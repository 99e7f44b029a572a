"""The other three ALS engines of the port (``engines/ecommerce.py``,
``engines/similarproduct.py``, ``engines/recommended_user.py``) against
the JAX package's, on the CPU.

Events made from a seed with numpy are written by the reference into
one sqlite file, which both packages read. The reference trains on a
one-device mesh; the port trains on the CPU from the reference's initial
item factors (its seeded init is patched to supply them, as
``tests/test_torch_train_lifecycle.py`` does), so factors must agree
within ``ATOL, RTOL = 5e-5, 1e-4`` (the same sweeps in f32, sums in
another order); vocabularies, popularity counts, item metadata and
cooccurrence top lists must be equal. Then the port's query server
answers over HTTP what the reference's ``predict`` gives on every query
path: ids equal up to ties (a swap only between scores within
``TIE_TOL``), scores within ``SCORE_RTOL``. Similar-product's fused lane
(the two-stage scorer, the shortlist kernel's plain version on CPU
tensors) agrees with its exact lane, and on the ML-1M catalog's
factors both packages' parity gates reach the same recall and the same
verdict (the default shortlist demotes it). E-commerce's fold-in
applies the reference controller's rows and popularity counts on the
same model and events.
"""

import datetime as dt
import types

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import predictionio_tpu.data.eventstore as ref_eventstore
import predictionio_tpu.deploy.foldin as ref_foldin
import predictionio_tpu.engines.ecommerce as ref_ecom
import predictionio_tpu.engines.recommended_user as ref_ru
import predictionio_tpu.engines.similarproduct as ref_sp
import predictionio_tpu_torch.data.eventstore as port_eventstore
import predictionio_tpu_torch.deploy.foldin as port_foldin
import predictionio_tpu_torch.engines.ecommerce as port_ecom
import predictionio_tpu_torch.engines.recommended_user as port_ru
import predictionio_tpu_torch.engines.similarproduct as port_sp
import predictionio_tpu_torch.models.als as port_als
from predictionio_tpu.core.engine import TrainResult as RefTrainResult
from predictionio_tpu.core.params import EngineParams as RefEngineParams
from predictionio_tpu.data import DataMap as RefDataMap, Event as RefEvent
from predictionio_tpu.ops import scoring as ref_scoring
from predictionio_tpu.server.query_server import QueryServer as RefQueryServer
from predictionio_tpu.storage import App as RefApp, Storage as RefStorage
from predictionio_tpu.storage.base import EngineInstance as RefEngineInstance
from predictionio_tpu.utils.server_config import (
    DeployConfig as RefDeployConfig, FoldinConfig as RefFoldinConfig,
    ScorerConfig as RefScorerConfig, ServingConfig as RefServingConfig,
)
from predictionio_tpu.workflow.context import WorkflowContext
from predictionio_tpu_torch.core.engine import TrainResult
from predictionio_tpu_torch.data.event import Event as PortEvent
from predictionio_tpu_torch.deploy.warm import EngineInstance
from predictionio_tpu_torch.models.als import ALSData, ALSParams, train_als
from predictionio_tpu_torch.ops import scoring as port_scoring
from predictionio_tpu_torch.server.query_server import (
    QueryServer, create_query_server,
)
from predictionio_tpu_torch.storage.base import App as PortApp
from predictionio_tpu_torch.storage.registry import Storage as PortStorage
from predictionio_tpu_torch.utils.server_config import (
    FoldinConfig, ScorerConfig,
)

pytestmark = pytest.mark.anyio

APP = "TorchEnginesApp"
RANK, ITERS = 6, 6
#: factors: the same sweeps in f32, sums in another order
ATOL, RTOL = 5e-5, 1e-4
#: served scores of the same ids (the factors' tolerance carried
#: through a dot product)
SCORE_RTOL = 1e-3
#: two ids may trade places only between scores this close
TIE_TOL = 1e-3
BASE = dt.datetime(2024, 5, 1, tzinfo=dt.timezone.utc)


def _config(path):
    return {
        "sources": {"DB": {"TYPE": "sqlite", "PATH": str(path)}},
        "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                         for r in ("METADATA", "EVENTDATA", "MODELDATA")},
    }


@pytest.fixture()
def stores(tmp_path, monkeypatch):
    """Both packages' registries; the entity cache's TTL 0 so that a
    read after a write sees the write."""
    monkeypatch.setenv("PIO_ENTITY_CACHE_TTL_S", "0")

    def reset():
        RefStorage.reset()
        PortStorage.reset()
        ref_eventstore.clear_cache()
        port_eventstore.clear_cache()
        port_scoring.set_process_scorer_config(None)

    reset()
    yield tmp_path
    reset()


# -- events -------------------------------------------------------------------

def _ev(event, etype, eid, props=None, ttype=None, tid=None, sec=0):
    return (event, etype, eid, props or {}, ttype, tid, sec)


def _items_and_users(n_users, n_items, rng):
    rows = [_ev("$set", "user", f"u{u}", {"age": int(rng.integers(18, 60))})
            for u in range(n_users)]
    for i in range(n_items):
        cats = [f"c{i % 4}"] + ([f"c{(i + 1) % 4}"] if i % 5 == 0 else [])
        rows.append(_ev("$set", "item", f"i{i}", {"categories": cats}))
    return rows


def _ecomm_rows(seed=3, n_users=30, n_items=24):
    rng = np.random.default_rng(seed)
    rows = _items_and_users(n_users, n_items, rng)
    rows.append(_ev("$set", "constraint", "unavailableItems",
                    {"items": ["i3", "i7"]}))
    for s in range(1, 421):
        u, i = int(rng.integers(n_users)), int(rng.integers(n_items))
        kind = "view" if rng.random() < 0.85 else "buy"
        rows.append(_ev(kind, "user", f"u{u}", None, "item", f"i{i}", s))
    return rows


def _similar_rows(seed=5, n_users=40, n_items=30):
    rng = np.random.default_rng(seed)
    rows = _items_and_users(n_users, n_items, rng)
    for s in range(1, 501):
        u, i = int(rng.integers(n_users)), int(rng.integers(n_items))
        rows.append(_ev("view", "user", f"u{u}", None, "item", f"i{i}", s))
    for s in range(1, 241):
        u, i = int(rng.integers(n_users)), int(rng.integers(n_items))
        kind = "like" if rng.random() < 0.6 else "dislike"
        # a small time set: equal timestamps per pair are common, and the
        # first in scan order must win in both packages
        rows.append(_ev(kind, "user", f"u{u}", None, "item", f"i{i}",
                        1000 + s % 7))
    return rows


def _follow_rows(seed=6, n_users=40):
    rng = np.random.default_rng(seed)
    rows = [_ev("$set", "user", f"u{u}", {"name": f"n{u}"})
            for u in range(n_users)]
    for s in range(1, 361):
        # ids past n_users are not $set users: the follow is dropped
        a, b = int(rng.integers(n_users + 4)), int(rng.integers(n_users + 4))
        rows.append(_ev("follow", "user", f"u{a}", None, "user", f"u{b}",
                        s))
    return rows


def _write_ref(path, rows):
    RefStorage.configure(_config(path))
    ref_eventstore.clear_cache()
    app_id = RefStorage.get_meta_data_apps().insert(RefApp(id=0, name=APP))
    store = RefStorage.get_events()
    store.init_channel(app_id)
    _append_ref(rows)
    PortStorage.configure(_config(path))
    port_eventstore.clear_cache()
    return app_id


def _append_ref(rows, app_id=1):
    RefStorage.get_events().insert_batch([
        RefEvent(event=e, entity_type=et, entity_id=eid,
                 target_entity_type=tt, target_entity_id=tid,
                 properties=RefDataMap(p),
                 event_time=BASE + dt.timedelta(seconds=s))
        for e, et, eid, p, tt, tid, s in rows], app_id)


# -- training -----------------------------------------------------------------

def _reference_init_V(seed, n_items, k):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (n_items, k), jnp.float32)
                      / jnp.sqrt(jnp.float32(k)))


def _patch_init(monkeypatch):
    """The port's seeded init hands out the reference's initial V."""
    def init(n_items, n_items_pad, k, seed, device):
        import torch

        V = np.zeros((n_items_pad, k), np.float32)
        V[:n_items] = _reference_init_V(seed, n_items, k)
        return torch.from_numpy(V).to(device)

    monkeypatch.setattr(port_als, "_init_item_factors", init)


def _train_both(monkeypatch, ref_mod, port_mod, variant):
    ref_engine, port_engine = ref_mod.engine(), port_mod.engine()
    ref_result = ref_engine.train(
        WorkflowContext(mode="Training", devices=jax.devices()[:1]),
        ref_engine.engine_params_from_json(variant))
    _patch_init(monkeypatch)
    port_result = port_engine.train(types.SimpleNamespace(device="cpu"),
                                    port_engine.engine_params_from_json(
                                        variant))
    return ref_result, port_engine, port_result


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _items_equal(port_items, ref_items):
    assert {k: v.categories for k, v in port_items.items()} == \
        {k: v.categories for k, v in ref_items.items()}


# -- serving ------------------------------------------------------------------

_WIRE = {"whiteList": "white_list", "blackList": "black_list"}


def _ref_query(cls, q):
    return cls(**{_WIRE.get(k, k): v for k, v in q.items()})


def _same_up_to_ties(got, want, key):
    """Ids position by position, a swap allowed only inside a run of
    scores within TIE_TOL; scores within SCORE_RTOL."""
    assert len(got) == len(want), (got, want)
    gs = [s["score"] for s in got]
    ws = [s["score"] for s in want]
    np.testing.assert_allclose(gs, ws, rtol=SCORE_RTOL, atol=1e-6)
    wid = [s[key] for s in want]
    for p, s in enumerate(got):
        if s[key] == wid[p]:
            continue
        near = [wid[j] for j in range(len(want))
                if abs(ws[j] - ws[p]) <= TIE_TOL * max(1.0, abs(ws[p]))]
        assert s[key] in near, (p, got, want)


async def _serve_and_compare(port_engine, result, ref_predict, queries,
                             key, scorer=None):
    server = create_query_server(
        port_engine, result, EngineInstance(id="engines-test"),
        scorer_config=scorer or ScorerConfig(mode="exact"), linger_s=0.0)
    server.warm()
    port = await server.start("127.0.0.1", 0)
    try:
        async with aiohttp.ClientSession() as session:
            for q in queries:
                async with session.post(
                        f"http://127.0.0.1:{port}/queries.json",
                        json=q) as resp:
                    assert resp.status == 200, await resp.text()
                    got = await resp.json()
                want = ref_predict(q)
                name = "itemScores" if key == "item" else \
                    "similarUserScores"
                _same_up_to_ties(got[name], want[name], key)
            async with session.get(f"http://127.0.0.1:{port}/") as resp:
                root = await resp.json()
        # sequential queries: one micro-batch each, when the engine
        # batches (every algorithm overrides batch_predict)
        batches = root["microBatches"]
        if server._unit.vectorized:
            assert batches["batches"] == len(queries), batches
        else:
            assert batches is None
    finally:
        await server.close()


# -- e-commerce ----------------------------------------------------------------

def _ecomm_variant(unseen_only):
    return {"datasource": {"params": {"appName": APP}},
            "algorithms": [{"name": "ecomm", "params": {
                "appName": APP, "unseenOnly": unseen_only, "rank": RANK,
                "numIterations": ITERS}}]}


ECOMM_QUERIES = [
    {"user": "u1", "num": 5},
    {"user": "u2", "num": 24},
    {"user": "u4", "num": 6, "categories": ["c1"]},
    {"user": "u5", "num": 6, "whiteList": ["i0", "i2", "i4", "i9", "i11"]},
    {"user": "u6", "num": 6, "blackList": ["i0", "i1", "i2"]},
    {"user": "newbie", "num": 6},                  # recent views
    {"user": "newbie", "num": 4, "categories": ["c2", "c3"]},
    {"user": "ghost", "num": 8},                   # popularity
    {"user": "ghost", "num": 5, "blackList": ["i5"], "categories": ["c0"]},
]


@pytest.mark.parametrize("unseen_only", [False, True])
async def test_ecommerce_trains_and_serves_like_reference(
        stores, monkeypatch, unseen_only):
    _write_ref(stores / "ecomm.db", _ecomm_rows())
    ref_result, port_engine, port_result = _train_both(
        monkeypatch, ref_ecom, port_ecom, _ecomm_variant(unseen_only))
    ref_m, m = ref_result.models[0], port_result.models[0]
    assert list(m.user_vocab) == list(ref_m.user_vocab)
    assert list(m.item_vocab) == list(ref_m.item_vocab)
    _close(m.U, ref_m.U)
    _close(m.V, ref_m.V)
    _close(m.V_normalized, ref_m.V_normalized)
    assert m.popular_count == ref_m.popular_count
    _items_equal(m.items, ref_m.items)

    # after training: an unknown user with recent views
    _append_ref([_ev("view", "user", "newbie", None, "item", f"i{i}",
                     900 + j) for j, i in enumerate((2, 5, 9))])
    ref_algo = ref_result.algorithms[0]

    def ref_predict(q):
        return ref_algo.predict(ref_m, _ref_query(ref_ecom.Query,
                                                  q)).to_dict()

    await _serve_and_compare(port_engine, port_result, ref_predict,
                             ECOMM_QUERIES, "item")


async def test_ecommerce_foldin_counts_and_rows(tmp_path, monkeypatch):
    """The reference's ``test_controller_ecommerce_counts_and_cache`` on
    both packages: each on its own sqlite file with the same events, the
    same model; one apply folds the new user's row (views and a buy
    summed per pair: i0 = 2 x 1.0 + 2.0, i1 = 1.0) and adds the buy to
    the popularity counts; the item side stays the same array."""
    monkeypatch.setenv("PIO_ENTITY_CACHE_TTL_S", "0")
    rng = np.random.default_rng(0)
    n_u, n_i, k = 10, 8, 3
    V = rng.normal(size=(n_i, k)).astype(np.float32)
    U = rng.normal(size=(n_u, k)).astype(np.float32)
    users = np.sort(np.asarray([f"u{i}" for i in range(n_u)], dtype=object))
    items = np.sort(np.asarray([f"i{i}" for i in range(n_i)], dtype=object))
    Vn = V / np.maximum(np.linalg.norm(V, axis=1, keepdims=True), 1e-9)
    evs = [("view", "i0"), ("view", "i0"), ("view", "i1"), ("buy", "i0")]
    instance_kw = dict(id="ecomm-inst", engine_id="ecomm-engine",
                       engine_version="1", engine_variant="default",
                       status="COMPLETED")
    try:
        RefStorage.configure(_config(tmp_path / "ref.db"))
        ref_eventstore.clear_cache()
        app_id = RefStorage.get_meta_data_apps().insert(
            RefApp(id=0, name=APP))
        RefStorage.get_events().init_channel(app_id)
        ref_model = ref_ecom.ECommModel(
            user_vocab=users, item_vocab=items, U=U, V=V, V_normalized=Vn,
            items={}, popular_count={0: 3})
        ref_server = RefQueryServer(
            ref_ecom.engine(), RefTrainResult(
                models=[ref_model], algorithms=[ref_ecom.ECommAlgorithm(
                    ref_ecom.ECommAlgorithmParams(app_name=APP, rank=k))],
                serving=ref_ecom.ECommerceServing(),
                engine_params=RefEngineParams()),
            RefEngineInstance(**instance_kw), ctx=None,
            serving_config=RefServingConfig(batch_max=8,
                                            batch_linger_s=0.0),
            deploy_config=RefDeployConfig(warmup=False))
        ref_ctl = ref_foldin.FoldInController(
            ref_server, RefFoldinConfig(enabled=True,
                                        apply_interval_s=3600.0,
                                        max_pending=64),
            registry=ref_server.registry)
        # event times after the controller's watermark (its start)
        when = dt.datetime.now(tz=dt.timezone.utc)
        RefStorage.get_events().insert_batch([
            RefEvent(event=e, entity_type="user", entity_id="euser",
                     target_entity_type="item", target_entity_id=t,
                     event_time=when) for e, t in evs], app_id)
        ref_stats = ref_ctl.apply_pending()
        ref_m2 = ref_server._unit.result.models[0]

        PortStorage.configure(_config(tmp_path / "port.db"))
        port_eventstore.clear_cache()
        app_id = PortStorage.get_meta_data_apps().insert(
            PortApp(id=0, name=APP))
        PortStorage.get_events().init_channel(app_id)
        model = port_ecom.ECommModel(
            user_vocab=users, item_vocab=items, U=U, V=V, V_normalized=Vn,
            items={}, popular_count={0: 3}, device="cpu")
        server = QueryServer(
            port_ecom.engine(), TrainResult(
                models=[model], algorithms=[port_ecom.ECommAlgorithm(
                    port_ecom.ECommAlgorithmParams(app_name=APP, rank=k))],
                serving=port_ecom.ECommerceServing(),
                engine_params=port_ecom.default_engine_params(APP)),
            EngineInstance(**instance_kw),
            scorer_config=ScorerConfig(mode="exact"), linger_s=0.0,
            foldin_config=FoldinConfig(enabled=True,
                                       apply_interval_s=3600.0,
                                       max_pending=64))
        ctl = port_foldin.FoldInController(server, FoldinConfig(
            enabled=True, apply_interval_s=3600.0, max_pending=64))
        assert ctl.spec.aggregate == "sum" and not ctl.spec.fold_items
        when = dt.datetime.now(tz=dt.timezone.utc)
        PortStorage.get_events().insert_batch([
            PortEvent(event=e, entity_type="user", entity_id="euser",
                      target_entity_type="item", target_entity_id=t,
                      event_time=when) for e, t in evs], app_id)
        stats = ctl.apply_pending()
        m2 = server._unit.result.models[0]

        assert (stats["users"], stats["counts"]) == (
            ref_stats["users"], ref_stats["counts"]) == (1, 1)
        assert list(m2.user_vocab) == list(ref_m2.user_vocab)
        ui = m2.user_index("euser")
        np.testing.assert_allclose(m2.U[ui], ref_m2.U[ui], atol=1e-4)
        # the dense implicit solve: c = 1 + alpha * r, ridge reg * n
        i0, i1 = model.item_index("i0"), model.item_index("i1")
        F = V[[i0, i1]].astype(np.float64)
        c = 1.0 + np.array([4.0, 1.0])
        A = (V.T @ V).astype(np.float64) + (F * (c - 1)[:, None]).T @ F \
            + 0.01 * 2 * np.eye(k)
        np.testing.assert_allclose(
            m2.U[ui], np.linalg.solve(A, (F * c[:, None]).T @ np.ones(2)),
            atol=2e-3)
        assert m2.popular_count == ref_m2.popular_count
        assert m2.popular_count[i0] == 4
        assert m2.V is model.V and m2.item_vocab is model.item_vocab
        algo = server.result.algorithms[0]
        got = algo.predict(m2, port_ecom.Query(user="euser", num=5))
        want = ref_server._unit.result.algorithms[0].predict(
            ref_m2, ref_ecom.Query(user="euser", num=5))
        _same_up_to_ties(got.to_dict()["itemScores"],
                         want.to_dict()["itemScores"], "item")
        await server.close()
    finally:
        RefStorage.reset()
        PortStorage.reset()
        ref_eventstore.clear_cache()
        port_eventstore.clear_cache()
        port_scoring.set_process_scorer_config(None)


# -- similar-product -------------------------------------------------------------

SIMILAR_VARIANT = {
    "datasource": {"params": {"appName": APP}},
    "algorithms": [
        {"name": "als", "params": {"rank": RANK, "numIterations": ITERS}},
        {"name": "likealgo", "params": {"rank": RANK,
                                        "numIterations": ITERS}},
        {"name": "cooccurrence", "params": {"n": 6}}]}

SIMILAR_QUERIES = [
    {"items": ["i1"], "num": 5},
    {"items": ["i2", "i7"], "num": 8},
    {"items": ["i3", "i4", "i20"], "num": 4},
    {"items": ["i5"], "num": 6, "blackList": ["i6", "i8", "i9"]},
    {"items": ["i10", "i11"], "num": 5, "categories": ["c1"]},
    {"items": ["i12"], "num": 5, "whiteList": ["i0", "i13", "i14", "i28"]},
    {"items": ["nope"], "num": 5},
]


@pytest.fixture()
def similar(stores, monkeypatch):
    _write_ref(stores / "similar.db", _similar_rows())
    return _train_both(monkeypatch, ref_sp, port_sp, SIMILAR_VARIANT)


def test_similarproduct_models_match_reference(similar):
    ref_result, _engine, port_result = similar
    for name, ref_m, m in zip(("als", "likealgo", "cooccurrence"),
                              ref_result.models, port_result.models):
        if name == "cooccurrence":
            assert list(m.model.item_vocab) == list(ref_m.model.item_vocab)
            assert m.model.top_cooccurrences == \
                ref_m.model.top_cooccurrences
        else:
            assert list(m.item_vocab) == list(ref_m.item_vocab), name
            _close(m.V, ref_m.V)
        _items_equal(m.items, ref_m.items)


@pytest.mark.parametrize("algo", [0, 1, 2], ids=["als", "likealgo",
                                                 "cooccurrence"])
async def test_similarproduct_serves_each_algorithm_like_reference(
        similar, algo):
    ref_result, port_engine, port_result = similar
    result = TrainResult(models=[port_result.models[algo]],
                         algorithms=[port_result.algorithms[algo]],
                         serving=port_result.serving,
                         engine_params=port_result.engine_params)
    ref_algo, ref_m = ref_result.algorithms[algo], ref_result.models[algo]

    def ref_predict(q):
        return ref_algo.predict(ref_m, _ref_query(ref_sp.Query,
                                                  q)).to_dict()

    await _serve_and_compare(port_engine, result, ref_predict,
                             SIMILAR_QUERIES, "item")


@pytest.mark.parametrize("mode", ["exact", "twostage"])
async def test_similarproduct_multi_algorithm_engine_serves_first(
        similar, mode):
    """The three algorithms in one engine (FirstServing: the ALS
    algorithm's answers), served through the micro-batcher; under
    twostage the plain queries take the fused lane."""
    ref_result, port_engine, port_result = similar
    ref_algo, ref_m = ref_result.algorithms[0], ref_result.models[0]

    def ref_predict(q):
        return ref_algo.predict(ref_m, _ref_query(ref_sp.Query,
                                                  q)).to_dict()

    await _serve_and_compare(
        port_engine, port_result, ref_predict, SIMILAR_QUERIES, "item",
        scorer=ScorerConfig(mode=mode, tile_items=16, shortlist=32))
    if mode == "twostage":
        for m in port_result.models[:2]:
            assert m._scorer_cache[2].active


@pytest.mark.parametrize("algo", [0, 1], ids=["als", "likealgo"])
def test_fused_lane_agrees_with_exact_lane(similar, algo):
    """``_fused_batch`` through the two-stage scorer (the shortlist
    kernel's plain version on CPU tensors) against the exact lane on
    the same batch: the same answers."""
    _ref, _engine, port_result = similar
    a, m = port_result.algorithms[algo], port_result.models[algo]
    queries = [(j, port_sp.Query(**{_WIRE.get(k, k): v
                                    for k, v in q.items()}))
               for j, q in enumerate(SIMILAR_QUERIES)
               if "categories" not in q and "whiteList" not in q]
    m._scorer_cfg_override = ScorerConfig(mode="exact")
    exact = a.batch_predict(m, queries)
    m._scorer_cfg_override = ScorerConfig(mode="twostage", tile_items=16,
                                          shortlist=32)
    idx_sets = [port_sp._index_set(m, q.items) for _, q in queries]
    rows = [b for b, s in enumerate(idx_sets) if s]
    qsums = np.stack([m.V[sorted(idx_sets[b])].sum(axis=0) for b in rows])
    assert a._fused_batch(m, queries, rows, idx_sets, qsums) is not None
    fused = a.batch_predict(m, queries)
    assert m._scorer_cache[2].active
    assert m._scorer_cache[2].n_tiles > 1
    for (i, e), (j, f) in zip(exact, fused):
        assert i == j
        got, want = f.to_dict()["itemScores"], e.to_dict()["itemScores"]
        _same_up_to_ties(got, want, "item")
        np.testing.assert_allclose([s["score"] for s in got],
                                   [s["score"] for s in want], rtol=1e-5)


def test_like_ties_keep_the_first_event(stores, monkeypatch):
    """Two events of one pair at one timestamp: the first in scan order
    wins (strict >), in both packages' like ratings."""
    rows = _items_and_users(4, 4, np.random.default_rng(0))
    rows += [_ev("view", "user", "u0", None, "item", "i0", 1),
             _ev("like", "user", "u0", None, "item", "i1", 5),
             _ev("dislike", "user", "u0", None, "item", "i1", 5),
             _ev("dislike", "user", "u1", None, "item", "i1", 6),
             _ev("like", "user", "u1", None, "item", "i1", 6),
             _ev("dislike", "user", "u2", None, "item", "i2", 4),
             _ev("like", "user", "u2", None, "item", "i2", 7)]
    _write_ref(stores / "ties.db", rows)
    ref_td = ref_sp.SimilarProductDataSource(
        ref_sp.DataSourceParams(app_name=APP)).read_training(None)
    td = port_sp.SimilarProductDataSource(
        port_sp.DataSourceParams(app_name=APP)).read_training(None)
    want = ref_sp.LikeAlgorithm()._ratings(ref_td)
    got = port_sp.LikeAlgorithm()._ratings(td)
    as_set = lambda r: sorted(zip(*(list(map(str, c)) for c in r)))  # noqa: E731
    assert as_set(got) == as_set(want)
    assert ("u0", "i1", "1.0") in as_set(got)
    assert ("u1", "i1", "-1.0") in as_set(got)
    assert ("u2", "i2", "1.0") in as_set(got)


@pytest.fixture(scope="module")
def ml1m_similarity_V():
    """Similar-product's ALS factors at cfg_cooccurrence's ML-1M shape
    (the reference bench's generator, bench.py:106-117, seed 2; view
    counts per pair; rank 10, 10 iterations), trained by the port on
    the CPU and row-normalized."""
    rng = np.random.default_rng(2)
    nu, ni, nnz = 6040, 3706, 1_000_000
    users = rng.integers(0, nu, nnz).astype(np.int32)
    items = rng.integers(0, ni, nnz).astype(np.int32)
    pairs, counts = np.unique(users.astype(np.int64) * ni + items,
                              return_counts=True)
    data = ALSData.build((pairs // ni).astype(np.int32),
                         (pairs % ni).astype(np.int32),
                         counts.astype(np.float32), nu, ni)
    _, V = train_als(data, ALSParams(rank=10, num_iterations=10, reg=0.01,
                                     alpha=1.0, implicit_prefs=True),
                     device="cpu")
    norms = np.linalg.norm(V, axis=1, keepdims=True)
    return (V / np.where(norms == 0, 1.0, norms)).astype(np.float32)


@pytest.mark.parametrize("shortlist", [512, 1024])
def test_scorer_gate_on_the_ml1m_catalog_matches_reference(
        ml1m_similarity_V, shortlist):
    """The two-stage parity gate on the same factors: the same scan
    rank, probe recall and verdict in both packages. At the reference's
    default shortlist (512, one tile of 4096) the scan rank is cut to 8
    and the gate demotes the catalog to exact; at 1024 it keeps it (the
    smoke deploys this catalog with 1024)."""
    V = ml1m_similarity_V
    got = port_scoring.build_scorer(
        V, ScorerConfig(mode="twostage", shortlist=shortlist), device="cpu")
    want = ref_scoring.build_scorer(
        V, RefScorerConfig(mode="twostage", shortlist=shortlist))
    assert (got.scan_rank, got.tile, got.n_tiles) == (
        want.scan_rank, want.tile, want.n_tiles) == (8, 4096, 1)
    assert got.recall_probe == want.recall_probe
    assert got.active_mode == want.active_mode
    if shortlist == 1024:
        assert got.active_mode == "twostage"


# -- recommended-user --------------------------------------------------------------

RU_QUERIES = [
    {"users": ["u1"], "num": 5},
    {"users": ["u2", "u3"], "num": 8},
    {"users": ["u4", "u5", "u6"], "num": 4},
    {"users": ["u7"], "num": 6, "blackList": ["u8", "u9", "u10"]},
    {"users": ["u11"], "num": 5, "whiteList": ["u0", "u12", "u13", "u30"]},
    {"users": ["stranger"], "num": 5},
]


async def test_recommended_user_trains_and_serves_like_reference(
        stores, monkeypatch):
    _write_ref(stores / "ru.db", _follow_rows())
    variant = {"datasource": {"params": {"appName": APP}},
               "algorithms": [{"name": "als", "params": {
                   "rank": RANK, "numIterations": ITERS}}]}
    ref_result, port_engine, port_result = _train_both(
        monkeypatch, ref_ru, port_ru, variant)
    ref_m, m = ref_result.models[0], port_result.models[0]
    assert list(m.user_vocab) == list(ref_m.user_vocab)
    assert m.users == ref_m.users
    _close(m.V, ref_m.V)
    assert not any(u in ("u40", "u41", "u42", "u43") for u in m.user_vocab)
    ref_algo = ref_result.algorithms[0]

    def ref_predict(q):
        return ref_algo.predict(ref_m, _ref_query(ref_ru.Query,
                                                  q)).to_dict()

    await _serve_and_compare(port_engine, port_result, ref_predict,
                             RU_QUERIES, "user")
