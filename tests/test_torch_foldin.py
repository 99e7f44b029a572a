"""Online fold-in of the port (``predictionio_tpu_torch/deploy/foldin.py``,
``models/als.FoldInSolver``), held against the JAX package's on the same
numpy inputs from a seed.

* ``FoldInSolver.solve``: explicit; implicit with alpha 0 and alpha > 0;
  weighted regularization on and off; an entity spanning several packed
  rows; an empty segment (the zero row); B = 0 and the error cases. The
  reference runs its XLA path (``batched_spd_solve`` takes Pallas only on
  a TPU), the port its plain solve; rows agree within
  ``1e-4 * max(1, max |x|)``.
* ``upsert_factor_rows``, the history read on one sqlite file written by
  the reference and read by both packages, ``FoldinConfig`` precedence
  and the write buffer's flush taps.
* The controller through the port's ``QueryServer`` on the CPU, each
  case calling ``apply_pending()`` directly (never the apply timer):
  pull, solve, swap and the deferred requeue of a new item's raters;
  push/pull dedup and the ``max_pending`` cap; a history read that fails;
  a swap raced by a cutover. The folded rows equal the reference
  controller's on the same model and events.
* The slice as a whole: events through the port's event server reach
  the port's query server's answers, which agree with the reference's
  on the same model and events; ``POST /rollback.json`` restores the
  pre-fold-in answers byte for byte and marks the drift row ROLLED_BACK.
"""

import asyncio
import dataclasses
import json
import time

import aiohttp
import numpy as np
import pytest

import predictionio_tpu.data.eventstore as ref_eventstore
import predictionio_tpu.deploy.foldin as ref_foldin
import predictionio_tpu_torch.data.eventstore as port_eventstore
import predictionio_tpu_torch.deploy.foldin as port_foldin
from predictionio_tpu.core.engine import Engine as RefEngine
from predictionio_tpu.core.engine import TrainResult as RefTrainResult
from predictionio_tpu.core.params import EngineParams as RefEngineParams
from predictionio_tpu.data.datamap import DataMap as RefDataMap
from predictionio_tpu.data.event import Event as RefEvent
from predictionio_tpu.engines import recommendation as ref_rec
from predictionio_tpu.models.als import ALSModel as RefALSModel
from predictionio_tpu.models.als import ALSParams as RefALSParams
from predictionio_tpu.models.als import FoldInSolver as RefFoldInSolver
from predictionio_tpu.server.query_server import QueryServer as RefQueryServer
from predictionio_tpu.storage import App as RefApp
from predictionio_tpu.storage import Storage as RefStorage
from predictionio_tpu.storage.base import EngineInstance as RefEngineInstance
from predictionio_tpu.utils.server_config import (
    DeployConfig as RefDeployConfig, FoldinConfig as RefFoldinConfig,
    ServingConfig as RefServingConfig,
)
from predictionio_tpu_torch.data import write_buffer as port_wb
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.deploy.releases import record_release
from predictionio_tpu_torch.engines import recommendation as port_rec
from predictionio_tpu_torch.models.als import ALSModel, ALSParams, FoldInSolver
from predictionio_tpu_torch.server.query_server import QueryServer
from predictionio_tpu_torch.storage.base import (
    AccessKey, App, EngineInstance,
)
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.server_config import (
    FoldinConfig, ScorerConfig,
)

pytestmark = pytest.mark.anyio

APP = "FoldinTestApp"
KEY = "foldin-key"
ENGINE_ID, VARIANT = "foldin-test-engine", "default"
RANK = 4
#: folded rows: max |x - x_ref| <= ROW_TOL * max(1, max |x_ref|)
ROW_TOL = 1e-4
#: served scores of the same ids
SCORE_TOL = 1e-4


def _close_rows(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= ROW_TOL * scale, (err, scale)


# ---------------------------------------------------------------------------
# FoldInSolver
# ---------------------------------------------------------------------------

def _segments(rng, n_items, lengths):
    rated = [rng.choice(n_items, size=n, replace=False) for n in lengths]
    values = [rng.integers(1, 6, size=n).astype(np.float32)
              for n in lengths]
    return rated, values


@pytest.mark.parametrize("implicit,alpha,weighted", [
    (False, 1.0, True), (False, 1.0, False),
    (True, 0.0, True), (True, 0.0, False),
    (True, 1.5, True), (True, 1.5, False)])
def test_solver_matches_reference(implicit, alpha, weighted):
    """Explicit and both implicit branches, weighted reg on and off; one
    entity spans three packed rows (row_len 4, 10 ratings) and one
    segment is empty (the zero row)."""
    rng = np.random.default_rng(11)
    n_items = 40
    V = rng.normal(size=(n_items, 6)).astype(np.float32)
    rated, values = _segments(rng, n_items, [3, 10, 0, 7, 1])
    if implicit:
        values[1][:3] = 0.0              # zero ratings: preference 0
    kw = dict(rank=6, reg=0.05, alpha=alpha, implicit_prefs=implicit,
              weighted_reg=weighted)
    want = RefFoldInSolver(V, RefALSParams(**kw), row_len=4).solve(
        rated, values)
    got = FoldInSolver(V, ALSParams(**kw), row_len=4,
                       device="cpu").solve(rated, values)
    _close_rows(got, want)
    if not implicit:
        assert not got[2].any() and not want[2].any()


def test_solver_weights_and_batches_match_reference():
    """Per-rating weights, and a batch that buckets past its size (S = 5
    pads to 8 segments)."""
    rng = np.random.default_rng(3)
    V = rng.normal(size=(30, 4)).astype(np.float32)
    rated, values = _segments(rng, 30, [5, 2, 9, 4, 6])
    weights = [rng.uniform(0.5, 2.0, size=len(r)).astype(np.float32)
               for r in rated]
    p = dict(rank=4, reg=0.01)
    want = RefFoldInSolver(V, RefALSParams(**p)).solve(rated, values,
                                                        weights)
    solver = FoldInSolver(V, ALSParams(**p), device="cpu")
    _close_rows(solver.solve(rated, values, weights), want)
    assert solver.last_solve["S"] == 8 and solver.last_solve["K"] == 4
    assert solver.last_solve["solve_event_ms"] is None      # on the CPU


def test_solver_edge_cases_match_reference():
    V = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)
    ref = RefFoldInSolver(V, RefALSParams(rank=3))
    port = FoldInSolver(V, ALSParams(rank=3), device="cpu")
    for s in (ref, port):
        assert s.solve([], []).shape == (0, 3)
        with pytest.raises(ValueError, match="length mismatch"):
            s.solve([np.array([0])], [])
        with pytest.raises(ValueError, match="out of range"):
            s.solve([np.array([8])], [np.array([1.0])])
        with pytest.raises(ValueError, match="weights"):
            s.solve([np.array([0, 1])], [np.array([1.0, 2.0])],
                    [np.array([1.0])])
    empty = [np.zeros(0, np.int64)]
    zero = np.zeros(0, np.float32)
    _close_rows(port.solve(empty, [zero]), ref.solve(empty, [zero]))
    assert not port.solve(empty, [zero]).any()


def test_solver_without_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rule is moot")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FoldInSolver(np.ones((2, 2), np.float32), ALSParams(rank=2))


# ---------------------------------------------------------------------------
# upsert_factor_rows, history reads, config, flush taps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_upsert_factor_rows(pkg):
    upsert = (ref_foldin if pkg == "reference" else port_foldin
              ).upsert_factor_rows
    vocab = np.asarray(["b", "d", "f"], dtype=object)
    M = np.arange(6, dtype=np.float32).reshape(3, 2)
    rows = {"d": np.array([9.0, 9.0], np.float32),      # overwrite
            "a": np.array([1.0, 1.0], np.float32),      # insert front
            "e": np.array([2.0, 2.0], np.float32),      # insert middle
            "z": np.array([3.0, 3.0], np.float32)}      # insert back
    v2, m2 = upsert(vocab, M, rows)
    assert list(v2) == ["a", "b", "d", "e", "f", "z"]
    np.testing.assert_array_equal(m2[2], [9.0, 9.0])
    np.testing.assert_array_equal(m2[0], [1.0, 1.0])
    np.testing.assert_array_equal(m2[3], [2.0, 2.0])
    np.testing.assert_array_equal(m2[5], [3.0, 3.0])
    np.testing.assert_array_equal(m2[1], M[0])
    assert list(vocab) == ["b", "d", "f"]
    np.testing.assert_array_equal(M, np.arange(6).reshape(3, 2))
    v3, m3 = upsert(vocab, M, {})
    assert v3 is vocab and m3 is M
    # overwrite only: the vocab object rides, the matrix is a copy
    v4, m4 = upsert(vocab, M, {"b": np.zeros(2, np.float32)})
    assert v4 is vocab and m4 is not M


def test_upsert_widens_a_fixed_width_vocab():
    """A vocab of numpy strings (``np.array(["u0", ...])``) takes a
    longer new id whole."""
    vocab = np.array(["u0", "u1"])
    M = np.zeros((2, 2), np.float32)
    v2, m2 = port_foldin.upsert_factor_rows(
        vocab, M, {"newuser": np.ones(2, np.float32)})
    assert list(v2) == ["newuser", "u0", "u1"]
    assert vocab.dtype == np.dtype("<U2")
    np.testing.assert_array_equal(m2[0], [1.0, 1.0])


def test_batch_lookup_on_a_fixed_width_vocab():
    """The fold-in lookup of rated ids in a numpy-string vocab: the same
    codes as the reference's on the object vocab, a key longer than the
    vocab's width never matches its cut prefix, and None never matches."""
    from predictionio_tpu.data.bimap import batch_lookup as ref_lookup
    from predictionio_tpu_torch.data.bimap import batch_lookup

    vocab = np.array(["i0", "i1", "i2", "i9"])
    keys = np.asarray(["i1", "i10", "zz", "i2", "", "i9", "a"],
                      dtype=object)
    want = ref_lookup(vocab.astype(object), keys)
    np.testing.assert_array_equal(batch_lookup(vocab, keys), want)
    np.testing.assert_array_equal(want, [1, -1, -1, 2, -1, 3, -1])
    np.testing.assert_array_equal(
        batch_lookup(vocab, np.asarray([None, "i0"], dtype=object)),
        [-1, 0])


def _config(path):
    return {"sources": {"DB": {"TYPE": "sqlite", "PATH": str(path)}},
            "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                             for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}}


def _reset_stores():
    Storage.reset()
    RefStorage.reset()
    port_eventstore.clear_cache()
    ref_eventstore.clear_cache()


@pytest.fixture()
def stores():
    _reset_stores()
    yield
    _reset_stores()


def _spec(pkg):
    mod = ref_foldin if pkg == "reference" else port_foldin
    params = (RefALSParams if pkg == "reference" else ALSParams)(rank=RANK)
    return mod.FoldinSpec(
        app_name=APP, als_params=params, event_names=("rate", "buy",
                                                      "view"),
        event_weights={"buy": 4.0, "view": 1.0}, rate_event="rate",
        fold_items=True)


def test_history_read_across_packages(stores, tmp_path):
    """One sqlite file written by the reference, read by both packages:
    the user side, the item side, event weights, and a rate without a
    rating (dropped)."""
    db = tmp_path / "history.db"
    RefStorage.configure(_config(db))
    app_id = RefStorage.get_meta_data_apps().insert(RefApp(id=0, name=APP))
    store = RefStorage.get_events()
    store.init_channel(app_id)

    def ev(name, u, i, rating=None):
        props = RefDataMap({} if rating is None else {"rating": rating})
        return RefEvent(event=name, entity_type="user", entity_id=u,
                        target_entity_type="item", target_entity_id=i,
                        properties=props)

    store.insert_batch([
        ev("rate", "u1", "i1", 4.0), ev("buy", "u1", "i2"),
        ev("view", "u1", "i3"), ev("rate", "u1", "i4"),   # no rating
        ev("rate", "u2", "i1", 2.0), ev("rate", "u1", "i1", 5.0),
        ev("like", "u1", "i5"),                           # not a rating
    ], app_id)
    Storage.configure(_config(db))

    def pairs(others, values):
        return sorted(zip([str(o) for o in others], values.tolist()))

    for side, ent in (("user", "u1"), ("user", "u2"), ("item", "i1"),
                      ("user", "nobody")):
        want = pairs(*ref_foldin.read_entity_ratings(_spec("reference"),
                                                     ent, side))
        got = pairs(*port_foldin.read_entity_ratings(_spec("port"), ent,
                                                     side))
        assert got == want, (side, ent)
    # an entity whose only rate has no rating reads as no ratings (the
    # reference's pyarrow property parse raises IndexError on a column
    # with no properties at all, so it is not asked here)
    assert pairs(*port_foldin.read_entity_ratings(_spec("port"), "i4",
                                                  "item")) == []
    assert pairs(*port_foldin.read_entity_ratings(
        _spec("port"), "u1", "user")) == [
        ("i1", 4.0), ("i1", 5.0), ("i2", 4.0), ("i3", 1.0)]
    # the batched read gives each entity its own history
    many = port_foldin.read_entities_ratings(_spec("port"),
                                             ["u1", "u2", "nobody"])
    for ent in ("u1", "u2", "nobody"):
        assert pairs(*many[ent]) == pairs(*port_foldin.read_entity_ratings(
            _spec("port"), ent, "user"))


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_foldin_config_precedence(pkg, monkeypatch):
    cls = RefFoldinConfig if pkg == "reference" else FoldinConfig
    cfg = cls.from_env({"enabled": True, "applyIntervalS": 5.0,
                        "maxPending": 9})
    assert cfg.enabled and cfg.apply_interval_s == 5.0 \
        and cfg.max_pending == 9
    cfg = cls.from_env({"enabled": True, "applyIntervalS": 5.0},
                       {"applyIntervalS": 1.0})
    assert cfg.enabled and cfg.apply_interval_s == 1.0
    monkeypatch.setenv("PIO_FOLDIN", "0")
    monkeypatch.setenv("PIO_FOLDIN_APPLY_INTERVAL_S", "junk")
    cfg = cls.from_env({"enabled": True, "applyIntervalS": 5.0},
                       {"applyIntervalS": 1.0})
    assert not cfg.enabled and cfg.apply_interval_s == 1.0
    monkeypatch.setenv("PIO_FOLDIN_MAX_PENDING", "17")
    assert cls.from_env().max_pending == 17
    # the clamps
    monkeypatch.setenv("PIO_FOLDIN_APPLY_INTERVAL_S", "0")
    monkeypatch.setenv("PIO_FOLDIN_MAX_PENDING", "-3")
    monkeypatch.setenv("PIO_FOLDIN_ROW_LEN", "0")
    cfg = cls.from_env()
    assert (cfg.apply_interval_s, cfg.max_pending, cfg.row_len) == \
        (0.01, 1, 1)


class _ListStore:
    """EventStore stand-in for the tap tests."""

    def __init__(self, fail_first=0):
        self.rows = []
        self.fail_first = fail_first

    def insert_batch(self, events, app_id, channel_id=None):
        if self.fail_first > 0:
            self.fail_first -= 1
            from predictionio_tpu_torch.storage.base import StorageError

            raise StorageError("injected")
        self.rows.extend(events)
        return [e.event_id for e in events]

    insert_batch_idempotent = insert_batch


def _rate_events(user, items, rating=4.0):
    return [Event(event="rate", entity_type="user", entity_id=user,
                  target_entity_type="item", target_entity_id=item,
                  properties=DataMap({"rating": float(rating)}))
            for item in items]


def test_flush_tap_delivers_after_commit():
    store = _ListStore()
    seen = []

    def tap(events, app_id, channel_id):
        assert len(store.rows) >= len(events)      # committed first
        seen.append((tuple(e.entity_id for e in events), app_id,
                     channel_id))

    def bad_tap(events, app_id, channel_id):
        raise RuntimeError("taps never break the flush")

    port_wb.add_flush_tap(bad_tap)
    port_wb.add_flush_tap(tap)
    port_wb.add_flush_tap(tap)                     # once only
    buf = port_wb.WriteBuffer(store_fn=lambda: store, linger_s=0.0)
    try:
        ids = buf.submit(_rate_events("tapuser", ["i1", "i2"]),
                         app_id=7).result(timeout=10)
        assert len(ids) == 2
        deadline = time.monotonic() + 5
        while not seen and time.monotonic() < deadline:
            time.sleep(0.01)
        assert seen == [(("tapuser", "tapuser"), 7, None)]
        port_wb.remove_flush_tap(tap)
        buf.submit(_rate_events("other", ["i3"]), app_id=7).result(10)
        time.sleep(0.05)
        assert len(seen) == 1
    finally:
        port_wb.remove_flush_tap(tap)
        port_wb.remove_flush_tap(bad_tap)
        buf.stop()


def test_flush_tap_not_called_on_failed_flush():
    store = _ListStore(fail_first=10)              # every attempt fails
    seen = []
    tap = seen.append
    port_wb.add_flush_tap(lambda e, a, c: tap(e))
    buf = port_wb.WriteBuffer(store_fn=lambda: store, linger_s=0.0,
                              retries=1, backoff_s=0.001)
    try:
        fut = buf.submit(_rate_events("u", ["i1"]), app_id=7)
        with pytest.raises(Exception):
            fut.result(timeout=10)
        time.sleep(0.05)
        assert seen == []
    finally:
        port_wb._FLUSH_TAPS.clear()
        buf.stop(drain=False)


# ---------------------------------------------------------------------------
# the controller through the port's QueryServer (and the reference's)
# ---------------------------------------------------------------------------

def _arrays(seed=0, n_users=24, n_items=18, rank=RANK):
    rng = np.random.default_rng(seed)
    return (np.asarray([f"u{i}" for i in range(n_users)], dtype=object),
            np.asarray([f"i{i}" for i in range(n_items)], dtype=object),
            rng.normal(size=(n_users, rank)).astype(np.float32),
            rng.normal(size=(n_items, rank)).astype(np.float32))


def _sorted_arrays(seed=0, **kw):
    users, items, U, V = _arrays(seed, **kw)
    ou, oi = np.argsort(users), np.argsort(items)
    return users[ou], items[oi], U[ou], V[oi]


def _port_server(arrays, release=None, instance=None,
                 foldin=None) -> QueryServer:
    model = ALSModel.from_arrays(*arrays, device="cpu")
    eng = port_rec.engine()
    result = eng.prepare_deploy(port_rec.default_engine_params(APP,
                                                               rank=RANK),
                                [model])
    instance = instance or EngineInstance(
        id="foldin-incumbent", engine_id=ENGINE_ID, engine_version="1",
        engine_variant=VARIANT, status="COMPLETED")
    return QueryServer(
        eng, result, instance, scorer_config=ScorerConfig(mode="exact"),
        max_batch=16, linger_s=0.0, release=release,
        foldin_config=foldin or FoldinConfig(
            enabled=True, apply_interval_s=3600.0, max_pending=64))


def _ref_server(arrays):
    users, items, U, V = arrays
    model = RefALSModel(user_vocab=users, item_vocab=items, U=U, V=V)
    eng = RefEngine(
        data_source_classes=ref_rec.RecommendationDataSource,
        preparator_classes=ref_rec.RecommendationPreparator,
        algorithm_classes={"als": ref_rec.ALSAlgorithm},
        serving_classes=ref_rec.RecommendationServing)
    result = RefTrainResult(
        models=[model],
        algorithms=[ref_rec.ALSAlgorithm(ref_rec.AlgorithmParams(
            rank=RANK))],
        serving=ref_rec.RecommendationServing(),
        engine_params=RefEngineParams(
            data_source_params=ref_rec.DataSourceParams(app_name=APP)))
    instance = RefEngineInstance(
        id="foldin-incumbent", engine_id=ENGINE_ID, engine_version="1",
        engine_variant=VARIANT, status="COMPLETED")
    return RefQueryServer(
        eng, result, instance, ctx=None,
        serving_config=RefServingConfig(batch_max=16, batch_linger_s=0.0),
        deploy_config=RefDeployConfig(warmup=False, drain_timeout_s=5.0))


def _port_controller(server, **cfg):
    kw = dict(enabled=True, apply_interval_s=0.2, max_pending=64)
    kw.update(cfg)
    return port_foldin.FoldInController(server, FoldinConfig(**kw))


def _ref_controller(server, **cfg):
    kw = dict(enabled=True, apply_interval_s=0.2, max_pending=64)
    kw.update(cfg)
    return ref_foldin.FoldInController(server, RefFoldinConfig(**kw),
                                       registry=server.registry)


class _Side:
    """One package's store, server and controller on its own sqlite
    file, fed the same rating rows."""

    def __init__(self, pkg, path, arrays, **cfg):
        self.pkg = pkg
        if pkg == "reference":
            RefStorage.configure(_config(path))
            self.app_id = RefStorage.get_meta_data_apps().insert(
                RefApp(id=0, name=APP))
            self.store = RefStorage.get_events()
            self.server = _ref_server(arrays)
            self.ctl = _ref_controller(self.server, **cfg)
        else:
            Storage.configure(_config(path))
            self.app_id = Storage.get_meta_data_apps().insert(
                App(id=0, name=APP))
            self.store = Storage.get_events()
            self.server = _port_server(arrays)
            self.ctl = _port_controller(self.server, **cfg)
        self.store.init_channel(self.app_id)

    def insert(self, rows):
        """rows: (user, item, rating)."""
        if self.pkg == "reference":
            evs = [RefEvent(event="rate", entity_type="user", entity_id=u,
                            target_entity_type="item", target_entity_id=i,
                            properties=RefDataMap({"rating": r}))
                   for u, i, r in rows]
        else:
            evs = [Event(event="rate", entity_type="user", entity_id=u,
                         target_entity_type="item", target_entity_id=i,
                         properties=DataMap({"rating": r}))
                   for u, i, r in rows]
        return self.store.insert_batch(evs, self.app_id)

    @property
    def model(self):
        return self.server._unit.result.models[0]

    def top(self, user, num=3):
        if self.pkg == "reference":
            out = self.server._predict(ref_rec.Query(user=user, num=num))
        else:
            out = self.server._predict_batch(
                [port_rec.Query(user=user, num=num)])[0]
        return [(s.item, float(s.score)) for s in out.item_scores]


def _same_answers(got, want):
    assert len(got) == len(want)
    gs = np.array([s for _, s in got])
    ws = np.array([s for _, s in want])
    np.testing.assert_allclose(gs, ws, rtol=SCORE_TOL, atol=SCORE_TOL)
    for (gi, gsc), (wi, wsc) in zip(got, want):
        tied = {i for i, s in want if abs(s - wsc) <= SCORE_TOL}
        assert gi == wi or gi in tied, (got, want)


async def test_controller_pull_solve_swap_and_requeue(stores, tmp_path):
    """Pull, solve, swap; a new item rated by known users folds from its
    raters while their user pass defers, and the deferred users requeue
    and fold next tick; a new user can then anchor on the folded item.
    Every tick's rows equal the reference controller's."""
    arrays = _sorted_arrays()
    sides = []
    for pkg in ("reference", "port"):
        side = _Side(pkg, tmp_path / f"{pkg}.db", arrays)
        base_model = side.model
        side.insert([("newuser", f"i{j}", 4.0) for j in range(5)])
        assert side.top("newuser") == []
        s1 = side.ctl.apply_pending()
        assert s1["users"] == 1
        assert len(side.top("newuser")) == 3
        # the swap pinned the pre-fold-in unit as the rollback standby
        assert side.server._standby.result.models[0] is base_model
        assert side.server._unit.foldin_of is side.server._standby
        assert side.server._unit.foldin_rows == 1
        side.insert([(f"u{j}", "colditem", 2.0) for j in range(3)])
        s2 = side.ctl.apply_pending()
        assert s2["users"] == 0 and s2["items"] == 1
        assert side.ctl.pending_rows() == 3          # deferred users
        s3 = side.ctl.apply_pending()
        assert s3["users"] == 3
        assert side.model.item_index("colditem") is not None
        side.insert([("fresh9", "colditem", 4.0), ("fresh9", "i0", 4.0)])
        s4 = side.ctl.apply_pending()
        assert s4["users"] == 1 and s4["items"] == 0
        assert side.server._standby.result.models[0] is base_model
        assert side.ctl.apply_pending() is None      # quiescent tick
        sides.append(side)
    ref, port = (s.model for s in sides)
    assert list(port.user_vocab) == list(ref.user_vocab)
    assert list(port.item_vocab) == list(ref.item_vocab)
    for user in ("newuser", "u0", "u1", "u2", "fresh9"):
        _close_rows(port.U[port.user_index(user)],
                    ref.U[ref.user_index(user)])
    _close_rows(port.V[port.item_index("colditem")],
                ref.V[ref.item_index("colditem")])
    for user in ("newuser", "fresh9", "u0", "u5"):
        _same_answers(sides[1].top(user, 5), sides[0].top(user, 5))
    # the port's explicit fold matches the dense solve (weighted ridge)
    m0 = ALSModel.from_arrays(*arrays, device="cpu")
    F = m0.V[[m0.item_index(f"i{j}") for j in range(5)]]
    dense = np.linalg.solve(F.T @ F + 0.01 * 5 * np.eye(RANK),
                            F.T @ np.full(5, 4.0, np.float32))
    np.testing.assert_allclose(port.U[port.user_index("newuser")], dense,
                               atol=1e-3)
    st = sides[1].ctl.status_dict()
    assert st["applies"] == 4 and st["appliedUserRows"] == 5
    assert st["appliedItemRows"] == 1 and st["solveCalls"] == 4
    assert st["outcomes"] == {"applied": 4, "empty": 1}
    assert [a["users"] for a in st["recentApplies"]] == [1, 0, 3, 1]


async def test_controller_push_pull_dedup_and_cap(stores, tmp_path):
    side = _Side("port", tmp_path / "port.db", _sorted_arrays(),
                 max_pending=2)
    ctl = side.ctl
    evs = _rate_events("pushuser", ["i0", "i1"])
    ids = side.store.insert_batch(evs, side.app_id)
    evs = [dataclasses.replace(e, event_id=eid) for e, eid in zip(evs, ids)]
    # push first (the tap), then the pull sees the same ids again
    ctl.tap(evs, side.app_id, None)
    assert ctl.pending_rows() == 1
    ctl.pull()
    assert ctl.pending_rows() == 1
    side.insert([(f"cap{j}", "i2", 4.0) for j in range(4)])
    ctl.pull()
    before = ctl.pending_rows()
    assert before >= 5
    ctl.apply_pending()
    assert ctl.pending_rows() == before - 2          # max_pending caps
    ctl.tap(_rate_events("foreign", ["i9"]), side.app_id + 999, None)
    assert all(u != "foreign" for u in ctl._dirty_users)


async def test_read_failure_requeues_entity(stores, tmp_path, monkeypatch):
    """A failed history read loses no delta: the tick's batched read
    fails, each entity is read alone, the failing one is requeued and
    the rest apply; the next tick folds it."""
    side = _Side("port", tmp_path / "port.db", _sorted_arrays())
    side.insert([("flaky", "i0", 4.0), ("flaky", "i1", 4.0),
                 ("steady", "i2", 4.0), ("steady", "i3", 4.0)])
    real = port_foldin.read_entities_ratings
    failures = {"n": 0}

    def flaky_read(spec, ids, side="user"):
        if "flaky" in ids and failures["n"] < 2:
            failures["n"] += 1
            raise RuntimeError("transient storage error")
        return real(spec, ids, side)

    monkeypatch.setattr(port_foldin, "read_entities_ratings", flaky_read)
    stats = side.ctl.apply_pending()
    assert stats["users"] == 1                       # steady folded
    assert "flaky" in side.ctl._dirty_users          # requeued
    s2 = side.ctl.apply_pending()
    assert s2["users"] == 1
    assert side.model.user_index("flaky") is not None


async def test_swap_raced_by_concurrent_cutover(stores, tmp_path,
                                                monkeypatch):
    """A cutover that lands during the solve wins the compare-and-swap;
    the deltas requeue and fold onto the new unit next tick."""
    side = _Side("port", tmp_path / "port.db", _sorted_arrays())
    server = side.server
    side.insert([("raceduser", "i0", 4.0), ("raceduser", "i1", 4.0)])
    real = port_foldin.read_entities_ratings
    raced = {}

    def racing_read(spec, ids, side_="user"):
        if "unit" not in raced:
            raced["unit"] = server.build_foldin_unit(
                list(server._unit.result.models), 0)
            server._unit = raced["unit"]
        return real(spec, ids, side_)

    monkeypatch.setattr(port_foldin, "read_entities_ratings", racing_read)
    assert side.ctl.apply_pending() is None
    assert server._unit is raced["unit"]             # the cutover won
    assert "raceduser" in side.ctl._dirty_users      # delta kept
    assert side.ctl.outcomes["raced"] == 1
    stats = side.ctl.apply_pending()
    assert stats["users"] == 1
    assert side.model.user_index("raceduser") is not None


def test_concurrent_taps_and_applies_lose_no_user(stores, tmp_path):
    """Taps on many threads race a thread applying in a loop (a short
    switch interval): every offered user is folded exactly once it has
    settled, and nothing stays pending."""
    import sys
    import threading

    side = _Side("port", tmp_path / "port.db", _sorted_arrays(),
                 max_pending=5)
    users = [f"racer{t}_{n}" for t in range(8) for n in range(6)]
    evs = [e for u in users for e in _rate_events(u, ["i0", "i3"])]
    ids = side.store.insert_batch(evs, side.app_id)
    evs = [dataclasses.replace(e, event_id=i) for e, i in zip(evs, ids)]
    done = threading.Event()
    errors = []

    def applier():
        while not done.is_set():
            try:
                side.ctl.apply_pending()
            except Exception as e:      # noqa: BLE001 — asserted below
                errors.append(e)

    def tapper(t):
        mine = [e for e in evs if e.entity_id.startswith(f"racer{t}_")]
        for k in range(0, len(mine), 2):
            side.ctl.tap(mine[k:k + 2], side.app_id, None)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        apply_thread = threading.Thread(target=applier)
        apply_thread.start()
        tappers = [threading.Thread(target=tapper, args=(t,))
                   for t in range(8)]
        for th in tappers:
            th.start()
        for th in tappers:
            th.join(timeout=60)
        done.set()
        apply_thread.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not apply_thread.is_alive()
    assert not any(th.is_alive() for th in tappers)
    assert not errors
    while side.ctl.apply_pending() is not None:
        pass
    assert side.ctl.pending_rows() == 0
    assert all(side.model.user_index(u) is not None for u in users)


def test_foldin_apply_carries_device_copies():
    """A user-only fold keeps V and carries the resident V copy and the
    scorer cache; an item fold changes V, so both caches miss."""
    model = ALSModel.from_arrays(*_sorted_arrays(), device="cpu")
    dev = model.V_device
    model._scorer_cache = ("sentinel",)
    algo = port_rec.ALSAlgorithm(port_rec.AlgorithmParams(rank=RANK))
    new = algo.foldin_apply(model, None, {"u0": np.ones(RANK, np.float32)},
                            {}, None)
    assert new.V is model.V and new.V_device is dev
    assert new._scorer_cache is model._scorer_cache
    # the controller's vocab lookups never touch the device copy
    calls = []
    fa = algo.foldin_factors(new)
    fa.device_copy = lambda: calls.append(1)
    assert list(fa.item_vocab) == list(model.item_vocab) and calls == []
    assert new.device == model.device
    grown = algo.foldin_apply(model, None, {},
                              {"zz9": np.ones(RANK, np.float32)}, None)
    assert grown.V.shape[0] == model.V.shape[0] + 1
    assert grown.V_device is not dev


def test_foldin_apply_requantizes_scorer_on_item_fold():
    """On a quantized unit a user-only fold keeps the scorer; an item
    fold rebuilds it on the next scored batch, which serves the new
    item."""
    from predictionio_tpu_torch.ops import scoring

    scoring.set_process_scorer_config(ScorerConfig(mode="fused_int8",
                                                   tile_items=128))
    try:
        model = ALSModel.from_arrays(*_sorted_arrays(n_users=30,
                                                     n_items=40, rank=8),
                                     device="cpu")
        algo = port_rec.ALSAlgorithm(port_rec.AlgorithmParams(rank=8))
        model.recommend_batch([("u1", 5, (), None)])
        scorer = model._scorer_cache[2]
        user_only = algo.foldin_apply(
            model, None, {"u1": np.ones(8, np.float32)}, {}, None)
        user_only.recommend_batch([("u1", 5, (), None)])
        assert user_only._scorer_cache[2] is scorer
        grown = algo.foldin_apply(
            model, None, {}, {"zz9": np.full(8, 2.0, np.float32)}, None)
        out = grown.recommend_batch([("u1", 5, (), None)])
        assert grown._scorer_cache[2] is not scorer
        assert grown._scorer_cache[2].n_items == 41
        assert out[0]
        aligned = ALSModel(user_vocab=np.asarray(["q"], dtype=object),
                           item_vocab=grown.item_vocab,
                           U=np.full((1, 8), 0.5, np.float32), V=grown.V,
                           device="cpu")
        assert aligned.recommend_batch([("q", 1, (), None)])[0][0][0] \
            == "zz9"
    finally:
        scoring.set_process_scorer_config(None)


def test_resolve_foldin_unsupported():
    eng = port_rec.engine()
    result = eng.prepare_deploy(port_rec.default_engine_params(None),
                                [ALSModel.from_arrays(*_sorted_arrays(),
                                                      device="cpu")])
    assert port_foldin.resolve_foldin(result) is None   # no appName
    with pytest.raises(port_foldin.FoldinUnsupported):
        port_foldin.FoldInController(
            QueryServer(eng, result, EngineInstance(id="x")),
            FoldinConfig(enabled=True))


# ---------------------------------------------------------------------------
# the slice as a whole: event server -> query server -> rollback
# ---------------------------------------------------------------------------

async def test_freshness_and_rollback_against_reference(stores, tmp_path):
    """Events POSTed to the port's event server (the push tap) reach the
    port's query server once its controller applies (driven directly,
    never by the timer): new users, more ratings of known users and a
    new item. The folded rows and served answers equal the reference
    controller's on the same model and events. ``POST /rollback.json``
    then restores every pre-fold-in answer byte for byte, the new users
    are unknown again and the registry shows the drift ROLLED_BACK."""
    from predictionio_tpu_torch.server.event_server import EventServer
    from predictionio_tpu_torch.utils.server_config import IngestConfig

    arrays = _sorted_arrays(seed=4)
    rows = ([(f"new{n}", f"i{(3 * n + j) % 18}", float(1 + (n + j) % 5))
             for n in range(3) for j in range(4)]
            + [(f"u{u}", f"i{(u + 7) % 18}", 5.0) for u in range(4)]
            + [(f"u{u}", "brandnew", 4.0) for u in range(5, 9)])
    sample = ["u0", "u3", "u5", "u10", "u20"]

    ref = _Side("reference", tmp_path / "ref.db", arrays)
    ref.insert(rows)
    while ref.ctl.apply_pending() is not None:
        pass

    Storage.configure(_config(tmp_path / "port.db"))
    app_id = Storage.get_meta_data_apps().insert(App(id=0, name=APP))
    Storage.get_events().init_channel(app_id)
    Storage.get_meta_data_access_keys().insert(
        AccessKey(key=KEY, appid=app_id, events=()))
    instance = EngineInstance(
        id="e2e-instance", status="COMPLETED", engine_id=ENGINE_ID,
        engine_version="1", engine_variant=VARIANT,
        data_source_params=json.dumps({"appName": APP}))
    Storage.get_meta_data_engine_instances().insert(instance)
    base_release = record_release(instance, train_seconds=1.0)
    qs = _port_server(arrays, release=base_release, instance=instance)
    qs.access_key = "op-key"
    base_model = qs.result.models[0]
    es = EventServer(ingest=IngestConfig(buffer=True, linger_s=0.0))
    loop = asyncio.get_running_loop()
    q_port = await qs.start("127.0.0.1", 0)
    e_port = await es.start("127.0.0.1", 0)
    session = aiohttp.ClientSession()

    async def answer(user, num=5):
        async with session.post(f"http://127.0.0.1:{q_port}/queries.json",
                                json={"user": user, "num": num}) as r:
            assert r.status == 200
            return await r.read()

    async def get(path):
        async with session.get(f"http://127.0.0.1:{q_port}{path}") as r:
            return r.status, await r.json()

    try:
        assert qs._foldin is not None                # armed at start
        before = {u: await answer(u) for u in sample + ["new0"]}
        assert json.loads(before["new0"])["itemScores"] == []
        wire = [{"event": "rate", "entityType": "user", "entityId": u,
                 "targetEntityType": "item", "targetEntityId": i,
                 "properties": {"rating": r}} for u, i, r in rows]
        async with session.post(
                f"http://127.0.0.1:{e_port}/batch/events.json"
                f"?accessKey={KEY}", json=wire) as r:
            assert r.status == 200
            assert [x["status"] for x in await r.json()] == \
                [201] * len(rows)
        # the push tap marked them once the group commit landed
        deadline = time.monotonic() + 10
        while qs._foldin.pending_rows() < 8 and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        ticks = 0
        while await loop.run_in_executor(
                qs._deploy_executor, qs._foldin.apply_pending) is not None:
            ticks += 1
        assert ticks == 2            # users + the new item, then deferred
        port = qs.result.models[0]
        refm = ref.model
        assert list(port.user_vocab) == list(refm.user_vocab)
        assert list(port.item_vocab) == list(refm.item_vocab)
        for u in [f"new{n}" for n in range(3)] + [f"u{u}" for u in range(9)]:
            _close_rows(port.U[port.user_index(u)],
                        refm.U[refm.user_index(u)])
        _close_rows(port.V[port.item_index("brandnew")],
                    refm.V[refm.item_index("brandnew")])
        for u in sample + ["new0", "new2"]:
            got = [(s["item"], s["score"])
                   for s in json.loads(await answer(u))["itemScores"]]
            _same_answers(got, ref.top(u, 5))
        status, st = await get("/deploy/status.json")
        assert status == 200 and st["foldin"]["enabled"] is True
        assert st["foldin"]["appliedUserRows"] == 3 + 4 + 4
        assert st["foldin"]["appliedItemRows"] == 1
        assert st["standby"]["releaseVersion"] == base_release.version
        assert st["active"]["releaseVersion"] == base_release.version + 1
        status, root = await get("/")
        assert root["foldin"]["solveCalls"] == st["foldin"]["solveCalls"]
        # the drift is a release row over the base
        rels = Storage.get_meta_data_releases()
        drift = next(r for r in rels.get_for_variant(ENGINE_ID, "1",
                                                     VARIANT)
                     if r.batch.startswith("foldin drift"))
        assert drift.status == "LIVE" and drift.model_digest == ""
        assert drift.version == base_release.version + 1
        assert rels.get(base_release.id).status == "RETIRED"

        url = f"http://127.0.0.1:{q_port}/rollback.json"
        async with session.post(url) as r:
            assert r.status == 401
        async with session.post(url + "?accessKey=op-key") as r:
            assert r.status == 200, await r.text()
            body = await r.json()
        assert body["releaseVersion"] == base_release.version
        assert qs.result.models[0] is base_model
        for u in sample + ["new0"]:
            assert await answer(u) == before[u]
        for n in range(3):
            assert json.loads(await answer(f"new{n}"))["itemScores"] == []
        assert rels.get(drift.id).status == "ROLLED_BACK"
        assert rels.get(base_release.id).status == "LIVE"
        # nothing older to roll back to
        async with session.post(url + "?accessKey=op-key") as r:
            assert r.status == 404
    finally:
        await session.close()
        await es.close()
        await qs.close()


async def test_rollback_after_reload_loads_previous_release(stores,
                                                            tmp_path):
    """Without a resident standby (a fresh server), rollback loads the
    newest older release from the registry."""
    from predictionio_tpu_torch.workflow.serialization import (
        serialize_models,
    )

    Storage.configure(_config(tmp_path / "port.db"))
    rels = []
    for n, seed in enumerate((1, 2)):
        inst = EngineInstance(
            id=f"inst{n}", status="COMPLETED", engine_id=ENGINE_ID,
            engine_version="1", engine_variant=VARIANT,
            engine_factory="predictionio_tpu_torch.engines."
                           "recommendation:engine",
            data_source_params=json.dumps({"appName": APP}),
            algorithms_params=json.dumps([{"name": "als", "params": {
                "rank": RANK}}]))
        Storage.get_meta_data_engine_instances().insert(inst)
        model = ALSModel.from_arrays(*_sorted_arrays(seed=seed),
                                     device="cpu")
        from predictionio_tpu_torch.storage.base import Model

        blob = serialize_models([model])
        Storage.get_model_data_models().insert(Model(id=inst.id,
                                                     models=blob))
        rels.append((inst, record_release(inst, 1.0, blob), model))
    # v1 served once and was superseded by v2
    Storage.get_meta_data_releases().set_status(rels[0][1].id, "RETIRED")
    inst, rel, _ = rels[1]
    qs = _port_server(_sorted_arrays(seed=2), release=rel, instance=inst,
                      foldin=FoldinConfig(enabled=False))
    port = await qs.start("127.0.0.1", 0)
    try:
        async with aiohttp.ClientSession() as session:
            async with session.post(
                    f"http://127.0.0.1:{port}/rollback.json") as r:
                assert r.status == 200, await r.text()
                body = await r.json()
            async with session.get(
                    f"http://127.0.0.1:{port}/deploy/status.json") as r:
                st = await r.json()
        assert body["engineInstanceId"] == "inst0"
        assert body["releaseVersion"] == rels[0][1].version
        assert st["foldin"] == {"enabled": False}
        assert st["standby"] is None
        np.testing.assert_array_equal(qs.result.models[0].U,
                                      rels[0][2].U)
    finally:
        await qs.close()
