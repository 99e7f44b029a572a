"""The training slice as a whole, against the JAX package.

* The JAX package writes rate and buy events into a sqlite file; the
  reference trains its recommendation engine from it (one-device mesh),
  and the port's ``Engine.train`` reads the same file and trains from the
  reference's initial item factors (the port's seeded init is patched to
  supply them). The vocabularies are equal and the factors agree within
  atol 5e-5 + rtol 1e-4 (the same sweeps in f32, sums in another order).
* The port's ``deploy`` of the trained model (through its ``.npz``) and
  the reference's ``create_query_server`` answer the same
  ``/queries.json`` with the same items, scores within rtol 1e-3.
* Both directions of the store: the port reads a store the reference
  wrote (above), and the reference reads one the port wrote (the same
  events and the same training columns).
* A rate event without a rating raises ``ValueError`` in both.
* The train CLI on the CPU writes a model file that deploys.
"""

import json
import subprocess
import sys
import types

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

import predictionio_tpu.data.eventstore as ref_eventstore
import predictionio_tpu.engines.recommendation as ref_rec
import predictionio_tpu_torch.data.eventstore as port_eventstore
import predictionio_tpu_torch.engines.recommendation as port_rec
import predictionio_tpu_torch.models.als as port_als
from predictionio_tpu.data import DataMap as RefDataMap, Event as RefEvent
from predictionio_tpu.server.query_server import (
    create_query_server as ref_create_query_server,
)
from predictionio_tpu.storage import App as RefApp, Storage as RefStorage
from predictionio_tpu.workflow import run_train
from predictionio_tpu.workflow.context import WorkflowContext
from predictionio_tpu.workflow.train import load_for_deploy
from predictionio_tpu_torch.data.event import Event as PortEvent
from predictionio_tpu_torch.deploy.warm import EngineInstance
from predictionio_tpu_torch.server.query_server import create_query_server
from predictionio_tpu_torch.storage.base import App as PortApp
from predictionio_tpu_torch.storage.registry import Storage as PortStorage
from predictionio_tpu_torch.utils.server_config import ScorerConfig
from predictionio_tpu_torch.workflow.serialization import (
    load_model, save_model,
)

pytestmark = pytest.mark.anyio

APP = "TorchTrainApp"
RANK, ITERS = 8, 8
ATOL, RTOL = 5e-5, 1e-4


def _config(path):
    return {
        "sources": {"DB": {"TYPE": "sqlite", "PATH": str(path)}},
        "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                         for r in ("METADATA", "EVENTDATA", "MODELDATA")},
    }


def _event_rows(seed=7, n_users=30, n_items=20):
    """(event, user, item, rating or None) with block structure, plus
    buy events (implicit 4.0)."""
    rng = np.random.default_rng(seed)
    rows = []
    for u in range(n_users):
        for it in range(n_items):
            if (u % 2) == (it % 2) and rng.random() < 0.7:
                rows.append(("rate", f"u{u}", f"i{it}",
                             float(rng.integers(3, 6))))
            elif rng.random() < 0.2:
                rows.append(("rate", f"u{u}", f"i{it}",
                             float(rng.integers(1, 3))))
    rows += [("buy", f"u{u}", f"i{(u * 3) % n_items}", None)
             for u in range(0, n_users, 5)]
    return rows


def _events(cls, datamap, rows):
    return [cls(event=e, entity_type="user", entity_id=u,
                target_entity_type="item", target_entity_id=i,
                properties=datamap({} if r is None else {"rating": r}))
            for e, u, i, r in rows]


@pytest.fixture()
def stores(tmp_path):
    """Both packages' storage registries, each on its own sqlite file."""
    def reset():
        RefStorage.reset()
        PortStorage.reset()
        ref_eventstore.clear_cache()
        port_eventstore.clear_cache()

    reset()
    yield tmp_path
    reset()


def _ref_write(path, rows):
    RefStorage.configure(_config(path))
    ref_eventstore.clear_cache()
    app_id = RefStorage.get_meta_data_apps().insert(RefApp(id=0, name=APP))
    store = RefStorage.get_events()
    store.init_channel(app_id)
    store.insert_batch(_events(RefEvent, RefDataMap, rows), app_id)


def _port_write(path, rows):
    PortStorage.configure(_config(path))
    port_eventstore.clear_cache()
    app_id = PortStorage.get_meta_data_apps().insert(PortApp(id=0, name=APP))
    store = PortStorage.get_events()
    store.init_channel(app_id)
    store.insert_batch(_events(PortEvent, dict, rows), app_id)


def _reference_init_V(seed, n_items):
    V = (jax.random.normal(jax.random.PRNGKey(seed), (n_items, RANK),
                           jnp.float32) / jnp.sqrt(jnp.float32(RANK)))
    return np.asarray(V)


def _ref_train():
    engine = ref_rec.engine()
    instance = run_train(
        engine, ref_rec.default_engine_params(APP, rank=RANK,
                                              num_iterations=ITERS),
        engine_factory="predictionio_tpu.engines.recommendation:engine",
        ctx=WorkflowContext(mode="Training", devices=jax.devices()[:1]))
    result, ctx = load_for_deploy(engine, instance)
    return engine, instance, result, ctx


def _port_train(monkeypatch, seed=3):
    def init(n_items, n_items_pad, k, s, device):
        import torch

        assert (s, k) == (seed, RANK)
        V = np.zeros((n_items_pad, k), np.float32)
        V[:n_items] = _reference_init_V(s, n_items)
        return torch.from_numpy(V).to(device)

    monkeypatch.setattr(port_als, "_init_item_factors", init)
    engine = port_rec.engine()
    ep = port_rec.default_engine_params(APP, rank=RANK,
                                        num_iterations=ITERS)
    return engine, engine.train(types.SimpleNamespace(device="cpu"), ep)


QUERIES = [
    {"user": "u1", "num": 4},
    {"user": "u2", "num": 5},
    {"user": "u0", "num": 10},
    {"user": "u3", "num": 3, "blackList": ["i1", "i3"]},
    {"user": "u4", "num": 6, "whiteList": ["i0", "i2", "i4", "i5", "i7"]},
    {"user": "ghost", "num": 4},
]


async def test_port_trains_from_reference_store_and_serves_alike(
        stores, monkeypatch, tmp_path):
    db = stores / "ref.db"
    _ref_write(db, _event_rows())
    ref_engine, instance, ref_result, ref_ctx = _ref_train()
    ref_model = ref_result.models[0]

    PortStorage.configure(_config(db))
    port_engine, port_result = _port_train(monkeypatch)
    model = port_result.models[0]
    assert list(model.user_vocab) == list(ref_model.user_vocab)
    assert list(model.item_vocab) == list(ref_model.item_vocab)
    assert model.train_info["nnz"] == len(_event_rows())
    np.testing.assert_allclose(model.U, ref_model.U, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(model.V, ref_model.V, atol=ATOL, rtol=RTOL)

    path = tmp_path / "model.npz"
    save_model(path, model)
    deployed = port_engine.prepare_deploy(
        port_engine.engine_params_from_json(
            {"datasource": {"params": {"appName": APP}},
             "algorithms": [{"name": "als", "params": {"rank": RANK}}]}),
        [load_model(path, device="cpu")])
    server = create_query_server(port_engine, deployed,
                                 EngineInstance(id="trained"),
                                 scorer_config=ScorerConfig(mode="exact"))
    server.warm()
    ref_server = ref_create_query_server(ref_engine, ref_result, instance,
                                         ref_ctx)
    ref_client = TestClient(TestServer(ref_server.app))
    await ref_client.start_server()
    port = await server.start("127.0.0.1", 0)
    try:
        async with aiohttp.ClientSession() as session:
            for q in QUERIES:
                want_resp = await ref_client.post("/queries.json", json=q)
                want = await want_resp.json()
                async with session.post(
                        f"http://127.0.0.1:{port}/queries.json",
                        json=q) as resp:
                    assert resp.status == want_resp.status == 200
                    got = await resp.json()
                assert ([s["item"] for s in got["itemScores"]]
                        == [s["item"] for s in want["itemScores"]]), q
                np.testing.assert_allclose(
                    [s["score"] for s in got["itemScores"]],
                    [s["score"] for s in want["itemScores"]], rtol=1e-3)
                if q["user"] == "ghost":
                    assert got["itemScores"] == []
    finally:
        await server.close()
        await ref_client.close()


def test_reference_reads_a_store_the_port_wrote(stores):
    db = stores / "port.db"
    rows = _event_rows(seed=9)
    _port_write(db, rows)
    RefStorage.configure(_config(db))
    ref_eventstore.clear_cache()
    ref_events = list(ref_eventstore.EventStoreClient.find(APP))
    port_events = list(port_eventstore.EventStoreClient.find(APP))
    assert len(ref_events) == len(port_events) == len(rows)
    for a, b in zip(ref_events, port_events):
        assert (a.event_id, a.event, a.entity_id, a.target_entity_id,
                a.event_time, a.creation_time) == (
            b.event_id, b.event, b.entity_id, b.target_entity_id,
            b.event_time, b.creation_time)
        assert a.properties.fields == b.properties.fields

    ref_cols = ref_rec.RecommendationDataSource(
        ref_rec.DataSourceParams(app_name=APP))._read_columns()
    port_cols = port_rec.RecommendationDataSource(
        port_rec.DataSourceParams(app_name=APP))._read_columns()

    def triples(c):
        return sorted(zip(c.users.tolist(), c.items.tolist(),
                          c.values.tolist()))

    assert triples(ref_cols) == triples(port_cols)
    want = sorted((u, i, 4.0 if r is None else r) for _, u, i, r in rows)
    assert triples(port_cols) == want


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_rate_without_rating_raises_in_both(stores, writer):
    db = stores / f"{writer}.db"
    rows = _event_rows(seed=4)[:20] + [("rate", "u9", "i9", None)]
    (_ref_write if writer == "reference" else _port_write)(db, rows)
    RefStorage.configure(_config(db))
    PortStorage.configure(_config(db))
    ref_eventstore.clear_cache()
    port_eventstore.clear_cache()
    with pytest.raises(ValueError, match="rating"):
        ref_rec.RecommendationDataSource(
            ref_rec.DataSourceParams(app_name=APP)).read_training(None)
    with pytest.raises(ValueError, match="rating"):
        port_rec.engine().train(
            types.SimpleNamespace(device="cpu"),
            port_rec.default_engine_params(APP, rank=4, num_iterations=1))


def test_train_cli_writes_a_model_that_deploys(stores, tmp_path):
    db = stores / "cli.db"
    _port_write(db, _event_rows(seed=11))
    PortStorage.reset()
    variant = tmp_path / "engine.json"
    variant.write_text(json.dumps({
        "id": "default",
        "engineFactory": "predictionio_tpu_torch.engines.recommendation:"
                         "engine",
        "datasource": {"params": {"appName": APP}},
        "algorithms": [{"name": "als", "params": {
            "rank": 6, "numIterations": 4, "lambda": 0.01}}]}))
    out = tmp_path / "m.npz"
    env = {"PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
           "PIO_STORAGE_SOURCES_DB_PATH": str(db),
           "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "pio",
           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "pio",
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "DB",
           "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    proc = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "train",
         "--variant", str(variant), "--out", str(out), "--device", "cpu"],
        cwd=str(port_rec.__file__).rsplit("/predictionio_tpu_torch/", 1)[0],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["nnz"] == len(_event_rows(seed=11))
    assert line["launches"] == {"shortlist": 0, "spd_solve": 0}
    assert (line["users"], line["items"], line["rank"]) == (30, 20, 6)
    model = load_model(out, device="cpu")
    assert model.U.shape == (30, 6) and np.isfinite(model.U).all()
    recs = model.recommend("u1", 3)
    assert len(recs) == 3
