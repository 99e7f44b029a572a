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
* The whole lifecycle through the port's CLI and servers on the CPU:
  eventserver, app and keys, events over REST, train into the instance,
  model and release stores, deploy of the latest release, a retrain and
  ``GET /reload`` to it.
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
           "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "pio",
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
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


# -- the whole lifecycle through the port's servers, on the CPU ------------

ROOT = str(port_rec.__file__).rsplit("/predictionio_tpu_torch/", 1)[0]


class _Proc:
    """A port CLI command in a subprocess whose stdout is followed until
    it prints its ``listening on`` line."""

    def __init__(self, args, env):
        import queue
        import threading

        self.proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli.main",
             *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.lines = queue.Queue()
        threading.Thread(target=lambda: [self.lines.put(x) for x in
                                         self.proc.stdout],
                         daemon=True).start()

    def port(self, timeout=120):
        import queue

        out = []
        while True:
            try:
                line = self.lines.get(timeout=timeout)
            except queue.Empty:
                raise AssertionError(f"no listening line: {out}") from None
            out.append(line)
            if "listening on" in line:
                return int(line.rsplit(":", 1)[1])
            assert self.proc.poll() is None, "".join(out)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.terminate()
        return self.proc.wait(timeout=60)


def _http(port, method, path, body=None):
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    c.request(method, path, body=None if body is None else json.dumps(body),
              headers={"Content-Type": "application/json"})
    r = c.getresponse()
    out = r.status, json.loads(r.read())
    c.close()
    return out


def _exact_top(model, user, k):
    ui = model.user_index(user)
    scores = model.V @ model.U[ui]
    order = np.argsort(-scores, kind="stable")[:k]
    return [str(model.item_vocab[j]) for j in order], scores[order]


def test_whole_lifecycle_on_cpu(stores, tmp_path):
    """eventserver -> app/accesskey -> POST /batch/events.json -> train
    (instance 1, release v1) -> deploy the latest release -> more events
    with new users -> train (v2) -> GET /reload -> instance 2's answers,
    every step through the port's CLI and servers on the CPU."""
    from predictionio_tpu_torch.cli.main import main
    from predictionio_tpu_torch.storage.registry import Storage
    from predictionio_tpu_torch.workflow.serialization import (
        deserialize_models,
    )

    db = tmp_path / "life.db"
    env = {"PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
           "PIO_STORAGE_SOURCES_DB_PATH": str(db),
           "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
           "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "models"),
           "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    for repo, src in (("METADATA", "DB"), ("EVENTDATA", "DB"),
                      ("MODELDATA", "FS")):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_NAME"] = "pio"
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = src
    PortStorage.configure({
        "sources": {"DB": {"TYPE": "sqlite", "PATH": str(db)},
                    "FS": {"TYPE": "localfs",
                           "PATH": str(tmp_path / "models")}},
        "repositories": {"METADATA": {"NAME": "pio", "SOURCE": "DB"},
                         "EVENTDATA": {"NAME": "pio", "SOURCE": "DB"},
                         "MODELDATA": {"NAME": "pio", "SOURCE": "FS"}}})
    assert main(["app", "new", APP, "--access-key", "k1"]) == 0
    with pytest.raises(SystemExit) as dup:
        main(["app", "new", APP])
    assert dup.value.code == 1
    assert main(["accesskey", "new", APP, "--key", "k2",
                 "--event", "rate"]) == 0
    variant = tmp_path / "engine.json"
    variant.write_text(json.dumps({
        "id": "default",
        "engineFactory": "predictionio_tpu_torch.engines.recommendation:"
                         "engine",
        "datasource": {"params": {"appName": APP}},
        "algorithms": [{"name": "als", "params": {
            "rank": 6, "numIterations": 4, "lambda": 0.05}}]}))

    def wire(rows):
        return [{"event": e, "entityType": "user", "entityId": u,
                 "targetEntityType": "item", "targetEntityId": i,
                 **({} if r is None else {"properties": {"rating": r}})}
                for e, u, i, r in rows]

    es = _Proc(["eventserver", "--ip", "127.0.0.1", "--port", "0"], env)
    server = None
    try:
        es_port = es.port()
        first = wire(_event_rows(seed=21))
        for s in range(0, len(first), 50):
            status, body = _http(es_port, "POST",
                                 "/batch/events.json?accessKey=k2",
                                 first[s:s + 50])
            assert status == 200
            # k2 takes rate events only: buy events answer 403
            assert [r["status"] for r in body] == [
                201 if ev["event"] == "rate" else 403
                for ev in first[s:s + 50]]
        status, _ = _http(es_port, "POST", "/batch/events.json?accessKey=no",
                          first[:2])
        assert status == 401
        n_rate = sum(ev["event"] == "rate" for ev in first)

        def train():
            proc = subprocess.run(
                [sys.executable, "-m", "predictionio_tpu_torch.cli.main",
                 "train", "--variant", str(variant), "--device", "cpu"],
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=300)
            assert proc.returncode == 0, proc.stderr[-3000:]
            return json.loads(proc.stdout.strip().splitlines()[-1])

        t1 = train()
        assert (t1["nnz"], t1["release"], t1["out"]) == (n_rate, 1, None)
        server = _Proc(["deploy", "--variant", str(variant), "--ip",
                        "127.0.0.1", "--port", "0", "--device", "cpu",
                        "--accesskey", "secret"], env)
        q_port = server.port()
        status, root = _http(q_port, "GET", "/")
        assert root["engineInstance"]["id"] == t1["instance"]
        assert root["engineInstance"]["releaseVersion"] == 1

        def models_of(instance_id):
            blob = Storage.get_model_data_models().get(instance_id).models
            return deserialize_models(blob, device="cpu")[0]

        m1 = models_of(t1["instance"])
        got = _http(q_port, "POST", "/queries.json",
                    {"user": "u1", "num": 5})[1]["itemScores"]
        assert [s["item"] for s in got] == _exact_top(m1, "u1", 5)[0]
        assert _http(q_port, "POST", "/queries.json",
                     {"user": "newbie", "num": 5})[1] == {"itemScores": []}

        more = wire([("rate", "newbie", f"i{j}", 5.0) for j in range(6)]
                    + [("rate", f"u{u}", "i3", 4.0) for u in range(10)])
        status, body = _http(es_port, "POST",
                             "/batch/events.json?accessKey=k1", more)
        assert all(r["status"] == 201 for r in body)
        t2 = train()
        assert (t2["nnz"], t2["release"]) == (n_rate + len(more), 2)

        assert _http(q_port, "GET", "/reload")[0] == 401
        status, body = _http(q_port, "GET", "/reload?accessKey=secret")
        assert status == 200, body
        assert (body["engineInstanceId"], body["releaseVersion"]) == (
            t2["instance"], 2)
        m2 = models_of(t2["instance"])
        for user in ("newbie", "u1", "u7"):
            got = _http(q_port, "POST", "/queries.json",
                        {"user": user, "num": 5})[1]["itemScores"]
            want, scores = _exact_top(m2, user, 5)
            assert [s["item"] for s in got] == want
            np.testing.assert_allclose([s["score"] for s in got], scores,
                                       rtol=1e-5, atol=1e-6)
        status, listing = _http(q_port, "GET", "/releases.json")
        assert [(r["version"], r["status"]) for r in listing["releases"]] \
            == [(2, "LIVE"), (1, "RETIRED")]
        assert listing["serving"]["releaseVersion"] == 2
        assert _http(q_port, "POST", "/stop?accessKey=secret")[0] == 200
        assert server.proc.wait(timeout=60) == 0
    finally:
        if server is not None:
            server.stop()
        # SIGTERM: the event server drains its buffer and exits cleanly
        assert es.stop() == 0
