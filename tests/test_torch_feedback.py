"""The query server's feedback loop and remote error log in the port
(``server/query_server.py``, ``deploy --feedback --event-server-app
--log-url --log-prefix`` and ``undeploy`` in ``cli/main.py``), held
against the JAX package:

* each answer carries a ``prId`` and is recorded as a ``predict`` event
  (entity type ``pio_pr``, entity id the ``prId``, properties ``query``
  and ``prediction``) equal to the reference's for the same query and
  prediction; a ``prId`` the model set itself is kept;
* a failed query posts ``log_prefix + json({engineInstance: {id,
  engineId, engineVariant}, message})`` to ``log_url`` with the
  reference's keys, prefix and message head; a sink that never answers
  delays the 400 by less than 0.5 s (the reference awaits the POST, the
  port does not);
* through the CLI on the CPU: ``deploy --feedback`` records one event a
  query, ``--log-url`` receives the failure, and ``undeploy`` stops the
  server, which exits 0.
"""

import asyncio
import dataclasses
import http.server
import json
import os
import pathlib
import socket
import subprocess
import sys
import threading
import time

import aiohttp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

import predictionio_tpu.data.eventstore as ref_eventstore
import predictionio_tpu_torch.data.eventstore as port_eventstore
from predictionio_tpu.core.engine import TrainResult as RefTrainResult
from predictionio_tpu.core.params import EngineParams as RefEngineParams
from predictionio_tpu.engines import recommendation as ref_rec
from predictionio_tpu.models.als import ALSModel as RefALSModel
from predictionio_tpu.server.query_server import QueryServer as RefQueryServer
from predictionio_tpu.storage import App as RefApp
from predictionio_tpu.storage import Storage as RefStorage
from predictionio_tpu.storage.base import EngineInstance as RefEngineInstance
from predictionio_tpu.utils.server_config import (
    DeployConfig as RefDeployConfig, ServingConfig as RefServingConfig,
)
from predictionio_tpu_torch.engines import recommendation as port_rec
from predictionio_tpu_torch.models.als import ALSModel
from predictionio_tpu_torch.server.query_server import QueryServer
from predictionio_tpu_torch.storage.base import App, EngineInstance
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.server_config import ScorerConfig
from predictionio_tpu_torch.workflow.serialization import save_model

pytestmark = pytest.mark.anyio

ROOT = pathlib.Path(__file__).resolve().parent.parent
APP = "FeedbackApp"
QUERIES = [{"user": "u1", "num": 3}, {"user": "u4", "num": 2},
           {"user": "nobody", "num": 3},
           {"user": "u2", "num": 4, "blackList": ["i1"]}]


def _config(path):
    return {"sources": {"DB": {"TYPE": "sqlite", "PATH": str(path)}},
            "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                             for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}}


@pytest.fixture()
def stores(tmp_path):
    """Each package's store on its own sqlite file, with the feedback
    app."""
    def reset():
        Storage.reset()
        RefStorage.reset()
        port_eventstore.clear_cache()
        ref_eventstore.clear_cache()

    reset()
    Storage.configure(_config(tmp_path / "port.db"))
    RefStorage.configure(_config(tmp_path / "ref.db"))
    ids = []
    for storage, app in ((Storage, App), (RefStorage, RefApp)):
        app_id = storage.get_meta_data_apps().insert(app(id=0, name=APP))
        storage.get_events().init_channel(app_id)
        ids.append(app_id)
    yield ids
    reset()


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return (np.asarray([f"u{i}" for i in range(8)], dtype=object),
            np.asarray([f"i{i}" for i in range(12)], dtype=object),
            rng.normal(size=(8, 4)).astype(np.float32),
            rng.normal(size=(12, 4)).astype(np.float32))


class TaggedServing(port_rec.RecommendationServing):
    """A serving whose answers carry the model's own prId."""

    def serve(self, query, predictions):
        return {**super().serve(query, predictions).to_dict(),
                "prId": f"model-{query.user}"}


class RefTaggedServing(ref_rec.RecommendationServing):
    def serve(self, query, predictions):
        return {**super().serve(query, predictions).to_dict(),
                "prId": f"model-{query.user}"}


def _port_server(tagged=False, **kw) -> QueryServer:
    eng = port_rec.engine()
    result = eng.prepare_deploy(
        port_rec.default_engine_params(rank=4),
        [ALSModel.from_arrays(*_arrays(), device="cpu")])
    if tagged:
        result = dataclasses.replace(result, serving=TaggedServing())
    return QueryServer(
        eng, result, EngineInstance(id="fb", engine_id="fb-engine",
                                    engine_variant="fb-variant"),
        scorer_config=ScorerConfig(mode="exact"), max_batch=4,
        linger_s=0.0, **kw)


def _ref_server(tagged=False, **kw) -> RefQueryServer:
    users, items, U, V = _arrays()
    return RefQueryServer(
        ref_rec.engine(), RefTrainResult(
            models=[RefALSModel(user_vocab=users, item_vocab=items, U=U,
                                V=V)],
            algorithms=[ref_rec.ALSAlgorithm(ref_rec.AlgorithmParams(
                rank=4))],
            serving=(RefTaggedServing() if tagged
                     else ref_rec.RecommendationServing()),
            engine_params=RefEngineParams()),
        RefEngineInstance(id="fb", engine_id="fb-engine",
                          engine_variant="fb-variant"), ctx=None,
        serving_config=RefServingConfig(batch_max=4, batch_linger_s=0.0),
        deploy_config=RefDeployConfig(warmup=False), **kw)


async def _wait_events(storage, app_id, n, timeout=10.0):
    """The feedback writes land off the response path."""
    deadline = time.monotonic() + timeout
    while True:
        got = list(storage.get_events().find(app_id,
                                             entity_type="pio_pr"))
        if len(got) >= n or time.monotonic() > deadline:
            return got
        await asyncio.sleep(0.02)


async def _both(queries, tagged, port_kw, ref_kw):
    """Every query through both servers: (port answers, ref answers)."""
    server = _port_server(tagged, **port_kw)
    ref_server = _ref_server(tagged, **ref_kw)
    ref_client = TestClient(TestServer(ref_server.app))
    await ref_client.start_server()
    port = await server.start("127.0.0.1", 0)
    got, want = [], []
    try:
        async with aiohttp.ClientSession() as session:
            for q in queries:
                t0 = time.perf_counter()
                async with session.post(
                        f"http://127.0.0.1:{port}/queries.json",
                        json=q) as r:
                    got.append((r.status, await r.json(),
                                time.perf_counter() - t0))
                resp = await ref_client.post("/queries.json", json=q)
                want.append((resp.status, await resp.json()))
    finally:
        await server.close()
        await ref_client.close()
    return got, want


@pytest.mark.parametrize("tagged", [False, True])
async def test_predict_event_matches_reference(stores, tagged):
    port_app, ref_app = stores
    kw = dict(feedback=True, feedback_app_name=APP)
    got, want = await _both(QUERIES, tagged, kw, kw)
    port_events = await _wait_events(Storage, port_app, len(QUERIES))
    ref_events = await _wait_events(RefStorage, ref_app, len(QUERIES))
    assert len(port_events) == len(ref_events) == len(QUERIES)
    by_id = {e.entity_id: e for e in port_events}
    ref_by_id = {e.entity_id: e for e in ref_events}
    for q, (status, body, _), (ref_status, ref_body) in zip(QUERIES, got,
                                                            want):
        assert status == ref_status == 200
        pr, ref_pr = body["prId"], ref_body["prId"]
        if tagged:
            assert pr == ref_pr == f"model-{q['user']}"
        else:
            assert len(pr) == len(ref_pr) == 32 and pr != ref_pr
        e, r = by_id[pr], ref_by_id[ref_pr]
        assert (e.event, e.entity_type, e.target_entity_type) == \
            (r.event, r.entity_type, r.target_entity_type) == \
            ("predict", "pio_pr", None)
        props, ref_props = e.properties.fields, r.properties.fields
        assert props["query"] == ref_props["query"] == q
        assert props["prediction"] == body
        assert ref_props["prediction"] == ref_body
        assert props["prediction"]["itemScores"] == pytest.approx(
            ref_props["prediction"]["itemScores"])
        assert set(props) == set(ref_props) == {"query", "prediction"}


async def test_no_feedback_without_the_app(stores):
    port_app, _ = stores
    got, want = await _both(QUERIES[:2], False, dict(feedback=True),
                            dict(feedback=True))
    assert all("prId" not in b for _, b, _ in got)
    assert all("prId" not in b for _, b in want)
    assert await _wait_events(Storage, port_app, 1, timeout=0.3) == []


class _Sink:
    """A stdlib HTTP sink that records each body, answering after
    ``delay_s``; ``silent`` accepts connections and never answers."""

    def __init__(self, delay_s=0.0, silent=False):
        self.bodies = []
        sink = self
        if silent:
            self.sock = socket.socket()
            self.sock.bind(("127.0.0.1", 0))
            self.sock.listen(8)
            self.port = self.sock.getsockname()[1]
            self.httpd = None
            return

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                sink.bodies.append((self.rfile.read(n).decode(),
                                    self.headers.get("Content-Type")))
                time.sleep(delay_s)
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.port}/log"

    def wait(self, n, timeout=10.0):
        deadline = time.monotonic() + timeout
        while len(self.bodies) < n and time.monotonic() < deadline:
            time.sleep(0.02)
        return self.bodies

    def close(self):
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
        else:
            self.sock.close()


async def test_remote_log_payload_matches_reference():
    sink, ref_sink = _Sink(), _Sink()
    bad = {"num": 3}                               # no user
    try:
        got, want = await _both(
            [bad], False, dict(log_url=sink.url, log_prefix="PIO>"),
            dict(log_url=ref_sink.url, log_prefix="PIO>"))
        assert got[0][0] == want[0][0] == 400
        (body, ctype), = sink.wait(1)
        (ref_body, ref_ctype), = ref_sink.wait(1)
    finally:
        sink.close()
        ref_sink.close()
    assert body.startswith("PIO>") and ref_body.startswith("PIO>")
    payload, ref_payload = json.loads(body[4:]), json.loads(ref_body[4:])
    assert payload["engineInstance"] == ref_payload["engineInstance"] == {
        "id": "fb", "engineId": "fb-engine", "engineVariant": "fb-variant"}
    assert set(payload) == set(ref_payload) == {"engineInstance",
                                                "message"}
    head = f"Query:\n{json.dumps(bad)}\n\nError:\n"
    assert payload["message"].startswith(head)
    assert ref_payload["message"].startswith(head)
    assert ctype.split(";")[0] == ref_ctype.split(";")[0] == "text/plain"


async def test_silent_sink_does_not_delay_the_400():
    sink = _Sink(silent=True)
    server = _port_server(log_url=sink.url, log_prefix="x")
    port = await server.start("127.0.0.1", 0)
    try:
        async with aiohttp.ClientSession() as session:
            for _ in range(3):
                t0 = time.perf_counter()
                async with session.post(
                        f"http://127.0.0.1:{port}/queries.json",
                        json={"user": 5}) as r:
                    assert r.status == 400
                    await r.read()
                assert time.perf_counter() - t0 < 0.5
            async with session.post(f"http://127.0.0.1:{port}/queries.json",
                                    json={"user": "u1", "num": 2}) as r:
                assert r.status == 200
    finally:
        await server.close()
        sink.close()


def _cli(args, env, **kw):
    return subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.main", *args],
        cwd=str(ROOT), env=env, capture_output=True, text=True,
        timeout=120, **kw)


def test_cli_deploy_feedback_log_and_undeploy(tmp_path):
    """deploy --feedback --event-server-app --log-url --log-prefix on the
    CPU: one predict event per answered query with its prId, the
    failure's body at the sink while the 400 is already out, then
    ``undeploy`` exits 0 and so does the server."""
    import queue

    db = tmp_path / "cli.db"
    env = dict(os.environ, **{
        "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_DB_PATH": str(db),
        **{f"PIO_STORAGE_REPOSITORIES_{r}_{k}": v
           for r in ("METADATA", "EVENTDATA", "MODELDATA")
           for k, v in (("NAME", "pio"), ("SOURCE", "DB"))}})
    Storage.reset()
    port_eventstore.clear_cache()
    Storage.configure(_config(db))
    sink = _Sink(delay_s=2.0)
    proc = None
    try:
        app_id = Storage.get_meta_data_apps().insert(App(id=0, name=APP))
        Storage.get_events().init_channel(app_id)
        model = tmp_path / "m.npz"
        save_model(model, ALSModel.from_arrays(*_arrays(), device="cpu"))
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli.main",
             "deploy", "--model", str(model), "--port", "0", "--device",
             "cpu", "--accesskey", "k", "--feedback",
             "--event-server-app", APP, "--log-url", sink.url,
             "--log-prefix", "P:"],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        lines = queue.Queue()
        threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                         daemon=True).start()
        out = []
        while True:
            line = lines.get(timeout=120)
            out.append(line)
            if "listening on" in line:
                port = int(line.rsplit(":", 1)[1])
                break
            assert proc.poll() is None, "".join(out)
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)

        def post(body):
            t0 = time.perf_counter()
            conn.request("POST", "/queries.json", body=json.dumps(body))
            r = conn.getresponse()
            return r.status, json.loads(r.read()), time.perf_counter() - t0

        answers = [post({"user": f"u{i % 8}", "num": 2}) for i in range(10)]
        assert all(s == 200 for s, _, _ in answers)
        status, _, dt = post({"num": 2})
        assert status == 400 and dt < 0.5
        assert not sink.bodies or dt < 2.0
        (body, _), = sink.wait(1)
        assert body.startswith("P:") and json.loads(body[2:])[
            "engineInstance"]["id"] == "m.npz"
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            events = list(Storage.get_events().find(app_id,
                                                    entity_type="pio_pr"))
            if len(events) == 10:
                break
            time.sleep(0.05)
        assert sorted(e.entity_id for e in events) == \
            sorted(b["prId"] for _, b, _ in answers)
        assert all(e.event == "predict" for e in events)
        t0 = time.monotonic()
        done = _cli(["undeploy", "--port", str(port), "--accesskey", "k"],
                    env)
        assert done.returncode == 0, done.stdout + done.stderr
        assert "Shutting down" in done.stdout
        assert proc.wait(timeout=5) == 0
        assert time.monotonic() - t0 < 5
        # nothing listens now: undeploy reports it and exits 1
        gone = _cli(["undeploy", "--port", str(port)], env)
        assert gone.returncode == 1
        assert "[ERROR] Unable to undeploy" in gone.stdout
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        sink.close()
        Storage.reset()
