"""The observability plane on the port's servers, on the CPU: the query
server's per-request anatomy, ``/metrics``, ``/slo.json``,
``/capacity.json`` and ``/history``; the deploy counters on the
registry; the canary splitter's restore across a restart; fold-in's SLO
deferral; the event server's ``/stats.json`` (against the reference's)
and its ingest anatomy.
"""

import asyncio
import os

import aiohttp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from predictionio_tpu.server.event_server import (
    create_event_server as ref_create_event_server,
)
from predictionio_tpu.storage import (
    AccessKey as RefAccessKey, App as RefApp, Storage as RefStorage,
)
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.deploy.warm import EngineInstance
from predictionio_tpu_torch.engines.recommendation import (
    default_engine_params, engine,
)
from predictionio_tpu_torch.models.als import ALSModel
from predictionio_tpu_torch.obs import trace_context as port_tc
from predictionio_tpu_torch.obs.anatomy import (
    MIDDLEWARE_STAGE, SERVING_COST_STAGES, SERVING_WALL_STAGES,
    STAGE_HISTOGRAM, TRACE_STAGE_PREFIX,
)
from predictionio_tpu_torch.obs.registry import MetricsRegistry
from predictionio_tpu_torch.obs.slo import SLOSpec
from predictionio_tpu_torch.obs.telemetry import TelemetryRecorder
from predictionio_tpu_torch.ops import scoring
from predictionio_tpu_torch.server.event_server import EventServer
from predictionio_tpu_torch.server.query_server import (
    QueryServer, create_query_server,
)
from predictionio_tpu_torch.storage.base import AccessKey, App
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.server_config import (
    DeployConfig, FoldinConfig, IngestConfig, ScorerConfig,
    TelemetryConfig,
)
from test_torch_canary import (  # noqa: E402
    APP, N_USERS, _arrays, _Http, _port_engine, _register, port_store,
)

pytestmark = pytest.mark.anyio

__all__ = ["port_store"]


@pytest.fixture(autouse=True)
def _clean():
    port_tc.recorder().clear()
    yield
    port_tc.recorder().clear()
    scoring.set_process_scorer_config(None)


def _twostage_server(**kw) -> QueryServer:
    rng = np.random.default_rng(4)
    n_users, n_items, rank = 60, 4000, 16
    model = ALSModel.from_arrays(
        np.array([f"u{i}" for i in range(n_users)]),
        np.array([f"i{i}" for i in range(n_items)]),
        rng.standard_normal((n_users, rank)).astype(np.float32),
        rng.standard_normal((n_items, rank)).astype(np.float32),
        device="cpu")
    eng = engine()
    result = eng.prepare_deploy(default_engine_params(), [model])
    server = create_query_server(
        eng, result, EngineInstance(id="obs", engine_variant="default"),
        scorer_config=ScorerConfig(mode="twostage", tile_items=512,
                                   shortlist=256), **kw)
    server.warm()
    return server


async def _burst(base, n, clients):
    async with aiohttp.ClientSession() as session:
        async def one(i):
            async with session.post(base + "/queries.json", json={
                    "user": f"u{i % 60}", "num": 5}) as r:
                assert r.status == 200, await r.text()
                return r.headers["X-Request-ID"]

        ids = []
        for lo in range(0, n, clients):
            ids += await asyncio.gather(*(one(i) for i in
                                          range(lo, min(n, lo + clients))))
        return ids


async def test_anatomy_splits_each_request_and_metrics_show_it():
    server = _twostage_server(linger_s=0.002)
    port = await server.start("127.0.0.1", 0)
    base = f"http://127.0.0.1:{port}"
    try:
        ids = await _burst(base, 48, 8)
        async with aiohttp.ClientSession() as session:
            async with session.get(base + "/debug/traces.json?limit=200"
                                   ) as r:
                doc = await r.json()
            async with session.get(base + "/metrics") as r:
                text = await r.text()
    finally:
        await server.close()
    by_id = {t["traceId"]: t for t in doc["traces"]
             if t["name"] == "query_server POST /queries.json"}
    assert set(ids) <= set(by_id)
    for rid in ids:
        t = by_id[rid]
        stages = {k[len(TRACE_STAGE_PREFIX):]: v
                  for k, v in t["spans"].items()
                  if k.startswith(TRACE_STAGE_PREFIX)}
        assert set(SERVING_WALL_STAGES) <= set(stages), stages
        wall = sum(stages[s] for s in SERVING_WALL_STAGES)
        # the stages tile the handler's wall: only the middleware's own
        # steps around the handler stay outside them
        # (the smoke's rule: 10%, or 0.5 ms of a short request)
        assert abs(wall - t["durationSec"]) <= max(
            0.1 * t["durationSec"], 0.0005), (rid, stages, t)
    hist = server.registry.get(STAGE_HISTOGRAM)
    for stage in SERVING_WALL_STAGES + SERVING_COST_STAGES:
        assert hist.count(path="serving", stage=stage) == 48, stage
    assert 'pio_anatomy_stage_seconds_bucket{path="serving",stage="device"' \
        in text
    assert "pio_scoring_batches_total" in text
    assert 'pio_http_request_duration_seconds_count{service="query_server",' \
        'method="POST",handler="/queries.json",status="200"} 48' in text


@pytest.mark.parametrize("where,stage", [
    ("after_the_handler", MIDDLEWARE_STAGE),
    ("before_the_queue", "queue_wait"),
])
async def test_stages_tile_the_wall_around_a_stall(monkeypatch, where,
                                                   stage):
    """A 5 ms stall (a GC pass, or the loop thread waiting out the
    interpreter's 5 ms switch interval for the batch thread) either in
    the handler's own metrics after its last stage, or in its query
    extraction before the micro-batcher: the wall stages and the
    middleware's own stage tile the middleware's wall to 0.5 ms, and each
    request's own stall shows in the stage where it happened (the loop
    it blocks delays the other clients' requests wherever they are)."""
    import time

    server = _twostage_server(linger_s=0.002)
    stall_s = 0.005
    if where == "after_the_handler":
        target, name = server._query_hist, "observe"
    else:
        target, name = server, "_extract_query"
    real = getattr(target, name)

    def stalled(*args, **kwargs):
        time.sleep(stall_s)
        return real(*args, **kwargs)

    monkeypatch.setattr(target, name, stalled)
    port = await server.start("127.0.0.1", 0)
    base = f"http://127.0.0.1:{port}"
    try:
        ids = await _burst(base, 16, 4)
        async with aiohttp.ClientSession() as session:
            async with session.get(base + "/debug/traces.json?limit=200"
                                   ) as r:
                doc = await r.json()
    finally:
        await server.close()
    by_id = {t["traceId"]: t for t in doc["traces"]
             if t["name"] == "query_server POST /queries.json"}
    for rid in ids:
        t = by_id[rid]
        st = {s: t["spans"][TRACE_STAGE_PREFIX + s]
              for s in SERVING_WALL_STAGES + (MIDDLEWARE_STAGE,)}
        assert t["durationSec"] >= stall_s, t
        assert abs(t["durationSec"] - sum(st.values())) <= 0.0005, (rid, t)
        assert st[stage] >= stall_s, (rid, st)


async def test_anatomy_off_records_nothing(monkeypatch):
    monkeypatch.setenv("PIO_ANATOMY", "0")
    server = _twostage_server()
    port = await server.start("127.0.0.1", 0)
    try:
        await _burst(f"http://127.0.0.1:{port}", 8, 4)
    finally:
        await server.close()
    hist = server.registry.get(STAGE_HISTOGRAM)
    assert hist is None or hist.total_count() == 0
    traces = port_tc.recorder().traces()
    assert traces and not any(k.startswith(TRACE_STAGE_PREFIX)
                              for t in traces for k in t["spans"])


async def test_slo_capacity_and_history_routes(tmp_path):
    registry = MetricsRegistry()
    cfg = TelemetryConfig(dir=str(tmp_path / "tel"), interval_s=60.0)
    telemetry = TelemetryRecorder("query_server-t", cfg,
                                  registries=[registry])
    spec = SLOSpec.from_dict({
        "objectives": [{"name": "p99", "kind": "latency",
                        "thresholdS": 10.0, "budget": 0.01}],
        "windows": [{"seconds": 60, "burnThreshold": 1.0}],
        "evalIntervalS": 0.1})
    server = _twostage_server(registry=registry, telemetry=telemetry,
                              slo_spec=spec)
    port = await server.start("127.0.0.1", 0)
    http = _Http(port)
    try:
        server._slo.tick()          # the windows' baseline: no queries
        await _burst(http.base, 12, 4)
        status, slo = await http.call("GET", "/slo.json")
        assert status == 200 and slo["enabled"] and not slo["breached"]
        obj = slo["objectives"][0]
        assert obj["windows"][0]["total"] == 12.0
        assert obj["windows"][0]["burn"] == 0.0
        status, cap = await http.call("GET", "/capacity.json")
        unit = cap["units"][0]
        assert unit["role"] == "active" and unit["scorerBytes"] > 0
        scorer = server.result.models[0]._scorer_cache[2]
        assert unit["scorerBytes"] == (scorer._tiles.nbytes
                                       + scorer._scales.nbytes)
        telemetry.scrape_once()
        status, rng = await http.call(
            "GET", "/history/range.json?name=pio_query_duration_seconds")
        pts = rng["series"][0]["points"]
        assert pts[-1][1] == 12
        status, listing = await http.call("GET", "/history/series.json")
        names = {s["name"] for s in listing["series"]}
        assert {"pio_query_duration_seconds",
                "pio_anatomy_stage_seconds"} <= names
        status, body = await http.call("GET", "/history/range.json")
        assert status == 400
    finally:
        await http.close()
        await server.close()
    # close stopped the recorder: a final drain, the store closed
    assert telemetry.db._f is None


async def test_deploy_counters_answer_the_same_keys(port_store):
    inst, rel = _register(0, "incumbent")
    _register(1, "candidate")
    result = engine().prepare_deploy(
        default_engine_params(APP, rank=6),
        [ALSModel.from_arrays(*_arrays(0), device="cpu")])
    server = QueryServer(
        _port_engine(), result, inst,
        scorer_config=ScorerConfig(mode="exact"), max_batch=16,
        linger_s=0.0, release=rel,
        foldin_config=FoldinConfig(enabled=False),
        deploy_config=DeployConfig(warmup=True, drain_timeout_s=10.0))
    http = _Http(await server.start("127.0.0.1", 0))
    try:
        for i in range(5):
            await http.call("POST", "/queries.json",
                            {"user": f"u{i}", "num": 3})
        status, body = await http.call("POST", "/deploy.json",
                                       {"version": 2})
        assert status == 200, body
        status, _ = await http.call("POST", "/rollback.json")
        assert status == 200
        status, st = await http.call("GET", "/deploy/status.json")
        _, root = await http.call("GET", "/")
    finally:
        await http.close()
        await server.close()
    assert set(st["deploy"]) == {"requests", "promotes", "rollbacks",
                                 "swaps", "recentEvents"}
    assert st["deploy"]["requests"] == {"incumbent": 5}
    assert st["deploy"]["swaps"] == {"warm/ok": 1, "rollback/ok": 1}
    assert st["deploy"]["rollbacks"] == {"operator": 1}
    assert st["deploy"]["promotes"] == {}
    assert set(root) >= {
        "status", "engineInstance", "algorithms", "startTime",
        "uptimeSeconds", "requestCount", "queryCount", "avgServingSec",
        "p95ServingSec", "lastServingSec", "scorer", "warmup",
        "kernelLaunches", "warmupKernelLaunches", "microBatches", "foldin",
        "feedback"}
    assert root["queryCount"] == 5
    assert set(root["feedback"]) == {"enabled", "writes", "failures",
                                     "p50WriteSec", "maxWriteSec"}
    reg = server.registry
    assert reg.get("pio_deploy_active_release_version").value() == 1.0
    assert reg.get("pio_deploy_phase_duration_seconds").count(
        phase="load") == 1


CANARY = {"version": 2, "canaryFraction": 0.2, "canaryMinSamples": 10**6,
          "canaryPromoteAfter": 10**6}


def _canary_server(telemetry, registry):
    inst = Storage.get_meta_data_engine_instances().get("incumbent")
    rel = Storage.get_meta_data_releases().get_for_variant(
        inst.engine_id, inst.engine_version, inst.engine_variant)[-1]
    result = engine().prepare_deploy(
        default_engine_params(APP, rank=6),
        [ALSModel.from_arrays(*_arrays(0), device="cpu")])
    return QueryServer(
        _port_engine(), result, inst,
        scorer_config=ScorerConfig(mode="exact"), max_batch=16,
        linger_s=0.0, release=rel,
        foldin_config=FoldinConfig(enabled=False),
        deploy_config=DeployConfig(warmup=True, drain_timeout_s=10.0),
        registry=registry, telemetry=telemetry)


async def test_canary_splitter_restores_after_a_restart(port_store):
    _register(0, "incumbent")
    _register(1, "candidate")
    cfg = TelemetryConfig(dir=str(port_store / "tel"), interval_s=60.0)

    def recorder(reg):
        return TelemetryRecorder("query_server-c", cfg, registries=[reg])

    reg1 = MetricsRegistry()
    server = _canary_server(recorder(reg1), reg1)
    http = _Http(await server.start("127.0.0.1", 0))
    try:
        status, body = await http.call("POST", "/deploy.json", CANARY)
        assert status == 200, body
        for i in range(7):
            await http.call("POST", "/queries.json",
                            {"user": f"u{i % N_USERS}", "num": 3})
        acc = server._canary.controller.splitter.state()
        assert 0.0 < acc < 1.0
    finally:
        await http.close()
        await server.close()      # stops the recorder: a last scrape
    reg2 = MetricsRegistry()
    server = _canary_server(recorder(reg2), reg2)
    http = _Http(await server.start("127.0.0.1", 0))
    try:
        status, body = await http.call("POST", "/deploy.json", CANARY)
        assert status == 200, body
        assert server._canary.controller.splitter.state() == acc
        assert reg2.get("pio_deploy_canary_splitter_acc").value() == acc
    finally:
        await http.close()
        await server.close()


def _breach(server, kind):
    """Drive ``kind``'s objective into breach on the server's registry."""
    reg = server.registry
    if kind == "errors":
        fails = reg.get("pio_query_failures_total")
        for _ in range(20):
            fails.inc(engine_variant="default", reason="predict_error")
    else:
        hist = reg.histogram("pio_foldin_event_to_applied_seconds", "f")
        for _ in range(20):
            hist.observe(30.0)
    server._slo.tick()
    assert server._slo.breached()


@pytest.mark.parametrize("kind,deferred", [("errors", True),
                                           ("freshness", False)])
async def test_foldin_defers_under_a_serving_breach_only(port_store, kind,
                                                         deferred):
    inst, rel = _register(0, "incumbent")
    result = engine().prepare_deploy(
        default_engine_params(APP, rank=6),
        [ALSModel.from_arrays(*_arrays(0), device="cpu")])
    spec = SLOSpec.from_dict({
        "objectives": [{"name": "errors", "kind": "errors",
                        "budget": 0.01},
                       {"name": "fresh", "kind": "freshness",
                        "thresholdS": 1.0, "budget": 0.01}],
        "windows": [{"seconds": 60, "burnThreshold": 1.0}],
        "evalIntervalS": 60.0})
    server = QueryServer(
        _port_engine(), result, inst,
        scorer_config=ScorerConfig(mode="exact"), max_batch=16,
        linger_s=0.0, release=rel, slo_spec=spec,
        foldin_config=FoldinConfig(enabled=True, apply_interval_s=3600.0),
        deploy_config=DeployConfig(warmup=False))
    await server.start("127.0.0.1", 0)
    try:
        ctl = server._foldin
        assert ctl is not None
        server._slo.tick()
        _breach(server, kind)
        ctl.offer([Event(event="rate", entity_type="user", entity_id="u1",
                         target_entity_type="item", target_entity_id="i1",
                         properties={"rating": 4.0}, event_id="e1")])
        assert ctl.pending_rows() == 1
        ctl.apply_pending()
        outcomes = ctl.outcomes
        assert (outcomes.get("deferred", 0) == 1) is deferred, outcomes
        if deferred:
            assert ctl.pending_rows() == 1
            assert server.registry.get("pio_foldin_pending_rows").value() \
                == 1.0
    finally:
        await server.close()


def _es_config(path):
    return {"sources": {"DB": {"TYPE": "sqlite", "PATH": str(path)}},
            "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                             for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}}


def _es_setup(storage, app_cls, key_cls, path):
    storage.configure(_es_config(path))
    app_id = storage.get_meta_data_apps().insert(app_cls(id=0, name="es"))
    storage.get_events().init_channel(app_id)
    storage.get_meta_data_access_keys().insert(
        key_cls(key="k", appid=app_id, events=()))


def _events(seed):
    rng = np.random.default_rng(seed)
    names = ("view", "buy", "rate")
    out = []
    for i in range(30):
        ev = {"event": str(rng.choice(names)), "entityType": "user",
              "entityId": f"u{int(rng.integers(0, 9))}",
              "targetEntityType": "item",
              "targetEntityId": f"i{int(rng.integers(0, 9))}"}
        if i % 7 == 0:
            ev["entityType"] = "item"
        out.append(ev)
    return out


async def test_event_server_stats_metrics_and_ingest_anatomy(tmp_path):
    events = _events(3)
    _es_setup(RefStorage, RefApp, RefAccessKey, tmp_path / "ref.db")
    ref_client = TestClient(TestServer(ref_create_event_server(stats=True)))
    await ref_client.start_server()
    try:
        for lo in range(0, len(events), 10):
            r = await ref_client.post("/batch/events.json?accessKey=k",
                                      json=events[lo:lo + 10])
            assert r.status == 200
        r = await ref_client.post("/events.json?accessKey=k",
                                  json=events[0])
        assert r.status == 201
        want = await (await ref_client.get("/stats.json?accessKey=k")).json()
    finally:
        await ref_client.close()
        RefStorage.reset()

    _es_setup(Storage, App, AccessKey, tmp_path / "port.db")
    server = EventServer(stats=True, ingest=IngestConfig(linger_s=0.001))
    http = _Http(await server.start("127.0.0.1", 0))
    try:
        for lo in range(0, len(events), 10):
            status, body = await http.call(
                "POST", "/batch/events.json?accessKey=k",
                events[lo:lo + 10])
            assert status == 200 and all(b["status"] == 201 for b in body)
        status, _ = await http.call("POST", "/events.json?accessKey=k",
                                    events[0])
        assert status == 201
        status, got = await http.call("GET", "/stats.json?accessKey=k")
        assert status == 200
        async with http.session.get(http.base + "/metrics") as r:
            text = await r.text()
    finally:
        await http.close()
        await server.close()
        Storage.reset()
    assert got["longLive"] == want["longLive"]
    assert got["hourly"] == want["hourly"]
    assert sum(e["count"] for e in got["longLive"]) == len(events) + 1
    assert ('pio_http_request_duration_seconds_count{service='
            '"event_server",method="POST",handler="/batch/events.json",'
            'status="200"} 3') in text
    hist = server.registry.get(STAGE_HISTOGRAM)
    for stage in ("flush_wait", "commit"):
        assert hist.count(path="ingest", stage=stage) == 4, stage


async def test_stats_json_answers_404_without_stats(tmp_path):
    _es_setup(Storage, App, AccessKey, tmp_path / "port.db")
    server = EventServer()
    http = _Http(await server.start("127.0.0.1", 0))
    try:
        status, body = await http.call("GET", "/stats.json?accessKey=k")
    finally:
        await http.close()
        await server.close()
        Storage.reset()
    assert status == 404 and "--stats" in body["message"]


async def test_profile_route_answers_one_capture_at_a_time(tmp_path):
    """``POST /debug/profile``: a capture on the deploy executor while
    queries keep being answered; a second one at the same time 409."""
    server = _twostage_server()
    port = await server.start("127.0.0.1", 0)
    base = f"http://127.0.0.1:{port}"
    try:
        async with aiohttp.ClientSession() as session:
            async def capture():
                async with session.post(base + "/debug/profile", json={
                        "seconds": 0.5, "dir": str(tmp_path / "p")}) as r:
                    return r.status, await r.json()

            first = asyncio.ensure_future(capture())
            await asyncio.sleep(0.1)
            second = await capture()
            ids = await _burst(base, 8, 4)
            status, body = await first
        assert status == 200, body
        assert second[0] == 409
        assert len(ids) == 8
        assert os.path.exists(os.path.join(body["traceDir"], "trace.json"))
        kinds = [e["kind"] for e in port_tc.recorder().events()]
        assert "profile_capture" in kinds
    finally:
        await server.close()
