"""The port's serving observability plane against the JAX package's, on
the CPU: the request middleware and ``/metrics``, the per-request
anatomy, the telemetry store (``obs/tsdb``, ``storage/logstore``), the
SLO burn-rate engine, the capacity ledger, the profiler and the series
modules.

The same inputs (made from a numpy seed) go through both packages. The
middleware answers the reference aiohttp app's series, labels and
request-id contract; a store either package writes is read by the other
with equal answers; the SLO engines agree document for document under a
fake clock; and the port's query server splits each request's wall into
the anatomy's stages.
"""

import json
import os
import subprocess
import sys

import aiohttp
import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer
from hypothesis import given, settings
from hypothesis import strategies as st

import predictionio_tpu.obs.anatomy as ref_anatomy
import predictionio_tpu.obs.capacity as ref_capacity
import predictionio_tpu.obs.eval_stats as ref_eval_stats
import predictionio_tpu.obs.foldin_stats as ref_foldin_stats
import predictionio_tpu.obs.registry as ref_registry
import predictionio_tpu.obs.scoring_stats as ref_scoring_stats
import predictionio_tpu.obs.slo as ref_slo
import predictionio_tpu.obs.trace_context as ref_tc
import predictionio_tpu.obs.train_stats as ref_train_stats
import predictionio_tpu.obs.tsdb as ref_tsdb
import predictionio_tpu.deploy.warm as ref_warm
from predictionio_tpu.obs.middleware import (
    add_metrics_routes, observability_middleware as ref_middleware,
)
from predictionio_tpu.obs.tracing import span as ref_span
import predictionio_tpu_torch.deploy.warm as port_warm
import predictionio_tpu_torch.obs.anatomy as port_anatomy
import predictionio_tpu_torch.obs.capacity as port_capacity
import predictionio_tpu_torch.obs.eval_stats as port_eval_stats
import predictionio_tpu_torch.obs.foldin_stats as port_foldin_stats
import predictionio_tpu_torch.obs.profiler as port_profiler
import predictionio_tpu_torch.obs.registry as port_registry
import predictionio_tpu_torch.obs.scoring_stats as port_scoring_stats
import predictionio_tpu_torch.obs.slo as port_slo
import predictionio_tpu_torch.obs.trace_context as port_tc
import predictionio_tpu_torch.obs.train_stats as port_train_stats
import predictionio_tpu_torch.obs.tsdb as port_tsdb
from predictionio_tpu_torch.obs.middleware import (
    metrics_routes, observability_middleware as port_middleware,
)
from predictionio_tpu_torch.obs.tracing import span as port_span
from predictionio_tpu_torch.server.http import HttpError, HttpServer
from predictionio_tpu_torch.storage.faults import (
    CrashError, set_kill_points,
)

pytestmark = pytest.mark.anyio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_recorders():
    ref_tc.recorder().clear()
    port_tc.recorder().clear()
    set_kill_points([])
    yield
    ref_tc.recorder().clear()
    port_tc.recorder().clear()
    set_kill_points([])


# ---------------------------------------------------------------------------
# the request middleware and /metrics
# ---------------------------------------------------------------------------

#: (method, path, extra headers) sent in this order to both apps
SEQUENCE = [
    ("GET", "/ok", {}),
    ("GET", "/ok", {"X-Request-ID": "rid-given"}),
    ("GET", "/items/a.json", {}),
    ("GET", "/items/b.json", {}),
    ("GET", "/items/c.json", {}),
    ("GET", "/boom", {}),
    ("GET", "/crash", {}),
    ("GET", "/nope", {}),
    ("GET", "/nope/deeper", {}),
]


async def _ref_app_answers():
    registry = ref_registry.MetricsRegistry()

    async def ok(_request):
        with ref_span("stage_one"):
            pass
        return web.json_response({"ok": True})

    async def item(_request):
        return web.json_response({"ok": True})

    async def boom(_request):
        raise web.HTTPConflict()

    async def crash(_request):
        raise ValueError("handler bug")

    app = web.Application(middlewares=[
        ref_middleware(registry, "bare", slow_threshold_s=10.0)])
    app.router.add_get("/ok", ok)
    app.router.add_get("/items/{name}.json", item)
    app.router.add_get("/boom", boom)
    app.router.add_get("/crash", crash)
    add_metrics_routes(app, registry)
    client = TestClient(TestServer(app))
    await client.start_server()
    out = []
    try:
        for method, path, headers in SEQUENCE:
            resp = await client.request(method, path, headers=headers)
            out.append((resp.status, resp.headers.get("X-Request-ID"),
                        resp.headers.get("X-Pio-Trace")))
        text = await (await client.get("/metrics")).text()
    finally:
        await client.close()
    return registry, out, text


async def _port_app_answers():
    registry = port_registry.MetricsRegistry()

    async def ok(_req):
        with port_span("stage_one"):
            pass
        return 200, {"ok": True}

    async def item(_req):
        return 200, {"ok": True}

    async def boom(_req):
        raise HttpError(409, "Conflict")

    async def crash(_req):
        raise ValueError("handler bug")

    server = HttpServer([
        ("GET", "/ok", ok),
        ("GET", "/items/{name}.json", item),
        ("GET", "/boom", boom),
        ("GET", "/crash", crash),
        *metrics_routes(registry),
    ], middleware=port_middleware(registry, "bare", slow_threshold_s=10.0))
    port = await server.start("127.0.0.1", 0)
    out = []
    try:
        async with aiohttp.ClientSession() as session:
            for method, path, headers in SEQUENCE:
                async with session.request(
                        method, f"http://127.0.0.1:{port}{path}",
                        headers=headers) as resp:
                    await resp.read()
                    out.append((resp.status,
                                resp.headers.get("X-Request-ID"),
                                resp.headers.get("X-Pio-Trace")))
            async with session.get(f"http://127.0.0.1:{port}/metrics") as r:
                assert r.headers["Content-Type"] == \
                    port_registry.PROMETHEUS_CONTENT_TYPE
                text = await r.text()
    finally:
        await server.close()
    return registry, out, text


def _http_series(registry):
    """(labels, count) of the duration histogram and the in-flight
    gauge's samples, the /metrics requests left out."""
    hist = registry.get("pio_http_request_duration_seconds")
    series = sorted(
        (tuple(sorted(labels.items())), d["count"])
        for labels, d in hist.samples()
        if labels["handler"] != "/metrics")
    return series, registry.get("pio_http_requests_in_flight").samples()


async def test_middleware_series_and_request_ids_equal_the_reference():
    ref_reg, ref_out, ref_text = await _ref_app_answers()
    port_reg, port_out, port_text = await _port_app_answers()
    assert _http_series(port_reg) == _http_series(ref_reg)
    # one series per route template; unmatched paths share one
    handlers = {dict(k)["handler"] for k, _ in _http_series(port_reg)[0]}
    assert handlers == {"/ok", "/items/{name}.json", "/boom", "/crash",
                        "__unmatched__"}
    assert [s for s, _, _ in port_out] == [s for s, _, _ in ref_out] == [
        200, 200, 200, 200, 200, 409, 500, 404, 404]
    # every answer carries a request id (the 500 too); a given one echoes
    for (s, rid, _), (_, ref_rid, _) in zip(port_out, ref_out):
        assert rid and ref_rid, s
    assert port_out[1][1] == ref_out[1][1] == "rid-given"
    # a trace context rides every port answer, as on the reference's 2xx
    assert port_out[0][2] and ref_out[0][2]
    # the same series names, kinds and label names in the exposition
    def families(text):
        return sorted(line for line in text.splitlines()
                      if line.startswith("# TYPE"))
    assert families(port_text) == families(ref_text)
    # the span histogram recorded the handler's stage in both
    for reg in (ref_reg, port_reg):
        assert reg.get("pio_span_duration_seconds").count(
            span="stage_one") == 2


async def test_traced_requests_land_in_the_flight_recorder():
    _, out, _ = await _port_app_answers()
    traces = port_tc.recorder().traces()
    names = [t["name"] for t in traces]
    assert "bare GET /items/{name}.json" in names
    assert "bare GET __unmatched__" in names
    crash = [t for t in traces if t["name"] == "bare GET /crash"]
    assert crash and crash[0]["status"] == "error"
    ok = [t for t in traces if t["name"] == "bare GET /ok"]
    assert any("stage_one" in t["spans"] for t in ok)
    # the answer's trace header names a recorded trace
    assert out[0][2].split(":")[0] in {t["traceId"] for t in traces}


async def test_tracing_off_keeps_metrics_and_records_nothing(monkeypatch):
    monkeypatch.setenv("PIO_TRACING", "0")
    reg, out, _ = await _port_app_answers()
    assert port_tc.recorder().traces() == []
    assert all(rid for _, rid, _ in out)
    assert all(trace is None for _, _, trace in out)
    assert reg.get("pio_http_request_duration_seconds").total_count() \
        >= len(SEQUENCE)


async def test_wrong_method_answers_405_under_the_unmatched_label():
    reg = port_registry.MetricsRegistry()

    async def ok(_req):
        return 200, {}

    server = HttpServer([("GET", "/ok", ok)],
                        middleware=port_middleware(reg, "svc"))
    port = await server.start("127.0.0.1", 0)
    try:
        async with aiohttp.ClientSession() as session:
            async with session.post(f"http://127.0.0.1:{port}/ok") as r:
                assert r.status == 405
                assert r.headers.get("X-Request-ID")
    finally:
        await server.close()
    hist = reg.get("pio_http_request_duration_seconds")
    assert hist.count(service="svc", method="POST",
                      handler="__unmatched__", status="405") == 1


# ---------------------------------------------------------------------------
# anatomy: the report math and the exemplar hook
# ---------------------------------------------------------------------------

def _stage_store(tsdb_mod, registry_mod, anatomy_mod, path, seed):
    """A store holding two windows of anatomy histograms drawn from
    ``seed``: the second window's queue_wait is planted 10x slower."""
    rng = np.random.default_rng(seed)
    reg = registry_mod.MetricsRegistry()
    metrics = anatomy_mod.anatomy_metrics(reg)
    db = tsdb_mod.TSDB(path)
    for t, slow in ((1000, 1.0), (2000, 10.0)):
        for stage in anatomy_mod.SERVING_WALL_STAGES:
            scale = 0.002 * (slow if stage == "queue_wait" else 1.0)
            for v in rng.exponential(scale, size=40):
                metrics.stage.observe(float(v), path="serving", stage=stage)
        db.append_snapshot(reg.to_snapshot(), ts_ms=t)
    db.flush()
    db.close()


def test_stage_stats_composition_and_regression_diff_equal(tmp_path):
    d = str(tmp_path / "db")
    _stage_store(port_tsdb, port_registry, port_anatomy, d, seed=3)
    out = {}
    for name, tsdb_mod, anat in (("ref", ref_tsdb, ref_anatomy),
                                 ("port", port_tsdb, port_anatomy)):
        reader = tsdb_mod.TSDBReader([d])
        before = anat.stage_stats(reader, "serving", until_ms=1000)
        after = anat.stage_stats(reader, "serving", since_ms=1001)
        whole = anat.stage_stats(reader, "serving")
        out[name] = (before, after, whole,
                     anat.composition(whole, "serving"),
                     anat.composition(whole, "serving", which="mean"),
                     anat.regression_diff(before, after))
    assert out["port"] == out["ref"]
    assert out["port"][5]["stage"] == "queue_wait"


def test_exemplars_carry_the_live_trace_id(monkeypatch):
    from predictionio_tpu_torch.obs.tracing import reset_trace, start_trace

    reg = port_registry.MetricsRegistry()
    hist = reg.histogram("pio_x_seconds", "x")
    tokens, trace = start_trace("req-1", reg)
    try:
        hist.observe(0.004)
    finally:
        reset_trace(tokens)
    hist.observe(0.004)                 # outside a trace: no exemplar
    slots = [e for e in hist.exemplars() if e is not None]
    assert [e[0] for e in slots] == [trace.trace_id]
    monkeypatch.setenv("PIO_ANATOMY", "0")
    tokens, _ = start_trace("req-2", reg)
    try:
        reg.histogram("pio_y_seconds", "y").observe(0.004)
    finally:
        reset_trace(tokens)
    assert all(e is None for e in reg.get("pio_y_seconds").exemplars())


# ---------------------------------------------------------------------------
# the telemetry store: one format, read by both packages
# ---------------------------------------------------------------------------

def _drive_store(tsdb_mod, registry_mod, path, seed):
    """Three process lifetimes of a counter, a gauge and a histogram
    drawn from ``seed`` (the registry re-zeroes at each restart), plus
    events and traces, with a roll and a compaction on the way."""
    rng = np.random.default_rng(seed)
    ts = 1_000
    for life in range(3):
        reg = registry_mod.MetricsRegistry()
        c = reg.counter("pio_t_total", "t", ("op",))
        g = reg.gauge("pio_t_depth", "depth")
        h = reg.histogram("pio_t_seconds", "lat", ("op",),
                          buckets=(0.001, 0.01, 0.1, 1.0))
        db = tsdb_mod.TSDB(path, compact_min_segments=2)
        for tick in range(5):
            for _ in range(int(rng.integers(1, 6))):
                c.inc(float(rng.integers(1, 4)), op="a")
                h.observe(float(rng.exponential(0.02)), op="a")
            c.inc(op="b")
            g.set(float(rng.normal()))
            db.append_snapshot(reg.to_snapshot(), ts_ms=ts)
            db.append_event({"kind": "tick", "life": life, "n": tick},
                            ts_ms=ts)
            db.append_trace({"traceId": f"t{life}{tick}", "name": "q"},
                            ts_ms=ts)
            ts += 1_000
            if tick == 2:
                db.roll()
        db.roll()
        db.compact(now_ms=ts)
        db.close()
    return ts


def _read_all(tsdb_mod, path, end_ms):
    r = tsdb_mod.TSDBReader([path])
    series = sorted(
        (i.name, sorted(i.labels.items()), i.kind, tuple(i.buckets),
         [tuple(tuple(x) if isinstance(x, list) else x for x in p)
          for p in i.points])
        for i in r.series())
    return {
        "series": series,
        "rate": sorted(json.dumps(x, sort_keys=True)
                       for x in r.rate("pio_t_total")),
        "rate_window": sorted(json.dumps(x, sort_keys=True) for x in
                              r.rate("pio_t_total", since_ms=6_000)),
        "q99": r.quantile_over_time("pio_t_seconds", 0.99),
        "q50_window": r.quantile_over_time("pio_t_seconds", 0.5,
                                           labels={"op": "a"},
                                           since_ms=4_000),
        "window": r.histogram_window("pio_t_seconds", labels={"op": "a"},
                                     since_ms=3_000, until_ms=end_ms),
        "cumulative": r.cumulative_points("pio_t_total",
                                          labels={"op": "a"}),
        "events": r.events(),
        "traces": r.traces(since_ms=5_000),
    }


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_a_store_either_package_writes_reads_alike(tmp_path, writer):
    mods = {"port": (port_tsdb, port_registry),
            "ref": (ref_tsdb, ref_registry)}
    d = str(tmp_path / "db")
    end = _drive_store(*mods[writer], d, seed=11)
    got = _read_all(port_tsdb, d, end)
    want = _read_all(ref_tsdb, d, end)
    assert got == want
    assert got["q99"] is not None and got["window"] is not None
    assert len(got["events"]) == 15


@settings(max_examples=60, deadline=None)
@given(st.lists(st.floats(0, 1e6, allow_nan=False), max_size=30))
def test_adjust_resets_equal(values):
    assert port_tsdb.adjust_resets(values) == ref_tsdb.adjust_resets(values)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.floats(0, 1e3, allow_nan=False), min_size=1,
                max_size=8),
       st.floats(0, 1))
def test_bucket_quantile_equal(counts, q):
    buckets = tuple(0.001 * 2.0 ** i for i in range(len(counts) - 1))
    assert port_tsdb.bucket_quantile(buckets, counts, q) == \
        ref_tsdb.bucket_quantile(buckets, counts, q)


@settings(max_examples=80, deadline=None)
@given(st.lists(st.lists(st.floats(0, 100, allow_nan=False), min_size=3,
                         max_size=3), max_size=10),
       st.one_of(st.none(), st.integers(0, 12)), st.booleans())
def test_window_delta_equal(rows, since_s, from_zero):
    """Per-tick increments of three series (one row a tick), cumulated."""
    ts = [1000 * (i + 1) for i in range(len(rows))]
    adj = [[float(v) for v in np.cumsum([r[j] for r in rows])]
           for j in range(3)]
    since = None if since_s is None else since_s * 1000
    assert port_tsdb._window_delta(ts, adj, since, from_zero) == \
        ref_tsdb._window_delta(ts, adj, since, from_zero)


KILL_POINTS = ["tsdb:append:mid", "tsdb:roll:pre-commit",
               "tsdb:roll:committed", "tsdb:compact:mid",
               "tsdb:compact:pre-commit", "tsdb:compact:committed"]


@pytest.mark.parametrize("point", KILL_POINTS)
def test_a_kill_at_each_point_leaves_a_store_both_read(tmp_path, point):
    d = str(tmp_path / "db")
    db = port_tsdb.TSDB(d, compact_min_segments=2)
    for t in range(4):
        reg = port_registry.MetricsRegistry()
        reg.counter("pio_t_total", "t").inc(5.0 * (t + 1))
        db.append_snapshot(reg.to_snapshot(), ts_ms=1000 * (t + 1))
        db.append_event({"kind": "e", "n": t}, ts_ms=1000 * (t + 1))
        if t < 3:
            db.roll()
    db.flush()
    set_kill_points([point])
    reg = port_registry.MetricsRegistry()
    reg.counter("pio_t_total", "t").inc(99.0)
    with pytest.raises(CrashError):
        if point.startswith("tsdb:append"):
            db.append_snapshot(reg.to_snapshot(), ts_ms=9000)
        elif point.startswith("tsdb:roll"):
            db.roll()
        else:
            db.compact(now_ms=10_000)
    set_kill_points([])
    want = [(1000 * (t + 1), 5.0 * (t + 1)) for t in range(4)]
    for mod in (port_tsdb, ref_tsdb):
        r = mod.TSDBReader([d])
        assert r.cumulative_points("pio_t_total") == want, mod.__name__
        assert len(r.events()) == 4
    # recovery converges and both still read the same
    port_tsdb.TSDB(d, compact_min_segments=2).close()
    for mod in (port_tsdb, ref_tsdb):
        assert mod.TSDBReader([d]).cumulative_points("pio_t_total") == want


def test_single_writer_claim(tmp_path):
    d = str(tmp_path / "db")
    port_tsdb.TSDB(d).close()
    port_tsdb.TSDB(d).close()        # the owner re-opens (a restart)
    with open(os.path.join(d, "WRITER"), "w") as f:
        f.write(f"{os.getppid()}\n")  # a live foreign writer
    with pytest.raises(port_tsdb.TSDBLocked):
        port_tsdb.TSDB(d)
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    child.wait()                     # a dead owner's claim is stale
    with open(os.path.join(d, "WRITER"), "w") as f:
        f.write(f"{child.pid}\n")
    db = port_tsdb.TSDB(d)
    reg = port_registry.MetricsRegistry()
    reg.counter("pio_t_total", "t").inc(2.0)
    db.append_snapshot(reg.to_snapshot(), ts_ms=2000)
    db.close()
    with open(os.path.join(d, "WRITER")) as f:
        assert int(f.read()) == os.getpid()
    assert ref_tsdb.TSDBReader([d]).cumulative_points("pio_t_total") == [
        (2000, 2.0)]


# ---------------------------------------------------------------------------
# the SLO engine
# ---------------------------------------------------------------------------

SLO_SPEC = {
    "objectives": [
        {"name": "p99", "kind": "latency", "thresholdS": 0.008,
         "budget": 0.05},
        {"name": "errors", "kind": "errors", "budget": 0.02},
        {"name": "fresh", "kind": "freshness", "thresholdS": 2.0,
         "budget": 0.1},
    ],
    "windows": [{"seconds": 30, "burnThreshold": 2.0},
                {"seconds": 120, "burnThreshold": 1.0}],
    "evalIntervalS": 1.0,
}


def _slo_run(slo_mod, registry_mod, seed):
    """Observations drawn from ``seed`` over 200 fake seconds: healthy,
    then a latency and error burst, then healthy again; one tick per
    fake second. Returns the documents and the registry."""
    rng = np.random.default_rng(seed)
    reg = registry_mod.MetricsRegistry()
    lat = reg.histogram("pio_query_duration_seconds", "q",
                        ("engine_variant",))
    fails = reg.counter("pio_query_failures_total", "f",
                        ("engine_variant", "reason"))
    fresh = reg.histogram("pio_foldin_event_to_applied_seconds", "f")
    engine = slo_mod.SLOEngine(reg, slo_mod.SLOSpec.from_dict(SLO_SPEC))
    docs = []
    for t in range(200):
        burst = 80 <= t < 120
        for v in rng.exponential(0.02 if burst else 0.002, size=5):
            lat.observe(float(v), engine_variant="v")
        if burst or rng.random() < 0.01:
            fails.inc(engine_variant="v", reason="predict_error")
        fresh.observe(float(rng.exponential(0.5)))
        docs.append(engine.tick(now=1000.0 + t))
    return docs, reg, engine


def test_slo_engines_agree_tick_for_tick():
    ref_docs, ref_reg, ref_engine = _slo_run(ref_slo, ref_registry, 5)
    port_docs, port_reg, port_engine = _slo_run(port_slo, port_registry, 5)
    assert port_docs == ref_docs
    assert any(d["breached"] for d in port_docs)
    assert not port_docs[-1]["objectives"][0]["breached"] or \
        port_docs[-1] == ref_docs[-1]
    for name in ("pio_slo_breach_total", "pio_slo_breached",
                 "pio_slo_burn_rate"):
        assert sorted(port_reg.get(name).samples(), key=str) == \
            sorted(ref_reg.get(name).samples(), key=str), name
    assert port_engine.breached(("freshness",)) == \
        ref_engine.breached(("freshness",))
    kinds = [e["kind"] for e in port_tc.recorder().events()]
    assert kinds == [e["kind"] for e in ref_tc.recorder().events()]
    assert "slo_breach" in kinds


def test_slo_rehydrates_alike_from_one_history(tmp_path):
    """History written by the port's store; both engines rehydrate from
    it (each package's reader) into the same state."""
    d = str(tmp_path / "db")
    rng = np.random.default_rng(9)
    reg = port_registry.MetricsRegistry()
    lat = reg.histogram("pio_query_duration_seconds", "q",
                        ("engine_variant",))
    fails = reg.counter("pio_query_failures_total", "f",
                        ("engine_variant", "reason"))
    db = port_tsdb.TSDB(d)
    wall0 = 1_700_000_000.0
    for t in range(60):
        for v in rng.exponential(0.02, size=4):
            lat.observe(float(v), engine_variant="v")
        fails.inc(engine_variant="v", reason="predict_error")
        db.append_snapshot(reg.to_snapshot(),
                           ts_ms=int((wall0 + t) * 1000))
    db.close()
    out = {}
    for name, slo_mod, registry_mod, tsdb_mod in (
            ("ref", ref_slo, ref_registry, ref_tsdb),
            ("port", port_slo, port_registry, port_tsdb)):
        engine = slo_mod.SLOEngine(registry_mod.MetricsRegistry(),
                                   slo_mod.SLOSpec.from_dict(SLO_SPEC))
        n = engine.rehydrate(tsdb_mod.TSDBReader([d]), now=500.0,
                             wall_now=wall0 + 61)
        out[name] = (n, engine.status(), engine.breached(),
                     dict(engine._base), engine.tick(now=501.0))
    assert out["port"] == out["ref"]
    assert out["port"][0] > 0 and out["port"][2]


# ---------------------------------------------------------------------------
# capacity, the profiler, the series modules
# ---------------------------------------------------------------------------

def _twostage_model():
    from predictionio_tpu_torch.models.als import ALSModel
    from predictionio_tpu_torch.ops import scoring
    from predictionio_tpu_torch.utils.server_config import ScorerConfig

    rng = np.random.default_rng(2)
    U = rng.standard_normal((40, 16)).astype(np.float32)
    V = rng.standard_normal((3000, 16)).astype(np.float32)
    model = ALSModel.from_arrays(
        np.array([f"u{i}" for i in range(40)]),
        np.array([f"i{i}" for i in range(3000)]), U, V, device="cpu")
    scoring.set_process_scorer_config(ScorerConfig(
        mode="twostage", tile_items=512, shortlist=256))
    return model


def test_capacity_counts_the_scorer_tensors_and_keys_match():
    from predictionio_tpu_torch.ops import scoring

    model = _twostage_model()
    try:
        model.recommend_batch([("u1", 5, (), None)])
        scorer = model._scorer_cache[2]
        assert scorer.active_mode == "twostage"
        entry = port_capacity.model_capacity(model)
        want = int(scorer._tiles.nbytes + scorer._scales.nbytes)
        assert want > 0
        assert entry["scorerFactorBytes"] == want
        assert entry["scorerFactorBytes"] == scorer.status()["factorBytes"]
        assert entry["hostBytes"] == (scorer._v_host.nbytes
                                      + scorer._rotation.nbytes)
        ref_entry = ref_capacity.model_capacity(object())
        assert set(ref_entry) <= set(entry)
        unit = type("U", (), {"result": type("R", (), {
            "models": [model]})(), "instance": None,
            "release_version": 1})()
        doc = port_capacity.capacity_document(
            lambda: [port_capacity.unit_capacity(unit, "active")])
        ref_doc = ref_capacity.capacity_document(
            lambda: [ref_capacity.unit_capacity(unit, "active")])
        assert set(doc) == set(ref_doc)
        assert set(doc["process"]) == set(ref_doc["process"])
        assert set(doc["units"][0]) == set(ref_doc["units"][0])
        assert doc["units"][0]["scorerBytes"] == want
        # no CUDA in this process: the allocator reads zero
        assert doc["process"]["deviceBytes"] == 0.0
    finally:
        scoring.set_process_scorer_config(None)


def test_profile_capture_busy_and_clamp(tmp_path, monkeypatch):
    out = port_profiler.capture(0.05, str(tmp_path / "p"))
    path = os.path.join(out["traceDir"], port_profiler.TRACE_FILE)
    with open(path) as f:
        assert "traceEvents" in json.load(f)
    assert set(out) == {"traceDir", "seconds", "dispatch"}
    assert port_profiler._capture_lock.acquire(blocking=False)
    try:
        with pytest.raises(port_profiler.ProfileBusy):
            port_profiler.capture(0.01)
    finally:
        port_profiler._capture_lock.release()
    slept = []
    monkeypatch.setattr(port_profiler.time, "sleep", slept.append)
    port_profiler.capture(1e6, str(tmp_path / "q"))
    assert slept == [port_profiler.MAX_CAPTURE_S] == [60.0]


def _series_ops(mods, reg):
    """The same operations on each series module of one package."""
    train, evals, foldin, scoring, warm = mods
    train.als_block_sweeps(reg).inc(6)
    train.als_gramian_cache_hits(reg).inc(4)
    train.als_half_sweep_seconds(reg).observe(0.03, solver="subspace")
    evals.eval_candidates_counter(reg).inc(9, mode="batched")
    evals.eval_batch_size(reg).observe(27)
    evals.eval_compile_groups(reg).set(2)
    foldin.foldin_pending(reg).set(12)
    foldin.foldin_batch_rows(reg).observe(12)
    foldin.foldin_solve_seconds(reg).observe(0.004)
    foldin.foldin_apply_seconds(reg).observe(0.02)
    foldin.foldin_applied_rows(reg).inc(12, side="user")
    for outcome in ("applied", "deferred", "empty"):
        foldin.foldin_applies(reg).inc(outcome=outcome)
    foldin.foldin_event_to_applied(reg).observe(0.7)
    foldin.entity_cache_hits(reg).inc(lookup="seen")
    foldin.entity_cache_misses(reg).inc(lookup="seen")
    m = scoring.scoring_metrics(reg)
    m.batches.inc(mode="twostage")
    m.tiles.inc(8)
    m.shortlist.observe(1024)
    m.rescore_fraction.observe(0.0001)
    m.quant_error.set(0.01, mode="twostage")
    m.parity_recall.set(1.0, mode="twostage")
    m.parity_fallback.inc(mode="fused_int8")
    d = warm.deploy_metrics(reg)
    d.phase_hist.observe(0.5, phase="load")
    d.swap_total.inc(mode="warm", outcome="ok")
    d.rollback_total.inc(reason="operator")
    d.promote_total.inc(reason="healthy")
    d.requests_total.inc(role="canary")
    d.canary_fraction.set(0.2)
    d.canary_splitter_acc.set(0.4)
    d.active_version.set(3)
    d.warmup_shapes.inc(7)
    reg.histogram("pio_feedback_write_duration_seconds",
                  "Feedback-loop event store write wall time").observe(0.01)
    return reg


def test_series_modules_render_as_the_reference():
    ref = _series_ops((ref_train_stats, ref_eval_stats, ref_foldin_stats,
                       ref_scoring_stats, ref_warm),
                      ref_registry.MetricsRegistry())
    port = _series_ops((port_train_stats, port_eval_stats,
                        port_foldin_stats, port_scoring_stats, port_warm),
                       port_registry.MetricsRegistry())
    assert port.render_prometheus() == ref.render_prometheus()
    assert port.to_snapshot() == ref.to_snapshot()


def test_anatomy_metric_family_matches():
    ref = ref_registry.MetricsRegistry()
    port = port_registry.MetricsRegistry()
    for mod, reg in ((ref_anatomy, ref), (port_anatomy, port)):
        m = mod.anatomy_metrics(reg)
        for stage in mod.SERVING_WALL_STAGES + mod.SERVING_COST_STAGES:
            m.stage.observe(0.001, path="serving", stage=stage)
        bd = mod.BatchBreakdown()
        bd.add_stage("batch_device", 0.01)
        bd.dispatch_s = 0.002
        bd.note_padding(3, 1, 4)
        mod.observe_serving_batch(m, bd, [(0.0, None)] * 3, 0.001, 0.005)
        mod.observe_ingest_batch(m, [(0.0, None), (0.001, None)], 0.01,
                                 0.003)
    assert port.render_prometheus() == ref.render_prometheus()
    assert port_anatomy.SERVING_WALL_STAGES == ref_anatomy.SERVING_WALL_STAGES
    assert port_anatomy.INGEST_STAGES == ref_anatomy.INGEST_STAGES


@pytest.mark.parametrize("fail", [False, True])
def test_workflow_run_metrics_match_the_reference(fail):
    import predictionio_tpu.utils.profiling as ref_profiling
    import predictionio_tpu.workflow.instrument as ref_instrument
    import predictionio_tpu_torch.utils.profiling as port_profiling
    import predictionio_tpu_torch.workflow.instrument as port_instrument

    status = "failed" if fail else "completed"
    out = {}
    for name, instrument, profiling, registry_mod in (
            ("ref", ref_instrument, ref_profiling, ref_registry),
            ("port", port_instrument, port_profiling, port_registry)):
        reg = registry_mod.default_registry()
        runs = reg.counter("pio_train_runs_total", "train workflow runs "
                           "by outcome", labelnames=("status",))
        before = runs.value(status=status)
        phases = reg.histogram(
            "pio_phase_duration_seconds", "", ("workflow", "phase"),
            buckets=instrument.WORKFLOW_DURATION_BUCKETS)
        p_before = phases.count(workflow="train", phase="incidence_build")
        try:
            with instrument.workflow_run_metrics("train", "pio_train"):
                with profiling.phase("incidence_build"):
                    pass
                if fail:
                    raise RuntimeError("planted")
        except RuntimeError:
            pass
        out[name] = (runs.value(status=status) - before,
                     phases.count(workflow="train",
                                  phase="incidence_build") - p_before,
                     reg.get("pio_train_duration_seconds").help,
                     reg.get("pio_train_duration_seconds").buckets)
    assert out["port"] == out["ref"] == (1.0, 1.0, out["ref"][2],
                                         out["ref"][3])
