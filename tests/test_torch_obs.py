"""The port's obs core (``obs/registry``, ``obs/trace_context``,
``obs/tracing``, ``obs/batch_stats``, ``obs/fleet``) against the JAX
package's, on the CPU.

The same operations on both packages' registries must render the same
Prometheus text and the same JSON, and export and merge the same
snapshots (fleet merges read either package's). A ``PIO_TRACE_CONTEXT``
either package writes is read by the other; ``span``/``carried`` record
into the flight recorder as the reference's do; ``merge_snapshot_files``
over two shard snapshots equals the reference's ``FleetView``.
"""

import json
import math

import pytest

import predictionio_tpu.obs.batch_stats as ref_batch_stats
import predictionio_tpu.obs.fleet as ref_fleet
import predictionio_tpu.obs.registry as ref_registry
import predictionio_tpu.obs.trace_context as ref_tc
import predictionio_tpu.obs.tracing as ref_tracing
import predictionio_tpu_torch.obs.batch_stats as port_batch_stats
import predictionio_tpu_torch.obs.fleet as port_fleet
import predictionio_tpu_torch.obs.registry as port_registry
import predictionio_tpu_torch.obs.trace_context as port_tc
import predictionio_tpu_torch.obs.tracing as port_tracing

PAIRS = {"ref": (ref_registry, ref_tc, ref_tracing, ref_fleet,
                 ref_batch_stats),
         "port": (port_registry, port_tc, port_tracing, port_fleet,
                  port_batch_stats)}


def _drive(registry_mod, stats_mod, exemplar=None):
    """One fixed sequence of counter, gauge and histogram operations,
    label escaping, a callback gauge, a series cap overflow and the
    five batch-predict series."""
    reg = registry_mod.MetricsRegistry()
    registry_mod.set_exemplar_provider(
        (lambda: exemplar) if exemplar else None)
    try:
        c = reg.counter("pio_requests_total", "Requests\nserved",
                        ("route", "status"))
        c.inc(route="/q", status=200)
        c.inc(2.5, route="/q", status=200)
        c.inc(route='/a"b\\c\nd', status=500)
        plain = reg.counter("pio_plain_total", "no labels")
        plain.inc(3)
        g = reg.gauge("pio_depth", "queue depth", ("queue",))
        g.set(4, queue="in")
        g.inc(2, queue="in")
        g.dec(1.5, queue="out")
        reg.gauge("pio_unset", "never set")
        reg.gauge_callback("pio_callback", "lazy", lambda: 7.25)
        reg.gauge_callback("pio_callback_labels", "lazy labels",
                           lambda: [({"k": "a"}, 1.0), ({"k": "b"}, 2.0)],
                           labelnames=("k",))
        h = reg.histogram("pio_latency_seconds", "latency", ("route",))
        for v in (0.0001, 0.0005, 0.003, 0.02, 0.5, 3.0, 100.0):
            h.observe(v, route="/q")
        h.observe(0.004, route="/b")
        custom = reg.histogram("pio_custom", "custom buckets",
                               buckets=registry_mod.exponential_buckets(
                                   0.1, 3.0, 4))
        custom.observe(0.2)
        custom.observe(1e9)
        capped = reg.counter("pio_capped_total", "cap", ("id",),
                             max_series=2)
        for i in range(5):
            capped.inc(id=f"e{i}")
        stats_mod.batch_queries_counter(reg).inc(13)
        stats_mod.batch_invalid_counter(reg).inc()
        stats_mod.batch_rows_per_second(reg).set(1234.5)
        stats_mod.batch_chunk_seconds(reg).observe(0.0123)
        stats_mod.batch_pad_waste(reg).inc(3)
    finally:
        registry_mod.set_exemplar_provider(None)
    return reg


def _normalize(obj):
    """Exemplar timestamps differ between two runs; everything else must
    not."""
    if isinstance(obj, dict):
        return {k: ("ts" if k == "ts" else _normalize(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        if len(obj) == 3 and isinstance(obj[0], str) and isinstance(
                obj[2], float):
            return [obj[0], obj[1], "ts"]
        return [_normalize(v) for v in obj]
    return obj


def _strip_exemplar_ts(text):
    out = []
    for line in text.splitlines():
        if line.startswith("# exemplar "):
            line = line.rsplit(" ", 1)[0]
        out.append(line)
    return "\n".join(out)


@pytest.mark.parametrize("exemplar", [None, "trace-abc"])
def test_prometheus_text_and_json_equal_the_reference(exemplar):
    ref = _drive(ref_registry, ref_batch_stats, exemplar)
    port = _drive(port_registry, port_batch_stats, exemplar)
    assert _strip_exemplar_ts(port.render_prometheus()) \
        == _strip_exemplar_ts(ref.render_prometheus())
    assert _normalize(port.render_json()) == _normalize(ref.render_json())
    assert _strip_exemplar_ts(port_registry.render_prometheus(
        [port, port_registry.MetricsRegistry()])) == _strip_exemplar_ts(
        ref_registry.render_prometheus([ref, ref_registry.MetricsRegistry()]))


def test_snapshots_and_merges_equal_the_reference():
    ref = _drive(ref_registry, ref_batch_stats, "t1")
    port = _drive(port_registry, port_batch_stats, "t1")
    snap_ref, snap_port = ref.to_snapshot(), port.to_snapshot()
    assert _normalize(snap_port) == _normalize(snap_ref)
    # a snapshot either package wrote merges into the other's registry
    merged = {}
    for name, mod, snaps in (("ref", ref_registry, (snap_ref, snap_port)),
                             ("port", port_registry, (snap_port, snap_ref))):
        reg = mod.MetricsRegistry()
        for i, snap in enumerate(json.loads(json.dumps(s)) for s in snaps):
            reg.merge_snapshot(snap, extra_labels={"process": f"p{i}"})
        reg.merge_snapshot(snaps[0], extra_labels={"process": "p0"})
        merged[name] = reg
    assert _strip_exemplar_ts(merged["port"].render_prometheus()) \
        == _strip_exemplar_ts(merged["ref"].render_prometheus())
    assert _normalize(merged["port"].to_snapshot()) \
        == _normalize(merged["ref"].to_snapshot())
    h = merged["port"].get("pio_latency_seconds")
    assert h.count(route="/q", process="p0") == 14
    assert math.isclose(h.quantile(0.5), merged["ref"].get(
        "pio_latency_seconds").quantile(0.5))


def test_histogram_bucket_mismatch_raises_in_both():
    for mod in (ref_registry, port_registry):
        reg = mod.MetricsRegistry()
        reg.histogram("pio_h", "h", buckets=(1.0, 2.0))
        with pytest.raises(ValueError, match="buckets"):
            reg.merge_snapshot({"pio_h": {
                "kind": "histogram", "help": "h", "labelnames": [],
                "buckets": [1.0, 3.0],
                "series": [{"labels": {}, "counts": [1, 0, 0], "sum": 1}]}})


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_trace_context_env_crosses_packages(writer, reader):
    w_tc, r_tc = PAIRS[writer][1], PAIRS[reader][1]
    parent = w_tc.TraceContext.root()
    env = w_tc.child_env(parent, base={"OTHER": "1"})
    assert env["OTHER"] == "1"
    got = r_tc.from_env(env)
    assert got is not None and got.trace_id == parent.trace_id
    assert got.span_id != parent.span_id
    assert got.encode() == env[w_tc.TRACE_ENV]
    assert r_tc.TRACE_ENV == w_tc.TRACE_ENV == "PIO_TRACE_CONTEXT"
    for bad in ("", "nocolon", "a:b:c", "a b:c", ":x"):
        assert r_tc.TraceContext.decode(bad) is None
        assert w_tc.TraceContext.decode(bad) is None


def _record_run(registry_mod, tc_mod, tracing_mod):
    """span/carried/adopt under a parent context; the recorder's records
    with their random ids and times replaced by their shape."""
    tc_mod.recorder().clear()
    reg = registry_mod.MetricsRegistry()
    parent = tc_mod.TraceContext("feedc0de", "0123456789abcdef")
    with tracing_mod.carried(parent, "job", registry=reg,
                             attrs={"rank": 0}) as trace:
        with tracing_mod.span("read"):
            pass
        with tracing_mod.span("read"):
            pass
        ctx = tracing_mod.capture_context()
        with tracing_mod.carried(ctx, "hop", record=False):
            with tracing_mod.span("inner"):
                pass
        with tracing_mod.carried(ctx, "child"):
            tc_mod.record_event("swap", {"kind": "ignored", "v": 2})
    with pytest.raises(KeyError):
        with tracing_mod.adopt("failing", context=parent):
            raise KeyError("x")
    traces = tc_mod.recorder().traces()
    events = tc_mod.recorder().events()
    shape = [{"name": t["name"], "traceId": t["traceId"],
              "parent": t["parentSpanId"] == parent.span_id,
              "spans": sorted(t["spans"]), "status": t["status"],
              "attrs": t.get("attrs")} for t in traces]
    ev = [{k: e[k] for k in ("kind", "v", "traceId")} for e in events]
    hist = reg.get("pio_span_duration_seconds")
    counts = {s: hist.count(span=s) for s in ("read", "inner")}
    tc_mod.recorder().clear()
    return shape, ev, counts, trace.trace_id


def test_span_and_carried_record_as_the_reference():
    ref = _record_run(ref_registry, ref_tc, ref_tracing)
    port = _record_run(port_registry, port_tc, port_tracing)
    assert port == ref
    shape, ev, counts, trace_id = port
    assert trace_id == "feedc0de"
    assert [s["name"] for s in shape] == ["child", "job", "failing"]
    assert shape[1]["spans"] == ["read"] and shape[2]["status"] == "error"
    assert ev == [{"kind": "swap", "v": 2, "traceId": "feedc0de"}]
    # the hop carried no registry: its span reaches no histogram
    assert counts == {"read": 2, "inner": 0}


def _shard_snapshot(registry_mod, tc_mod, fleet_mod, stats_mod, rank):
    reg = registry_mod.MetricsRegistry()
    stats_mod.batch_queries_counter(reg).inc(10 + rank)
    stats_mod.batch_pad_waste(reg).inc(rank)
    stats_mod.batch_chunk_seconds(reg).observe(0.01 * (rank + 1))
    reg.counter("python_local_total", "not exported").inc()
    doc = fleet_mod.snapshot(reg, process=f"{rank}/2", include_traces=False,
                             extra={"worker": [rank, 2], "traceId": "t"})
    doc["traces"] = [{"traceId": "t", "spanId": f"s{rank}",
                      "name": f"batchpredict shard {rank}/2", "ts": 1.0}]
    doc["events"] = [{"kind": "done", "traceId": "t", "ts": 2.0}]
    return doc


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_merge_snapshot_files_equals_the_reference(tmp_path, writer):
    """Two shard snapshots, written by either package, merged by both:
    the same fleet document (metrics JSON, counter totals, traces,
    events, processes) and the same Prometheus text."""
    reg_mod, tc_mod, fleet_mod, _, stats_mod = PAIRS[writer][0], \
        PAIRS[writer][1], PAIRS[writer][3], None, PAIRS[writer][4]
    paths = []
    for rank in (0, 1):
        p = tmp_path / f"obs-{rank}.json"
        fleet_mod.write_snapshot(str(p), _shard_snapshot(
            reg_mod, tc_mod, fleet_mod, stats_mod, rank))
        paths.append(str(p))
    (tmp_path / "torn.json").write_text("{not json")
    paths.append(str(tmp_path / "torn.json"))
    ref_view = ref_fleet.merge_snapshot_files(paths)
    port_view = port_fleet.merge_snapshot_files(paths)
    assert port_view.to_json() == ref_view.to_json()
    assert port_view.render_prometheus() == ref_view.render_prometheus()
    assert port_view.processes == ["0/2", "1/2"]
    assert port_view.counter_total("pio_batchpredict_queries_total") == 21
    assert port_view.counter_totals() == ref_view.counter_totals()
    assert port_view.trace_ids() == ["t"]
    port_tc.recorder().clear()
    port_fleet.import_into_recorder(port_view)
    assert [t["spanId"] for t in port_tc.recorder().traces("t")] == \
        ["s0", "s1"]
    port_tc.recorder().clear()


def test_fleet_snapshot_exports_only_pio_series():
    reg = port_registry.MetricsRegistry()
    reg.counter("pio_x_total").inc()
    reg.counter("other_total").inc()
    port_tc.recorder().clear()
    port_tc.record_event("deploy", {"v": 1})
    doc = port_fleet.snapshot(reg, process="me")
    assert set(doc["metrics"]) == {"pio_x_total"}
    assert doc["process"] == "me" and doc["version"] == 1
    assert [e["kind"] for e in doc["events"]] == ["deploy"]
    assert port_fleet.read_snapshot("/nonexistent/x.json") is None
    port_tc.recorder().clear()


def test_flight_recorder_rings_pins_and_tail_match_the_reference():
    out = {}
    for name in ("ref", "port"):
        tc_mod = PAIRS[name][1]
        rec = tc_mod.FlightRecorder(capacity=3, event_capacity=2)
        for i in range(5):
            rec.record_span(trace_id=f"t{i % 2}", span_id=f"s{i}",
                            parent_span_id=None, name=f"n{i}",
                            duration_s=0.1234567891, spans={"a": 1e-7},
                            process="p")
            if i == 1:
                rec.pin("t1")
        rec.record_event("e1", {"x": 1}, trace_id="t0")
        rec.record_event("e2", trace_id="t1")
        rec.record_event("e3", trace_id="t1")
        new_t, new_e, tc, ec = rec.tail(2, 1)
        rec.import_records([{"traceId": "t9", "spanId": "z"}], [],
                           process="other")
        keep = ("traceId", "spanId", "name", "durationSec", "spans",
                "process", "kind", "x")
        strip = lambda rows: [{k: r[k] for k in keep if k in r}  # noqa
                              for r in rows]
        out[name] = (strip(rec.traces()), strip(rec.traces("t1")),
                     strip(rec.events()), rec.pinned_ids(),
                     strip(new_t), strip(new_e), tc, ec)
    assert out["port"] == out["ref"]


def test_request_trace_and_slow_request_line(caplog):
    tokens, trace = port_tracing.start_trace("rid-1")
    try:
        trace.add("predict", 0.25)
        assert port_tracing.current_request_id() == "rid-1"
        assert port_tracing.current_trace() is trace
    finally:
        port_tracing.reset_trace(tokens)
    assert port_tracing.current_trace() is None
    with caplog.at_level("WARNING", logger="pio.obs"):
        port_tracing.log_slow_request("query", "POST", "/queries.json",
                                      200, 1.5, trace)
    payload = json.loads(caplog.records[-1].getMessage().split(" ", 2)[2])
    assert payload == {"requestId": "rid-1", "traceId": "rid-1",
                       "service": "query", "method": "POST",
                       "path": "/queries.json", "status": 200,
                       "durationSec": 1.5, "spans": {"predict": 0.25}}
