"""Fleet console, port 9000 (port of the reference's
``server/dashboard.py``; grown from Dashboard.scala:45-162's index of
completed EvaluationInstances, which it still serves route for route):

  GET /                      -> the console: releases and their lineage,
                                SLO burn with history sparklines,
                                serving, the capacity ledger, the
                                orchestrator's cycles, the top dispatch
                                families, recent traces and lifecycle
                                events, completed evaluations
  GET /history/series.json   -> the persisted series (fleet-wide)
  GET /history/range.json    -> raw samples / rate() / quantile over time
  GET /engine_instances/<id> -> an evaluation's detail page
  GET /evaluations.json, /evaluations/<id>.json -> the same as JSON

Everything longitudinal renders from the merged per-process telemetry
stores (``obs/fleet.history_reader`` over the telemetry root), with no
script tags and no external assets: sparklines are unicode blocks, so
the console works over curl and with no network. Key auth (the
``accessKey`` query parameter against server.json's ``key``) and TLS
come from the server config; the metrics, history and capacity
endpoints stay unauthenticated, as on every other server. The HTTP
layer is the port's stdlib one (``server/http``).
"""

from __future__ import annotations

import asyncio
import html
import json
import logging
import os
import time
from typing import List, Optional

from predictionio_tpu_torch.obs.capacity import (
    CAPACITY_PATH, capacity_routes, register_capacity_metrics,
)
from predictionio_tpu_torch.obs.middleware import (
    METRICS_PATHS, metrics_routes, observability_middleware,
)
from predictionio_tpu_torch.obs.registry import (
    MetricsRegistry, default_registry,
)
from predictionio_tpu_torch.obs.telemetry import (
    HISTORY_PATHS, build_recorder, history_reader_factory, history_routes,
)
from predictionio_tpu_torch.obs.trace_context import recorder
from predictionio_tpu_torch.server.http import (
    HttpServer, RawBody, Request, serve_until_stopped,
)
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.server_config import (
    ServerConfig, pio_home,
)

logger = logging.getLogger("pio.torch.dashboard")

DEFAULT_PORT = 9000

#: unicode sparkline ramp (8 levels)
_SPARK = "▁▂▃▄▅▆▇█"

#: served without the key: scrapers hold no access keys
_OPEN_PATHS = frozenset(METRICS_PATHS) | frozenset(HISTORY_PATHS) | {
    CAPACITY_PATH}

_HTML = "text/html; charset=utf-8"


def sparkline(values: List[float], width: int = 32) -> str:
    """Server-rendered history: the last ``width`` values as unicode
    blocks, scaled to their own max (flat-zero renders as floor)."""
    values = [float(v) for v in values][-width:]
    if not values:
        return ""
    top = max(values)
    if top <= 0:
        return _SPARK[0] * len(values)
    return "".join(
        _SPARK[min(len(_SPARK) - 1, int(v / top * (len(_SPARK) - 1)))]
        for v in values)


def _series_sparkline(info, rate: bool = False) -> str:
    """A SeriesInfo's values as a sparkline; cumulative kinds (and all
    histograms, via their total count) plot per-interval increases."""
    if info.kind == "histogram":
        values = [sum(p[1]) for p in info.points]
        rate = True
    else:
        values = [p[1] for p in info.points]
    if rate and len(values) >= 2:
        values = [max(0.0, b - a) for a, b in zip(values, values[1:])]
    return sparkline(values)


def _esc(value) -> str:
    return html.escape(str(value))


# ---------------------------------------------------------------------------
# console sections (each degrades to an honest "no data" row)
# ---------------------------------------------------------------------------

def _section(title: str, body: str) -> str:
    return f"<h2>{_esc(title)}</h2>\n{body}\n"


def _table(headers: List[str], rows: List[List[str]],
           empty: str = "no data") -> str:
    if not rows:
        return f"<p><em>{_esc(empty)}</em></p>"
    head = "".join(f"<th>{h}</th>" for h in headers)
    body = "".join("<tr>" + "".join(f"<td>{c}</td>" for c in row) + "</tr>"
                   for row in rows)
    return f"<table border=1 cellpadding=4><tr>{head}</tr>{body}</table>"


def _releases_rows() -> List[List[str]]:
    try:
        releases = Storage.get_meta_data_releases().get_all()
    except Exception:
        return []
    rows = []
    for r in sorted(releases, key=lambda r: (r.engine_id,
                                             r.engine_variant, -r.version)):
        lineage = " → ".join(h.get("status", "?") for h in r.history) \
            or r.status
        rows.append([
            _esc(f"{r.engine_id.rsplit('.', 1)[-1]}/{r.engine_variant}"),
            f"v{r.version}",
            f"<b>{_esc(r.status)}</b>",
            _esc(r.instance_id),
            _esc(r.created_time.strftime("%Y-%m-%d %H:%M:%S")),
            _esc(lineage)])
    return rows


def _slo_rows(reader, since_ms: int) -> List[List[str]]:
    rows = []
    breached = {}
    for info in reader.series("pio_slo_breached", since_ms=since_ms):
        key = (info.labels.get("process", ""),
               info.labels.get("objective", ""))
        breached[key] = info.points[-1][1] if info.points else 0.0
    for info in reader.series("pio_slo_burn_rate", since_ms=since_ms):
        if not info.points:
            continue
        process = info.labels.get("process", "")
        objective = info.labels.get("objective", "")
        state = "BREACHED" if breached.get((process, objective)) else "ok"
        rows.append([
            _esc(process), _esc(objective),
            _esc(info.labels.get("window", "")),
            f"{info.points[-1][1]:.2f}",
            f"<b>{state}</b>" if state == "BREACHED" else state,
            f"<code>{_series_sparkline(info)}</code>"])
    return rows


def _cycle_rows(state_dir: Optional[str], limit: int = 12
                ) -> List[List[str]]:
    """The orchestrator cycle timeline from its crash-safe history dir
    (deploy/orchestrator.CycleStore archives one JSON per cycle)."""
    if not state_dir:
        return []
    history = os.path.join(state_dir, "history")
    try:
        names = sorted(os.listdir(history))
    except OSError:
        return []
    docs = []
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(history, name)) as f:
                docs.append(json.load(f))
        except (OSError, ValueError):
            continue
    docs.sort(key=lambda d: d.get("started_ms", 0), reverse=True)
    rows = []
    for d in docs[:limit]:
        started = time.strftime(
            "%Y-%m-%d %H:%M:%S",
            time.localtime(d.get("started_ms", 0) / 1000.0))
        wall = (d.get("updated_ms", 0) - d.get("started_ms", 0)) / 1000.0
        outcome = d.get("outcome", "?")
        mark = f"<b>{_esc(outcome)}</b>" if outcome != "promoted" \
            else _esc(outcome)
        rows.append([
            _esc(d.get("cycle_id", "?")), _esc(d.get("trigger", "?")),
            _esc(started), f"{wall:.1f}s", _esc(d.get("phase", "")),
            mark,
            _esc((f"v{d['candidate_release_version']}"
                  if d.get("candidate_release_version") else "-")),
            _esc((d.get("reason") or "")[:80])])
    return rows


def _dispatch_rows(reader, since_ms: int, top: int = 10
                   ) -> List[List[str]]:
    rates = reader.rate("pio_device_dispatch_seconds_total",
                        since_ms=since_ms)
    rates.sort(key=lambda r: -r["increase"])
    return [[_esc(r["labels"].get("family", "?")),
             _esc(r["labels"].get("process", "")),
             f"{r['increase']:.3f}s",
             f"{100.0 * r['rate']:.2f}%"]
            for r in rates[:top]]


def _trace_rows(reader, since_ms: int, limit: int = 12) -> List[List[str]]:
    local = recorder().traces(limit=limit)
    persisted = [t for _ts, t in reader.traces(since_ms=since_ms)]
    seen, rows = set(), []
    for t in (persisted + local)[-4 * limit:]:
        key = (t.get("traceId"), t.get("spanId"))
        if key in seen:
            continue
        seen.add(key)
        rows.append(t)
    rows.sort(key=lambda t: t.get("ts", 0), reverse=True)
    return [[_esc((t.get("traceId") or "?")[:12]),
             _esc(t.get("name", "?")),
             f"{1e3 * t.get('durationSec', 0.0):.1f}ms",
             _esc(t.get("status", "?")),
             _esc(t.get("process", ""))]
            for t in rows[:limit]]


def _event_rows(reader, since_ms: int, limit: int = 12) -> List[List[str]]:
    local = recorder().events(limit=limit)
    persisted = [e for _ts, e in reader.events(since_ms=since_ms)]
    seen, rows = set(), []
    for e in persisted + local:
        key = (e.get("ts"), e.get("kind"), e.get("traceId"))
        if key in seen:
            continue
        seen.add(key)
        rows.append(e)
    rows.sort(key=lambda e: e.get("ts", 0), reverse=True)
    out = []
    for e in rows[:limit]:
        detail = {k: v for k, v in e.items()
                  if k not in ("kind", "ts", "traceId", "process")}
        out.append([
            _esc(time.strftime("%H:%M:%S",
                               time.localtime(e.get("ts", 0)))),
            _esc(e.get("kind", "?")),
            _esc((e.get("traceId") or "-")[:12]),
            _esc(e.get("process", "")),
            _esc(json.dumps(detail, sort_keys=True)[:100])])
    return out


def _serving_rows(reader, since_ms: int) -> List[List[str]]:
    rows = []
    for info in reader.series("pio_query_duration_seconds",
                              since_ms=since_ms):
        if info.kind != "histogram" or not info.points:
            continue
        rows.append([
            _esc(info.labels.get("process", "")),
            _esc(info.labels.get("engine_variant", "")),
            f"{sum(info.points[-1][1]):.0f}",
            f"<code>{_series_sparkline(info)}</code>"])
    if rows:
        q99 = reader.quantile_over_time("pio_query_duration_seconds",
                                        0.99, since_ms=since_ms)
        rows[0].append(f"{1e3 * q99:.1f}ms" if q99 is not None else "")
        for row in rows[1:]:
            row.append("")
    return rows


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.0f}B" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}TiB"


def _capacity_rows(reader, since_ms: int) -> List[List[str]]:
    """Per-process capacity ledger: live device bytes (+history), the
    process watermark, host RSS, and the per-role unit residency."""
    last, spark = {}, {}
    for name in ("pio_capacity_device_bytes",
                 "pio_capacity_device_watermark_bytes",
                 "pio_capacity_host_rss_bytes"):
        for info in reader.series(name, since_ms=since_ms):
            if not info.points:
                continue
            proc = info.labels.get("process", "")
            last[(proc, name)] = info.points[-1][1]
            if name == "pio_capacity_device_bytes":
                spark[proc] = sparkline([p[1] for p in info.points])
    units: dict = {}
    for info in reader.series("pio_capacity_unit_resident_bytes",
                              since_ms=since_ms):
        if not info.points:
            continue
        proc = info.labels.get("process", "")
        units.setdefault(proc, []).append(
            f"{info.labels.get('role', '?')}="
            f"{_fmt_bytes(info.points[-1][1])}")
    rows = []
    for proc in sorted({p for p, _n in last}):
        rows.append([
            _esc(proc),
            _fmt_bytes(last.get((proc, "pio_capacity_device_bytes"), 0.0)),
            _fmt_bytes(last.get(
                (proc, "pio_capacity_device_watermark_bytes"), 0.0)),
            _fmt_bytes(last.get((proc, "pio_capacity_host_rss_bytes"),
                                0.0)),
            _esc(", ".join(sorted(units.get(proc, []))) or "-"),
            f"<code>{spark.get(proc, '')}</code>"])
    return rows


def _evaluation_rows() -> List[List[str]]:
    try:
        instances = \
            Storage.get_meta_data_evaluation_instances().get_completed()
    except Exception:
        return []
    return [[
        f"<a href='/engine_instances/{_esc(i.id)}'>{_esc(i.id)}</a>",
        _esc(i.evaluation_class),
        _esc(i.start_time.isoformat()),
        _esc(i.end_time.isoformat()),
        _esc(i.evaluator_results)] for i in instances]


def render_console(reader, orch_state_dir: Optional[str],
                   window_s: float = 3600.0) -> str:
    since_ms = int((time.time() - window_s) * 1000)
    sections = [
        _section("Releases", _table(
            ["engine/variant", "version", "status", "instance", "created",
             "lineage"], _releases_rows(),
            empty="no releases registered")),
        _section("SLO burn (trailing hour)", _table(
            ["process", "objective", "window", "burn now", "state",
             "history"], _slo_rows(reader, since_ms),
            empty="no persisted SLO history — is telemetry enabled on "
                  "the query server?")),
        _section("Serving (trailing hour)", _table(
            ["process", "variant", "queries", "throughput history",
             "p99 over window"], _serving_rows(reader, since_ms),
            empty="no persisted serving history")),
        _section("Capacity ledger (trailing hour)", _table(
            ["process", "device bytes", "watermark", "host RSS",
             "unit residency", "device history"],
            _capacity_rows(reader, since_ms),
            empty="no persisted capacity history — /capacity.json "
                  "answers live per process")),
        _section("Orchestrator cycles", _table(
            ["cycle", "trigger", "started", "wall", "last phase",
             "outcome", "release", "reason"],
            _cycle_rows(orch_state_dir),
            empty="no archived cycles (pio orchestrate writes them)")),
        _section("Top dispatch families (trailing hour)", _table(
            ["family", "process", "device seconds", "duty"],
            _dispatch_rows(reader, since_ms),
            empty="no dispatch attribution persisted")),
        _section("Recent traces", _table(
            ["trace", "name", "wall", "status", "process"],
            _trace_rows(reader, since_ms), empty="no traces recorded")),
        _section("Lifecycle events", _table(
            ["at", "kind", "trace", "process", "detail"],
            _event_rows(reader, since_ms), empty="no lifecycle events")),
        _section("Completed evaluations", _table(
            ["ID", "Evaluation", "Started", "Finished", "Result"],
            _evaluation_rows(), empty="no completed evaluations")),
    ]
    return (
        "<html><head><title>predictionio_tpu fleet console</title>"
        "<style>body{font-family:monospace;margin:24px}"
        "table{border-collapse:collapse;margin-bottom:12px}"
        "td,th{text-align:left}code{font-size:14px}</style></head><body>"
        "<h1>predictionio_tpu fleet console</h1>"
        "<p>JSON: <a href='/history/series.json'>/history/series.json</a>"
        " · /history/range.json?name=&lt;metric&gt;&amp;sinceS=3600"
        "[&amp;rate=1|&amp;quantile=0.99] · "
        "<a href='/metrics'>/metrics</a> · "
        "<a href='/debug/traces.json'>/debug/traces.json</a></p>"
        + "".join(sections) + "</body></html>")


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

def _evaluation_doc(i) -> dict:
    return {"id": i.id, "evaluationClass": i.evaluation_class,
            "startTime": i.start_time.isoformat(),
            "endTime": i.end_time.isoformat(),
            "result": i.evaluator_results}


class Dashboard:
    """``start`` binds on the running loop and returns the port;
    ``close`` stops it (and the telemetry it owns); :func:`run_dashboard`
    is the blocking form."""

    def __init__(self, server_config: Optional[ServerConfig] = None,
                 registry: Optional[MetricsRegistry] = None,
                 telemetry=None, history_root: Optional[str] = None,
                 orch_state_dir: Optional[str] = None):
        self.config = server_config or ServerConfig()
        self.registry = registry or MetricsRegistry()
        self.telemetry = telemetry
        self.orch_state_dir = orch_state_dir
        self._reader_factory = history_reader_factory(telemetry,
                                                      root=history_root)
        register_capacity_metrics(self.registry)
        observe = observability_middleware(self.registry, "dashboard")

        async def middleware(req: Request, label: str, call):
            async def authorized():
                if req.path in _OPEN_PATHS or self.config.check_key(
                        req.query.get("accessKey")):
                    return await call()
                return 401, {"message": "Unauthorized"}, {}
            return await observe(req, label, authorized)

        self._http = HttpServer([
            ("GET", "/", self.handle_index),
            ("GET", "/engine_instances/{instance_id}", self.handle_detail),
            ("GET", "/evaluations.json", self.handle_index_json),
            ("GET", "/evaluations/{instance_id}.json",
             self.handle_detail_json),
            *capacity_routes(),
            *metrics_routes(self.registry, default_registry()),
            *history_routes(self._reader_factory),
        ], middleware=middleware)
        self.stopped = asyncio.Event()

    async def start(self, host: str = "localhost", port: int = DEFAULT_PORT,
                    ssl_context=None) -> int:
        return await self._http.start(host, port, ssl_context=ssl_context)

    async def close(self) -> None:
        await self._http.close()
        if self.telemetry is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, self.telemetry.stop)
            self.telemetry = None

    async def handle_index(self, _req: Request):
        # the render reads (and CRC-checks) every telemetry segment and
        # the storage tables: off the event loop
        page = await asyncio.get_running_loop().run_in_executor(
            None, render_console, self._reader_factory(),
            self.orch_state_dir)
        return 200, RawBody(page.encode("utf-8"), _HTML)

    async def handle_detail(self, req: Request):
        instance = Storage.get_meta_data_evaluation_instances().get(
            req.params["instance_id"])
        if instance is None:
            return 404, RawBody(b"evaluation instance not found",
                                "text/plain; charset=utf-8")
        body = instance.evaluator_results_html or (
            "<html><body><pre>"
            f"{html.escape(instance.evaluator_results)}</pre></body></html>")
        return 200, RawBody(body.encode("utf-8"), _HTML)

    async def handle_index_json(self, _req: Request):
        return 200, [_evaluation_doc(i) for i in
                     Storage.get_meta_data_evaluation_instances()
                     .get_completed()]

    async def handle_detail_json(self, req: Request):
        instance = Storage.get_meta_data_evaluation_instances().get(
            req.params["instance_id"])
        if instance is None:
            return 404, {"message": "Not Found"}
        return 200, {"id": instance.id,
                     "evaluationClass": instance.evaluation_class,
                     "result": instance.evaluator_results,
                     "resultJSON": instance.evaluator_results_json}


def create_dashboard(server_config: Optional[ServerConfig] = None,
                     registry: Optional[MetricsRegistry] = None,
                     telemetry=None, history_root: Optional[str] = None,
                     orch_state_dir: Optional[str] = None) -> Dashboard:
    return Dashboard(server_config, registry, telemetry=telemetry,
                     history_root=history_root,
                     orch_state_dir=orch_state_dir)


def run_dashboard(host: str = "localhost", port: int = DEFAULT_PORT,
                  server_config: Optional[ServerConfig] = None,
                  on_ready=None) -> None:
    """Serve until SIGINT or SIGTERM under server.json's key and TLS;
    the console reads the telemetry root and the orchestrator's state
    directory (``orchestrator.stateDir``, else
    ``$PIO_HOME/orchestrator``). ``on_ready(port)`` runs once the
    socket is bound."""
    cfg = server_config or ServerConfig.load()
    registry = MetricsRegistry()
    telemetry = build_recorder("dashboard", cfg.telemetry,
                               instance=str(port),
                               registries=[registry, default_registry()])
    serve_until_stopped(
        create_dashboard(cfg, registry, telemetry=telemetry,
                         history_root=cfg.telemetry.root_dir(),
                         orch_state_dir=(cfg.orchestrator.state_dir
                                         or os.path.join(pio_home(),
                                                         "orchestrator"))),
        host, port, on_ready, ssl_context=cfg.ssl_context())
