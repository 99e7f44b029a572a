"""Request observability for the port's HTTP layer (the reference's
``obs/middleware.py``, as a ``server/http`` middleware: the machine
with the card has no aiohttp).

``observability_middleware(registry, service)`` gives every request a
request ID (honouring an incoming ``X-Request-ID``), opens a trace for
the ``span()`` API, times the handler into
``pio_http_request_duration_seconds{service,method,handler,status}``,
tracks in-flight requests, and emits a structured slow-request log line
when the wall time crosses the threshold (``PIO_SLOW_REQUEST_SECONDS``,
default 1.0 s). The ``handler`` label is the route's pattern
(``/events/{event_id}.json``), never the raw path, and ``__unmatched__``
for a request no route took, so the label's cardinality stays bounded.

Cross-process propagation: an incoming ``X-Pio-Trace`` header
(``trace_id:span_id``) makes the request a child of the carrier's
trace. The response echoes the request's own context in the same
header, and every completed request is recorded in the in-memory flight
recorder, exposed at ``GET /debug/traces.json``. ``PIO_TRACING=0``
disables the trace layer (no contextvars, no recorder writes) while
keeping every metric.

Where the handler's anatomy stages tile an interval of the wall
(``Trace.stage_frame``), the middleware books the rest of its wall, its
own steps before and after the handler, to the trace pseudo-span
``anatomy_middleware``, so a stall there shows under its own name.

:func:`metrics_routes` gives ``GET /metrics`` (Prometheus text
exposition 0.0.4), ``GET /metrics.json`` and ``GET /debug/traces.json``
over the given registries merged: by convention the server's own
registry first, then :func:`default_registry`. They are
unauthenticated, as the reference's are: aggregate counts and bounded
trace rings only.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Tuple

from predictionio_tpu_torch.obs.anatomy import (
    MIDDLEWARE_STAGE, TRACE_STAGE_PREFIX,
)
from predictionio_tpu_torch.obs.registry import (
    PROMETHEUS_CONTENT_TYPE, MetricsRegistry, default_registry,
    render_json, render_prometheus,
)
from predictionio_tpu_torch.obs.trace_context import (
    TRACE_HEADER, TraceContext, recorder,
)
from predictionio_tpu_torch.obs.tracing import (
    REQUEST_ID_HEADER, log_slow_request, new_request_id, reset_trace,
    span_histogram, start_trace, tracing_enabled,
)
from predictionio_tpu_torch.server.http import RawBody, Request

logger = logging.getLogger("pio.obs")

DEFAULT_SLOW_REQUEST_SECONDS = 1.0


def slow_request_threshold() -> float:
    try:
        return float(os.environ.get("PIO_SLOW_REQUEST_SECONDS",
                                    DEFAULT_SLOW_REQUEST_SECONDS))
    except ValueError:
        return DEFAULT_SLOW_REQUEST_SECONDS


def observability_middleware(registry: MetricsRegistry, service: str,
                             slow_threshold_s: float = None):
    if slow_threshold_s is None:
        slow_threshold_s = slow_request_threshold()
    duration = registry.histogram(
        "pio_http_request_duration_seconds",
        "HTTP request wall time by service/method/handler/status",
        labelnames=("service", "method", "handler", "status"))
    in_flight = registry.gauge(
        "pio_http_requests_in_flight",
        "Requests currently being handled", labelnames=("service",))
    spans = span_histogram(registry)
    flight = recorder()
    rid_header = REQUEST_ID_HEADER.lower()
    trace_header = TRACE_HEADER.lower()

    async def middleware(request: Request, handler_label: str, call):
        request_id = request.headers.get(rid_header) or new_request_id()
        tokens = trace = None
        if tracing_enabled():
            parent = TraceContext.decode(request.headers.get(trace_header))
            tokens, trace = start_trace(request_id, registry, spans,
                                        context=parent)
        in_flight.inc(service=service)
        t0 = time.perf_counter()
        status = 500
        try:
            status, payload, headers = await call()
            headers = {**headers, REQUEST_ID_HEADER: request_id}
            if trace is not None:
                headers[TRACE_HEADER] = trace.context().encode()
            return status, payload, headers
        finally:
            in_flight.dec(service=service)
            t_end = time.perf_counter()
            dt = t_end - t0
            if trace is not None and trace.stage_frame is not None:
                start, end = trace.stage_frame
                trace.add(TRACE_STAGE_PREFIX + MIDDLEWARE_STAGE,
                          (start - t0) + (t_end - end))
            duration.observe(dt, service=service, method=request.method,
                             handler=handler_label, status=str(status))
            if dt >= slow_threshold_s:
                log_slow_request(service, request.method, request.path,
                                 status, dt, trace)
            if trace is not None:
                flight.record_span(
                    trace_id=trace.trace_id, span_id=trace.span_id,
                    parent_span_id=trace.parent_span_id,
                    name=f"{service} {request.method} {handler_label}",
                    duration_s=dt, spans=trace.spans_by_name(),
                    status="ok" if status < 500 else "error")
                reset_trace(tokens)

    return middleware


METRICS_PATHS = ("/metrics", "/metrics.json", "/debug/traces.json")


def metrics_routes(*registries: MetricsRegistry) -> List[Tuple]:
    """``GET /metrics``, ``/metrics.json`` and ``/debug/traces.json``
    (``traceId``, ``limit`` and ``sinceS`` query parameters) as
    ``server/http`` routes."""
    regs = tuple(registries) or (default_registry(),)

    async def handle_metrics(_req):
        return 200, RawBody(render_prometheus(regs).encode("utf-8"),
                            PROMETHEUS_CONTENT_TYPE)

    async def handle_metrics_json(_req):
        return 200, render_json(regs)

    async def handle_traces(req):
        q = req.query
        try:
            limit = int(q["limit"]) if "limit" in q else None
        except ValueError:
            limit = None
        since_ts = None
        try:
            if "sinceS" in q:
                since_ts = time.time() - float(q["sinceS"])
        except ValueError:
            pass
        return 200, recorder().to_json(q.get("traceId"), limit, since_ts)

    return [("GET", "/metrics", handle_metrics),
            ("GET", "/metrics.json", handle_metrics_json),
            ("GET", "/debug/traces.json", handle_traces)]
