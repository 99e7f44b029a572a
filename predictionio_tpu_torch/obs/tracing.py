"""Tracing: request ids, the contextvar span API and cross-hop carry (a
copy of the reference's ``obs/tracing.py``; its HTTP middleware,
``obs/middleware.py``, is not ported yet).

``span("name")`` anywhere below an active trace records a named stage
timing without threading arguments through every signature. A trace has
an identity that survives thread and process boundaries
(``obs/trace_context``): thread hops capture it with
:func:`capture_context` and re-enter it with :func:`carried`; whole
processes adopt a parent's context from ``PIO_TRACE_CONTEXT`` with
:func:`adopt`, so one trace id stitches a fleet run end to end.

Span timings feed two places: the active trace (its records in the
flight recorder, the structured slow-request log line) and the owning
registry's ``pio_span_duration_seconds`` histogram.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import time
import uuid
from typing import Dict, List, Optional, Tuple

from predictionio_tpu_torch.obs.registry import MetricsRegistry
from predictionio_tpu_torch.obs.trace_context import (
    TraceContext, new_span_id, recorder,
)

logger = logging.getLogger("pio.obs")


_request_id_var: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("pio_request_id", default=None)
_trace_var: contextvars.ContextVar[Optional["Trace"]] = \
    contextvars.ContextVar("pio_trace", default=None)


def new_request_id() -> str:
    return uuid.uuid4().hex


def current_request_id() -> Optional[str]:
    return _request_id_var.get()


def current_trace() -> Optional["Trace"]:
    return _trace_var.get()


def span_histogram(registry: MetricsRegistry):
    """Resolve the span histogram once (callers on hot paths cache this)."""
    return registry.histogram(
        "pio_span_duration_seconds",
        "Per-stage wall time recorded by span()", labelnames=("span",))


class Trace:
    """Per-request (or per-job/per-hop) span accumulator with identity."""

    __slots__ = ("request_id", "registry", "span_hist", "spans",
                 "trace_id", "span_id", "parent_span_id")

    def __init__(self, request_id: str,
                 registry: Optional[MetricsRegistry] = None,
                 span_hist=None,
                 context: Optional[TraceContext] = None):
        self.request_id = request_id
        self.registry = registry
        #: pre-resolved pio_span_duration_seconds handle — span() exits on
        #: the query hot path must not take the registry lock per call
        self.span_hist = span_hist
        self.spans: List[Tuple[str, float]] = []
        # identity: adopt the carried context (this hop is a child of the
        # carrier), else the request id IS the trace id (root)
        if context is not None:
            self.trace_id = context.trace_id
            self.parent_span_id = context.span_id
        else:
            self.trace_id = request_id
            self.parent_span_id = None
        self.span_id = new_span_id()

    def add(self, name: str, seconds: float) -> None:
        self.spans.append((name, seconds))

    def spans_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, seconds in self.spans:
            out[name] = out.get(name, 0.0) + seconds
        return out

    def context(self) -> TraceContext:
        """This trace's position as a carryable context (the hop a child
        span/process attaches under)."""
        return TraceContext(self.trace_id, self.span_id)


def start_trace(request_id: str,
                registry: Optional[MetricsRegistry] = None,
                span_hist=None,
                context: Optional[TraceContext] = None):
    """Install a fresh trace + request id; returns tokens for
    :func:`reset_trace`."""
    trace = Trace(request_id, registry, span_hist, context=context)
    return (_request_id_var.set(request_id), _trace_var.set(trace)), trace


def reset_trace(tokens) -> None:
    rid_token, trace_token = tokens
    _request_id_var.reset(rid_token)
    _trace_var.reset(trace_token)


def capture_context() -> Optional[TraceContext]:
    """The active trace's carryable context (None outside a trace) — the
    cheap contextvar read a submit path does so a worker thread can later
    :func:`carried` into the same trace."""
    trace = _trace_var.get()
    return trace.context() if trace is not None else None


@contextlib.contextmanager
def carried(context: Optional[TraceContext], name: str,
            registry: Optional[MetricsRegistry] = None,
            span_hist=None, record: bool = True,
            attrs: Optional[dict] = None):
    """Re-enter a captured trace context on another thread.

    Installs a child Trace of ``context`` (or a fresh root when the
    submitter had none) named ``name``; ``span()`` calls inside link to
    the originating request's trace id, and on exit the hop is recorded
    in the flight recorder (``record=False`` skips — e.g. per-batch hops
    that would flood the ring under load record selectively)."""
    rid = context.trace_id if context is not None else new_request_id()
    tokens, trace = start_trace(rid, registry, span_hist, context=context)
    t0 = time.perf_counter()
    status = "ok"
    try:
        yield trace
    except BaseException:
        status = "error"
        raise
    finally:
        reset_trace(tokens)
        if record:
            recorder().record_span(
                trace_id=trace.trace_id, span_id=trace.span_id,
                parent_span_id=trace.parent_span_id, name=name,
                duration_s=time.perf_counter() - t0,
                spans=trace.spans_by_name(), status=status, attrs=attrs)


@contextlib.contextmanager
def adopt(name: str, context: Optional[TraceContext] = None,
          registry: Optional[MetricsRegistry] = None,
          attrs: Optional[dict] = None):
    """Run a whole job (train, eval, a batchpredict shard) as one trace.

    ``context=None`` reads ``PIO_TRACE_CONTEXT`` from the environment —
    a shard spawned by a parent run joins the parent's trace — and
    falls back to the ACTIVE trace context: a workflow invoked
    in-process by a traced parent (an orchestrator cycle running
    run_train/run_evaluation as phases) joins the parent's trace id
    instead of starting a fresh root. A standalone run becomes a root.
    The job is recorded in the flight recorder on exit either way."""
    if context is None:
        from predictionio_tpu_torch.obs.trace_context import from_env

        context = from_env()
        if context is None:
            context = capture_context()
    with carried(context, name, registry=registry, attrs=attrs) as trace:
        yield trace


@contextlib.contextmanager
def span(name: str, registry: Optional[MetricsRegistry] = None):
    """Record this block's wall time as a named stage of the current
    request (no-op-cheap when no trace/registry is active)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        trace = _trace_var.get()
        hist = None
        if trace is not None:
            trace.add(name, dt)
            if registry is None:
                hist = trace.span_hist
                if hist is None and trace.registry is not None:
                    hist = span_histogram(trace.registry)
        if hist is None and registry is not None:
            hist = span_histogram(registry)
        if hist is not None:
            hist.observe(dt, span=name)


def log_slow_request(service: str, method: str, path: str, status: int,
                     duration_s: float, trace: Optional[Trace]) -> None:
    """One structured line per over-threshold request (the reference's
    format: ``slow request`` and a sort_keys JSON object)."""
    payload = {
        "requestId": trace.request_id if trace else None,
        "traceId": trace.trace_id if trace else None,
        "service": service,
        "method": method,
        "path": path,
        "status": status,
        "durationSec": round(duration_s, 6),
        "spans": {name: round(secs, 6) for name, secs in
                  (trace.spans_by_name() if trace else {}).items()},
    }
    logger.warning("slow request %s", json.dumps(payload, sort_keys=True))
