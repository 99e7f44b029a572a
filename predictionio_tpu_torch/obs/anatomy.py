"""Per-request critical-path anatomy: where each request's wall went.

The trace plane says *that* a request was slow; this module says *why*:
every query that rides the micro-batcher gets an exact stage breakdown
(queue wait, linger, batch assemble, device, serve, serialize) plus two
amortized *cost* attributions (its share of the batch's pad rows, and
its share of the kernel wrappers' dispatch wall, measured by
``ops/kernels``), and the ingest path gets the same treatment
(submit → flush-wait → commit). Stages land in two places:

* the request's own trace, as ``anatomy_*`` pseudo-spans — so the
  flight-recorder record and the structured slow-request log show the
  breakdown per request;
* ``pio_anatomy_stage_seconds{path,stage}`` — per-stage histograms the
  telemetry loop persists to the tsdb, which is what ``pio analyze``
  reads for tail composition and regression diffs.

Elapsed stages are additive: their per-request sum approximates the
request wall (members of a coalesced batch each experience the full
batch device/serve wall — that IS their critical path). The cost
stages (``pad_share``, ``device_dispatch``) are shares of batch work
divided over member rows, built for capacity math, and deliberately
not part of the wall identity.

This module also installs the registry's exemplar provider: with the
plane enabled, every histogram observation made under a live trace
stamps its bucket's exemplar slot with (trace_id, value, ts).

``PIO_ANATOMY=0`` kills the whole plane (stage accounting AND exemplar
capture); the reference holds the enabled path to within 5% + 0.3 ms
of p99 against this switch, and the smoke's ``obs`` phase measures the
port against the same limit.
"""

from __future__ import annotations

import contextvars
import os
from typing import Dict, List, Optional, Tuple

from predictionio_tpu_torch.obs import registry as registry_mod
from predictionio_tpu_torch.obs import tracing
from predictionio_tpu_torch.obs.registry import MetricsRegistry, default_registry

ANATOMY_ENV = "PIO_ANATOMY"

STAGE_HISTOGRAM = "pio_anatomy_stage_seconds"

SERVING_PATH = "serving"
INGEST_PATH = "ingest"

#: elapsed serving stages — per-request sum ≈ request wall
SERVING_WALL_STAGES = ("queue_wait", "linger", "assemble", "device",
                       "serve", "serialize")
#: the HTTP middleware's own steps around a handler whose wall stages it
#: frames (``obs/middleware``): a trace pseudo-span only, no histogram;
#: with it the wall stages tile the middleware's wall
MIDDLEWARE_STAGE = "middleware"
#: amortized cost attributions (shares of batch work, not elapsed wall)
SERVING_COST_STAGES = ("pad_share", "device_dispatch")
INGEST_STAGES = ("flush_wait", "commit")

#: anatomy stages ride traces as pseudo-spans under this prefix, which
#: keeps them distinct from the real span() timeline they decompose
TRACE_STAGE_PREFIX = "anatomy_"


def anatomy_enabled() -> bool:
    return os.environ.get(ANATOMY_ENV, "1").strip().lower() not in (
        "0", "false", "no", "off")


def _exemplar_trace_id() -> Optional[str]:
    if not anatomy_enabled():
        return None
    trace = tracing.current_trace()
    return trace.trace_id if trace is not None else None


# the hook is installed at import (this module is pulled in by every
# hot path that observes histograms under a trace); registry stays
# dependency-free and merely consults it
registry_mod.set_exemplar_provider(_exemplar_trace_id)


class AnatomyMetrics:
    """Pre-resolved handles for the anatomy histograms (hot paths
    resolve once, like deploy_metrics)."""

    def __init__(self, registry: MetricsRegistry):
        self.stage = registry.histogram(
            STAGE_HISTOGRAM,
            "Per-request critical-path stage breakdown (elapsed stages "
            "sum to the request wall; pad_share/device_dispatch are "
            "amortized batch-cost shares)",
            labelnames=("path", "stage"))


def anatomy_metrics(registry: MetricsRegistry = None) -> AnatomyMetrics:
    """Get-or-create the anatomy metric family on `registry`."""
    return AnatomyMetrics(registry or default_registry())


class BatchBreakdown:
    """Mutable accumulator one drained micro-batch fills while it runs:
    the predict path notes its stage walls, the kernel wrappers add
    their dispatch time, the padding logic its pad/bucket
    geometry. Single-threaded by construction (one executor thread owns
    one batch), so no lock."""

    __slots__ = ("stages", "dispatch_s", "pad_rows", "bucket", "rows")

    def __init__(self):
        self.stages: Dict[str, float] = {}
        self.dispatch_s = 0.0
        self.pad_rows = 0
        self.bucket = 0
        self.rows = 0

    def add_stage(self, name: str, seconds: float) -> None:
        self.stages[name] = self.stages.get(name, 0.0) + seconds

    def note_padding(self, rows: int, pad_rows: int, bucket: int) -> None:
        self.rows = rows
        self.pad_rows = pad_rows
        self.bucket = bucket


_breakdown_var: contextvars.ContextVar[Optional[BatchBreakdown]] = \
    contextvars.ContextVar("pio_anatomy_breakdown", default=None)


def push_breakdown(bd: Optional[BatchBreakdown]):
    return _breakdown_var.set(bd)


def pop_breakdown(token) -> None:
    _breakdown_var.reset(token)


def active_breakdown() -> Optional[BatchBreakdown]:
    return _breakdown_var.get()


def note_stage(name: str, seconds: float) -> None:
    """Add a measured stage wall to the active batch breakdown (no-op
    outside a batch — the span() plumbing calls this unconditionally)."""
    bd = _breakdown_var.get()
    if bd is not None:
        bd.add_stage(name, seconds)


def note_dispatch(seconds: float) -> None:
    """The kernel wrappers' dispatch wall for the active
    batch (one contextvar read per dispatch; no-op outside a batch)."""
    bd = _breakdown_var.get()
    if bd is not None:
        bd.dispatch_s += seconds


def observe_stage(metrics: AnatomyMetrics, path: str, stage: str,
                  seconds: float, trace=None) -> None:
    """One stage observation: histogram always, trace pseudo-span when
    the request's trace is known."""
    metrics.stage.observe(seconds, path=path, stage=stage)
    if trace is not None:
        trace.add(TRACE_STAGE_PREFIX + stage, seconds)


def observe_serving_batch(metrics: AnatomyMetrics, bd: BatchBreakdown,
                          entries: List[Tuple[float, object]],
                          linger_s: float, t_dispatch: float) -> None:
    """Per-member stage observations for one drained micro-batch.

    `entries` is (submit perf_counter, request Trace-or-None) per member
    row; `t_dispatch` the perf_counter when the worker handed the batch
    to the executor. Queue wait is each member's submit→dispatch wall
    minus its linger share (members that arrived mid-linger waited less
    than the full window)."""
    rows = max(1, bd.rows or len(entries))
    assemble = bd.stages.get("batch_assemble", 0.0)
    device = bd.stages.get("batch_device", 0.0)
    serve = bd.stages.get("batch_serve", 0.0)
    dispatch_share = bd.dispatch_s / rows
    pad_share = (device * bd.pad_rows / (bd.bucket * rows)
                 if bd.bucket else 0.0)
    for t_submit, trace in entries:
        wait = max(0.0, t_dispatch - t_submit)
        linger_share = min(max(0.0, linger_s), wait)
        observe_stage(metrics, SERVING_PATH, "queue_wait",
                      wait - linger_share, trace)
        observe_stage(metrics, SERVING_PATH, "linger", linger_share, trace)
        observe_stage(metrics, SERVING_PATH, "assemble", assemble, trace)
        observe_stage(metrics, SERVING_PATH, "device", device, trace)
        observe_stage(metrics, SERVING_PATH, "serve", serve, trace)
        observe_stage(metrics, SERVING_PATH, "pad_share", pad_share, trace)
        observe_stage(metrics, SERVING_PATH, "device_dispatch",
                      dispatch_share, trace)


# ---------------------------------------------------------------------------
# tail-anatomy analysis (pio analyze) — pure functions over the tsdb
# reader so the report math is testable without a server or a CLI
# ---------------------------------------------------------------------------

def stages_for(path: str) -> Tuple[str, ...]:
    if path == INGEST_PATH:
        return INGEST_STAGES
    return SERVING_WALL_STAGES + SERVING_COST_STAGES


def stage_stats(reader, path: str, since_ms=None, until_ms=None
                ) -> Dict[str, Dict]:
    """Per-stage window statistics from the persisted anatomy
    histograms: observation count, summed seconds, mean, p50, p99 —
    the raw material of the tail report and the regression diff."""
    from predictionio_tpu_torch.obs.tsdb import bucket_quantile

    out: Dict[str, Dict] = {}
    for stage in stages_for(path):
        window = reader.histogram_window(
            STAGE_HISTOGRAM, labels={"path": path, "stage": stage},
            since_ms=since_ms, until_ms=until_ms)
        if window is None:
            continue
        layout, counts, total, sum_inc = window
        if total <= 0:
            continue
        out[stage] = {
            "count": total,
            "sum": sum_inc,
            "mean": sum_inc / total,
            "p50": bucket_quantile(layout, counts, 0.50),
            "p99": bucket_quantile(layout, counts, 0.99),
        }
    return out


def composition(stats: Dict[str, Dict], path: str,
                which: str = "p99") -> Dict[str, float]:
    """Each WALL stage's share of the summed ``which`` quantile — the
    "where does a p99 request spend its wall" answer (cost stages are
    excluded: they are amortized shares of the device wall, and adding
    them would double-count it)."""
    wall = (SERVING_WALL_STAGES if path != INGEST_PATH
            else INGEST_STAGES)
    values = {s: stats[s][which] for s in wall if s in stats}
    total = sum(values.values())
    if total <= 0:
        return {}
    return {s: v / total for s, v in values.items()}


def regression_diff(before: Dict[str, Dict],
                    after: Dict[str, Dict]) -> Optional[Dict]:
    """Name the stage a regression came from: the largest mean-wall
    increase between two windows of the same path. Returns None when
    the windows share no stage (nothing to compare)."""
    deltas = sorted(
        ((after[s]["mean"] - before[s]["mean"], s)
         for s in after if s in before),
        reverse=True)
    if not deltas:
        return None
    delta, stage = deltas[0]
    return {
        "stage": stage,
        "deltaMeanS": delta,
        "beforeMeanS": before[stage]["mean"],
        "afterMeanS": after[stage]["mean"],
        "deltas": {s: d for d, s in deltas},
    }


def observe_ingest_batch(metrics: AnatomyMetrics,
                         entries: List[Tuple[float, object]],
                         t_flush_start: float, commit_s: float) -> None:
    """Per-pending stage observations for one WriteBuffer flush:
    flush_wait is each submitter's submit→flush wall, commit the shared
    storage-commit wall they all rode. `entries` is (submit
    perf_counter, submitter Trace-or-None) per pending."""
    for t_submit, trace in entries:
        observe_stage(metrics, INGEST_PATH, "flush_wait",
                      max(0.0, t_flush_start - t_submit), trace)
        observe_stage(metrics, INGEST_PATH, "commit", commit_s, trace)
