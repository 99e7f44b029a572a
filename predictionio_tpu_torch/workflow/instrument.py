"""Shared run instrumentation for the train/evaluate workflows.

One context manager owns the whole harness: run counter by outcome,
end-to-end duration histogram, a ``collect_phases`` sink bridged into
``pio_phase_duration_seconds`` (published on success AND failure — a
failed run's partial phase breakdown is exactly what you debug with),
and the capacity ledger's device gauges (``obs/capacity``) registered
on the process registry.
"""

from __future__ import annotations

import contextlib
import time

from predictionio_tpu_torch.obs.capacity import register_capacity_metrics
from predictionio_tpu_torch.obs.registry import default_registry, exponential_buckets
from predictionio_tpu_torch.utils.profiling import collect_phases

#: 100 ms .. ~27 min doubling — training runs, not request latencies
WORKFLOW_DURATION_BUCKETS = exponential_buckets(0.1, 2.0, 15)


def publish_phase_timings(sink: dict, workflow: str) -> None:
    """Bridge a ``collect_phases`` sink into the process registry so
    per-phase breakdowns (build/transfer/...) surface at /metrics."""
    if not sink:
        return
    hist = default_registry().histogram(
        "pio_phase_duration_seconds",
        "Host-phase wall time bridged from utils.profiling.collect_phases",
        labelnames=("workflow", "phase"), buckets=WORKFLOW_DURATION_BUCKETS)
    for name, seconds in sink.items():
        hist.observe(seconds, workflow=workflow, phase=name)


@contextlib.contextmanager
def workflow_run_metrics(workflow: str, metric_prefix: str):
    """Instrument one workflow run; yields the phase sink.

    ``workflow`` labels the phase timings ("train"/"evaluate");
    ``metric_prefix`` names the run metrics ("pio_train" ->
    pio_train_runs_total + pio_train_duration_seconds).
    """
    registry = register_capacity_metrics(default_registry())
    runs = registry.counter(f"{metric_prefix}_runs_total",
                            f"{workflow} workflow runs by outcome",
                            labelnames=("status",))
    duration = registry.histogram(
        f"{metric_prefix}_duration_seconds",
        f"End-to-end {workflow} workflow wall time by outcome",
        labelnames=("status",), buckets=WORKFLOW_DURATION_BUCKETS)
    t0 = time.perf_counter()
    phases: dict = {}
    try:
        with collect_phases(phases):
            yield phases
    except BaseException:
        runs.inc(status="failed")
        duration.observe(time.perf_counter() - t0, status="failed")
        publish_phase_timings(phases, workflow)
        raise
    runs.inc(status="completed")
    duration.observe(time.perf_counter() - t0, status="completed")
    publish_phase_timings(phases, workflow)
