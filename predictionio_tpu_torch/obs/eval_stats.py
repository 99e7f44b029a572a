"""Evaluation-sweep metrics: grid size, device batch sizes, compile groups.

The vectorized `pio eval` path executes the whole candidate grid as a few
large device programs; these metrics make that visible on /metrics:

* ``pio_eval_candidates_total{mode}`` — candidates processed, labelled by
  execution mode (``batched`` device sweep vs ``sequential`` fallback).
  A sweep that silently fell back to the per-candidate loop shows up as
  the wrong label, not as an invisible slowdown.
* ``pio_eval_batch_size`` — histogram of (candidate x fold) units per
  compiled launch; the leading-axis size the vmap'd train covers.
* ``pio_eval_compile_groups`` — gauge: compile groups (distinct
  shape-changing parameter sets, i.e. ranks) of the last sweep. The
  XLA-compile ledger of a sweep is bounded by THIS, not by grid size.

Stage timings ride the shared ``span()`` API as ``eval_*`` spans
(``pio_span_duration_seconds{span=...}``).
"""

from __future__ import annotations

from predictionio_tpu_torch.obs.registry import (
    MetricsRegistry, default_registry, exponential_buckets,
)

#: 1 .. 2048 units per launch, doubling
EVAL_BATCH_BUCKETS = exponential_buckets(1.0, 2.0, 12)


def eval_candidates_counter(registry: MetricsRegistry = None):
    return (registry or default_registry()).counter(
        "pio_eval_candidates_total",
        "Evaluation-sweep candidates processed, by execution mode",
        labelnames=("mode",))


def eval_batch_size(registry: MetricsRegistry = None):
    return (registry or default_registry()).histogram(
        "pio_eval_batch_size",
        "Candidate x fold units per compiled eval-sweep launch",
        buckets=EVAL_BATCH_BUCKETS)


def eval_compile_groups(registry: MetricsRegistry = None):
    return (registry or default_registry()).gauge(
        "pio_eval_compile_groups",
        "Compile groups (distinct shape-changing param sets) in the last "
        "eval sweep")
