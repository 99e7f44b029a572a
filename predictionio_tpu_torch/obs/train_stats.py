"""Training-kernel metrics: ALS solver block sweeps, Gramian cache, timing.

The subspace (iALS++ block coordinate descent) ALS solver executes its
rank-block sweeps fused inside one jitted device loop, so these metrics
are accounted host-side per training dispatch:

* ``pio_train_als_block_sweeps_total`` — rank-block solves executed
  (2 * iterations * blocks-per-sweep per train). Flat at zero on a box
  that believes it enabled the subspace solver = misconfiguration.
* ``pio_train_als_gramian_cache_hits_total`` — block solves served from
  the per-half-sweep cached Gramian/count terms (the global V^T V slices
  and the ALS-WR lambda counts are built once per half-sweep and reused
  by every subsequent block) instead of a per-block rebuild.
* ``pio_train_als_half_sweep_seconds{solver}`` — per-half-sweep wall
  time, DERIVED as dispatch wall / (2 * iterations): the sweeps run
  fused under ``lax.fori_loop``, so per-sweep sampling would require
  breaking the fusion this kernel exists to keep. WARM dispatches only:
  a run whose program had to trace+compile observes nothing, since
  compile seconds would drown the per-solver kernel comparison.

The device dispatch itself is wrapped in an ``als_solve`` span
(``pio_span_duration_seconds{span="als_solve"}``).
"""

from __future__ import annotations

from predictionio_tpu_torch.obs.registry import (
    MetricsRegistry, default_registry, exponential_buckets,
)

#: 1 ms .. ~2 min doubling — a half-sweep, not a whole training run
HALF_SWEEP_BUCKETS = exponential_buckets(0.001, 2.0, 17)


def als_block_sweeps(registry: MetricsRegistry = None):
    return (registry or default_registry()).counter(
        "pio_train_als_block_sweeps_total",
        "Rank-block solves executed by the subspace ALS solver")


def als_gramian_cache_hits(registry: MetricsRegistry = None):
    return (registry or default_registry()).counter(
        "pio_train_als_gramian_cache_hits_total",
        "Block solves served from the per-half-sweep cached Gramian/"
        "regularization terms instead of a rebuild")


def als_half_sweep_seconds(registry: MetricsRegistry = None):
    return (registry or default_registry()).histogram(
        "pio_train_als_half_sweep_seconds",
        "Per-half-sweep ALS wall time (dispatch wall / half-sweeps), "
        "by solver", labelnames=("solver",), buckets=HALF_SWEEP_BUCKETS)
