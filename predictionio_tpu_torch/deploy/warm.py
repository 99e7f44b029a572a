"""Warm-up before a model takes traffic (port of the reference's
``deploy/warm.py``: ``ServingUnit``, ``FoldinSwapRaced``, ``build_unit``,
``warmup_ladder``, ``warmup_unit`` and ``verify_unit``).

Before a unit takes traffic — at deploy, and at ``GET /reload`` before
the swap — its full batch-predict path is driven once per reachable
bucketed batch size: the first batch builds the quantized scorer and
runs its parity gate, and every batch shape the micro-batcher can hand
the shortlist kernel launches once. Then one real scoring must succeed
(verify).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, List, Optional, Sequence

from predictionio_tpu_torch.obs.registry import MetricsRegistry, default_registry
from predictionio_tpu_torch.ops.bucketing import bucket_size
from predictionio_tpu_torch.storage.base import EngineInstance, Release

logger = logging.getLogger("pio.torch.deploy")


class FoldinSwapRaced(Exception):
    """A fold-in drift lost the cutover race: the serving unit changed
    (reload or rollback) between the solve's snapshot and the swap. The
    apply requeues its deltas and the next tick folds them onto whatever
    serves then, never reverting a real deploy."""


class DeployError(Exception):
    """A release failed to become servable (load/warmup/verify)."""


@dataclasses.dataclass
class ServingUnit:
    """One servable release: everything a query needs, bundled so a
    swap is one reference assignment. ``vectorized`` says whether every
    algorithm batches (micro-batching pays only then); ``batcher`` is
    attached by the query server."""

    instance: EngineInstance
    result: Any                        # core.engine.TrainResult
    vectorized: bool
    release: Optional[Release] = None
    batcher: Any = None
    #: the pre-fold-in base unit when this unit is an online fold-in
    #: drift of it (deploy/foldin): kept resident as the rollback standby
    #: however many applies stack on it
    foldin_of: Optional["ServingUnit"] = None
    #: factor rows folded into this unit since its base was deployed
    foldin_rows: int = 0

    @property
    def release_version(self) -> int:
        return self.release.version if self.release else 0


def build_unit(engine, instance: EngineInstance,
               release: Optional[Release] = None,
               device=None) -> ServingUnit:
    """Load a COMPLETED instance's stored models into a ServingUnit on
    ``device`` (the load phase; off the serving loop)."""
    from predictionio_tpu_torch.workflow.train import load_for_deploy

    result, _ctx = load_for_deploy(engine, instance, device=device)
    return ServingUnit(instance=instance, result=result,
                       vectorized=compute_vectorized(result),
                       release=release)


def compute_vectorized(result) -> bool:
    """Micro-batching pays only when EVERY algorithm overrides
    batch_predict."""
    from predictionio_tpu_torch.core.base import Algorithm

    return bool(result.algorithms) and all(
        type(a).batch_predict is not Algorithm.batch_predict
        for a in result.algorithms)


def resolve_warmup_query(result, explicit: Optional[Any] = None):
    """The query the shape ladder drives: an explicit one wins;
    otherwise the first algorithm that can synthesize one."""
    if explicit is not None:
        return explicit
    for algo, model in zip(result.algorithms, result.models):
        try:
            q = algo.warmup_query(model)
        except Exception:
            logger.exception("warmup_query failed on %s", type(algo).__name__)
            continue
        if q is not None:
            return q
    return None


@dataclasses.dataclass
class WarmupReport:
    """What the warmup pass exercised."""

    buckets: List[int] = dataclasses.field(default_factory=list)
    queries: int = 0
    seconds: float = 0.0
    skipped: Optional[str] = None   # reason when nothing could be warmed

    def to_dict(self) -> dict:
        return {"buckets": self.buckets, "queries": self.queries,
                "seconds": round(self.seconds, 6), "skipped": self.skipped}


def warmup_ladder(max_batch: int) -> List[int]:
    """The distinct bucketed batch sizes a batcher capped at `max_batch`
    can ever hand a scorer."""
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b <<= 1
    out.append(bucket_size(max_batch, max_batch))
    return sorted(set(out))


def warmup_unit(unit: ServingUnit,
                predict_batch: Callable[[Sequence[Any]], List[Any]],
                max_batch: int,
                query: Optional[Any] = None) -> WarmupReport:
    """Drive `predict_batch` (the unit's full serving batch path) once
    per reachable bucket shape. Per-query failures inside a rung are
    tolerated (verify is the health gate); a rung that fails wholesale
    raises DeployError."""
    report = WarmupReport()
    t0 = time.perf_counter()
    q = resolve_warmup_query(unit.result, query)
    if q is None:
        report.skipped = "no_warmup_query"
        report.seconds = time.perf_counter() - t0
        return report
    if not unit.vectorized:
        report.skipped = "not_vectorized"
    for b in ([1] if report.skipped else warmup_ladder(max_batch)):
        try:
            out = predict_batch([q] * b)
        except Exception as e:
            raise DeployError(f"warmup failed at batch size {b}: {e!r}") from e
        report.buckets.append(b)
        report.queries += b
        if out and all(isinstance(r, Exception) for r in out):
            raise DeployError(
                f"warmup batch of {b} failed wholesale: {out[0]!r}")
    report.seconds = time.perf_counter() - t0
    return report


def verify_unit(unit: ServingUnit,
                predict_batch: Callable[[Sequence[Any]], List[Any]],
                query: Optional[Any] = None) -> None:
    """One real scoring through the unit's serving path must produce a
    non-error result before the unit may take traffic."""
    q = resolve_warmup_query(unit.result, query)
    if q is None:
        logger.warning("verify skipped: no warmup query for instance %s",
                       unit.instance.id)
        return
    out = predict_batch([q])
    if not out or isinstance(out[0], Exception):
        err = out[0] if out else RuntimeError("empty result")
        raise DeployError(f"verify query failed: {err!r}")


# ---------------------------------------------------------------------------
# pio_deploy_* metric handles
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeployMetrics:
    phase_hist: Any       # pio_deploy_phase_duration_seconds{phase}
    swap_total: Any       # pio_deploy_swap_total{mode, outcome}
    rollback_total: Any   # pio_deploy_rollback_total{reason}
    promote_total: Any    # pio_deploy_promote_total{reason}
    requests_total: Any   # pio_deploy_requests_total{role}
    canary_fraction: Any  # pio_deploy_canary_fraction gauge
    canary_splitter_acc: Any  # pio_deploy_canary_splitter_acc gauge
    active_version: Any   # pio_deploy_active_release_version gauge
    warmup_shapes: Any    # pio_deploy_warmup_shapes_total counter


def deploy_metrics(registry: Optional[MetricsRegistry] = None
                   ) -> DeployMetrics:
    """Get-or-create the deploy metric family on `registry`
    (idempotent; the reference's series)."""
    reg = registry or default_registry()
    return DeployMetrics(
        phase_hist=reg.histogram(
            "pio_deploy_phase_duration_seconds",
            "Wall time of each deploy phase (load/warmup/verify/swap/drain)",
            labelnames=("phase",)),
        swap_total=reg.counter(
            "pio_deploy_swap_total",
            "Release cutovers by mode (warm/cold) and outcome",
            labelnames=("mode", "outcome")),
        rollback_total=reg.counter(
            "pio_deploy_rollback_total",
            "Rollbacks by trigger (slo_latency/slo_errors/operator)",
            labelnames=("reason",)),
        promote_total=reg.counter(
            "pio_deploy_promote_total",
            "Canary promotions by trigger (healthy/operator)",
            labelnames=("reason",)),
        requests_total=reg.counter(
            "pio_deploy_requests_total",
            "Queries routed per serving role during a staged rollout",
            labelnames=("role",)),
        canary_fraction=reg.gauge(
            "pio_deploy_canary_fraction",
            "Traffic fraction currently routed to the canary (0 = none)"),
        canary_splitter_acc=reg.gauge(
            "pio_deploy_canary_splitter_acc",
            "Canary splitter's error-diffusion accumulator — persisted "
            "through the telemetry store so a restarted server resumes "
            "the exact mid-stream split instead of re-seeding at zero"),
        active_version=reg.gauge(
            "pio_deploy_active_release_version",
            "Release version currently serving full traffic (0 = unversioned)"),
        warmup_shapes=reg.counter(
            "pio_deploy_warmup_shapes_total",
            "Bucket shapes driven through warmup passes"),
    )
