"""pio_orchestrator_* metric handles (port of the reference's
``obs/orch_stats.py``, the same names and labels).

One get-or-create bundle like obs/batch_stats.py: the orchestrator
resolves its handles once per process, chaos tests assert against the
same registry, and the docs-drift gate sees every name as a literal.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from predictionio_tpu_torch.obs.registry import MetricsRegistry, default_registry


@dataclasses.dataclass
class OrchestratorMetrics:
    cycles_total: Any        # pio_orchestrator_cycles_total{outcome}
    phase_seconds: Any       # pio_orchestrator_phase_seconds{phase}
    phase_retries: Any       # pio_orchestrator_phase_retries_total{phase}
    triggers_total: Any      # pio_orchestrator_triggers_total{trigger}
    suppressed_total: Any    # pio_orchestrator_suppressed_total{reason}
    recovered_total: Any     # pio_orchestrator_recovered_total{action}
    failure_streak: Any      # pio_orchestrator_consecutive_failures


def orchestrator_metrics(registry: Optional[MetricsRegistry] = None
                         ) -> OrchestratorMetrics:
    reg = registry or default_registry()
    return OrchestratorMetrics(
        cycles_total=reg.counter(
            "pio_orchestrator_cycles_total",
            "Completed orchestrator cycles by outcome "
            "(promoted/rolled_back/failed)",
            labelnames=("outcome",)),
        phase_seconds=reg.histogram(
            "pio_orchestrator_phase_seconds",
            "Wall time of each orchestrator phase "
            "(train/eval/smoke/canary/promote), retries included",
            labelnames=("phase",)),
        phase_retries=reg.counter(
            "pio_orchestrator_phase_retries_total",
            "Phase attempts retried after a transient failure or timeout",
            labelnames=("phase",)),
        triggers_total=reg.counter(
            "pio_orchestrator_triggers_total",
            "Cycles started, by the data-driven trigger that fired "
            "(ingest_volume/foldin_pressure/slo_burn/manual)",
            labelnames=("trigger",)),
        suppressed_total=reg.counter(
            "pio_orchestrator_suppressed_total",
            "Trigger firings suppressed by the cooldown / failure-backoff "
            "window (flap suppression)",
            labelnames=("reason",)),
        recovered_total=reg.counter(
            "pio_orchestrator_recovered_total",
            "Crash-recovery actions on restart "
            "(resumed/unwound/converged)",
            labelnames=("action",)),
        failure_streak=reg.gauge(
            "pio_orchestrator_consecutive_failures",
            "Consecutive failed cycles feeding the jittered cycle "
            "backoff (0 after a promote)"),
    )
