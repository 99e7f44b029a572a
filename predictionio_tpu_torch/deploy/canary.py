"""Staged rollout: deterministic traffic splitting and the SLO-guarded
judge (port of the reference's ``deploy/canary.py``).

A canary deploy routes a configured fraction of live queries to the
candidate release while the incumbent serves the rest; a shadow deploy
routes nothing user-visible to the candidate but mirrors queries into
it and discards the results. Either way the judge compares the
candidate's sliding-window p99 latency and error rate against the
incumbent's after every observation (``obs/slo.judge_relative``):

  * ``rollback`` — the candidate breached a guard (its error rate above
    the incumbent's by more than ``error_rate_slack``, or its p99 above
    ``p99_ratio`` x the incumbent's p99 + ``latency_slack_s``);
  * ``promote`` — the candidate absorbed ``promote_after`` samples
    without a breach;
  * ``None`` — keep judging.

The splitter is error diffusion, not a random draw: an accumulator gains
``fraction`` per query and routes to the canary each time it crosses 1,
so over any N queries exactly ``round(N * fraction)`` (±1) go to the
canary. Windows are bounded by sample count, so an early latency spike
ages out.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from predictionio_tpu_torch.obs.slo import SlidingStats, judge_relative

__all__ = ["CanaryConfig", "CanaryController", "SlidingStats",
           "TrafficSplitter", "ROLE_INCUMBENT", "ROLE_CANARY",
           "ROLE_SHADOW"]

#: the roles a query can be scored under
ROLE_INCUMBENT = "incumbent"
ROLE_CANARY = "canary"
ROLE_SHADOW = "shadow"


@dataclasses.dataclass
class CanaryConfig:
    """Knobs of one staged rollout (defaults from
    ``utils.server_config.DeployConfig``; a ``POST /deploy.json`` body
    overrides any of them)."""

    fraction: float = 0.1           # share of live traffic to the canary
    shadow: bool = False            # score and discard instead of serving
    window: int = 200               # sliding per-arm sample window
    min_samples: int = 20           # per arm before any judgment
    promote_after: int = 100        # breach-free canary samples to promote
    p99_ratio: float = 2.0          # canary p99 <= incumbent p99 * ratio
    latency_slack_s: float = 0.025  # ... + this absolute slack
    error_rate_slack: float = 0.05  # canary err <= incumbent err + slack

    #: the incumbent must keep enough traffic to fill its window, so the
    #: fraction clamps here (all of it is a plain deploy, not a canary)
    MAX_FRACTION = 0.9

    def normalized(self) -> "CanaryConfig":
        out = dataclasses.replace(self)
        out.fraction = min(max(float(out.fraction), 0.0),
                           self.MAX_FRACTION)
        out.window = max(1, int(out.window))
        out.min_samples = max(1, min(int(out.min_samples), out.window))
        out.promote_after = max(out.min_samples, int(out.promote_after))
        return out


class TrafficSplitter:
    """Deterministic error-diffusion split: over any N queries exactly
    ``round(N * fraction)`` (±1) route to the canary."""

    def __init__(self, fraction: float):
        self.fraction = min(max(fraction, 0.0), 1.0)
        self._acc = 0.0

    def route(self) -> bool:
        """True: this query goes to the canary."""
        self._acc += self.fraction
        if self._acc >= 1.0:
            self._acc -= 1.0
            return True
        return False

    def state(self) -> float:
        """The diffusion accumulator, to persist across a restart."""
        return self._acc

    def restore(self, acc) -> None:
        """Re-seed the accumulator from a persisted :meth:`state`; junk
        (None, NaN, out of range) is ignored."""
        try:
            acc = float(acc)
        except (TypeError, ValueError):
            return
        if 0.0 <= acc < 1.0:
            self._acc = acc


class CanaryController:
    """The SLO judge of one candidate release: fed every query's outcome
    by the server, it returns a ``(verdict, reason)`` pair once, and is
    ``decided`` and inert after that."""

    def __init__(self, config: CanaryConfig):
        self.config = config.normalized()
        self.splitter = TrafficSplitter(
            0.0 if self.config.shadow else self.config.fraction)
        self.incumbent = SlidingStats(self.config.window)
        self.canary = SlidingStats(self.config.window)
        self.decided: Optional[Tuple[str, str]] = None

    def observe(self, role: str, seconds: float, ok: bool
                ) -> Optional[Tuple[str, str]]:
        """Record one query outcome; the verdict the first time one is
        reached, else None."""
        if role == ROLE_INCUMBENT:
            self.incumbent.observe(seconds, ok)
        else:                      # canary and shadow judge alike
            self.canary.observe(seconds, ok)
        if self.decided is not None:
            return None
        verdict = self._judge()
        if verdict is not None:
            self.decided = verdict
        return verdict

    def _judge(self) -> Optional[Tuple[str, str]]:
        cfg = self.config
        return judge_relative(
            self.incumbent, self.canary,
            min_samples=cfg.min_samples,
            error_rate_slack=cfg.error_rate_slack,
            p99_ratio=cfg.p99_ratio,
            latency_slack_s=cfg.latency_slack_s,
            promote_after=cfg.promote_after)

    def to_dict(self) -> dict:
        return {
            "fraction": self.splitter.fraction,
            "shadow": self.config.shadow,
            "decided": list(self.decided) if self.decided else None,
            "incumbent": self.incumbent.to_dict(),
            "canary": self.canary.to_dict(),
            "promoteAfter": self.config.promote_after,
            "minSamples": self.config.min_samples,
        }
