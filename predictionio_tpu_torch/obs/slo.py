"""The canary's sliding-window SLO judgment (port of the reference's
``obs/slo.py``: :class:`SlidingStats` and :func:`judge_relative` only).

:class:`SlidingStats` keeps one serving arm's last ``window`` outcomes
(latency of the successful ones, and whether each failed);
:func:`judge_relative` compares a candidate arm against the incumbent:
errors first, then p99 latency, then the promote count. The canary
controller (``deploy/canary``) delegates to it. The reference's
burn-rate engine (``SLOSpec``/``SLOEngine``) is not ported yet.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Deque, Optional, Tuple


class SlidingStats:
    """Bounded latency/error window for one serving arm."""

    def __init__(self, window: int):
        self._lat: Deque[float] = deque(maxlen=max(1, window))
        self._err: Deque[bool] = deque(maxlen=max(1, window))
        self.total = 0

    def observe(self, seconds: float, ok: bool) -> None:
        self.total += 1
        self._err.append(not ok)
        if ok:
            # a failed query has no serving latency; it counts against
            # the error SLO instead
            self._lat.append(seconds)

    def count(self) -> int:
        return len(self._err)

    def error_rate(self) -> float:
        if not self._err:
            return 0.0
        return sum(self._err) / len(self._err)

    def p99(self) -> float:
        return self.quantile(0.99)

    def quantile(self, q: float) -> float:
        if not self._lat:
            return 0.0
        ordered = sorted(self._lat)
        rank = min(len(ordered) - 1,
                   max(0, math.ceil(q * len(ordered)) - 1))
        return ordered[rank]

    def to_dict(self) -> dict:
        return {"samples": self.count(), "total": self.total,
                "errorRate": round(self.error_rate(), 4),
                "p50Sec": round(self.quantile(0.50), 6),
                "p99Sec": round(self.p99(), 6)}


def judge_relative(incumbent: SlidingStats, candidate: SlidingStats, *,
                   min_samples: int, error_rate_slack: float,
                   p99_ratio: float, latency_slack_s: float,
                   promote_after: int) -> Optional[Tuple[str, str]]:
    """The candidate-vs-incumbent SLO judgment: ``("rollback",
    reason)``, ``("promote", reason)`` or None (keep judging). Errors are
    judged before latency; the reason's slug before the colon
    (``slo_errors``, ``slo_latency``, ``healthy``) names the rule."""
    if candidate.count() < min_samples or incumbent.count() < min_samples:
        return None
    can_err, inc_err = candidate.error_rate(), incumbent.error_rate()
    if can_err > inc_err + error_rate_slack:
        return ("rollback",
                f"slo_errors: canary {can_err:.3f} > incumbent "
                f"{inc_err:.3f} + {error_rate_slack}")
    can_p99, inc_p99 = candidate.p99(), incumbent.p99()
    if can_p99 > inc_p99 * p99_ratio + latency_slack_s:
        return ("rollback",
                f"slo_latency: canary p99 {can_p99 * 1e3:.1f}ms > "
                f"incumbent p99 {inc_p99 * 1e3:.1f}ms x {p99_ratio} "
                f"+ {latency_slack_s * 1e3:.0f}ms")
    if candidate.total >= promote_after:
        return ("promote", "healthy: SLO window clean")
    return None
