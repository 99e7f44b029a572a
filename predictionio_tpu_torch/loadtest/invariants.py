"""The runtime invariant engine (port of the reference's
``loadtest/invariants.py``): `pio check`-era guarantees asserted as
live facts during a storm.

`pio check` (analysis/) proves the invariants STATICALLY — ledgered
jits, atomic writes, knob ownership. This module asserts the dynamic
counterparts while the fleet is actually under fire:

* **no dropped acks** — every offered ingest item resolved (acked or
  explicitly failed); offered − acked − failed == 0 and no timeout.
* **no dropped queries** — same for the query lane through the router.
* **exactly-once ingest** — the post-run identity audit
  (storage/audit.py) against the emitter's acked-id ledger.
* **registry converges** — exactly one LIVE release once the storm
  (and any mid-storm promote) settles.
* **retrain promoted** — the orchestrator completed a full
  retrain-and-promote cycle MID-RUN (outcome ``promoted``).
* **latency bounds** — ack p99 / query p99 under scenario bounds.
* **freshness** — fold-in applied rows during the storm and the
  event→applied p95 under its bound (the Lambda loop's freshness SLO
  holding while everything else was happening).

Each verdict increments ``pio_loadtest_invariant_checks_total`` and a
violation records a ``loadtest_invariant_violated`` flight-recorder
event, so a failing storm leaves a trace, not just an exit code.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from predictionio_tpu_torch.obs.loadtest_stats import loadtest_invariant_checks

__all__ = ["InvariantResult", "InvariantEngine"]


@dataclasses.dataclass
class InvariantResult:
    name: str
    ok: bool
    detail: str = ""

    def as_dict(self) -> dict:
        return {"name": self.name, "ok": self.ok, "detail": self.detail}


class InvariantEngine:
    """Collects named verdicts; ``ok`` only when every one held."""

    def __init__(self, registry=None):
        self.results: List[InvariantResult] = []
        self._metric = loadtest_invariant_checks(registry)

    def check(self, name: str, ok: bool, detail: str = "") -> bool:
        self.results.append(InvariantResult(name, bool(ok), detail))
        self._metric.inc(invariant=name,
                         outcome="ok" if ok else "violated")
        if not ok:
            from predictionio_tpu_torch.obs.trace_context import record_event

            record_event("loadtest_invariant_violated",
                         {"invariant": name, "detail": detail})
        return bool(ok)

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    def failures(self) -> List[InvariantResult]:
        return [r for r in self.results if not r.ok]

    def report(self) -> List[dict]:
        return [r.as_dict() for r in self.results]

    # -- the standard storm checks ------------------------------------------
    def check_open_loop(self, name: str, result) -> bool:
        """No dropped acks/queries for one lane's OpenLoopResult."""
        return self.check(
            name,
            result.dropped == 0 and not result.timed_out,
            f"offered={result.offered} acked={result.acked} "
            f"failed={result.failed} dropped={result.dropped} "
            f"timed_out={result.timed_out}")

    def check_exactly_once(self, audit_report) -> bool:
        return self.check("exactly_once_ingest", audit_report.ok,
                          audit_report.summary())

    def check_registry_converged(self, releases) -> bool:
        """Exactly one LIVE release in the lineage after the dust
        settles — the orchestrator/canary safety invariant."""
        live = [r for r in releases.get_all() if r.status == "LIVE"]
        return self.check(
            "registry_one_live", len(live) == 1,
            f"LIVE releases: {[f'v{r.version}' for r in live]}")

    def check_retrain_promoted(self, cycles: List) -> bool:
        promoted = [c for c in cycles
                    if getattr(c, "outcome", None) == "promoted"]
        outcomes = [getattr(c, "outcome", None) for c in cycles]
        return self.check(
            "retrain_promoted_mid_run", len(promoted) >= 1,
            f"cycles={len(cycles)} outcomes={outcomes}")

    def check_latency(self, name: str, p99_ms: float,
                      bound_ms: float) -> bool:
        return self.check(name, p99_ms <= bound_ms,
                          f"p99 {p99_ms:.1f}ms vs bound {bound_ms:.0f}ms")

    def check_freshness(self, applied_rows: int,
                        event_to_applied_p95_s: Optional[float],
                        bound_s: float) -> bool:
        """Fold-in kept up: rows actually folded during the storm, and
        (when the histogram saw samples) event→applied p95 under the
        bound."""
        ok = applied_rows > 0 and (
            event_to_applied_p95_s is None
            or event_to_applied_p95_s <= bound_s)
        lat = ("n/a" if event_to_applied_p95_s is None
               else f"{event_to_applied_p95_s:.2f}s")
        return self.check(
            "freshness_foldin", ok,
            f"applied_rows={applied_rows} event_to_applied_p95={lat} "
            f"bound={bound_s:g}s")
