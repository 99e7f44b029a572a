"""SLO engine: declarative objectives + multi-window burn rates.

The reference's ``obs/slo.py``. The canary controller's judgment
(candidate vs incumbent p99/error-rate over a sliding sample window)
and the per-release latency/error/freshness objectives live here as one
reusable substrate:

* :class:`SlidingStats` + :func:`judge_relative` — the canary
  controller's sample-window comparison (deploy/canary.py delegates to
  these).

* :class:`SLOSpec` / :class:`SLOEngine` — declarative absolute
  objectives (``server.json "slo"``) evaluated as error-budget BURN
  RATES over multiple trailing windows, the SRE-workbook shape: burn
  rate = (observed bad fraction / budget); an objective is breached
  when EVERY configured window is burning past its threshold (the
  multi-window AND keeps one latency spike from paging while a
  sustained burn flips within one evaluation window). Sources are the
  registry's own cumulative metrics — latency from the
  ``pio_query_duration_seconds`` histogram (bad = observations above
  the threshold bucket), errors from ``pio_query_failures_total`` vs
  served queries, freshness from
  ``pio_foldin_event_to_applied_seconds`` — sampled into a bounded ring
  so windowed deltas need no external storage.

The engine publishes ``pio_slo_burn_rate{objective,window}`` and
``pio_slo_breached{objective}`` gauges plus a
``pio_slo_breach_total{objective}`` transition counter, records an
``slo_breach`` lifecycle event in the flight recorder, and renders the
``/slo.json`` document the query server serves. The canary controller
and fold-in's gating consume the same evaluation.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from predictionio_tpu_torch.obs.registry import Histogram, MetricsRegistry
from predictionio_tpu_torch.obs.trace_context import record_event, recorder

logger = logging.getLogger("pio.slo")

#: env kill-switch: PIO_SLO=0 disables the engine regardless of config
SLO_ENV = "PIO_SLO"


# ---------------------------------------------------------------------------
# the sliding-window relative judgment (the canary controller's core)
# ---------------------------------------------------------------------------

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
            # failed queries have no meaningful serving latency; they
            # count against the error SLO instead
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
    """The candidate-vs-incumbent SLO judgment (one verdict or None).

    Extracted from the canary controller with NO behavior change: same
    ordering (errors judged before latency), same thresholds, same
    verdict strings — the canary's existing test scenarios lock this."""
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


# ---------------------------------------------------------------------------
# declarative objectives + burn-rate evaluation
# ---------------------------------------------------------------------------

#: objective kinds and the registry metric each reads
KIND_LATENCY = "latency"        # pio_query_duration_seconds above threshold
KIND_ERRORS = "errors"          # pio_query_failures_total vs served queries
KIND_FRESHNESS = "freshness"    # pio_foldin_event_to_applied_seconds

#: the SRE-workbook default: a fast-burn window and a slow-burn window
DEFAULT_WINDOWS = ((300.0, 14.4), (3600.0, 6.0))


@dataclasses.dataclass
class SLOWindow:
    seconds: float
    burn_threshold: float

    def label(self) -> str:
        return f"{int(self.seconds)}s"


@dataclasses.dataclass
class SLOObjective:
    name: str
    kind: str                       # latency | errors | freshness
    threshold_s: Optional[float] = None   # latency/freshness bound
    budget: float = 0.01            # allowed bad fraction

    def __post_init__(self):
        if self.kind not in (KIND_LATENCY, KIND_ERRORS, KIND_FRESHNESS):
            raise ValueError(
                f"slo objective {self.name!r}: unknown kind {self.kind!r} "
                f"(expected latency/errors/freshness)")
        if self.kind in (KIND_LATENCY, KIND_FRESHNESS) \
                and not self.threshold_s:
            raise ValueError(
                f"slo objective {self.name!r}: kind {self.kind} needs "
                f"thresholdS")
        if not 0.0 < self.budget <= 1.0:
            raise ValueError(
                f"slo objective {self.name!r}: budget must be in (0, 1]")


@dataclasses.dataclass
class SLOSpec:
    objectives: List[SLOObjective]
    windows: List[SLOWindow]
    eval_interval_s: float = 5.0

    @classmethod
    def from_dict(cls, data: Optional[dict]) -> Optional["SLOSpec"]:
        """Parse a ``server.json "slo"`` section; None/no-objectives means
        the engine stays off. Malformed objectives raise — an operator's
        explicit SLO config failing silently would be worse than a loud
        boot error."""
        if not data:
            return None
        objectives = [
            SLOObjective(
                name=str(o.get("name") or o.get("kind") or "slo"),
                kind=str(o.get("kind", KIND_LATENCY)),
                threshold_s=(float(o["thresholdS"])
                             if o.get("thresholdS") is not None else None),
                budget=float(o.get("budget", 0.01)))
            for o in data.get("objectives", ())]
        if not objectives:
            return None
        windows = [SLOWindow(float(w["seconds"]),
                             float(w.get("burnThreshold", 1.0)))
                   for w in data.get("windows", ())]
        if not windows:
            windows = [SLOWindow(s, t) for s, t in DEFAULT_WINDOWS]
        interval = float(data.get("evalIntervalS", 5.0))
        return cls(objectives=objectives, windows=windows,
                   eval_interval_s=max(0.05, interval))


def slo_enabled() -> bool:
    return os.environ.get(SLO_ENV, "1").strip().lower() not in (
        "0", "false", "no", "off")


def slo_spec_from_server_json() -> Optional[SLOSpec]:
    """The host's SLO spec (server.json ``slo`` section), or None."""
    if not slo_enabled():
        return None
    from predictionio_tpu_torch.utils.server_config import read_server_json

    try:
        return SLOSpec.from_dict(read_server_json().get("slo"))
    except (ValueError, TypeError) as e:
        logger.warning("ignoring malformed slo section: %s", e)
        return None


class SLOEngine:
    """Evaluates an :class:`SLOSpec` against a registry's cumulative
    metrics by sampling (bad, total) pairs into a bounded ring and
    computing windowed deltas.

    ``sources`` maps objective kind -> ``fn(objective) -> (bad, total)``
    cumulative pair; the defaults read the registry metrics named above
    (tests inject synthetic sources). Thread-safe enough for its use:
    tick() runs on one evaluator at a time (the server loop or an
    on-demand /slo.json read — both on the event loop)."""

    def __init__(self, registry: MetricsRegistry, spec: SLOSpec,
                 sources: Optional[Dict[str, Callable]] = None):
        self.registry = registry
        self.spec = spec
        self._sources = sources or {}
        max_window = max(w.seconds for w in spec.windows)
        ring_len = min(4096, max(8, int(max_window
                                        / spec.eval_interval_s) + 2))
        #: per-objective ring of (ts, bad, total) cumulative samples
        self._rings: Dict[str, Deque[Tuple[float, float, float]]] = {
            o.name: deque(maxlen=ring_len) for o in spec.objectives}
        self._breached: Dict[str, bool] = {o.name: False
                                           for o in spec.objectives}
        #: per-objective (bad, total) offsets added to the LIVE
        #: cumulative reads after a rehydrate: the registry re-zeroed at
        #: restart, but the ring's history is on the pre-restart scale —
        #: the offsets splice the two into one monotone series
        self._base: Dict[str, Tuple[float, float]] = {}
        self._last_status: Optional[dict] = None
        self._burn_gauge = registry.gauge(
            "pio_slo_burn_rate",
            "Error-budget burn rate per objective and trailing window "
            "(1.0 = burning exactly the budget)",
            labelnames=("objective", "window"))
        self._breached_gauge = registry.gauge(
            "pio_slo_breached",
            "1 while every configured window of the objective burns past "
            "its threshold", labelnames=("objective",))
        self._breach_total = registry.counter(
            "pio_slo_breach_total",
            "Objective transitions into the breached state",
            labelnames=("objective",))

    # -- cumulative sources --------------------------------------------------
    def _cumulative(self, obj: SLOObjective) -> Tuple[float, float]:
        bad, total = self._cumulative_raw(obj)
        base = self._base.get(obj.name)
        if base is not None:
            bad += base[0]
            total += base[1]
        return bad, total

    def _cumulative_raw(self, obj: SLOObjective) -> Tuple[float, float]:
        fn = self._sources.get(obj.kind)
        if fn is not None:
            return fn(obj)
        if obj.kind == KIND_LATENCY:
            return self._hist_above("pio_query_duration_seconds",
                                    obj.threshold_s)
        if obj.kind == KIND_FRESHNESS:
            return self._hist_above("pio_foldin_event_to_applied_seconds",
                                    obj.threshold_s)
        # errors: failed queries vs (served + failed)
        failures = self.registry.get("pio_query_failures_total")
        bad = (sum(v for _, v in failures.samples())
               if failures is not None else 0.0)
        served = self.registry.get("pio_query_duration_seconds")
        good = (served.total_count()
                if isinstance(served, Histogram) else 0.0)
        return bad, bad + good

    def _hist_above(self, name: str, threshold: float
                    ) -> Tuple[float, float]:
        hist = self.registry.get(name)
        if not isinstance(hist, Histogram):
            return 0.0, 0.0
        total = hist.total_count()
        return total - hist.count_below(threshold), total

    # -- evaluation ----------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> dict:
        """One evaluation: sample every objective, compute windowed burn
        rates, update gauges/counters, record breach transitions. Returns
        the /slo.json document."""
        now = time.monotonic() if now is None else now
        objectives = []
        for obj in self.spec.objectives:
            bad, total = self._cumulative(obj)
            ring = self._rings[obj.name]
            # the ring is sized for eval_interval spacing, but tick()
            # also fires per /slo.json read — a fast poller must not
            # erode the slow-burn window's history, so sub-interval
            # samples REPLACE the newest entry instead of appending.
            # Never replace the ONLY sample: it is the window baseline,
            # and collapsing it into "now" would zero every delta (a
            # burst faster than half an interval would become invisible)
            if len(ring) >= 2 and \
                    now - ring[-1][0] < 0.5 * self.spec.eval_interval_s:
                ring[-1] = (now, bad, total)
            else:
                ring.append((now, bad, total))
            windows = []
            burning = []
            for w in self.spec.windows:
                burn, d_bad, d_total = self._burn(ring, now, w.seconds,
                                                  obj.budget)
                self._burn_gauge.set(burn, objective=obj.name,
                                     window=w.label())
                windows.append({
                    "seconds": w.seconds, "burnThreshold": w.burn_threshold,
                    "burn": round(burn, 4), "bad": d_bad, "total": d_total})
                burning.append(d_total > 0 and burn >= w.burn_threshold)
            breached = bool(burning) and all(burning)
            was = self._breached[obj.name]
            self._breached[obj.name] = breached
            self._breached_gauge.set(1.0 if breached else 0.0,
                                     objective=obj.name)
            if breached and not was:
                self._breach_total.inc(objective=obj.name)
                detail = {"objective": obj.name, "objectiveKind": obj.kind,
                          "windows": windows}
                exemplars = self._breach_exemplars(obj)
                if exemplars:
                    # evidence, not summary: the actual trace ids that
                    # burned the budget, pinned so they outlive the ring
                    detail["exemplars"] = exemplars
                record_event("slo_breach", detail)
                logger.warning("SLO breach: %s (%s) %s exemplars=%s",
                               obj.name, obj.kind, windows, exemplars)
            objectives.append({
                "name": obj.name, "kind": obj.kind,
                "thresholdS": obj.threshold_s, "budget": obj.budget,
                "breached": breached,
                "window": self._window_state(ring),
                "windows": windows})
        status = {
            "breached": any(o["breached"] for o in objectives),
            #: amnesia honesty: a freshly (re)started engine whose ring
            #: does not yet span the longest configured window reports
            #: cold — an empty/healthy evaluation with no history behind
            #: it must not be mistaken for health. Rehydration from the
            #: telemetry store (obs/tsdb.py) flips it warm immediately.
            "cold": any(o["window"] == "cold" for o in objectives),
            "objectives": objectives,
            "evalIntervalS": self.spec.eval_interval_s,
        }
        self._last_status = status
        return status

    #: exemplar trace ids one breach event carries (and pins)
    BREACH_EXEMPLARS = 3

    def _breach_exemplars(self, obj: SLOObjective) -> List[str]:
        """Culprit trace ids for a latency/freshness breach: the newest
        histogram exemplars above the objective's threshold, from the
        same metric the burn rate integrates over. Each id is pinned in
        the flight recorder so the p99 culprit is still resolvable via
        ``pio traces --trace-id`` long after the 256-entry ring has
        rolled past it. Errors objectives carry none — failure traces
        are already first-class flight-recorder records."""
        if obj.kind == KIND_ERRORS or not obj.threshold_s:
            return []
        metric = LATENCY_METRIC if obj.kind == KIND_LATENCY \
            else FRESHNESS_METRIC
        hist = self.registry.get(metric)
        if not isinstance(hist, Histogram):
            return []
        try:
            above = hist.exemplars_above(obj.threshold_s)
        except Exception:
            return []
        ids: List[str] = []
        for tid, _value, _ts in above:
            if tid not in ids:
                ids.append(tid)
            if len(ids) >= self.BREACH_EXEMPLARS:
                break
        try:
            rec = recorder()
            for tid in ids:
                rec.pin(tid)
        except Exception:
            logger.exception("pinning breach exemplar traces failed")
        return ids

    def _window_state(self, ring) -> str:
        """``warm`` once the ring's covered timespan reaches the longest
        configured window (rehydration gets there instantly; a cold
        start earns it by uptime), else ``cold``."""
        if len(ring) < 2:
            return "cold"
        covered = ring[-1][0] - ring[0][0]
        need = max(w.seconds for w in self.spec.windows) \
            - 2.0 * self.spec.eval_interval_s
        return "warm" if covered >= need else "cold"

    def _burn(self, ring, now: float, window_s: float, budget: float
              ) -> Tuple[float, float, float]:
        """Burn rate over the trailing window: delta(bad)/delta(total)
        divided by the budget. Baseline = the newest sample at/before the
        window start, else the oldest available (a young engine burns
        over the data it has, so a sustained breach flips within one
        evaluation window of the engine starting)."""
        baseline = ring[0]
        start = now - window_s
        for entry in ring:
            if entry[0] <= start:
                baseline = entry
            else:
                break
        _, bad0, total0 = baseline
        _, bad1, total1 = ring[-1]
        d_bad = max(0.0, bad1 - bad0)
        d_total = max(0.0, total1 - total0)
        if d_total <= 0:
            return 0.0, d_bad, d_total
        return (d_bad / d_total) / budget, d_bad, d_total

    def status(self) -> dict:
        """The most recent evaluation (ticking first when none ran)."""
        if self._last_status is None:
            return self.tick()
        return self._last_status

    def breached(self, exclude_kinds: Tuple[str, ...] = ()) -> bool:
        """Any objective currently breached (fold-in gating and — next —
        admission control read this). ``exclude_kinds`` drops objectives
        whose breach must not gate the caller — fold-in excludes
        ``freshness``, because deferring applies is exactly what would
        make a freshness breach WORSE."""
        kinds = {o.name: o.kind for o in self.spec.objectives}
        return any(v and kinds.get(name) not in exclude_kinds
                   for name, v in self._breached.items())

    # -- restart-surviving budgets (the durable-telemetry splice) ------------
    def rehydrate(self, reader, now: Optional[float] = None,
                  wall_now: Optional[float] = None) -> int:
        """Reload the burn-rate rings from the persisted history
        (obs/tsdb.py via obs/telemetry.py), so error budgets survive a
        restart: a breach in progress stays breached across a crash
        loop instead of resetting to amnesia-health.

        Historical wall timestamps are mapped onto the engine's
        monotonic timescale, and the last historical cumulative value
        per objective becomes the base offset added to every LIVE read
        (the restarted registry counts from zero again). Ends with one
        tick, so ``breached()`` and ``/slo.json`` reflect the restored
        state immediately. Returns the number of ring samples restored."""
        now = time.monotonic() if now is None else now
        wall_now = time.time() if wall_now is None else wall_now
        max_window = max(w.seconds for w in self.spec.windows)
        since_ms = int((wall_now - 1.5 * max_window) * 1000)
        restored = 0
        for obj in self.spec.objectives:
            try:
                pairs = history_cumulative_pairs(reader, obj, since_ms)
            except Exception:
                logger.exception("slo rehydrate failed for %s", obj.name)
                continue
            if not pairs:
                continue
            ring = self._rings[obj.name]
            for ts_ms, bad, total in pairs:
                ring.append((now - (wall_now - ts_ms / 1000.0),
                             bad, total))
                restored += 1
            self._base[obj.name] = (pairs[-1][1], pairs[-1][2])
        if restored:
            self.tick(now=now)
            logger.info("SLO rings rehydrated: %d sample(s) across %d "
                        "objective(s)%s", restored,
                        len(self.spec.objectives),
                        " — breach restored" if self.breached() else "")
        return restored


#: the registry metrics each objective kind integrates over (shared by
#: the live engine and the history rehydration path)
LATENCY_METRIC = "pio_query_duration_seconds"
ERRORS_METRIC = "pio_query_failures_total"
FRESHNESS_METRIC = "pio_foldin_event_to_applied_seconds"


def _carry(points: list, t: float) -> float:
    """Newest scalar cumulative at/before t (0.0 before the first)."""
    value = 0.0
    for ts, v in points:
        if ts > t:
            break
        value = v
    return value


def history_cumulative_pairs(reader, obj: SLOObjective,
                             since_ms: int) -> list:
    """The objective's ``(ts_ms, bad, total)`` cumulative pairs as the
    persisted history recorded them — reset-adjusted by the reader, so
    one series spans any number of process lifetimes (the same math
    :meth:`SLOEngine._cumulative_raw` does against the live registry)."""
    import bisect

    if obj.kind == KIND_ERRORS:
        _, fails = reader.cumulative_series(ERRORS_METRIC,
                                            since_ms=since_ms)
        _, served = reader.cumulative_series(LATENCY_METRIC,
                                             since_ms=since_ms)
        stamps = sorted({p[0] for p in fails}
                        | {p[0] for p in served})
        out = []
        for t in stamps:
            bad = _carry(fails, t)
            good = 0.0
            for ts, counts, _sum in served:
                if ts > t:
                    break
                good = sum(counts)
            out.append((t, bad, bad + good))
        return out
    metric = LATENCY_METRIC if obj.kind == KIND_LATENCY \
        else FRESHNESS_METRIC
    buckets, points = reader.cumulative_series(metric, since_ms=since_ms)
    if not buckets:
        return []
    idx = bisect.bisect_left(list(buckets), obj.threshold_s)
    out = []
    for ts, counts, _sum in points:
        total = sum(counts)
        below = sum(counts[:idx + 1])
        out.append((ts, total - below, total))
    return out
