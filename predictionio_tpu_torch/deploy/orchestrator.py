"""Continuous-training orchestrator: the crash-safe closed Lambda loop
(port of the reference's ``deploy/orchestrator.py``; its cycle and
trigger documents are the reference's, readable by either package).

A recurring pipeline that runs

    trigger → train → eval-gate → batchpredict smoke →
    SLO-judged canary → promote

entirely over the release registry, with online fold-in (deploy/
foldin.py) as the light path between full retrains — the
heavy-offline/light-online split of parallel-and-stream learning
(arXiv:2111.00032), run the ALX way (arXiv:2112.02194): retraining as
an always-on pipeline whose failures heal themselves, not an event an
operator fires.

**Durability.** The cycle is a phase state machine persisted as a
*cycle document* (one JSON file, temp-write + ``os.replace`` commit)
in ``state_dir``. Every phase transition is committed BEFORE its side
effects are observed: entering a phase commits ``{phase, status:
running}``, finishing it commits
``{status: done}``. A kill anywhere (storage/faults kill points sit at
every boundary: ``orch:<phase>:enter|done|committed``, plus the
registry-write points ``releases:set-status:*``) leaves a document
from which :meth:`Orchestrator.recover` converges:

* a half-done phase is **completed or unwound, never repeated
  destructively** — the train phase adopts the cycle's COMPLETED
  instance instead of retraining (instances and releases carry the
  cycle id in ``batch``, the idempotency key), eval unwinds its
  partial instances and re-runs, a crashed canary rolls back, a
  committed promote intent is driven to completion (``set_status`` is
  idempotent per status, so "promote again" can never record a second
  promote);
* :meth:`Orchestrator.converge_registry` then heals global invariants:
  at most one LIVE release per variant, no orphaned CANARY rows, no
  ghost manifests pointing at undeployable instances, and the
  pre-cycle LIVE (the resident standby) restored whenever a cycle died
  before its promote committed — serving never regresses below the
  pre-cycle answers.

**Triggers are data-driven, not cron**: fresh ingest volume since the
last cycle's watermark (cheap snapshot-digest drift check first, then
a bounded count), fold-in pending-queue pressure, and a burning
serving SLO (obs/slo.py). A cooldown window plus a jittered
exponential failure backoff (utils/retry) means a flapping trigger or
a persistently failing cycle backs off instead of thrashing retrains.

Every phase runs under a timeout with bounded retries and
full-jitter backoff; the whole cycle runs under ONE trace id
(``pio traces`` / the flight recorder shows trigger → train → eval →
smoke → canary → promote as one lineage).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import itertools
import json
import logging
import os
import random
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from predictionio_tpu_torch.data.event import UTC
from predictionio_tpu_torch.obs.orch_stats import orchestrator_metrics
from predictionio_tpu_torch.obs.trace_context import TraceContext, record_event
from predictionio_tpu_torch.obs.tracing import carried
from predictionio_tpu_torch.storage.base import Release, generate_id
from predictionio_tpu_torch.storage.faults import CrashError, maybe_kill
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.retry import RetryPolicy, retry_call
from predictionio_tpu_torch.utils.server_config import OrchestratorConfig

logger = logging.getLogger("pio.orchestrator")

#: the phases of one cycle, in execution order (trigger evaluation
#: happens before a cycle document exists)
PHASES = ("train", "eval", "smoke", "canary", "promote")

#: terminal cycle outcomes: ``promoted``, ``rolled_back`` (a gate or
#: canary verdict said NO), ``failed`` (a phase exhausted its retries)
OUTCOMES = ("promoted", "rolled_back", "failed")

#: CycleDoc fields a phase body may produce — merged back from the
#: attempt's working copy ONLY on success, so an abandoned (timed-out)
#: attempt finishing late can never mutate the live document
PHASE_OUTPUT_FIELDS = (
    "train_instance_id", "candidate_release_id",
    "candidate_release_version", "eval_score", "smoke",
    "canary_verdict", "canary_reason")


class OrchestratorError(Exception):
    """A phase failed in a way worth retrying (transient)."""


class CycleRollback(Exception):
    """A phase reached a terminal NO verdict (failed eval gate, smoke
    with no output, canary rollback): the cycle unwinds — candidate
    rolled back, standby stays live — without retrying the phase."""


class CycleFailed(Exception):
    """A phase exhausted its retries/timeouts: same unwind as a
    rollback, but the cycle is accounted ``failed`` (an infrastructure
    problem, not a quality verdict — operators alert on these
    differently)."""


# ---------------------------------------------------------------------------
# durable state: the cycle document + trigger state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CycleDoc:
    """One retrain cycle's durable record (the recovery source of
    truth). Committed crash-safe on every phase transition."""

    cycle_id: str
    trace: str = ""                 # encoded TraceContext of the cycle
    trigger: str = ""               # which trigger fired
    phase: str = ""                 # furthest phase entered
    phase_status: str = ""          # "running" | "done"
    attempts: Dict[str, int] = dataclasses.field(default_factory=dict)
    started_ms: int = 0
    updated_ms: int = 0
    trigger_digest: str = ""        # snapshot digest when triggered
    baseline_release_id: str = ""   # pre-cycle LIVE release (the standby)
    train_instance_id: str = ""
    candidate_release_id: str = ""
    candidate_release_version: int = 0
    eval_score: Optional[float] = None
    smoke: Optional[dict] = None
    canary_verdict: str = ""
    canary_reason: str = ""
    outcome: str = ""               # "" while active, else OUTCOMES
    reason: str = ""
    accounted: bool = False         # trigger-state bookkeeping committed

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, data: dict) -> "CycleDoc":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in fields})


@dataclasses.dataclass
class TriggerState:
    """Durable trigger bookkeeping between cycles."""

    watermark_ms: int = 0           # only events after this count as fresh
    last_digest: str = ""           # snapshot digest at the last cycle
    last_cycle_end_ms: int = 0
    next_earliest_ms: int = 0       # cooldown + failure backoff gate
    consecutive_failures: int = 0
    last_outcome: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, data: dict) -> "TriggerState":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in fields})


class CycleStore:
    """The orchestrator's durable file state under ``state_dir``:
    ``cycle.json`` (the active cycle document), ``trigger.json`` (the
    trigger state), and ``history/<cycle_id>.json`` (archived cycles).
    Every commit is temp-write + ``os.replace`` — a kill can leave the
    previous document or the new one, never a torn file."""

    def __init__(self, state_dir: str):
        self.state_dir = state_dir
        os.makedirs(os.path.join(state_dir, "history"), exist_ok=True)

    @property
    def cycle_path(self) -> str:
        return os.path.join(self.state_dir, "cycle.json")

    @property
    def trigger_path(self) -> str:
        return os.path.join(self.state_dir, "trigger.json")

    def _commit_json(self, path: str, doc: dict) -> None:
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _load_json(self, path: str) -> Optional[dict]:
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            # an unreadable document is treated as absent, loudly: the
            # commit discipline makes this unreachable short of disk
            # corruption, and refusing to start would be worse
            logger.error("unreadable orchestrator state %s: %s", path, e)
            return None

    def commit_cycle(self, doc: CycleDoc) -> None:
        self._commit_json(self.cycle_path, doc.to_json())

    def load_cycle(self) -> Optional[CycleDoc]:
        data = self._load_json(self.cycle_path)
        return CycleDoc.from_json(data) if data else None

    def archive_cycle(self, doc: CycleDoc) -> None:
        """Move a finished cycle out of the active slot. Ordered so a
        kill between the two steps leaves BOTH copies (recovery
        re-archives), never neither."""
        self._commit_json(
            os.path.join(self.state_dir, "history",
                         f"{doc.cycle_id}.json"), doc.to_json())
        try:
            os.unlink(self.cycle_path)
        except FileNotFoundError:
            pass

    def commit_trigger_state(self, state: TriggerState) -> None:
        self._commit_json(self.trigger_path, state.to_json())

    def load_trigger_state(self, now_ms: int) -> TriggerState:
        data = self._load_json(self.trigger_path)
        if data is not None:
            return TriggerState.from_json(data)
        # first run: only events from now on count as fresh — committed
        # immediately so a restart keeps the same watermark
        state = TriggerState(watermark_ms=now_ms)
        self.commit_trigger_state(state)
        return state


def default_state_dir() -> str:
    from predictionio_tpu_torch.utils.server_config import pio_home

    return os.path.join(pio_home(), "orchestrator")


# ---------------------------------------------------------------------------
# trigger arithmetic (pure: injected clocks/rng, no wall reads — tested
# as units)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TriggerSignals:
    """One observation of the data-driven trigger inputs."""

    digest: Optional[str] = None
    ingest_events: int = 0          # fresh events since the watermark
    foldin_pending: int = 0
    slo_breached: bool = False


def cycle_backoff_ms(cfg: OrchestratorConfig, failures: int,
                     rng: Optional[random.Random] = None) -> int:
    """Jittered exponential backoff after ``failures`` consecutive
    failed cycles. EQUAL jitter (uniform in [ceiling/2, ceiling])
    rather than the phase-retry full jitter: a failing cycle must be
    guaranteed a breathing floor — full jitter could draw ~0 and
    hot-loop the very retrain that keeps failing."""
    if failures <= 0:
        return 0
    ceiling = min(cfg.cycle_backoff_cap_s,
                  cfg.cycle_backoff_s * (2.0 ** (failures - 1)))
    return int(1000 * (rng or random).uniform(ceiling / 2.0, ceiling))


def next_earliest_ms(cfg: OrchestratorConfig, end_ms: int, failures: int,
                     rng: Optional[random.Random] = None) -> int:
    """When the next trigger may fire: cycle end + cooldown, plus the
    failure backoff when the cycle failed."""
    return int(end_ms + cfg.cooldown_s * 1000
               + cycle_backoff_ms(cfg, failures, rng))


def evaluate_triggers(cfg: OrchestratorConfig, state: TriggerState,
                      signals: TriggerSignals, now_ms: int
                      ) -> Tuple[Optional[str], Optional[str]]:
    """One trigger decision: ``(fired_reason, suppressed_reason)``.

    At most one is non-None. Priority: a burning SLO outranks fold-in
    pressure outranks ingest volume (urgency order). A condition that
    holds while the cooldown/backoff window is open is *suppressed*
    (returned so the caller can count it) — this is the
    flap-suppression contract: however fast a trigger condition
    oscillates, cycles start no faster than the cooldown allows, and a
    failing cycle's backoff stretches that window further."""
    fired = None
    if cfg.slo_trigger and signals.slo_breached:
        fired = "slo_burn"
    elif cfg.foldin_pending_max > 0 \
            and signals.foldin_pending >= cfg.foldin_pending_max:
        fired = "foldin_pressure"
    elif cfg.min_ingest_events > 0 \
            and signals.ingest_events >= cfg.min_ingest_events:
        fired = "ingest_volume"
    if fired is None:
        return None, None
    if now_ms < state.next_earliest_ms:
        return None, ("backoff" if state.consecutive_failures > 0
                      else "cooldown")
    return fired, None


class StoreSignals:
    """Default :class:`TriggerSignals` source: the event store for
    digest + bounded fresh-event counts, and — when the orchestrator
    drives a live query server — its ``/deploy/status.json`` and
    ``/slo.json`` for fold-in pressure and SLO burn. Standalone (no
    server), fold-in pressure reads 0 and SLO burn comes from a locally
    ticked engine when server.json configures one."""

    def __init__(self, app_name: Optional[str],
                 channel_name: Optional[str] = None,
                 http_get: Optional[Callable[[str], dict]] = None,
                 slo_engine: Optional[Any] = None):
        self.app_name = app_name
        self.channel_name = channel_name
        self._http_get = http_get
        self._slo_engine = slo_engine

    def observe(self, watermark_ms: int, last_digest: str,
                ingest_limit: int) -> TriggerSignals:
        from predictionio_tpu_torch.data.eventstore import EventStoreClient

        out = TriggerSignals()
        if self.app_name:
            try:
                out.digest = EventStoreClient.snapshot_digest(
                    self.app_name, self.channel_name)
            except Exception:
                logger.exception("snapshot digest read failed")
            if ingest_limit > 0 and (out.digest is None
                                     or out.digest != last_digest):
                out.ingest_events = self._count_fresh(
                    watermark_ms, ingest_limit)
        if self._http_get is not None:
            try:
                status = self._http_get("/deploy/status.json")
                out.foldin_pending = int(
                    ((status or {}).get("foldin") or {})
                    .get("pendingRows", 0) or 0)
            except Exception:
                logger.exception("foldin pressure read failed")
            try:
                slo = self._http_get("/slo.json")
                out.slo_breached = bool((slo or {}).get("breached"))
            except Exception:
                logger.exception("slo status read failed")
        elif self._slo_engine is not None:
            try:
                self._slo_engine.tick()
                out.slo_breached = self._slo_engine.breached(
                    exclude_kinds=("freshness",))
            except Exception:
                logger.exception("local slo tick failed")
        return out

    def _count_fresh(self, watermark_ms: int, limit: int) -> int:
        """Bounded count of events since the watermark: the trigger only
        needs "at least `limit`?", so the scan stops at limit rows —
        never O(all events) per tick."""
        from predictionio_tpu_torch.data.eventstore import EventStoreClient

        since = _dt.datetime.fromtimestamp(watermark_ms / 1000.0, tz=UTC)
        try:
            rows = EventStoreClient.find(
                self.app_name, self.channel_name, start_time=since,
                limit=limit)
            return sum(1 for _ in itertools.islice(rows, limit))
        except Exception:
            logger.exception("fresh-event count failed")
            return 0


# ---------------------------------------------------------------------------
# serving planes: how canary/promote/rollback act on the world
# ---------------------------------------------------------------------------

def _releases():
    return Storage.get_meta_data_releases()


class RegistryPlane:
    """Canary/promote/rollback entirely over the release registry — the
    mode where the orchestrator IS the deploy authority (no live query
    server attached). The canary marks the candidate CANARY and asks
    the injected ``judge`` for a verdict (default: promote — the
    eval-gate and smoke phases are the evidence when there is no live
    traffic to observe; wire :func:`make_slo_judge` or a live server to
    judge on real signals)."""

    def __init__(self, judge: Optional[Callable[[CycleDoc],
                                                Tuple[str, str]]] = None):
        self._judge = judge

    def canary(self, doc: CycleDoc) -> Tuple[str, str]:
        _releases().set_status(
            doc.candidate_release_id, "CANARY",
            f"orchestrator cycle {doc.cycle_id}")
        maybe_kill("orch:canary:armed")
        if self._judge is None:
            return ("promote",
                    "no canary judge configured: eval + smoke gates passed")
        return self._judge(doc)

    def promote(self, doc: CycleDoc) -> None:
        """The two-write promote. Order: candidate LIVE first (the
        at-least-one-LIVE invariant for readers resolving by status),
        then retire the baseline. The kill window between them leaves
        dual-LIVE — healed by recovery completing THIS promote
        (set_status is idempotent, so re-running never duplicates)."""
        rels = _releases()
        rels.set_status(doc.candidate_release_id, "LIVE",
                        f"orchestrator promote (cycle {doc.cycle_id})")
        maybe_kill("orch:promote:mid")
        if doc.baseline_release_id \
                and doc.baseline_release_id != doc.candidate_release_id:
            base = rels.get(doc.baseline_release_id)
            if base is not None and base.status == "LIVE":
                rels.set_status(
                    base.id, "RETIRED",
                    f"superseded by orchestrator cycle {doc.cycle_id}")

    def rollback(self, doc: CycleDoc, reason: str) -> None:
        rels = _releases()
        cand = (rels.get(doc.candidate_release_id)
                if doc.candidate_release_id else None)
        if cand is not None and cand.status != "LIVE":
            rels.set_status(cand.id, "ROLLED_BACK", reason)
        # the standby must stay servable: restore the baseline if the
        # cycle (or a crash inside it) knocked it off LIVE — unless the
        # candidate actually IS live (a rollback triggered by a failure
        # AFTER a committed promote must not resurrect the old release
        # next to the new one)
        if doc.baseline_release_id and (cand is None
                                        or cand.status != "LIVE"):
            base = rels.get(doc.baseline_release_id)
            if base is not None and base.status != "LIVE":
                rels.set_status(base.id, "LIVE",
                                f"standby restored: {reason}")


def _latency_window_start(registry) -> dict:
    """Snapshot the cumulative serving metrics at canary-hold start, so
    the verdict can compute the CANDIDATE WINDOW's own p99/error rate
    as deltas (the live ring only knows 'since process start')."""
    from predictionio_tpu_torch.obs.registry import Histogram

    out = {"counts": None, "buckets": (), "failures": 0.0}
    hist = registry.get("pio_query_duration_seconds")
    if isinstance(hist, Histogram):
        snap = hist.to_snapshot()
        counts = [0.0] * (len(hist.buckets) + 1)
        for s in snap.get("series", ()):
            for i, c in enumerate(s.get("counts", ())):
                counts[i] += c
        out["counts"] = counts
        out["buckets"] = tuple(hist.buckets)
    failures = registry.get("pio_query_failures_total")
    if failures is not None:
        out["failures"] = sum(v for _, v in failures.samples())
    return out


def _latency_window_stats(registry, start: dict
                          ) -> Optional[Tuple[float, float, float]]:
    """(p99_s, error_rate, served) of the window since ``start``; None
    when the window saw no traffic (nothing to judge)."""
    from predictionio_tpu_torch.obs.tsdb import bucket_quantile

    end = _latency_window_start(registry)
    if end["counts"] is None:
        return None
    if start["counts"] is None:
        # the histogram was first registered DURING the hold: the whole
        # thing is window traffic
        start = {"counts": [0.0] * len(end["counts"]),
                 "buckets": end["buckets"],
                 "failures": start["failures"]}
    if end["buckets"] != start["buckets"]:
        return None
    delta = [max(0.0, b - a) for a, b in zip(start["counts"],
                                             end["counts"])]
    served = sum(delta)
    failures = max(0.0, end["failures"] - start["failures"])
    if served + failures <= 0:
        return None
    p99 = bucket_quantile(end["buckets"], delta, 0.99) if served else 0.0
    return p99, failures / (served + failures), served


def history_baseline(history, window_s: float,
                     until_ms: Optional[int] = None
                     ) -> Optional[Tuple[float, float]]:
    """(p99_s, error_rate) of the trailing ``window_s`` from the durable
    telemetry store — "was this canary's p99 bad, or is it Tuesday?".
    None when the store holds no serving history for the window."""
    until_ms = int(time.time() * 1000) if until_ms is None else until_ms
    since_ms = int(until_ms - window_s * 1000)
    p99 = history.quantile_over_time("pio_query_duration_seconds", 0.99,
                                     since_ms=since_ms, until_ms=until_ms)
    if p99 is None:
        return None
    window = history.histogram_window("pio_query_duration_seconds",
                                      since_ms=since_ms, until_ms=until_ms)
    served = window[2] if window is not None else 0.0
    failures = sum(
        r["increase"] for r in history.rate("pio_query_failures_total",
                                            since_ms=since_ms,
                                            until_ms=until_ms))
    err_rate = failures / (served + failures) if served + failures > 0 \
        else 0.0
    return p99, err_rate


def make_slo_judge(slo_engine, hold_s: float,
                   sleep: Callable[[float], None] = time.sleep,
                   tick_s: float = 0.5,
                   history=None,
                   baseline_window_s: float = 3600.0,
                   p99_ratio: float = 2.0,
                   latency_slack_s: float = 0.025,
                   error_rate_slack: float = 0.05) -> Callable:
    """A registry-plane canary judge over the SLO burn-rate engine:
    hold for ``hold_s``, ticking; any non-freshness breach rolls back,
    a clean hold promotes (freshness excluded for the same reason as
    fold-in gating: a retrain is the CURE for staleness).

    With ``history`` (a tsdb reader over the telemetry stores) and a
    positive ``baseline_window_s``, the hold window's own p99/error
    rate is additionally judged against the TRAILING WINDOW from the
    durable store — not only the incumbent's live ring, which a restart
    empties: a candidate that is "clean" only because the process
    forgot what normal looks like still rolls back."""

    def judge(doc: CycleDoc) -> Tuple[str, str]:
        start = None
        if history is not None and baseline_window_s > 0:
            start = _latency_window_start(slo_engine.registry)
            start_ms = int(time.time() * 1000)
        waited = 0.0
        while True:
            slo_engine.tick()
            if slo_engine.breached(exclude_kinds=("freshness",)):
                breached = [o["name"] for o in
                            slo_engine.status().get("objectives", ())
                            if o.get("breached")]
                return ("rollback", f"slo_burn: {','.join(breached)}")
            if waited >= hold_s:
                break
            step = min(tick_s, hold_s - waited)
            sleep(step)
            waited += step
        if start is not None:
            stats = _latency_window_stats(slo_engine.registry, start)
            baseline = history_baseline(history, baseline_window_s,
                                        until_ms=start_ms)
            if stats is not None and baseline is not None:
                p99, err_rate, served = stats
                base_p99, base_err = baseline
                if err_rate > base_err + error_rate_slack:
                    return ("rollback",
                            f"history_baseline: window error rate "
                            f"{err_rate:.3f} > trailing "
                            f"{base_err:.3f} + {error_rate_slack}")
                if p99 > base_p99 * p99_ratio + latency_slack_s:
                    return ("rollback",
                            f"history_baseline: window p99 "
                            f"{p99 * 1e3:.1f}ms > trailing p99 "
                            f"{base_p99 * 1e3:.1f}ms x {p99_ratio} + "
                            f"{latency_slack_s * 1e3:.0f}ms")
                return ("promote",
                        f"slo clean for {hold_s:g}s; window p99 "
                        f"{p99 * 1e3:.1f}ms / err {err_rate:.3f} within "
                        f"trailing baseline ({served:.0f} served)")
        return ("promote", f"slo clean for {hold_s:g}s")

    return judge


class HttpPlane:
    """Drive a LIVE query server's deploy API: the canary is a real
    staged rollout (POST /deploy.json with a traffic fraction, the
    server's CanaryController judges p99/error SLOs against the
    incumbent and acts), promote/rollback converge the registry to
    whatever the server decided. HTTP calls retry with the shared
    full-jitter policy."""

    def __init__(self, base_url: str, access_key: Optional[str] = None,
                 fraction: float = 0.1,
                 verdict_timeout_s: float = 60.0,
                 poll_s: float = 0.25,
                 policy: Optional[RetryPolicy] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.base_url = base_url.rstrip("/")
        self.access_key = access_key
        self.fraction = fraction
        self.verdict_timeout_s = verdict_timeout_s
        self.poll_s = poll_s
        self.policy = policy or RetryPolicy(retries=2, backoff_s=0.2,
                                            backoff_cap_s=2.0,
                                            timeout_s=30.0)
        self._sleep = sleep
        self._registry_plane = RegistryPlane()

    # -- http ---------------------------------------------------------------
    def _url(self, path: str) -> str:
        url = f"{self.base_url}{path}"
        if self.access_key:
            sep = "&" if "?" in url else "?"
            url = f"{url}{sep}accessKey={self.access_key}"
        return url

    def _request(self, path: str, body: Optional[dict] = None) -> dict:
        import urllib.request

        def once():
            req = urllib.request.Request(
                self._url(path),
                data=(json.dumps(body).encode()
                      if body is not None else None),
                method="POST" if body is not None else "GET",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                return json.loads(r.read().decode())

        return retry_call(once, policy=self.policy, sleep=self._sleep)

    def get(self, path: str) -> dict:
        return self._request(path)

    # -- plane --------------------------------------------------------------
    def canary(self, doc: CycleDoc) -> Tuple[str, str]:
        # canaryFraction in the body is what opts the server into a
        # staged rollout instead of a full cutover
        body = {"releaseId": doc.candidate_release_id,
                "canaryFraction": self.fraction}
        out = self._request("/deploy.json", body)
        maybe_kill("orch:canary:armed")
        if "Canary" not in str(out.get("message", "")):
            # the server did a full deploy (no canary config): treat as
            # promoted by the operator's own configuration
            return ("promote", f"server deployed directly: {out}")
        deadline = time.monotonic() + self.verdict_timeout_s
        while time.monotonic() < deadline:
            status = self._request("/deploy/status.json")
            if status.get("canary") is None:
                # the server acted on a verdict. Its OWN active release
                # is the authoritative promote signal — the registry
                # LIVE/ROLLED_BACK write happens best-effort on an
                # executor thread and may lag this poll
                active_v = (status.get("active") or {}).get(
                    "releaseVersion")
                if active_v and doc.candidate_release_version \
                        and int(active_v) == int(
                            doc.candidate_release_version):
                    return ("promote",
                            f"server promoted: serving v{active_v}")
                return self._verdict_from_registry(doc)
            self._sleep(self.poll_s)
        # no verdict in time: abort the rollout rather than leaving an
        # undecided canary holding the deploy API hostage
        try:
            self._request("/rollback.json", {})
        except Exception:
            logger.exception("canary-timeout rollback request failed")
        return ("rollback",
                f"no canary verdict within {self.verdict_timeout_s:g}s")

    def _verdict_from_registry(self, doc: CycleDoc,
                               grace_s: float = 5.0) -> Tuple[str, str]:
        """The registry-lineage verdict, with a grace window: the query
        server writes the release status off-thread after acting, so a
        non-terminal status right after the canary settles means "not
        written YET", not "rolled back"."""
        deadline = time.monotonic() + grace_s
        status = None
        while True:
            cand = _releases().get(doc.candidate_release_id)
            status = cand.status if cand is not None else None
            if status == "LIVE":
                reason = ""
                for h in reversed(cand.history):
                    if h.get("status") == "LIVE":
                        reason = h.get("reason", "")
                        break
                return ("promote", f"server promoted: {reason}")
            if status in ("ROLLED_BACK", "RETIRED"):
                return ("rollback",
                        f"server rolled back: "
                        f"{cand.history[-1].get('reason', '')}")
            if time.monotonic() >= deadline:
                break
            self._sleep(max(0.05, self.poll_s))
        return ("rollback",
                f"no terminal release status after the canary settled "
                f"(last seen: {status})")

    def promote(self, doc: CycleDoc) -> None:
        # the server already swapped + wrote LIVE/RETIRED on its verdict
        # (best-effort, off-thread) — converge the registry so the
        # lineage is consistent even if those writes were lost
        self._registry_plane.promote(doc)

    def rollback(self, doc: CycleDoc, reason: str) -> None:
        self._registry_plane.rollback(doc, reason)


# ---------------------------------------------------------------------------
# the orchestrator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OrchestratorHooks:
    """The cycle's side-effect seams. Production hooks are built by
    :func:`build_hooks` from an engine variant; tests inject fakes and
    drive the same state machine, kill points and all.

    ``train(doc) -> EngineInstance`` must return a COMPLETED instance
    whose ``batch`` is the cycle id (the idempotency key).
    ``evaluate(doc) -> (score, ok, detail)`` runs the eval sweep and
    applies the quality gate; None skips the phase.
    ``smoke(doc) -> {"written": n, "invalid": m}`` scores the smoke
    query set against the candidate; None skips the phase.
    ``signals`` feeds trigger evaluation; None disables data triggers.
    """

    train: Callable[[CycleDoc], Any]
    evaluate: Optional[Callable[[CycleDoc], Tuple[float, bool, str]]] = None
    smoke: Optional[Callable[[CycleDoc], dict]] = None
    signals: Optional[StoreSignals] = None


class Orchestrator:
    """The durable phase state machine (see module docstring)."""

    def __init__(self, engine_id: str, engine_version: str,
                 engine_variant: str, config: OrchestratorConfig,
                 hooks: OrchestratorHooks,
                 plane=None,
                 state_dir: Optional[str] = None,
                 registry=None,
                 clock_ms: Callable[[], int] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None):
        self.engine_id = engine_id
        self.engine_version = engine_version
        self.engine_variant = engine_variant
        self.cfg = config
        self.hooks = hooks
        self.plane = plane if plane is not None else RegistryPlane()
        self.store = CycleStore(state_dir or config.state_dir
                                or default_state_dir())
        self.metrics = orchestrator_metrics(registry)
        self._clock_ms = clock_ms or (lambda: int(time.time() * 1000))
        self._sleep = sleep
        self._rng = rng or random.Random()
        self._stop = False

    # -- public loop ---------------------------------------------------------
    def run(self, cycles: Optional[int] = None,
            force_first: bool = False) -> int:
        """Recover, then poll triggers every ``interval_s``; returns the
        number of cycles completed (bounded by ``cycles`` when given).
        ``force_first`` fires one manual cycle immediately."""
        self.recover()
        done = 0
        force = force_first
        while not self._stop:
            doc = self.tick(force=force)
            force = False
            if doc is not None:
                done += 1
            if cycles is not None and done >= cycles:
                break
            if self._stop:
                break
            self._sleep(self.cfg.interval_s)
        return done

    def stop(self) -> None:
        self._stop = True

    # -- trigger evaluation --------------------------------------------------
    def tick(self, force: bool = False) -> Optional[CycleDoc]:
        """One trigger evaluation; runs a full cycle when one fires (or
        ``force``). Returns the finished cycle document, or None."""
        pending = self.store.load_cycle()
        if pending is not None:
            # a previous process died mid-cycle and nobody recovered:
            # converge before considering new work
            self.recover()
            return None
        now = self._clock_ms()
        state = self.store.load_trigger_state(now)
        signals = self._observe(state)
        if force:
            fired, suppressed = "manual", None
        else:
            fired, suppressed = evaluate_triggers(
                self.cfg, state, signals, now)
        if suppressed is not None:
            self.metrics.suppressed_total.inc(reason=suppressed)
            logger.info("trigger suppressed (%s) until %d", suppressed,
                        state.next_earliest_ms)
            return None
        if fired is None:
            return None
        self.metrics.triggers_total.inc(trigger=fired)
        doc = CycleDoc(
            cycle_id=generate_id()[:16],
            trace=TraceContext.root().encode(),
            trigger=fired,
            started_ms=now, updated_ms=now,
            trigger_digest=signals.digest or "",
            baseline_release_id=self._baseline_release_id())
        self.store.commit_cycle(doc)
        maybe_kill("orch:cycle:created")
        return self.run_cycle(doc)

    def _observe(self, state: TriggerState) -> TriggerSignals:
        if self.hooks.signals is None:
            return TriggerSignals()
        return self.hooks.signals.observe(
            state.watermark_ms, state.last_digest,
            self.cfg.min_ingest_events)

    def _baseline_release_id(self) -> str:
        try:
            live = _releases().latest(self.engine_id, self.engine_version,
                                      self.engine_variant, status="LIVE")
            return live.id if live is not None else ""
        except Exception:
            logger.exception("baseline release lookup failed")
            return ""

    # -- the cycle -----------------------------------------------------------
    def run_cycle(self, doc: CycleDoc) -> CycleDoc:
        """Execute (or resume) the cycle's remaining phases under its
        one trace id."""
        ctx = TraceContext.decode(doc.trace)
        with carried(ctx, "orchestrate_cycle",
                     attrs={"cycle": doc.cycle_id,
                            "trigger": doc.trigger}):
            record_event("orch_trigger", {
                "cycleId": doc.cycle_id, "trigger": doc.trigger,
                "baselineReleaseId": doc.baseline_release_id or None})
            try:
                start = 0
                if doc.phase:
                    start = PHASES.index(doc.phase)
                    if doc.phase_status == "done":
                        start += 1
                for phase in PHASES[start:]:
                    self._run_phase(doc, phase)
                self._finish(doc, "promoted",
                             f"cycle complete: release "
                             f"v{doc.candidate_release_version} live")
            except CycleRollback as e:
                self._rollback_cycle(doc, str(e))
            except CycleFailed as e:
                self._rollback_cycle(doc, str(e), outcome="failed")
            except CrashError:
                raise       # the simulated kill -9: leave the doc as-is
            except Exception as e:
                logger.exception("cycle %s failed", doc.cycle_id)
                self._rollback_cycle(doc, f"{type(e).__name__}: {e}",
                                     outcome="failed")
        return doc

    def _run_phase(self, doc: CycleDoc, phase: str) -> None:
        fn = {
            "train": self._phase_train,
            "eval": self._phase_eval,
            "smoke": self._phase_smoke,
            "canary": self._phase_canary,
            "promote": self._phase_promote,
        }[phase]
        # commit the transition BEFORE any side effect of the phase
        doc.phase = phase
        doc.phase_status = "running"
        doc.updated_ms = self._clock_ms()
        self.store.commit_cycle(doc)
        maybe_kill(f"orch:{phase}:enter")
        record_event("orch_phase", {"cycleId": doc.cycle_id,
                                    "phase": phase, "status": "start"})
        t0 = time.perf_counter()
        policy = RetryPolicy(
            retries=self.cfg.phase_retries,
            backoff_s=self.cfg.phase_backoff_s,
            backoff_cap_s=self.cfg.phase_backoff_cap_s,
            timeout_s=self.cfg.phase_timeout_s)

        def attempt():
            # each attempt works on its OWN copy of the document: a
            # timed-out attempt is abandoned, not killed, and a late
            # finisher writing into the live doc could smuggle an
            # un-gated candidate into a later phase (or tear a commit)
            work = CycleDoc.from_json(doc.to_json())
            try:
                fn(work)
                return (work, None)
            except CycleRollback as e:
                return (work, e)    # terminal verdicts are not retried

        def on_retry(i, err):
            doc.attempts[phase] = doc.attempts.get(phase, 0) + 1
            self.metrics.phase_retries.inc(phase=phase)
            logger.warning("phase %s attempt %d failed: %s; backing off",
                           phase, i + 1, err)

        try:
            work, verdict = retry_call(attempt, policy=policy,
                                       on_retry=on_retry,
                                       sleep=self._sleep, rng=self._rng,
                                       thread_name=f"pio-orch-{phase}")
        except Exception as e:
            self.metrics.phase_seconds.observe(
                time.perf_counter() - t0, phase=phase)
            record_event("orch_phase", {
                "cycleId": doc.cycle_id, "phase": phase,
                "status": "failed", "error": f"{type(e).__name__}: {e}"})
            raise CycleFailed(
                f"{phase} failed after "
                f"{policy.attempts()} attempt(s): {e}") from e
        for field in PHASE_OUTPUT_FIELDS:
            setattr(doc, field, getattr(work, field))
        if verdict is not None:
            self.metrics.phase_seconds.observe(
                time.perf_counter() - t0, phase=phase)
            record_event("orch_phase", {
                "cycleId": doc.cycle_id, "phase": phase,
                "status": "rejected", "reason": str(verdict)})
            raise verdict
        maybe_kill(f"orch:{phase}:done")
        doc.phase_status = "done"
        doc.updated_ms = self._clock_ms()
        self.store.commit_cycle(doc)
        maybe_kill(f"orch:{phase}:committed")
        self.metrics.phase_seconds.observe(
            time.perf_counter() - t0, phase=phase)
        record_event("orch_phase", {"cycleId": doc.cycle_id,
                                    "phase": phase, "status": "done"})

    # -- phase bodies --------------------------------------------------------
    def _cycle_instances(self, doc: CycleDoc) -> List[Any]:
        instances = Storage.get_meta_data_engine_instances()
        return [i for i in instances.get_all() if i.batch == doc.cycle_id]

    def _phase_train(self, doc: CycleDoc) -> None:
        """Train once per cycle: re-entry (crash recovery, retry after a
        post-train failure) ADOPTS the cycle's COMPLETED instance
        instead of retraining, and unwinds any INIT row a killed
        attempt left behind."""
        instances = Storage.get_meta_data_engine_instances()
        mine = self._cycle_instances(doc)
        completed = [i for i in mine if i.status == "COMPLETED"]
        for i in mine:
            if i.status != "COMPLETED":
                instances.delete(i.id)      # a killed attempt's debris
        if completed:
            instance = completed[0]
            logger.info("cycle %s adopting completed instance %s",
                        doc.cycle_id, instance.id)
        else:
            instance = self.hooks.train(doc)
        if instance is None or instance.status != "COMPLETED":
            raise OrchestratorError(
                "train produced no COMPLETED instance")
        doc.train_instance_id = instance.id
        release = self._release_of_instance(instance.id)
        if release is None:
            release = self._register_release(instance)
        if release is None:
            raise OrchestratorError(
                f"no release manifest for instance {instance.id}")
        doc.candidate_release_id = release.id
        doc.candidate_release_version = release.version

    def _release_of_instance(self, instance_id: str) -> Optional[Release]:
        for r in _releases().get_for_variant(
                self.engine_id, self.engine_version, self.engine_variant):
            if r.instance_id == instance_id:
                return r
        return None

    def _register_release(self, instance) -> Optional[Release]:
        """Heal the train→register crash window: the instance COMPLETED
        but its manifest never landed (run_train's registration is
        best-effort). Re-register from the stored blob."""
        from predictionio_tpu_torch.deploy.releases import record_release

        model = Storage.get_model_data_models().get(instance.id)
        return record_release(
            instance,
            train_seconds=(instance.end_time - instance.start_time
                           ).total_seconds(),
            blob=model.models if model is not None else None)

    def _unwind_eval_instances(self, doc: CycleDoc) -> int:
        """Remove every evaluation row this cycle created — the failed-
        eval contract: the instance store looks exactly as before the
        phase started (the archived cycle doc keeps the score)."""
        evals = Storage.get_meta_data_evaluation_instances()
        removed = 0
        for i in evals.get_all():
            if i.batch == doc.cycle_id:
                evals.delete(i.id)
                removed += 1
        return removed

    def _phase_eval(self, doc: CycleDoc) -> None:
        # re-entry after a crash/retry: unwind the partial sweep first,
        # then run it fresh (the sweep is deterministic per data+params)
        self._unwind_eval_instances(doc)
        if self.hooks.evaluate is None:
            doc.eval_score = None
            return
        score, ok, detail = self.hooks.evaluate(doc)
        doc.eval_score = float(score)
        if not ok:
            # the gate said NO: clean up the sweep rows (EVALFAILED
            # debris included) and unwind the cycle without retrying
            raise CycleRollback(f"eval gate failed: {detail} "
                                f"(score {score})")

    def _phase_smoke(self, doc: CycleDoc) -> None:
        if self.hooks.smoke is None:
            doc.smoke = {"skipped": True}
            return
        report = self.hooks.smoke(doc)
        doc.smoke = dict(report)
        written = int(report.get("written", 0))
        invalid = int(report.get("invalid", 0))
        if written <= 0:
            raise CycleRollback("smoke scored no queries")
        if invalid > written:
            raise CycleRollback(
                f"smoke mostly invalid ({invalid}/{written + invalid})")

    def _phase_canary(self, doc: CycleDoc) -> None:
        verdict, reason = self.plane.canary(doc)
        doc.canary_verdict, doc.canary_reason = verdict, reason
        record_event("orch_canary_verdict", {
            "cycleId": doc.cycle_id, "verdict": verdict, "reason": reason,
            "releaseVersion": doc.candidate_release_version or None})
        if verdict != "promote":
            raise CycleRollback(f"canary {verdict}: {reason}")

    def _phase_promote(self, doc: CycleDoc) -> None:
        self.plane.promote(doc)

    # -- cycle termination ---------------------------------------------------
    def _finish(self, doc: CycleDoc, outcome: str, reason: str) -> None:
        doc.outcome = outcome
        doc.reason = reason
        doc.phase_status = "done"
        doc.updated_ms = self._clock_ms()
        self.store.commit_cycle(doc)
        maybe_kill("orch:cycle:finished")
        # account BEFORE archiving: the archive deletes the active doc
        # (the recovery evidence), so the cooldown/backoff window must
        # already be durably open by then — losing it would let a
        # persistently failing cycle re-trigger with no backoff. The
        # `accounted` flag makes recovery's re-run idempotent.
        self._account_outcome(doc)
        doc.accounted = True
        self.store.commit_cycle(doc)
        self.store.archive_cycle(doc)
        record_event("orch_cycle", {
            "cycleId": doc.cycle_id, "outcome": outcome, "reason": reason,
            "releaseVersion": doc.candidate_release_version or None,
            "trigger": doc.trigger})
        logger.info("cycle %s %s: %s", doc.cycle_id, outcome, reason)

    def _rollback_cycle(self, doc: CycleDoc, reason: str,
                        outcome: str = "rolled_back") -> None:
        try:
            self.plane.rollback(doc, reason)
        except CrashError:
            raise
        except Exception:
            logger.exception("plane rollback failed (registry converge "
                             "will heal on next start)")
        self._unwind_eval_instances(doc)
        self._finish(doc, outcome, reason)

    def _account_outcome(self, doc: CycleDoc) -> None:
        """Trigger-state bookkeeping at cycle end: watermark/digest
        advance, cooldown + (on failure) jittered backoff open."""
        now = self._clock_ms()
        state = self.store.load_trigger_state(now)
        if doc.outcome == "promoted":
            state.consecutive_failures = 0
        else:
            state.consecutive_failures += 1
        state.last_outcome = doc.outcome
        state.last_cycle_end_ms = now
        state.watermark_ms = doc.started_ms
        state.last_digest = doc.trigger_digest
        state.next_earliest_ms = next_earliest_ms(
            self.cfg, now, state.consecutive_failures, self._rng)
        self.store.commit_trigger_state(state)
        self.metrics.cycles_total.inc(outcome=doc.outcome)
        self.metrics.failure_streak.set(float(state.consecutive_failures))

    # -- crash recovery ------------------------------------------------------
    def recover(self) -> Optional[str]:
        """Converge after a crash: finish or unwind the active cycle,
        then heal the registry's global invariants. Idempotent — safe
        (and run) on every start."""
        doc = self.store.load_cycle()
        action = None
        if doc is not None and doc.outcome:
            # died between the outcome commit and the archive: finish
            # the bookkeeping (cooldown/backoff must still open, or the
            # next tick could hot-loop a failing cycle); `accounted`
            # keeps a crash between the two commits from double-counting
            if not doc.accounted:
                self._account_outcome(doc)
                doc.accounted = True
                self.store.commit_cycle(doc)
            self.store.archive_cycle(doc)
            doc = None
            action = "archived"
        if doc is not None:
            action = self._recover_cycle(doc)
            doc = self.store.load_cycle()   # may have finished just now
        self.converge_registry(doc)
        if action is not None:
            self.metrics.recovered_total.inc(action=action)
            logger.info("recovery: %s", action)
        return action

    def _recover_cycle(self, doc: CycleDoc) -> str:
        """Finish or unwind the crashed cycle. Phase bodies are
        idempotent by construction (adopt/unwind on re-entry), so
        resuming re-enters the interrupted phase; the one exception is
        a canary we were not watching — its verdict is unknowable, so
        it unwinds (the candidate stays redeployable by explicit
        selector)."""
        record_event("orch_recovery", {
            "cycleId": doc.cycle_id, "phase": doc.phase,
            "phaseStatus": doc.phase_status})
        if doc.phase == "canary" and doc.phase_status == "running":
            with carried(TraceContext.decode(doc.trace),
                         "orchestrate_recovery",
                         attrs={"cycle": doc.cycle_id}):
                self._rollback_cycle(
                    doc, "orchestrator died during canary; rolled back")
            return "unwound"
        self.run_cycle(doc)
        return "resumed"

    def converge_registry(self,
                          active_doc: Optional[CycleDoc] = None) -> dict:
        """Heal the variant's registry invariants: no ghost manifests
        (releases whose instance cannot be deployed), no orphaned
        CANARY rows, exactly one LIVE (the newest, or the active
        cycle's own candidate), and the baseline restored when a
        crashed cycle left nothing LIVE. Returns counts per action."""
        rels = _releases()
        instances = Storage.get_meta_data_engine_instances()
        stats = {"ghosts": 0, "orphaned_canaries": 0, "dual_live": 0,
                 "baseline_restored": 0}
        active_candidate = (active_doc.candidate_release_id
                            if active_doc is not None else "")
        listing = rels.get_for_variant(
            self.engine_id, self.engine_version, self.engine_variant)
        for r in listing:
            if r.status in ("REGISTERED", "CANARY", "LIVE"):
                inst = instances.get(r.instance_id)
                if inst is None or inst.status != "COMPLETED":
                    rels.set_status(
                        r.id, "ROLLED_BACK",
                        "ghost manifest: instance not deployable "
                        "(orchestrator convergence)")
                    stats["ghosts"] += 1
        listing = rels.get_for_variant(
            self.engine_id, self.engine_version, self.engine_variant)
        for r in listing:
            if r.status == "CANARY" and r.id != active_candidate:
                rels.set_status(
                    r.id, "ROLLED_BACK",
                    "orphaned canary (orchestrator convergence)")
                stats["orphaned_canaries"] += 1
        listing = rels.get_for_variant(
            self.engine_id, self.engine_version, self.engine_variant)
        live = [r for r in listing if r.status == "LIVE"]
        if len(live) > 1:
            keep = next((r for r in live if r.id == active_candidate),
                        max(live, key=lambda r: r.version))
            for r in live:
                if r.id != keep.id:
                    rels.set_status(
                        r.id, "RETIRED",
                        f"duplicate LIVE healed: v{keep.version} wins "
                        "(orchestrator convergence)")
                    stats["dual_live"] += 1
            live = [keep]
        if not live and active_doc is not None \
                and active_doc.baseline_release_id:
            base = rels.get(active_doc.baseline_release_id)
            if base is not None and base.status != "LIVE":
                rels.set_status(
                    base.id, "LIVE",
                    "baseline restored (orchestrator convergence)")
                stats["baseline_restored"] += 1
        if any(stats.values()):
            self.metrics.recovered_total.inc(action="converged")
            logger.info("registry converged: %s", stats)
        return stats


# ---------------------------------------------------------------------------
# production hooks from an engine variant (the CLI path)
# ---------------------------------------------------------------------------

def load_variant(variant_path: str):
    """engine.json -> (engine, engine_params, factory_path, variant_id,
    variant_json): the CLI's loader without the CLI (the engineFactory
    string names one of the port's engines, as ``pio train`` reads
    it)."""
    from predictionio_tpu_torch.cli.main import _engine_of

    with open(variant_path) as f:
        variant = json.load(f)
    factory_path = variant.get("engineFactory")
    if not factory_path:
        raise OrchestratorError(f"{variant_path} has no engineFactory")
    engine = _engine_of(variant)
    engine_params = engine.engine_params_from_json(variant)
    return (engine, engine_params, factory_path,
            variant.get("id", "default"), variant)


def _variant_app_name(variant_json: dict) -> Optional[str]:
    params = (variant_json.get("datasource") or {}).get("params") or {}
    return params.get("appName") or params.get("app_name")


def build_hooks(variant_path: str, config: OrchestratorConfig,
                eval_path: Optional[str] = None,
                server_get: Optional[Callable[[str], dict]] = None,
                slo_engine: Optional[Any] = None,
                device=None
                ) -> Tuple[OrchestratorHooks, str, str, str]:
    """The production hook set for ``pio orchestrate``: train/eval/
    smoke run the real workflows with the cycle id as the batch label
    (the recovery idempotency key), signals read the variant's app.
    Each workflow runs on ``device`` (None: ``cuda``).
    Returns (hooks, engine_id, engine_version, variant_id)."""
    engine, engine_params, factory_path, variant_id, variant_json = \
        load_variant(variant_path)

    def train_hook(doc: CycleDoc):
        from predictionio_tpu_torch.workflow.context import WorkflowParams
        from predictionio_tpu_torch.workflow.train import run_train

        instance, _result = run_train(
            engine, engine_params, engine_factory=factory_path,
            engine_variant=variant_id,
            workflow_params=WorkflowParams(batch=doc.cycle_id),
            device=device)
        return instance

    evaluate_hook = None
    if eval_path:
        def evaluate_hook(doc: CycleDoc):
            from predictionio_tpu_torch.core.base import load_class
            from predictionio_tpu_torch.core.evaluation import Evaluation
            from predictionio_tpu_torch.workflow.context import (
                WorkflowParams,
            )
            from predictionio_tpu_torch.workflow.evaluate import (
                run_evaluation,
            )

            evaluation = load_class(eval_path)
            if isinstance(evaluation, type):
                evaluation = evaluation()
            elif callable(evaluation) \
                    and not isinstance(evaluation, Evaluation):
                evaluation = evaluation()
            params_list = list(
                getattr(evaluation, "engine_params_list", [])) \
                or [engine_params]
            result = run_evaluation(
                evaluation, params_list, evaluation_class=eval_path,
                workflow_params=WorkflowParams(batch=doc.cycle_id),
                device=device)
            score = float(result.best_score)
            ok = (config.min_eval_score is None
                  or score >= config.min_eval_score)
            return score, ok, (
                "min_eval_score" if not ok else result.to_one_liner())

    smoke_hook = None
    if config.smoke_queries:
        def smoke_hook(doc: CycleDoc):
            from predictionio_tpu_torch.workflow.batch_predict import (
                run_batch_predict,
            )

            instances = Storage.get_meta_data_engine_instances()
            instance = instances.get(doc.train_instance_id)
            out = os.path.join(
                os.path.dirname(config.smoke_queries) or ".",
                f".orch-smoke-{doc.cycle_id}.jsonl")
            try:
                report = run_batch_predict(
                    engine, instance, config.smoke_queries, out,
                    device=device)
                return {"written": report.total_written or report.written,
                        "invalid": report.total_invalid or report.invalid
                        or 0}
            finally:
                for path in (out, f"{out}.errors.jsonl"):
                    try:
                        os.unlink(path)
                    except OSError:
                        pass

    hooks = OrchestratorHooks(
        train=train_hook, evaluate=evaluate_hook, smoke=smoke_hook,
        signals=StoreSignals(_variant_app_name(variant_json),
                             http_get=server_get, slo_engine=slo_engine))
    return hooks, factory_path, "1", variant_id


def build_orchestrator(variant_path: str,
                       config: Optional[OrchestratorConfig] = None,
                       eval_path: Optional[str] = None,
                       server: Optional[str] = None,
                       access_key: Optional[str] = None,
                       state_dir: Optional[str] = None,
                       registry=None, device=None) -> Orchestrator:
    """The ``pio orchestrate`` factory: resolve the knob chain (env >
    engine.json ``orchestrator`` section > server.json), build the
    production hooks, and pick the serving plane — a live query
    server's deploy API when ``server`` ("host:port") is given, else
    the registry plane with the SLO burn-rate judge when server.json
    configures objectives. The workflows run on ``device`` (None:
    ``cuda``)."""
    with open(variant_path) as f:
        variant_json = json.load(f)
    if config is None:
        from predictionio_tpu_torch.utils.server_config import orchestrator_config

        config = orchestrator_config(variant_json.get("orchestrator"))
    slo_engine = None
    server_get = None
    if server:
        plane = HttpPlane(
            f"http://{server}", access_key=access_key,
            verdict_timeout_s=config.canary_verdict_timeout_s)
        server_get = plane.get
    else:
        from predictionio_tpu_torch.obs.registry import default_registry
        from predictionio_tpu_torch.obs.slo import (
            SLOEngine, slo_spec_from_server_json,
        )

        spec = slo_spec_from_server_json()
        if spec is not None:
            slo_engine = SLOEngine(registry or default_registry(), spec)
        # optional history baseline: the fleet's durable telemetry
        # stores, when the host runs them (PIO_TELEMETRY=0 or an empty
        # store degrades to the plain live-ring judgment)
        history = None
        if slo_engine is not None and config.history_window_s > 0:
            from predictionio_tpu_torch.obs import fleet
            from predictionio_tpu_torch.utils.server_config import (
                telemetry_config,
            )

            tcfg = telemetry_config(variant_json.get("telemetry"))
            if tcfg.enabled:
                history = fleet.history_reader(tcfg.root_dir())
                try:
                    slo_engine.rehydrate(history)
                except Exception:
                    logger.exception("orchestrator SLO rehydrate failed")
        plane = RegistryPlane(
            judge=(make_slo_judge(
                slo_engine, config.canary_hold_s, history=history,
                baseline_window_s=config.history_window_s)
                   if slo_engine is not None else None))
    hooks, engine_id, engine_version, variant_id = build_hooks(
        variant_path, config, eval_path=eval_path, server_get=server_get,
        slo_engine=slo_engine, device=device)
    return Orchestrator(engine_id, engine_version, variant_id,
                        config, hooks, plane=plane,
                        state_dir=state_dir, registry=registry)
