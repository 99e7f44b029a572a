"""SLO-driven fleet autoscaling: replica count as a durable state machine
(port of the reference's ``deploy/fleet.py``; its fleet documents are
the reference's, readable by either package).

The orchestrator (deploy/orchestrator.py) made RETRAINING a crash-safe
phase state machine; this module applies the same chaos-tested
discipline to REPLICA COUNT:

* **Signals, not thresholds on instantaneous noise** — scale-up fires
  only after the serving SLO has burned CONTINUOUSLY for
  ``burn_sustain_s`` (the durable burn-rate history is what
  makes "continuously" survive a controller restart); scale-down fires
  only after fleet QPS has sat under ``idle_qps`` for
  ``idle_sustain_s``. A ``cooldown_s`` window between actions
  suppresses flapping the same way the orchestrator's trigger cooldown
  does.
* **Committed phase transitions with kill points** — every scale
  action writes a durable :class:`FleetDoc` (temp-write +
  ``os.replace``) BEFORE actuating, and commits
  ``done`` after; ``maybe_kill`` points sit at each boundary
  (``fleet:<action>:enter|done|committed``) so the chaos harness can
  kill the controller anywhere and :meth:`FleetController.recover`
  converges — a half-done scale-up re-checks actual capacity instead
  of double-spawning, a half-done scale-down finishes the drain.
* **One trace id per action** — each scale decision runs under its own
  ``TraceContext`` and lands in the flight recorder as ``fleet_scale``
  events, so ``pio traces`` shows decide → actuate → commit as one
  lineage.

The actuator seam (count/scale_up/scale_down) is how the controller
touches the world: ``server/router.Router`` provides the production one
(spawn replica + wait healthy; drain + stop — zero dropped queries is
the router's contract), tests inject fakes and drive the same state
machine, kill points and all.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Optional

from predictionio_tpu_torch.obs.trace_context import TraceContext, record_event
from predictionio_tpu_torch.obs.tracing import carried
from predictionio_tpu_torch.storage.base import generate_id
from predictionio_tpu_torch.storage.faults import CrashError, maybe_kill
from predictionio_tpu_torch.utils.server_config import FleetConfig

logger = logging.getLogger("pio.fleet")

#: scale actions a fleet document can record
ACTIONS = ("scale_up", "scale_down")

#: terminal action outcomes
OUTCOMES = ("done", "failed")


@dataclasses.dataclass
class FleetSignals:
    """One observation of the autoscaler's inputs (produced by the
    router's health probes + request counters)."""

    burning: bool = False       # any in-rotation replica's SLO burning
    qps: float = 0.0            # fleet-wide queries per second
    healthy: int = 0            # replicas currently in rotation


@dataclasses.dataclass
class FleetState:
    """The controller's durable bookkeeping between actions."""

    burn_since_ms: int = 0      # 0 = not currently burning
    idle_since_ms: int = 0      # 0 = not currently idle
    cooldown_until_ms: int = 0
    last_action: str = ""
    last_outcome: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, data: dict) -> "FleetState":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in fields})


@dataclasses.dataclass
class FleetDoc:
    """One scale action's durable record (the recovery source of
    truth). Committed crash-safe on every transition."""

    action_id: str
    action: str = ""
    trace: str = ""
    reason: str = ""
    from_replicas: int = 0
    to_replicas: int = 0
    phase_status: str = ""      # "running" | "done"
    outcome: str = ""           # "" while active, else OUTCOMES
    detail: str = ""
    started_ms: int = 0
    updated_ms: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, data: dict) -> "FleetDoc":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in fields})


class FleetStore:
    """Durable file state under ``state_dir``: ``state.json`` (the
    sustain/cooldown bookkeeping), ``action.json`` (the active scale
    action), ``history/<action_id>.json`` (archived actions). Every
    commit is temp-write + ``os.replace``."""

    def __init__(self, state_dir: str):
        self.state_dir = state_dir
        os.makedirs(os.path.join(state_dir, "history"), exist_ok=True)

    @property
    def state_path(self) -> str:
        return os.path.join(self.state_dir, "state.json")

    @property
    def action_path(self) -> str:
        return os.path.join(self.state_dir, "action.json")

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
            logger.error("unreadable fleet state %s: %s", path, e)
            return None

    def commit_state(self, state: FleetState) -> None:
        self._commit_json(self.state_path, state.to_json())

    def load_state(self) -> FleetState:
        data = self._load_json(self.state_path)
        return FleetState.from_json(data) if data else FleetState()

    def commit_action(self, doc: FleetDoc) -> None:
        self._commit_json(self.action_path, doc.to_json())

    def load_action(self) -> Optional[FleetDoc]:
        data = self._load_json(self.action_path)
        return FleetDoc.from_json(data) if data else None

    def archive_action(self, doc: FleetDoc) -> None:
        """Ordered like the orchestrator's archive: history copy first,
        then unlink the active slot — a kill between leaves both."""
        self._commit_json(
            os.path.join(self.state_dir, "history",
                         f"{doc.action_id}.json"), doc.to_json())
        try:
            os.unlink(self.action_path)
        except FileNotFoundError:
            pass


def decide(cfg: FleetConfig, state: FleetState, signals: FleetSignals,
           now_ms: int, replicas: int) -> tuple:
    """The pure scaling decision: ``(action | None, reason)``.

    Mutates only the sustain clocks in ``state`` (the caller commits).
    Scale-up outranks scale-down (a burning fleet that also looks idle
    is a broken replica, not spare capacity); both respect bounds and
    the cooldown window."""
    # sustain clocks: a signal edge starts the clock, its absence
    # resets it — "sustained" means continuously held, not cumulative
    if signals.burning:
        if state.burn_since_ms == 0:
            state.burn_since_ms = now_ms or 1   # 0 is the idle sentinel
    else:
        state.burn_since_ms = 0
    if signals.qps <= cfg.idle_qps:
        if state.idle_since_ms == 0:
            state.idle_since_ms = now_ms or 1
    else:
        state.idle_since_ms = 0
    if now_ms < state.cooldown_until_ms:
        return None, "cooldown"
    if state.burn_since_ms \
            and now_ms - state.burn_since_ms >= cfg.burn_sustain_s * 1000:
        if replicas >= cfg.max_replicas:
            return None, "burning but at max_replicas"
        burned_s = (now_ms - state.burn_since_ms) / 1000.0
        return "scale_up", (f"slo burned {burned_s:.0f}s "
                            f">= {cfg.burn_sustain_s:g}s")
    if state.idle_since_ms \
            and now_ms - state.idle_since_ms >= cfg.idle_sustain_s * 1000:
        if replicas <= cfg.min_replicas:
            return None, "idle but at min_replicas"
        idle_s = (now_ms - state.idle_since_ms) / 1000.0
        return "scale_down", (f"qps <= {cfg.idle_qps:g} for "
                              f"{idle_s:.0f}s >= {cfg.idle_sustain_s:g}s")
    return None, "steady"


class FleetController:
    """The durable scale state machine (module docstring). ``actuator``
    may be bound later via :meth:`bind` (the router constructs the
    controller before its event loop exists)."""

    def __init__(self, config: FleetConfig, actuator=None,
                 state_dir: Optional[str] = None,
                 registry=None,
                 clock_ms=None):
        self.cfg = config
        self.actuator = actuator
        self.store = FleetStore(state_dir or config.resolved_state_dir())
        self._clock_ms = clock_ms or (lambda: int(time.time() * 1000))
        self._replicas_g = None
        self._actions_total = None
        if registry is not None:
            self._replicas_g = registry.gauge(
                "pio_fleet_replicas",
                "Replica count the autoscaler last observed")
            self._actions_total = registry.counter(
                "pio_fleet_scale_actions_total",
                "Committed scale actions by direction and outcome",
                labelnames=("action", "outcome"))

    def bind(self, actuator) -> None:
        self.actuator = actuator

    def status(self) -> dict:
        state = self.store.load_state()
        active = self.store.load_action()
        return {
            "enabled": self.cfg.enabled,
            "minReplicas": self.cfg.min_replicas,
            "maxReplicas": self.cfg.max_replicas,
            "state": state.to_json(),
            "activeAction": active.to_json() if active else None,
        }

    # -- the tick ------------------------------------------------------------
    def tick(self, signals: FleetSignals) -> Optional[FleetDoc]:
        """One observation → at most one committed scale action.
        Returns the finished action document, or None."""
        if self.actuator is None:
            return None
        pending = self.store.load_action()
        if pending is not None:
            # a previous process died mid-action: converge before
            # considering new work
            self.recover()
            return None
        now = self._clock_ms()
        replicas = self.actuator.count()
        if self._replicas_g is not None:
            self._replicas_g.set(float(replicas))
        state = self.store.load_state()
        action, reason = decide(self.cfg, state, signals, now, replicas)
        self.store.commit_state(state)      # sustain clocks advanced
        if action is None:
            return None
        doc = FleetDoc(
            action_id=generate_id()[:16],
            action=action,
            trace=TraceContext.root().encode(),
            reason=reason,
            from_replicas=replicas,
            to_replicas=replicas + (1 if action == "scale_up" else -1),
            started_ms=now, updated_ms=now)
        self.store.commit_action(doc)
        maybe_kill("fleet:action:created")
        return self._run_action(doc, state)

    def _run_action(self, doc: FleetDoc, state: FleetState) -> FleetDoc:
        ctx = TraceContext.decode(doc.trace)
        with carried(ctx, "fleet_scale",
                     attrs={"action": doc.action,
                            "actionId": doc.action_id}):
            record_event("fleet_scale", {
                "actionId": doc.action_id, "action": doc.action,
                "status": "start", "reason": doc.reason,
                "fromReplicas": doc.from_replicas,
                "toReplicas": doc.to_replicas})
            doc.phase_status = "running"
            doc.updated_ms = self._clock_ms()
            self.store.commit_action(doc)
            maybe_kill(f"fleet:{doc.action}:enter")
            try:
                detail = self._actuate(doc)
            except CrashError:
                raise           # the simulated kill -9: doc stays as-is
            except Exception as e:
                logger.exception("fleet %s failed", doc.action)
                return self._finish(doc, state, "failed",
                                    f"{type(e).__name__}: {e}")
            maybe_kill(f"fleet:{doc.action}:done")
            doc.phase_status = "done"
            doc.updated_ms = self._clock_ms()
            self.store.commit_action(doc)
            maybe_kill(f"fleet:{doc.action}:committed")
            return self._finish(doc, state, "done", detail)

    def _actuate(self, doc: FleetDoc) -> str:
        if doc.action == "scale_up":
            rank = self.actuator.scale_up()
            return f"replica {rank} healthy"
        drained = self.actuator.scale_down()
        return "drained clean" if drained else "drain timed out"

    def _finish(self, doc: FleetDoc, state: FleetState, outcome: str,
                detail: str) -> FleetDoc:
        doc.outcome = outcome
        doc.detail = detail
        doc.updated_ms = self._clock_ms()
        self.store.commit_action(doc)
        # the action consumed its sustain window: reset the clocks and
        # open the cooldown BEFORE archiving (same ordering argument as
        # the orchestrator's accounting — losing the cooldown would let
        # a still-burning fleet immediately re-fire)
        state.burn_since_ms = 0
        state.idle_since_ms = 0
        state.cooldown_until_ms = int(self._clock_ms()
                                      + self.cfg.cooldown_s * 1000)
        state.last_action = doc.action
        state.last_outcome = outcome
        self.store.commit_state(state)
        self.store.archive_action(doc)
        if self._actions_total is not None:
            self._actions_total.inc(action=doc.action, outcome=outcome)
        record_event("fleet_scale", {
            "actionId": doc.action_id, "action": doc.action,
            "status": outcome, "detail": detail,
            "fromReplicas": doc.from_replicas,
            "toReplicas": doc.to_replicas})
        logger.info("fleet %s %s: %s (%d -> %d replicas)", doc.action,
                    outcome, detail, doc.from_replicas, doc.to_replicas)
        return doc

    # -- crash recovery ------------------------------------------------------
    def recover(self) -> Optional[str]:
        """Converge a crashed action: a scale-up that already reached
        its target capacity just commits, one that didn't re-actuates
        (spawn + wait-healthy is idempotent against actual count); a
        scale-down re-drains (drain is idempotent). Safe on every
        start."""
        doc = self.store.load_action()
        if doc is None:
            return None
        state = self.store.load_state()
        if doc.outcome:
            # died between the outcome commit and the archive
            self.store.archive_action(doc)
            return "archived"
        record_event("fleet_recovery", {
            "actionId": doc.action_id, "action": doc.action,
            "phaseStatus": doc.phase_status})
        if self.actuator is not None \
                and self.actuator.count() == doc.to_replicas:
            # the actuation completed before the crash: just commit
            with carried(TraceContext.decode(doc.trace),
                         "fleet_recovery",
                         attrs={"actionId": doc.action_id}):
                self._finish(doc, state, "done",
                             "recovered: capacity already at target")
            return "committed"
        self._run_action(doc, state)
        return "resumed"
