"""The storm itself (port of the reference's ``loadtest/simulator.py``):
population × scenario × open-loop lanes × chaos × live invariants,
producing one verdict dict.

Three concurrent open-loop lanes drive the fleet the way production
traffic would:

* **events** — behavioural ``rate`` events, batched to the event
  server's batch API; every acked event id lands in the emitter's
  ledger (the exactly-once audit's ground truth).
* **queries** — recommendation queries through the router; served
  slates feed back into per-user session state.
* **feedback** — positive signals on PREVIOUSLY-SERVED items (the
  fold-in loop closed by real traffic, not synthetic writes).

An incident thread walks the scenario timeline (kill/restart a
replica, crash a compaction, burn SLO, degrade quality, force a
retrain-and-promote cycle), and the invariant engine renders the
verdict: no dropped acks or queries, exactly-once ingest by post-run
audit, registry converged to one LIVE, retrain promoted mid-run,
latency and freshness bounds held.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
from typing import List, Optional

import numpy as np

from predictionio_tpu_torch.loadtest.harness import LatencyLedger, drive_open_loop
from predictionio_tpu_torch.loadtest.invariants import InvariantEngine
from predictionio_tpu_torch.loadtest.population import Population, arrival_offsets
from predictionio_tpu_torch.loadtest.scenario import Scenario
from predictionio_tpu_torch.obs import loadtest_stats
from predictionio_tpu_torch.obs.trace_context import record_event

logger = logging.getLogger(__name__)

__all__ = ["run_storm", "run_tenant_storm"]

#: events coalesced per batch POST (the SDK bulk-emitter shape)
EVENT_BATCH = 64


class _Lanes:
    """Precomputed arrival schedule split across the traffic mix —
    deterministic under the scenario seed."""

    def __init__(self, sc: Scenario):
        offsets = arrival_offsets(
            sc.duration_s, sc.base_rate, sc.amplitude,
            sc.effective_period_s, seed=sc.seed)
        rng = np.random.default_rng(sc.seed + 3)
        u = rng.random(len(offsets))
        self.event_offsets = offsets[u < sc.mix_events]
        self.query_offsets = offsets[
            (u >= sc.mix_events) & (u < sc.mix_events + sc.mix_queries)]
        self.feedback_offsets = offsets[u >= sc.mix_events + sc.mix_queries]
        self.total = len(offsets)


def run_storm(scenario: Scenario, fleet, *,
              ack_p99_bound_ms: float = 2000.0,
              query_p99_bound_ms: float = 2000.0,
              freshness_bound_s: float = 30.0,
              registry=None,
              check_freshness: bool = True) -> dict:
    """Drive one storm against a started :class:`LocalFleet` (or any
    object with its lane/incident surface) and return the report dict
    (``report["ok"]`` is the verdict)."""
    sc = scenario
    pop = Population(sc.population, sc.items, seed=sc.seed)
    lanes = _Lanes(sc)
    engine = InvariantEngine(registry)
    m_offered = loadtest_stats.loadtest_offered(registry)
    m_acked = loadtest_stats.loadtest_acked(registry)
    m_failed = loadtest_stats.loadtest_failed(registry)
    m_incidents = loadtest_stats.loadtest_incidents(registry)
    m_ack_hist = loadtest_stats.loadtest_ack_seconds(registry)
    m_query_hist = loadtest_stats.loadtest_query_seconds(registry)
    m_active = loadtest_stats.loadtest_active_users(registry)

    degrade = threading.Event()      #: degrade_quality incident in force
    ledger: List[str] = []           #: acked event ids (audit ground truth)
    ledger_lock = threading.Lock()
    timeout_s = sc.duration_s + 120.0

    # -- event lane ----------------------------------------------------------
    # payloads are pregenerated on this thread (deterministic, and the
    # Population's RNG is not shared across driver threads)
    event_batches: List[tuple] = []
    for i in range(0, len(lanes.event_offsets), EVENT_BATCH):
        offs = lanes.event_offsets[i:i + EVENT_BATCH]
        payloads = [
            pop.event_for(pop.next_user(), float(t)).to_dict()
            for t in offs]
        event_batches.append((float(offs[0]), payloads))

    def submit_events(batch) -> object:
        _off, payloads = batch
        if degrade.is_set():
            for p in payloads:
                props = p.setdefault("properties", {})
                props["rating"] = 1.0
        return fleet.submit_event_batch(payloads)

    def on_event_ack(_batch, fut) -> None:
        ids = fut.result()
        with ledger_lock:
            ledger.extend(ids)

    # -- query lane ----------------------------------------------------------
    query_items = [
        (uid, pop.query_for(uid))
        for uid in (pop.next_user() for _ in lanes.query_offsets)]

    def submit_query(item) -> object:
        return fleet.submit_query(item[1])

    def on_query_ack(item, fut) -> None:
        uid = item[0]
        try:
            scores = fut.result().get("itemScores") or []
        except Exception:
            return
        pop.record_recommendations(
            uid, [str(s.get("item")) for s in scores if s.get("item")])

    # -- feedback lane (built at submit time: needs the served slates) ------
    feedback_items = [
        (int(pop.next_user()), float(t)) for t in lanes.feedback_offsets]

    def submit_feedback(item) -> object:
        uid, at_s = item
        ev = pop.feedback_for(uid, at_s) or pop.event_for(uid, at_s)
        return fleet.submit_event_batch([ev.to_dict()])

    results = {}

    def _drive(name, items, submit, schedule, on_ack, weight=None):
        results[name] = drive_open_loop(
            items, submit, max_outstanding=sc.max_outstanding,
            timeout_s=timeout_s, schedule=schedule, on_ack=on_ack,
            weight=weight, ledger=LatencyLedger())

    threads = [
        threading.Thread(
            target=_drive, name="storm-events",
            args=("events", event_batches, submit_events,
                  [b[0] for b in event_batches], on_event_ack,
                  lambda b: len(b[1]))),
        threading.Thread(
            target=_drive, name="storm-queries",
            args=("queries", query_items, submit_query,
                  list(lanes.query_offsets), on_query_ack, None)),
        threading.Thread(
            target=_drive, name="storm-feedback",
            args=("feedback", feedback_items, submit_feedback,
                  list(lanes.feedback_offsets), on_event_ack, None)),
    ]

    # -- incident timeline ---------------------------------------------------
    retrain_threads: List[threading.Thread] = []
    restart_threads: List[threading.Thread] = []

    def _fire(incident) -> None:
        m_incidents.inc(kind=incident.kind)
        record_event("loadtest_incident", incident.to_dict())
        logger.info("incident @%.1fs: %s", incident.at_s, incident.kind)
        if incident.kind == "kill_replica":
            fleet.kill_replica(incident.target)
            if incident.restart_after_s > 0:
                def _restart():
                    time.sleep(incident.restart_after_s)
                    fleet.restart_replica(incident.target)
                    record_event("loadtest_incident", {
                        "kind": "restart_replica",
                        "target": incident.target})

                t = threading.Thread(target=_restart,
                                     name="storm-restart")
                t.start()
                restart_threads.append(t)
        elif incident.kind == "kill_compaction":
            fleet.kill_compaction()
        elif incident.kind == "retrain":
            t = threading.Thread(target=fleet.run_retrain_cycle,
                                 name="storm-retrain")
            t.start()
            retrain_threads.append(t)
        elif incident.kind == "burn_slo":
            t = threading.Thread(
                target=_burn_slo,
                args=(fleet, incident.duration_s or 2.0),
                name="storm-burn")
            t.start()
            restart_threads.append(t)
        elif incident.kind == "degrade_quality":
            degrade.set()
            if incident.duration_s > 0:
                def _clear():
                    time.sleep(incident.duration_s)
                    degrade.clear()

                t = threading.Thread(target=_clear, name="storm-undegrade")
                t.start()
                restart_threads.append(t)

    def _incident_loop(t_start: float) -> None:
        for incident in sc.incidents:
            wait = t_start + incident.at_s - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            try:
                _fire(incident)
            except Exception:
                logger.exception("incident %s failed", incident.kind)

    t_start = time.perf_counter()
    incident_thread = threading.Thread(
        target=_incident_loop, args=(t_start,), name="storm-incidents")
    incident_thread.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s + 30)
    incident_thread.join(30)
    for t in retrain_threads + restart_threads:
        t.join(180)
    wall_s = time.perf_counter() - t_start

    # -- settle + metrics ----------------------------------------------------
    fleet.drain_ingest()
    m_active.set(float(pop.active_users))
    for lane, res in results.items():
        m_offered.inc(res.offered, lane=lane)
        m_acked.inc(res.acked, lane=lane)
        if res.failed:
            m_failed.inc(res.failed, lane=lane)
        hist = m_query_hist if lane == "queries" else m_ack_hist
        for s in res.ledger.samples():
            hist.observe(s)

    # -- the verdict ---------------------------------------------------------
    engine.check_open_loop("no_dropped_acks", results["events"])
    engine.check_open_loop("no_dropped_queries", results["queries"])
    engine.check_open_loop("no_dropped_feedback", results["feedback"])
    with ledger_lock:
        ledger_ids = list(ledger)
    # the fleet's pre-storm seed inserts were acked too — the audit
    # expects their ids alongside the storm's own
    ledger_ids.extend(getattr(fleet, "seed_event_ids", ()))
    from predictionio_tpu_torch.storage.audit import audit_exactly_once

    audit = audit_exactly_once(
        fleet.event_store(), fleet.app_id, ledger_ids)
    engine.check_exactly_once(audit)
    engine.check_registry_converged(fleet.releases())
    if any(i.kind == "retrain" for i in sc.incidents):
        engine.check_retrain_promoted(fleet.cycles)
    engine.check_latency("ack_p99_bound",
                         results["events"].p99_ms(), ack_p99_bound_ms)
    engine.check_latency("query_p99_bound",
                         results["queries"].p99_ms(), query_p99_bound_ms)
    if check_freshness:
        engine.check_freshness(fleet.foldin_applied_rows(),
                               fleet.foldin_freshness_p95_s(),
                               freshness_bound_s)

    report = {
        "scenario": sc.to_dict(),
        "ok": engine.ok,
        "wall_s": round(wall_s, 2),
        "arrivals": lanes.total,
        "active_users": pop.active_users,
        "lanes": {name: res.as_dict() for name, res in results.items()},
        "audit": audit.as_dict(),
        "invariants": engine.report(),
        "cycles": [
            {"outcome": getattr(c, "outcome", None),
             "trigger": getattr(c, "trigger", None)}
            for c in fleet.cycles],
        "foldin_applied_rows": fleet.foldin_applied_rows(),
    }
    return report


def run_tenant_storm(scenario: Scenario, fleet, *,
                     query_p99_bound_ms: float = 2000.0,
                     registry=None) -> dict:
    """Drive a multi-tenant storm: one query lane PER TENANT, each with
    its own Zipf population/catalog and rate scale, against a fleet
    exposing ``submit_tenant_query(name, payload)`` (a started
    :class:`MultiTenantFleet`, or any consolidated host adapter).

    The only incident kind here is ``burn_slo`` with a ``tenant`` —
    the point of the storm is the blast-radius verdict: the burned
    tenant gets shed at the gate (429s observed as lane failures, and
    at least one rejection counted host-side), while every OTHER
    tenant's query p99 stays under the bound and drops nothing.
    """
    sc = scenario
    if not sc.tenants:
        raise ValueError("scenario has no tenants — use run_storm")
    for inc in sc.incidents:
        if inc.kind != "burn_slo":
            raise ValueError(
                f"tenant storms only support burn_slo incidents, "
                f"got {inc.kind!r}")
    burned = {inc.tenant for inc in sc.incidents if inc.tenant}
    engine = InvariantEngine(registry)
    m_incidents = loadtest_stats.loadtest_incidents(registry)
    timeout_s = sc.duration_s + 120.0
    results = {}
    pops = {}
    threads: List[threading.Thread] = []

    for idx, mix in enumerate(sc.tenants):
        # independent skews: each tenant gets its OWN seed lineage so
        # one tenant's head items say nothing about another's
        pop = Population(mix.population, mix.items,
                         seed=sc.seed + 101 * (idx + 1),
                         item_alpha=mix.item_alpha)
        pops[mix.name] = pop
        offsets = arrival_offsets(
            sc.duration_s, sc.base_rate * mix.rate_scale, sc.amplitude,
            sc.effective_period_s, seed=sc.seed + 13 * (idx + 1))
        items = [(uid, pop.query_for(uid))
                 for uid in (pop.next_user() for _ in offsets)]

        def _submit(item, name=mix.name):
            return fleet.submit_tenant_query(name, item[1])

        def _on_ack(item, fut, pop=pop):
            try:
                scores = fut.result().get("itemScores") or []
            except Exception:
                return
            pop.record_recommendations(
                item[0],
                [str(s.get("item")) for s in scores if s.get("item")])

        def _drive(name, items, submit, schedule, on_ack):
            results[name] = drive_open_loop(
                items, submit, max_outstanding=sc.max_outstanding,
                timeout_s=timeout_s, schedule=schedule, on_ack=on_ack,
                ledger=LatencyLedger())

        threads.append(threading.Thread(
            target=_drive, name=f"storm-queries-{mix.name}",
            args=(mix.name, items, _submit, list(offsets), _on_ack)))

    burn_threads: List[threading.Thread] = []

    def _incident_loop(t_start: float) -> None:
        for incident in sc.incidents:
            wait = t_start + incident.at_s - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            m_incidents.inc(kind=incident.kind)
            record_event("loadtest_incident", incident.to_dict())
            logger.info("incident @%.1fs: burn_slo tenant=%s",
                        incident.at_s, incident.tenant or "<all>")
            t = threading.Thread(
                target=fleet.burn_tenant,
                args=(incident.tenant, incident.duration_s or 2.0),
                name=f"storm-burn-{incident.tenant or 'all'}")
            t.start()
            burn_threads.append(t)

    t_start = time.perf_counter()
    incident_thread = threading.Thread(
        target=_incident_loop, args=(t_start,), name="storm-incidents")
    incident_thread.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s + 30)
    incident_thread.join(30)
    for t in burn_threads:
        t.join(60)
    wall_s = time.perf_counter() - t_start

    # -- the blast-radius verdict --------------------------------------------
    for mix in sc.tenants:
        res = results[mix.name]
        engine.check_open_loop(f"no_dropped_queries:{mix.name}", res)
        if mix.name in burned:
            # the burn MUST have tripped admission: rejections counted
            # host-side prove the 429 path, not just lane errors
            rejected = fleet.tenant_rejections(mix.name)
            engine.check(f"tenant_shed:{mix.name}", rejected > 0,
                         f"admission rejections={rejected}")
        else:
            engine.check_latency(f"tenant_p99:{mix.name}",
                                 res.p99_ms(), query_p99_bound_ms)
            engine.check(
                f"tenant_unshed:{mix.name}",
                fleet.tenant_rejections(mix.name) == 0,
                f"rejections={fleet.tenant_rejections(mix.name)}")

    return {
        "scenario": sc.to_dict(),
        "ok": engine.ok,
        "wall_s": round(wall_s, 2),
        "tenants": {name: {**res.as_dict(),
                           "activeUsers": pops[name].active_users,
                           "rejections": fleet.tenant_rejections(name)}
                    for name, res in results.items()},
        "invariants": engine.report(),
    }


def _burn_slo(fleet, duration_s: float) -> None:
    """Deliberately burn replica error budgets: malformed queries POSTed
    straight at each replica (not through the router, so the router's
    own accounting stays clean) until the window ends."""
    deadline = time.monotonic() + duration_s
    while time.monotonic() < deadline:
        for url in getattr(fleet, "replica_urls", []):
            try:
                req = urllib.request.Request(
                    f"{url}/queries.json", data=b"{not json",
                    method="POST",
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=2) as r:
                    r.read()
            except Exception:
                pass   # errors are the point
        time.sleep(0.05)


def storm_report_json(report: dict) -> str:
    return json.dumps(report, indent=2, sort_keys=True)
