"""The storm itself (port of the reference's ``loadtest/simulator.py``):
population × scenario × open-loop lanes × chaos × live invariants,
producing one verdict dict.

Three concurrent open-loop lanes, in a process of their own, drive the
fleet the way production traffic would:

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
import subprocess
import sys
import threading
import time
import urllib.request
from typing import List, Optional

import numpy as np

from predictionio_tpu_torch.loadtest.harness import (
    LatencyLedger, OpenLoopResult, child_env, drive_open_loop, read_line,
)
from predictionio_tpu_torch.loadtest.invariants import InvariantEngine
from predictionio_tpu_torch.loadtest.population import Population, arrival_offsets
from predictionio_tpu_torch.loadtest.scenario import Scenario
from predictionio_tpu_torch.obs import loadtest_stats
from predictionio_tpu_torch.obs.trace_context import record_event

logger = logging.getLogger(__name__)

__all__ = ["run_storm", "run_tenant_storm"]

#: events coalesced per batch POST (the SDK bulk-emitter shape)
EVENT_BATCH = 64

#: seconds an HTTP exchange of the storm's traffic may take
HTTP_TIMEOUT_S = 60.0

#: seconds the traffic process may take to start its lanes (it builds
#: every event payload first)
TRAFFIC_START_S = 120.0


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
              check_freshness: bool = True,
              query_times: Optional[list] = None) -> dict:
    """Drive one storm against a started :class:`LocalFleet` (or any
    object with its ``event_url``/``router_url``/``access_key`` and
    incident surface) and return the report dict (``report["ok"]`` is
    the verdict).

    The three lanes run in a process of their own (``_traffic_main``),
    as the fleet's callers would: in the fleet's process their sends,
    reads and callbacks would share its GIL with the servers under test
    and be counted in their latency. This process walks the incident
    timeline on the lanes' clock and renders the verdict. A
    ``query_times`` list gets each query's ``[submit offset, seconds]``
    on the lanes' clock."""
    sc = scenario
    lanes = _Lanes(sc)
    engine = InvariantEngine(registry)
    m_offered = loadtest_stats.loadtest_offered(registry)
    m_acked = loadtest_stats.loadtest_acked(registry)
    m_failed = loadtest_stats.loadtest_failed(registry)
    m_incidents = loadtest_stats.loadtest_incidents(registry)
    m_ack_hist = loadtest_stats.loadtest_ack_seconds(registry)
    m_query_hist = loadtest_stats.loadtest_query_seconds(registry)
    m_active = loadtest_stats.loadtest_active_users(registry)
    timeout_s = sc.duration_s + 120.0

    traffic = _TrafficProcess({
        "scenario": sc.to_dict(), "event_url": fleet.event_url,
        "router_url": fleet.router_url, "access_key": fleet.access_key,
        "timeout_s": timeout_s})

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
            # pio: ignore[PIO003]: a load-generator thread; no request trace
            t = threading.Thread(
                target=_burn_slo,
                args=(fleet, incident.duration_s or 2.0),
                name="storm-burn")
            t.start()
            restart_threads.append(t)
        elif incident.kind == "degrade_quality":
            traffic.set_degrade(True)
            if incident.duration_s > 0:
                def _clear():
                    time.sleep(incident.duration_s)
                    traffic.set_degrade(False)

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

    try:
        traffic.wait_started()
        t_start = time.perf_counter()
        incident_thread = threading.Thread(
            target=_incident_loop, args=(t_start,), name="storm-incidents")
        incident_thread.start()
        out = traffic.result(timeout_s + 60)
    finally:
        traffic.close()
    incident_thread.join(30)
    for t in retrain_threads + restart_threads:
        t.join(180)
    wall_s = time.perf_counter() - t_start
    results = {name: _lane_result(lane)
               for name, lane in out["lanes"].items()}

    # -- settle + metrics ----------------------------------------------------
    fleet.drain_ingest()
    m_active.set(float(out["active_users"]))
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
    ledger_ids = list(out["ledger"])
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
        "active_users": out["active_users"],
        "lanes": {name: res.as_dict() for name, res in results.items()},
        "audit": audit.as_dict(),
        "invariants": engine.report(),
        "cycles": [
            {"outcome": getattr(c, "outcome", None),
             "trigger": getattr(c, "trigger", None)}
            for c in fleet.cycles],
        "foldin_applied_rows": fleet.foldin_applied_rows(),
    }
    if query_times is not None:
        query_times.extend(out["query_times"])
    return report


def _lane_result(lane: dict) -> OpenLoopResult:
    """A lane's result as the traffic process reported it."""
    ledger = LatencyLedger()
    for seconds in lane["samples"]:
        ledger.record(seconds)
    return OpenLoopResult(
        offered=lane["offered"], acked=lane["acked"],
        failed=lane["failed"], wall_s=lane["wall_s"], ledger=ledger,
        timed_out=lane["timed_out"])


class _TrafficProcess:
    """The storm's lanes in a child process (``_traffic_main``): its
    settings go in as one JSON line on stdin, ``degrade 1``/``degrade
    0`` lines follow; it prints ``started`` when the lanes start and
    its result as one JSON line when they end."""

    def __init__(self, spec: dict):
        self.proc = subprocess.Popen(
            [sys.executable, "-c",
             f"import sys; from {__name__} import _traffic_main; "
             "sys.exit(_traffic_main())"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=child_env(),
            start_new_session=True)
        self._lock = threading.Lock()
        self._send(json.dumps(spec))

    def _send(self, line: str) -> None:
        with self._lock:
            try:
                self.proc.stdin.write((line + "\n").encode())
                self.proc.stdin.flush()
            except (BrokenPipeError, ValueError):
                pass        # the child ended: its result says why

    def wait_started(self) -> None:
        line = read_line(self.proc.stdout, TRAFFIC_START_S)
        if line.strip() != "started":
            raise RuntimeError(f"the storm's traffic process never "
                               f"started (said {line!r})")

    def set_degrade(self, on: bool) -> None:
        self._send(f"degrade {int(bool(on))}")

    def result(self, timeout_s: float) -> dict:
        line = read_line(self.proc.stdout, timeout_s)
        if not line.strip():
            raise RuntimeError("the storm's traffic process ended without "
                               "a result")
        return json.loads(line)

    def close(self) -> None:
        with self._lock:
            try:
                self.proc.stdin.close()
            except (BrokenPipeError, ValueError):
                pass
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.proc.stdout.close()


class _TrafficClient:
    """The lanes' HTTP client on a loop thread of its own: event batches
    to the event server (a 429 retries after its Retry-After: shedding
    is backpressure, not loss), queries through the router."""

    def __init__(self, event_url: str, router_url: str, access_key: str):
        import asyncio

        from predictionio_tpu_torch.server.http_client import HttpClient

        self.event_url, self.router_url = event_url, router_url
        self.access_key = access_key
        self._loop = asyncio.new_event_loop()
        # pio: ignore[PIO003]: the load generator's loop; no request trace
        self._thread = threading.Thread(
            target=self._loop.run_forever, name="storm-client", daemon=True)
        self._thread.start()

        async def _mk():
            return HttpClient()

        self._client = self._call(_mk()).result(10)

    def _call(self, coro):
        import asyncio

        return asyncio.run_coroutine_threadsafe(coro, self._loop)

    async def _post_json(self, url: str, payload) -> tuple:
        resp = await self._client.request("POST", url, json_body=payload,
                                          timeout=HTTP_TIMEOUT_S)
        try:
            body = resp.json()
        except ValueError:
            body = resp.body.decode(errors="replace")
        return resp, body

    def submit_event_batch(self, payloads: List[dict]):
        """A Future resolving to the acked event ids."""
        return self._call(self._post_events(payloads))

    async def _post_events(self, payloads: List[dict]) -> List[str]:
        import asyncio

        url = (f"{self.event_url}/batch/events.json"
               f"?accessKey={self.access_key}")
        for _attempt in range(60):
            resp, body = await self._post_json(url, payloads)
            if resp.status == 429:
                retry_after = float(
                    resp.headers.get("retry-after", 0.1) or 0.1)
                await asyncio.sleep(min(max(retry_after, 0.02), 0.5))
                continue
            if resp.status != 200:
                raise RuntimeError(
                    f"batch ingest HTTP {resp.status}: {body}")
            ids = []
            for entry in body:
                if entry.get("status") != 201:
                    raise RuntimeError(f"event rejected: {entry}")
                ids.append(entry["eventId"])
            return ids
        raise RuntimeError("batch ingest shed 60 times — queue_max too "
                           "small for the offered load")

    def submit_query(self, payload: dict):
        """A Future resolving to the parsed answer (raises on a non-200,
        so failures are counted)."""
        return self._call(self._post_query(payload))

    async def _post_query(self, payload: dict) -> dict:
        resp, body = await self._post_json(
            f"{self.router_url}/queries.json", payload)
        if resp.status != 200:
            raise RuntimeError(f"query HTTP {resp.status}: {body}")
        return body

    def close(self) -> None:
        self._call(self._client.close()).result(10)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(10)
        self._loop.close()


def _drive_lanes(sc: Scenario, client, degrade: threading.Event,
                 timeout_s: float, on_start) -> dict:
    """The three open-loop lanes against ``client``
    (:class:`_TrafficClient`); ``on_start()`` runs just before they
    start. Returns each lane's counts and latency samples, the acked
    event ids, the woken users and each query's ``[offset, seconds]``."""
    pop = Population(sc.population, sc.items, seed=sc.seed)
    lanes = _Lanes(sc)
    ledger: List[str] = []           #: acked event ids (audit ground truth)
    ledger_lock = threading.Lock()

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
        return client.submit_event_batch(payloads)

    def on_event_ack(_batch, fut) -> None:
        ids = fut.result()
        with ledger_lock:
            ledger.extend(ids)

    # -- query lane ----------------------------------------------------------
    query_items = [
        (uid, pop.query_for(uid))
        for uid in (pop.next_user() for _ in lanes.query_offsets)]
    query_times: List[list] = []
    t0 = [0.0]

    def submit_query(item) -> object:
        t = time.perf_counter()
        fut = client.submit_query(item[1])
        fut.add_done_callback(lambda _f, t=t: query_times.append(
            [round(t - t0[0], 6), round(time.perf_counter() - t, 6)]))
        return fut

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
        return client.submit_event_batch([ev.to_dict()])

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
    on_start()
    t0[0] = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s + 30)
    with ledger_lock:
        ids = list(ledger)
    return {
        "lanes": {name: {"offered": res.offered, "acked": res.acked,
                         "failed": res.failed, "wall_s": res.wall_s,
                         "timed_out": res.timed_out,
                         "samples": res.ledger.samples()}
                  for name, res in results.items()},
        "ledger": ids, "active_users": pop.active_users,
        "query_times": sorted(query_times)}


def _traffic_main() -> int:
    """The storm's traffic process (``_TrafficProcess``)."""
    spec = json.loads(sys.stdin.readline())
    sc = Scenario.from_dict(spec["scenario"])
    degrade = threading.Event()

    def _commands() -> None:
        for line in sys.stdin:
            cmd = line.split()
            if cmd[:1] == ["degrade"]:
                (degrade.set if cmd[1:] == ["1"] else degrade.clear)()

    threading.Thread(target=_commands, name="storm-commands",
                     daemon=True).start()
    client = _TrafficClient(spec["event_url"], spec["router_url"],
                            spec["access_key"])

    def started() -> None:
        # pio: ignore[PIO100]: the parent waits for "started" on stdout
        print("started", flush=True)

    try:
        out = _drive_lanes(sc, client, degrade, spec["timeout_s"],
                           on_start=started)
    finally:
        client.close()
    # pio: ignore[PIO100]: the parent reads the JSON result off stdout
    print(json.dumps(out), flush=True)
    return 0


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
            # pio: ignore[PIO003]: a load-generator thread; no request trace
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
