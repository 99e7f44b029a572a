"""Serving-fleet router tier: one front door over N query-server replicas
(port of the reference's ``server/router.py``, on the port's
``server/http`` server and ``server/http_client`` client: the machine
with the card has no aiohttp).

* **Spread** — queries fan out over the replicas through
  :class:`WeightedSplitter`, the canary splitter's error-diffusion
  discipline generalized to N arms: every arm accumulates
  ``weight/total`` credit per query and the largest accumulator wins,
  so over any window each replica serves exactly ``round(N * share)``
  (±1) queries — no RNG, and a restarted router resumes the EXACT
  mid-stream split because the accumulators persist through the durable
  telemetry store (``pio_router_splitter_acc``).
* **Health** — every replica is probed at ``/slo.json`` +
  ``/deploy/status.json``; ``health_fail_after`` consecutive failures
  eject it from rotation, the first healthy probe re-admits it, and a
  replica that keeps failing is probed at exponentially growing gaps
  (capped). A failed proxy attempt (an error, or an answer >= 500)
  retries on OTHER replicas (``proxy_retries``) before surfacing.
* **Fleet cutovers** — ``POST /deploy.json`` / ``/rollback.json`` on
  the router sequence the cutover one replica at a time in rank order,
  aborting (and rolling back the already-cut replicas) on the first
  failure, so replicas never diverge past one rank.
* **One trace id** — the proxy forwards the request's trace context in
  ``X-Pio-Trace`` (``obs/middleware`` adopts it on the replica); the
  replicas the router spawns inherit it via
  ``parallel/distributed.worker_env``.
* **Autoscaling** — with a ``deploy/fleet.FleetController`` attached,
  the router feeds it burn/QPS signals off the health probes and
  executes its scale decisions: grow spawns + waits healthy, shrink
  DRAINS the victim (weight zero, in-flight runs to completion) before
  stopping it — zero dropped queries across a scale-down.

The router computes nothing: it imports no torch and never touches the
card. Every knob is ``PIO_ROUTER_*`` / server.json ``router``
(``utils.server_config.RouterConfig``); metrics are the
``pio_router_*`` family.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Optional, Tuple

from predictionio_tpu_torch.obs.middleware import (
    metrics_routes, observability_middleware,
)
from predictionio_tpu_torch.obs.registry import (
    MetricsRegistry, default_registry,
)
from predictionio_tpu_torch.obs.trace_context import (
    TRACE_HEADER, record_event,
)
from predictionio_tpu_torch.obs.tracing import capture_context, carried
from predictionio_tpu_torch.server.http import (
    HttpServer, RawBody, Request, serve_until_stopped,
)
from predictionio_tpu_torch.server.http_client import (
    HttpClient, HttpClientError,
)
from predictionio_tpu_torch.utils.server_config import RouterConfig

logger = logging.getLogger("pio.router")

#: default port a router listens on (replicas live at base_port + rank)
DEFAULT_ROUTER_PORT = 8100

#: how long a scale-up waits for the new replica's first healthy probe
SPAWN_HEALTHY_TIMEOUT_S = 60.0

#: per-probe and per-proxy HTTP timeouts — probes must be fast enough
#: that a hung replica cannot stall the whole health sweep
PROBE_TIMEOUT_S = 5.0
PROXY_TIMEOUT_S = 30.0

#: what a failed replica exchange raises (the reference catches
#: aiohttp.ClientError, asyncio.TimeoutError and OSError)
_EXCHANGE_ERRORS = (HttpClientError, asyncio.TimeoutError, OSError)


class WeightedSplitter:
    """The canary error-diffusion splitter generalized to N arms.

    Each :meth:`route` call adds ``weight/total`` credit to every arm
    and picks the arm with the most accumulated credit (ties break on
    the lowest arm id), then debits the winner by 1 — stride
    scheduling, so over any window of N routes each arm serves within
    ±1 of its exact share, deterministically. Arms with zero weight
    (draining or ejected replicas) accrue nothing and can never win.

    The accumulators are the ONLY state; :meth:`state` / :meth:`restore`
    round-trip them through the telemetry store so a restarted router
    resumes the split mid-stream instead of re-seeding at zero.
    """

    def __init__(self, weights: Optional[Dict[int, float]] = None):
        self._weights: Dict[int, float] = {}
        self._acc: Dict[int, float] = {}
        if weights:
            self.set_weights(weights)

    def set_weights(self, weights: Dict[int, float]) -> None:
        """Replace the arm set; surviving arms keep their accumulated
        credit (a scale event must not reshuffle the in-progress
        diffusion of the arms that stay)."""
        self._weights = {int(a): max(0.0, float(w))
                         for a, w in weights.items()}
        self._acc = {a: self._acc.get(a, 0.0) for a in self._weights}

    def route(self, eligible=None) -> Optional[int]:
        """The arm this query goes to, or None when no arm is routable.
        ``eligible`` restricts the draw (retry excluding the arm that
        just failed) without disturbing the other arms' credit."""
        arms = [a for a, w in self._weights.items()
                if w > 0 and (eligible is None or a in eligible)]
        if not arms:
            return None
        total = sum(self._weights[a] for a in arms)
        best = None
        for arm in sorted(arms):
            self._acc[arm] += self._weights[arm] / total
            if best is None or self._acc[arm] > self._acc[best]:
                best = arm
        self._acc[best] -= 1.0
        return best

    def state(self) -> Dict[int, float]:
        return dict(self._acc)

    def restore(self, accs: Dict[int, float]) -> None:
        """Re-seed surviving arms' accumulators from a persisted
        :meth:`state`; junk values (non-numeric, |acc| >= arm count + 1)
        are ignored — a corrupt snapshot must not be worse than the
        cold start it replaces."""
        bound = len(self._acc) + 1.0
        for arm, acc in accs.items():
            try:
                arm = int(arm)
                acc = float(acc)
            except (TypeError, ValueError):
                continue
            if arm in self._acc and abs(acc) < bound:
                self._acc[arm] = acc


@dataclasses.dataclass
class ReplicaHandle:
    """One replica's liveness state as the router sees it."""

    rank: int
    url: str
    proc: object = None             # Popen when the router spawned it
    healthy: bool = False
    fails: int = 0
    draining: bool = False
    inflight: int = 0
    slo: Optional[dict] = None
    deploy_status: Optional[dict] = None
    #: monotonic instant before which the health loop skips this
    #: replica — exponential probe backoff for a dead port
    next_probe_at: float = 0.0

    def to_json(self) -> dict:
        active = (self.deploy_status or {}).get("active") or {}
        return {
            "rank": self.rank,
            "url": self.url,
            "healthy": self.healthy,
            "draining": self.draining,
            "inflight": self.inflight,
            "consecutiveFailures": self.fails,
            "sloBreached": bool((self.slo or {}).get("breached")),
            "releaseVersion": active.get("releaseVersion"),
        }


class Router:
    """The router tier (module docstring). ``spawn(rank) -> url |
    ReplicaHandle`` and ``stop(handle)`` are the replica lifecycle
    seams: ``pio router`` injects a ``deploy`` subprocess spawner
    (``cli/main.py``), tests inject in-process stub servers, and a
    router can also front existing replicas via ``replica_urls``.

    ``await start(host, port)`` runs the start-up (splitter restore,
    spawns, the health and fleet loops) and binds, returning the port;
    ``await close()`` stops the loops and the replicas it spawned.
    """

    def __init__(self, config: Optional[RouterConfig] = None,
                 registry: Optional[MetricsRegistry] = None,
                 telemetry=None,
                 spawn: Optional[Callable] = None,
                 stop: Optional[Callable] = None,
                 fleet=None,
                 replica_urls=()):
        self.cfg = config or RouterConfig.from_env()
        self.registry = registry or MetricsRegistry()
        self._telemetry = telemetry
        self._spawn = spawn
        self._stop = stop
        self.fleet = fleet
        self.replicas: Dict[int, ReplicaHandle] = {}
        self.splitter = WeightedSplitter()
        self._client: Optional[HttpClient] = None
        self._health_task: Optional[asyncio.Task] = None
        self._fleet_task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._qps_sample = (time.monotonic(), 0.0)
        self.stopped = asyncio.Event()

        r = self.registry
        self._requests = r.counter(
            "pio_router_requests_total",
            "Queries proxied by replica and upstream HTTP status",
            labelnames=("replica", "status"))
        self._proxy_hist = r.histogram(
            "pio_router_proxy_duration_seconds",
            "Router-to-replica proxy wall time (queue + replica + wire)",
            labelnames=("replica",))
        self._retries = r.counter(
            "pio_router_retries_total",
            "Proxy attempts retried on another replica after a failure")
        self._dropped = r.counter(
            "pio_router_dropped_total",
            "Queries failed with no routable replica left to try")
        self._healthy_g = r.gauge(
            "pio_router_replica_healthy",
            "1 while the replica is in rotation, 0 while ejected",
            labelnames=("replica",))
        self._replicas_g = r.gauge(
            "pio_router_replicas",
            "Replicas currently attached (healthy or not)")
        self._acc_g = r.gauge(
            "pio_router_splitter_acc",
            "Error-diffusion accumulator per replica — persisted "
            "through the telemetry store so a restarted router resumes "
            "the exact mid-stream split",
            labelnames=("replica",))
        self._health_total = r.counter(
            "pio_router_health_checks_total",
            "Replica health probes by outcome",
            labelnames=("replica", "outcome"))
        self._deploys = r.counter(
            "pio_router_deploys_total",
            "Fleet-sequenced cutovers by action and outcome",
            labelnames=("action", "outcome"))

        for i, url in enumerate(replica_urls):
            self._attach(ReplicaHandle(rank=i, url=str(url).rstrip("/")))

        self._http = HttpServer(
            self._routes(),
            middleware=observability_middleware(self.registry, "router"))

    # -- membership ----------------------------------------------------------
    def _attach(self, handle: ReplicaHandle) -> ReplicaHandle:
        self.replicas[handle.rank] = handle
        self._rebuild_weights()
        return handle

    def _rebuild_weights(self) -> None:
        self.splitter.set_weights({
            rank: 0.0 if h.draining else 1.0
            for rank, h in self.replicas.items()})
        self._replicas_g.set(float(len(self.replicas)))
        for rank, h in self.replicas.items():
            self._healthy_g.set(
                1.0 if h.healthy and not h.draining else 0.0,
                replica=str(rank))
        self._publish_acc()

    def _publish_acc(self) -> None:
        for rank, acc in self.splitter.state().items():
            self._acc_g.set(acc, replica=str(rank))

    def active_count(self) -> int:
        return sum(1 for h in self.replicas.values() if not h.draining)

    def _restore_splitter(self) -> None:
        """Re-seed the diffusion accumulators from the durable
        telemetry store: the last persisted ``pio_router_splitter_acc``
        point per replica wins."""
        if not self.cfg.persist_splitter or self._telemetry is None:
            return
        try:
            accs: Dict[int, float] = {}
            for info in self._telemetry.reader().series(
                    "pio_router_splitter_acc"):
                rep = info.labels.get("replica")
                if rep is None or not info.points:
                    continue
                accs[int(rep)] = float(info.points[-1][1])
            if accs:
                self.splitter.restore(accs)
                self._publish_acc()
                logger.info("splitter state restored for %d replica(s)",
                            len(accs))
        except Exception:
            logger.exception("splitter state restore failed; "
                             "starting from zero accumulators")

    # -- lifecycle -----------------------------------------------------------
    async def start(self, host: str = "localhost",
                    port: int = DEFAULT_ROUTER_PORT) -> int:
        self._loop = asyncio.get_running_loop()
        self._client = HttpClient()
        self._restore_splitter()
        if self._spawn is not None and not self.replicas:
            for _ in range(self.cfg.replicas):
                await self.grow(wait_healthy=False)
        self._health_task = self._loop.create_task(self._health_loop())
        if self.fleet is not None:
            self._fleet_task = self._loop.create_task(self._fleet_loop())
        return await self._http.start(host, port)

    async def close(self) -> None:
        await self._http.close()
        for task in (self._health_task, self._fleet_task):
            if task is not None:
                task.cancel()
                try:
                    await task
                except (asyncio.CancelledError, Exception):
                    pass
        for handle in list(self.replicas.values()):
            if handle.proc is not None:
                await self._terminate(handle)
        if self._client is not None:
            await self._client.close()
        if self._telemetry is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, self._telemetry.stop)

    def _routes(self) -> list:
        from predictionio_tpu_torch.obs.telemetry import (
            history_reader_factory, history_routes,
        )

        return [
            ("GET", "/", self.handle_root),
            ("POST", "/queries.json", self.handle_query),
            # multi-tenant replicas: the tenant path segment rides
            # through to the replica's own gate
            ("POST", "/t/{tenant}/queries.json", self.handle_tenant_query),
            ("GET", "/slo.json", self.handle_slo),
            ("GET", "/fleet/status.json", self.handle_fleet_status),
            ("POST", "/deploy.json", self.handle_deploy),
            ("POST", "/rollback.json", self.handle_rollback),
            *metrics_routes(self.registry, default_registry()),
            *history_routes(history_reader_factory(self._telemetry)),
        ]

    # -- spawn / drain (the fleet controller's actuation surface) ------------
    async def grow(self, wait_healthy: bool = True) -> int:
        """Attach one more replica via the spawner; returns its rank.
        ``wait_healthy`` blocks until its first healthy probe (the
        scale-up contract: capacity exists before the action commits)."""
        if self._spawn is None:
            raise RuntimeError("router has no replica spawner")
        rank = max(self.replicas) + 1 if self.replicas else 0
        spawned = self._spawn(rank)
        if isinstance(spawned, ReplicaHandle):
            spawned.rank = rank
            handle = spawned
        else:
            handle = ReplicaHandle(rank=rank, url=str(spawned).rstrip("/"))
        handle.url = handle.url.rstrip("/")
        self._attach(handle)
        logger.info("replica %d attached at %s", rank, handle.url)
        if wait_healthy:
            ok = await self.wait_replica_healthy(rank)
            if not ok:
                raise RuntimeError(
                    f"replica {rank} ({handle.url}) never became healthy "
                    f"within {SPAWN_HEALTHY_TIMEOUT_S:g}s")
        return rank

    async def wait_replica_healthy(
            self, rank: int,
            timeout_s: float = SPAWN_HEALTHY_TIMEOUT_S) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            handle = self.replicas.get(rank)
            if handle is None:
                return False
            if await self._probe(handle):
                return True
            await asyncio.sleep(
                min(0.1, max(0.01, self.cfg.health_interval_s / 4)))
        return False

    async def drain(self, rank: int,
                    timeout_s: Optional[float] = None) -> bool:
        """Scale-down one replica with the zero-drop discipline: weight
        to zero FIRST (no new queries), in-flight queries run to
        completion (bounded by ``drain_timeout_s``), then stop. Returns
        True when the drain completed with nothing in flight."""
        handle = self.replicas.get(rank)
        if handle is None:
            return True
        handle.draining = True
        self._rebuild_weights()
        deadline = time.monotonic() + (
            self.cfg.drain_timeout_s if timeout_s is None else timeout_s)
        while handle.inflight > 0 and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        drained = handle.inflight == 0
        if not drained:
            logger.warning("replica %d drain timed out with %d in flight",
                           rank, handle.inflight)
        await self._terminate(handle)
        self.replicas.pop(rank, None)
        self._healthy_g.set(0.0, replica=str(rank))
        self._rebuild_weights()
        logger.info("replica %d drained and detached (%s)", rank,
                    "clean" if drained else "timeout")
        return drained

    async def _terminate(self, handle: ReplicaHandle) -> None:
        if self._stop is not None:
            try:
                out = self._stop(handle)
                if asyncio.iscoroutine(out):
                    await out
            except Exception:
                logger.exception("replica %d stop hook failed",
                                 handle.rank)
        elif handle.proc is not None:
            try:
                handle.proc.terminate()
                await asyncio.get_running_loop().run_in_executor(
                    None, handle.proc.wait, 10)
            except Exception:
                logger.exception("replica %d terminate failed",
                                 handle.rank)
        handle.proc = None

    # -- health --------------------------------------------------------------
    async def _get_json(self, handle: ReplicaHandle, path: str) -> Any:
        resp = await self._client.request(
            "GET", f"{handle.url}{path}", timeout=PROBE_TIMEOUT_S)
        if resp.status != 200:
            raise HttpClientError(f"{path} {resp.status}")
        return resp.json()

    async def _probe(self, handle: ReplicaHandle) -> bool:
        """One readiness probe: both surfaces a deployed query server
        exposes must answer — /slo.json (burn state feeds the fleet
        controller) and /deploy/status.json (a replica mid-cutover is
        not ready)."""
        try:
            slo = await self._get_json(handle, "/slo.json")
            status = await self._get_json(handle, "/deploy/status.json")
        except _EXCHANGE_ERRORS + (ValueError,):
            handle.fails += 1
            self._health_total.inc(replica=str(handle.rank),
                                   outcome="fail")
            # exponential backoff: a replica that keeps failing gets
            # probed at interval, 2x, 4x ... capped, and one successful
            # probe resets the schedule
            backoff = min(
                self.cfg.health_backoff_cap_s,
                self.cfg.health_interval_s * (2 ** max(0, handle.fails - 1)))
            handle.next_probe_at = time.monotonic() + backoff
            if handle.healthy \
                    and handle.fails >= self.cfg.health_fail_after:
                handle.healthy = False
                self._rebuild_weights()
                logger.warning("replica %d ejected after %d failed "
                               "probes (probe backoff up to %.1fs)",
                               handle.rank, handle.fails,
                               self.cfg.health_backoff_cap_s)
            return False
        handle.slo = slo if isinstance(slo, dict) else None
        handle.deploy_status = status if isinstance(status, dict) else None
        handle.fails = 0
        handle.next_probe_at = 0.0
        self._health_total.inc(replica=str(handle.rank), outcome="ok")
        if not handle.healthy:
            handle.healthy = True
            self._rebuild_weights()
        return True

    async def _health_loop(self) -> None:
        while True:
            await asyncio.sleep(self.cfg.health_interval_s)
            now = time.monotonic()
            for handle in list(self.replicas.values()):
                if handle.draining or now < handle.next_probe_at:
                    continue
                try:
                    await self._probe(handle)
                except Exception:
                    logger.exception("health probe for replica %d blew "
                                     "up", handle.rank)

    # -- the fleet controller loop -------------------------------------------
    def fleet_signals(self):
        """One observation for the autoscaler: fleet QPS from the
        router's own request counter delta, burn from the replicas'
        last /slo.json probes."""
        from predictionio_tpu_torch.deploy.fleet import FleetSignals

        now = time.monotonic()
        total = sum(v for _, v in self._requests.samples())
        last_t, last_total = self._qps_sample
        self._qps_sample = (now, total)
        dt = max(1e-6, now - last_t)
        burning = any(bool((h.slo or {}).get("breached"))
                      for h in self.replicas.values()
                      if h.healthy and not h.draining)
        return FleetSignals(
            burning=burning,
            qps=max(0.0, total - last_total) / dt,
            healthy=sum(1 for h in self.replicas.values()
                        if h.healthy and not h.draining))

    async def _fleet_loop(self) -> None:
        self.fleet.bind(FleetRouterActuator(self, self._loop))
        await self._loop.run_in_executor(None, self.fleet.recover)
        while True:
            await asyncio.sleep(self.cfg.health_interval_s)
            signals = self.fleet_signals()
            ctx = capture_context()
            try:
                # the tick blocks on spawn/drain — keep it off the loop
                # (the proxy hot path keeps serving THROUGH a scale
                # action)
                await self._loop.run_in_executor(
                    None, lambda: self._fleet_tick(ctx, signals))
            except Exception:
                logger.exception("fleet controller tick failed")

    def _fleet_tick(self, ctx, signals) -> None:
        with carried(ctx, "fleet_tick", record=False):
            self.fleet.tick(signals)

    # -- handlers ------------------------------------------------------------
    async def handle_root(self, _req: Request) -> Tuple[int, Any]:
        return 200, {
            "service": "router",
            "replicas": [h.to_json()
                         for _, h in sorted(self.replicas.items())],
        }

    async def handle_query(self, req: Request) -> Tuple[int, Any]:
        return await self._proxy_query(req, "/queries.json")

    async def handle_tenant_query(self, req: Request) -> Tuple[int, Any]:
        tenant = req.params["tenant"]
        return await self._proxy_query(req, f"/t/{tenant}/queries.json")

    async def _proxy_query(self, req: Request, path: str
                           ) -> Tuple[int, Any]:
        headers = {"Content-Type": "application/json"}
        ctx = capture_context()
        if ctx is not None:
            # one trace id spans router -> replica -> device: the
            # replica's middleware adopts this as its parent
            headers[TRACE_HEADER] = ctx.encode()
        tried: set = set()
        attempts = 1 + self.cfg.proxy_retries
        last_error = "no routable replica"
        for attempt in range(attempts):
            eligible = {rank for rank, h in self.replicas.items()
                        if h.healthy and not h.draining
                        and rank not in tried}
            rank = self.splitter.route(eligible=eligible)
            if rank is None:
                break
            if attempt > 0:
                self._retries.inc()
            self._publish_acc()
            handle = self.replicas[rank]
            tried.add(rank)
            handle.inflight += 1
            t0 = time.perf_counter()
            try:
                resp = await self._client.request(
                    "POST", f"{handle.url}{path}", body=req.body,
                    headers=headers, params=req.query,
                    timeout=PROXY_TIMEOUT_S)
                if resp.status >= 500:
                    raise HttpClientError(
                        f"replica {rank} answered {resp.status}")
                self._requests.inc(replica=str(rank),
                                   status=str(resp.status))
                return resp.status, RawBody(resp.body, "application/json")
            except _EXCHANGE_ERRORS as e:
                last_error = str(e) or type(e).__name__
                self._requests.inc(replica=str(rank), status="error")
                handle.fails += 1
                if handle.healthy \
                        and handle.fails >= self.cfg.health_fail_after:
                    handle.healthy = False
                    self._rebuild_weights()
                    logger.warning("replica %d ejected on proxy "
                                   "failures: %s", rank, last_error)
            finally:
                handle.inflight -= 1
                self._proxy_hist.observe(time.perf_counter() - t0,
                                         replica=str(rank))
        self._dropped.inc()
        return 503, {"message":
                     f"no replica could serve the query: {last_error}"}

    async def handle_slo(self, _req: Request) -> Tuple[int, Any]:
        """The fleet burn view: breached when ANY in-rotation replica
        reports a burn (the scale-up trigger reads the same signal)."""
        docs = {str(rank): h.slo
                for rank, h in sorted(self.replicas.items())
                if h.slo is not None}
        breached = any(bool((d or {}).get("breached"))
                       for d in docs.values())
        return 200, {"breached": breached, "replicas": docs}

    async def handle_fleet_status(self, _req: Request) -> Tuple[int, Any]:
        doc = {
            "replicas": [h.to_json()
                         for _, h in sorted(self.replicas.items())],
            "splitter": {str(a): acc
                         for a, acc in self.splitter.state().items()},
            "config": {
                "replicas": self.cfg.replicas,
                "healthIntervalS": self.cfg.health_interval_s,
                "healthFailAfter": self.cfg.health_fail_after,
                "proxyRetries": self.cfg.proxy_retries,
                "drainTimeoutS": self.cfg.drain_timeout_s,
            },
        }
        if self.fleet is not None:
            doc["autoscaler"] = self.fleet.status()
        return 200, doc

    @staticmethod
    def _body(req: Request) -> dict:
        try:
            return req.json()
        except ValueError:
            return {}

    async def handle_deploy(self, req: Request) -> Tuple[int, Any]:
        return await self._sequenced("/deploy.json", self._body(req),
                                     "deploy", req)

    async def handle_rollback(self, req: Request) -> Tuple[int, Any]:
        return await self._sequenced("/rollback.json", self._body(req),
                                     "rollback", req)

    async def _sequenced(self, path: str, body: dict, action: str,
                         req: Request) -> Tuple[int, Any]:
        """The fleet-consistent cutover: one replica at a time in rank
        order; the first failure aborts the remainder and rolls the
        already-cut replicas back, so the fleet can never diverge past
        one rank. Recorded as a flight-recorder event under the
        request's trace id."""
        ranks = [rank for rank, h in sorted(self.replicas.items())
                 if not h.draining]
        results = []
        done = []
        for rank in ranks:
            handle = self.replicas.get(rank)
            if handle is None:
                continue
            try:
                resp = await self._client.request(
                    "POST", f"{handle.url}{path}", json_body=body,
                    params=req.query, timeout=PROXY_TIMEOUT_S)
                doc = resp.json()
                results.append({"replica": rank, "status": resp.status,
                                "response": doc})
                if resp.status >= 400:
                    raise HttpClientError(
                        f"replica {rank} answered {resp.status}")
            except _EXCHANGE_ERRORS + (ValueError,) as e:
                if not results or results[-1].get("replica") != rank:
                    results.append({"replica": rank, "status": "error",
                                    "error": str(e) or type(e).__name__})
                unwound = []
                if action == "deploy" and done:
                    unwound = await self._unwind(done, req)
                self._deploys.inc(action=action, outcome="aborted")
                record_event("router_cutover", {
                    "action": action, "outcome": "aborted",
                    "failedReplica": rank, "completed": done,
                    "unwound": unwound})
                return 502, {"action": action, "aborted": True,
                             "failedReplica": rank, "results": results,
                             "unwound": unwound}
            done.append(rank)
        self._deploys.inc(action=action, outcome="ok")
        record_event("router_cutover", {"action": action,
                                        "outcome": "ok",
                                        "replicas": done})
        return 200, {"action": action, "aborted": False,
                     "results": results}

    async def _unwind(self, ranks, req: Request) -> list:
        """Best-effort rollback of replicas a failed sequenced deploy
        already cut over — convergence, not a guarantee (a replica that
        cannot answer its rollback stays divergent and its health probe
        keeps it visible)."""
        unwound = []
        for rank in ranks:
            handle = self.replicas.get(rank)
            if handle is None:
                continue
            try:
                resp = await self._client.request(
                    "POST", f"{handle.url}/rollback.json", json_body={},
                    params=req.query, timeout=PROXY_TIMEOUT_S)
                if resp.status < 400:
                    unwound.append(rank)
            except _EXCHANGE_ERRORS:
                logger.exception("unwind rollback failed for replica "
                                 "%d", rank)
        return unwound


class FleetRouterActuator:
    """The fleet controller's synchronous view of the router: the
    controller ticks on an executor thread (scale actions block on
    spawn/drain), so each actuation round-trips into the router's
    event loop and waits for the result."""

    def __init__(self, router: Router, loop: asyncio.AbstractEventLoop):
        self._router = router
        self._loop = loop

    def count(self) -> int:
        return self._router.active_count()

    def scale_up(self) -> int:
        fut = asyncio.run_coroutine_threadsafe(
            self._router.grow(wait_healthy=True), self._loop)
        return fut.result(timeout=SPAWN_HEALTHY_TIMEOUT_S + 30)

    def scale_down(self) -> bool:
        active = sorted(rank for rank, h in self._router.replicas.items()
                        if not h.draining)
        if not active:
            return True
        victim = active[-1]     # newest replica drains first (LIFO)
        fut = asyncio.run_coroutine_threadsafe(
            self._router.drain(victim), self._loop)
        return fut.result(
            timeout=self._router.cfg.drain_timeout_s + 30)


def run_router(config: Optional[RouterConfig] = None,
               ip: str = "localhost",
               spawn: Optional[Callable] = None,
               stop: Optional[Callable] = None,
               replica_urls=(),
               registry: Optional[MetricsRegistry] = None,
               fleet=None, on_ready=None) -> None:
    """Serve the router until SIGINT or SIGTERM (the ``pio router``
    entry): resolves the knob chain, arms durable telemetry (service
    ``router``) so the splitter accumulators and the ``pio_router_*``
    history survive restarts, and attaches the autoscaler when
    server.json/env enable it. The replicas it spawned stop with it.
    ``on_ready(port)`` runs once the socket is bound."""
    from predictionio_tpu_torch.obs.telemetry import build_recorder
    from predictionio_tpu_torch.utils.server_config import (
        fleet_config, router_config, telemetry_config,
    )

    cfg = config or router_config()
    registry = registry or MetricsRegistry()
    telemetry = build_recorder(
        "router", telemetry_config(), instance=str(cfg.port),
        registries=[registry, default_registry()])
    if fleet is None:
        fcfg = fleet_config()
        if fcfg.enabled:
            from predictionio_tpu_torch.deploy.fleet import FleetController

            fleet = FleetController(fcfg, registry=registry)
    router = Router(cfg, registry=registry, telemetry=telemetry,
                    spawn=spawn, stop=stop, fleet=fleet,
                    replica_urls=replica_urls)
    logger.info("Router on %s:%s over %d replica(s)", ip, cfg.port,
                max(len(router.replicas), cfg.replicas))
    serve_until_stopped(router, ip, cfg.port, on_ready=on_ready)
