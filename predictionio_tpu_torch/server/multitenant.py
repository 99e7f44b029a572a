"""Multi-tenant serving host: N serving units, one process, one budget
(port of the reference's ``server/multitenant.py``).

N full :class:`~predictionio_tpu_torch.server.query_server.QueryServer`\\ s
behind per-tenant routes (``POST /t/{tenant}/queries.json``) in ONE
process, under ONE device-memory budget:

* **residency budgeter** — attributes device bytes per tenant from the
  capacity ledger (``obs/capacity``), evicts the least-recently-queried
  tenant to warm on-host state (instance and release pointer kept,
  factors dropped) when the budget is exceeded, and reloads it through
  the deploy's load -> warm-up -> verify ladder on the next hit;
* **per-tenant scorer residency** — each tenant's server is built with
  ``pin_process_scorer=False`` and stamps ITS scorer config on its model
  holders (``ops/scoring.holder_scorer_config``), so one tenant holds
  int8 factors while another holds bf16 in the same process;
* **per-tenant isolation** — every tenant keeps its own micro-batcher,
  fold-in and canary controllers and release lineage, plus
  tenant-labelled metrics and an SLO burn-rate engine;
* **admission control** — a tenant whose SLO budget is burning is
  answered 429 (with Retry-After) at the gate, so one noisy tenant
  cannot evict or queue-starve the rest.

The routes are the port's stdlib HTTP layer (``server/http``): each
tenant's own routes are mounted under ``/t/{name}/`` (``deploy``,
``reload``, ``slo.json``, ``capacity.json``, ``deploy/status.json`` and
the rest), where the reference uses aiohttp's ``add_subapp``; the gate's
exact ``/t/{name}/queries.json`` outranks the mount, and the host's
middleware (service ``multitenant``) observes each request once. The
host also answers ``/slo.json`` and ``/deploy/status.json`` (over its
tenants), the two documents the port's router probes a replica for, so
a host can stand behind ``pio router``.

Knobs: ``PIO_MT_*`` / server.json ``multitenant``
(:class:`~predictionio_tpu_torch.utils.server_config.MultiTenantConfig`).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import re
import time
from typing import Any, Dict, List, Optional, Tuple

from predictionio_tpu_torch.obs.capacity import (
    UNIT_RESIDENT_GAUGE, capacity_routes, register_capacity_metrics,
)
from predictionio_tpu_torch.obs.middleware import (
    metrics_routes, observability_middleware,
)
from predictionio_tpu_torch.obs.registry import (
    MetricsRegistry, default_registry,
)
from predictionio_tpu_torch.obs.slo import (
    KIND_ERRORS, KIND_FRESHNESS, KIND_LATENCY, SLOEngine, SLOSpec,
)
from predictionio_tpu_torch.server.http import (
    HttpServer, Request, serve_until_stopped,
)
from predictionio_tpu_torch.server.query_server import (
    MAX_BATCH, QueryServer,
)
from predictionio_tpu_torch.utils.server_config import MultiTenantConfig

logger = logging.getLogger("pio.torch.multitenant")

DEFAULT_PORT = 8800

#: tenant names become URL path segments and metric label values: keep
#: them boring (no '/', no label-breaking characters)
_TENANT_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]*$")


@dataclasses.dataclass
class TenantSpec:
    """Everything needed to co-host one engine variant as a tenant.

    ``scorer_config`` is the per-tenant residency choice (int8 keeps
    about 3.8x more tenants resident than f32 before the budgeter has to
    evict); ``slo`` is a raw server.json-style ``"slo"`` section whose
    objective names get tenant-prefixed so N tenants share one
    registry's ``pio_slo_*`` gauges without colliding.
    ``serving_config`` (a ``ServingConfig``: server.json ``serving`` and
    ``PIO_BATCH_*``) sizes the tenant's micro-batcher; without one,
    ``max_batch`` and ``linger_s`` do."""

    name: str
    engine: Any
    train_result: Any
    instance: Any
    release: Any = None
    scorer_config: Any = None
    deploy_config: Any = None
    foldin_config: Any = None
    slo: Optional[dict] = None
    serving_config: Any = None
    max_batch: int = MAX_BATCH
    linger_s: Optional[float] = None


class Tenant:
    """One co-hosted tenant: its server plus the host-side state the
    budgeter and the admission gate need (LRU clock, SLO engine)."""

    __slots__ = ("name", "server", "slo", "last_hit")

    def __init__(self, name: str, server: QueryServer,
                 slo: Optional[SLOEngine]):
        self.name = name
        self.server = server
        self.slo = slo
        self.last_hit = time.monotonic()


class MultiTenantServer:
    """One process, N tenants, one device-memory budget. ``start`` binds
    on the running loop and returns the port; ``stopped`` ends
    :func:`run_multitenant_server`."""

    def __init__(self, specs: List[TenantSpec],
                 config: Optional[MultiTenantConfig] = None,
                 registry: Optional[MetricsRegistry] = None,
                 access_key: Optional[str] = None,
                 telemetry=None):
        if not specs:
            raise ValueError("multi-tenant host needs at least one tenant")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {sorted(names)}")
        for name in names:
            if not _TENANT_NAME_RE.match(name):
                raise ValueError(
                    f"tenant name {name!r} is not URL/label safe "
                    f"(want {_TENANT_NAME_RE.pattern})")
        self.config = config or MultiTenantConfig.from_env()
        self.registry = registry or MetricsRegistry()
        self.access_key = access_key
        self._telemetry = telemetry
        cap = self.config.max_tenant_series
        self._queries = self.registry.counter(
            "pio_tenant_queries_total",
            "Queries admitted per tenant at the multi-tenant gate",
            labelnames=("tenant",), max_series=cap)
        self._failures = self.registry.counter(
            "pio_tenant_query_failures_total",
            "Admitted queries that answered >= 400 per tenant (the "
            "errors-SLO burn numerator)",
            labelnames=("tenant",), max_series=cap)
        self._hist = self.registry.histogram(
            "pio_tenant_query_duration_seconds",
            "Gate-to-answer wall time per tenant (the latency-SLO "
            "burn source)",
            labelnames=("tenant",), max_series=cap)
        self._rejected = self.registry.counter(
            "pio_tenant_admission_rejected_total",
            "Queries 429'd at the gate because the tenant's SLO "
            "budget is burning (NOT counted as tenant failures: "
            "shedding must let the burn recover)",
            labelnames=("tenant",), max_series=cap)
        self._reload_timeouts = self.registry.counter(
            "pio_tenant_reload_timeouts_total",
            "Queries that hit a warm tenant and timed out waiting for "
            "the warm reload (answered 503)",
            labelnames=("tenant",), max_series=cap)
        self.registry.gauge(
            "pio_mt_device_budget_bytes",
            "Configured device-memory residency budget "
            "(0 = unlimited, never evict)").set(
                float(self.config.budget_bytes))
        #: construction order = route order
        self.tenants: Dict[str, Tenant] = {}
        for spec in specs:
            self.tenants[spec.name] = self._build_tenant(spec)
        # each tenant's server pointed the shared registry's per-unit
        # residency gauge at its own units; the host owns the truth:
        # every tenant's units, tenant-labelled
        self.registry.unregister(UNIT_RESIDENT_GAUGE)
        register_capacity_metrics(self.registry, self._all_capacity_units,
                                  labelnames=("tenant", "role"))
        self.registry.gauge_callback(
            "pio_tenant_resident_bytes",
            "Device-resident factor bytes per tenant (0 while evicted "
            "to warm state)",
            self._resident_samples, labelnames=("tenant",))
        self.registry.gauge_callback(
            "pio_mt_resident_bytes_total",
            "Device-resident factor bytes across all tenants (the "
            "number the budgeter keeps under pio_mt_device_budget_bytes)",
            lambda: float(self.resident_bytes()))
        self._tasks: List[asyncio.Task] = []
        self.stopped = asyncio.Event()
        self._http = HttpServer([
            ("GET", "/", self.handle_root),
            ("GET", "/tenants.json", self.handle_tenants),
            ("GET", "/residency.json", self.handle_residency),
            # the router's readiness probe reads these two on a replica
            ("GET", "/slo.json", self.handle_slo),
            ("GET", "/deploy/status.json", self.handle_status),
            # the gate: exact per-tenant routes outrank the mounts below,
            # so queries go through admission and residency while every
            # other per-tenant path reaches the tenant's own routes
            *[("POST", f"/t/{name}/queries.json", self.handle_tenant_query)
              for name in self.tenants],
            # unknown tenants land here for a clean 404
            ("POST", "/t/{tenant}/queries.json", self.handle_tenant_query),
            *capacity_routes(self._all_capacity_units),
            *metrics_routes(self.registry, default_registry()),
        ], middleware=observability_middleware(self.registry,
                                               "multitenant"))
        for name, tenant in self.tenants.items():
            self._http.mount(f"/t/{name}/", tenant.server._http)

    # -- construction --------------------------------------------------------
    def _build_tenant(self, spec: TenantSpec) -> Tenant:
        kwargs: Dict[str, Any] = {}
        for key in ("release", "scorer_config", "serving_config",
                    "deploy_config", "foldin_config"):
            value = getattr(spec, key)
            if value is not None:
                kwargs[key] = value
        server = QueryServer(
            spec.engine, spec.train_result, spec.instance,
            max_batch=spec.max_batch, linger_s=spec.linger_s,
            access_key=self.access_key, registry=self.registry,
            pin_process_scorer=False, **kwargs)
        return Tenant(spec.name, server, self._build_slo(spec))

    def _build_slo(self, spec: TenantSpec) -> Optional[SLOEngine]:
        """A per-tenant burn-rate engine over the HOST's tenant-labelled
        metrics. Objective names get a ``{tenant}:`` prefix: all N
        engines share one registry, and ``pio_slo_*`` label by objective
        name."""
        if not spec.slo:
            return None
        data = dict(spec.slo)
        data["objectives"] = [
            {**o, "name": f"{spec.name}:{o.get('name', o.get('kind', 'slo'))}"}
            for o in data.get("objectives", ())]
        parsed = SLOSpec.from_dict(data)
        if parsed is None:
            return None
        name = spec.name

        def _errors(obj) -> Tuple[float, float]:
            return (self._failures.value(tenant=name),
                    self._queries.value(tenant=name))

        def _latency(obj) -> Tuple[float, float]:
            total = self._hist.count(tenant=name)
            bad = total - self._hist.count_below(obj.threshold_s,
                                                 tenant=name)
            return bad, total

        return SLOEngine(self.registry, parsed,
                         sources={KIND_ERRORS: _errors,
                                  KIND_LATENCY: _latency})

    # -- lifecycle -----------------------------------------------------------
    async def start(self, host: str = "localhost",
                    port: int = DEFAULT_PORT, ssl_context=None) -> int:
        """Bind (over TLS with ``ssl_context``), start every tenant's
        fold-in and SLO loops, the budget sweep (with a budget) and the
        tenants' SLO loop; returns the bound port."""
        bound = await self._http.start(host, port, ssl_context=ssl_context)
        for tenant in self.tenants.values():
            tenant.server.start_background()
        loop = asyncio.get_running_loop()
        if self.config.budget_bytes > 0:
            self._tasks.append(loop.create_task(self._sweep_loop()))
        intervals = [t.slo.spec.eval_interval_s
                     for t in self.tenants.values() if t.slo is not None]
        if intervals:
            self._tasks.append(loop.create_task(
                self._slo_loop(min(intervals))))
        logger.info(
            "multi-tenant host up: %d tenant(s) [%s], budget %s bytes, "
            "admission %s", len(self.tenants),
            ", ".join(self.tenants), self.config.budget_bytes or "off",
            "on" if self.config.admission else "off")
        return bound

    async def close(self) -> None:
        """Stop accepting, stop the host's loops, close every tenant's
        server, then the shared telemetry recorder (last: its final
        drain includes what the steps before it recorded)."""
        await self._http.close()
        for task in self._tasks:
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks = []
        for tenant in self.tenants.values():
            await tenant.server.close()
        if self._telemetry is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, self._telemetry.stop)
            self._telemetry = None

    async def _sweep_loop(self) -> None:
        """Background LRU budget sweep: a standby or canary growing a
        tenant past the budget is corrected within one interval even if
        that tenant is never queried again."""
        while True:
            await asyncio.sleep(self.config.sweep_interval_s)
            try:
                await self.enforce_budget()
            except Exception:
                logger.exception("residency sweep failed")

    async def _slo_loop(self, interval: float) -> None:
        while True:
            await asyncio.sleep(interval)
            for tenant in self.tenants.values():
                if tenant.slo is None:
                    continue
                try:
                    tenant.slo.tick()
                except Exception:
                    logger.exception("SLO evaluation failed for tenant %s",
                                     tenant.name)

    # -- residency budgeter --------------------------------------------------
    def _resident_tenants(self) -> List[Tenant]:
        return [t for t in self.tenants.values() if t.server.resident]

    def resident_bytes(self) -> int:
        """Live device-resident attribution across all tenants (warm
        tenants contribute 0: their remembered footprint only enters as
        the reload's projection)."""
        return sum(t.server.warm_bytes for t in self._resident_tenants())

    def _resident_samples(self):
        return [({"tenant": t.name},
                 float(t.server.warm_bytes if t.server.resident else 0))
                for t in self.tenants.values()]

    def _all_capacity_units(self) -> List[dict]:
        return [{**unit, "tenant": tenant.name}
                for tenant in self.tenants.values()
                for unit in tenant.server._capacity_units()]

    async def _evict_lru(self, exclude: Tuple[str, ...] = (),
                         reason: str = "budget") -> bool:
        """Evict the least-recently-queried resident tenant (skipping
        ``exclude`` and tenants mid-canary: the judge needs its
        incumbent). True when something was evicted."""
        candidates = sorted(
            (t for t in self._resident_tenants()
             if t.name not in exclude and t.server._canary is None),
            key=lambda t: t.last_hit)
        for tenant in candidates:
            if await tenant.server.evict_to_warm(reason):
                logger.info("evicted tenant %s (%s)", tenant.name, reason)
                return True
        return False

    async def enforce_budget(self) -> None:
        """Evict LRU tenants until resident bytes fit the budget, never
        below the ``min_resident`` floor."""
        budget = self.config.budget_bytes
        if budget <= 0:
            return
        while (self.resident_bytes() > budget
               and len(self._resident_tenants()) > self.config.min_resident):
            if not await self._evict_lru():
                return

    async def ensure_tenant_resident(self, tenant: Tenant) -> bool:
        """The miss path: make room for the tenant's projected reload
        footprint (its last resident attribution), drive the warm
        reload, then enforce the budget again on the ACTUAL bytes (a
        projection is the last cycle's truth, not this one's)."""
        budget = self.config.budget_bytes
        if not tenant.server.resident and budget > 0:
            while (self.resident_bytes() + tenant.server.warm_bytes > budget
                   and await self._evict_lru(exclude=(tenant.name,))):
                pass
        ok = await tenant.server.ensure_resident(
            wait_s=self.config.reload_wait_s)
        if ok and budget > 0:
            while (self.resident_bytes() > budget
                   and await self._evict_lru(exclude=(tenant.name,))):
                pass
        return ok

    # -- the gate ------------------------------------------------------------
    async def handle_tenant_query(self, req: Request) -> tuple:
        # the exact per-tenant routes carry no path parameter; the path
        # shape is fixed (/t/<name>/queries.json), the name is segment 2
        name = req.params.get("tenant") or req.path.split("/")[2]
        tenant = self.tenants.get(name)
        if tenant is None:
            return 404, {"message": f"unknown tenant {name!r}"}
        retry = {"Retry-After": f"{self.config.retry_after_s:g}"}
        if (self.config.admission and tenant.slo is not None
                and tenant.slo.breached(exclude_kinds=(KIND_FRESHNESS,))):
            self._rejected.inc(tenant=name)
            return 429, {"message": f"tenant {name!r} SLO budget is "
                                    "burning; shedding load"}, retry
        tenant.last_hit = time.monotonic()
        if not tenant.server.resident:
            if not await self.ensure_tenant_resident(tenant):
                self._reload_timeouts.inc(tenant=name)
                return 503, {"message": f"tenant {name!r} is reloading; "
                                        "retry"}, retry
        t0 = time.perf_counter()
        self._queries.inc(tenant=name)
        try:
            out = await tenant.server.handle_query(req)
        except Exception:
            self._failures.inc(tenant=name)
            self._hist.observe(time.perf_counter() - t0, tenant=name)
            raise
        self._hist.observe(time.perf_counter() - t0, tenant=name)
        if out[0] >= 400:
            self._failures.inc(tenant=name)
        return out

    # -- status surfaces -----------------------------------------------------
    def _tenant_doc(self, tenant: Tenant) -> dict:
        server = tenant.server
        return {
            "tenant": tenant.name,
            "resident": server.resident,
            "residentBytes": server.warm_bytes if server.resident else 0,
            "warmBytes": 0 if server.resident else server.warm_bytes,
            "lastHitAgoS": round(time.monotonic() - tenant.last_hit, 3),
            "canary": server._canary is not None,
            "slo": (tenant.slo.breached(exclude_kinds=(KIND_FRESHNESS,))
                    if tenant.slo is not None else None),
            "engineInstanceId": server.instance.id,
            "scorerMode": server.scorer_config.mode,
        }

    async def handle_root(self, _req: Request) -> tuple:
        return 200, {
            "status": "alive",
            "tenants": list(self.tenants),
            "budgetBytes": self.config.budget_bytes,
            "residentBytes": self.resident_bytes(),
            "admission": self.config.admission,
        }

    async def handle_tenants(self, _req: Request) -> tuple:
        return 200, {"tenants": [self._tenant_doc(t)
                                 for t in self.tenants.values()]}

    async def handle_residency(self, _req: Request) -> tuple:
        return 200, {
            "budgetBytes": self.config.budget_bytes,
            "residentBytes": self.resident_bytes(),
            "residentTenants": len(self._resident_tenants()),
            "minResident": self.config.min_resident,
            "tenants": [self._tenant_doc(t)
                        for t in self.tenants.values()],
        }


    async def handle_slo(self, _req: Request) -> tuple:
        """The tenants' admission SLOs for a router's probe: ``breached``
        while any tenant's burns (the fleet scales up on it)."""
        burning = {t.name: t.slo.breached(exclude_kinds=(KIND_FRESHNESS,))
                   for t in self.tenants.values() if t.slo is not None}
        return 200, {"enabled": bool(burning),
                     "breached": any(burning.values()),
                     "tenants": burning}

    async def handle_status(self, _req: Request) -> tuple:
        """Readiness for a router's probe: each tenant's residency and
        release (a tenant's own status is under ``/t/{name}/``)."""
        return 200, {"tenants": [
            {**self._tenant_doc(t),
             "releaseVersion": t.server._unit.release_version or None}
            for t in self.tenants.values()]}


def create_multitenant_server(specs: List[TenantSpec],
                              **kwargs) -> MultiTenantServer:
    return MultiTenantServer(specs, **kwargs)


def run_multitenant_server(specs: List[TenantSpec],
                           ip: str = "localhost",
                           port: int = DEFAULT_PORT,
                           on_ready=None, **kwargs) -> None:
    """Serve until SIGINT or SIGTERM, with the ``PIO_MT_*`` knobs and,
    unless the caller passed one, a telemetry recorder of service
    ``multitenant`` over the host's registry. Without an
    ``access_key`` (None or empty) server.json's ``key`` guards every
    tenant's deploy API; server.json's ``ssl`` turns TLS on.
    ``on_ready(port)`` runs once the socket is bound."""
    from predictionio_tpu_torch.obs.telemetry import build_recorder
    from predictionio_tpu_torch.utils.server_config import ServerConfig

    cfg = ServerConfig.load()
    # the file's key stands in for a missing one (the reference's
    # setdefault never applies: its CLI passes access_key=None)
    if not kwargs.get("access_key"):
        kwargs["access_key"] = cfg.key or None
    kwargs.setdefault("config", cfg.multitenant)
    if "telemetry" not in kwargs:
        registry = kwargs.setdefault("registry", MetricsRegistry())
        kwargs["telemetry"] = build_recorder(
            "multitenant", cfg.telemetry, instance=str(port),
            registries=[registry, default_registry()])
    server = create_multitenant_server(specs, **kwargs)
    ssl_ctx = cfg.ssl_context()
    logger.info("Multi-tenant server on %s:%s%s (%d tenants)", ip, port,
                " (TLS)" if ssl_ctx else "", len(server.tenants))
    serve_until_stopped(server, ip, port, on_ready, ssl_context=ssl_ctx)
