"""The fleet under test, every production subsystem in one process (port
of the reference's ``loadtest/fleet.py``).

:class:`LocalFleet` assembles the real components the way an operator
would deploy them, scaled to one box:

* a partitioned event store (``PIO_INGEST_PARTITIONS`` commit lanes)
  behind the real :class:`EventServer` (group-commit WriteBuffer, 429
  shedding, batch API) on a real port;
* N :class:`QueryServer` replicas serving a trained recommendation
  engine (ALS), each with online fold-in on, on fixed ports (a killed
  replica restarts at the same url, so the router's re-admission path
  is exercised);
* the :class:`Router` in front of them (spread, health ejection with
  backed-off probes, per-query retry, sequenced fleet cutovers);
* the continuous-training :class:`Orchestrator` (registry plane and
  SLO-judged canary), whose promoted release the fleet rolls out
  through the router's sequenced ``/deploy.json``.

The event server and the replicas run on one background asyncio loop
thread, on the port's stdlib HTTP layer (``server/http``; the reference
uses aiohttp, which the card's machine lacks); the router runs in a
process of its own (``_router_main``), and so do the simulator's lanes
(``simulator._traffic_main``), which talk to the fleet over real HTTP.
The reference keeps every part on one loop; on the port's stdlib HTTP
layer that one thread and one GIL carried the router's proxying and the
callers' own sends beside the servers under test, and the storm's p99
measured their queueing.

The models (the replicas, the orchestrator's trains, fold-in) run on
``device``: ``cuda`` unless the caller passes ``"cpu"``. A fleet asked
for ``cuda`` on a machine without a card raises; it never falls back.

The fleet sets ``PIO_INGEST_PARTITIONS`` and ``PIO_SERVER_CONF`` for the
whole process while it runs (restored by ``stop``), as the reference
does: run nothing beside it that reads those knobs.

Incident levers (what scenario timelines trigger): ``kill_replica`` /
``restart_replica`` (a replica's server down and up on the same port),
``kill_compaction`` (a no-op on sqlite, as in the reference: a sqlite
compaction is one DELETE, with nothing to kill mid-way),
``run_retrain_cycle`` (a forced orchestrator cycle, then a sequenced
router cutover to the promoted release).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

__all__ = ["LocalFleet", "MultiTenantFleet"]

#: events the batch endpoint accepts per request (the fleet raises the
#: reference's 50 cap for bulk emitters)
BATCH_MAX = 256

#: the recommendation engine by the reference's factory string, which
#: the port's CLI maps to its own engine
REFERENCE_FACTORY = (__name__.split(".")[0].removesuffix("_torch")
                     + ".engines.recommendation:engine")

#: seconds an HTTP exchange of the fleet may take
HTTP_TIMEOUT_S = 60.0

#: seconds the router's process may take to answer with every replica
#: healthy behind it
ROUTER_READY_S = 90.0


def _router_main() -> int:
    """The fleet's router process (``LocalFleet._start_router``; its
    settings as JSON in ``argv[1]``): serves on a free loopback port,
    prints that port once every replica is healthy behind it, and closes
    on SIGTERM."""
    import signal

    from predictionio_tpu_torch.obs.registry import MetricsRegistry
    from predictionio_tpu_torch.server.router import Router
    from predictionio_tpu_torch.utils.server_config import RouterConfig

    cfg = json.loads(sys.argv[1])
    router = Router(
        RouterConfig(health_interval_s=cfg["health_interval_s"],
                     health_fail_after=2, proxy_retries=2,
                     health_backoff_cap_s=cfg["health_backoff_cap_s"]),
        registry=MetricsRegistry(), replica_urls=cfg["replica_urls"])

    async def _main() -> int:
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, router.stopped.set)
        port = await router.start("127.0.0.1", 0)
        try:
            for rank in list(router.replicas):
                if not await router.wait_replica_healthy(rank,
                                                         timeout_s=30):
                    # pio: ignore[PIO100]: the parent reads this child's stdout
                    print(f"replica {rank} never became healthy behind "
                          "the router", flush=True)
                    return 1
            # pio: ignore[PIO100]: the parent reads the port off stdout
            print(port, flush=True)
            await router.stopped.wait()
        finally:
            await router.close()
        return 0

    return asyncio.run(_main())


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _LoopOwner:
    """One background asyncio loop and an HTTP client living on it."""

    _loop: Optional[asyncio.AbstractEventLoop] = None
    _loop_thread: Optional[threading.Thread] = None
    _client = None

    def _start_loop(self, name: str) -> None:
        from predictionio_tpu_torch.server.http_client import HttpClient

        self._loop = asyncio.new_event_loop()
        ready = threading.Event()

        def _spin():
            asyncio.set_event_loop(self._loop)
            ready.set()
            self._loop.run_forever()

        self._loop_thread = threading.Thread(target=_spin, name=name,
                                             daemon=True)
        self._loop_thread.start()
        ready.wait(10)

        async def _mk_client():
            return HttpClient()

        self._client = self._run(_mk_client(), timeout=10)

    def _stop_loop(self) -> None:
        if self._loop is None:
            return
        self._loop.call_soon_threadsafe(self._loop.stop)
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10)
        self._loop.close()
        self._loop = None

    def _run(self, coro, timeout: float = 60.0):
        """Run a coroutine on the fleet loop from any thread, blocking."""
        return asyncio.run_coroutine_threadsafe(
            coro, self._loop).result(timeout)

    def _submit(self, coro):
        """Fire a coroutine on the fleet loop, returning the concurrent
        Future the open-loop harness drives."""
        return asyncio.run_coroutine_threadsafe(coro, self._loop)

    async def _post_json(self, url: str, payload) -> tuple:
        resp = await self._client.request("POST", url, json_body=payload,
                                          timeout=HTTP_TIMEOUT_S)
        try:
            body = resp.json()
        except ValueError:
            body = resp.body.decode(errors="replace")
        return resp, body


class LocalFleet(_LoopOwner):
    """See the module docstring. Lifecycle: ``start()`` (seeds data,
    trains the first release through a forced orchestrator cycle, boots
    the event server, the replicas and the router) ... lanes and
    incidents ... ``stop()``."""

    def __init__(self, root: str, *, replicas: int = 2,
                 partitions: int = 2, backend: str = "sqlite",
                 app_name: str = "loadtest", seed_events: int = 160,
                 foldin: bool = True,
                 foldin_interval_s: float = 1.0,
                 health_interval_s: float = 0.1,
                 health_backoff_cap_s: float = 1.0,
                 queue_max: int = 1 << 17,
                 device=None):
        if backend != "sqlite":
            raise NotImplementedError(
                f"a {backend!r} fleet is not ported to PyTorch: the "
                "parquet event store waits for pyarrow (ROADMAP Queue 1 "
                "item 8)")
        self.root = str(root)
        self.n_replicas = int(replicas)
        self.partitions = int(partitions)
        self.backend = backend
        self.app_name = app_name
        self.seed_events = int(seed_events)
        self.foldin = foldin
        self.foldin_interval_s = foldin_interval_s
        self.health_interval_s = health_interval_s
        self.health_backoff_cap_s = health_backoff_cap_s
        self.queue_max = queue_max
        self.device = device

        self.app_id: Optional[int] = None
        self.access_key = "storm-key"
        self.event_url: Optional[str] = None
        self.router_url: Optional[str] = None
        self.replica_urls: List[str] = []
        self.cycles: List = []            #: CycleDocs of retrain incidents
        self.seed_event_ids: List[str] = []

        self._event_server = None
        self._router_proc: Optional[subprocess.Popen] = None
        self._replica_ports: List[int] = []
        self._replica_servers: List[Optional[object]] = []
        self._orch = None
        self._variant_path: Optional[str] = None
        self._smoke_path: Optional[str] = None
        self._saved_env: Dict[str, Optional[str]] = {}

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        from predictionio_tpu_torch.utils.device import resolve_device

        # the device first: without a card (and without device="cpu")
        # this raises before anything is written
        resolve_device(self.device)
        os.makedirs(self.root, exist_ok=True)
        self._set_env("PIO_INGEST_PARTITIONS",
                      str(self.partitions) if self.partitions > 1 else None)
        self._configure_storage()
        self._seed_app_and_data()
        self._write_configs()
        self._start_loop("loadtest-fleet-loop")
        self._build_orchestrator()
        # cycle 0, before the storm: train and promote the first LIVE
        # release the replicas deploy from (the operator's `pio train`)
        doc0 = self._orch.tick(force=True)
        if doc0 is None or doc0.outcome != "promoted":
            raise RuntimeError(
                "seed training cycle failed: "
                f"{getattr(doc0, 'reason', 'no cycle ran')}")
        self._start_event_server()
        self._replica_ports = [_free_port() for _ in range(self.n_replicas)]
        self._replica_servers = [None] * self.n_replicas
        for rank in range(self.n_replicas):
            self._start_replica(rank)
        self._start_router()

    def stop(self) -> None:
        from predictionio_tpu_torch.storage.faults import set_kill_points
        from predictionio_tpu_torch.storage.registry import Storage

        try:
            self._stop_router()
            if self._loop is not None:
                self._run(self._shutdown_all(), timeout=60)
        except Exception:
            logger.exception("fleet shutdown raised")
        self._stop_loop()
        set_kill_points([])
        Storage.reset()
        for key, old in self._saved_env.items():
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old
        self._saved_env.clear()

    # -- plumbing ------------------------------------------------------------
    def _set_env(self, key: str, value: Optional[str]) -> None:
        if key not in self._saved_env:
            self._saved_env[key] = os.environ.get(key)
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value

    def _configure_storage(self) -> None:
        from predictionio_tpu_torch.data.eventstore import clear_cache
        from predictionio_tpu_torch.storage.registry import Storage

        Storage.configure({
            "sources": {
                "DB": {"TYPE": "sqlite",
                       "PATH": os.path.join(self.root, "meta.db")},
                "EVENTS": {"TYPE": "sqlite",
                           "PATH": os.path.join(self.root, "events.db")}},
            "repositories": {
                "METADATA": {"NAME": "pio_meta", "SOURCE": "DB"},
                "MODELDATA": {"NAME": "pio_model", "SOURCE": "DB"},
                "EVENTDATA": {"NAME": "pio_event", "SOURCE": "EVENTS"},
            }})
        clear_cache()

    def _seed_app_and_data(self) -> None:
        import datetime as dt
        import random

        from predictionio_tpu_torch.data.event import UTC, Event
        from predictionio_tpu_torch.storage.base import AccessKey, App
        from predictionio_tpu_torch.storage.registry import Storage

        self.app_id = Storage.get_meta_data_apps().insert(
            App(id=0, name=self.app_name))
        Storage.get_meta_data_access_keys().insert(
            AccessKey(key=self.access_key, appid=self.app_id, events=()))
        Storage.get_events().init_channel(self.app_id)
        # seed ratings: enough signal for the first ALS fit
        rng = random.Random(11)
        base = dt.datetime(2026, 7, 1, tzinfo=UTC)
        events = [Event(
            event="rate", entity_type="user",
            entity_id=f"u{rng.randrange(40)}",
            target_entity_type="item",
            target_entity_id=f"i{rng.randrange(60)}",
            properties={"rating": 1.0 + rng.random() * 4.0},
            event_time=base + dt.timedelta(seconds=i))
            for i in range(self.seed_events)]
        # the seed ids join the audit ledger: this insert acked them
        self.seed_event_ids = list(
            Storage.get_events().insert_batch(events, self.app_id))

    def _write_configs(self) -> None:
        self._variant_path = os.path.join(self.root, "engine.json")
        with open(self._variant_path, "w") as f:
            json.dump({
                "id": "default",
                "engineFactory": REFERENCE_FACTORY,
                "datasource": {"params": {"app_name": self.app_name}},
                "algorithms": [{
                    "name": "als",
                    "params": {"rank": 4, "num_iterations": 3,
                               "reg": 0.05, "seed": 3}}],
            }, f)
        self._smoke_path = os.path.join(self.root, "smoke.jsonl")
        with open(self._smoke_path, "w") as f:
            f.write("".join(
                json.dumps({"user": f"u{i}", "num": 3}) + "\n"
                for i in range(5)))
        server_conf = os.path.join(self.root, "server.json")
        with open(server_conf, "w") as f:
            json.dump({"slo": {
                "objectives": [
                    {"name": "errs", "kind": "errors", "budget": 0.02},
                    {"name": "p99", "kind": "latency",
                     "thresholdMs": 2000, "budget": 0.05}],
                "windows": [{"seconds": 60, "burnThreshold": 1.0}],
                "evalIntervalS": 0.05}}, f)
        self._set_env("PIO_SERVER_CONF", server_conf)

    # -- components ----------------------------------------------------------
    def _build_orchestrator(self) -> None:
        from predictionio_tpu_torch.deploy.orchestrator import (
            build_orchestrator,
        )
        from predictionio_tpu_torch.utils.server_config import (
            OrchestratorConfig,
        )

        cfg = OrchestratorConfig(
            min_ingest_events=0, cooldown_s=0.0, phase_retries=0,
            phase_timeout_s=300.0, canary_hold_s=0.0,
            smoke_queries=self._smoke_path)
        self._orch = build_orchestrator(
            self._variant_path, config=cfg,
            state_dir=os.path.join(self.root, "orch_state"),
            device=self.device)

    def _start_event_server(self) -> None:
        from predictionio_tpu_torch.obs.registry import MetricsRegistry
        from predictionio_tpu_torch.server.event_server import EventServer
        from predictionio_tpu_torch.utils.server_config import IngestConfig

        ingest = IngestConfig(
            buffer=True, queue_max=self.queue_max, flush_max=512,
            linger_s=0.002, partitions=self.partitions,
            max_events_per_batch=BATCH_MAX)
        self._event_server = EventServer(registry=MetricsRegistry(),
                                         ingest=ingest)
        port = self._run(self._event_server.start("127.0.0.1", 0),
                         timeout=30)
        self.event_url = f"http://127.0.0.1:{port}"

    def _build_replica_server(self):
        """One QueryServer serving the current LIVE release (the
        in-process `pio deploy`), with fold-in."""
        from predictionio_tpu_torch.deploy.orchestrator import load_variant
        from predictionio_tpu_torch.obs.registry import MetricsRegistry
        from predictionio_tpu_torch.server.query_server import QueryServer
        from predictionio_tpu_torch.storage.registry import Storage
        from predictionio_tpu_torch.utils.server_config import (
            DeployConfig, FoldinConfig,
        )
        from predictionio_tpu_torch.workflow.train import load_for_deploy

        engine, _params, factory, variant_id, _ = load_variant(
            self._variant_path)
        release = Storage.get_meta_data_releases().latest(
            factory, "1", variant_id, status="LIVE")
        if release is None:
            raise RuntimeError("no LIVE release to deploy from")
        instance = Storage.get_meta_data_engine_instances().get(
            release.instance_id)
        result, _ctx = load_for_deploy(engine, instance, device=self.device)
        return QueryServer(
            engine, result, instance, max_batch=16, linger_s=0.0,
            inflight=2, release=release, registry=MetricsRegistry(),
            deploy_config=DeployConfig(warmup=True),
            foldin_config=FoldinConfig(
                enabled=self.foldin,
                apply_interval_s=self.foldin_interval_s,
                max_pending=2048))

    def _start_replica(self, rank: int) -> None:
        server = self._build_replica_server()
        port = self._replica_ports[rank]
        self._run(server.start("127.0.0.1", port), timeout=60)
        self._replica_servers[rank] = server
        url = f"http://127.0.0.1:{port}"
        if len(self.replica_urls) <= rank:
            self.replica_urls.append(url)

    def _start_router(self) -> None:
        """The router in a process of its own (``_router_main``), as ``pio
        router`` runs it: on the fleet's loop its proxying would share one
        thread and one GIL with the replicas it fronts. Returns once it
        answers and every replica is healthy behind it."""
        from predictionio_tpu_torch.loadtest.harness import (
            child_env, read_line,
        )

        cfg = {"health_interval_s": self.health_interval_s,
               "health_backoff_cap_s": self.health_backoff_cap_s,
               "replica_urls": list(self.replica_urls)}
        self._router_proc = subprocess.Popen(
            [sys.executable, "-c",
             f"import sys; from {__name__} import _router_main; "
             "sys.exit(_router_main())", json.dumps(cfg)],
            stdout=subprocess.PIPE, env=child_env(),
            start_new_session=True)
        ready = read_line(self._router_proc.stdout, ROUTER_READY_S)
        if not ready.strip().isdigit():
            self._stop_router()
            raise RuntimeError(
                f"the router process never came up (said {ready!r})")
        self.router_url = f"http://127.0.0.1:{int(ready)}"

    def _stop_router(self) -> None:
        proc, self._router_proc = self._router_proc, None
        if proc is None:
            return
        if proc.poll() is None:
            proc.terminate()        # SIGTERM: the router closes cleanly
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        proc.stdout.close()

    async def _shutdown_all(self) -> None:
        if self._client is not None:
            await self._client.close()
        for server in self._replica_servers:
            if server is not None:
                await server.close()
        if self._event_server is not None:
            await self._event_server.close()

    # -- incidents -----------------------------------------------------------
    def kill_replica(self, rank: int) -> None:
        """Stop a replica's server mid-storm: its port goes dead, the
        router's probes must eject it and its queries retry elsewhere."""
        server = self._replica_servers[rank]
        self._replica_servers[rank] = None
        if server is not None:
            self._run(server.close(), timeout=60)

    def restart_replica(self, rank: int) -> None:
        """Restart a killed replica at the same url; the router's health
        loop must re-admit it."""
        self._start_replica(rank)

    def kill_compaction(self) -> None:
        """Parquet stores only in the reference (a sqlite compaction is
        one DELETE, with nothing to kill mid-way); the port's fleet is
        sqlite, so this logs and returns."""
        logger.info("kill_compaction skipped: backend=%s", self.backend)

    def run_retrain_cycle(self):
        """The mid-storm loop: one forced orchestrator cycle (train ->
        eval gate -> smoke -> SLO-judged canary -> promote), then the
        promoted release rolled across the fleet through the router's
        sequenced /deploy.json, one replica at a time while queries keep
        flowing."""
        doc = self._orch.tick(force=True)
        self.cycles.append(doc)
        if doc is not None and doc.outcome == "promoted":
            try:
                self._run(self._fleet_cutover(doc.candidate_release_id),
                          timeout=120)
            except Exception:
                logger.exception("sequenced fleet cutover failed")
        return doc

    async def _fleet_cutover(self, release_id: str) -> dict:
        resp, body = await self._post_json(
            f"{self.router_url}/deploy.json", {"releaseId": release_id})
        if resp.status != 200:
            raise RuntimeError(f"fleet cutover HTTP {resp.status}: {body}")
        return body

    # -- post-run surfaces ---------------------------------------------------
    def event_store(self):
        from predictionio_tpu_torch.storage.registry import Storage

        return Storage.get_events()

    def releases(self):
        from predictionio_tpu_torch.storage.registry import Storage

        return Storage.get_meta_data_releases()

    def drain_ingest(self, timeout_s: float = 60.0) -> None:
        """Wait for the event server's WriteBuffer to drain, so the
        post-run audit scans a settled store."""
        buf = getattr(self._event_server, "buffer", None)
        if buf is None:
            return
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline and buf.queue_depth():
            time.sleep(0.05)

    def _servers(self) -> List[object]:
        return [s for s in self._replica_servers if s is not None]

    def foldin_applied_rows(self) -> int:
        total = 0
        for server in self._servers():
            ctrl = getattr(server, "_foldin", None)
            if ctrl is not None:
                total += int(ctrl.applied_users) + int(ctrl.applied_items)
        return total

    def foldin_freshness_p95_s(self) -> Optional[float]:
        """The largest replica p95 of event-to-applied seconds, from the
        fold-in histogram; None when no apply happened."""
        worst = []
        for server in self._servers():
            hist = server.registry.get("pio_foldin_event_to_applied_seconds")
            if hist is None or not hist.total_count():
                continue
            worst.append(float(hist.quantile(0.95)))
        return max(worst) if worst else None


class MultiTenantFleet(_LoopOwner):
    """A consolidated multi-tenant host under storm: one
    :class:`~predictionio_tpu_torch.server.multitenant.MultiTenantServer`
    serving every scenario tenant behind ``/t/{name}/``, each trained on
    its own small synthetic ALS catalog sized from its ``TenantMix``.

    The surface ``run_tenant_storm`` drives:

    * ``submit_tenant_query(name, payload)``: a Future resolving to the
      parsed answer (raises on a non-200, so the gate's 429s land as lane
      failures);
    * ``burn_tenant(name, duration_s)``: malformed queries at one
      tenant's gate route until its errors budget burns;
    * ``tenant_rejections(name)``: the host's 429 count, the proof the
      shedding came from admission control.

    Every tenant gets an errors SLO so the burn has a budget to burn;
    admission is on: that is the subsystem under test."""

    def __init__(self, root: str, tenants, *, budget_bytes: int = 0,
                 error_budget: float = 0.05,
                 manage_storage: bool = True, device=None):
        self.root = str(root)
        self.mixes = list(tenants)
        self.budget_bytes = int(budget_bytes)
        self.error_budget = float(error_budget)
        self.manage_storage = manage_storage
        self.device = device
        self.base_url: Optional[str] = None
        self.host = None                   #: the MultiTenantServer

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        from predictionio_tpu_torch.server.multitenant import (
            MultiTenantServer,
        )
        from predictionio_tpu_torch.utils.device import resolve_device
        from predictionio_tpu_torch.utils.server_config import (
            MultiTenantConfig,
        )

        resolve_device(self.device)
        os.makedirs(self.root, exist_ok=True)
        if self.manage_storage:
            self._configure_storage()
        specs = [self._build_spec(i, mix)
                 for i, mix in enumerate(self.mixes)]
        self.host = MultiTenantServer(
            specs,
            config=MultiTenantConfig(
                budget_bytes=self.budget_bytes, reload_wait_s=10.0,
                sweep_interval_s=0.5, min_resident=1, admission=True,
                retry_after_s=0.5))
        self._start_loop("mt-fleet-loop")
        port = self._run(self.host.start("127.0.0.1", 0), timeout=60)
        self.base_url = f"http://127.0.0.1:{port}"

    def stop(self) -> None:
        try:
            if self._loop is not None:
                self._run(self._shutdown(), timeout=30)
        except Exception:
            logger.exception("multi-tenant fleet shutdown raised")
        finally:
            self._stop_loop()
            if self.manage_storage:
                from predictionio_tpu_torch.storage.registry import Storage

                Storage.reset()

    async def _shutdown(self) -> None:
        if self._client is not None:
            await self._client.close()
        if self.host is not None:
            await self.host.close()

    # -- construction --------------------------------------------------------
    def _configure_storage(self) -> None:
        from predictionio_tpu_torch.storage.registry import Storage

        Storage.configure({
            "sources": {"DB": {"TYPE": "sqlite",
                               "PATH": os.path.join(self.root, "mt.db")}},
            "repositories": {
                "METADATA": {"NAME": "pio_meta", "SOURCE": "DB"},
                "MODELDATA": {"NAME": "pio_model", "SOURCE": "DB"},
                "EVENTDATA": {"NAME": "pio_event", "SOURCE": "DB"},
            }})

    def _build_spec(self, idx: int, mix):
        """One reloadable tenant: synthetic ALS factors over the mix's
        catalog, persisted (instance, blob, release) so the host's warm
        eviction and reload have a real ladder to climb."""
        import numpy as np

        from predictionio_tpu_torch.deploy.releases import record_release
        from predictionio_tpu_torch.engines import recommendation as rec
        from predictionio_tpu_torch.models.als import ALSModel
        from predictionio_tpu_torch.server.multitenant import TenantSpec
        from predictionio_tpu_torch.storage.base import (
            EngineInstance, Model,
        )
        from predictionio_tpu_torch.storage.registry import Storage
        from predictionio_tpu_torch.utils.server_config import DeployConfig
        from predictionio_tpu_torch.workflow.serialization import (
            serialize_models,
        )

        rank = 8
        n_users = min(int(mix.population), 64)
        n_items = int(mix.items)
        rng = np.random.default_rng(1000 + idx)
        model = ALSModel.from_arrays(
            np.sort(np.asarray([f"u{i}" for i in range(n_users)],
                               dtype=object)),
            np.sort(np.asarray([f"i{i}" for i in range(n_items)],
                               dtype=object)),
            rng.normal(size=(n_users, rank)).astype(np.float32),
            rng.normal(size=(n_items, rank)).astype(np.float32),
            device=self.device)
        instance = EngineInstance(
            id=f"mtfleet-{mix.name}", status="COMPLETED",
            engine_id="loadtest-multitenant", engine_version="1",
            engine_variant=mix.name,
            data_source_params=json.dumps({"app_name": f"{mix.name}App"}),
            algorithms_params=json.dumps(
                [{"name": "als", "params": {"rank": rank}}]))
        Storage.get_meta_data_engine_instances().insert(instance)
        blob = serialize_models([model])
        Storage.get_model_data_models().insert(
            Model(id=instance.id, models=blob))
        release = record_release(instance, train_seconds=0.0, blob=blob)
        engine = rec.engine()
        result = engine.prepare_deploy(
            rec.default_engine_params(f"{mix.name}App", rank=rank), [model])
        return TenantSpec(
            name=mix.name, engine=engine, train_result=result,
            instance=instance, release=release,
            deploy_config=DeployConfig(warmup=False, drain_timeout_s=5.0),
            slo={"objectives": [
                    {"name": "errors", "kind": "errors",
                     "budget": self.error_budget}],
                 "windows": [{"seconds": 60, "burnThreshold": 1.0}],
                 "evalIntervalS": 0.25},
            max_batch=16, linger_s=0.0)

    # -- the storm surface ---------------------------------------------------
    def submit_tenant_query(self, tenant: str, payload: dict):
        return self._submit(self._post_tenant_query(tenant, payload))

    async def _post_tenant_query(self, tenant: str, payload: dict) -> dict:
        resp, body = await self._post_json(
            f"{self.base_url}/t/{tenant}/queries.json", payload)
        if resp.status != 200:
            raise RuntimeError(f"tenant query HTTP {resp.status}: {body}")
        return body

    def burn_tenant(self, tenant: str, duration_s: float) -> None:
        """Burn one tenant's error budget: malformed queries at its gate
        route answer 400 (counted as tenant failures) until admission
        flips to 429, then keep pressing so the burn holds."""
        import urllib.request

        deadline = time.monotonic() + duration_s
        url = f"{self.base_url}/t/{tenant}/queries.json"
        while time.monotonic() < deadline:
            try:
                req = urllib.request.Request(
                    url, data=b"{not json", method="POST",
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=2) as r:
                    r.read()
            except Exception:
                pass   # 400s and 429s are the point
            time.sleep(0.02)

    def tenant_rejections(self, tenant: str) -> int:
        return int(self.host._rejected.value(tenant=tenant))

    def tenant_resident(self, tenant: str) -> bool:
        return self.host.tenants[tenant].server.resident
