"""Query server — a deployed engine's REST serving (port of the
reference's ``server/query_server.py``):

  GET  /               -> engine/instance info, serving stats, the
                          scorer's status and the kernel launch counts
  POST /queries.json   -> the prediction hot path
  GET  /reload         -> warm-swap to the latest COMPLETED instance
  GET  /releases.json  -> release manifests of this engine variant
  GET  /deploy/status.json -> active and standby releases, fold-in status
  POST /rollback.json  -> restore the resident standby (else the newest
                          older release from the registry)
  POST /stop           -> graceful shutdown

``/reload``, ``/rollback.json`` and ``/stop`` take the ``accessKey``
query parameter when the server was given one (``deploy --accesskey``).

Every swap keeps the outgoing unit resident as the rollback standby
(its batcher is retired); a unit's device copies are dropped only once
it is neither active nor standby. With ``FoldinConfig.enabled`` the
online fold-in controller (``deploy/foldin``) starts with the server and
swaps drifted models in through :meth:`QueryServer.swap_foldin_unit`,
whose standby is the pre-fold-in base. The HTTP layer is the
port's stdlib one (``server/http``), where the reference uses aiohttp.
The error contract is the reference's: a body that is not JSON, or a
query the engine rejects, answers 400 with ``{"message": ...}``.

Concurrent queries coalesce in a :class:`MicroBatcher` into one
``batch_predict`` per algorithm, padded to its power-of-two bucket
(ops/bucketing) before any scorer sees it.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import datetime as _dt
import functools
import json
import logging
import threading
import time
import typing
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.core.engine import Engine, TrainResult
from predictionio_tpu_torch.core.params import params_from_json
from predictionio_tpu_torch.deploy.releases import (
    release_of_instance, release_to_json,
)
from predictionio_tpu_torch.deploy.warm import (
    DeployError, FoldinSwapRaced, ServingUnit, WarmupReport, build_unit,
    compute_vectorized, verify_unit, warmup_unit,
)
from predictionio_tpu_torch.server.http import (
    HttpServer, Request, serve_until_stopped,
)
from predictionio_tpu_torch.ops import kernels
from predictionio_tpu_torch.ops.bucketing import bucket_size, padding_waste
from predictionio_tpu_torch.ops.scoring import (
    set_process_scorer_config, unit_scorer_status,
)
from predictionio_tpu_torch.storage.base import EngineInstance, Release
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.server_config import (
    FoldinConfig, ScorerConfig,
)

logger = logging.getLogger("pio.torch.queryserver")

DEFAULT_PORT = 8000
#: largest micro-batch (the reference's ``batchMax`` default)
MAX_BATCH = 64
#: micro-batches running at once on the predict executor
INFLIGHT = 2

#: ceiling of the adaptive linger window: the batcher never waits
#: longer than this for stragglers, and usually far less (2x the
#: arrival-interval EWMA)
ADAPTIVE_LINGER_MAX_S = 0.002
#: EWMA smoothing for the arrival-interval estimate
_EWMA_ALPHA = 0.2
#: an arrival gap above this resets the estimator
_EWMA_RESET_S = 1.0
#: longest wait for a retired unit's queued and in-flight batches
DRAIN_TIMEOUT_S = 30.0


def _to_jsonable(obj: Any) -> Any:
    if hasattr(obj, "to_dict"):
        return obj.to_dict()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    return obj


def _query_class(train_result: TrainResult) -> Optional[type]:
    """The query dataclass: an explicit `query_class` on an algorithm,
    else the annotation of predict's query parameter."""
    for algo in train_result.algorithms:
        qc = getattr(algo, "query_class", None)
        if qc is not None:
            return qc
        try:
            hints = typing.get_type_hints(type(algo).predict)
        except (NameError, TypeError):
            continue
        qc = hints.get("query")
        if isinstance(qc, type) and dataclasses.is_dataclass(qc):
            return qc
    return None


class MicroBatcher:
    """Cross-request micro-batching onto the resident device model.

    Every request queued while a batch is running is drained into ONE
    ``predict_batch`` call (at most ``max_batch`` queries). Up to
    ``inflight`` batches run at once on ``executor``, so the worker
    assembles batch k+1 while batch k is on the device.

    Linger rule (``linger_s=None``, adaptive): the worker waits for
    stragglers only while another batch is in flight (the device is
    busy, so waiting is free) AND the arrival-interval EWMA says a
    second request is likely within ``ADAPTIVE_LINGER_MAX_S``; then it
    waits ``min(ADAPTIVE_LINGER_MAX_S, 2 * EWMA)``. A lone sequential
    client never pays a linger. A number forces a fixed wait (0 = none).
    """

    def __init__(self, predict_batch, max_batch: int = MAX_BATCH,
                 linger_s: Optional[float] = None, inflight: int = INFLIGHT,
                 executor: Optional[ThreadPoolExecutor] = None):
        self._predict_batch = predict_batch
        self.max_batch = max(1, max_batch)
        self.linger_s = linger_s
        self.adaptive_linger_max_s = ADAPTIVE_LINGER_MAX_S
        self.inflight = max(1, inflight)
        self._executor = executor
        self._queue: Optional[asyncio.Queue] = None
        self._task: Optional[asyncio.Task] = None
        self._sem: Optional[asyncio.Semaphore] = None
        self._inflight_now = 0
        self._ewma_interval: Optional[float] = None
        self._last_arrival: Optional[float] = None
        #: sizes of the batches dispatched so far (count per size)
        self.batch_sizes: collections.Counter = collections.Counter()

    # -- arrival-rate estimate (adaptive linger input) -----------------------
    def _note_arrival(self) -> None:
        now = time.monotonic()
        last, self._last_arrival = self._last_arrival, now
        if last is None:
            return
        dt = now - last
        if dt > _EWMA_RESET_S:
            self._ewma_interval = None
        elif self._ewma_interval is None:
            self._ewma_interval = dt
        else:
            self._ewma_interval += _EWMA_ALPHA * (dt - self._ewma_interval)

    def _linger_window(self) -> float:
        if self.linger_s is not None:
            return self.linger_s
        if self._inflight_now == 0:
            return 0.0
        ewma = self._ewma_interval
        if ewma is None or ewma > self.adaptive_linger_max_s:
            return 0.0
        return min(self.adaptive_linger_max_s, 2.0 * ewma)

    def idle(self) -> bool:
        """Nothing queued and no batch in flight."""
        return ((self._queue is None or self._queue.empty())
                and self._inflight_now == 0)

    async def shutdown(self) -> None:
        """Cancel the worker; its drain fails everything still queued."""
        task = self._task
        if task is not None and not task.done():
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    # -- submit/worker -------------------------------------------------------
    async def submit(self, query):
        loop = asyncio.get_running_loop()
        self._note_arrival()
        fut = loop.create_future()
        while True:
            if self._task is None or self._task.done():
                self._queue = asyncio.Queue()
                self._sem = asyncio.Semaphore(self.inflight)
                self._task = loop.create_task(
                    self._worker(self._queue, self._sem))
            task, queue = self._task, self._queue
            queue.put_nowait((query, fut))
            if not task.done() or fut.done():
                return await fut
            # the worker completed between the liveness check and the
            # put: its drain may have missed our entry — requeue onto a
            # fresh worker

    async def _worker(self, queue: asyncio.Queue, sem: asyncio.Semaphore):
        loop = asyncio.get_running_loop()
        batch = []
        try:
            while True:
                batch = [await queue.get()]
                # an in-flight slot BEFORE assembling: while every slot is
                # busy the queue keeps filling, which IS the batching signal
                await sem.acquire()
                dispatched = False
                try:
                    while len(batch) < self.max_batch and not queue.empty():
                        batch.append(queue.get_nowait())
                    linger = self._linger_window()
                    if linger > 0.0 and len(batch) < self.max_batch:
                        await asyncio.sleep(linger)
                        while (len(batch) < self.max_batch
                               and not queue.empty()):
                            batch.append(queue.get_nowait())
                    self.batch_sizes[len(batch)] += 1
                    ex_fut = loop.run_in_executor(
                        self._executor, self._predict_batch,
                        [entry[0] for entry in batch])
                    self._inflight_now += 1
                    ex_fut.add_done_callback(
                        functools.partial(self._finish_batch, batch, sem))
                    dispatched = True
                finally:
                    if not dispatched:
                        sem.release()
                batch = []
        finally:
            # fail everything not yet dispatched so no handler hangs
            while not queue.empty():
                batch.append(queue.get_nowait())
            for _query, fut in batch:
                if not fut.done():
                    fut.set_exception(
                        RuntimeError("query micro-batch worker stopped"))

    def _finish_batch(self, batch, sem: asyncio.Semaphore, ex_fut) -> None:
        """On the event loop when a dispatched batch settles: free the
        slot, then route per-query results/errors to their handlers."""
        self._inflight_now -= 1
        sem.release()
        try:
            results = ex_fut.result()
        except BaseException as e:   # noqa: BLE001 — must never orphan futs
            err = e if isinstance(e, Exception) else \
                RuntimeError(f"micro-batch dispatch failed: {e!r}")
            results = [err] * len(batch)
        for (_query, fut), res in zip(batch, results):
            if fut.done():
                continue
            if isinstance(res, Exception):
                fut.set_exception(res)
            else:
                fut.set_result(res)


class QueryServer:
    """Serves one deployed TrainResult and swaps in retrained ones
    (``/reload``). ``start`` binds the socket on the running event loop;
    :func:`run_query_server` is the blocking form."""

    def __init__(self, engine: Engine, train_result: TrainResult,
                 instance: EngineInstance,
                 scorer_config: Optional[ScorerConfig] = None,
                 max_batch: int = MAX_BATCH,
                 linger_s: Optional[float] = None,
                 inflight: int = INFLIGHT,
                 release: Optional[Release] = None,
                 access_key: Optional[str] = None,
                 foldin_config: Optional[FoldinConfig] = None):
        self.engine = engine
        self.start_time = _dt.datetime.now(tz=_dt.timezone.utc)
        self.max_batch = max(1, max_batch)
        #: resolved scoring-kernel knobs, pinned process-wide so every
        #: scoring surface (models, warm-up) sees ONE mode
        self.scorer_config = scorer_config or ScorerConfig.from_env()
        set_process_scorer_config(self.scorer_config)
        #: guards /reload and /stop when set (``deploy --accesskey``)
        self.access_key = access_key
        #: where a reloaded instance's models go: the deployed models'
        self.device = getattr(train_result.models[0], "device", None) \
            if train_result.models else None
        self._predict_executor = ThreadPoolExecutor(
            max_workers=max(4, inflight * 2),
            thread_name_prefix="pio-predict")
        #: load, warm-up and verify of a reloaded unit run here, so the
        #: serving unit keeps every predict slot
        self._deploy_executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="pio-deploy")
        self._linger_s = linger_s
        self._inflight = inflight
        self._unit = ServingUnit(
            instance=instance, result=train_result,
            vectorized=compute_vectorized(train_result), release=release)
        self._attach_batcher(self._unit)
        #: the unit the last swap replaced, kept resident for an instant
        #: rollback (a fold-in drift's is its pre-fold-in base)
        self._standby: Optional[ServingUnit] = None
        #: online fold-in knobs; the controller starts with the server
        self.foldin_config = foldin_config or FoldinConfig.from_env()
        self._foldin = None
        self._swap_lock = threading.Lock()
        #: one reload at a time
        self._reload_lock = asyncio.Lock()
        self._tasks: set = set()
        self._http = HttpServer([
            ("GET", "/", self.handle_root),
            ("POST", "/queries.json", self.handle_query),
            ("GET", "/reload", self.handle_reload),
            ("GET", "/releases.json", self.handle_releases),
            ("GET", "/deploy/status.json", self.handle_deploy_status),
            ("POST", "/rollback.json", self.handle_rollback),
            ("POST", "/stop", self.handle_stop),
        ])
        #: set by POST /stop; :func:`run_query_server` then shuts down
        self.stopped = asyncio.Event()
        self._stats_lock = threading.Lock()
        self._query_count = 0
        self._query_seconds = 0.0
        self._recent = collections.deque(maxlen=1024)
        self.last_serving_sec = 0.0
        self.last_warmup: Optional[WarmupReport] = None
        self.warmup_launches: Dict[str, int] = {}

    @property
    def result(self) -> TrainResult:
        return self._unit.result

    @property
    def instance(self) -> EngineInstance:
        return self._unit.instance

    @property
    def batcher(self) -> MicroBatcher:
        return self._unit.batcher

    def _attach_batcher(self, unit: ServingUnit) -> None:
        unit.batcher = MicroBatcher(
            functools.partial(self._predict_batch_unit, unit),
            max_batch=self.max_batch, linger_s=self._linger_s,
            inflight=self._inflight, executor=self._predict_executor)

    # -- deploy phases -------------------------------------------------------
    def warm(self) -> WarmupReport:
        """Warm-up ladder then verify, on the caller's thread, before
        the server takes traffic."""
        report = warmup_unit(self._unit, self._predict_batch,
                             self.max_batch)
        verify_unit(self._unit, self._predict_batch)
        self.last_warmup = report
        # GET / counts the kernel launches of served queries only: the
        # counts are zeroed here, just before the server takes traffic
        self.warmup_launches = kernels.counts()
        kernels.reset_counts()
        return report

    def _prepare_unit(self, instance: EngineInstance,
                      release: Optional[Release]
                      ) -> Tuple[ServingUnit, WarmupReport]:
        """Load -> warm-up -> verify of a unit that does not take
        traffic yet (on the deploy executor)."""
        unit = build_unit(self.engine, instance, release,
                          device=self.device)
        self._attach_batcher(unit)
        predict = functools.partial(self._predict_batch_unit, unit)
        report = warmup_unit(unit, predict, self.max_batch)
        verify_unit(unit, predict)
        return unit, report

    def _swap_to(self, unit: ServingUnit, reason: str = "reload",
                 retire_old: bool = True) -> ServingUnit:
        """The cutover: one reference assignment installs the new unit;
        the old one becomes the standby, and its batcher drains in the
        background. ``retire_old=False`` leaves the outgoing release's
        status to the caller (rollback marks it ROLLED_BACK)."""
        with self._swap_lock:
            old, self._unit = self._unit, unit
            dropped, self._standby = self._standby, old
        self._spawn(self._retire(old))
        if dropped is not None and dropped is not unit:
            self._spawn(self._retire(dropped))
        self._set_release_status(unit.release, "LIVE", reason)
        if retire_old and old.release is not None and (
                unit.release is None or old.release.id != unit.release.id):
            self._set_release_status(old.release, "RETIRED",
                                     f"superseded: {reason}")
        logger.info("swapped to engine instance %s (release v%d, %s)",
                    unit.instance.id, unit.release_version, reason)
        return old

    def _spawn(self, coro) -> None:
        task = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _retire(self, unit: ServingUnit) -> None:
        """Let a replaced unit's queued and in-flight batches finish on
        it, then stop its batcher; drop its device-resident copies only
        if it is neither active nor standby by then (a standby keeps
        them for an instant rollback). A unit made active again meanwhile
        is left alone: its batcher serves."""
        batcher = unit.batcher
        deadline = time.monotonic() + DRAIN_TIMEOUT_S
        while batcher is not None and not batcher.idle() \
                and time.monotonic() < deadline:
            if unit is self._unit:
                return
            await asyncio.sleep(0.02)
        if unit is self._unit:
            return
        if batcher is not None:
            await batcher.shutdown()
        if unit is self._standby:
            return
        for model in unit.result.models:
            release = getattr(model, "release_device", None)
            if release is not None:
                release()

    # -- online fold-in cutover (deploy/foldin.py) ---------------------------
    def build_foldin_unit(self, new_models, applied_rows: int,
                          drift_release: Optional[Release] = None,
                          base_unit: Optional[ServingUnit] = None
                          ) -> ServingUnit:
        """A fold-in drift of ``base_unit`` (default: the active unit):
        same instance, new models, ``foldin_of`` pinned to the
        pre-fold-in base so every later drift and the rollback find it."""
        base = base_unit if base_unit is not None else self._unit
        result = dataclasses.replace(base.result, models=list(new_models))
        unit = ServingUnit(
            instance=base.instance, result=result,
            vectorized=compute_vectorized(result),
            release=drift_release or base.release)
        unit.foldin_of = base.foldin_of or base
        unit.foldin_rows = base.foldin_rows + applied_rows
        return unit

    def swap_foldin_unit(self, unit: ServingUnit, loop=None,
                         expected_base: Optional[ServingUnit] = None
                         ) -> None:
        """The fold-in cutover, callable from any thread: the ``/reload``
        swap as a compare-and-swap against ``expected_base`` (the unit
        the solve read). A reload or rollback that landed meanwhile wins:
        :class:`FoldinSwapRaced` is raised and the controller requeues its
        deltas. The standby becomes the pre-fold-in base; the replaced
        unit's batcher is retired on ``loop`` when one runs."""
        if unit.batcher is None:
            self._attach_batcher(unit)
        with self._swap_lock:
            if expected_base is not None and self._unit is not expected_base:
                raise FoldinSwapRaced(
                    "serving unit changed during the fold-in solve (now "
                    f"instance {self._unit.instance.id})")
            old, self._unit = self._unit, unit
            dropped, self._standby = self._standby, unit.foldin_of
        if loop is not None and loop.is_running():
            for gone in {id(u): u for u in (old, dropped)
                         if u is not None and u is not unit}.values():
                loop.call_soon_threadsafe(
                    lambda u=gone: self._spawn(self._retire(u)))

    def _set_release_status(self, release: Optional[Release], status: str,
                            reason: str) -> None:
        """Best-effort lineage write-back, off the event loop (a registry
        outage must not stall serving)."""
        if release is None:
            return
        release.status = status

        def write():
            try:
                Storage.get_meta_data_releases().set_status(
                    release.id, status, reason=reason)
            except Exception:
                logger.exception("release status update failed (%s -> %s)",
                                 release.id, status)

        self._deploy_executor.submit(write)

    # -- HTTP ----------------------------------------------------------------
    async def start(self, host: str = "localhost", port: int = DEFAULT_PORT
                    ) -> int:
        """Bind and start accepting; returns the bound port (``port=0``
        picks a free one). Starts the fold-in controller when enabled."""
        bound = await self._http.start(host, port)
        self._start_foldin()
        return bound

    def _start_foldin(self) -> None:
        """Start the online fold-in controller when it is enabled and the
        engine resolves exactly one fold-in algorithm; otherwise serve as
        before."""
        if not self.foldin_config.enabled or self._foldin is not None:
            return
        from predictionio_tpu_torch.deploy.foldin import (
            FoldInController, FoldinUnsupported,
        )

        try:
            self._foldin = FoldInController(self, self.foldin_config)
        except FoldinUnsupported as e:
            logger.warning("online fold-in disabled: %s", e)
            return
        self._foldin.start()
        logger.info("online fold-in armed: interval %.2fs, max pending %d",
                    self.foldin_config.apply_interval_s,
                    self.foldin_config.max_pending)

    def foldin_status(self) -> dict:
        return (self._foldin.status_dict() if self._foldin is not None
                else {"enabled": False})

    async def close(self) -> None:
        """Stop accepting, stop fold-in, join an in-flight apply or
        reload, settle the retirements, then stop the batchers."""
        await self._http.close()
        if self._foldin is not None:
            await self._foldin.aclose()
        await asyncio.get_running_loop().run_in_executor(
            None, functools.partial(self._deploy_executor.shutdown,
                                    wait=True))
        while pending := [t for t in self._tasks if not t.done()]:
            await asyncio.gather(*pending, return_exceptions=True)
        for unit in (self._unit, self._standby):
            if unit is not None and unit.batcher is not None:
                await unit.batcher.shutdown()
        self._predict_executor.shutdown(wait=False)

    def _authorized(self, req: Request) -> bool:
        return not self.access_key or \
            req.query.get("accessKey") == self.access_key

    # -- info ---------------------------------------------------------------
    async def handle_root(self, _req: Request) -> Tuple[int, Any]:
        """Engine/instance info + serving stats; also the scorer status,
        the kernel launch counts of this process since it was warm (a
        ``/reload``'s warm-up and the fold-in solves count among them) and
        the fold-in status."""
        with self._stats_lock:
            count, total = self._query_count, self._query_seconds
            recent = list(self._recent)
        uptime = (_dt.datetime.now(tz=_dt.timezone.utc)
                  - self.start_time).total_seconds()
        unit = self._unit
        return 200, {
            "status": "alive",
            "engineInstance": {
                "id": unit.instance.id,
                "engineId": unit.instance.engine_id,
                "engineVariant": unit.instance.engine_variant,
                "startTime": unit.instance.start_time.isoformat(),
                "releaseVersion": unit.release_version or None,
            },
            "algorithms": [type(a).__name__ for a in unit.result.algorithms],
            "startTime": self.start_time.isoformat(),
            "uptimeSeconds": uptime,
            "requestCount": count,
            "queryCount": count,
            "avgServingSec": (total / count) if count else 0.0,
            "p95ServingSec": (float(np.percentile(recent, 95))
                              if recent else 0.0),
            "lastServingSec": self.last_serving_sec,
            "scorer": unit_scorer_status(unit.result),
            "warmup": (self.last_warmup.to_dict()
                       if self.last_warmup is not None else None),
            "kernelLaunches": kernels.counts(),
            "warmupKernelLaunches": self.warmup_launches,
            "foldin": self.foldin_status(),
        }

    # -- deploy lifecycle ----------------------------------------------------
    def _latest(self) -> Tuple[Optional[EngineInstance], Optional[Release]]:
        inst = self.instance
        latest = Storage.get_meta_data_engine_instances(
        ).get_latest_completed(inst.engine_id, inst.engine_version,
                               inst.engine_variant)
        release = None
        if latest is not None:
            try:
                release = release_of_instance(
                    Storage.get_meta_data_releases(), latest)
            except Exception:
                logger.exception("release lookup failed")
        return latest, release

    async def handle_reload(self, req: Request) -> Tuple[int, Any]:
        """Warm-swap to the latest COMPLETED instance of this variant:
        load, warm up and verify it off the event loop, then swap."""
        if not self._authorized(req):
            return 401, {"message": "Unauthorized"}
        loop = asyncio.get_running_loop()
        async with self._reload_lock:
            t0 = time.perf_counter()
            latest, release = await loop.run_in_executor(
                self._deploy_executor, self._latest)
            if latest is None:
                return 404, {"message": "No COMPLETED instance found"}
            try:
                unit, report = await loop.run_in_executor(
                    self._deploy_executor, self._prepare_unit, latest,
                    release)
            except DeployError as e:
                return 500, {"message": str(e)}
            self._swap_to(unit, reason="reload")
            self.last_warmup = report
            return 200, {
                "message": "Reloaded",
                "engineInstanceId": latest.id,
                "releaseVersion": unit.release_version or None,
                "warmup": report.to_dict(),
                "seconds": time.perf_counter() - t0}

    async def handle_releases(self, _req: Request) -> Tuple[int, Any]:
        """Release manifests of this engine variant, newest first."""
        inst = self.instance

        def listing():
            try:
                return [release_to_json(r) for r in
                        Storage.get_meta_data_releases().get_for_variant(
                            inst.engine_id, inst.engine_version,
                            inst.engine_variant)]
            except Exception:
                logger.exception("release listing failed")
                return []

        out = await asyncio.get_running_loop().run_in_executor(
            self._deploy_executor, listing)
        return 200, {"releases": out, "serving": {
            "engineInstanceId": inst.id,
            "releaseVersion": self._unit.release_version or None}}

    async def handle_rollback(self, req: Request) -> Tuple[int, Any]:
        """Operator rollback: restore the resident standby (the previous
        release, or a fold-in drift's pre-fold-in base), else load the
        newest older release from the registry. The release rolled away
        from is marked ROLLED_BACK, and the standby is cleared so a
        second rollback never flips back onto it."""
        if not self._authorized(req):
            return 401, {"message": "Unauthorized"}
        loop = asyncio.get_running_loop()
        async with self._reload_lock:
            t0 = time.perf_counter()
            target = self._standby
            if target is None:
                target = await loop.run_in_executor(
                    self._deploy_executor, self._load_previous_release)
            if target is None:
                return 404, {"message": "No previous release to roll "
                                        "back to."}
            rolled_back = self._swap_to(target, reason="operator rollback",
                                        retire_old=False)
            self._set_release_status(rolled_back.release, "ROLLED_BACK",
                                     "operator rollback")
            self._standby = None
            return 200, {
                "message": "Rolled back",
                "engineInstanceId": target.instance.id,
                "releaseVersion": target.release_version or None,
                "seconds": time.perf_counter() - t0}

    def _load_previous_release(self) -> Optional[ServingUnit]:
        """The registry's rollback target when no standby is resident
        (the server restarted since the last swap): the newest RETIRED
        or LIVE release below the active version whose instance is
        COMPLETED, loaded, warmed up and verified (on the deploy
        executor)."""
        inst = self.instance
        try:
            releases = Storage.get_meta_data_releases()
            instances = Storage.get_meta_data_engine_instances()
            active_v = self._unit.release_version
            for r in releases.get_for_variant(
                    inst.engine_id, inst.engine_version,
                    inst.engine_variant):
                if active_v and r.version >= active_v:
                    continue
                if r.status not in ("RETIRED", "LIVE"):
                    continue
                target = instances.get(r.instance_id)
                if target is not None and target.status == "COMPLETED":
                    return self._prepare_unit(target, r)[0]
        except DeployError:
            logger.exception("previous release failed to prepare")
        except Exception:
            logger.exception("rollback target lookup failed")
        return None

    async def handle_deploy_status(self, _req: Request) -> Tuple[int, Any]:
        """The active and standby units and the fold-in status (the
        canary comes with the canary's port)."""
        unit, standby = self._unit, self._standby
        return 200, {
            "active": {
                "engineInstanceId": unit.instance.id,
                "releaseVersion": unit.release_version or None,
                "vectorized": unit.vectorized,
                "foldinRows": unit.foldin_rows,
            },
            "standby": ({
                "engineInstanceId": standby.instance.id,
                "releaseVersion": standby.release_version or None,
            } if standby is not None else None),
            "canary": None,
            "lastWarmup": (self.last_warmup.to_dict()
                           if self.last_warmup is not None else None),
            "foldin": self.foldin_status(),
            "scorer": unit_scorer_status(unit.result),
        }

    async def handle_stop(self, req: Request) -> Tuple[int, Any]:
        if not self._authorized(req):
            return 401, {"message": "Unauthorized"}
        # after the answer has gone out
        asyncio.get_running_loop().call_later(0.2, self.stopped.set)
        return 200, {"message": "Shutting down"}

    # -- hot path ------------------------------------------------------------
    async def handle_query(self, req: Request) -> Tuple[int, Any]:
        t0 = time.perf_counter()
        try:
            data = req.json()
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            return 400, {"message": str(e)}
        unit = self._unit
        try:
            query = self._extract_query(data)
            prediction = await self._predict_via(unit, query)
        except Exception as e:
            logger.exception("query failed")
            return 400, {"message": str(e)}
        dt = time.perf_counter() - t0
        with self._stats_lock:
            self._query_count += 1
            self._query_seconds += dt
            self._recent.append(dt)
        self.last_serving_sec = dt
        return 200, _to_jsonable(prediction)

    def _extract_query(self, body):
        qc = _query_class(self.result)
        if qc is None:
            return body
        if not isinstance(body, dict):
            raise ValueError("a query must be a JSON object")
        return params_from_json(body, qc)

    async def _predict_via(self, unit: ServingUnit, query):
        """Through the unit's batcher when vectorized, else per-request
        on the predict pool."""
        if unit.vectorized:
            return await unit.batcher.submit(query)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._predict_executor, self._predict_unit, unit, query)

    def _predict_unit(self, unit: ServingUnit, query):
        result = unit.result
        supplemented = result.serving.supplement(query)
        predictions = [
            algo.predict(model, supplemented)
            for algo, model in zip(result.algorithms, result.models)]
        return result.serving.serve(query, predictions)

    def _predict_batch(self, queries):
        """Active-unit batch path (warm-up and tests call this)."""
        return self._predict_batch_unit(self._unit, queries)

    def _predict_batch_unit(self, unit: ServingUnit, queries):
        """Batch path behind each unit's MicroBatcher (on the predict
        executor). Per-query errors are isolated: a failing query yields
        its Exception in the result slot. The batch pads up to its
        power-of-two bucket with clones of the last real query under
        sentinel indices; pad rows are sliced off here."""
        result = unit.result
        n = len(queries)
        out: List[Any] = [None] * n
        ok = []
        for i, q in enumerate(queries):
            try:
                ok.append((i, result.serving.supplement(q)))
            except Exception as e:
                out[i] = e
        if not ok:
            return out
        bucket = bucket_size(len(ok), self.max_batch)
        waste = padding_waste(len(ok), bucket)
        if waste:
            pad_q = ok[-1][1]
            batch = ok + [(n + j, pad_q) for j in range(waste)]
        else:
            batch = ok
        try:
            per_query = {i: [] for i, _ in ok}
            for algo, model in zip(result.algorithms, result.models):
                for i, p in algo.batch_predict(model, batch):
                    if i in per_query:      # pad rows sliced off
                        per_query[i].append(p)
            for i, _ in ok:
                try:
                    out[i] = result.serving.serve(queries[i], per_query[i])
                except Exception as e:
                    out[i] = e
        except Exception:
            # the batch path failed (a poison query inside a vectorized
            # batch_predict): isolate by per-query predict
            for i, sq in ok:
                try:
                    preds = [a.predict(m, sq) for a, m in
                             zip(result.algorithms, result.models)]
                    out[i] = result.serving.serve(queries[i], preds)
                except Exception as e:
                    out[i] = e
        return out


def create_query_server(engine: Engine, train_result: TrainResult,
                        instance: EngineInstance, **kwargs) -> QueryServer:
    return QueryServer(engine, train_result, instance, **kwargs)


def run_query_server(server: QueryServer, host: str = "localhost",
                     port: int = DEFAULT_PORT, on_ready=None) -> None:
    """Serve until ``POST /stop``, SIGINT or SIGTERM. ``on_ready(port)``
    runs once the socket is bound."""
    serve_until_stopped(server, host, port, on_ready)
