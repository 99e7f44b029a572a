"""Query server — a deployed engine's REST serving (port of the
reference's ``server/query_server.py``):

  GET  /               -> engine/instance info, serving stats, the
                          scorer's status, the kernel launch counts and
                          the feedback writes
  POST /queries.json   -> the prediction hot path
  GET  /reload         -> warm-swap to the latest COMPLETED instance
  POST /deploy.json    -> warm-deploy a release (``engineInstanceId``,
                          ``releaseId`` or ``version``): a full cutover,
                          or a canary (``canaryFraction``) or shadow
                          (``shadow``) rollout judged against the
                          incumbent
  GET  /releases.json  -> release manifests of this engine variant
  GET  /deploy/status.json -> active, standby and canary units, the
                          deploy counters, fold-in status
  POST /rollback.json  -> abort an undecided canary, else restore the
                          resident standby (else the newest older
                          release from the registry)
  GET  /plugins.json   -> the registered output blockers and sniffers
  POST /stop           -> graceful shutdown

``/reload``, ``/deploy.json``, ``/rollback.json`` and ``/stop`` take
the ``accessKey`` query parameter when the server was given one
(``deploy --accesskey``).

Every swap keeps the outgoing unit resident as the rollback standby
(its batcher is retired); a unit's device copies are dropped only once
it is neither active, standby nor a canary. A cutover's release-status
writes (LIVE, RETIRED, CANARY, ROLLED_BACK) land before the request
that caused it answers, so the registry never trails the server. With
``FoldinConfig.enabled`` the online fold-in controller (``deploy/foldin``)
starts with the server and swaps drifted models in through
:meth:`QueryServer.swap_foldin_unit`, whose standby is the pre-fold-in
base; it holds its deltas while a canary is judged.

A staged rollout (``deploy/canary``) routes each query once, by the
canary's error-diffusion splitter, to the incumbent's or the
candidate's own micro-batcher; under shadow every query is answered by
the incumbent and mirrored into the candidate off the response path.
Each outcome feeds the judge, whose verdict (promote or rollback) is
acted on off the request path.

On an answer, the feedback loop (``deploy --feedback``) tags it with a
``prId`` and records a ``predict`` event off the response path; output
blockers then transform it and output sniffers observe it
(``server/plugins``). A failed query answers 400 at once and, with
``deploy --log-url``, posts its error to that URL in the background.
The HTTP layer is the port's stdlib one (``server/http``), where the
reference uses aiohttp. The error contract is the reference's: a body
that is not JSON, or a query the engine rejects, answers 400 with
``{"message": ...}``.

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
import urllib.request
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.core.engine import Engine, TrainResult
from predictionio_tpu_torch.core.params import params_from_json
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.deploy.canary import (
    ROLE_CANARY, ROLE_INCUMBENT, ROLE_SHADOW, CanaryConfig,
    CanaryController,
)
from predictionio_tpu_torch.deploy.releases import (
    release_of_instance, release_to_json, resolve_release,
)
from predictionio_tpu_torch.deploy.warm import (
    DeployError, FoldinSwapRaced, ServingUnit, WarmupReport, build_unit,
    compute_vectorized, verify_unit, warmup_unit,
)
from predictionio_tpu_torch.server.http import (
    HttpServer, Request, serve_until_stopped,
)
from predictionio_tpu_torch.server.plugins import (
    ENGINESERVER_GROUP, PluginContext,
)
from predictionio_tpu_torch.ops import kernels
from predictionio_tpu_torch.ops.bucketing import bucket_size, padding_waste
from predictionio_tpu_torch.ops.scoring import (
    set_process_scorer_config, unit_scorer_status,
)
from predictionio_tpu_torch.storage.base import (
    EngineInstance, Release, generate_id,
)
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.server_config import (
    DeployConfig, FoldinConfig, ScorerConfig,
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
#: the remote error log's POST gives up after this
REMOTE_LOG_TIMEOUT_S = 5.0
#: lifecycle events (swaps, canary starts and verdicts) kept for
#: ``GET /deploy/status.json``
RECENT_DEPLOY_EVENTS = 64


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


def _post_remote_log(url: str, payload: str) -> None:
    """POST one remote-log payload (on its own daemon thread); a
    delivery failure is logged here and goes no further."""
    try:
        req = urllib.request.Request(
            url, data=payload.encode(), method="POST",
            headers={"Content-Type": "text/plain; charset=utf-8"})
        with urllib.request.urlopen(req, timeout=REMOTE_LOG_TIMEOUT_S):
            pass
    except Exception as e:
        logger.error("Unable to send remote log: %s", e)


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


@dataclasses.dataclass
class CanaryState:
    """One staged rollout in flight: the candidate unit and its judge."""

    unit: ServingUnit
    controller: CanaryController
    config: CanaryConfig
    #: set once the verdict is being acted on: one action per rollout,
    #: whoever comes second waits for it
    settling: Optional[asyncio.Future] = None


class QueryServer:
    """Serves one deployed TrainResult and swaps in others (``/reload``,
    ``/deploy.json``, ``/rollback.json``, fold-in). ``start`` binds the
    socket on the running event loop; :func:`run_query_server` is the
    blocking form."""

    def __init__(self, engine: Engine, train_result: TrainResult,
                 instance: EngineInstance,
                 scorer_config: Optional[ScorerConfig] = None,
                 max_batch: int = MAX_BATCH,
                 linger_s: Optional[float] = None,
                 inflight: int = INFLIGHT,
                 release: Optional[Release] = None,
                 access_key: Optional[str] = None,
                 foldin_config: Optional[FoldinConfig] = None,
                 deploy_config: Optional[DeployConfig] = None,
                 feedback: bool = False,
                 feedback_app_name: Optional[str] = None,
                 log_url: Optional[str] = None,
                 log_prefix: str = "",
                 plugin_context: Optional[PluginContext] = None):
        self.engine = engine
        self.start_time = _dt.datetime.now(tz=_dt.timezone.utc)
        self.max_batch = max(1, max_batch)
        #: resolved scoring-kernel knobs, pinned process-wide so every
        #: scoring surface (models, warm-up) sees ONE mode
        self.scorer_config = scorer_config or ScorerConfig.from_env()
        set_process_scorer_config(self.scorer_config)
        #: guards /reload, /deploy.json, /rollback.json and /stop when
        #: set (``deploy --accesskey``)
        self.access_key = access_key
        #: warm-up, drain and canary defaults
        self.deploy_config = deploy_config or DeployConfig.from_env()
        #: the feedback loop: every answer is recorded as a ``predict``
        #: event of this app, resolved once here (a lookup per query
        #: would sit on the hot path)
        self.feedback = feedback
        self.feedback_app_name = feedback_app_name
        self._feedback_target = None
        if feedback and feedback_app_name:
            from predictionio_tpu_torch.data.eventstore import resolve_app

            self._feedback_target = resolve_app(feedback_app_name)
        #: remote error sink: a failed query POSTs log_prefix + JSON of
        #: the instance and the error here
        self.log_url = log_url
        self.log_prefix = log_prefix
        self.plugins = plugin_context or PluginContext(ENGINESERVER_GROUP)
        #: where a reloaded instance's models go: the deployed models'
        self.device = getattr(train_result.models[0], "device", None) \
            if train_result.models else None
        #: predictions only: feedback writes and the remote log never
        #: take a predict slot
        self._predict_executor = ThreadPoolExecutor(
            max_workers=max(4, inflight * 2),
            thread_name_prefix="pio-predict")
        #: load, warm-up and verify of a new unit, the release-status
        #: writes (in submission order) and the fold-in applies run here,
        #: so the serving unit keeps every predict slot
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
        #: the staged rollout being judged, if any
        self._canary: Optional[CanaryState] = None
        #: online fold-in knobs; the controller starts with the server
        self.foldin_config = foldin_config or FoldinConfig.from_env()
        self._foldin = None
        self._swap_lock = threading.Lock()
        #: one reload, deploy or rollback at a time
        self._reload_lock = asyncio.Lock()
        self._tasks: set = set()
        self._http = HttpServer([
            ("GET", "/", self.handle_root),
            ("POST", "/queries.json", self.handle_query),
            ("GET", "/reload", self.handle_reload),
            ("POST", "/deploy.json", self.handle_deploy),
            ("GET", "/releases.json", self.handle_releases),
            ("GET", "/deploy/status.json", self.handle_deploy_status),
            ("POST", "/rollback.json", self.handle_rollback),
            ("GET", "/plugins.json", self.handle_plugins),
            ("POST", "/stop", self.handle_stop),
        ])
        #: set by POST /stop; :func:`run_query_server` then shuts down
        self.stopped = asyncio.Event()
        self._stats_lock = threading.Lock()
        self._query_count = 0
        self._query_seconds = 0.0
        self._recent = collections.deque(maxlen=1024)
        #: the deploy counters (the reference's ``pio_deploy_*`` series):
        #: queries by role, promotes by reason, rollbacks by reason slug,
        #: swaps by "mode/outcome"
        self._deploy_counts: Dict[str, collections.Counter] = {
            k: collections.Counter()
            for k in ("requests", "promotes", "rollbacks", "swaps")}
        self._deploy_events = collections.deque(maxlen=RECENT_DEPLOY_EVENTS)
        #: the feedback loop's event-store writes
        self._feedback_writes = 0
        self._feedback_failures = 0
        self._feedback_seconds = collections.deque(maxlen=1024)
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

    def _count(self, counter: str, key: str) -> None:
        with self._stats_lock:
            self._deploy_counts[counter][key] += 1

    def _record(self, kind: str, **fields) -> None:
        """One lifecycle event (the reference's ``record_event``), kept
        for ``GET /deploy/status.json``."""
        self._deploy_events.append(
            {"kind": kind, "timeMs": int(time.time() * 1000), **fields})

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

    def _effective_warmup(self, override: Optional[bool]) -> bool:
        """A deploy body's ``warmup`` beats the DeployConfig's."""
        return bool(self.deploy_config.warmup if override is None
                    else override)

    def _prepare_unit(self, instance: EngineInstance,
                      release: Optional[Release],
                      warmup: Optional[bool] = None,
                      warmup_query_json: Optional[dict] = None
                      ) -> Tuple[ServingUnit, WarmupReport, dict]:
        """Load -> warm-up -> verify of a unit that does not take
        traffic yet (on the deploy executor). Returns the unit, the
        warm-up report and the phases' seconds (``loadS``, ``warmupS``,
        ``verifyS``) with the status of the scorer it built (its
        ``buildSeconds``, ``gateSeconds`` and ``recallProbe``)."""
        t0 = time.perf_counter()
        unit = build_unit(self.engine, instance, release,
                          device=self.device)
        t1 = time.perf_counter()
        self._attach_batcher(unit)
        predict = functools.partial(self._predict_batch_unit, unit)
        query = (self._extract_query(warmup_query_json)
                 if warmup_query_json is not None else None)
        if self._effective_warmup(warmup):
            report = warmup_unit(unit, predict, self.max_batch, query)
        else:
            report = WarmupReport(skipped="disabled")
        t2 = time.perf_counter()
        verify_unit(unit, predict, query)
        t3 = time.perf_counter()
        logger.info("prepared instance %s: load %.3fs, warm-up %.3fs, "
                    "verify %.3fs", instance.id, t1 - t0, t2 - t1, t3 - t2)
        return unit, report, {
            "loadS": t1 - t0, "warmupS": t2 - t1, "verifyS": t3 - t2,
            "scorer": unit_scorer_status(unit.result)}

    async def _swap_to(self, unit: ServingUnit, mode: str, reason: str,
                       retire_old: bool = True,
                       keep_standby: bool = True) -> ServingUnit:
        """The cutover: one reference assignment installs the new unit;
        the old one becomes the standby (unless ``keep_standby`` is
        False: a rollback never flips back onto what it left), and its
        batcher drains in the background. The release-status writes
        land before this returns. ``retire_old=False`` leaves the
        outgoing release's status to the caller (rollback marks it
        ROLLED_BACK)."""
        with self._swap_lock:
            old, self._unit = self._unit, unit
            dropped = self._standby
            self._standby = old if keep_standby else None
        self._count("swaps", f"{mode}/ok")
        self._record("swap", mode=mode, reason=reason,
                     engineInstanceId=unit.instance.id,
                     releaseVersion=unit.release_version or None)
        self._spawn(self._retire(old))
        if dropped is not None and dropped is not unit:
            self._spawn(self._retire(dropped))
        writes = [self._set_release_status(unit.release, "LIVE", reason)]
        if retire_old and old.release is not None and (
                unit.release is None or old.release.id != unit.release.id):
            writes.append(self._set_release_status(
                old.release, "RETIRED", f"superseded: {reason}"))
        logger.info("swapped to engine instance %s (release v%d, %s: %s)",
                    unit.instance.id, unit.release_version, mode, reason)
        await self._settle_writes(writes)
        return old

    def _spawn(self, coro) -> None:
        task = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _retire(self, unit: ServingUnit) -> None:
        """Let a replaced unit's queued and in-flight batches finish on
        it, then stop its batcher; drop its device-resident copies only
        if it is neither active, standby nor a canary by then (a standby
        keeps them for an instant rollback). A unit made active again
        meanwhile is left alone: its batcher serves."""
        batcher = unit.batcher
        deadline = time.monotonic() + self.deploy_config.drain_timeout_s
        while batcher is not None and not batcher.idle() \
                and time.monotonic() < deadline:
            if unit is self._unit:
                return
            await asyncio.sleep(0.02)
        if unit is self._unit:
            return
        if batcher is not None:
            await batcher.shutdown()
        canary = self._canary
        if unit is self._standby or (canary is not None
                                     and unit is canary.unit):
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
        the solve read). A reload, deploy or rollback that landed
        meanwhile wins, and so does a canary window that opened: the
        incumbent it is judged against must not drift.
        :class:`FoldinSwapRaced` is raised and the controller requeues
        its deltas. The standby becomes the pre-fold-in base; the
        replaced unit's batcher is retired on ``loop`` when one runs."""
        if unit.batcher is None:
            self._attach_batcher(unit)
        with self._swap_lock:
            if expected_base is not None and self._unit is not expected_base:
                self._count("swaps", "foldin/raced")
                raise FoldinSwapRaced(
                    "serving unit changed during the fold-in solve (now "
                    f"instance {self._unit.instance.id})")
            if self._canary is not None:
                self._count("swaps", "foldin/raced")
                raise FoldinSwapRaced(
                    "canary window opened during the fold-in solve")
            old, self._unit = self._unit, unit
            dropped, self._standby = self._standby, unit.foldin_of
        self._count("swaps", "foldin/ok")
        self._record("swap", mode="foldin",
                     engineInstanceId=unit.instance.id,
                     releaseVersion=unit.release_version or None,
                     foldinRows=unit.foldin_rows)
        if loop is not None and loop.is_running():
            for gone in {id(u): u for u in (old, dropped)
                         if u is not None and u is not unit}.values():
                loop.call_soon_threadsafe(
                    lambda u=gone: self._spawn(self._retire(u)))

    def _set_release_status(self, release: Optional[Release], status: str,
                            reason: str) -> Optional[Future]:
        """Submit a lineage write-back to the deploy executor (one
        worker: writes land in submission order) and return its future;
        :meth:`_settle_writes` awaits it off the event loop. A failed
        write is logged and never fails the request that caused it (a
        registry outage must not wedge serving)."""
        if release is None:
            return None
        release.status = status

        def write():
            try:
                Storage.get_meta_data_releases().set_status(
                    release.id, status, reason=reason)
            except Exception:
                logger.exception("release status update failed (%s -> %s)",
                                 release.id, status)

        try:
            return self._deploy_executor.submit(write)
        except RuntimeError:              # the server is shutting down
            logger.exception("release status update not submitted "
                             "(%s -> %s)", release.id, status)
            return None

    @staticmethod
    async def _settle_writes(writes) -> None:
        """Wait for release-status writes (they never raise)."""
        for fut in writes:
            if fut is not None:
                await asyncio.wrap_future(fut)

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
        canary = self._canary
        for unit in (self._unit, self._standby,
                     canary.unit if canary is not None else None):
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
        ``/reload``'s or ``/deploy.json``'s warm-up, a shadow's scoring
        and the fold-in solves count among them), the serving unit's
        micro-batches, the fold-in status and the feedback writes."""
        with self._stats_lock:
            count, total = self._query_count, self._query_seconds
            recent = list(self._recent)
            fb = list(self._feedback_seconds)
            fb_writes, fb_failures = (self._feedback_writes,
                                      self._feedback_failures)
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
            "microBatches": self._batch_counts(unit),
            "foldin": self.foldin_status(),
            "feedback": {
                "enabled": self._feedback_target is not None,
                "writes": fb_writes, "failures": fb_failures,
                "p50WriteSec": float(np.median(fb)) if fb else None,
                "maxWriteSec": max(fb) if fb else None},
        }

    @staticmethod
    def _batch_counts(unit: ServingUnit) -> Optional[dict]:
        """The serving unit's micro-batches so far, by size (the
        reference's per-batch serving observations, plain counts until
        the port has the metrics registry); None when the unit does not
        batch."""
        batcher = unit.batcher
        if batcher is None or not unit.vectorized:
            return None
        sizes = dict(batcher.batch_sizes)
        return {"batches": sum(sizes.values()),
                "sizes": {str(k): v for k, v in sorted(sizes.items())}}

    async def handle_plugins(self, _req: Request) -> Tuple[int, Any]:
        return 200, {"plugins": self.plugins.describe()}

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
        load, warm up and verify it off the event loop, then swap. A
        canary being judged answers 409; a decided one is acted on
        first."""
        if not self._authorized(req):
            return 401, {"message": "Unauthorized"}
        loop = asyncio.get_running_loop()
        async with self._reload_lock:
            blocked = await self._settle_canary_first()
            if blocked is not None:
                return blocked
            t0 = time.perf_counter()
            latest, release = await loop.run_in_executor(
                self._deploy_executor, self._latest)
            if latest is None:
                return 404, {"message": "No COMPLETED instance found"}
            mode = "warm" if self._effective_warmup(None) else "cold"
            try:
                unit, report, _phases = await loop.run_in_executor(
                    self._deploy_executor, self._prepare_unit, latest,
                    release)
            except DeployError as e:
                self._count("swaps", f"{mode}/failed")
                return 500, {"message": str(e)}
            self.last_warmup = report
            await self._swap_to(unit, mode=mode, reason="reload")
            return 200, {
                "message": "Reloaded",
                "engineInstanceId": latest.id,
                "releaseVersion": unit.release_version or None,
                "warmup": report.to_dict(),
                "seconds": time.perf_counter() - t0}

    def _resolve_target(self, body: dict
                        ) -> Tuple[Optional[EngineInstance],
                                   Optional[Release]]:
        """The instance (and release) a deploy body names: by
        ``engineInstanceId``, else by ``releaseId`` or ``version``
        through ``resolve_release`` (neither: the newest release that
        was not rolled back)."""
        instances = Storage.get_meta_data_engine_instances()
        release = None
        if body.get("engineInstanceId"):
            instance = instances.get(str(body["engineInstanceId"]))
        else:
            selector = body.get("releaseId") or body.get("version")
            inst = self.instance
            release = resolve_release(
                Storage.get_meta_data_releases(), inst.engine_id,
                inst.engine_version, inst.engine_variant,
                str(selector) if selector is not None else None)
            instance = (instances.get(release.instance_id)
                        if release is not None else None)
        return instance, release

    async def handle_deploy(self, req: Request) -> Tuple[int, Any]:
        """Warm-deploy a release: a full cutover by default, a canary or
        shadow rollout when the body asks for one (``canaryFraction`` or
        ``shadow``; the other ``canary*`` keys override DeployConfig).
        404 when no COMPLETED instance matches; 500 (and the release
        ROLLED_BACK) when its prepare fails; 409 while a canary is
        judged."""
        if not self._authorized(req):
            return 401, {"message": "Unauthorized"}
        try:
            body = req.json() if req.body else {}
            if not isinstance(body, dict):
                raise ValueError("a deploy body must be a JSON object")
        except (json.JSONDecodeError, UnicodeDecodeError, ValueError) as e:
            return 400, {"message": str(e)}
        loop = asyncio.get_running_loop()
        async with self._reload_lock:
            blocked = await self._settle_canary_first()
            if blocked is not None:
                return blocked
            t0 = time.perf_counter()
            instance, release = await loop.run_in_executor(
                self._deploy_executor, self._resolve_target, body)
            if instance is None or instance.status != "COMPLETED":
                return 404, {"message": "No deployable release/instance "
                                        "matched."}
            mode = "warm" if self._effective_warmup(body.get("warmup")) \
                else "cold"
            try:
                unit, report, phases = await loop.run_in_executor(
                    self._deploy_executor, self._prepare_unit, instance,
                    release, body.get("warmup"), body.get("warmupQuery"))
            except DeployError as e:
                self._count("swaps", f"{mode}/failed")
                await self._settle_writes([self._set_release_status(
                    release, "ROLLED_BACK", f"prepare failed: {e}")])
                return 500, {"message": str(e)}
            self.last_warmup = report
            out = {"engineInstanceId": instance.id,
                   "releaseVersion": unit.release_version or None,
                   "warmup": report.to_dict(), "prepare": phases}
            cfg = self._canary_config(body)
            if cfg is not None:
                controller = CanaryController(cfg)
                self._canary = CanaryState(unit=unit, controller=controller,
                                           config=controller.config)
                await self._settle_writes([self._set_release_status(
                    release, "CANARY", "shadow" if cfg.shadow else
                    f"fraction={controller.config.fraction}")])
                self._record("canary_start", engineInstanceId=instance.id,
                             releaseVersion=unit.release_version or None,
                             shadow=cfg.shadow,
                             fraction=controller.config.fraction)
                return 200, {"message": "Canary started", **out,
                             "canary": controller.to_dict(),
                             "seconds": time.perf_counter() - t0}
            await self._swap_to(unit, mode=mode, reason="deploy")
            return 200, {"message": "Deployed", **out,
                         "seconds": time.perf_counter() - t0}

    async def _settle_canary_first(self) -> Optional[Tuple[int, Any]]:
        """A swap must not run over a canary: an undecided one answers
        409 (a swap would poison the judge's incumbent baseline); a
        decided one not yet acted on is acted on now."""
        canary = self._canary
        if canary is None:
            return None
        if canary.controller.decided is None:
            return 409, {"message": "A canary rollout is already in "
                                    "progress; rollback or wait for its "
                                    "verdict first."}
        await self._act_on_verdict(canary, canary.controller.decided)
        return None

    def _canary_config(self, body: dict) -> Optional[CanaryConfig]:
        """A deploy body opts into a staged rollout with canaryFraction
        or shadow; DeployConfig supplies every knob it leaves out."""
        if not (body.get("canaryFraction") or body.get("shadow")):
            return None
        dc = self.deploy_config
        return CanaryConfig(
            fraction=float(body.get("canaryFraction",
                                    dc.canary_fraction) or 0.0),
            shadow=bool(body.get("shadow", False)),
            window=int(body.get("canaryWindow", dc.canary_window)),
            min_samples=int(body.get("canaryMinSamples",
                                     dc.canary_min_samples)),
            promote_after=int(body.get("canaryPromoteAfter",
                                       dc.canary_promote_after)),
            p99_ratio=float(body.get("canaryP99Ratio", dc.canary_p99_ratio)),
            latency_slack_s=float(body.get("canaryLatencySlackS",
                                           dc.canary_latency_slack_s)),
            error_rate_slack=float(body.get("canaryErrorRateSlack",
                                            dc.canary_error_rate_slack)),
        )

    async def _act_on_verdict(self, canary: CanaryState, verdict) -> None:
        """Promote the candidate (the ``/reload`` swap) or mark it
        ROLLED_BACK and retire it. The statuses land before the canary
        clears, so once ``/deploy/status.json`` shows no canary the
        registry reads the verdict. Acted on once: a second caller waits
        for the first."""
        if canary.settling is not None:
            await asyncio.shield(canary.settling)
            return
        if self._canary is not canary:
            return
        canary.settling = asyncio.get_running_loop().create_future()
        decision, reason = verdict
        t0 = time.perf_counter()
        try:
            if decision == "promote":
                self._count("promotes", "healthy"
                            if reason.startswith("healthy") else reason)
                await self._swap_to(canary.unit, mode="canary",
                                    reason=reason)
            else:
                self._count("rollbacks", reason.split(":", 1)[0])
                await self._settle_writes([self._set_release_status(
                    canary.unit.release, "ROLLED_BACK", reason)])
                logger.warning("canary rolled back: %s", reason)
        finally:
            if self._canary is canary:
                self._canary = None
            canary.settling.set_result(None)
            # ``seconds``: the swap or the status write, until the canary
            # cleared
            self._record("canary_verdict", decision=decision, reason=reason,
                         engineInstanceId=canary.unit.instance.id,
                         releaseVersion=canary.unit.release_version or None,
                         seconds=time.perf_counter() - t0)
        if decision != "promote":
            await self._retire(canary.unit)

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
        """Operator rollback. An undecided canary is aborted (its release
        ROLLED_BACK, the incumbent keeps serving); a decided one is acted
        on first, and when that verdict was a rollback the incumbent is
        not demoted too. Otherwise restore the resident standby (the
        previous release, or a fold-in drift's pre-fold-in base), else
        load the newest older release from the registry. The release
        rolled away from is marked ROLLED_BACK, and the standby is
        cleared so a second rollback never flips back onto it."""
        if not self._authorized(req):
            return 401, {"message": "Unauthorized"}
        loop = asyncio.get_running_loop()
        async with self._reload_lock:
            t0 = time.perf_counter()
            canary = self._canary
            if canary is not None:
                decision = canary.controller.decided
                if decision is None:
                    decision = canary.controller.decided = ("rollback",
                                                             "operator")
                await self._act_on_verdict(canary, decision)
                if decision[0] == "rollback":
                    return 200, {
                        "message": "Canary aborted",
                        "engineInstanceId": canary.unit.instance.id,
                        "releaseVersion": canary.unit.release_version
                        or None,
                        "seconds": time.perf_counter() - t0}
            target = self._standby
            if target is None:
                target = await loop.run_in_executor(
                    self._deploy_executor, self._load_previous_release)
            if target is None:
                return 404, {"message": "No previous release to roll "
                                        "back to."}
            self._count("rollbacks", "operator")
            rolled_back = await self._swap_to(
                target, mode="rollback", reason="operator rollback",
                retire_old=False, keep_standby=False)
            await self._settle_writes([self._set_release_status(
                rolled_back.release, "ROLLED_BACK", "operator rollback")])
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
        """The active, standby and canary units, the deploy counters and
        recent lifecycle events, and the fold-in status."""
        unit, standby, canary = self._unit, self._standby, self._canary
        with self._stats_lock:
            counts = {k: dict(v) for k, v in self._deploy_counts.items()}
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
            "canary": ({
                "engineInstanceId": canary.unit.instance.id,
                "releaseVersion": canary.unit.release_version or None,
                **canary.controller.to_dict(),
            } if canary is not None else None),
            "lastWarmup": (self.last_warmup.to_dict()
                           if self.last_warmup is not None else None),
            "foldin": self.foldin_status(),
            "scorer": unit_scorer_status(unit.result),
            "deploy": {**counts,
                       "recentEvents": list(self._deploy_events)},
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
        # route once: everything this request touches rides the units
        # snapshotted here, so a concurrent swap never mixes halves
        role, unit, canary = ROLE_INCUMBENT, self._unit, self._canary
        if canary is not None and canary.controller.decided is None \
                and canary.controller.splitter.route():
            role, unit = ROLE_CANARY, canary.unit
        t_predict = time.perf_counter()
        try:
            query = self._extract_query(data)
            prediction = await self._predict_via(unit, query)
        except Exception as e:
            self._observe_role(canary, role, time.perf_counter() - t_predict,
                               ok=False)
            logger.exception("query failed")
            if self.log_url:
                self._remote_log(
                    f"Query:\n{json.dumps(data)}\n\nError:\n{e!r}\n\n")
            return 400, {"message": str(e)}
        self._observe_role(canary, role, time.perf_counter() - t_predict,
                           ok=True)
        if (canary is not None and canary.config.shadow
                and canary.controller.decided is None):
            # mirror the query into the candidate off the response path;
            # its answer is judged and discarded
            self._spawn(self._shadow_score(canary, query))
        pred_json = _to_jsonable(prediction)
        if self._feedback_target is not None:
            pr_id = (pred_json.get("prId") if isinstance(pred_json, dict)
                     else None) or generate_id()
            if isinstance(pred_json, dict):
                pred_json = dict(pred_json)
                pred_json["prId"] = pr_id
            asyncio.get_running_loop().run_in_executor(
                None, self._record_feedback, data, pred_json, pr_id)
        # output blockers transform; sniffers observe
        for blocker in self.plugins.output_blockers.values():
            try:
                pred_json = blocker.process(self.instance, data, pred_json)
            except Exception:
                logger.exception("output blocker failed")
        for sniffer in self.plugins.output_sniffers.values():
            try:
                sniffer.process(self.instance, data, pred_json)
            except Exception:
                logger.exception("output sniffer failed")
        dt = time.perf_counter() - t0
        with self._stats_lock:
            self._query_count += 1
            self._query_seconds += dt
            self._recent.append(dt)
        self.last_serving_sec = dt
        return 200, pred_json

    def _observe_role(self, canary: Optional[CanaryState], role: str,
                      seconds: float, ok: bool) -> None:
        """Count the query under its role and, during a rollout, feed the
        judge; a verdict is acted on off the request path."""
        self._count("requests", role)
        if canary is None or canary is not self._canary:
            return
        verdict = canary.controller.observe(role, seconds, ok)
        if verdict is not None:
            self._spawn(self._act_on_verdict(canary, verdict))

    async def _shadow_score(self, canary: CanaryState, query) -> None:
        """Score on the candidate and discard: it sees the traffic's
        shape without serving a byte."""
        t0 = time.perf_counter()
        try:
            await self._predict_via(canary.unit, query)
            ok = True
        except Exception:
            ok = False
        self._observe_role(canary, ROLE_SHADOW, time.perf_counter() - t0, ok)

    def _remote_log(self, message: str) -> None:
        """POST a serving failure to ``log_url`` on a daemon thread: the
        400 goes out at once, and delivery (5 s at most) or its failure
        never reaches the client."""
        inst = self.instance
        payload = self.log_prefix + json.dumps({
            "engineInstance": {"id": inst.id, "engineId": inst.engine_id,
                               "engineVariant": inst.engine_variant},
            "message": message})
        threading.Thread(target=_post_remote_log,
                         args=(self.log_url, payload), daemon=True,
                         name="pio-remote-log").start()

    def _record_feedback(self, query_json, pred_json, pr_id) -> None:
        """Write the ``predict`` event linking a query to its answer
        (CreateServer.scala:563-589), on the loop's default executor."""
        t0 = time.perf_counter()
        try:
            app_id, channel_id = self._feedback_target
            event = Event(event="predict", entity_type="pio_pr",
                          entity_id=pr_id,
                          properties=DataMap({"query": query_json,
                                              "prediction": pred_json}))
            Storage.get_events().insert_batch([event], app_id, channel_id)
        except Exception:
            logger.exception("feedback recording failed")
            with self._stats_lock:
                self._feedback_failures += 1
            return
        with self._stats_lock:
            self._feedback_writes += 1
            self._feedback_seconds.append(time.perf_counter() - t0)

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
