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
  GET  /slo.json       -> the SLO burn-rate evaluation (``obs/slo``)
  POST /debug/profile  -> a bounded ``torch.profiler`` capture
  GET  /capacity.json  -> the device-memory ledger (``obs/capacity``)
  GET  /metrics, /metrics.json, /debug/traces.json -> the registries
                          and the flight recorder (``obs/middleware``)
  GET  /history/series.json, /history/range.json -> the telemetry
                          store's history (``obs/telemetry``)
  POST /stop           -> graceful shutdown

``/reload``, ``/deploy.json``, ``/rollback.json``, ``/debug/profile``
and ``/stop`` take the ``accessKey`` query parameter when the server was
given one (``deploy --accesskey``).

Every request runs under the observability middleware (request id,
trace, ``pio_http_request_duration_seconds``). A batched query's
critical path is split by ``obs/anatomy`` into queue wait, linger,
assemble, device (closed once the result is on the host), serve and
serialize, which tile the handler from its start to the end of
serialize (``Trace.stage_frame``; the middleware books its own steps
around that). With an SLO spec the burn-rate engine ticks on the
server's loop; with a telemetry recorder the registries persist to its
store, the SLO rings rehydrate from it and a canary's splitter resumes
from its last persisted accumulator.

Every swap keeps the outgoing unit resident as the rollback standby
(its batcher is retired); a unit's device copies are dropped only once
it is neither active, standby nor a canary. A cutover's release-status
writes (LIVE, RETIRED, CANARY, ROLLED_BACK) land before the request
that caused it answers, so the registry never trails the server. With
``FoldinConfig.enabled`` the online fold-in controller (``deploy/foldin``)
starts with the server and swaps drifted models in through
:meth:`QueryServer.swap_foldin_unit`, whose standby is the pre-fold-in
base; it holds its deltas while a canary is judged.

Warm residency (the multi-tenant host, ``server/multitenant``):
:meth:`QueryServer.evict_to_warm` swaps in a factor-less unit (instance
and release kept) and releases the device tensors of the old unit, its
standby and their fold-in bases; the next query (or
:meth:`QueryServer.ensure_resident`) reloads it through the deploy's
load, warm-up and verify ladder, single-flight, and answers 503 with
Retry-After past its wait. A server built with
``pin_process_scorer=False`` stamps its scorer config on its own model
holders instead of pinning the process's.

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
import contextlib
import contextvars
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
    compute_vectorized, deploy_metrics, verify_unit, warmup_unit,
)
from predictionio_tpu_torch.obs import profiler
from predictionio_tpu_torch.obs.anatomy import (
    SERVING_PATH, AnatomyMetrics, BatchBreakdown, active_breakdown,
    anatomy_enabled, anatomy_metrics, note_stage, observe_serving_batch,
    observe_stage, pop_breakdown, push_breakdown,
)
from predictionio_tpu_torch.obs.capacity import (
    capacity_routes, register_capacity_metrics, unit_capacity,
)
from predictionio_tpu_torch.obs.middleware import (
    metrics_routes, observability_middleware,
)
from predictionio_tpu_torch.obs.registry import (
    MetricsRegistry, default_registry,
)
from predictionio_tpu_torch.obs.slo import SLOEngine, SLOSpec
from predictionio_tpu_torch.obs.trace_context import record_event
from predictionio_tpu_torch.obs.tracing import (
    capture_context, carried, current_trace, span, span_histogram,
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
from predictionio_tpu_torch.storage import faults
from predictionio_tpu_torch.storage.base import (
    EngineInstance, Release, generate_id,
)
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.server_config import (
    DeployConfig, FoldinConfig, ScorerConfig, ServingConfig,
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


#: when the answer a request awaited from its micro-batch was ready (set
#: by :meth:`MicroBatcher.submit` in the awaiting request's context)
_ANSWER_READY: contextvars.ContextVar[Optional[float]] = \
    contextvars.ContextVar("pio_answer_ready", default=None)


@contextlib.contextmanager
def _stage(hist, name: str):
    """Stage timing against a pre-resolved span histogram handle (no
    registry lock per stage); the stage also lands in the carried
    request trace and in the active micro-batch's anatomy breakdown."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        hist.observe(dt, span=name)
        trace = current_trace()
        if trace is not None:
            trace.add(name, dt)
        note_stage(name, dt)


class _TiledBreakdown(BatchBreakdown):
    """A micro-batch's breakdown whose stages tile the batch's wall: each
    stage runs from the previous one's end (the batch's start for the
    first) to its own end, so a wait between two stages (for the
    interpreter lock, say) is booked to the stage it delayed, and the
    last stage runs on to the time the answers are handed back."""

    __slots__ = ("ends",)

    def __init__(self):
        super().__init__()
        self.ends: Dict[str, float] = {}

    def add_stage(self, name: str, seconds: float) -> None:
        self.ends[name] = time.perf_counter()

    def tile(self, t_start: float, t_end: float) -> None:
        order = sorted(self.ends.items(), key=lambda kv: kv[1])
        prev = t_start
        for i, (name, end) in enumerate(order):
            end = t_end if i == len(order) - 1 else end
            self.stages[name] = end - prev
            prev = end


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
                 executor: Optional[ThreadPoolExecutor] = None,
                 registry: Optional[MetricsRegistry] = None):
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
        self._registry = registry
        self._size_hist = self._inflight_gauge = self._span_hist = None
        self._anatomy: Optional[AnatomyMetrics] = None
        if registry is not None:
            self._anatomy = anatomy_metrics(registry)
            self._size_hist = registry.histogram(
                "pio_batch_size",
                "Queries coalesced per micro-batch drain",
                buckets=tuple(float(1 << i) for i in range(11)))
            self._inflight_gauge = registry.gauge(
                "pio_batch_inflight",
                "Micro-batches currently running on the predict executor")
            registry.gauge_callback(
                "pio_batch_queue_depth",
                "Queries waiting in the micro-batch queue",
                lambda: float(self.queue_depth()))
            self._span_hist = span_histogram(registry)

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

    def queue_depth(self) -> int:
        return self._queue.qsize() if self._queue is not None else 0

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
    async def submit(self, query, t_start: Optional[float] = None):
        """Score ``query`` in the next micro-batch. ``t_start`` (default:
        now) is where the request's anatomy queue wait starts: the
        handler passes its own start, so the body parse and the query's
        extraction are booked to the wait too."""
        loop = asyncio.get_running_loop()
        self._note_arrival()
        fut = loop.create_future()
        # the submitting request's trace context (the executor thread's
        # batch spans stay linked to it), its start time and its Trace
        # (the per-request anatomy); the last slot gets the time the
        # batch's answers were ready
        entry = [query, fut, capture_context(),
                 time.perf_counter() if t_start is None else t_start,
                 current_trace(), None]
        while True:
            if self._task is None or self._task.done():
                self._queue = asyncio.Queue()
                self._sem = asyncio.Semaphore(self.inflight)
                self._task = loop.create_task(
                    self._worker(self._queue, self._sem))
            task, queue = self._task, self._queue
            queue.put_nowait(entry)
            if not task.done() or fut.done():
                try:
                    return await fut
                finally:
                    _ANSWER_READY.set(entry[5])
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
                    linger_dt = 0.0
                    if linger > 0.0 and len(batch) < self.max_batch:
                        t0 = time.perf_counter()
                        await asyncio.sleep(linger)
                        linger_dt = time.perf_counter() - t0
                        if self._span_hist is not None:
                            self._span_hist.observe(linger_dt,
                                                    span="batch_linger")
                        while (len(batch) < self.max_batch
                               and not queue.empty()):
                            batch.append(queue.get_nowait())
                    self.batch_sizes[len(batch)] += 1
                    if self._size_hist is not None:
                        self._size_hist.observe(float(len(batch)))
                    # the batch runs under the first traced submitter's
                    # context (coalesced siblings ride the same batch)
                    ctx = next((entry[2] for entry in batch
                                if entry[2] is not None), None)
                    meta = [(entry[3], entry[4]) for entry in batch]
                    ex_fut = loop.run_in_executor(
                        self._executor, self._run_batch,
                        [entry[0] for entry in batch], ctx, meta,
                        linger_dt)
                    self._inflight_now += 1
                    if self._inflight_gauge is not None:
                        self._inflight_gauge.set(float(self._inflight_now))
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
            for entry in batch:
                fut = entry[1]
                if not fut.done():
                    fut.set_exception(
                        RuntimeError("query micro-batch worker stopped"))

    def _run_batch(self, queries, ctx, meta, linger_s: float):
        """Executor side: re-enter the submitting request's trace when one
        was captured, so the ``serving_batch`` hop and its stage spans
        land in the flight recorder under the request's trace id.
        Returns the answers and the time they were ready.

        The anatomy's queue wait runs until this thread starts the batch
        (a wait for an executor thread is a wait in the queue), and the
        request's serialize stage from the time the answers were ready
        (the loop's resumption of the handler is part of the tail), so
        the stages tile the request's wall."""
        t_dispatch = time.perf_counter()
        if ctx is None:
            return self._run_measured(queries, meta, linger_s, t_dispatch)
        with carried(ctx, "serving_batch", registry=self._registry,
                     span_hist=self._span_hist,
                     attrs={"batch": len(queries)}):
            return self._run_measured(queries, meta, linger_s, t_dispatch)

    def _run_measured(self, queries, meta, linger_s: float,
                      t_dispatch: float):
        """Run the batch under an anatomy breakdown; each member's stages
        are observed before the futures resolve, so they are on the
        request's trace when the middleware records it."""
        if self._anatomy is None or not anatomy_enabled():
            return self._predict_batch(queries), time.perf_counter()
        bd = _TiledBreakdown()
        token = push_breakdown(bd)
        try:
            results = self._predict_batch(queries)
        finally:
            pop_breakdown(token)
        t_ready = time.perf_counter()
        try:
            bd.tile(t_dispatch, t_ready)
            observe_serving_batch(self._anatomy, bd, meta, linger_s,
                                  t_dispatch)
        except Exception:
            logger.exception("anatomy observation failed")
        return results, t_ready

    def _finish_batch(self, batch, sem: asyncio.Semaphore, ex_fut) -> None:
        """On the event loop when a dispatched batch settles: free the
        slot, then route per-query results/errors to their handlers."""
        self._inflight_now -= 1
        if self._inflight_gauge is not None:
            self._inflight_gauge.set(float(self._inflight_now))
        sem.release()
        t_ready = None
        try:
            results, t_ready = ex_fut.result()
        except BaseException as e:   # noqa: BLE001 — must never orphan futs
            err = e if isinstance(e, Exception) else \
                RuntimeError(f"micro-batch dispatch failed: {e!r}")
            results = [err] * len(batch)
        for entry, res in zip(batch, results):
            fut = entry[1]
            entry[5] = t_ready
            if fut.done():
                continue
            if isinstance(res, Exception):
                fut.set_exception(res)
            else:
                fut.set_result(res)


def _release_device(unit: ServingUnit) -> None:
    """Drop the device copies of a unit's models (the exact scorer's V,
    the quantized scorer's tiles)."""
    for model in getattr(unit.result, "models", ()) or ():
        release = getattr(model, "release_device", None)
        if release is not None:
            release()


def _drop_factors(unit: ServingUnit) -> None:
    """Release a unit, and the fold-in base it drifted from, down to
    nothing: their device copies (a drift shares its base's), then the
    references to models, batcher and base."""
    for u in (unit, unit.foldin_of):
        if u is not None:
            _release_device(u)
            u.result = u.batcher = u.foldin_of = None


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
                 serving_config: Optional[ServingConfig] = None,
                 release: Optional[Release] = None,
                 access_key: Optional[str] = None,
                 foldin_config: Optional[FoldinConfig] = None,
                 deploy_config: Optional[DeployConfig] = None,
                 feedback: bool = False,
                 feedback_app_name: Optional[str] = None,
                 log_url: Optional[str] = None,
                 log_prefix: str = "",
                 plugin_context: Optional[PluginContext] = None,
                 registry: Optional[MetricsRegistry] = None,
                 slo_spec: Optional[SLOSpec] = None,
                 telemetry=None,
                 pin_process_scorer: bool = True):
        self.engine = engine
        #: this server's metrics; ``/metrics`` renders it merged with the
        #: process-wide default registry
        self.registry = registry or MetricsRegistry()
        self.start_time = _dt.datetime.now(tz=_dt.timezone.utc)
        if serving_config is not None:
            # server.json "serving" and PIO_BATCH_* (ServingConfig)
            # outrank the three knobs
            max_batch = serving_config.batch_max
            linger_s = serving_config.batch_linger_s
            inflight = serving_config.batch_inflight
        self.max_batch = max(1, max_batch)
        #: resolved scoring-kernel knobs, pinned process-wide so every
        #: scoring surface (models, warm-up) sees ONE mode
        self.scorer_config = scorer_config or ScorerConfig.from_env()
        #: a multi-tenant host passes pin_process_scorer=False: its
        #: servers cannot all own the one process pin, so each stamps its
        #: config on its own model holders (ops/scoring.
        #: holder_scorer_config): one tenant holds int8 factors while
        #: another holds bf16 in the same process
        self._pin_process_scorer = bool(pin_process_scorer)
        if self._pin_process_scorer:
            set_process_scorer_config(self.scorer_config)
        else:
            self._stamp_scorer_override(train_result)
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
        #: batch-stage span histogram, resolved once (the executor must
        #: not take the registry lock per stage)
        self._span_hist = span_histogram(self.registry)
        #: anatomy stage histograms (serialize is observed per request)
        self._anatomy = anatomy_metrics(self.registry)
        register_capacity_metrics(self.registry, self._capacity_units)
        self._pad_waste = self.registry.counter(
            "pio_batch_pad_waste_rows_total",
            "Throwaway rows added padding batches up to their shape "
            "bucket (the price of a bounded compile-shape set)")
        self._deploy = deploy_metrics(self.registry)
        self._query_hist = self.registry.histogram(
            "pio_query_duration_seconds",
            "Query hot-path wall time by engine variant",
            labelnames=("engine_variant",))
        self._query_failures = self.registry.counter(
            "pio_query_failures_total",
            "Failed queries by engine variant and cause "
            "(bad_json = client garbage, predict_error = engine failure)",
            labelnames=("engine_variant", "reason"))
        self._feedback_hist = self.registry.histogram(
            "pio_feedback_write_duration_seconds",
            "Feedback-loop event store write wall time")
        self._reload_total = self.registry.counter(
            "pio_reload_total", "Model reload attempts by outcome",
            labelnames=("status",))
        self._evict_total = self.registry.counter(
            "pio_unit_evictions_total",
            "Serving units evicted to warm on-host state (factors "
            "dropped, params + release pointer retained)",
            labelnames=("reason",))
        #: warm residency (the multi-tenant budgeter): an evicted server
        #: serves a WARM unit (instance and release kept, factors dropped)
        #: and reloads it through the deploy ladder on the next hit;
        #: ``_reload_event`` is the single-flight latch queries wait on,
        #: ``_warm_bytes`` the last resident attribution (the budgeter's
        #: projection of a reload's cost)
        self._reload_event: Optional[asyncio.Event] = None
        self._warm_bytes = 0
        #: the last warm reload's phases (loadS, warmupS, verifyS,
        #: scorerBuildS within them, swapS)
        self.last_warm_reload: Optional[dict] = None
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
        self._deploy.active_version.set(float(self._unit.release_version))
        #: the SLO burn-rate engine (``obs/slo``) when a spec was given:
        #: ticked on the server's loop and at each ``/slo.json`` read;
        #: fold-in defers its applies while a serving objective burns
        self._slo = (SLOEngine(self.registry, slo_spec)
                     if slo_spec is not None else None)
        self._slo_task: Optional[asyncio.Task] = None
        #: the durable-telemetry recorder (``obs/telemetry``), owned by
        #: this server when given: stopped last on close, and the SLO
        #: rings rehydrate from its history
        self._telemetry = telemetry
        if self._telemetry is not None and self._slo is not None:
            try:
                self._slo.rehydrate(self._telemetry.reader())
            except Exception:
                logger.exception("SLO rehydration from history failed")
        from predictionio_tpu_torch.obs.telemetry import (
            history_reader_factory, history_routes,
        )

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
            ("GET", "/slo.json", self.handle_slo),
            ("POST", "/debug/profile", self.handle_profile),
            *capacity_routes(self._capacity_units),
            *metrics_routes(self.registry, default_registry()),
            *history_routes(history_reader_factory(self._telemetry)),
        ], middleware=observability_middleware(self.registry,
                                               "query_server"))
        #: set by POST /stop; :func:`run_query_server` then shuts down
        self.stopped = asyncio.Event()
        self._stats_lock = threading.Lock()
        self._deploy_events = collections.deque(maxlen=RECENT_DEPLOY_EVENTS)
        #: feedback writes that failed (their durations are
        #: ``pio_feedback_write_duration_seconds``), and the longest write
        self._feedback_failures = 0
        self._feedback_max_s: Optional[float] = None
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
            inflight=self._inflight, executor=self._predict_executor,
            registry=self.registry)

    def _live_units(self):
        units = [("active", self._unit)]
        if self._standby is not None:
            units.append(("standby", self._standby))
        canary = self._canary
        if canary is not None:
            units.append(("canary", canary.unit))
        return units

    def _capacity_units(self) -> List[dict]:
        """Per-unit residency for ``/capacity.json`` and the
        ``pio_capacity_unit_resident_bytes`` gauge."""
        return [unit_capacity(u, role) for role, u in self._live_units()]

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
        self._stamp_scorer_override(unit.result)
        self._attach_batcher(unit)
        predict = functools.partial(self._predict_batch_unit, unit)
        query = (self._extract_query(warmup_query_json, unit.result)
                 if warmup_query_json is not None else None)
        if self._effective_warmup(warmup):
            report = warmup_unit(unit, predict, self.max_batch, query)
        else:
            report = WarmupReport(skipped="disabled")
        t2 = time.perf_counter()
        verify_unit(unit, predict, query)
        t3 = time.perf_counter()
        for phase, seconds in (("load", t1 - t0), ("warmup", t2 - t1),
                               ("verify", t3 - t2)):
            if phase != "warmup" or not report.skipped:
                self._deploy.phase_hist.observe(seconds, phase=phase)
        self._deploy.warmup_shapes.inc(len(report.buckets))
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
        self._deploy.swap_total.inc(mode=mode, outcome="ok")
        self._deploy.active_version.set(float(unit.release_version))
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
        t0 = time.monotonic()
        deadline = t0 + self.deploy_config.drain_timeout_s
        while batcher is not None and not batcher.idle() \
                and time.monotonic() < deadline:
            if unit is self._unit:
                return
            await asyncio.sleep(0.02)
        if unit is self._unit:
            return
        if batcher is not None:
            await batcher.shutdown()
            self._deploy.phase_hist.observe(time.monotonic() - t0,
                                            phase="drain")
        canary = self._canary
        if unit is self._standby or (canary is not None
                                     and unit is canary.unit):
            return
        _release_device(unit)

    # -- warm eviction / reload (the multi-tenant budgeter) ------------------
    def _stamp_scorer_override(self, result) -> None:
        """A server that does not own the process scorer pin (one of a
        multi-tenant host's) stamps its scorer config on every model
        holder, where ``holder_scorer_config`` reads it before the pin."""
        if self._pin_process_scorer or result is None:
            return
        for model in getattr(result, "models", ()) or ():
            try:
                model._scorer_cfg_override = self.scorer_config
            except AttributeError:      # a slotted holder: the pin rules
                pass

    @property
    def resident(self) -> bool:
        """Whether the active unit holds its factors."""
        return self._unit.result is not None

    @property
    def warm_bytes(self) -> int:
        """The last known device attribution: the live bytes while
        resident, the pre-eviction footprint while warm (what a reload
        will cost)."""
        if self.resident:
            return int(sum(u.get("residentBytes", 0)
                           for u in self._capacity_units()))
        return self._warm_bytes

    async def evict_to_warm(self, reason: str = "budget") -> bool:
        """Drop the active unit to warm on-host state: the instance and
        the release pointer stay, the factors go (the unit's and the
        standby's models, their device copies and scorers, the fold-in
        controller's solver). The cutover installs a new factor-less
        unit under ``_swap_lock``, so a fold-in swap racing the eviction
        loses (FoldinSwapRaced). Queued and in-flight batches finish on
        the old unit's batcher first. Refused (False) while a canary is
        judged (the judge needs its incumbent), while a reload is in
        flight, and on a unit that is already warm.

        Nothing that serves keeps a reference to the dropped tensors, so
        the caching allocator takes their blocks back for the next
        tenant's reload; its cache is not emptied here."""
        if self._canary is not None or self._reload_event is not None:
            return False
        with self._swap_lock:
            old = self._unit
            if old.result is None:
                return False
            warm = ServingUnit(instance=old.instance, result=None,
                               vectorized=False, release=old.release)
            self._unit = warm
            standby, self._standby = self._standby, None
        # the attribution BEFORE the factors drop: the budgeter projects
        # the reload's cost from it
        self._warm_bytes = int(unit_capacity(old, "active")["residentBytes"])
        await self._drain(old.batcher)
        faults.maybe_kill("mt:evict:drained")
        for unit in (old, standby):
            if unit is not None:
                _drop_factors(unit)
        if self._foldin is not None:
            # after any apply in flight on the deploy executor: its
            # solver holds a device copy of the evicted factors
            await asyncio.get_running_loop().run_in_executor(
                self._deploy_executor, self._foldin.release_device)
        self._evict_total.inc(reason=reason)
        self._deploy.swap_total.inc(mode="evict", outcome="ok")
        self._record("evict", reason=reason,
                     engineInstanceId=warm.instance.id,
                     releaseVersion=warm.release_version or None,
                     residentBytes=self._warm_bytes)
        logger.info("evicted instance %s to warm state (%s, %d bytes)",
                    warm.instance.id, reason, self._warm_bytes)
        faults.maybe_kill("mt:evict:committed")
        return True

    async def _drain(self, batcher: Optional[MicroBatcher]) -> None:
        """Let a batcher's queued and in-flight batches finish (at most
        the drain timeout), then stop it."""
        if batcher is None:
            return
        deadline = time.monotonic() + self.deploy_config.drain_timeout_s
        while not batcher.idle() and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        await batcher.shutdown()

    async def ensure_resident(self, wait_s: Optional[float] = None) -> bool:
        """Start (or join) the single-flight warm reload and wait for it,
        at most ``wait_s`` (default: the deploy drain timeout). True when
        the active unit is resident on return."""
        if self._unit.result is not None:
            return True
        ev = self._reload_event
        if ev is None:
            self._reload_event = ev = asyncio.Event()
            self._spawn(self._reload_from_warm(ev))
        timeout = (wait_s if wait_s is not None
                   else self.deploy_config.drain_timeout_s)
        try:
            await asyncio.wait_for(asyncio.shield(ev.wait()), timeout)
        except asyncio.TimeoutError:
            return False
        return self._unit.result is not None

    async def _reload_from_warm(self, ev: asyncio.Event) -> None:
        """The reload half of the cycle: the deploy's own load -> warm-up
        -> verify ladder (the unit that swaps in is never half-resident),
        then a compare-and-swap over the warm placeholder. A deploy or
        rollback that landed meanwhile wins: the reloaded unit is
        dropped, never installed over it."""
        warm = self._unit
        loop = asyncio.get_running_loop()
        try:
            unit, _report, phases = await loop.run_in_executor(
                self._deploy_executor, self._prepare_unit, warm.instance,
                warm.release)
            faults.maybe_kill("mt:reload:loaded")
            t0 = time.perf_counter()
            with self._swap_lock:
                raced = self._unit is not warm
                if not raced:
                    self._unit = unit
            if raced:
                await self._drain(unit.batcher)
                _drop_factors(unit)
                self._reload_total.inc(status="warm_reload_raced")
                return
            self.last_warm_reload = {
                **{k: phases[k] for k in ("loadS", "warmupS", "verifyS")},
                # the scorer build (in the first scoring: warm-up, else
                # verify) and its parity gate
                "scorerBuildS": sum(st.get("buildSeconds", 0.0)
                                    for st in phases["scorer"]),
                "swapS": time.perf_counter() - t0}
            self._deploy.swap_total.inc(mode="warm_reload", outcome="ok")
            self._deploy.active_version.set(float(unit.release_version))
            self._reload_total.inc(status="warm_reload")
            self._record("swap", mode="warm_reload",
                         engineInstanceId=unit.instance.id,
                         releaseVersion=unit.release_version or None,
                         **self.last_warm_reload)
            faults.maybe_kill("mt:reload:committed")
        except DeployError:
            self._reload_total.inc(status="warm_reload_failed")
            self._deploy.swap_total.inc(mode="warm_reload",
                                        outcome="failed")
            logger.exception("warm reload failed; the unit stays warm")
        finally:
            # waiters wake either way: resident -> serve, still warm -> a
            # clean 503, and the next hit retries the reload
            self._reload_event = None
            ev.set()

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
        self._stamp_scorer_override(result)
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
                self._deploy.swap_total.inc(mode="foldin", outcome="raced")
                raise FoldinSwapRaced(
                    "serving unit changed during the fold-in solve (now "
                    f"instance {self._unit.instance.id})")
            if self._canary is not None:
                self._deploy.swap_total.inc(mode="foldin", outcome="raced")
                raise FoldinSwapRaced(
                    "canary window opened during the fold-in solve")
            old, self._unit = self._unit, unit
            dropped, self._standby = self._standby, unit.foldin_of
        self._deploy.swap_total.inc(mode="foldin", outcome="ok")
        self._deploy.active_version.set(float(unit.release_version))
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
    async def start(self, host: str = "localhost", port: int = DEFAULT_PORT,
                    ssl_context=None) -> int:
        """Bind and start accepting (over TLS with ``ssl_context``);
        returns the bound port (``port=0`` picks a free one). Starts the
        fold-in controller when enabled."""
        bound = await self._http.start(host, port, ssl_context=ssl_context)
        self.start_background()
        return bound

    def start_background(self) -> None:
        """Start the fold-in controller and the SLO loop on the running
        loop, without a socket (a multi-tenant host serves this server's
        routes itself)."""
        self._start_foldin()
        self._start_slo()

    def _start_slo(self) -> None:
        """Periodic SLO evaluation on the server's loop: the burn-rate
        gauges and breach events update every evaluation interval even
        when nothing reads ``/slo.json``. The tick reads the registry
        only (no tensor, no device sync)."""
        if self._slo is None or self._slo_task is not None:
            return

        async def _loop():
            interval = self._slo.spec.eval_interval_s
            while True:
                await asyncio.sleep(interval)
                try:
                    self._slo.tick()
                except Exception:
                    logger.exception("SLO evaluation failed")

        self._slo_task = asyncio.get_running_loop().create_task(_loop())
        logger.info("SLO engine armed: %d objective(s), eval every %.2fs",
                    len(self._slo.spec.objectives),
                    self._slo.spec.eval_interval_s)

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
        if self._slo_task is not None:
            self._slo_task.cancel()
            try:
                await self._slo_task
            except (asyncio.CancelledError, Exception):
                pass
            self._slo_task = None
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
        if self._telemetry is not None:
            # last: the final drain includes the records the steps above
            # emitted; the store's single-writer claim is released here
            await asyncio.get_running_loop().run_in_executor(
                None, self._telemetry.stop)
            self._telemetry = None

    def _authorized(self, req: Request) -> bool:
        return not self.access_key or \
            req.query.get("accessKey") == self.access_key

    # -- info ---------------------------------------------------------------
    async def handle_root(self, _req: Request) -> Tuple[int, Any]:
        """Engine/instance info + serving stats; also the scorer status,
        the kernel launch counts of this process since it was warm (a
        ``/reload``'s or ``/deploy.json``'s warm-up, a shadow's scoring
        and the fold-in solves count among them), the attributed kernel
        dispatches per family since the process started
        (``obs/profiler``), the serving unit's micro-batches, the fold-in
        status and the feedback writes."""
        count = int(self._query_hist.total_count())
        total = self._query_hist.total_sum()
        fb_writes = int(self._feedback_hist.total_count())
        with self._stats_lock:
            fb_failures, fb_max = (self._feedback_failures,
                                   self._feedback_max_s)
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
            "resident": unit.result is not None,
            "algorithms": [type(a).__name__ for a in
                           (unit.result.algorithms
                            if unit.result is not None else ())],
            "startTime": self.start_time.isoformat(),
            "uptimeSeconds": uptime,
            "requestCount": count,
            "queryCount": count,
            "avgServingSec": (total / count) if count else 0.0,
            "p95ServingSec": self._query_hist.quantile(0.95),
            "lastServingSec": self.last_serving_sec,
            "scorer": unit_scorer_status(unit.result),
            "warmup": (self.last_warmup.to_dict()
                       if self.last_warmup is not None else None),
            "kernelLaunches": kernels.counts(),
            "dispatchCalls": profiler.dispatch_calls(),
            "warmupKernelLaunches": self.warmup_launches,
            "microBatches": self._batch_counts(unit),
            "foldin": self.foldin_status(),
            "feedback": {
                "enabled": self._feedback_target is not None,
                "writes": fb_writes, "failures": fb_failures,
                "p50WriteSec": (self._feedback_hist.quantile(0.5)
                                if fb_writes else None),
                "maxWriteSec": fb_max},
        }

    @staticmethod
    def _batch_counts(unit: ServingUnit) -> Optional[dict]:
        """The serving unit's micro-batches so far, by size (across
        units, ``pio_batch_size``); None when the unit does not batch."""
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
                self._deploy.swap_total.inc(mode=mode, outcome="failed")
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
                self._deploy.swap_total.inc(mode=mode, outcome="failed")
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
                self._restore_canary_splitter(controller)
                self._canary = CanaryState(unit=unit, controller=controller,
                                           config=controller.config)
                self._deploy.canary_fraction.set(
                    0.0 if cfg.shadow else controller.config.fraction)
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
            self._deploy.canary_fraction.set(0.0)
            if decision == "promote":
                self._deploy.promote_total.inc(
                    reason="healthy" if reason.startswith("healthy")
                    else reason)
                await self._swap_to(canary.unit, mode="canary",
                                    reason=reason)
            else:
                self._deploy.rollback_total.inc(
                    reason=reason.split(":", 1)[0])
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
            self._deploy.rollback_total.inc(reason="operator")
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
            "resident": unit.result is not None,
            "deploy": {**self._deploy_counts(),
                       "recentEvents": list(self._deploy_events)},
        }

    def _deploy_counts(self) -> Dict[str, Dict[str, int]]:
        """The deploy counters as ``/deploy/status.json`` answers them:
        queries by role, promotes by reason, rollbacks by reason slug,
        swaps by "mode/outcome"."""
        def by(counter, key):
            return {key(labels): int(v) for labels, v in counter.samples()}

        d = self._deploy
        return {
            "requests": by(d.requests_total, lambda lb: lb["role"]),
            "promotes": by(d.promote_total, lambda lb: lb["reason"]),
            "rollbacks": by(d.rollback_total, lambda lb: lb["reason"]),
            "swaps": by(d.swap_total,
                        lambda lb: f"{lb['mode']}/{lb['outcome']}")}

    async def handle_slo(self, _req: Request) -> Tuple[int, Any]:
        """The burn-rate engine's evaluation; a read also ticks the engine
        so a breach is visible within one evaluation window."""
        if self._slo is None:
            return 200, {
                "enabled": False,
                "message": 'no SLO spec configured (server.json "slo")'}
        try:
            status = self._slo.tick()
        except Exception as e:
            logger.exception("SLO evaluation failed")
            return 500, {"enabled": True, "error": str(e)}
        return 200, {
            "enabled": True,
            "release": {
                "engineInstanceId": self.instance.id,
                "releaseVersion": self._unit.release_version or None,
            },
            **status}

    async def handle_profile(self, req: Request) -> Tuple[int, Any]:
        """A bounded ``torch.profiler`` capture (``obs/profiler``) plus the
        per-family dispatch table; runs on the deploy executor, so
        serving keeps answering. 409 while another capture runs, 501
        when the profiler is unavailable."""
        if not self._authorized(req):
            return 401, {"message": "Unauthorized"}
        try:
            body = req.json() if req.body else {}
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            seconds = float(body.get("seconds", 1.0) or 1.0)
            outdir = body.get("dir")
        except (json.JSONDecodeError, UnicodeDecodeError, TypeError,
                ValueError) as e:
            return 400, {"message": str(e)}
        # the capture is reserved here, on the loop: a second request
        # answers 409 at once instead of queueing behind the first on
        # the one-thread deploy executor
        if not profiler.reserve():
            return 409, {"message": "a profile capture is already running"}
        loop = asyncio.get_running_loop()
        try:
            out = await loop.run_in_executor(
                self._deploy_executor, functools.partial(
                    profiler.capture, seconds, outdir, reserved=True))
        except RuntimeError as e:
            return 501, {"message": str(e)}
        record_event("profile_capture", {"seconds": out["seconds"],
                                         "traceDir": out["traceDir"]})
        return 200, out

    def _restore_canary_splitter(self, controller) -> None:
        """Re-seed the canary splitter's diffusion accumulator from the
        telemetry store: a restart mid-canary resumes the split from the
        last persisted ``pio_deploy_canary_splitter_acc`` point instead
        of zero."""
        if self._telemetry is None:
            return
        try:
            points = [p for info in self._telemetry.reader().series(
                "pio_deploy_canary_splitter_acc") for p in info.points]
            if points:
                controller.splitter.restore(max(points)[1])
                self._deploy.canary_splitter_acc.set(
                    controller.splitter.state())
        except Exception:
            logger.exception("canary splitter restore failed; starting "
                             "from a zero accumulator")

    async def handle_stop(self, req: Request) -> Tuple[int, Any]:
        if not self._authorized(req):
            return 401, {"message": "Unauthorized"}
        # after the answer has gone out
        asyncio.get_running_loop().call_later(0.2, self.stopped.set)
        return 200, {"message": "Shutting down"}

    # -- hot path ------------------------------------------------------------
    async def handle_query(self, req: Request) -> Tuple[int, Any]:
        t0 = time.perf_counter()
        variant = self.instance.engine_variant
        try:
            data = req.json()
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            self._query_failures.inc(engine_variant=variant,
                                     reason="bad_json")
            return 400, {"message": str(e)}
        # route once: everything this request touches rides the units
        # snapshotted here, so a concurrent swap never mixes halves
        role, unit, canary = ROLE_INCUMBENT, self._unit, self._canary
        if unit.result is None:
            # warm-evicted under the device-memory budget: start (or
            # join) the single-flight reload and wait, bounded; past the
            # bound a clean 503 with Retry-After, not an unbounded queue
            if not await self.ensure_resident():
                self._query_failures.inc(engine_variant=variant,
                                         reason="not_resident")
                return 503, {"message": "serving unit is reloading; "
                                        "retry"}, {"Retry-After": "1"}
            role, unit, canary = ROLE_INCUMBENT, self._unit, self._canary
        if canary is not None and canary.controller.decided is None:
            if canary.controller.splitter.route():
                role, unit = ROLE_CANARY, canary.unit
            # published so the telemetry scrape persists it: a restarted
            # server resumes the split from here
            self._deploy.canary_splitter_acc.set(
                canary.controller.splitter.state())
        t_predict = time.perf_counter()
        _ANSWER_READY.set(None)
        try:
            with span("extract_query"):
                query = self._extract_query(data)
            with span("predict"):
                prediction = await self._predict_via(unit, query, t0)
        except Exception as e:
            self._observe_role(canary, role, time.perf_counter() - t_predict,
                               ok=False)
            self._query_failures.inc(engine_variant=variant,
                                     reason="predict_error")
            logger.exception("query failed")
            if self.log_url:
                self._remote_log(
                    f"Query:\n{json.dumps(data)}\n\nError:\n{e!r}\n\n")
            return 400, {"message": str(e)}
        self._observe_role(canary, role, time.perf_counter() - t_predict,
                           ok=True)
        # the tail starts when the answer was ready (a batched answer's
        # wait for the loop to resume this handler belongs to it)
        t_serialize = _ANSWER_READY.get() or time.perf_counter()
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
        if anatomy_enabled():
            # the post-predict tail: feedback scheduling, blockers,
            # sniffers, JSON conversion
            t_done = time.perf_counter()
            trace = current_trace()
            observe_stage(self._anatomy, SERVING_PATH, "serialize",
                          t_done - t_serialize, trace)
            if trace is not None:
                trace.stage_frame = (t0, t_done)
        dt = time.perf_counter() - t0
        self.last_serving_sec = dt
        self._query_hist.observe(dt, engine_variant=variant)
        return 200, pred_json

    def _observe_role(self, canary: Optional[CanaryState], role: str,
                      seconds: float, ok: bool) -> None:
        """Count the query under its role and, during a rollout, feed the
        judge; a verdict is acted on off the request path."""
        self._deploy.requests_total.inc(role=role)
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
        never reaches the client. The delivery runs in the failed
        request's trace."""
        inst = self.instance
        payload = self.log_prefix + json.dumps({
            "engineInstance": {"id": inst.id, "engineId": inst.engine_id,
                               "engineVariant": inst.engine_variant},
            "message": message})
        ctx, url = capture_context(), self.log_url

        def deliver() -> None:
            with carried(ctx, "remote_log", registry=self.registry):
                _post_remote_log(url, payload)

        threading.Thread(target=deliver, daemon=True,
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
        dt = time.perf_counter() - t0
        self._feedback_hist.observe(dt)
        with self._stats_lock:
            self._feedback_max_s = max(self._feedback_max_s or 0.0, dt)

    def _extract_query(self, body, result: Optional[TrainResult] = None):
        qc = _query_class(result if result is not None else self.result)
        if qc is None:
            return body
        if not isinstance(body, dict):
            raise ValueError("a query must be a JSON object")
        return params_from_json(body, qc)

    async def _predict_via(self, unit: ServingUnit, query,
                           t_start: Optional[float] = None):
        """Through the unit's batcher when vectorized, else per-request
        on the predict pool."""
        if unit.vectorized:
            return await unit.batcher.submit(query, t_start)
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
        with _stage(self._span_hist, "batch_assemble"):
            for i, q in enumerate(queries):
                try:
                    ok.append((i, result.serving.supplement(q)))
                except Exception as e:
                    out[i] = e
            if not ok:
                return out
            bucket = bucket_size(len(ok), self.max_batch)
            waste = padding_waste(len(ok), bucket)
            bd = active_breakdown()
            if bd is not None:
                bd.note_padding(len(ok), waste, bucket)
            if waste:
                pad_q = ok[-1][1]
                batch = ok + [(n + j, pad_q) for j in range(waste)]
                self._pad_waste.inc(waste)
            else:
                batch = ok
        try:
            per_query = {i: [] for i, _ in ok}
            # the device stage closes once the answers are on the host
            # (the model layer's download waits for the kernel), so the
            # kernel's time is never booked to serve or serialize
            with _stage(self._span_hist, "batch_device"):
                for algo, model in zip(result.algorithms, result.models):
                    for i, p in algo.batch_predict(model, batch):
                        if i in per_query:      # pad rows sliced off
                            per_query[i].append(p)
            with _stage(self._span_hist, "batch_serve"):
                for i, _ in ok:
                    try:
                        out[i] = result.serving.serve(queries[i],
                                                      per_query[i])
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
                     port: int = DEFAULT_PORT, on_ready=None,
                     ssl_context=None) -> None:
    """Serve until ``POST /stop``, SIGINT or SIGTERM, over TLS with
    ``ssl_context``. ``on_ready(port)`` runs once the socket is bound."""
    serve_until_stopped(server, host, port, on_ready,
                        ssl_context=ssl_context)
