"""Group-commit write buffer between the event server and the event
store (port of the reference's ``data/write_buffer.py``).

* **group commit** — one writer thread drains the queue and folds
  concurrent submits into one ``insert_batch`` per (app, channel): a
  flush holds up to ``flush_max`` events and waits at most ``linger_s``
  after its first event for more.
* **backpressure** — the queue is bounded in events (``queue_max``).
  ``submit`` never blocks: past the bound it raises :class:`BufferFull`
  with a ``retry_after`` estimate, which the event server answers as
  429 with ``Retry-After``.
* **retries** — every event gets its id at submit, so a flush can be
  replayed: attempts after the first go through
  ``insert_batch_idempotent``, which skips ids already stored, with
  exponential backoff and full jitter. Attempts run on a thread of
  the lane's own that outlives them (it keeps its sqlite connection; the
  reference starts a thread an attempt), bounded by
  ``flush_timeout_s``; an attempt still running after a second timeout
  fails the batch without a retry (a concurrent retry could write
  twice), and the lane's next attempt gets a fresh thread. A caller's
  future fails only when every attempt has.

* **flush taps** — ``add_flush_tap(tap)`` subscribes
  ``tap(events, app_id, channel_id)`` to every successful group commit
  of every buffer in the process (the push path of online fold-in,
  ``deploy/foldin``). A tap runs on the writer thread only after the
  commit landed, never for a failed flush; a tap that raises is logged
  and the flush goes on. A group commit runs under the trace context
  of its first submitter that had one (an ``ingest_flush`` hop of the
  submitting request's trace), and so do its taps: fold-in captures the
  context there and its apply re-enters it. (The reference runs its
  taps after the carried flush has ended, where no trace is active.)

* **commit lanes** — with ``partitions > 1`` the buffer runs one
  group-commit lane per partition, each with its own bounded queue
  (``queue_max // partitions`` events), writer thread, retries and flush
  clock, routed by the partitioned store's hash
  (``storage/partitioned.partition_of``): a lane's flush lands in one
  partition's commit stream, and the P partitions commit at once. A full
  lane sheds its own submits, with a ``retry_after`` from its own flush
  time. A submit whose events span lanes is split (capacity reserved on
  every lane it touches, or none) and its ids come back in input order
  once every part committed.

``stop(drain=True)`` flushes everything queued before it returns; the
lanes drain at once.

With a ``registry``, the buffer keeps the reference's series:
``pio_ingest_queue_depth``, ``pio_ingest_shed_total``,
``pio_ingest_retry_total``, ``pio_ingest_flush_size``,
``pio_ingest_flush_duration_seconds`` and, by lane (label
``partition``), ``pio_ingest_partition_queue_depth``,
``pio_ingest_partition_flush_size`` and
``pio_ingest_partition_commit_seconds``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import logging
import queue
import random
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.obs.anatomy import (
    anatomy_enabled, anatomy_metrics, observe_ingest_batch,
)
from predictionio_tpu_torch.obs.tracing import (
    capture_context, carried, current_trace, span,
)
from predictionio_tpu_torch.storage.base import StorageError, generate_id
from predictionio_tpu_torch.storage.partitioned import partition_of

logger = logging.getLogger("pio.torch.writebuffer")

#: flush taps of this process, called after each successful group commit
_FLUSH_TAPS: List[Callable] = []
_TAPS_LOCK = threading.Lock()


def add_flush_tap(tap: Callable) -> None:
    """Subscribe ``tap(events, app_id, channel_id)`` to the successful
    group commits of every WriteBuffer in this process."""
    with _TAPS_LOCK:
        if tap not in _FLUSH_TAPS:
            _FLUSH_TAPS.append(tap)


def remove_flush_tap(tap: Callable) -> None:
    with _TAPS_LOCK:
        if tap in _FLUSH_TAPS:
            _FLUSH_TAPS.remove(tap)


def _notify_taps(events, app_id, channel_id) -> None:
    with _TAPS_LOCK:
        taps = list(_FLUSH_TAPS)
    for tap in taps:
        try:
            tap(events, app_id, channel_id)
        except Exception:
            logger.exception("flush tap failed (events stay committed)")


class BufferFull(Exception):
    """A lane's bounded queue cannot take these events now.
    ``retry_after`` estimates, in whole seconds, when it can: that lane's
    depth over its observed flush rate."""

    def __init__(self, depth: int, retry_after: int):
        super().__init__(
            f"ingest queue full ({depth} events buffered); "
            f"retry in ~{retry_after}s")
        self.depth = depth
        self.retry_after = retry_after


def _as_storage_error(e: BaseException) -> StorageError:
    return e if isinstance(e, StorageError) else StorageError(repr(e))


def _with_id(e: Event) -> Event:
    """Copy of ``e`` with a fresh event_id, without re-running the
    dataclass validation the event already passed."""
    clone = object.__new__(Event)
    clone.__dict__.update(e.__dict__)
    clone.__dict__["event_id"] = generate_id()
    return clone


class _AttemptThread:
    """Runs a lane's flush attempts, one at a time, on one daemon thread
    that lives as long as its attempts return: the thread keeps its
    sqlite connection (``SqliteClient`` connects per thread), where a
    thread per attempt would open one a flush. A hung attempt keeps this
    thread; the lane then starts a fresh one for the next attempt
    (``abandon``), so a hung storage call never holds the slot the next
    attempt needs."""

    def __init__(self, name: str):
        self._jobs: "queue.SimpleQueue" = queue.SimpleQueue()
        threading.Thread(target=self._run, daemon=True, name=name).start()

    def _run(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            fn, args, f = job
            try:
                f.set_result(fn(*args))
            except BaseException as e:  # noqa: BLE001 — relayed to the waiter
                f.set_exception(e)

    def submit(self, fn: Callable, args) -> "concurrent.futures.Future":
        f: concurrent.futures.Future = concurrent.futures.Future()
        self._jobs.put((fn, args, f))
        return f

    def close(self) -> None:
        """Let the thread exit after the attempt it is running."""
        self._jobs.put(None)


class _Pending:
    """One submit. ``t_submit`` and ``req_trace`` (the submitting
    request's Trace) feed the ingest anatomy; ``trace`` is its carryable
    context (None outside a trace)."""

    __slots__ = ("events", "app_id", "channel_id", "future", "t_submit",
                 "req_trace", "trace")

    def __init__(self, events, app_id, channel_id, future):
        self.events = events
        self.app_id = app_id
        self.channel_id = channel_id
        self.future = future
        self.t_submit = time.perf_counter()
        self.req_trace = current_trace()
        self.trace = capture_context()


class _Lane:
    """One commit lane: bounded queue, writer thread and flush clock,
    all guarded by the lane's own condition variable."""

    __slots__ = ("index", "cond", "queue", "depth", "thread",
                 "last_flush_s", "attempts")

    def __init__(self, index: int):
        self.index = index
        self.cond = threading.Condition()
        self.queue: deque = deque()
        self.depth = 0              # queued + in-flush events
        self.thread: Optional[threading.Thread] = None
        self.last_flush_s = 0.05    # seeds the retry-after estimate
        #: where the lane's flush attempts run (started with the writer)
        self.attempts: Optional[_AttemptThread] = None


def _join_parts(parent: "concurrent.futures.Future", n_events: int,
                parts) -> None:
    """Resolve a split submit's future from its per-lane parts: the ids
    at their input positions, or the first part's failure."""
    ids: List[Optional[str]] = [None] * n_events
    state = {"remaining": len(parts), "failed": False}
    lock = threading.Lock()

    def one_done(idxs, child):
        # read before the lock: no future is waited on under it
        exc = child.exception()
        res = child.result() if exc is None else None
        finish = None
        with lock:
            if state["failed"]:
                return
            if exc is not None:
                state["failed"] = True
                finish = exc
            else:
                for i, eid in zip(idxs, res):
                    ids[i] = eid
                state["remaining"] -= 1
                if state["remaining"] == 0:
                    finish = ids
        if finish is None or not parent.set_running_or_notify_cancel():
            return
        if finish is ids:
            parent.set_result(ids)
        else:
            parent.set_exception(finish)

    for idxs, child in parts:
        child.add_done_callback(functools.partial(one_done, idxs))


_SIZE_BUCKETS = (1., 2., 4., 8., 16., 32., 64., 128., 256., 512., 1024.)


class WriteBuffer:
    """Bounded group-commit buffer in front of an EventStore
    (``store_fn()`` returns the store at each flush), one commit lane per
    partition."""

    def __init__(self, store_fn: Callable, *, queue_max: int = 8192,
                 flush_max: int = 256, linger_s: float = 0.002,
                 retries: int = 4, backoff_s: float = 0.05,
                 backoff_cap_s: float = 1.0, flush_timeout_s: float = 30.0,
                 partitions: int = 1, registry=None):
        self._store_fn = store_fn
        #: the ingest anatomy (``flush_wait``, ``commit``) on this
        #: registry, when one is given
        self._anatomy = (anatomy_metrics(registry)
                         if registry is not None else None)
        self._registry = registry
        self.queue_max = max(1, queue_max)
        self.flush_max = max(1, flush_max)
        self.linger_s = max(0.0, linger_s)
        self.retries = max(0, retries)
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self.flush_timeout_s = flush_timeout_s
        self.partitions = max(1, partitions)
        #: each lane's event bound: the lanes together hold queue_max
        self.lane_queue_max = max(1, self.queue_max // self.partitions)
        self._lanes = [_Lane(i) for i in range(self.partitions)]
        self._stopping = False
        self._rng = random.Random()
        #: group commits run so far, over every lane (fewer than submits
        #: when they coalesce)
        self.flushes = 0
        self._shed_total = self._retry_total = None
        self._flush_size = self._flush_duration = None
        self._p_flush_size = self._p_commit = None
        if registry is not None:
            registry.gauge_callback(
                "pio_ingest_queue_depth",
                "Events buffered for group commit (queued + in flush)",
                lambda: float(self.queue_depth()))
            registry.gauge_callback(
                "pio_ingest_partition_queue_depth",
                "Events buffered per commit lane (queued + in flush)",
                lambda: [({"partition": str(lane.index)}, float(lane.depth))
                         for lane in self._lanes],
                labelnames=("partition",))
            self._shed_total = registry.counter(
                "pio_ingest_shed_total",
                "Events rejected with 429 because the ingest queue was full")
            self._retry_total = registry.counter(
                "pio_ingest_retry_total",
                "Flush attempts retried after a storage fault or timeout")
            self._flush_size = registry.histogram(
                "pio_ingest_flush_size", "Events per group-commit flush",
                buckets=_SIZE_BUCKETS)
            self._p_flush_size = registry.histogram(
                "pio_ingest_partition_flush_size",
                "Events per group-commit flush, by commit lane",
                labelnames=("partition",), buckets=_SIZE_BUCKETS)
            self._flush_duration = registry.histogram(
                "pio_ingest_flush_duration_seconds",
                "Wall time of one group-commit flush (including retries)")
            self._p_commit = registry.histogram(
                "pio_ingest_partition_commit_seconds",
                "Durable commit wall time of one lane flush, by commit "
                "lane (the anatomy `commit` stage, partition-resolved)",
                labelnames=("partition",))

    # -- caller side ---------------------------------------------------------
    def queue_depth(self) -> int:
        return sum(lane.depth for lane in self._lanes)

    def _retry_after(self, lane: _Lane) -> int:
        est = (lane.depth / self.flush_max) * lane.last_flush_s
        return int(min(60, max(1, est + 0.999)))

    def _shed(self, lane: _Lane, n: int) -> BufferFull:
        if self._shed_total is not None:
            self._shed_total.inc(n)
        return BufferFull(lane.depth, self._retry_after(lane))

    def submit(self, events: Sequence[Event], app_id: int,
               channel_id: Optional[int] = None
               ) -> "concurrent.futures.Future[List[str]]":
        """Queue events for group commit; returns a future of their ids
        (assigned here). Raises :class:`BufferFull` past a target lane's
        bound and ``StorageError`` once stopped."""
        events = [e if e.event_id else _with_id(e) for e in events]
        if self.partitions == 1 or not events:
            return self._submit_lane(self._lanes[0], events, app_id,
                                     channel_id)
        groups: dict = {}
        for i, e in enumerate(events):
            p = partition_of(app_id, channel_id, e.entity_id,
                             self.partitions)
            idxs, evs = groups.setdefault(p, ([], []))
            idxs.append(i)
            evs.append(e)
        if len(groups) == 1:
            ((p, (_, evs)),) = groups.items()
            return self._submit_lane(self._lanes[p], evs, app_id,
                                     channel_id)
        parent: concurrent.futures.Future = concurrent.futures.Future()
        parts = []
        lane_ids = sorted(groups)
        # lanes locked in index order: no deadlock against another
        # spanning submit
        with contextlib.ExitStack() as stack:
            for p in lane_ids:
                stack.enter_context(self._lanes[p].cond)
            if self._stopping:
                raise StorageError("write buffer is shut down")
            for p in lane_ids:
                lane = self._lanes[p]
                if lane.depth + len(groups[p][1]) > self.lane_queue_max:
                    raise self._shed(lane, len(events))
            for p in lane_ids:
                idxs, evs = groups[p]
                child: concurrent.futures.Future = \
                    concurrent.futures.Future()
                self._enqueue_locked(self._lanes[p], evs, app_id,
                                     channel_id, child)
                parts.append((idxs, child))
        _join_parts(parent, len(events), parts)
        return parent

    def _submit_lane(self, lane: _Lane, events, app_id, channel_id
                     ) -> "concurrent.futures.Future[List[str]]":
        future: concurrent.futures.Future = concurrent.futures.Future()
        with lane.cond:
            if self._stopping:
                raise StorageError("write buffer is shut down")
            if lane.depth + len(events) > self.lane_queue_max:
                raise self._shed(lane, len(events))
            self._enqueue_locked(lane, events, app_id, channel_id, future)
        return future

    def _enqueue_locked(self, lane: _Lane, events, app_id, channel_id,
                        future) -> None:
        """Append one submit to a lane; the caller holds ``lane.cond``."""
        lane.queue.append(_Pending(events, app_id, channel_id, future))
        lane.depth += len(events)
        if lane.thread is None:
            lane.thread = threading.Thread(
                target=self._worker, args=(lane,), daemon=True,
                name=f"pio-ingest-writer-{lane.index}")
            lane.thread.start()
        lane.cond.notify()

    # -- writer side ---------------------------------------------------------
    def _worker(self, lane: _Lane) -> None:
        while True:
            with lane.cond:
                while not lane.queue and not self._stopping:
                    lane.cond.wait()
                if not lane.queue:
                    return
                batch = [lane.queue.popleft()]
                total = len(batch[0].events)
                # linger for concurrent submits, never past a full
                # flush; while draining, take what is queued but do not
                # wait for more
                deadline = time.monotonic() + self.linger_s
                while total < self.flush_max:
                    if lane.queue:
                        batch.append(lane.queue.popleft())
                        total += len(batch[-1].events)
                        continue
                    if self._stopping:
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not lane.cond.wait(remaining):
                        break
            try:
                self._flush(lane, batch, total)
            finally:
                with lane.cond:
                    lane.depth -= total

    def _flush(self, lane: _Lane, batch: List[_Pending], total: int
               ) -> None:
        """One group commit: one insert per (app, channel), then each
        submitter's future gets its slice of the ids."""
        t0 = time.monotonic()
        self.flushes += 1
        if self._flush_size is not None:
            self._flush_size.observe(total)
            self._p_flush_size.observe(total, partition=str(lane.index))
        groups: dict = {}
        for p in batch:
            groups.setdefault((p.app_id, p.channel_id), []).append(p)
        for (app_id, channel_id), pendings in groups.items():
            ctx = next((p.trace for p in pendings if p.trace is not None),
                       None)
            if ctx is None:
                self._commit_group(lane, pendings, app_id, channel_id)
                continue
            events = sum(len(p.events) for p in pendings)
            with carried(ctx, "ingest_flush", registry=self._registry,
                         attrs={"events": events,
                                "submits": len(pendings)}):
                self._commit_group(lane, pendings, app_id, channel_id)
        # this lane's own retry-after estimate: a slow partition backs
        # off only its own writers
        lane.last_flush_s = max(0.001, time.monotonic() - t0)
        if self._flush_duration is not None:
            self._flush_duration.observe(time.monotonic() - t0)

    def _commit_group(self, lane: _Lane, pendings: List[_Pending],
                      app_id, channel_id) -> None:
        """One (app, channel)'s insert; each submitter's future gets its
        slice of the ids, then the taps see the committed events."""
        events = [e for p in pendings for e in p.events]
        t_flush_start = time.perf_counter()
        try:
            with span("ingest_flush"):
                ids = self._flush_group(lane, events, app_id, channel_id)
        except Exception as e:  # noqa: BLE001 — fanned out to callers
            for p in pendings:
                if p.future.set_running_or_notify_cancel():
                    p.future.set_exception(_as_storage_error(e))
            return
        commit_s = time.perf_counter() - t_flush_start
        if self._p_commit is not None:
            self._p_commit.observe(commit_s, partition=str(lane.index))
        if self._anatomy is not None and anatomy_enabled():
            try:
                observe_ingest_batch(
                    self._anatomy,
                    [(p.t_submit, p.req_trace) for p in pendings],
                    t_flush_start, commit_s)
            except Exception:
                logger.exception("ingest anatomy observation failed")
        pos = 0
        for p in pendings:
            n = len(p.events)
            if p.future.set_running_or_notify_cancel():
                p.future.set_result(list(ids[pos:pos + n]))
            pos += n
        # only after the commit: a tap never sees an event the store
        # might still lose
        _notify_taps(events, app_id, channel_id)

    def _flush_group(self, lane: _Lane, events, app_id, channel_id
                     ) -> List[str]:
        last_err: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            store = self._store_fn()
            fn = (store.insert_batch if attempt == 0
                  else store.insert_batch_idempotent)
            if lane.attempts is None:
                lane.attempts = _AttemptThread(
                    f"pio-ingest-flush-{lane.index}")
            running = lane.attempts.submit(fn, (events, app_id, channel_id))
            try:
                return running.result(timeout=self.flush_timeout_s)
            except concurrent.futures.TimeoutError as te:
                if running.done():       # the store itself timed out
                    last_err = _as_storage_error(te)
                else:
                    # still running: a retry now could write twice, so
                    # wait one more period and take its outcome
                    try:
                        return running.result(timeout=self.flush_timeout_s)
                    except concurrent.futures.TimeoutError as te2:
                        if not running.done():
                            # the hung attempt keeps its thread; the
                            # lane's next attempt gets a fresh one
                            lane.attempts.close()
                            lane.attempts = None
                            raise StorageError(
                                f"flush hung past {2 * self.flush_timeout_s}"
                                "s; failing without retry (a concurrent "
                                "retry could duplicate events)") from None
                        last_err = _as_storage_error(te2)
                    except Exception as e:
                        last_err = _as_storage_error(e)
            except Exception as e:
                last_err = _as_storage_error(e)
            if attempt == self.retries:
                break
            if self._retry_total is not None:
                self._retry_total.inc()
            # exponential backoff with full jitter, capped
            ceiling = min(self.backoff_cap_s,
                          self.backoff_s * (2.0 ** attempt))
            time.sleep(self._rng.uniform(0.0, max(0.0, ceiling)))
        raise last_err  # type: ignore[misc]

    # -- lifecycle -----------------------------------------------------------
    def stop(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Stop the writers. ``drain=True`` flushes everything queued
        first (accepted events are never dropped); ``drain=False`` fails
        the queued futures at once. The lanes drain at once; the timeout
        bounds the whole stop."""
        threads = []
        for lane in self._lanes:
            with lane.cond:
                self._stopping = True
                if not drain:
                    dropped, lane.queue = list(lane.queue), deque()
                    for p in dropped:
                        lane.depth -= len(p.events)
                        if p.future.set_running_or_notify_cancel():
                            p.future.set_exception(StorageError(
                                "write buffer stopped before flush"))
                threads.append(lane.thread)
                lane.cond.notify_all()
        deadline = time.monotonic() + timeout_s
        for thread in threads:
            if thread is None:
                continue
            thread.join(timeout=max(0.0, deadline - time.monotonic()))
            if thread.is_alive():
                logger.warning("ingest writer did not drain within %.1fs",
                               timeout_s)
        for lane in self._lanes:
            if lane.attempts is not None and not (
                    lane.thread is not None and lane.thread.is_alive()):
                lane.attempts.close()
                lane.attempts = None
