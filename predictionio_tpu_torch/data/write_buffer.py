"""Group-commit write buffer between the event server and the event
store (port of the reference's ``data/write_buffer.py``, one commit
lane).

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
  exponential backoff and full jitter. Each attempt runs on its own
  thread, bounded by ``flush_timeout_s``; an attempt still running
  after a second timeout fails the batch without a retry (a concurrent
  retry could write twice). A caller's future fails only when every
  attempt has.

* **flush taps** — ``add_flush_tap(tap)`` subscribes
  ``tap(events, app_id, channel_id)`` to every successful group commit
  of every buffer in the process (the push path of online fold-in,
  ``deploy/foldin``). A tap runs on the writer thread only after the
  commit landed, never for a failed flush; a tap that raises is logged
  and the flush goes on.

``stop(drain=True)`` flushes everything queued before it returns.

The reference's parallel commit lanes (``partitions``) come with the
partitioned event store.
"""

from __future__ import annotations

import concurrent.futures
import logging
import random
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.storage.base import StorageError, generate_id

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
    """The bounded ingest queue cannot take these events now.
    ``retry_after`` estimates, in whole seconds, when it can: the queue
    depth over the observed flush rate."""

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


def _attempt(fn: Callable, args) -> "concurrent.futures.Future":
    """Run ``fn(*args)`` on a new daemon thread: a hung storage call can
    never hold the slot the next attempt needs."""
    f: concurrent.futures.Future = concurrent.futures.Future()

    def run():
        try:
            f.set_result(fn(*args))
        except BaseException as e:  # noqa: BLE001 — relayed to the waiter
            f.set_exception(e)

    threading.Thread(target=run, daemon=True,
                     name="pio-ingest-flush").start()
    return f


class _Pending:
    __slots__ = ("events", "app_id", "channel_id", "future")

    def __init__(self, events, app_id, channel_id, future):
        self.events = events
        self.app_id = app_id
        self.channel_id = channel_id
        self.future = future


class WriteBuffer:
    """Bounded group-commit buffer in front of an EventStore
    (``store_fn()`` returns the store at each flush)."""

    def __init__(self, store_fn: Callable, *, queue_max: int = 8192,
                 flush_max: int = 256, linger_s: float = 0.002,
                 retries: int = 4, backoff_s: float = 0.05,
                 backoff_cap_s: float = 1.0, flush_timeout_s: float = 30.0):
        self._store_fn = store_fn
        self.queue_max = max(1, queue_max)
        self.flush_max = max(1, flush_max)
        self.linger_s = max(0.0, linger_s)
        self.retries = max(0, retries)
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self.flush_timeout_s = flush_timeout_s
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._depth = 0              # queued + in-flush events
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._last_flush_s = 0.05    # seeds the retry-after estimate
        self._rng = random.Random()
        #: group commits run so far (fewer than submits when they
        #: coalesce)
        self.flushes = 0

    # -- caller side ---------------------------------------------------------
    def _retry_after(self) -> int:
        est = (self._depth / self.flush_max) * self._last_flush_s
        return int(min(60, max(1, est + 0.999)))

    def submit(self, events: Sequence[Event], app_id: int,
               channel_id: Optional[int] = None
               ) -> "concurrent.futures.Future[List[str]]":
        """Queue events for group commit; returns a future of their ids
        (assigned here). Raises :class:`BufferFull` past the bound and
        ``StorageError`` once stopped."""
        events = [e if e.event_id else _with_id(e) for e in events]
        future: concurrent.futures.Future = concurrent.futures.Future()
        with self._cond:
            if self._stopping:
                raise StorageError("write buffer is shut down")
            if self._depth + len(events) > self.queue_max:
                raise BufferFull(self._depth, self._retry_after())
            self._queue.append(_Pending(events, app_id, channel_id, future))
            self._depth += len(events)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._worker, daemon=True,
                    name="pio-ingest-writer")
                self._thread.start()
            self._cond.notify()
        return future

    # -- writer side ---------------------------------------------------------
    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stopping:
                    self._cond.wait()
                if not self._queue:
                    return
                batch = [self._queue.popleft()]
                total = len(batch[0].events)
                # linger for concurrent submits, never past a full
                # flush; while draining, take what is queued but do not
                # wait for more
                deadline = time.monotonic() + self.linger_s
                while total < self.flush_max:
                    if self._queue:
                        batch.append(self._queue.popleft())
                        total += len(batch[-1].events)
                        continue
                    if self._stopping:
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cond.wait(remaining):
                        break
            try:
                self._flush(batch, total)
            finally:
                with self._cond:
                    self._depth -= total

    def _flush(self, batch: List[_Pending], total: int) -> None:
        """One group commit: one insert per (app, channel), then each
        submitter's future gets its slice of the ids."""
        t0 = time.monotonic()
        self.flushes += 1
        groups: dict = {}
        for p in batch:
            groups.setdefault((p.app_id, p.channel_id), []).append(p)
        for (app_id, channel_id), pendings in groups.items():
            events = [e for p in pendings for e in p.events]
            try:
                ids = self._flush_group(events, app_id, channel_id)
            except Exception as e:  # noqa: BLE001 — fanned out to callers
                for p in pendings:
                    if p.future.set_running_or_notify_cancel():
                        p.future.set_exception(_as_storage_error(e))
                continue
            pos = 0
            for p in pendings:
                n = len(p.events)
                if p.future.set_running_or_notify_cancel():
                    p.future.set_result(list(ids[pos:pos + n]))
                pos += n
            # only after the commit: a tap never sees an event the store
            # might still lose
            _notify_taps(events, app_id, channel_id)
        self._last_flush_s = max(0.001, time.monotonic() - t0)

    def _flush_group(self, events, app_id, channel_id) -> List[str]:
        last_err: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            store = self._store_fn()
            fn = (store.insert_batch if attempt == 0
                  else store.insert_batch_idempotent)
            running = _attempt(fn, (events, app_id, channel_id))
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
            # exponential backoff with full jitter, capped
            ceiling = min(self.backoff_cap_s,
                          self.backoff_s * (2.0 ** attempt))
            time.sleep(self._rng.uniform(0.0, max(0.0, ceiling)))
        raise last_err  # type: ignore[misc]

    # -- lifecycle -----------------------------------------------------------
    def stop(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Stop the writer. ``drain=True`` flushes everything queued
        first (accepted events are never dropped); ``drain=False`` fails
        the queued futures at once."""
        with self._cond:
            self._stopping = True
            if not drain:
                dropped, self._queue = list(self._queue), deque()
                for p in dropped:
                    self._depth -= len(p.events)
                    if p.future.set_running_or_notify_cancel():
                        p.future.set_exception(StorageError(
                            "write buffer stopped before flush"))
            thread = self._thread
            self._cond.notify_all()
        if thread is not None:
            thread.join(timeout=timeout_s)
            if thread.is_alive():
                logger.warning("ingest writer did not drain within %.1fs",
                               timeout_s)
