"""The open-loop load harness (port of the reference's
``loadtest/harness.py``): one implementation of "offered load vs
observed ack", shared by the loadtest simulator and the smoke's ingest
curve.

The discipline, exactly as the ingest bench established it:

* **Open loop** — the submit schedule never slows because the system
  lags; only a bounded outstanding window provides backpressure, so a
  saturated system shows up as GROWING ack latency rather than a
  silently reduced offered rate (the classic closed-loop lie).
* **Ack latency is submit -> future resolved** — the full path the
  caller experiences (queueing + commit), not the server's internal
  service time.
* **Every offered item is accounted** — acked, failed, or still
  outstanding at the deadline; nothing vanishes. The zero-dropped-acks
  invariant is ``offered == acked`` and ``timed_out is False``.
"""

from __future__ import annotations

import dataclasses
import os
import select
import threading
import time
from typing import Callable, Iterable, List, Optional, Sequence

__all__ = ["LatencyLedger", "OpenLoopResult", "drive_open_loop",
           "child_env", "read_line"]

#: the directory holding this package: a child process of the load test
#: (the storm's traffic, the fleet's router) imports the package from it
_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def child_env() -> dict:
    """This process's environment, with the package on ``PYTHONPATH``
    (it is not installed: a ``python -c`` child finds it only so)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_PACKAGE_PARENT] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def read_line(stream, timeout_s: float) -> str:
    """One line from a child's pipe, or "" at its end or the deadline."""
    ready, _, _ = select.select([stream], [], [], timeout_s)
    return stream.readline().decode(errors="replace") if ready else ""


class LatencyLedger:
    """Thread-safe latency accounting shared by every lane: record in
    seconds from any thread, read percentiles once at the end. The
    percentile is the sorted-index estimator the ingest bench used
    (``sorted[int(q/100 * n)]``), not an interpolation — comparable
    across every config that reports p99."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._samples: List[float] = []

    def record(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(seconds)

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def samples(self) -> List[float]:
        with self._lock:
            return list(self._samples)

    def percentile_ms(self, q: float) -> float:
        """q in [0, 100]; 0.0 when no samples were recorded."""
        with self._lock:
            if not self._samples:
                return 0.0
            ordered = sorted(self._samples)
        idx = min(len(ordered) - 1, int(q / 100.0 * len(ordered)))
        return ordered[idx] * 1000.0

    def mean_ms(self) -> float:
        with self._lock:
            if not self._samples:
                return 0.0
            return sum(self._samples) / len(self._samples) * 1000.0


@dataclasses.dataclass
class OpenLoopResult:
    """What one open-loop drive observed."""

    offered: int            #: items offered (weighted — events, not batches)
    acked: int              #: items whose future resolved without error
    failed: int             #: items whose future resolved WITH an error
    wall_s: float           #: first submit -> last ack (or deadline)
    ledger: LatencyLedger   #: one ack-latency sample per submit
    timed_out: bool = False

    @property
    def dropped(self) -> int:
        """Offered items never acknowledged at all — the invariant that
        must be zero for a run to count."""
        return self.offered - self.acked - self.failed

    def events_per_s(self) -> float:
        return self.acked / self.wall_s if self.wall_s > 0 else 0.0

    def p99_ms(self) -> float:
        return self.ledger.percentile_ms(99)

    def as_dict(self) -> dict:
        return {
            "offered": self.offered, "acked": self.acked,
            "failed": self.failed, "dropped": self.dropped,
            "wall_s": round(self.wall_s, 4),
            "events_per_s": round(self.events_per_s(), 1),
            "ack_p50_ms": round(self.ledger.percentile_ms(50), 2),
            "ack_p99_ms": round(self.ledger.percentile_ms(99), 2),
            "timed_out": self.timed_out,
        }


def drive_open_loop(items: Iterable, submit: Callable,
                    *,
                    max_outstanding: int = 1024,
                    timeout_s: float = 600.0,
                    weight: Optional[Callable] = None,
                    schedule: Optional[Sequence[float]] = None,
                    on_ack: Optional[Callable] = None,
                    ledger: Optional[LatencyLedger] = None) -> OpenLoopResult:
    """Offer every item through ``submit(item) -> Future`` under a
    bounded outstanding window, recording ack latency submit->resolve.

    ``submit`` must return a ``concurrent.futures.Future``-compatible
    object (``add_done_callback`` + ``exception()``) — a WriteBuffer
    submit future, an ``asyncio.run_coroutine_threadsafe`` handle, or
    anything shaped like them.

    ``weight(item)`` converts an item to its event count (``len`` for
    batch submits, default 1 per item) so offered/acked tallies and
    events/s are in EVENTS regardless of batching shape.

    ``schedule`` — optional arrival offsets (seconds from drive start),
    one per item, ascending: the open-loop pacing. Without it items are
    offered back-to-back (the bench's max-rate shape). The window still
    backpressures a schedule that outruns the system, and the deadline
    (``timeout_s``, measured from start) bounds the whole drive.

    ``on_ack(item, future)`` runs on the resolver thread after a
    SUCCESSFUL ack — keep it cheap (the simulator records acked event
    ids for the exactly-once audit there).
    """
    w = weight or (lambda _item: 1)
    led = ledger if ledger is not None else LatencyLedger()
    window = threading.BoundedSemaphore(max_outstanding)
    lock = threading.Lock()
    state = {"offered": 0, "acked": 0, "failed": 0, "pending": 0}
    all_offered = threading.Event()
    drained = threading.Event()
    t_start = time.perf_counter()
    deadline = t_start + timeout_s

    def _resolve(item, n, fut, t_submit) -> None:
        try:
            err = fut.exception()
        except Exception as e:  # cancelled futures surface here
            err = e
        if err is None:
            led.record(time.perf_counter() - t_submit)
        with lock:
            if err is None:
                state["acked"] += n
            else:
                state["failed"] += n
            state["pending"] -= 1
            done = all_offered.is_set() and state["pending"] == 0
        if err is None and on_ack is not None:
            try:
                on_ack(item, fut)
            except Exception:
                pass
        window.release()
        if done:
            drained.set()

    for i, item in enumerate(items):
        if schedule is not None:
            due = t_start + schedule[i]
            while True:
                now = time.perf_counter()
                if now >= due or now >= deadline:
                    break
                time.sleep(min(due - now, 0.05))
        if time.perf_counter() >= deadline:
            break
        # the bounded window: block (with deadline) until a slot frees
        if not window.acquire(timeout=max(0.0, deadline
                                          - time.perf_counter())):
            break
        n = w(item)
        with lock:
            state["offered"] += n
            state["pending"] += 1
        t_submit = time.perf_counter()
        try:
            fut = submit(item)
        except Exception:
            with lock:
                state["failed"] += n
                state["pending"] -= 1
            window.release()
            continue
        fut.add_done_callback(
            lambda f, item=item, n=n, t=t_submit: _resolve(item, n, f, t))
    all_offered.set()
    with lock:
        pending_now = state["pending"]
    if pending_now == 0:
        drained.set()
    timed_out = not drained.wait(max(0.0, deadline - time.perf_counter()))
    wall = time.perf_counter() - t_start
    with lock:
        return OpenLoopResult(
            offered=state["offered"], acked=state["acked"],
            failed=state["failed"], wall_s=wall, ledger=led,
            timed_out=timed_out)
