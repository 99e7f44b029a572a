"""Fault injection for storage chaos tests (port of the reference's
``storage/faults.py``). Two tools, both off unless explicitly armed:

* :class:`FaultyEvents` — a transparent wrapper around any EventStore
  that injects transient faults into chosen operations: a random error
  rate, added latency, and a deterministic fail-N-then-recover counter.
  ``when="before"`` raises before the real call runs (a clean failure);
  ``when="after"`` runs the real call FIRST and then raises (the
  ambiguous failure: did the write land?). Armed from the environment
  via ``PIO_FAULT_*`` (:meth:`FaultyEvents.from_env`); the storage
  registry wraps ``Storage.get_events()`` when any fault knob is set
  (:func:`env_enabled`).

* **kill points** — named crash sites inside a multi-step write (a
  batch predict's chunk write, an orchestrator phase boundary, a
  release-registry commit, a warm eviction's or warm reload's step:
  ``mt:evict:drained``, ``mt:evict:committed``, ``mt:reload:loaded``,
  ``mt:reload:committed``). :func:`maybe_kill` raises
  :class:`CrashError` (a BaseException, so ordinary retry/except blocks
  cannot swallow it: the in-process stand-in for ``kill -9``) the first
  time each armed point is reached. Armed via ``PIO_FAULT_KILL`` (comma
  list) or :func:`set_kill_points` from tests.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Optional, Sequence

from predictionio_tpu_torch.storage.base import StorageError

#: operations faulted by default: the write path the ingest buffer retries
DEFAULT_FAULT_OPS = ("insert", "insert_batch", "insert_batch_idempotent")


class CrashError(BaseException):
    """An injected kill: deliberately NOT an Exception so except-clauses
    on the retried path cannot absorb it: the process 'dies' here."""


_kill_lock = threading.Lock()
_kill_points: Optional[set] = None     # None = not yet seeded from env


def set_kill_points(points: Sequence[str]) -> None:
    """Arm kill points programmatically (tests). Each fires ONCE."""
    global _kill_points
    with _kill_lock:
        _kill_points = set(points)


def armed_kill_points() -> set:
    global _kill_points
    with _kill_lock:
        if _kill_points is None:
            raw = os.environ.get("PIO_FAULT_KILL", "")
            _kill_points = {p.strip() for p in raw.split(",") if p.strip()}
        return set(_kill_points)


def maybe_kill(point: str) -> None:
    """Crash (once) if ``point`` is armed, e.g. ``batchpredict:chunk``,
    ``orch:canary:armed`` or ``releases:set-status:pre``."""
    armed_kill_points()      # seed from env on first use
    with _kill_lock:
        if _kill_points and point in _kill_points:
            _kill_points.discard(point)
            raise CrashError(f"injected kill at {point}")


def env_enabled(env=os.environ) -> bool:
    """Any PIO_FAULT_* fault knob set -> the registry wraps the event
    store in FaultyEvents."""
    return any(env.get(k) for k in (
        "PIO_FAULT_ERROR_RATE", "PIO_FAULT_LATENCY_S", "PIO_FAULT_FAIL_N"))


class FaultyEvents:
    """EventStore wrapper injecting transient faults into chosen ops.

    Not an EventStore subclass: everything not listed in ``ops`` is
    delegated verbatim via ``__getattr__``, so the wrapper tracks the
    store's interface (snapshot digests, columnar reads, ...)."""

    def __init__(self, inner, *, error_rate: float = 0.0,
                 latency_s: float = 0.0, fail_n: int = 0,
                 when: str = "before",
                 ops: Sequence[str] = DEFAULT_FAULT_OPS,
                 seed: Optional[int] = None):
        if when not in ("before", "after"):
            raise ValueError(f"when must be before|after, got {when!r}")
        self._inner = inner
        self._error_rate = float(error_rate)
        self._latency_s = float(latency_s)
        self._when = when
        self._ops = frozenset(ops)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._fail_remaining = int(fail_n)
        self.faults_fired = 0

    @classmethod
    def from_env(cls, inner, env=os.environ) -> "FaultyEvents":
        ops = env.get("PIO_FAULT_OPS", "")
        seed = env.get("PIO_FAULT_SEED", "")
        return cls(
            inner,
            error_rate=float(env.get("PIO_FAULT_ERROR_RATE", 0) or 0),
            latency_s=float(env.get("PIO_FAULT_LATENCY_S", 0) or 0),
            fail_n=int(env.get("PIO_FAULT_FAIL_N", 0) or 0),
            when=env.get("PIO_FAULT_WHEN", "before") or "before",
            ops=tuple(o.strip() for o in ops.split(",") if o.strip())
            or DEFAULT_FAULT_OPS,
            seed=int(seed) if seed else None,
        )

    def _fault(self, op: str) -> None:
        if self._latency_s:
            time.sleep(self._latency_s)
        with self._lock:
            fire = False
            if self._fail_remaining > 0:
                self._fail_remaining -= 1
                fire = True
            elif self._error_rate and self._rng.random() < self._error_rate:
                fire = True
            if fire:
                self.faults_fired += 1
        if fire:
            raise StorageError(f"injected fault in {op} ({self._when})")

    def _wrap(self, op: str, fn):
        def wrapped(*args, **kwargs):
            if self._when == "before":
                self._fault(op)
                return fn(*args, **kwargs)
            result = fn(*args, **kwargs)
            self._fault(op)
            return result
        wrapped.__name__ = op
        return wrapped

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        if name in self._ops and callable(attr):
            return self._wrap(name, attr)
        return attr

    def __repr__(self) -> str:
        return (f"FaultyEvents({self._inner!r}, rate={self._error_rate}, "
                f"latency={self._latency_s}s, "
                f"fail_remaining={self._fail_remaining}, when={self._when})")
