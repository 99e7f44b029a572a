"""Kill points for crash tests (the reference's ``storage/faults.py``:
``CrashError``, ``set_kill_points``, ``armed_kill_points`` and
``maybe_kill``; its ``FaultyEvents`` store wrapper is not ported yet).

A kill point is a named crash site inside a multi-step write (a batch
predict's chunk write, its shard merge). :func:`maybe_kill` raises
:class:`CrashError` (a BaseException, so ordinary retry/except blocks
cannot swallow it: the in-process stand-in for ``kill -9``) the first
time each armed point is reached. Armed via ``PIO_FAULT_KILL`` (comma
list) or :func:`set_kill_points` from tests.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Sequence


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
    """Crash (once) if ``point`` is armed, e.g. ``batchpredict:chunk``
    or ``batchpredict:merge``."""
    armed_kill_points()      # seed from env on first use
    with _kill_lock:
        if _kill_points and point in _kill_points:
            _kill_points.discard(point)
            raise CrashError(f"injected kill at {point}")
