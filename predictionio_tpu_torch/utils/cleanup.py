"""Global at-exit cleanup callback registry (port of the reference's
``utils/cleanup.py``).

Parity with CleanupFunctions (core/.../workflow/CleanupFunctions.scala:
29-65), which the ES storage client and pypio use to close connections
when a workflow ends. The registry is also wired into ``atexit``, so
servers and CLI commands get the same guarantee without an explicit
``run()`` at every exit path.
"""

from __future__ import annotations

import atexit
import logging
import threading
from typing import Callable, List

logger = logging.getLogger("pio.cleanup")

_lock = threading.Lock()
_functions: List[Callable[[], None]] = []
_atexit_registered = False


def add(fn: Callable[[], None]) -> None:
    """Register a zero-argument cleanup callback (CleanupFunctions.add)."""
    global _atexit_registered
    with _lock:
        _functions.append(fn)
        if not _atexit_registered:
            atexit.register(run)
            _atexit_registered = True


def run() -> None:
    """Run and clear every registered callback (CleanupFunctions.run), in
    registration order; a failure is logged, not raised, so one bad
    callback cannot block the rest of shutdown."""
    with _lock:
        fns, _functions[:] = list(_functions), []
    for fn in fns:
        try:
            fn()
        except Exception:  # noqa: BLE001 - shutdown must not raise
            logger.exception("cleanup callback %r failed", fn)


def clear() -> None:
    """Drop the registered callbacks without running them."""
    with _lock:
        _functions.clear()
