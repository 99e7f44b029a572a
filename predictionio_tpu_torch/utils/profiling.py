"""Host-phase timing hooks (the reference's ``utils/profiling.py``:
``collect_phases`` and ``phase``; device traces are ``obs/profiler``'s
``torch.profiler`` captures).
"""

from __future__ import annotations

import contextlib
import contextvars
import time

#: ContextVar, not a module global: concurrent requests/trainings each see
#: their own sink instead of clobbering whichever was installed last.
_phase_sink_var: "contextvars.ContextVar[dict]" = contextvars.ContextVar(
    "pio_phase_sink", default=None)


@contextlib.contextmanager
def collect_phases(sink: dict):
    """Install `sink` to receive named host-phase durations (seconds)
    recorded by `phase()` anywhere below this block — how the bench gets
    per-phase breakdowns (build/transfer/...) out of model internals
    without threading timing args through every signature.  The install
    is context-local (thread- and task-safe); note that
    ``loop.run_in_executor`` does NOT propagate context into worker
    threads, so install the sink in the thread that runs the phases."""
    token = _phase_sink_var.set(sink)
    try:
        yield sink
    finally:
        _phase_sink_var.reset(token)


@contextlib.contextmanager
def phase(name: str):
    """Accumulate this block's wall time into the installed sink (no-op
    when none is installed — zero overhead outside profiling)."""
    sink = _phase_sink_var.get()
    if sink is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink[name] = sink.get(name, 0.0) + time.perf_counter() - t0
