"""On-demand device profiling: bounded ``torch.profiler`` captures +
per-kernel-family dispatch attribution (the reference's
``obs/profiler.py``).

* **dispatch attribution**: the port's kernel wrappers
  (``ops/kernels.shortlist_topc_cuda``, family ``shortlist``, and
  ``spd_solve_cuda``, family ``spd_solve``) add each call's host wall
  time to ``pio_device_dispatch_seconds_total{family}``. A CUDA launch
  returns before its kernel ends, so this is the wrappers' launch time
  (argument checks, plan, enqueue), not kernel time: the kernel's time
  shows in the anatomy's ``device`` stage, which closes once the result
  is on the host. ``PIO_DISPATCH_ATTRIBUTION=0`` disables it.

* **bounded trace capture**: :func:`capture` runs ``torch.profiler``
  (CPU and CUDA activities) for a capped duration and writes a Chrome
  trace into the trace directory, exposed as ``POST /debug/profile`` on
  the query server and ``pio profile``. One capture at a time (a second
  request gets a busy error), duration clamped to :data:`MAX_CAPTURE_S`:
  an operator can never wedge a serving box with an unbounded profile.
"""

from __future__ import annotations

import collections
import os
import tempfile
import threading
import time
from typing import Dict, Optional

from predictionio_tpu_torch.obs.registry import (
    MetricsRegistry, default_registry,
)

DISPATCH_ENV = "PIO_DISPATCH_ATTRIBUTION"
DISPATCH_COUNTER = "pio_device_dispatch_seconds_total"

MAX_CAPTURE_S = 60.0

#: the Chrome trace a capture writes into its directory
TRACE_FILE = "trace.json"

_capture_lock = threading.Lock()
_calls_lock = threading.Lock()
#: attributed dispatches per family since process start (the seconds
#: counter says how long, this how many)
_calls: "collections.Counter[str]" = collections.Counter()


def dispatch_attribution_enabled() -> bool:
    return os.environ.get(DISPATCH_ENV, "1").strip().lower() not in (
        "0", "false", "no", "off")


def dispatch_counter(registry: Optional[MetricsRegistry] = None):
    """The family-labelled device-dispatch seconds counter."""
    return (registry or default_registry()).counter(
        DISPATCH_COUNTER,
        "Host wall seconds in the kernel wrappers (argument checks + "
        "launch; CUDA launches are asynchronous, so not kernel time), "
        "per kernel family",
        labelnames=("family",))


def note_dispatch(family: str, seconds: float, counter=None) -> None:
    """Account one attributed dispatch of ``family``."""
    (counter or dispatch_counter()).inc(seconds, family=family)
    with _calls_lock:
        _calls[family] += 1


def dispatch_calls() -> Dict[str, int]:
    """Attributed dispatches per family since process start."""
    with _calls_lock:
        return dict(_calls)


def dispatch_table(registry: Optional[MetricsRegistry] = None
                   ) -> Dict[str, float]:
    """Seconds per family, highest first."""
    metric = (registry or default_registry()).get(DISPATCH_COUNTER)
    if metric is None:
        return {}
    table = {labels.get("family", "?"): value
             for labels, value in metric.samples()}
    return dict(sorted(table.items(), key=lambda kv: -kv[1]))


class ProfileBusy(Exception):
    """A capture is already running; exactly one at a time."""


def reserve() -> bool:
    """Take the one capture slot without blocking; False when a capture
    holds it. A :func:`capture` with ``reserved=True`` releases it."""
    return _capture_lock.acquire(blocking=False)


def capture(seconds: float, outdir: Optional[str] = None,
            reserved: bool = False) -> dict:
    """Run a bounded ``torch.profiler`` trace; returns {traceDir,
    seconds, dispatch} (the dispatch table rides along so one call
    answers both "what ran" and "who ate the time"). The trace is
    ``<traceDir>/trace.json`` (Chrome trace format).

    Raises :class:`ProfileBusy` when a capture is in flight (unless the
    caller ``reserved`` the slot) and RuntimeError when the profiler is
    unavailable or recorded nothing.
    The sleep happens INSIDE the trace window: callers run this off the
    event loop."""
    if not reserved and not reserve():
        raise ProfileBusy("a profile capture is already running")
    try:
        seconds = min(max(0.01, float(seconds)), MAX_CAPTURE_S)
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
        except ImportError as e:
            raise RuntimeError(f"torch profiler unavailable: {e}") from e
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        trace_dir = outdir or tempfile.mkdtemp(prefix="pio-profile-")
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, TRACE_FILE)
        t0 = time.perf_counter()
        try:
            with profile(activities=activities) as prof:
                time.sleep(seconds)
            prof.export_chrome_trace(path)
        except Exception as e:
            raise RuntimeError(f"torch profiler capture failed: {e}") from e
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            raise RuntimeError("torch profiler wrote no trace")
        return {
            "traceDir": trace_dir,
            "seconds": round(time.perf_counter() - t0, 3),
            "dispatch": dispatch_table(),
        }
    finally:
        _capture_lock.release()
