"""Device-memory reads for the capacity ledger (the torch counterpart of
the live-buffer reads of the reference's ``obs/jax_stats.py``).

The reference walks ``jax.live_arrays()``; the port reads the CUDA
caching allocator's own counters instead: ``memory_allocated`` (bytes
held by live tensors), ``memory_stats()["active.all.current"`` (live
allocations) and ``max_memory_allocated`` (the high-water mark). They
are host-side reads with no device synchronisation, so the telemetry
and SLO threads may call them. A process that never initialised CUDA
(the event server, a CPU run) reads zeros: a scrape must not be what
initialises the card.

The reference's ``pio_jax_*`` gauges and compile counter have no
counterpart here (nothing reads them; no program is compiled at serve
time).
"""

from __future__ import annotations

import sys
from typing import Tuple


def _cuda():
    """``torch.cuda`` iff torch is imported and CUDA already initialised."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
    except Exception:
        return None
    return torch.cuda


def live_buffer_stats() -> Tuple[float, float]:
    """(bytes, count) of live device allocations on the current device."""
    cuda = _cuda()
    if cuda is None:
        return (0.0, 0.0)
    try:
        stats = cuda.memory_stats()
        return (float(cuda.memory_allocated()),
                float(stats.get("active.all.current", 0)))
    except Exception:
        return (0.0, 0.0)


def device_watermark_bytes() -> float:
    """High-water mark of live device bytes since process start (or the
    allocator's last ``reset_peak_memory_stats``)."""
    cuda = _cuda()
    if cuda is None:
        return 0.0
    try:
        return float(cuda.max_memory_allocated())
    except Exception:
        return 0.0
