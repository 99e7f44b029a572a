"""The worker contract of a multi-process run (the reference's
``parallel/distributed.py``: ``resolve_worker``, ``worker_env``,
``contiguous_range`` and ``process_count`` only).

An offline shard fleet (``pio batchpredict``) is N processes with two
environment variables each, ``PIO_PROCESS_ID`` and
``PIO_NUM_PROCESSES``; no collective runtime is needed for it. The
reference's ``initialize_distributed`` (``jax.distributed``) is not
ported yet: a process group of the port is one of
``torch.distributed``, which ``resolve_worker`` reads when one is
initialized.
"""

from __future__ import annotations

import os
from typing import Optional


def _torch_group() -> Optional["tuple[int, int]"]:
    """(rank, world size) of an initialized ``torch.distributed`` group,
    else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return None


def resolve_worker(rank: Optional[int] = None,
                   size: Optional[int] = None) -> "tuple[int, int]":
    """This process's (rank, size) under the PIO_* process contract.

    Explicit arguments win; then the ``PIO_PROCESS_ID`` /
    ``PIO_NUM_PROCESSES`` env pair; then an initialized
    ``torch.distributed`` process group; else (0, 1).
    """
    if rank is not None and size is not None:
        if not 0 <= rank < size:
            raise ValueError(f"worker rank {rank} outside [0, {size})")
        return rank, size
    if "PIO_NUM_PROCESSES" in os.environ:
        size = int(os.environ["PIO_NUM_PROCESSES"])
        rank = int(os.environ.get("PIO_PROCESS_ID", "0"))
        if not 0 <= rank < size:
            raise ValueError(
                f"PIO_PROCESS_ID={rank} outside [0, PIO_NUM_PROCESSES={size})")
        return rank, size
    group = _torch_group()
    return group if group is not None else (0, 1)


def worker_env(rank: int, size: int, base: Optional[dict] = None,
               trace_context=None) -> dict:
    """The environment for spawning one shard of a fleet run: the
    ``PIO_PROCESS_ID``/``PIO_NUM_PROCESSES`` contract plus the parent's
    trace context as ``PIO_TRACE_CONTEXT`` (``obs/trace_context``), so
    one trace id spans the parent and every shard it launches. The
    parent's context defaults to the trace active at call time; pass
    ``trace_context`` to pin one."""
    if not 0 <= rank < size:
        raise ValueError(f"worker rank {rank} outside [0, {size})")
    from predictionio_tpu_torch.obs.trace_context import child_env
    from predictionio_tpu_torch.obs.tracing import capture_context

    ctx = trace_context if trace_context is not None else capture_context()
    env = child_env(ctx, base)
    env["PIO_PROCESS_ID"] = str(rank)
    env["PIO_NUM_PROCESSES"] = str(size)
    return env


def contiguous_range(n: int, rank: int, size: int) -> "tuple[int, int]":
    """Row range [lo, hi) owned by `rank` of `size` over `n` rows:
    contiguous, disjoint, covering, balanced to within one row."""
    if size <= 0 or not 0 <= rank < size:
        raise ValueError(f"bad shard ({rank}, {size})")
    base, extra = divmod(max(0, n), size)
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (1 if rank < extra else 0)


def process_count() -> int:
    """Processes of this run (``resolve_worker``'s size)."""
    return resolve_worker()[1]
