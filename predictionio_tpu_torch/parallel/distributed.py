"""Multi-process runtime (port of the reference's
``parallel/distributed.py``).

Every process runs the same program. :func:`initialize_distributed`
joins them into one ``torch.distributed`` process group (``gloo``,
rendezvous over TCP at the coordinator's address); meshes built
afterwards (``parallel/mesh.make_mesh``) hold one position per process,
and the collectives of ``parallel/collectives`` and ``parallel/shuffle``
cross processes through the group. Tensors on the card are staged
through host buffers for the collectives: gloo moves CPU tensors, and
one card cannot hold two NCCL ranks.

Env contract (the reference's):
  PIO_COORDINATOR_ADDRESS  host:port of process 0's rendezvous store
  PIO_NUM_PROCESSES        total process count
  PIO_PROCESS_ID           this process's index

An offline shard fleet (``pio batchpredict``) is N processes with the
last two variables each and no process group (:func:`resolve_worker`).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

logger = logging.getLogger("pio.torch.distributed")

#: seconds a rendezvous or a collective may wait for the other
#: processes before it fails (torch.distributed's own default is 30 min)
DEFAULT_TIMEOUT_S = 300.0

_initialized = False


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           timeout_s: Optional[float] = None) -> None:
    """Join the process group, with the ``PIO_*`` env fallbacks.

    Idempotent; a no-op when neither an address nor a process count is
    given (a single-process run). Otherwise it needs all three and calls
    ``torch.distributed.init_process_group("gloo", init_method=
    "tcp://<address>")``, which waits up to ``timeout_s`` for every
    process to arrive and raises if one does not."""
    global _initialized
    if _initialized:
        return
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get(
        "PIO_COORDINATOR_ADDRESS")
    num_processes = num_processes if num_processes is not None else (
        int(os.environ["PIO_NUM_PROCESSES"])
        if "PIO_NUM_PROCESSES" in os.environ else None)
    process_id = process_id if process_id is not None else (
        int(os.environ["PIO_PROCESS_ID"])
        if "PIO_PROCESS_ID" in os.environ else None)
    if coordinator_address is None and num_processes is None:
        logger.info("single-process run; no process group")
        _initialized = True
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "a multi-process run needs PIO_COORDINATOR_ADDRESS, "
            "PIO_NUM_PROCESSES and PIO_PROCESS_ID (got "
            f"{coordinator_address!r}, {num_processes!r}, {process_id!r})")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside "
                         f"[0, {num_processes})")
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=datetime.timedelta(
                seconds=DEFAULT_TIMEOUT_S if timeout_s is None
                else timeout_s))
    logger.info("process group initialized: process %d/%d",
                dist.get_rank(), dist.get_world_size())
    _initialized = True


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


def group_rank_size() -> "tuple[int, int]":
    """(rank, world size) of the initialized process group, else
    (0, 1): what decides whether a train runs across processes."""
    group = _torch_group()
    return group if group is not None else (0, 1)


def process_count() -> int:
    """Processes of this run: the process group's size when one is
    initialized, else ``resolve_worker``'s."""
    group = _torch_group()
    return group[1] if group is not None else resolve_worker()[1]


def process_index() -> int:
    """This process's index: its rank in the process group when one is
    initialized, else ``resolve_worker``'s."""
    group = _torch_group()
    return group[0] if group is not None else resolve_worker()[0]


def global_array_from_local(mesh, local, axis: str = "data"):
    """The global tensor stitched from every position's block along
    ``axis`` (concatenated in position order), on this process's first
    local device. ``local`` is this process's blocks, one per local
    position (a list, or a tensor whose first dimension counts them).
    Collective: every process of the mesh calls it."""
    from predictionio_tpu_torch.parallel.collectives import all_gather

    blocks = list(local)
    return all_gather(blocks, mesh, axis)[0]
