"""Named collectives over a mesh axis (port of the reference's
``parallel/collectives.py``).

The reference calls these inside ``shard_map``, where each device holds
one block. The port runs the per-shard function in a plain loop over a
process's local mesh positions, so a collective here takes ``blocks``
(one tensor per local position, in position order) and returns one
result per local position, on that position's device. Positions of
this process combine in-process; positions of other processes arrive
through the ``torch.distributed`` group, staged through host buffers
(gloo moves CPU tensors; a CUDA tensor is copied to the host and back,
always, so there is one rule). Every process of a mesh that spans
processes must call the same collective in the same order.

Each collective combines the blocks of a position's axis group in
position order, so every process computes the same result bit for bit,
and the result equals that of a single-process mesh of the same
positions.

The collectives are differentiable (seqrec trains through them). Inside
one process they are torch ops (``sum``, ``cat``, ``chunk``, a reordered
list), so autograd runs through them as it runs through any op. The
cross-process leg (:func:`gather_positions`: one ``all_gather`` of every
process's blocks) is a ``torch.autograd.Function`` when a block needs a
gradient: its backward sums, over the processes, the gradients each
process took of the blocks it received, and hands each process those
of its own blocks (one ``all_reduce``, the reduce-scatter that
transposes the all-gather). Composed with the in-process combine, the
backward of ``psum`` is a ``psum`` of the gradients, of ``all_gather`` a
``reduce_scatter``, of ``all_to_all`` the inverse ``all_to_all`` and of
``ring_pass`` the ring the other way round. The received blocks live on
the device of this process's first block, so every backward node of a
train runs on one autograd thread, in the graph's order, and every
process issues its backward collectives in the same order. Without a
gradient (ALS) the leg is the plain detached exchange.

:func:`staged_stats` reads the seconds, calls and bytes of the
cross-process leg (host staging and the gloo call, forward and
backward) since :func:`reset_staged_stats`.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch


_STAGED_LOCK = threading.Lock()
_STAGED = {"seconds": 0.0, "calls": 0, "bytes": 0}


def reset_staged_stats() -> None:
    """Zero the cross-process leg's counters."""
    with _STAGED_LOCK:
        _STAGED.update(seconds=0.0, calls=0, bytes=0)


def staged_stats() -> dict:
    """The cross-process leg's seconds, calls and bytes moved (each
    host buffer counted once) since the last reset."""
    with _STAGED_LOCK:
        return dict(_STAGED)


def _note_staged(t0: float, nbytes: int) -> None:
    with _STAGED_LOCK:
        _STAGED["seconds"] += time.perf_counter() - t0
        _STAGED["calls"] += 1
        _STAGED["bytes"] += int(nbytes)


def _start_staging(device: torch.device) -> float:
    """The clock of one cross-process call, started once ``device`` has
    run its queued work (the copy to the host would wait for it)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _layout(mesh) -> Tuple[np.ndarray, list, int]:
    """``(each flat position's process, each position's slot among its
    process's positions, the most positions a process holds)``; raises
    unless every process of the group holds positions of the mesh."""
    import torch.distributed as dist

    world = dist.get_world_size()
    procs = mesh.process_indices.reshape(-1)
    if sorted(set(procs.tolist())) != list(range(world)):
        raise ValueError("a mesh across processes must hold positions of "
                         f"every process of the group (world {world})")
    seen = np.zeros(world, np.int64)
    slots = []
    for p in procs:
        slots.append(int(seen[p]))
        seen[p] += 1
    return procs, slots, int(seen.max())


def _gather_remote(blocks: Sequence[torch.Tensor], mesh) -> List:
    """Every other process's blocks, in flat position order, on the
    device of ``blocks[0]``: one ``all_gather`` of a host buffer of each
    process's blocks (detached)."""
    import torch.distributed as dist

    procs, slots, n_max = _layout(mesh)
    dev = blocks[0].device
    t0 = _start_staging(dev)
    buf = torch.zeros((n_max,) + tuple(blocks[0].shape),
                      dtype=blocks[0].dtype)
    for j, b in enumerate(blocks):
        buf[j] = b.detach().to("cpu")
    outs = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, buf)
    remote = [outs[p][j].to(dev) for p, j in zip(procs, slots)
              if p != mesh.process_index]
    _note_staged(t0, buf.numel() * buf.element_size())
    return remote


class _CrossProcessGather(torch.autograd.Function):
    """The cross-process leg with a gradient: forward, the other
    processes' blocks (:func:`_gather_remote`); backward, each local
    block's gradient from the other processes, summed over them (one
    ``all_reduce`` of a buffer of every position's gradient)."""

    @staticmethod
    def forward(ctx, mesh, *blocks):
        ctx.mesh = mesh
        ctx.local = [(b.shape, b.dtype, b.device) for b in blocks]
        return tuple(_gather_remote(blocks, mesh))

    @staticmethod
    def backward(ctx, *grads):
        import torch.distributed as dist

        mesh = ctx.mesh
        procs, slots, n_max = _layout(mesh)
        shape, dtype, dev = ctx.local[0]
        t0 = _start_staging(dev)
        buf = torch.zeros((dist.get_world_size(), n_max) + tuple(shape),
                          dtype=dtype)
        remote = iter(grads)
        for p, j in zip(procs, slots):
            if p != mesh.process_index:
                g = next(remote)
                if g is not None:
                    buf[p, j] = g.detach().to("cpu")
        dist.all_reduce(buf)
        own = buf[mesh.process_index]
        out = [own[j].to(d) for j, (_s, _t, d) in enumerate(ctx.local)]
        _note_staged(t0, buf.numel() * buf.element_size())
        return (None, *out)


def _local_blocks(blocks: Sequence[torch.Tensor], mesh) -> List:
    """``blocks`` as a list, one a local position (else ``ValueError``)."""
    blocks = list(blocks)
    if len(blocks) != len(mesh.local_positions()):
        raise ValueError(f"{len(blocks)} blocks for "
                         f"{len(mesh.local_positions())} local positions")
    return blocks


def gather_positions(blocks: Sequence[torch.Tensor], mesh) -> List:
    """Every position's block in flat position order: the local ones as
    given, another process's received through the group onto the device
    of this process's first block (through :class:`_CrossProcessGather`
    when a block needs a gradient). Blocks have one shape and dtype
    across positions (SPMD), and every process of the group holds
    positions of the mesh."""
    blocks = _local_blocks(blocks, mesh)
    if not mesh.spans_processes:
        return blocks
    if torch.is_grad_enabled() and any(b.requires_grad for b in blocks):
        remote = iter(_CrossProcessGather.apply(mesh, *blocks))
    else:
        remote = iter(_gather_remote(blocks, mesh))
    local = iter(blocks)
    return [next(local) if p == mesh.process_index else next(remote)
            for p in mesh.process_indices.reshape(-1)]


def _axis_rows(mesh, axis: str) -> Dict[int, Tuple[Tuple[int, ...], int]]:
    """Flat position -> (its axis group in axis order, its index there)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} not in mesh axes {mesh.axis_names}")
    a = mesh.axis_names.index(axis)
    grid = np.arange(mesh.size).reshape(mesh.devices.shape)
    rows = np.moveaxis(grid, a, -1).reshape(-1, grid.shape[a])
    out = {}
    for row in rows:
        t = tuple(int(p) for p in row)
        for i, p in enumerate(t):
            out[p] = (t, i)
    return out


def _per_local(mesh, axis: str, blocks, combine: Callable) -> List:
    """``combine(group, index, device)`` for each local position: its
    axis group's blocks in axis order, its index in that group, its
    device. When no group of ``axis`` holds positions of two processes
    (a property of the mesh, the same in every process) nothing crosses
    the group."""
    rows = _axis_rows(mesh, axis)
    procs = mesh.process_indices.reshape(-1)
    if any(len({procs[q] for q in row}) > 1 for row, _ in rows.values()):
        every = gather_positions(blocks, mesh)
    else:
        every = dict(zip(mesh.local_positions(),
                         _local_blocks(blocks, mesh)))
    flat_dev = mesh.devices.reshape(-1)
    out = []
    for p in mesh.local_positions():
        row, i = rows[p]
        dev = flat_dev[p]
        out.append(combine([every[q] for q in row], i, dev))
    return out


def _sum_on(group: List[torch.Tensor], dev) -> torch.Tensor:
    acc = group[0].to(dev)
    for g in group[1:]:
        acc = acc + g.to(dev)
    return acc


def psum(blocks, mesh, axis: str) -> List[torch.Tensor]:
    """Each position gets the sum of its axis group's blocks."""
    memo: dict = {}

    def combine(group, _i, dev):
        key = (tuple(id(g) for g in group), str(dev))
        if key not in memo:
            memo[key] = _sum_on(group, dev)
        return memo[key]

    return _per_local(mesh, axis, blocks, combine)


def pmean(blocks, mesh, axis: str) -> List[torch.Tensor]:
    """Each position gets the mean of its axis group's blocks."""
    n = mesh.shape[axis]
    return [s / n for s in psum(blocks, mesh, axis)]


def all_gather(blocks, mesh, axis: str, *, tiled: bool = True
               ) -> List[torch.Tensor]:
    """Each position gets its axis group's blocks in axis order,
    concatenated along dim 0 (``tiled``) or stacked on a new dim 0."""
    memo: dict = {}

    def combine(group, _i, dev):
        key = (tuple(id(g) for g in group), str(dev))
        if key not in memo:
            parts = [g.to(dev) for g in group]
            memo[key] = torch.cat(parts) if tiled else torch.stack(parts)
        return memo[key]

    return _per_local(mesh, axis, blocks, combine)


def reduce_scatter(blocks, mesh, axis: str) -> List[torch.Tensor]:
    """The sum of the axis group's blocks, split along dim 0 into one
    chunk per group position; position i keeps chunk i."""
    n = mesh.shape[axis]

    def combine(group, i, dev):
        return torch.chunk(_sum_on(group, dev), n, dim=0)[i]

    return _per_local(mesh, axis, blocks, combine)


def all_to_all(blocks, mesh, axis: str, split_axis: int = 0,
               concat_axis: int = 0) -> List[torch.Tensor]:
    """Each block splits into one chunk per group position along
    ``split_axis``; position i receives chunk i of every group member's
    block, concatenated along ``concat_axis`` in axis order."""
    n = mesh.shape[axis]

    def combine(group, i, dev):
        return torch.cat([torch.chunk(g, n, dim=split_axis)[i].to(dev)
                          for g in group], dim=concat_axis)

    return _per_local(mesh, axis, blocks, combine)


def ring_pass(blocks, mesh, axis: str, axis_size: int,
              reverse: bool = False) -> List[torch.Tensor]:
    """Send each block to the next position on the axis ring, receive
    from the previous one (the previous's block lands at position i;
    ``reverse`` sends to the previous instead)."""
    def combine(group, i, dev):
        src = (i + 1) % axis_size if reverse else (i - 1) % axis_size
        return group[src].to(dev)

    return _per_local(mesh, axis, blocks, combine)


def ring_reduce(blocks, mesh, axis: str, axis_size: int,
                op: Callable = torch.add) -> List[torch.Tensor]:
    """All-reduce by ``axis_size - 1`` explicit ring passes (the
    reference's didactic path; :func:`psum` gives the sum directly)."""
    acc = list(blocks)
    block = list(blocks)
    for _ in range(axis_size - 1):
        block = ring_pass(block, mesh, axis, axis_size)
        acc = [op(a, b) for a, b in zip(acc, block)]
    return acc


def broadcast_one_to_all(arrays: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Process 0's numpy arrays on every process of the group, through
    ``torch.distributed.broadcast`` (the reference's
    ``multihost_utils.broadcast_one_to_all``). Every process passes
    arrays of the same shapes and dtypes; without a group they come
    back as given."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return [np.asarray(a) for a in arrays]
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a)).clone()
        dist.broadcast(t, src=0)
        out.append(t.numpy())
    return out
