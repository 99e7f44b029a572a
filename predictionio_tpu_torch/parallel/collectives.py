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
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch


def gather_positions(blocks: Sequence[torch.Tensor], mesh) -> List:
    """Every position's block in flat position order: the local ones as
    given, another process's as CPU tensors received through the group.
    Blocks have one shape and dtype across positions (SPMD), and every
    process of the group holds positions of the mesh."""
    blocks = list(blocks)
    if len(blocks) != len(mesh.local_positions()):
        raise ValueError(f"{len(blocks)} blocks for "
                         f"{len(mesh.local_positions())} local positions")
    if not mesh.spans_processes:
        return blocks
    import torch.distributed as dist

    world = dist.get_world_size()
    procs = mesh.process_indices.reshape(-1)
    if sorted(set(procs.tolist())) != list(range(world)):
        raise ValueError("a mesh across processes must hold positions of "
                         f"every process of the group (world {world})")
    counts = np.bincount(procs, minlength=world)
    n_max = int(counts.max())
    buf = torch.zeros((n_max,) + tuple(blocks[0].shape),
                      dtype=blocks[0].dtype)
    for j, b in enumerate(blocks):
        buf[j] = b.detach().to("cpu")
    outs = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(outs, buf)
    seen = np.zeros(world, np.int64)
    result = []
    me = mesh.process_index
    local = iter(blocks)
    for p in procs:
        j = int(seen[p])
        seen[p] += 1
        result.append(next(local) if p == me else outs[p][j])
    return result


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
    device."""
    every = gather_positions(blocks, mesh)
    rows = _axis_rows(mesh, axis)
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
