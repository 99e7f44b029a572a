"""The mesh of mesh positions (port of the reference's
``parallel/mesh.py``).

Canonical axis names for the framework:
  * "data"  — batch/entity sharding (users, items, events, queries)
  * "model" — factor/parameter sharding (reserved for large-rank models)

A reference ``Mesh`` is an array of devices, each belonging to one
process. The port's :class:`Mesh` is an array of mesh positions, each a
``(process_index, torch.device)`` pair: what runs at a position runs in
that process on that device, and what crosses processes goes through the
``torch.distributed`` group (``parallel/collectives``). By default
:func:`make_mesh` gives one position per process of the group, each on
that process's own device. An explicit device list may repeat a device
(``make_mesh(devices=[torch.device("cpu")] * 8)``): each position is then
a logical shard on that device, the counterpart of the reference's eight
virtual CPU devices.
"""

from __future__ import annotations

import collections
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """An array of mesh positions with named axes.

    ``devices`` is the object array of each position's ``torch.device``
    (for a position of another process only its device type is known),
    ``process_indices`` the int array of each position's process, both
    of the mesh's shape. ``shape`` is the reference's ordered
    ``{axis name: size}``; ``size`` the number of positions."""

    def __init__(self, devices: np.ndarray, process_indices: np.ndarray,
                 axis_names: Sequence[str], process_index: int = 0):
        self.devices = np.asarray(devices, dtype=object)
        self.process_indices = np.asarray(process_indices, dtype=np.int64)
        if self.devices.shape != self.process_indices.shape:
            raise ValueError("devices and process indices differ in shape")
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-d mesh")
        #: the process this mesh object lives in
        self.process_index = int(process_index)

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def process_count(self) -> int:
        """Distinct processes holding positions of this mesh."""
        return len(set(self.process_indices.flat))

    @property
    def spans_processes(self) -> bool:
        return self.process_count > 1

    def local_positions(self) -> range:
        """The contiguous run of flat positions this process owns.
        Raises when this process's positions interleave with another's
        (every multi-process data layout needs them contiguous)."""
        mine = np.flatnonzero(self.process_indices.reshape(-1)
                              == self.process_index)
        if not len(mine):
            return range(0)
        lo, hi = int(mine[0]), int(mine[-1]) + 1
        if hi - lo != len(mine):
            raise ValueError(
                f"mesh interleaves processes (process "
                f"{self.process_index} owns positions {mine.tolist()}); "
                "multi-process layouts need process-contiguous positions")
        return range(lo, hi)

    def axis_index(self, position: int, axis: str) -> int:
        """The flat ``position``'s index along ``axis``."""
        coords = np.unravel_index(int(position), self.devices.shape)
        return int(coords[self.axis_names.index(axis)])

    def local_devices(self) -> list:
        """Each local position's device, in position order."""
        flat = self.devices.reshape(-1)
        return [flat[p] for p in self.local_positions()]

    def __repr__(self) -> str:
        return (f"Mesh(shape={dict(self.shape)}, processes="
                f"{self.process_count}, local={list(self.local_positions())})")


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Optional[Sequence[str]] = None,
              devices=None, device=None) -> Mesh:
    """Build a :class:`Mesh`.

    ``devices=None``: one position per process of the group (one
    position without a group), this process's on ``device`` (resolved by
    ``utils/device``: ``cuda`` unless the caller asks for the CPU).
    ``devices`` given: every position belongs to this process, a device
    may repeat. ``shape=None`` -> 1-D ``("data",)`` over every position;
    a shape needing more positions than there are raises the reference's
    ``ValueError``."""
    from predictionio_tpu_torch.parallel.distributed import group_rank_size
    from predictionio_tpu_torch.utils.device import resolve_device

    rank, world = group_rank_size()
    if devices is None:
        own = resolve_device(device)
        devs = [own if p == rank else torch.device(own.type)
                for p in range(world)]
        procs = list(range(world))
    else:
        devs = [torch.device(d) for d in devices]
        procs = [rank] * len(devs)
    if shape is None:
        shape = (len(devs),)
        axis_names = axis_names or (DATA_AXIS,)
    else:
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names) if axis_names else tuple(
            f"axis{i}" for i in range(len(shape)))
    n = int(np.prod(shape))
    if n > len(devs):
        raise ValueError(f"mesh shape {shape} needs {n} devices, "
                         f"only {len(devs)} available")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(shape),
                np.asarray(procs[:n], np.int64).reshape(shape),
                axis_names, process_index=rank)


def mesh_shape_from_conf(conf: dict) -> Tuple[Optional[list], Optional[list]]:
    """Parse runtime_conf {"mesh_shape": "4,2", "mesh_axes": "data,model"}."""
    shape = conf.get("mesh_shape")
    if isinstance(shape, str):
        shape = [int(x) for x in shape.split(",") if x]
    axes = conf.get("mesh_axes")
    if isinstance(axes, str):
        axes = [x for x in axes.split(",") if x]
    return shape, axes

