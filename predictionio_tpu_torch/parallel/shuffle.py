"""Cross-process row exchange (port of the reference's
``parallel/shuffle.py``).

Each process bins its locally read rows by destination process, and one
``torch.distributed.all_to_all_single`` over the process group moves
every bin to its owner. Combined with the storage shard readers
(``find_columns(shard=...)``) this is the partitioned input pipeline: no
process ever holds the full event set. Host-object collectives
(:func:`allgather_object`) carry the small metadata the exchange needs
(vocabularies, row counts, digests).

Without a process group (or with a group of one) every function is the
single-process identity.
"""

from __future__ import annotations

from typing import List

import numpy as np


def _group():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist
    return None


def allgather_object(obj) -> List:
    """Every process contributes one picklable object; all receive the
    list ordered by process index."""
    dist = _group()
    if dist is None:
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def global_vocab(local_values: np.ndarray) -> np.ndarray:
    """Sorted union of every process's local distinct values: the same
    global id assignment on every process, whichever shard saw which
    entity."""
    locals_ = allgather_object(np.unique(local_values))
    return np.unique(np.concatenate(locals_))


def exchange_rows(dest: np.ndarray, payload: np.ndarray) -> np.ndarray:
    """Redistribute host rows across processes by destination.

    dest: [n] destination process per row. payload: [n, k] int32 (view
    other 4-byte dtypes through ``.view(np.int32)``). Returns the [m, k]
    rows destined to THIS process, grouped by source process and keeping
    each source's local order within its group. One metadata all-gather
    of the per-destination counts, then one ``all_to_all_single`` of the
    rows as host int32 (no padding: the counts are the split sizes).
    Single-process: a stable reorder by destination."""
    import torch

    payload = np.ascontiguousarray(payload, np.int32)
    n, k = payload.shape
    dist = _group()
    nproc = 1 if dist is None else dist.get_world_size()
    dest = np.asarray(dest)
    order = np.argsort(dest, kind="stable")
    payload_s = payload[order]
    starts = np.searchsorted(dest[order], np.arange(nproc + 1))
    if dist is None:
        return payload_s
    me = dist.get_rank()
    counts = np.diff(starts).astype(np.int64)          # rows per dest
    all_counts = np.stack(allgather_object(counts))    # [P src, P dst]
    recv_counts = all_counts[:, me]
    out = torch.empty((int(recv_counts.sum()) * k,), dtype=torch.int32)
    dist.all_to_all_single(
        out, torch.from_numpy(payload_s.reshape(-1)),
        output_split_sizes=[int(c) * k for c in recv_counts],
        input_split_sizes=[int(c) * k for c in counts])
    return out.numpy().reshape(-1, k)
