"""Item cooccurrence counting for similar-product recommendation, on one
device (port of the reference's ``models/cooccurrence.py``): distinct
(user, item) pairs -> per-item-pair counts -> the top-N per item
(CooccurrenceAlgorithm.scala:71-105, a Spark self-join there).

Counting cooccurrences is C = A^T A for the binary user x item
incidence matrix A. On the card (the reference's ``_sharded_topn_fn``
with one shard):

* A is scattered on the host as uint8, item-major (A^T, each item's
  users contiguous), and uploaded once; on the card it is read as int8
  (0/1), so it is never widened to a second copy;
* C's rows are computed in slabs of ``KERNEL_SLAB`` rows, C[slab, :] =
  A^T[slab] (A^T)^T, through PyTorch's int8 matrix product into int32
  (exact; the reference multiplies bf16 with f32 accumulation, exact
  below 2^24). Both operands keep the user axis (the product's depth)
  contiguous, the layout the int8 tensor-core product takes, and a slab
  is a row range of A^T, so nothing is copied. Each slab is reduced to
  its per-row top-N at once, so the [n_items, n_items] count matrix
  never exists on the card;
* the diagonal is zeroed, and ties keep the lower item id first (the
  order of ``lax.top_k``), through one int64 key per entry, ``count <<
  32 | (2^31 - 1 - column)``.

On the CPU the reference's single-device fallback runs: numpy ``a.T @
a`` and ``host_topk``. Shapes past the budget fall back to host pair
enumeration. The reference's multi-process cooccurrence and its
device-resident A across calls are not ported.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.data.bimap import vocab_index
from predictionio_tpu_torch.ops.topk import host_topk
from predictionio_tpu_torch.utils.device import resolve_device, synchronize
from predictionio_tpu_torch.utils.profiling import phase

#: max dense entries of the CPU path before host pair counting: it
#: holds A (f32) and the full [n_items, n_items] count matrix
DENSE_BUDGET = 500_000_000
#: the card's byte budget for the slabbed product (the reference's
#: per-chip HBM budget)
DEVICE_HBM_BUDGET = 12_000_000_000
#: the slab height (rows of the count block materialized at once)
KERNEL_SLAB = 512
#: the item axis pads to a multiple of this per shard (the reference's
#: 128 lanes)
ITEM_ALIGN = 128
#: the user axis pads to a multiple of this (the depth of PyTorch's int8
#: product must be)
USER_ALIGN = 8
#: the key's low word: 2^31 - 1 - column ranks a lower column higher
_COL_KEY = (1 << 31) - 1


def distinct_pairs(user_idx: np.ndarray, item_idx: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """De-duplicate (user, item) events (the reference's .distinct())."""
    combined = user_idx.astype(np.int64) * (
        item_idx.max() + 1 if item_idx.size else 1) \
        + item_idx.astype(np.int64)
    _, keep = np.unique(combined, return_index=True)
    return user_idx[keep], item_idx[keep]


def slab_geometry(n_users: int, n_items: int) -> Tuple[int, int, int]:
    """``(nu_pad, ni_pad, slab)`` of the card path. The reference's
    rule: pad the items to 128 per shard, and keep the whole block in
    one slab while its f32 count block is at most 256 MB, else slabs of
    ``KERNEL_SLAB`` rows."""
    n_shards = 1        # the first mesh axis: one card
    blk = -(-n_items // (ITEM_ALIGN * n_shards)) * ITEM_ALIGN
    ni_pad = blk * n_shards
    nu_pad = -(-max(n_users, 1) // USER_ALIGN) * USER_ALIGN
    slab = blk if blk * ni_pad * 4 <= (1 << 28) else min(KERNEL_SLAB, blk)
    return nu_pad, ni_pad, slab


def device_bytes(n_users: int, n_items: int) -> int:
    """Bytes the card path holds at once: A^T (one byte an entry, one
    shard) and one slab's int32 counts and int64 keys."""
    nu_pad, ni_pad, slab = slab_geometry(n_users, n_items)
    return nu_pad * ni_pad + slab * ni_pad * (4 + 8)


def fits_dense(n_users: int, n_items: int, device: torch.device) -> bool:
    """The budget gate: on the card the slabbed product's bytes against
    ``DEVICE_HBM_BUDGET``; on the CPU, A and the full count matrix
    against ``DENSE_BUDGET`` (the n_items^2 term stays: the CPU path
    materializes it)."""
    if device.type == "cuda":
        return device_bytes(n_users, n_items) <= DEVICE_HBM_BUDGET
    _, ni_pad, _ = slab_geometry(n_users, n_items)
    return max(n_users * ni_pad, n_items * n_items) <= DENSE_BUDGET


def incidence(user_idx: np.ndarray, item_idx: np.ndarray, n_users: int,
              n_items: int) -> np.ndarray:
    """The uint8 incidence matrix of distinct pairs, item-major: A^T
    ``[ni_pad, nu_pad]``; padding rows and columns are zero and count
    nothing."""
    nu_pad, ni_pad, _ = slab_geometry(n_users, n_items)
    at = np.zeros((ni_pad, nu_pad), np.uint8)
    at[item_idx, user_idx] = 1
    return at


def topn_slabs(at: torch.Tensor, n_items: int, k: int, slab: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-``k`` of C = A^T A with a zero diagonal, slab by
    slab, on ``at``'s device: ``at`` = A^T, int8 ``[ni_pad, nu_pad]`` ->
    ``(counts int32 [n_items, k], ids int64 [n_items, k])``, counts
    descending, equal counts by ascending id."""
    ni_pad = at.shape[0]
    cols = torch.arange(ni_pad, device=at.device, dtype=torch.int64)
    low = _COL_KEY - cols
    vals, ids = [], []
    for lo in range(0, ni_pad, slab):
        hi = min(lo + slab, ni_pad)
        c = torch._int_mm(at[lo:hi], at.t())
        rows = torch.arange(hi - lo, device=at.device)
        c[rows, rows + lo] = 0                      # zero diagonal
        key = torch.topk((c.to(torch.int64) << 32) | low, k, dim=1).values
        del c
        vals.append((key >> 32).to(torch.int32))
        ids.append(_COL_KEY - (key & 0xFFFFFFFF))
    return torch.cat(vals)[:n_items], torch.cat(ids)[:n_items]


def cooccurrence_topn_slabs(user_idx: np.ndarray, item_idx: np.ndarray,
                            n_users: int, n_items: int, n_top: int,
                            device=None, stats: Optional[dict] = None
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-N cooccurrence of distinct pairs by the slabbed product on
    ``device`` (the card path; on CPU tensors the same code):
    ``(counts [n_items, k], ids [n_items, k])`` with k = min(n_top,
    n_items), rows with fewer than k cooccurrents padded with count 0.
    ``stats``, when given, receives the split: host incidence build,
    upload, the count and top-N (device ms by CUDA events on the card),
    the slab count and the bytes the path holds."""
    dev = resolve_device(device)
    k = int(min(n_top, n_items))
    _, _, slab = slab_geometry(n_users, n_items)
    t0 = time.perf_counter()
    # the reference's phases (``pio_phase_duration_seconds`` of a run)
    with phase("incidence_build"):
        at_host = incidence(user_idx, item_idx, n_users, n_items)
    t1 = time.perf_counter()
    with phase("incidence_transfer"):
        at = torch.from_numpy(at_host).to(dev).view(torch.int8)
        synchronize(dev)
    t2 = time.perf_counter()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    vals, ids = topn_slabs(at, n_items, k, slab)
    if dev.type == "cuda":
        end.record()
    vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
    t3 = time.perf_counter()
    if stats is not None:
        stats.update(
            path="slabs", device=str(dev), dtype="int8 -> int32",
            incidence_build_s=t1 - t0, upload_s=t2 - t1,
            count_topn_s=t3 - t2,
            count_topn_device_ms=(start.elapsed_time(end)
                                  if dev.type == "cuda" else None),
            slabs=-(-at.shape[0] // slab), slab=slab,
            shape=[int(at.shape[1]), int(at.shape[0])],
            device_bytes=device_bytes(n_users, n_items))
    return vals, ids


def cooccurrence_topn(user_idx: np.ndarray, item_idx: np.ndarray,
                      n_users: int, n_items: int, n_top: int,
                      device=None, stats: Optional[dict] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-N cooccurrence of distinct pairs on ``device`` (default
    ``cuda``): the slabbed product on the card, the reference's
    single-device fallback on the CPU (numpy ``a.T @ a``, then
    ``host_topk``, whose ties follow ``argpartition``)."""
    dev = resolve_device(device)
    if dev.type != "cpu":
        return cooccurrence_topn_slabs(user_idx, item_idx, n_users,
                                       n_items, n_top, dev, stats)
    t0 = time.perf_counter()
    a = np.zeros((n_users, n_items), np.float32)
    a[user_idx, item_idx] = 1.0
    c = a.T @ a
    np.fill_diagonal(c, 0.0)
    vals, ids = host_topk(c, int(min(n_top, n_items)))
    if stats is not None:
        stats.update(path="host_dense", device="cpu",
                     count_topn_s=time.perf_counter() - t0)
    return vals, ids


def cooccurrence_topn_host(user_idx: np.ndarray, item_idx: np.ndarray,
                           n_items: int, n: int
                           ) -> Dict[int, List[Tuple[int, int]]]:
    """Host fallback past the budget: enumerate each user's item pairs,
    count, keep the top-N (the reference's, a Python loop)."""
    order = np.argsort(user_idx, kind="stable")
    u_s, i_s = user_idx[order], item_idx[order]
    pairs: Dict[Tuple[int, int], int] = {}
    start = 0
    while start < len(u_s):
        end = start
        while end < len(u_s) and u_s[end] == u_s[start]:
            end += 1
        items = np.sort(i_s[start:end])
        if len(items) > 1:
            i1, i2 = np.triu_indices(len(items), k=1)
            for a, b in zip(items[i1], items[i2]):
                if a != b:
                    pairs[(int(a), int(b))] = pairs.get((int(a), int(b)),
                                                        0) + 1
        start = end
    top: Dict[int, List[Tuple[int, int]]] = {}
    for (a, b), c in pairs.items():
        top.setdefault(a, []).append((b, c))
        top.setdefault(b, []).append((a, c))
    return {k: sorted(v, key=lambda x: -x[1])[:n] for k, v in top.items()}


def train_cooccurrence(user_idx: np.ndarray, item_idx: np.ndarray,
                       n_users: int, n_items: int, n: int, device=None,
                       stats: Optional[dict] = None
                       ) -> Dict[int, List[Tuple[int, int]]]:
    """Top-N cooccurring ``(item, count)`` per item (trainCooccurrence
    parity) on ``device`` (default ``cuda``): the counted path when the
    budget gate (:func:`fits_dense`) passes, else host pair
    enumeration (``stats["path"]`` says which ran)."""
    if len(user_idx) == 0:
        return {}
    dev = resolve_device(device)
    user_idx, item_idx = distinct_pairs(user_idx, item_idx)
    if not fits_dense(n_users, n_items, dev):
        t0 = time.perf_counter()
        top = cooccurrence_topn_host(user_idx, item_idx, n_items, n)
        if stats is not None:
            stats.update(path="host_pairs", device=str(dev),
                         count_topn_s=time.perf_counter() - t0)
        return top
    vals, idx = cooccurrence_topn(user_idx, item_idx, n_users, n_items, n,
                                  dev, stats)
    top: Dict[int, List[Tuple[int, int]]] = {}
    for item in range(n_items):
        cands = [(int(j), int(c)) for j, c in zip(idx[item], vals[item])
                 if c > 0]
        if cands:
            top[item] = cands       # already sorted by count, descending
    return top


@dataclasses.dataclass
class CooccurrenceModel:
    """CooccurrenceModel parity: the top-N lists and the item ids."""

    item_vocab: np.ndarray                      # sorted distinct item ids
    top_cooccurrences: Dict[int, List[Tuple[int, int]]]

    def item_index(self, item_id: str) -> Optional[int]:
        return vocab_index(self.item_vocab, item_id)

    def similar(self, item_ids: List[str], num: int,
                exclude_query: bool = True,
                white_list: Optional[List[str]] = None,
                black_list: Optional[List[str]] = None,
                candidate_filter=None) -> List[Tuple[str, float]]:
        """Combine the query items' top lists (predict parity: counts
        summed per candidate, filtered, sorted descending; equal sums
        keep the order the lists give them). ``candidate_filter(idx)``
        applies an engine's own rules (category matching)."""
        query_idx = {i for i in (self.item_index(x) for x in item_ids)
                     if i is not None}
        white = None
        if white_list is not None:
            white = {i for i in (self.item_index(x) for x in white_list)
                     if i is not None}
        black = set()
        if black_list is not None:
            black = {i for i in (self.item_index(x) for x in black_list)
                     if i is not None}
        counts: Dict[int, int] = {}
        for q in query_idx:
            for cand, c in self.top_cooccurrences.get(q, []):
                counts[cand] = counts.get(cand, 0) + c
        out = []
        for cand, c in sorted(counts.items(), key=lambda x: -x[1]):
            if exclude_query and cand in query_idx:
                continue
            if white is not None and cand not in white:
                continue
            if cand in black:
                continue
            if candidate_filter is not None and not candidate_filter(cand):
                continue
            out.append((str(self.item_vocab[cand]), float(c)))
            if len(out) >= num:
                break
        return out
