"""Host-side top-k + the k-way shortlist merge (copy of the reference's
``ops/topk.py``).

The host counterpart of the device top-k for the dispatch-latency-aware
serving path (models/als.py): when a model is small enough that one
device round-trip costs more than the whole scoring matmul, the top-k
runs on host BLAS output instead.

`merge_topk` is the one tested implementation of "several per-source
top-k shortlists -> one global top-k": the exact-rescore tail of the fused/two-stage scorers routes here (as will
the model-parallel scorer of a later slice) instead of re-deriving the
sort-and-slice. Ties break deterministically (score descending, then
item id ascending), so a merged result never depends on shard order or
argpartition internals.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def host_topk(scores: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row descending top-k: [B, N] -> (values [B, k], idx [B, k]).

    k is clamped to N. argpartition against the (n-k)th element + a
    descending sort of the k-suffix — the O(N + k log k) idiom numpy
    lacks a primitive for, WITHOUT materializing a negated [B, N] copy:
    when k << N the only full-width pass is the partition itself, and
    the negation (numpy sorts ascending) touches just the [B, k] slice.
    """
    n = scores.shape[1]
    k = min(k, n)
    if k <= 0:
        empty = np.zeros((scores.shape[0], 0))
        return empty.astype(scores.dtype), empty.astype(np.int64)
    if k >= n:
        idx = np.argsort(-scores, axis=1)
    else:
        part = np.argpartition(scores, n - k, axis=1)[:, n - k:]
        order = np.argsort(-np.take_along_axis(scores, part, axis=1),
                           axis=1)
        idx = np.take_along_axis(part, order, axis=1)
    return np.take_along_axis(scores, idx, axis=1), idx


def merge_topk(shortlists: Sequence[Tuple[np.ndarray, np.ndarray]],
               k: int) -> Tuple[np.ndarray, np.ndarray]:
    """K-way merge of per-source top-k shortlists into one global top-k.

    ``shortlists`` is a sequence of ``(values [B, k_i], ids [B, k_i])``
    pairs — ragged widths are fine (a small shard legitimately emits a
    narrower shortlist than its siblings), but every pair must agree on
    ``B``. Returns ``(values [B, k], ids [B, k])`` sorted score
    descending with ties broken by ascending id — deterministic, so the
    merged result is independent of shard order and of whatever
    tie-order the per-source top-k used. Non-finite values and negative
    ids mark invalid candidates (mask sentinels, padding): they sort
    last, and rows with fewer than ``k`` valid candidates pad out with
    ``(-inf, -1)``. ``k <= 0`` (and an all-empty input) returns empty
    ``[B, 0]`` arrays.
    """
    if not shortlists:
        raise ValueError("merge_topk needs at least one shortlist")
    b = shortlists[0][0].shape[0]
    for vals, ids in shortlists:
        if vals.shape != ids.shape or vals.ndim != 2:
            raise ValueError(
                f"shortlist shapes must match and be 2-D, got values "
                f"{vals.shape} ids {ids.shape}")
        if vals.shape[0] != b:
            raise ValueError(
                f"ragged batch: shortlist rows {vals.shape[0]} != {b}")
    vals = np.concatenate([np.asarray(v, np.float32)
                           for v, _ in shortlists], axis=1)
    ids = np.concatenate([np.asarray(i, np.int64)
                          for _, i in shortlists], axis=1)
    if k <= 0 or vals.shape[1] == 0:
        empty = np.zeros((b, 0))
        return empty.astype(np.float32), empty.astype(np.int64)
    # invalid candidates (NaN scores, sentinel ids) become (-inf, -1) so
    # one rule sorts them last AND makes the short-row padding visible
    valid = np.isfinite(vals) & (ids >= 0)
    vals = np.where(valid, vals, -np.inf)
    ids = np.where(valid, ids, np.int64(-1))
    # -inf maps to +inf under negation, so invalids sort last; id is the
    # secondary key, except invalids where id -1 would wrongly win ties
    # against valid candidates — lift them to the max id instead
    tie_ids = np.where(valid, ids, np.iinfo(np.int64).max)
    order = np.lexsort((tie_ids, -vals), axis=1)[:, :k]
    out_v = np.take_along_axis(vals, order, axis=1)
    out_i = np.take_along_axis(ids, order, axis=1)
    if out_v.shape[1] < k:
        pad = k - out_v.shape[1]
        out_v = np.concatenate(
            [out_v, np.full((b, pad), -np.inf, out_v.dtype)], axis=1)
        out_i = np.concatenate(
            [out_i, np.full((b, pad), -1, out_i.dtype)], axis=1)
    return out_v, out_i
