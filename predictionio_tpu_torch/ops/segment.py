"""Chunked segment reductions for normal-equation assembly (port of the
reference's ``ops/segment.py``).

For every segment (user or item) they accumulate the Gramian
``sum_j w_j f_j f_j^T`` and right-hand side ``sum_j v_j f_j`` over that
segment's ratings. Ratings come packed into padded per-segment rows (the
ALX layout built on the host in ``models/als.py``), so each chunk's
Gramians are one batched matmul (``torch.bmm``); rows are processed in
fixed-size chunks so buffers stay bounded at any dataset size, and the
per-segment combine is a sorted ``index_add_`` of row partials.

The reference leaves these to XLA (``lax.scan``, ``einsum``, sorted
scatter-add); plain torch ops are their port. On CUDA ``index_add_``
adds with atomics, so sums come in another order from run to run.
"""

from __future__ import annotations

from typing import Tuple

import torch


def segment_count(seg_idx: torch.Tensor, weights: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    out = torch.zeros((num_segments,), dtype=weights.dtype,
                      device=weights.device)
    return out.index_add_(0, seg_idx, weights)


def _pad_rows_sorted(row_tgt, row_seg, extra, num_segments, chunk_rows):
    """Pad padded-row inputs to a chunk multiple. Padding rows aim at the
    LAST segment (keeps row_seg sorted) and every ``extra`` array is
    padded with zeros (weight-0 rows contribute nothing). Returns the
    padded (row_tgt, row_seg, extra) plus the chunk count and size."""
    r, l = row_tgt.shape
    chunk = min(chunk_rows, max(r, 1))
    num_chunks = max(1, (r + chunk - 1) // chunk)
    padded = num_chunks * chunk
    if padded != r:
        pad = padded - r
        row_tgt = torch.cat([row_tgt, row_tgt.new_zeros((pad, l))])
        row_seg = torch.cat(
            [row_seg, row_seg.new_full((pad,), num_segments - 1)])
        extra = tuple(torch.cat([a, a.new_zeros((pad, l))]) for a in extra)
    return row_tgt, row_seg, extra, num_chunks, chunk


def _chunks(num_chunks: int, chunk: int):
    for c in range(num_chunks):
        yield slice(c * chunk, (c + 1) * chunk)


def rows_gram_rhs(factors: torch.Tensor, row_tgt: torch.Tensor,
                  row_seg: torch.Tensor, row_val: torch.Tensor,
                  row_w: torch.Tensor, num_segments: int,
                  chunk_rows: int = 8192
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Padded-row Gramian assembly: ``factors [F, K]`` indexed by
    ``row_tgt [R, L]``; ``row_seg [R]`` (sorted) names each row's
    segment; ``row_val``/``row_w [R, L]`` are rating values and weights
    (0 = padding). Returns ``(gram [S, K, K], rhs [S, K], count [S])``."""
    k = factors.shape[-1]
    row_tgt, row_seg, (row_val, row_w), num_chunks, chunk = \
        _pad_rows_sorted(row_tgt, row_seg, (row_val, row_w),
                         num_segments, chunk_rows)
    gram = factors.new_zeros((num_segments, k, k))
    rhs = factors.new_zeros((num_segments, k))
    count = factors.new_zeros((num_segments,))
    for sl in _chunks(num_chunks, chunk):
        seg, w = row_seg[sl], row_w[sl]
        f = factors[row_tgt[sl]]                           # [C, L, K]
        fw_t = (f * w[..., None]).transpose(1, 2)          # [C, K, L]
        gram.index_add_(0, seg, torch.bmm(fw_t, f))
        rhs.index_add_(0, seg, torch.bmm(fw_t, row_val[sl, :, None])[..., 0])
        count.index_add_(0, seg, w.sum(dim=1))
    return gram, rhs, count


def row_predict_add(factors: torch.Tensor, x_rows: torch.Tensor,
                    row_tgt: torch.Tensor, row_seg: torch.Tensor,
                    row_pred: torch.Tensor,
                    chunk_rows: int = 8192) -> torch.Tensor:
    """``row_pred + <x_rows[seg], factors[tgt]>`` per rating slot.

    With the full factor matrices it initializes each rating's
    prediction; with one block's columns and the block's delta it folds
    one block update of the subspace solver into the running
    prediction."""
    r, l = row_tgt.shape
    row_tgt, row_seg, _, num_chunks, chunk = _pad_rows_sorted(
        row_tgt, row_seg, (), x_rows.shape[0], chunk_rows)
    parts = []
    for sl in _chunks(num_chunks, chunk):
        f = factors[row_tgt[sl]]                           # [C, L, B]
        parts.append(torch.bmm(f, x_rows[row_seg[sl], :, None])[..., 0])
    return row_pred + torch.cat(parts)[:r]


def block_gram_rhs(factors_b: torch.Tensor, x_b: torch.Tensor,
                   row_tgt: torch.Tensor, row_seg: torch.Tensor,
                   row_pred: torch.Tensor, rhs_val: torch.Tensor,
                   gram_w: torch.Tensor, num_segments: int,
                   chunk_rows: int = 8192
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment b x b normal equations of one rank block (iALS++):

        (sum_j gram_w_j f_j f_j^T) y =
            sum_j (rhs_val_j - gram_w_j * (pred_j - <f_j, x_b>)) f_j

    with ``factors_b [F, b]`` the block's opposite-side columns, ``x_b
    [S, b]`` this side's current block and ``row_pred`` the full current
    prediction per rating. The caller adds the regularization (and, for
    implicit feedback, the global Gramian term). Returns ``(gram [S, b,
    b], rhs [S, b])``."""
    b = factors_b.shape[-1]
    row_tgt, row_seg, (row_pred, rhs_val, gram_w), num_chunks, chunk = \
        _pad_rows_sorted(row_tgt, row_seg, (row_pred, rhs_val, gram_w),
                         num_segments, chunk_rows)
    gram = factors_b.new_zeros((num_segments, b, b))
    rhs = factors_b.new_zeros((num_segments, b))
    for sl in _chunks(num_chunks, chunk):
        seg, w = row_seg[sl], gram_w[sl]
        f = factors_b[row_tgt[sl]]                         # [C, L, b]
        pred_b = torch.bmm(f, x_b[seg, :, None])[..., 0]   # block's own part
        f_t = f.transpose(1, 2)
        gram.index_add_(0, seg, torch.bmm(f_t * w[:, None, :], f))
        resid = rhs_val[sl] - w * (row_pred[sl] - pred_b)
        rhs.index_add_(0, seg, torch.bmm(f_t, resid[..., None])[..., 0])
    return gram, rhs
