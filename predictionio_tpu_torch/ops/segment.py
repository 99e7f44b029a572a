"""Chunked segment reductions for normal-equation assembly (port of the
reference's ``ops/segment.py``).

For every segment (user or item) they accumulate the Gramian
``sum_j w_j f_j f_j^T`` and right-hand side ``sum_j v_j f_j`` over that
segment's ratings. Ratings come packed into padded per-segment rows (the
ALX layout built on the host in ``models/als.py``), so each chunk's
Gramians are one batched matmul; rows are processed in fixed-size chunks
so buffers stay bounded at any dataset size (the last chunk may be
shorter: padding rows add nothing), and the per-segment combine is a
sorted ``index_add_`` of row partials.

Every op takes a leading axis of ``b`` independent problems over one
shared row layout: factors ``[b, F, K]`` and per-unit weights ``[b, R,
L]`` give ``[b, S, K, K]`` Gramians in one pass over the rows. A train
is ``b = 1``; the evaluation sweep's (candidate, fold) units are ``b >
1``, the counterpart of the reference's ``vmap`` over these ops. Each
unit's partials land in its own block of a flat ``[b * S]`` segment
axis, so the combine is one ``index_add_`` whatever ``b`` is.

The reference leaves these to XLA (``lax.scan``, ``einsum``, sorted
scatter-add); plain torch ops are their port. On CUDA ``index_add_``
adds with atomics, so sums come in another order from run to run.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _chunks(n_rows: int, chunk_rows: int):
    """Row slices of at most ``chunk_rows``; one (empty) slice when there
    are no rows, so every op returns its zeros."""
    step = max(1, chunk_rows)
    for lo in range(0, max(n_rows, 1), step):
        yield slice(lo, lo + step)


def _unit_segments(seg: torch.Tensor, b: int,
                   num_segments: int) -> torch.Tensor:
    """``[b * C]``: each unit's copy of the chunk's segment ids, offset
    into that unit's block of the flat segment axis (still sorted)."""
    if b == 1:
        return seg
    off = torch.arange(b, device=seg.device, dtype=seg.dtype)
    return (seg[None] + num_segments * off[:, None]).reshape(-1)


def segment_count(seg_idx: torch.Tensor, weights: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """``weights [b, R]`` summed per segment of ``seg_idx [R]``:
    ``[b, S]``."""
    out = weights.new_zeros((weights.shape[0], num_segments))
    return out.index_add_(1, seg_idx, weights)


def rows_gram_rhs(factors: torch.Tensor, row_tgt: torch.Tensor,
                  row_seg: torch.Tensor, row_val: torch.Tensor,
                  row_w: torch.Tensor, num_segments: int,
                  chunk_rows: int = 8192
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Padded-row Gramian assembly: ``factors [b, F, K]`` indexed by
    ``row_tgt [R, L]``; ``row_seg [R]`` (sorted) names each row's
    segment; ``row_val [b or 1, R, L]`` are rating values and ``row_w
    [b, R, L]`` weights (0 = padding). Returns ``(gram [b, S, K, K], rhs
    [b, S, K], count [b, S])``."""
    b, _, k = factors.shape
    gram = factors.new_zeros((b * num_segments, k, k))
    rhs = factors.new_zeros((b * num_segments, k))
    count = factors.new_zeros((b * num_segments,))
    for sl in _chunks(row_tgt.shape[0], chunk_rows):
        seg, w = _unit_segments(row_seg[sl], b, num_segments), row_w[:, sl]
        f = factors[:, row_tgt[sl]]                        # [b, C, L, K]
        fw_t = (f * w[..., None]).transpose(-1, -2)        # [b, C, K, L]
        gram.index_add_(0, seg, torch.matmul(fw_t, f).flatten(0, 1))
        rhs.index_add_(0, seg, torch.matmul(
            fw_t, row_val[:, sl, :, None]).flatten(0, 1)[..., 0])
        count.index_add_(0, seg, w.sum(dim=-1).flatten())
    return (gram.view(b, num_segments, k, k), rhs.view(b, num_segments, k),
            count.view(b, num_segments))


def row_predict_add(factors: torch.Tensor, x_rows: torch.Tensor,
                    row_tgt: torch.Tensor, row_seg: torch.Tensor,
                    row_pred: torch.Tensor,
                    chunk_rows: int = 8192) -> torch.Tensor:
    """``row_pred + <x_rows[seg], factors[tgt]>`` per unit and rating
    slot: ``factors [b, F, B]``, ``x_rows [b, S, B]``, ``row_pred [b, R,
    L]``.

    With the full factor matrices it initializes each rating's
    prediction; with one block's columns and the block's delta it folds
    one block update of the subspace solver into the running
    prediction."""
    parts = []
    for sl in _chunks(row_tgt.shape[0], chunk_rows):
        f = factors[:, row_tgt[sl]]                        # [b, C, L, B]
        parts.append(torch.matmul(
            f, x_rows[:, row_seg[sl], :, None])[..., 0])
    return row_pred + torch.cat(parts, dim=1)


def block_gram_rhs(factors_b: torch.Tensor, x_b: torch.Tensor,
                   row_tgt: torch.Tensor, row_seg: torch.Tensor,
                   row_pred: torch.Tensor, rhs_val: torch.Tensor,
                   gram_w: torch.Tensor, num_segments: int,
                   chunk_rows: int = 8192
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment B x B normal equations of one rank block (iALS++):

        (sum_j gram_w_j f_j f_j^T) y =
            sum_j (rhs_val_j - gram_w_j * (pred_j - <f_j, x_b>)) f_j

    with ``factors_b [b, F, B]`` the block's opposite-side columns,
    ``x_b [b, S, B]`` this side's current block and ``row_pred [b, R,
    L]`` the full current prediction per rating (``rhs_val`` and
    ``gram_w`` are ``[b, R, L]`` too). The caller adds the
    regularization (and, for implicit feedback, the global Gramian
    term). Returns ``(gram [b, S, B, B], rhs [b, S, B])``."""
    b, _, bs = factors_b.shape
    gram = factors_b.new_zeros((b * num_segments, bs, bs))
    rhs = factors_b.new_zeros((b * num_segments, bs))
    for sl in _chunks(row_tgt.shape[0], chunk_rows):
        seg, w = row_seg[sl], gram_w[:, sl]
        f = factors_b[:, row_tgt[sl]]                      # [b, C, L, B]
        pred_b = torch.matmul(f, x_b[:, seg, :, None])[..., 0]
        f_t = f.transpose(-1, -2)
        useg = _unit_segments(seg, b, num_segments)
        gram.index_add_(0, useg, torch.matmul(
            f_t * w[..., None, :], f).flatten(0, 1))
        resid = rhs_val[:, sl] - w * (row_pred[:, sl] - pred_b)
        rhs.index_add_(0, useg, torch.matmul(
            f_t, resid[..., None]).flatten(0, 1)[..., 0])
    return gram.view(b, num_segments, bs, bs), rhs.view(b, num_segments, bs)
