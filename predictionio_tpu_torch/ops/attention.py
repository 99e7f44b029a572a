"""Single-device attention on ``[batch, seq, heads, head_dim]`` tensors
(port of the one-device part of the reference's ``ops/attention.py``).

* :func:`mha` — dense multi-head attention, the numerical ground truth.
* :func:`blockwise_attention` — flash-style: K/V streamed in blocks of
  ``block_k`` with the running-max / denominator recurrence, so the
  ``[Lq, Lk]`` score matrix never materializes whole. Exact.

The masked softmax is written out as the reference writes it (no
``scaled_dot_product_attention``): masked scores take the finite
``NEG_INF``, and a query row whose every key is masked (a pad position
of a left-padded session) outputs 0 — ``mha`` multiplies by ``max >
NEG_INF / 2`` and ``_flash_finish`` divides by 1 where the denominator
is 0. Scores and the recurrence stay in float32 whatever the input
dtype. The reference's ring and Ulysses attention need a device mesh
and are not ported (ROADMAP item A12, part 2).
"""

from __future__ import annotations

from typing import Optional

import torch

#: large-negative instead of -inf: avoids NaN in exp(m - m)
NEG_INF = -1e30


def _causal_mask(scores: torch.Tensor, q_off: int, k_off: int
                 ) -> torch.Tensor:
    """Mask scores ``[..., Lq, Lk]`` so query i attends to keys j with
    ``k_off + j <= q_off + i``."""
    lq, lk = scores.shape[-2], scores.shape[-1]
    qi = q_off + torch.arange(lq, device=scores.device)[:, None]
    kj = k_off + torch.arange(lk, device=scores.device)[None, :]
    return torch.where(kj <= qi, scores, NEG_INF)


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """``[B, H, Lq, Lk]`` float32 scores of ``[B, L, H, D]`` q and k."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        causal: bool = False,
        key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense multi-head attention, ``[B, L, H, D]`` -> ``[B, L, H, D]``.
    ``key_mask``: optional ``[B, Lk]`` bool, False = key is padding."""
    s = _scores(q, k, q.shape[-1] ** -0.5)
    if causal:
        s = _causal_mask(s, 0, 0)
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # fully-masked query rows (pad queries) output 0, not the mean of V
    p = p * (s.amax(dim=-1, keepdim=True) > NEG_INF / 2)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _flash_step(q, k_j, v_j, o, m, l, q_off: int, k_off: int,
                causal: bool, scale: float, key_mask_j=None):
    """Fold the K/V block ``(k_j, v_j)`` at key offset ``k_off`` into the
    running ``(o [B, H, Lq, D], m [B, H, Lq], l [B, H, Lq])`` of the
    queries ``q`` at offset ``q_off``."""
    s = _scores(q, k_j, scale)
    if causal:
        s = _causal_mask(s, q_off, k_off)
    if key_mask_j is not None:
        s = torch.where(key_mask_j[:, None, None, :], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    # an explicit zero for masked scores: with the finite NEG_INF,
    # exp(s - m_new) would be 1 (not 0) in an all-masked row
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m_new[..., None]), 0.0)
    l = l * alpha + p.sum(dim=-1)
    o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                            v_j.float())
    return o, m_new, l


def _flash_finish(o: torch.Tensor, l: torch.Tensor, dtype) -> torch.Tensor:
    out = o / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.permute(0, 2, 1, 3).to(dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_k: int = 512, causal: bool = False,
                        key_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Flash-style single-device attention over K/V blocks of
    ``block_k`` keys; ``key_mask`` as in :func:`mha`. A key length that
    is not a ``block_k`` multiple is padded up to one with masked zero
    keys."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    block_k = min(block_k, lk)
    pad = -lk % block_k
    if key_mask is None:
        key_mask = torch.ones((b, lk), dtype=torch.bool, device=q.device)
    if pad:
        zeros = torch.zeros((b, pad, h, d), dtype=k.dtype, device=k.device)
        k = torch.cat([k, zeros], dim=1)
        v = torch.cat([v, zeros.to(v.dtype)], dim=1)
        key_mask = torch.cat([key_mask, torch.zeros(
            (b, pad), dtype=torch.bool, device=key_mask.device)], dim=1)
    scale = d ** -0.5
    o = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, lq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    for lo in range(0, lk + pad, block_k):
        o, m, l = _flash_step(q, k[:, lo:lo + block_k], v[:, lo:lo + block_k],
                              o, m, l, 0, lo, causal, scale,
                              key_mask_j=key_mask[:, lo:lo + block_k])
    return _flash_finish(o, l, q.dtype)
