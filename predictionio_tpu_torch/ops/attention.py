"""Attention on ``[batch, seq, heads, head_dim]`` tensors (port of the
reference's ``ops/attention.py``).

* :func:`mha` — dense multi-head attention, the numerical ground truth.
* :func:`blockwise_attention` — flash-style: K/V streamed in blocks of
  ``block_k`` with the running-max / denominator recurrence, so the
  ``[Lq, Lk]`` score matrix never materializes whole. Exact.
* :func:`ring_attention` / :func:`ring_attention_traced` — sequence
  parallelism over a mesh axis (``parallel/mesh``): each position holds
  ``L / p`` of the queries, keys and values; the K/V blocks and their
  key mask rotate around the axis's ring (``collectives.ring_pass``)
  while each position folds every block into its queries' output with
  the flash recurrence at the block's global offsets. With a ``"data"``
  axis beside the sequence axis the batch shards over it too (dp x sp:
  each data row runs its own ring). The traced form takes and returns
  each local position's blocks (what seqrec's train calls); the other
  splits whole tensors over the mesh and reassembles the output.
* :func:`ulysses_attention` — all-to-all sequence parallelism (the
  DeepSpeed-Ulysses construction): one ``all_to_all`` swaps the sharded
  dimension from sequence to heads, each position runs :func:`mha` over
  the whole sequence for ``H / p`` heads, and another swaps it back.

The collectives are differentiable (``parallel/collectives``), so a
train's gradients flow back through the ring and the all-to-alls.

The masked softmax is written out as the reference writes it (no
``scaled_dot_product_attention``): masked scores take the finite
``NEG_INF``, and a query row whose every key is masked (a pad position
of a left-padded session) outputs 0 — ``mha`` multiplies by ``max >
NEG_INF / 2`` and ``_flash_finish`` divides by 1 where the denominator
is 0. Scores and the recurrence stay in float32 whatever the input
dtype.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

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


# -- sequence parallelism over a mesh ------------------------------------------

def _batch_axis_of(mesh, seq_axis: str) -> Optional[str]:
    """The mesh axis the BATCH dimension shards over beside the sequence
    axis: ``"data"`` when the mesh has one (dp composes with sp: each
    data row runs its own ring), else none (the batch is whole on every
    position)."""
    return "data" if ("data" in mesh.axis_names
                      and seq_axis != "data") else None


def _check_seq_divisible(seq_len: int, mesh, axis: str) -> None:
    if seq_len % mesh.shape[axis]:
        raise ValueError(
            f"seq len {seq_len} not divisible by mesh axis "
            f"'{axis}' size {mesh.shape[axis]}")


def _block_index(mesh, position: int, shape, spec) -> tuple:
    """The index of ``position``'s block of a tensor of ``shape`` whose
    dimension ``i`` splits evenly over mesh axis ``spec[i]`` (None:
    whole)."""
    idx = []
    for dim, axis in enumerate(spec):
        if axis is None:
            idx.append(slice(None))
        else:
            size = shape[dim] // mesh.shape[axis]
            i = mesh.axis_index(position, axis)
            idx.append(slice(i * size, (i + 1) * size))
    return tuple(idx)


def split_blocks(x: torch.Tensor, mesh, spec) -> List[torch.Tensor]:
    """Each local position's block of the whole tensor ``x`` (on the
    position's device), dimension ``i`` split over mesh axis
    ``spec[i]``."""
    return [x[_block_index(mesh, p, x.shape, spec)].to(dev)
            for p, dev in zip(mesh.local_positions(), mesh.local_devices())]


def assemble_blocks(blocks: Sequence[torch.Tensor], mesh, spec, shape
                    ) -> torch.Tensor:
    """The whole tensor of ``shape`` from every position's block
    (another process's through the group), on the device of this
    process's first block; a block repeated along an axis outside
    ``spec`` is read from its first position. Collective when the mesh
    spans processes."""
    from predictionio_tpu_torch.parallel.collectives import gather_positions

    every = gather_positions(blocks, mesh)
    out = torch.empty(shape, dtype=every[0].dtype, device=every[0].device)
    seen = set()
    for p, block in enumerate(every):
        idx = _block_index(mesh, p, shape, spec)
        key = tuple((s.start, s.stop) for s in idx)
        if key not in seen:
            seen.add(key)
            out[idx] = block.to(out.device)
    return out


def ring_attention_traced(q: Sequence[torch.Tensor],
                          k: Sequence[torch.Tensor],
                          v: Sequence[torch.Tensor], mesh,
                          axis: str = "seq", causal: bool = False,
                          key_mask: Optional[Sequence[torch.Tensor]] = None
                          ) -> List[torch.Tensor]:
    """The per-position ring (the reference's ``_ring_attention_local``
    under ``shard_map``): ``q``, ``k``, ``v`` are each local position's
    ``[B, L / p, H, D]`` blocks, ``key_mask`` its ``[B, L / p]`` bool
    blocks (False: a padding key; None: every key counts). Position ``r``
    of the axis holds queries at offset ``r * L / p``; at step ``t`` it
    folds in the K/V block first held by position ``(r + t) mod p``,
    received from its right neighbour. Fully masked query rows give 0.
    Returns each local position's ``[B, L / p, H, D]`` output, in the
    inputs' dtype. Collective over ``axis``: every position of the mesh
    runs it."""
    from predictionio_tpu_torch.parallel.collectives import ring_pass

    p_size = mesh.shape[axis]
    q, k, v = list(q), list(k), list(v)
    if key_mask is None:
        key_mask = [torch.ones(x.shape[:2], dtype=torch.bool,
                               device=x.device) for x in k]
    km = list(key_mask)
    ranks = [mesh.axis_index(p, axis) for p in mesh.local_positions()]
    b, lq, h, d = q[0].shape
    lk = k[0].shape[1]
    scale = d ** -0.5
    state = [(torch.zeros((b, h, lq, d), dtype=torch.float32,
                          device=x.device),
              torch.full((b, h, lq), NEG_INF, dtype=torch.float32,
                         device=x.device),
              torch.zeros((b, h, lq), dtype=torch.float32,
                          device=x.device)) for x in q]
    for t in range(p_size):
        state = [_flash_step(qj, kj, vj, *st, r * lq,
                             ((r + t) % p_size) * lk, causal, scale,
                             key_mask_j=mj)
                 for qj, kj, vj, mj, st, r in zip(q, k, v, km, state,
                                                   ranks)]
        if t + 1 < p_size:
            # receive the next block from the right neighbour
            k, v, km = (ring_pass(x, mesh, axis, p_size, reverse=True)
                        for x in (k, v, km))
    return [_flash_finish(o, l, qj.dtype)
            for (o, _m, l), qj in zip(state, q)]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis: str = "seq", causal: bool = False,
                   key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequence-parallel exact attention over ``mesh[axis]`` on whole
    ``[B, L, H, D]`` tensors: the sequence splits over ``axis`` (the
    batch over ``"data"`` too, when the mesh has it beside ``axis``),
    :func:`ring_attention_traced` runs at every position, and the whole
    output comes back assembled from every position's block."""
    _check_seq_divisible(q.shape[1], mesh, axis)
    spec = (_batch_axis_of(mesh, axis), axis, None, None)
    if key_mask is None:
        key_mask = torch.ones(q.shape[:2], dtype=torch.bool,
                              device=q.device)
    out = ring_attention_traced(
        *(split_blocks(x, mesh, spec) for x in (q, k, v)), mesh, axis,
        causal, split_blocks(key_mask, mesh, spec[:2]))
    return assemble_blocks(out, mesh, spec, q.shape).to(q.device)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, axis: str = "seq", causal: bool = False,
                      key_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """All-to-all sequence parallelism on whole ``[B, L, H, D]``
    tensors: each position's ``[B, L / p, H, D]`` blocks become ``[B, L,
    H / p, D]`` by one ``all_to_all`` over ``axis`` (its head group over
    the whole sequence), :func:`mha` runs there with the key mask
    gathered whole, and a second ``all_to_all`` brings the output back
    to sequence blocks, which are assembled. Heads and sequence length
    must divide by the axis size (the reference's ``ValueError``s)."""
    from predictionio_tpu_torch.parallel.collectives import (
        all_gather, all_to_all,
    )

    p_size = mesh.shape[axis]
    if q.shape[2] % p_size:
        raise ValueError(
            f"heads {q.shape[2]} not divisible by mesh axis size {p_size}")
    if q.shape[1] % p_size:
        raise ValueError(
            f"seq len {q.shape[1]} not divisible by mesh axis size {p_size}")
    spec = (None, axis, None, None)
    if key_mask is None:
        key_mask = torch.ones(q.shape[:2], dtype=torch.bool,
                              device=q.device)
    # [B, L/p, H, D] --all_to_all--> [B, L, H/p, D]
    heads = [all_to_all(split_blocks(x, mesh, spec), mesh, axis,
                        split_axis=2, concat_axis=1) for x in (q, k, v)]
    # the key mask whole ([B, L] bool, tiny): gathered along L
    masks = all_gather([m.t().contiguous()
                        for m in split_blocks(key_mask, mesh, spec[:2])],
                       mesh, axis)
    out = [mha(qj, kj, vj, causal=causal, key_mask=mj.t())
           for qj, kj, vj, mj in zip(*heads, masks)]
    seq = all_to_all(out, mesh, axis, split_axis=1, concat_axis=2)
    return assemble_blocks(seq, mesh, spec, q.shape).to(q.device)
