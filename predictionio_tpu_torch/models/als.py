"""ALS matrix factorization on a mesh of positions (port of the
reference's ``models/als.py``): training, and the ``ALSModel`` that
serves.

Training follows the reference's ALX layout: ratings packed on the host
into padded per-segment rows sorted by user and by item (numpy, copied
from the reference), uploaded once; each half-sweep assembles every
segment's normal equations from the opposite factors (``ops/segment``)
and solves them in one batched SPD solve (``ops/linalg``, the
hand-written kernel on the card). Explicit feedback uses ALS-WR
weighted-lambda regularization; implicit feedback Hu-Koren-Volinsky
confidence weighting with the shared V^T V Gramian. The ``subspace``
solver is iALS++ block coordinate descent.

Users and items are sharded in contiguous blocks over the mesh's
positions (``parallel/mesh``; one position by default). Each half-sweep
runs, for every local position in a plain loop, the one-shard sweep on
that position's rows against the full opposite factors, then one
``all_gather`` of the new factors (``parallel/collectives``) hands the
next half-sweep its full opposite — across processes through the
``torch.distributed`` group. :func:`build_distributed` assembles the
layout from per-process rating shards with one row exchange by owner
(``parallel/shuffle``).

A model comes from training, from the reference's factor arrays
(:meth:`ALSModel.from_arrays`) or from a ``.npz`` written by
``workflow/serialization.save_model``.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.core.params import Params
from predictionio_tpu_torch.data.bimap import vocab_index
from predictionio_tpu_torch.obs.tracing import span
from predictionio_tpu_torch.obs.train_stats import (
    als_block_sweeps, als_gramian_cache_hits, als_half_sweep_seconds,
)
from predictionio_tpu_torch.ops.bucketing import bucket_size, pad_rows
from predictionio_tpu_torch.ops.linalg import batched_spd_solve
from predictionio_tpu_torch.ops.segment import (
    block_gram_rhs, row_predict_add, rows_gram_rhs, segment_count,
)
from predictionio_tpu_torch.ops.topk import host_topk
from predictionio_tpu_torch.utils.device import resolve_device, synchronize

#: selectable training solvers: "full" = one K x K normal-equations solve
#: per row per half-sweep (the classic ALS step); "subspace" = iALS++
#: block coordinate descent over rank blocks (arXiv:2110.14044)
SOLVERS = ("full", "subspace")


@dataclasses.dataclass
class ALSParams(Params):
    """Hyperparameters (the reference's ``ALSParams``: rank,
    numIterations, lambda, seed; implicit feedback adds alpha)."""

    rank: int = 10
    num_iterations: int = 10
    reg: float = 0.01
    alpha: float = 1.0
    implicit_prefs: bool = False
    weighted_reg: bool = True   # ALS-WR: lambda scaled by per-entity count
    seed: int = 3
    #: rows per chunk of the Gramian assembly (bounds the gather buffer)
    chunk_size: int = 8192
    #: "full" (per-row K x K solve) or "subspace" (block coordinate
    #: descent over rank blocks of `block_size`, b x b solves)
    solver: str = "full"
    block_size: int = 16


def validate_solver(params: ALSParams) -> None:
    """Loud failure on a typo'd solver config."""
    if params.solver not in SOLVERS:
        raise ValueError(
            f"unknown ALS solver {params.solver!r}: expected one of "
            f"{'|'.join(SOLVERS)}")
    if params.solver == "subspace" and params.block_size < 1:
        raise ValueError(
            f"block_size must be >= 1, got {params.block_size}")


def block_starts(rank: int, block_size: int) -> Tuple[int, ...]:
    """Start offsets of the rank blocks one subspace sweep solves.

    Blocks are `block_size` wide; when rank is not divisible the LAST
    block is shifted left to end at `rank` (it overlaps its predecessor
    instead of shrinking, so every block keeps one b x b shape, and
    re-solving the overlap columns is still exact coordinate descent).
    rank <= block_size degrades to one block == the full solve."""
    b = max(1, min(block_size, rank))
    return tuple(sorted({min(s, rank - b) for s in range(0, rank, b)}))


# ---------------------------------------------------------------------------
# Host-side data layout (ALX-style padded rows), numpy as in the reference
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedRows:
    """Ratings packed into padded per-segment rows, split across shards.

    Row r holds up to L ratings of ONE segment (heavy segments span
    several consecutive rows); shard s owns segments [s * seg_per_shard,
    (s+1) * seg_per_shard), one shard a mesh position. The arrays hold
    every shard, or this process's (``ALSData.positions``); after
    :meth:`ALSData.put` they are lists of one ``[R, L]`` / ``[R]`` tensor
    a local position, each on its position's device."""

    tgt: np.ndarray   # int32 [D, R, L] — opposite-side factor rows
    val: np.ndarray   # float32 [D, R, L] — rating values
    w: np.ndarray     # float32 [D, R, L] — weights (0 = padding)
    seg: np.ndarray   # int32 [D, R] — LOCAL segment id of each row (sorted)
    seg_per_shard: int
    n_segments: int   # padded total (n_shards * seg_per_shard)
    row_len: int


def _auto_row_len(nnz: int, n_segments: int) -> int:
    mean = max(1.0, nnz / max(n_segments, 1))
    return int(min(512, max(16, 1 << int(np.ceil(np.log2(mean))))))


def _row_positions(seg_local: np.ndarray, row_len: int,
                   seg_per_shard: int):
    """Packing positions for sorted-by-segment ratings: (rrow, col,
    n_rows, row_seg), where element j lands at [rrow[j], col[j]] of an
    [n_rows, row_len] padded-row array. n == 0 degrades to one
    all-padding row (rrow/col None)."""
    n = len(seg_local)
    if n == 0:
        return None, None, 1, np.full((1,), seg_per_shard - 1, np.int32)
    # the input is sorted by segment, so groups fall out of one diff pass
    new_seg = np.empty(n, bool)
    new_seg[0] = True
    np.not_equal(seg_local[1:], seg_local[:-1], out=new_seg[1:])
    first_idx = np.flatnonzero(new_seg)            # [U] group starts
    uniq = seg_local[first_idx]
    counts = np.diff(np.append(first_idx, n))
    rows_per = -(-counts // row_len)
    row_start = np.concatenate([[0], np.cumsum(rows_per)])
    inv = np.cumsum(new_seg) - 1                   # group id per element
    pos = np.arange(n) - first_idx[inv]
    rrow = row_start[inv] + pos // row_len
    col = pos % row_len
    n_rows = int(row_start[-1])
    row_seg = np.repeat(uniq, rows_per).astype(np.int32)
    return rrow, col, n_rows, row_seg


def _build_rows(seg_local: np.ndarray, tgt: np.ndarray, val: np.ndarray,
                weights: Optional[np.ndarray], row_len: int,
                seg_per_shard: int):
    """Pack one shard's (sorted-by-segment) ratings into padded rows."""
    rrow, col, n_rows, row_seg = _row_positions(seg_local, row_len,
                                                seg_per_shard)
    tgt_out = np.zeros((n_rows, row_len), np.int32)
    val_out = np.zeros((n_rows, row_len), np.float32)
    w_out = np.zeros((n_rows, row_len), np.float32)
    if rrow is not None:
        tgt_out[rrow, col] = tgt
        val_out[rrow, col] = val
        w_out[rrow, col] = weights if weights is not None else 1.0
    return tgt_out, val_out, w_out, row_seg


def _bucket_rows(r_max: int) -> int:
    """Round the padded row count up to a multiple of 256 (the
    reference's bucketing, kept so both layouts are equal)."""
    return max(256, -(-r_max // 256) * 256)


def _stack_parts(per_shard, r_max: int, row_len: int, seg_per_shard: int):
    """Stack per-shard `_build_rows` outputs into padded [D, R, L]
    (+ [D, R] seg) arrays."""
    n = len(per_shard)

    def _stack(idx, fill, dtype, shape_tail):
        out = np.full((n, r_max) + shape_tail, fill, dtype=dtype)
        for s, parts in enumerate(per_shard):
            a = parts[idx]
            out[s, :a.shape[0]] = a
        return out

    seg_out = np.full((n, r_max), seg_per_shard - 1, np.int32)
    for s, (_, _, _, rs) in enumerate(per_shard):
        seg_out[s, :rs.shape[0]] = rs
    return (_stack(0, 0, np.int32, (row_len,)),
            _stack(1, 0.0, np.float32, (row_len,)),
            _stack(2, 0.0, np.float32, (row_len,)),
            seg_out)


def shard_rows(seg_idx: np.ndarray, tgt_idx: np.ndarray, values: np.ndarray,
               n_segments: int, n_shards: int = 1,
               weights: Optional[np.ndarray] = None,
               row_len: Optional[int] = None) -> ShardedRows:
    """Sort by segment, split at shard boundaries, pack into padded
    rows."""
    order = np.argsort(seg_idx, kind="stable")
    seg_s = seg_idx[order].astype(np.int64)
    tgt_s = tgt_idx[order].astype(np.int32)
    val_s = values[order].astype(np.float32)
    w_s = weights[order].astype(np.float32) if weights is not None else None
    nnz = len(seg_s)
    if row_len is None:
        row_len = _auto_row_len(nnz, n_segments)

    seg_per_shard = -(-max(n_segments, 1) // n_shards)
    bounds = np.searchsorted(
        seg_s, np.arange(1, n_shards) * seg_per_shard, side="left")
    starts = np.concatenate([[0], bounds, [nnz]]).astype(np.int64)

    per_shard = []
    for s in range(n_shards):
        lo, hi = int(starts[s]), int(starts[s + 1])
        per_shard.append(_build_rows(
            seg_s[lo:hi] - s * seg_per_shard, tgt_s[lo:hi], val_s[lo:hi],
            w_s[lo:hi] if w_s is not None else None, row_len, seg_per_shard))
    r_max = _bucket_rows(max(t.shape[0] for t, _, _, _ in per_shard))
    tgt, val, w, seg = _stack_parts(per_shard, r_max, row_len, seg_per_shard)
    return ShardedRows(
        tgt=tgt, val=val, w=w, seg=seg,
        seg_per_shard=seg_per_shard,
        n_segments=n_shards * seg_per_shard,
        row_len=row_len,
    )


@dataclasses.dataclass
class ALSData:
    """Training layout: padded rows sorted both ways + dims, one shard a
    mesh position."""

    by_user: ShardedRows    # seg=user, tgt=item
    by_item: ShardedRows    # seg=item, tgt=user
    n_users: int
    n_items: int
    n_users_pad: int
    n_items_pad: int
    nnz: int
    #: order-independent digest of the COO triples (coo_digest); the
    #: same however the ratings are spread over shards or processes
    digest: str = ""
    #: the mesh positions [lo, hi) whose rows these arrays hold
    #: (build_distributed); None: every position's
    positions: Optional[Tuple[int, int]] = None
    #: what build_distributed's row exchange moved (rows, bytes, seconds)
    exchange: dict = dataclasses.field(default_factory=dict, compare=False,
                                       repr=False)

    @property
    def n_shards(self) -> int:
        """Mesh positions the layout was built for."""
        return self.by_user.n_segments // self.by_user.seg_per_shard

    @classmethod
    def build(cls, user_idx: np.ndarray, item_idx: np.ndarray,
              ratings: np.ndarray, n_users: int, n_items: int,
              n_shards: int = 1, row_len: Optional[int] = None
              ) -> "ALSData":
        by_user = shard_rows(user_idx, item_idx, ratings, n_users,
                             n_shards, row_len=row_len)
        by_item = shard_rows(item_idx, user_idx, ratings, n_items,
                             n_shards, row_len=row_len)
        return cls(by_user=by_user, by_item=by_item,
                   n_users=n_users, n_items=n_items,
                   n_users_pad=by_user.n_segments,
                   n_items_pad=by_item.n_segments,
                   nnz=int(len(ratings)),
                   digest=coo_digest(user_idx, item_idx, ratings))

    def put(self, mesh) -> "ALSData":
        """The layout with each local position's rows on its position's
        device, uploaded once: a layout already placed on these devices
        is returned as it is, so repeated trains reuse its tensors. The
        layout holds every position's rows (sliced to this process's
        here) or exactly this process's (:func:`build_distributed`)."""
        local = mesh.local_positions()
        lo, hi = local.start, local.stop
        devs = mesh.local_devices()
        held = self.positions or (0, self.n_shards)
        if self.n_shards != mesh.size:
            raise ValueError(
                f"data built for {self.n_shards} shards but the mesh has "
                f"{mesh.size} positions: build with n_shards=mesh.size")
        if not (held[0] <= lo and hi <= held[1]):
            raise ValueError(f"the layout holds positions {held}, this "
                             f"process needs [{lo}, {hi})")

        def place(a, j, dev):
            t = a[j] if isinstance(a, list) else torch.from_numpy(
                np.ascontiguousarray(a[lo - held[0] + j]))
            return t if t.device == dev else t.to(dev)

        def commit(rows: ShardedRows) -> ShardedRows:
            def each(a):
                return [place(a, j, d) for j, d in enumerate(devs)]

            return dataclasses.replace(rows, tgt=each(rows.tgt),
                                       val=each(rows.val), w=each(rows.w),
                                       seg=each(rows.seg))

        already = isinstance(self.by_user.tgt, list) \
            and self.positions == (lo, hi)
        if already and all(t.device == d for t, d in
                           zip(self.by_user.tgt, devs)):
            return self
        out = dataclasses.replace(self, by_user=commit(self.by_user),
                                  by_item=commit(self.by_item),
                                  positions=(lo, hi))
        for d in {str(d): d for d in devs}.values():
            synchronize(d)
        return out


# ---------------------------------------------------------------------------
# Device sweeps
# ---------------------------------------------------------------------------

def _reg_per_segment(reg: torch.Tensor, cnt: torch.Tensor,
                     weighted_reg: bool) -> torch.Tensor:
    """Each unit's ridge per segment, ``[b, S]``, from its ``reg [b]``
    and the segment counts ``cnt [b, S]``."""
    if weighted_reg:
        return reg[:, None] * torch.clamp_min(cnt, 1.0)
    return reg[:, None].expand_as(cnt)


def _normal_equations(factors: torch.Tensor,
                      gram_all: Optional[torch.Tensor], row_tgt, row_seg,
                      row_val, row_w, reg: torch.Tensor,
                      alpha: torch.Tensor, *, num_segments: int,
                      implicit_prefs: bool, weighted_reg: bool,
                      alpha_is_zero: bool, chunk_rows: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every segment's normal equations against the frozen ``factors``
    for ``b`` units at once (a train is ``b = 1``): ``factors [b, F,
    K]``, the shared padded rows (``row_val [R, L]``), each unit's
    weights ``row_w [b, R, L]`` and its ``reg`` / ``alpha [b]``. Returns
    ``(A [b,S,K,K], rhs [b,S,K], ridge [b,S])``, solved as ``(A + ridge
    I) x = rhs``. Implicit feedback adds the global Gramian ``gram_all
    [b, K, K]`` (V^T V of all of ``factors``); explicit feedback ignores
    it."""
    if implicit_prefs:
        # Hu-Koren-Volinsky: p = [r > 0], c = 1 + alpha * |r|;
        # A_s = V^T V + sum (c-1) f f^T + lam I ; b_s = sum c p f, with
        # rhs values c*p/(c-1) so that value * weight = c * p exactly.
        # alpha == 0 is c = 1: the Gramian correction vanishes and the
        # rhs is a plain preference sum.
        p = (row_val > 0).to(row_val.dtype)[None]
        if alpha_is_zero:
            _, rhs, cnt = rows_gram_rhs(
                factors, row_tgt, row_seg, p, row_w,
                num_segments=num_segments, chunk_rows=chunk_rows)
            b, _, k = factors.shape
            A = gram_all[:, None].expand(b, num_segments, k, k)
        else:
            cm1 = alpha[:, None, None] * row_val.abs()   # c - 1, [b, R, L]
            vals = torch.where(
                cm1 > 0, (1.0 + cm1) * p / torch.clamp_min(cm1, 1e-12),
                torch.zeros_like(cm1))
            gram, rhs, _ = rows_gram_rhs(
                factors, row_tgt, row_seg, vals, row_w * cm1,
                num_segments=num_segments, chunk_rows=chunk_rows)
            cnt = segment_count(row_seg, row_w.sum(dim=-1), num_segments)
            A = gram_all[:, None] + gram
        return A, rhs, _reg_per_segment(reg, cnt, weighted_reg)
    gram, rhs, cnt = rows_gram_rhs(
        factors, row_tgt, row_seg, row_val[None], row_w,
        num_segments=num_segments, chunk_rows=chunk_rows)
    return gram, rhs, _reg_per_segment(reg, cnt, weighted_reg)


def _solve_units(A: torch.Tensor, rhs: torch.Tensor,
                 lam: torch.Tensor) -> torch.Tensor:
    """Every unit's systems in ONE batched SPD solve (B1 on the card):
    ``[b, S, K, K]`` flat to ``[b * S, K, K]``, each system's ridge in
    ``diag``. Returns ``[b, S, K]``."""
    b, s, k = rhs.shape
    x = batched_spd_solve(A.reshape(b * s, k, k), rhs.reshape(b * s, k),
                          diag=lam.reshape(b * s))
    return x.view(b, s, k)


def _half_sweep_dyn(opposite: torch.Tensor, row_tgt, row_seg, row_val,
                    row_w, seg_per_shard: int, *, reg, alpha,
                    implicit_prefs: bool, weighted_reg: bool,
                    alpha_is_zero: bool, chunk_rows: int,
                    gram_all: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Solve this side's factors of ``b`` units against their full
    opposite factor matrices ``opposite [b, F, K]`` (rows in the padded
    ALX layout, weights ``row_w [b, R, L]``, ``reg`` / ``alpha [b]``).
    One batched K x K solve over every unit's systems; returns ``[b, S,
    K]``. Implicit feedback takes ``gram_all [b, K, K]`` (V^T V) when
    the caller has it (a mesh's psum'd Gramian), else computes it."""
    if implicit_prefs and gram_all is None:
        gram_all = _global_gram(opposite)
    A, rhs, lam = _normal_equations(
        opposite, gram_all if implicit_prefs else None,
        row_tgt, row_seg, row_val, row_w, reg, alpha,
        num_segments=seg_per_shard, implicit_prefs=implicit_prefs,
        weighted_reg=weighted_reg, alpha_is_zero=alpha_is_zero,
        chunk_rows=chunk_rows)
    return _solve_units(A, rhs, lam)


def _unit_params(params: ALSParams, dev) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """``(reg [1], alpha [1])`` of one train on ``dev``."""
    return (torch.tensor([params.reg], dtype=torch.float32, device=dev),
            torch.tensor([params.alpha], dtype=torch.float32, device=dev))


def _half_sweep(opposite: torch.Tensor, rows: ShardedRows,
                params: ALSParams, reg: torch.Tensor,
                alpha: torch.Tensor, j: int = 0,
                gram_all: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One train's half-sweep (``b = 1`` of `_half_sweep_dyn`) on the
    rows of local position ``j``: ``opposite [F, K]`` to ``[S, K]``."""
    return _half_sweep_dyn(
        opposite[None], rows.tgt[j], rows.seg[j], rows.val[j],
        rows.w[j][None], rows.seg_per_shard, reg=reg, alpha=alpha,
        implicit_prefs=params.implicit_prefs,
        weighted_reg=params.weighted_reg,
        alpha_is_zero=(params.alpha == 0), chunk_rows=params.chunk_size,
        gram_all=None if gram_all is None else gram_all[None])[0]


def _global_gram(opposite: torch.Tensor) -> torch.Tensor:
    """The K x K Gramian of each unit's full opposite factor matrix
    (``[b, F, K]`` to ``[b, K, K]``; the implicit solver's V^T V term),
    once per half-sweep (:func:`_sharded_gram` on a mesh)."""
    return opposite.transpose(-1, -2) @ opposite


def _sharded_gram(opposite: torch.Tensor, mesh) -> list:
    """The Gramian of ``opposite [F, K]`` on a mesh (the reference's
    sharded ``_global_gram``): position p reduces its slice of the rows
    (``ceil(F / D)`` rows each, the last short) and one psum of the
    ``[K, K]`` results combines them. One per local position."""
    from predictionio_tpu_torch.parallel.collectives import psum

    d = mesh.size
    if d == 1:
        return [_global_gram(opposite[None])[0]]
    f = opposite.shape[0]
    per = -(-f // d)
    parts = []
    for p, dev in zip(mesh.local_positions(), mesh.local_devices()):
        sl = opposite[p * per:min(f, (p + 1) * per)].to(dev)
        parts.append(sl.T @ sl)
    return psum(parts, mesh, mesh.axis_names[0])


def _half_sweep_subspace_dyn(x_prev: torch.Tensor, opposite: torch.Tensor,
                             row_tgt, row_seg, row_val, row_w,
                             seg_per_shard: int, *, reg, alpha,
                             implicit_prefs: bool, weighted_reg: bool,
                             alpha_is_zero: bool, chunk_rows: int,
                             block_size: int,
                             gram_all: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Block coordinate descent half-sweep (iALS++, arXiv:2110.14044)
    for ``b`` units (``x_prev [b, S, K]``, ``opposite [b, F, K]``, the
    rest as in `_half_sweep_dyn`): for each rank block of width B, solve
    every row's B x B system against the frozen remainder of its own
    factors (``x_prev``, updated block by block), with the per-rating
    predictions maintained incrementally; one batched solve per block
    over every unit's systems. The per-segment counts and, for implicit
    feedback, the global Gramian are built once and reused by every
    block. ``gram_all [b, K, K]`` is the implicit Gramian when the
    caller has it (a mesh's psum'd one)."""
    k = opposite.shape[-1]
    bs = max(1, min(block_size, k))
    starts = block_starts(k, block_size)
    # block buffers are [b, C, L, B] vs the full path's [b, C, L, K]
    chunk_b = chunk_rows * max(1, k // bs)

    cnt = segment_count(row_seg, row_w.sum(dim=-1), seg_per_shard)
    lam = _reg_per_segment(reg, cnt, weighted_reg)
    if implicit_prefs:
        if gram_all is None:
            gram_all = _global_gram(opposite)                   # [b, K, K]
        p = (row_val > 0).to(row_val.dtype)
        if alpha_is_zero:
            gram_w = torch.zeros_like(row_w)
            rhs_val = row_w * p
        else:
            cm1 = alpha[:, None, None] * row_val.abs()          # c - 1
            gram_w = row_w * cm1
            rhs_val = row_w * (1.0 + cm1) * p
    else:
        gram_all = None
        gram_w = row_w
        rhs_val = row_w * row_val

    pred = row_predict_add(opposite, x_prev, row_tgt, row_seg,
                           torch.zeros_like(row_w), chunk_rows=chunk_rows)

    x = x_prev.clone()
    for j, s in enumerate(starts):
        f_b = opposite[..., s:s + bs]
        x_b = x[..., s:s + bs].clone()
        gram, rhs = block_gram_rhs(
            f_b, x_b, row_tgt, row_seg, pred, rhs_val, gram_w,
            num_segments=seg_per_shard, chunk_rows=chunk_b)
        if implicit_prefs:
            # dense all-items term from the cached global Gramian:
            # A += G[B,B]; rhs -= (x G)[:,B] - x_B G[B,B]
            g_col = gram_all[..., s:s + bs]                     # [b, K, B]
            g_bb = g_col[:, s:s + bs]
            gram = gram + g_bb[:, None]
            rhs = rhs - (x @ g_col - x_b @ g_bb)
        y = _solve_units(gram, rhs, lam)
        if j + 1 < len(starts):
            # fold this block's delta into the running predictions (the
            # last block's update feeds nothing)
            pred = row_predict_add(f_b, y - x_b, row_tgt, row_seg, pred,
                                   chunk_rows=chunk_b)
        x[..., s:s + bs] = y
    return x


def _half_sweep_subspace(x_prev: torch.Tensor, opposite: torch.Tensor,
                         rows: ShardedRows, params: ALSParams,
                         reg: torch.Tensor, alpha: torch.Tensor, j: int = 0,
                         gram_all: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """One train's subspace half-sweep (``b = 1``) on the rows of local
    position ``j``: ``[S, K]``."""
    return _half_sweep_subspace_dyn(
        x_prev[None], opposite[None], rows.tgt[j], rows.seg[j],
        rows.val[j], rows.w[j][None], rows.seg_per_shard, reg=reg,
        alpha=alpha, implicit_prefs=params.implicit_prefs,
        weighted_reg=params.weighted_reg,
        alpha_is_zero=(params.alpha == 0), chunk_rows=params.chunk_size,
        block_size=params.block_size,
        gram_all=None if gram_all is None else gram_all[None])[0]


def _init_item_factors(n_items: int, n_items_pad: int, k: int, seed: int,
                       device: torch.device) -> torch.Tensor:
    """Initial item factors: standard normal from a generator seeded by
    ``seed``, divided by sqrt(k); padding rows start (and stay) zero, as
    in the reference (nonzero pads would pollute the implicit solvers'
    global Gramian). The draw is ``[n_items, K]``, so it does not
    depend on the padding a shard count gives: every process of a mesh
    and a one-device train draw the same factors on one device type.
    torch cannot reproduce the reference's ``jax.random`` draw: to start
    from the reference's factors pass ``init_V`` to :func:`train_als`."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    V = torch.zeros((n_items_pad, k), dtype=torch.float32, device=device)
    V[:n_items] = torch.randn((n_items, k), generator=g, device=device,
                              dtype=torch.float32) / math.sqrt(k)
    return V


def als_fingerprint(data: ALSData, params: ALSParams) -> str:
    """Identity of a training run for checkpoint-resume safety, the
    reference's hex string for the same data and params: the
    math-shaping hyperparams (not num_iterations or chunk_size — more
    iterations of the same run is what resuming is for — and not the
    solver, which minimizes the same objective), the dataset's sizes and
    its order-independent COO digest."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    h.update(repr((params.rank, params.reg, params.alpha,
                   params.implicit_prefs, params.weighted_reg,
                   params.seed)).encode())
    h.update(np.asarray([data.nnz, data.n_users, data.n_items],
                        np.int64).tobytes())
    h.update(data.digest.encode())
    return h.hexdigest()


def _padded(rows: np.ndarray, n: int, n_pad: int, dev) -> torch.Tensor:
    out = torch.zeros((n_pad, rows.shape[1]), dtype=torch.float32,
                      device=dev)
    out[:n] = torch.from_numpy(np.array(rows[:n], np.float32)).to(dev)
    return out


def _flat_mesh(mesh):
    """The mesh's positions as one ``"data"`` axis in flat order (ALS
    shards users and items over every position)."""
    from predictionio_tpu_torch.parallel.mesh import DATA_AXIS, Mesh

    return Mesh(mesh.devices.reshape(-1), mesh.process_indices.reshape(-1),
                (DATA_AXIS,), process_index=mesh.process_index)


def _resume_state(checkpointer, fp, data: ALSData, params: ALSParams,
                  mesh):
    """``(step, V, U)`` of the snapshot to resume from (host arrays, U
    None unless the snapshot carries it), or None. Across processes
    process 0's snapshot decides and is broadcast, so every process
    resumes alike (snapshot directories are per-process paths)."""
    k = params.rank
    snap = checkpointer.latest(fingerprint=fp)
    # a snapshot at or past the target (a stale run with fewer
    # iterations) would skip every sweep: train from scratch instead
    ok = snap is not None and snap[0] < params.num_iterations \
        and getattr(snap[1].get("V"), "shape", None) == (data.n_items, k)
    su = snap[1].get("U") if ok else None
    has_u = getattr(su, "shape", None) == (data.n_users, k)
    if not mesh.spans_processes:
        if not ok:
            return None
        return snap[0], np.asarray(snap[1]["V"], np.float32), \
            (np.asarray(su, np.float32) if has_u else None)
    from predictionio_tpu_torch.parallel.collectives import (
        broadcast_one_to_all,
    )

    # only subspace snapshots carry U: gating on the solver (the same on
    # every process) spares the full solver an n_users x k broadcast
    want_u = params.solver == "subspace"
    meta = np.zeros(3, np.int64)
    v_buf = np.zeros((data.n_items, k), np.float32)
    u_buf = np.zeros((data.n_users if want_u else 0, k), np.float32)
    if mesh.process_index == 0 and ok:
        meta[:] = (1, snap[0], int(want_u and has_u))
        v_buf[:] = np.asarray(snap[1]["V"], np.float32)
        if want_u and has_u:
            u_buf[:] = np.asarray(su, np.float32)
    meta, v_buf, u_buf = broadcast_one_to_all((meta, v_buf, u_buf))
    if not int(meta[0]):
        return None
    return int(meta[1]), v_buf, (u_buf if int(meta[2]) else None)


class _MeshSweeps:
    """The half-sweeps of one train on a mesh: each local position's
    one-shard sweep in a loop, then one all-gather of the new factors
    (and, for implicit feedback, one psum of the opposite's Gramian).
    The full factors live on this process's first local device (and a
    copy on each other local device)."""

    def __init__(self, mesh, params: ALSParams):
        self.mesh = mesh
        self.params = params
        self.devs = mesh.local_devices()
        #: (reg, alpha) of the train on each local device
        self.units = {str(d): _unit_params(params, d) for d in self.devs}
        self.positions = list(mesh.local_positions())
        self.home = self.devs[0]
        self.gather_s = []

    def _on(self, full: torch.Tensor) -> dict:
        return {str(d): full if d == self.home else full.to(d)
                for d in self.devs}

    def __call__(self, prev: torch.Tensor, opposite: torch.Tensor,
                 rows: ShardedRows) -> torch.Tensor:
        from predictionio_tpu_torch.parallel.collectives import all_gather

        p = self.params
        per = rows.seg_per_shard
        opp = self._on(opposite)
        prev_on = self._on(prev) if p.solver == "subspace" else None
        grams = (_sharded_gram(opposite, self.mesh) if p.implicit_prefs
                 and self.mesh.size > 1 else [None] * len(self.devs))
        blocks = []
        for j, (pos, dev) in enumerate(zip(self.positions, self.devs)):
            key = str(dev)
            reg, alpha = self.units[key]
            if p.solver == "subspace":
                x_prev = prev_on[key][pos * per:(pos + 1) * per]
                blocks.append(_half_sweep_subspace(
                    x_prev, opp[key], rows, p, reg, alpha, j=j,
                    gram_all=grams[j]))
            else:
                blocks.append(_half_sweep(opp[key], rows, p, reg, alpha,
                                          j=j, gram_all=grams[j]))
        if self.mesh.size == 1:
            return blocks[0]
        t0 = time.perf_counter()
        full = all_gather(blocks, self.mesh, self.mesh.axis_names[0])[0]
        if self.mesh.spans_processes:
            self.gather_s.append(time.perf_counter() - t0)
        return full


def train_als(data: ALSData, params: ALSParams, device=None,
              init_V: Optional[np.ndarray] = None, checkpointer=None,
              mesh=None, stats: Optional[dict] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Train and return host ``(U [n_users, K], V [n_items, K])`` (on
    every process of a mesh that spans processes).

    ``mesh`` (``parallel/mesh``): the positions the users and items are
    sharded over, one shard a position (``data`` built for ``mesh.size``
    shards). Without one: a mesh of ``data.n_shards`` positions, all on
    ``device``. ``init_V`` (``[n_items, K]`` or ``[n_items_pad, K]``,
    numpy) replaces the seeded initial item factors, e.g. with the
    reference's. The rows are uploaded once (:meth:`ALSData.put`); each
    iteration runs the user half-sweep against V, then the item
    half-sweep against the new U, on every local position, each followed
    by one all-gather (B1 launches once a local position a half-sweep).

    With a ``workflow.checkpoint.Checkpointer`` the iterations run in
    chunks of ``checkpointer.interval`` and V (and U for ``subspace``,
    whose state is both) is snapshotted between chunks under
    :func:`als_fingerprint` (across processes by process 0 alone). A run
    whose latest snapshot of that fingerprint is below
    ``num_iterations`` and fits the data resumes from it and runs only
    the remaining iterations; across processes process 0's snapshot
    decides for all.

    ``stats``, when given, receives ``gather_s`` (each cross-process
    all-gather's seconds) and ``solve_s``."""
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    validate_solver(params)
    if mesh is None:
        mesh = make_mesh(devices=[resolve_device(device)] * data.n_shards)
    mesh = _flat_mesh(mesh)
    data = data.put(mesh)
    devs = mesh.local_devices()
    dev = devs[0]
    k = params.rank
    it = 0
    V = U = None
    fp = None
    if checkpointer is not None:
        fp = als_fingerprint(data, params)
        resumed = _resume_state(checkpointer, fp, data, params, mesh)
        if resumed is not None:
            it, v, u = resumed
            V = _padded(v, data.n_items, data.n_items_pad, dev)
            if u is not None:
                U = _padded(u, data.n_users, data.n_users_pad, dev)
    if V is None and init_V is None:
        V = _init_item_factors(data.n_items, data.n_items_pad, k,
                               params.seed, dev)
    elif V is None:
        init_V = np.asarray(init_V, np.float32)
        if init_V.shape[1] != k or init_V.shape[0] not in (
                data.n_items, data.n_items_pad):
            raise ValueError(f"init_V shape {init_V.shape} does not fit "
                             f"{data.n_items} items x rank {k}")
        V = _padded(init_V, data.n_items, data.n_items_pad, dev)
    if U is None:
        U = torch.zeros((data.n_users_pad, k), dtype=torch.float32,
                        device=dev)
    start = it
    sweep = _MeshSweeps(mesh, params)
    writer = not mesh.spans_processes or mesh.process_index == 0
    # the solve's wall: the sweeps and the download that waits for them,
    # snapshot writes excluded
    t0 = time.perf_counter()
    save_s = 0.0
    with span("als_solve"):
        while it < params.num_iterations:
            U = sweep(U, V, data.by_user)
            V = sweep(V, U, data.by_item)
            it += 1
            if (checkpointer is not None and it < params.num_iterations
                    and (it - start) % checkpointer.interval == 0):
                t_save = time.perf_counter()
                if writer:
                    state = {"V": V[:data.n_items]}
                    if params.solver == "subspace":
                        state["U"] = U[:data.n_users]
                    checkpointer.save(it, state, fingerprint=fp)
                save_s += time.perf_counter() - t_save
        out = (U[:data.n_users].cpu().numpy(),
               V[:data.n_items].cpu().numpy())
    solve_s = time.perf_counter() - t0 - save_s
    _observe_train(params, it - start, solve_s)
    if stats is not None:
        stats.update(gather_s=list(sweep.gather_s), solve_s=solve_s,
                     half_sweeps=2 * (it - start))
    return out


def _process_shard_range(mesh) -> Tuple[int, int]:
    """This process's contiguous run [lo, hi) of mesh positions (one
    shard row a position along the flattened mesh)."""
    local = _flat_mesh(mesh).local_positions()
    return local.start, local.stop


def build_distributed(mesh, user_idx: np.ndarray, item_idx: np.ndarray,
                      ratings: np.ndarray, n_users: int, n_items: int,
                      row_len: Optional[int] = None) -> ALSData:
    """The training layout from PER-PROCESS rating shards, placed on the
    mesh (:meth:`ALSData.put`).

    Each process passes only the ratings its own storage shard produced
    (``find_columns(shard=(p, P, snapshot))``); rows are re-keyed to
    their segment owners by one row exchange per side
    (``parallel/shuffle.exchange_rows``), and each process packs only
    its own positions' rows. No process holds the global rating set.
    The row count is bucketed over every process's, and the digest is
    the one ``ALSData.build`` gives the union. A mesh within one process
    is ``ALSData.build(..., n_shards=mesh.size).put(mesh)``."""
    from predictionio_tpu_torch.parallel.shuffle import (
        allgather_object, exchange_rows,
    )

    user_idx = np.ascontiguousarray(user_idx, np.int32)
    item_idx = np.ascontiguousarray(item_idx, np.int32)
    ratings = np.ascontiguousarray(ratings, np.float32)
    flat = _flat_mesh(mesh)
    n_shards = flat.size
    if not flat.spans_processes:
        return ALSData.build(user_idx, item_idx, ratings, n_users, n_items,
                             n_shards, row_len=row_len).put(flat)

    lo, hi = _process_shard_range(flat)
    shards_here = hi - lo
    # global sizes and the digest ride one metadata all-gather
    meta = allgather_object({
        "nnz": int(len(ratings)),
        "hash": _coo_hash_commutative(user_idx, item_idx, ratings)})
    nnz = sum(m["nnz"] for m in meta)
    digest = _combine_coo_hashes(meta, nnz)
    if row_len is None:
        row_len = _auto_row_len(nnz, max(n_users, n_items))
    payload = np.stack([user_idx, item_idx, ratings.view(np.int32)], axis=1)
    # each position's owner read off the mesh itself
    proc_of_shard = flat.process_indices.reshape(-1).astype(np.int32)
    exchange = {"rows_out": 0, "rows_in": 0, "bytes_out": 0, "seconds": 0.0}

    def one_side(n_segments: int, seg_col: int, tgt_col: int):
        seg_per_shard = -(-max(n_segments, 1) // n_shards)
        shard_of = np.minimum(payload[:, seg_col] // seg_per_shard,
                              n_shards - 1)
        dest = proc_of_shard[shard_of]
        t0 = time.perf_counter()
        mine = exchange_rows(dest, payload)
        exchange["seconds"] += time.perf_counter() - t0
        away = int((dest != flat.process_index).sum())
        exchange["rows_out"] += away
        exchange["bytes_out"] += away * payload.shape[1] * 4
        exchange["rows_in"] += len(mine)
        seg = mine[:, seg_col]
        if seg.size and not (seg.min() >= lo * seg_per_shard
                             and seg.max() < hi * seg_per_shard):
            raise AssertionError(
                "the exchange delivered segments outside this process's "
                "positions: the shard ownership map is inconsistent")
        order = np.argsort(seg, kind="stable")
        seg_s = seg[order].astype(np.int64)
        tgt_s = mine[order, tgt_col]
        val_s = np.ascontiguousarray(mine[order, 2]).view(np.float32)
        bounds = np.searchsorted(
            seg_s, (lo + np.arange(shards_here + 1)) * seg_per_shard)
        parts = []
        for j in range(shards_here):
            a, b = int(bounds[j]), int(bounds[j + 1])
            parts.append(_build_rows(
                seg_s[a:b] - (lo + j) * seg_per_shard, tgt_s[a:b],
                val_s[a:b], None, row_len, seg_per_shard))
        r_local = max(t.shape[0] for t, _, _, _ in parts)
        # the padded row count agreed over every process
        r_max = _bucket_rows(max(allgather_object(r_local)))
        tgt, val, w, seg_rows = _stack_parts(parts, r_max, row_len,
                                             seg_per_shard)
        return ShardedRows(tgt=tgt, val=val, w=w, seg=seg_rows,
                           seg_per_shard=seg_per_shard,
                           n_segments=n_shards * seg_per_shard,
                           row_len=row_len)

    by_user = one_side(n_users, 0, 1)
    by_item = one_side(n_items, 1, 0)
    out = ALSData(by_user=by_user, by_item=by_item, n_users=n_users,
                  n_items=n_items, n_users_pad=by_user.n_segments,
                  n_items_pad=by_item.n_segments, nnz=nnz, digest=digest,
                  positions=(lo, hi), exchange=exchange)
    return out.put(flat)


def _combine_coo_hashes(meta, nnz: int) -> str:
    """The digest of the union of every process's ratings from their
    commutative hashes (:func:`coo_digest` of the union)."""
    total = np.uint64(0)
    with np.errstate(over="ignore"):
        for m in meta:
            total += np.uint64(m["hash"])
    return f"coo-{nnz}-{int(total):016x}"


def _observe_train(params: ALSParams, iters_run: int,
                   solve_s: float) -> None:
    """The reference's half-sweep accounting (``obs/train_stats``):
    per-half-sweep wall derived from the solve's wall, and for the
    subspace solver its block solves, every one after a half-sweep's
    first served from that half-sweep's Gramian."""
    half_sweeps = max(1, 2 * iters_run)
    als_half_sweep_seconds().observe(solve_s / half_sweeps,
                                     solver=params.solver)
    if params.solver == "subspace":
        n_blocks = len(block_starts(params.rank, params.block_size))
        als_block_sweeps().inc(half_sweeps * n_blocks)
        als_gramian_cache_hits().inc(half_sweeps * max(0, n_blocks - 1))


def _coo_hash_commutative(user_idx, item_idx, ratings) -> int:
    """A commutative sum of per-row mixes (splitmix64-style): the same
    for any row order or partition of the ratings."""
    with np.errstate(over="ignore"):
        h = (user_idx.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
             ^ item_idx.astype(np.uint64) * np.uint64(0xC2B2AE3D27D4EB4F)
             ^ ratings.view(np.uint32).astype(np.uint64)
             * np.uint64(0x165667B19E3779F9))
        h ^= h >> np.uint64(31)
        h *= np.uint64(0xFF51AFD7ED558CCD)
        h ^= h >> np.uint64(29)
        return int(h.sum(dtype=np.uint64))


def coo_digest(user_idx: np.ndarray, item_idx: np.ndarray,
               ratings: np.ndarray) -> str:
    """Identity hash of the full rating set (canonical dtypes, so int32
    and int64 inputs digest alike), independent of row order — the
    reference's checkpoint-resume guard."""
    u = np.ascontiguousarray(np.asarray(user_idx).reshape(-1), np.int64)
    i = np.ascontiguousarray(np.asarray(item_idx).reshape(-1), np.int64)
    r = np.ascontiguousarray(np.asarray(ratings).reshape(-1), np.float32)
    return f"coo-{len(r)}-{_coo_hash_commutative(u, i, r):016x}"


def rmse(model_U: np.ndarray, model_V: np.ndarray, user_idx: np.ndarray,
         item_idx: np.ndarray, ratings: np.ndarray) -> float:
    """RMSE of r_hat = u . v over the given ratings."""
    pred = np.einsum("nk,nk->n", model_U[user_idx], model_V[item_idx])
    return float(np.sqrt(np.mean((pred - ratings) ** 2)))


# ---------------------------------------------------------------------------
# Model (serving side)
# ---------------------------------------------------------------------------


def _topk_scores_batch(user_vecs: torch.Tensor, V: torch.Tensor,
                       mask: torch.Tensor, num: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact masked top-k: one [B,K]@[K,N] f32 product, then top-k."""
    scores = (user_vecs @ V.T).masked_fill(mask, float("-inf"))
    return torch.topk(scores, num, dim=1)


def _topk_scores_batch_nomask(user_vecs: torch.Tensor, V: torch.Tensor,
                              num: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """No-exclusion fast path: skips the [B, n_items] mask build and its
    host->device transfer."""
    return torch.topk(user_vecs @ V.T, num, dim=1)


#: measured seconds for one tiny dispatch + fetch per device — the fixed
#: per-request cost of touching the device at all. Serving compares it
#: against the host-BLAS cost of the same product and sends the batch
#: wherever it finishes sooner. Re-probed when the scorer MODE changes.
#: Tests that force the device lane assign ``_DEVICE_ROUNDTRIP_S = 0.0``.
_DEVICE_ROUNDTRIP_S: Optional[float] = None
_DEVICE_ROUNDTRIP_MODE: Optional[str] = None
_PROBE_LOCK = threading.Lock()


def device_roundtrip_s(device: torch.device) -> float:
    global _DEVICE_ROUNDTRIP_S, _DEVICE_ROUNDTRIP_MODE
    from predictionio_tpu_torch.ops.scoring import process_scorer_config

    mode = process_scorer_config().mode
    with _PROBE_LOCK:
        if _DEVICE_ROUNDTRIP_S is None or (
                _DEVICE_ROUNDTRIP_MODE is not None
                and _DEVICE_ROUNDTRIP_MODE != mode):
            x = torch.ones((8, 8), dtype=torch.float32, device=device)

            def probe():
                vals, idx = torch.topk(x @ x.T, 4, dim=1)
                return vals.cpu(), idx.cpu()

            probe()                       # first-use costs off the clock
            synchronize(device)
            t0 = time.perf_counter()
            for _ in range(3):
                probe()
            _DEVICE_ROUNDTRIP_S = (time.perf_counter() - t0) / 3
            _DEVICE_ROUNDTRIP_MODE = mode
        return _DEVICE_ROUNDTRIP_S


#: rough host matmul+argpartition throughput (flop/s) for the crossover
#: estimate; measured lazily the first time a model serves from host
_HOST_FLOPS: Optional[float] = None


def _host_flops() -> float:
    global _HOST_FLOPS
    if _HOST_FLOPS is None:
        u = np.ones((16, 32), np.float32)
        v = np.ones((2048, 32), np.float32)
        host_topk(u @ v.T, 10)                  # warm the BLAS path
        t0 = time.perf_counter()
        host_topk(u @ v.T, 10)
        dt = max(time.perf_counter() - t0, 1e-7)
        _HOST_FLOPS = 2.0 * u.shape[0] * v.shape[0] * v.shape[1] / dt
    return _HOST_FLOPS


@dataclasses.dataclass
class ALSModel:
    """Trained factors + id maps, served on ``device``.

    ``U`` and ``V`` stay numpy on the host (the exact rescore and the
    host-BLAS lane read them); ``V_device`` is the resident copy of V on
    the device for the exact device scorer, and quantized scorers keep
    their own residency (ops/scoring)."""

    user_vocab: np.ndarray   # sorted distinct user ids (index = row of U)
    item_vocab: np.ndarray   # sorted distinct item ids (index = row of V)
    U: np.ndarray            # [n_users, K] f32
    V: np.ndarray            # [n_items, K] f32
    device: Optional[torch.device] = None
    #: what the train that made this model measured (nnz, build_s,
    #: solve_s); empty for a model loaded from arrays or a file
    train_info: dict = dataclasses.field(default_factory=dict,
                                         compare=False, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @classmethod
    def from_arrays(cls, user_vocab, item_vocab, U, V,
                    device=None) -> "ALSModel":
        """The port's model from a trained model's four arrays (the
        reference's ``ALSModel`` fields)."""
        U = np.ascontiguousarray(np.asarray(U), np.float32)
        V = np.ascontiguousarray(np.asarray(V), np.float32)
        user_vocab, item_vocab = np.asarray(user_vocab), np.asarray(item_vocab)
        if U.ndim != 2 or V.ndim != 2 or U.shape[1] != V.shape[1]:
            raise ValueError(f"factor shapes U {U.shape} / V {V.shape} "
                             "must be [n, K] with one K")
        if len(user_vocab) != U.shape[0] or len(item_vocab) != V.shape[0]:
            raise ValueError("vocab lengths must match the factor rows")
        return cls(user_vocab=user_vocab, item_vocab=item_vocab, U=U, V=V,
                   device=device)

    @property
    def V_device(self) -> torch.Tensor:
        """Item factors resident on the device across requests;
        re-uploaded only when V is swapped."""
        cached = getattr(self, "_resident", None)
        if cached is None or cached[0] is not self.V:
            cached = (self.V, torch.from_numpy(self.V).to(self.device))
            self._resident = cached
        return cached[1]

    def release_device(self) -> None:
        """Drop the device-resident copies (the exact scorer's V, the
        quantized scorer's factors) of a model that no longer serves, so
        their memory is freed."""
        self._resident = None
        self._scorer_cache = None

    def user_index(self, user_id: str) -> Optional[int]:
        return vocab_index(self.user_vocab, user_id)

    def item_index(self, item_id: str) -> Optional[int]:
        return vocab_index(self.item_vocab, item_id)

    def _query_mask(self, exclude_items: Tuple[str, ...],
                    allow_items) -> np.ndarray:
        mask = np.zeros(len(self.item_vocab), dtype=bool)
        for it in exclude_items:
            ii = self.item_index(it)
            if ii is not None:
                mask[ii] = True
        if allow_items is not None:
            allow = np.ones(len(self.item_vocab), dtype=bool)
            for it in allow_items:
                ii = self.item_index(it)
                if ii is not None:
                    allow[ii] = False
            mask |= allow
        return mask

    def recommend(self, user_id: str, num: int,
                  exclude_items: Tuple[str, ...] = (),
                  allow_items: Optional[Tuple[str, ...]] = None):
        """Top-num (item_id, score), optionally excluding/allowlisting."""
        return self.recommend_batch(
            [(user_id, num, exclude_items, allow_items)])[0]

    def _use_host(self, n_rows: int, any_mask: bool) -> bool:
        """Route the batch to host BLAS when the estimated host scoring
        time undercuts one device round-trip. Host BLAS IS the exact
        scorer, so it only competes in exact mode: a non-exact scorer
        mode always routes to the device."""
        from predictionio_tpu_torch.ops.scoring import holder_scorer_config

        cfg = holder_scorer_config(self)
        if cfg.mode != "exact":
            return False
        flops = 2.0 * n_rows * len(self.item_vocab) * self.U.shape[1]
        host_s = flops / _host_flops()
        device_s = device_roundtrip_s(self.device) * (1.5 if any_mask
                                                      else 1.0)
        return host_s < device_s

    def _fused_scorer(self):
        """The cached ops/scoring scorer for the current scorer mode, or
        None when exact (or when the parity gate demoted it)."""
        from predictionio_tpu_torch.ops import scoring

        scorer = scoring.scorer_for(self, self.V)
        if scorer is None or not scorer.active:
            return None
        return scorer

    def recommend_batch(self, requests):
        """Batched recommend: one [B,K]@[K,N] product + top-k for B
        queries. ``requests``: sequence of (user_id, num, exclude_items,
        allow_items). Returns a list parallel to requests; [] for
        unknown users."""
        out = [[] for _ in requests]
        scored = self._score_topk(requests)
        if scored is None:
            return out
        rows, scores, idx, _k = scored
        n_items = len(self.item_vocab)
        finite = np.isfinite(scores)
        score_rows = scores.tolist()
        for b, j in enumerate(rows):
            want = min(requests[j][1], n_items)
            names = self.item_vocab[idx[b][:want]]
            fin_b, s_b = finite[b], score_rows[b]
            out[j] = [(str(names[t]), s_b[t])
                      for t in range(want) if fin_b[t]]
        return out

    def recommend_batch_arrays(self, requests):
        """`recommend_batch` as flat columns: ``(items, scores, counts)``;
        request ``j`` owns the slice ``sum(counts[:j]) :
        sum(counts[:j+1])`` of ``items`` and ``scores`` (float64)."""
        counts = np.zeros(len(requests), dtype=np.int64)
        scored = self._score_topk(requests)
        empty = np.asarray([], dtype=object)
        if scored is None:
            return empty, np.asarray([], dtype=np.float64), counts
        rows, scores, idx, k = scored
        n_items = len(self.item_vocab)
        want = np.fromiter(
            (min(requests[j][1], n_items) for j in rows),
            dtype=np.int64, count=len(rows))
        take = np.isfinite(scores) & (np.arange(k)[None, :] < want[:, None])
        counts[np.asarray(rows)] = take.sum(axis=1)
        return (self.item_vocab[idx[take]],
                scores[take].astype(np.float64), counts)

    def _score_topk(self, requests):
        """Shared scoring core: validate, gather known users, run the
        host-BLAS, quantized or exact device scorer. Returns (rows,
        scores[B,k], idx[B,k], k) over the known-user rows, or None when
        no request has a known user."""
        n_items = len(self.item_vocab)
        for _u, num, _ex, _allow in requests:
            if num < 0:
                raise ValueError(f"num must be >= 0, got {num}")
        rows, uidx = [], []
        any_mask = False
        for j, (user_id, _num, ex, allow) in enumerate(requests):
            ui = self.user_index(user_id)
            if ui is not None:
                rows.append(j)
                uidx.append(ui)
                if ex or allow is not None:
                    any_mask = True
        if not rows:
            return None
        k = min(max(min(requests[j][1], n_items) for j in rows), n_items)
        u_batch = self.U[np.asarray(uidx)]

        if self._use_host(len(rows), any_mask):
            scores = u_batch @ self.V.T                  # [B, N] host BLAS
            if any_mask:
                for b, j in enumerate(rows):
                    m = self._query_mask(requests[j][2], requests[j][3])
                    scores[b, m] = -np.inf
            scores, idx = host_topk(scores, k)
        elif (scorer := self._fused_scorer()) is not None:
            # fused/quantized/two-stage scorer (ops/scoring): the
            # [B, n_items] score matrix never materializes
            mask = None
            if any_mask:
                mask = np.stack(
                    [self._query_mask(requests[j][2], requests[j][3])
                     for j in rows])
            scores, idx = scorer.topk(u_batch, k, mask=mask)
        else:
            # exact device scorer, B and k bucketed to powers of two as
            # the reference buckets them
            b_pad = bucket_size(len(rows))
            k_pad = min(bucket_size(k), n_items)
            u_dev = torch.from_numpy(pad_rows(u_batch, b_pad)).to(
                self.device)
            if any_mask:
                mask = np.stack(
                    [self._query_mask(requests[j][2], requests[j][3])
                     for j in rows]
                    + [np.ones(n_items, bool)] * (b_pad - len(rows)))
                scores, idx = _topk_scores_batch(
                    u_dev, self.V_device,
                    torch.from_numpy(mask).to(self.device), k_pad)
            else:
                scores, idx = _topk_scores_batch_nomask(
                    u_dev, self.V_device, k_pad)
            scores = scores.cpu().numpy()[:len(rows), :k]
            idx = idx.cpu().numpy()[:len(rows), :k]
        return rows, scores, idx, k


# ---------------------------------------------------------------------------
# Online fold-in (deploy/foldin.py): batched single-side row solves
# ---------------------------------------------------------------------------

class FoldInSolver:
    """Batched online fold-in against one frozen factor matrix.

    With the opposite side's factors frozen, each pending row (a user
    with fresh events, or an item with fresh raters) is an independent
    K x K least-squares solve, so B pending rows go through ONE call:
    each row's rated columns gathered from ``factors`` in the training
    path's padded-row layout (``_row_positions``, ``rows_gram_rhs``), the
    cached implicit Gramian V^T V added, and one batched SPD solve (B1 on
    the card). Segment and packed-row counts are bucketed to powers of
    two, as in the reference.

    ``factors_device`` is a copy of ``factors`` already on the device
    (``ALSModel.V_device``), which skips the upload; otherwise the
    factors go to ``device`` (None: ``cuda``; see utils/device).
    ``last_solve`` describes the latest call: the bucketed S and K, the
    host ms of the system's assembly and of the B1 call (on the card the
    wrapper's host time: it returns once the kernel is queued) and, on
    the card, the ms between CUDA events recorded before and after the
    B1 call (the kernel, plus the wait for its launch when the card was
    idle)."""

    def __init__(self, factors: np.ndarray, params: ALSParams,
                 row_len: int = 32, factors_device=None, device=None):
        self.params = params
        self.row_len = max(1, int(row_len))
        if factors_device is not None:
            self._dev = factors_device
        else:
            host = np.ascontiguousarray(np.asarray(factors), np.float32)
            self._dev = torch.from_numpy(host).to(resolve_device(device))
        self.device = self._dev.device
        self._shape = tuple(self._dev.shape)
        self._gram: Optional[torch.Tensor] = None
        self._reg, self._alpha = _unit_params(params, self.device)
        self.last_solve: dict = {}

    @property
    def rank(self) -> int:
        return self._shape[1]

    def _gram_dev(self) -> Optional[torch.Tensor]:
        """V^T V of the whole factor matrix, once per solver (implicit
        feedback only)."""
        if self._gram is None and self.params.implicit_prefs:
            self._gram = _global_gram(self._dev[None])
        return self._gram

    def solve(self, rated, values, weights=None) -> np.ndarray:
        """Solve rows for B segments: ``rated[i]`` holds segment i's
        rated opposite-side indices, ``values[i]`` the rating values,
        optional ``weights[i]`` per-rating weights (default 1). Returns
        host float32 [B, K]. A segment with no ratings solves to the
        zero row."""
        b = len(rated)
        if b != len(values):
            raise ValueError(f"rated/values length mismatch: {b} vs "
                             f"{len(values)}")
        if b == 0:
            return np.zeros((0, self.rank), np.float32)
        counts = np.fromiter((len(r) for r in rated), dtype=np.int64,
                             count=b)
        if weights is not None and [len(w) for w in weights] != \
                counts.tolist():
            raise ValueError("weights must parallel rated per segment")
        seg = np.repeat(np.arange(b, dtype=np.int64), counts)
        total = int(counts.sum())
        if total:
            tgt = np.concatenate([np.asarray(r) for r in rated]
                                 ).astype(np.int32)
            val = np.concatenate([np.asarray(v) for v in values]
                                 ).astype(np.float32)
            w = (np.concatenate([np.asarray(x) for x in weights]
                                ).astype(np.float32)
                 if weights is not None else np.ones(total, np.float32))
            if ((tgt < 0) | (tgt >= self._shape[0])).any():
                raise ValueError(
                    f"rated indices out of range [0, {self._shape[0]})")
        else:
            tgt = np.zeros(0, np.int32)
            val = w = np.zeros(0, np.float32)
        b_pad = bucket_size(b)
        rrow, col, n_rows, row_seg = _row_positions(seg, self.row_len,
                                                    b_pad)
        r_pad = bucket_size(max(n_rows, 1))
        row_tgt = np.zeros((r_pad, self.row_len), np.int32)
        row_val = np.zeros((r_pad, self.row_len), np.float32)
        row_w = np.zeros((r_pad, self.row_len), np.float32)
        # pad rows aim at the LAST (padding) segment with weight 0, so
        # row_seg stays sorted and the pads contribute nothing
        seg_arr = np.full((r_pad,), b_pad - 1, np.int32)
        seg_arr[:n_rows] = row_seg
        if rrow is not None:
            row_tgt[rrow, col] = tgt
            row_val[rrow, col] = val
            row_w[rrow, col] = w
        dev = self.device
        p = self.params
        t0 = time.perf_counter()
        A, rhs, lam = _normal_equations(
            self._dev[None], self._gram_dev(),
            torch.from_numpy(row_tgt).to(dev),
            torch.from_numpy(seg_arr).to(dev),
            torch.from_numpy(row_val).to(dev),
            torch.from_numpy(row_w).to(dev)[None], self._reg, self._alpha,
            num_segments=b_pad, implicit_prefs=p.implicit_prefs,
            weighted_reg=p.weighted_reg, alpha_is_zero=(p.alpha == 0),
            chunk_rows=1024)
        t1 = time.perf_counter()
        cuda = dev.type == "cuda"
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        out = batched_spd_solve(A[0], rhs[0], diag=lam[0])
        t2 = time.perf_counter()
        if cuda:
            end.record()
        x = out[:b].cpu().numpy()
        self.last_solve = {
            "S": b_pad, "K": self.rank, "rows": b,
            "system_ms": (t1 - t0) * 1e3, "solve_call_ms": (t2 - t1) * 1e3,
            "solve_event_ms": start.elapsed_time(end) if cuda else None}
        return x
