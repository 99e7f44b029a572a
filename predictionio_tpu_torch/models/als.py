"""ALS matrix factorization on one device (port of the reference's
``models/als.py``): training, and the ``ALSModel`` that serves.

Training follows the reference's ALX layout: ratings packed on the host
into padded per-segment rows sorted by user and by item (numpy, copied
from the reference), uploaded once; each half-sweep assembles every
segment's normal equations from the opposite factors (``ops/segment``)
and solves them in one batched SPD solve (``ops/linalg``, the
hand-written kernel on the card). Explicit feedback uses ALS-WR
weighted-lambda regularization; implicit feedback Hu-Koren-Volinsky
confidence weighting with the shared V^T V Gramian. The ``subspace``
solver is iALS++ block coordinate descent.

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
    (s+1) * seg_per_shard). The port trains on one device, so D = 1; the
    leading axis keeps the reference's layout. After
    :meth:`ALSData.to` the arrays are tensors on the device."""

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
    """Training layout: padded rows sorted both ways + dims (one shard)."""

    by_user: ShardedRows    # seg=user, tgt=item
    by_item: ShardedRows    # seg=item, tgt=user
    n_users: int
    n_items: int
    n_users_pad: int
    n_items_pad: int
    nnz: int
    #: order-independent digest of the COO triples (coo_digest)
    digest: str = ""

    @classmethod
    def build(cls, user_idx: np.ndarray, item_idx: np.ndarray,
              ratings: np.ndarray, n_users: int, n_items: int,
              row_len: Optional[int] = None) -> "ALSData":
        by_user = shard_rows(user_idx, item_idx, ratings, n_users,
                             row_len=row_len)
        by_item = shard_rows(item_idx, user_idx, ratings, n_items,
                             row_len=row_len)
        return cls(by_user=by_user, by_item=by_item,
                   n_users=n_users, n_items=n_items,
                   n_users_pad=by_user.n_segments,
                   n_items_pad=by_item.n_segments,
                   nnz=int(len(ratings)),
                   digest=coo_digest(user_idx, item_idx, ratings))

    def to(self, device=None) -> "ALSData":
        """The same layout with its row arrays uploaded to ``device``
        once (default ``cuda``), so repeated trains reuse them. Idempotent
        for data already there."""
        dev = resolve_device(device)

        def up(a):
            if isinstance(a, torch.Tensor) and a.device == dev:
                return a
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
            return t.to(dev)

        def commit(rows: ShardedRows) -> ShardedRows:
            return dataclasses.replace(rows, tgt=up(rows.tgt),
                                       val=up(rows.val), w=up(rows.w),
                                       seg=up(rows.seg))

        out = dataclasses.replace(self, by_user=commit(self.by_user),
                                  by_item=commit(self.by_item))
        synchronize(dev)
        return out


# ---------------------------------------------------------------------------
# Device sweeps
# ---------------------------------------------------------------------------

def _reg_per_segment(reg: float, cnt: torch.Tensor,
                     weighted_reg: bool) -> torch.Tensor:
    if weighted_reg:
        return reg * torch.clamp_min(cnt, 1.0)
    return torch.full_like(cnt, reg)


def _normal_equations(factors: torch.Tensor,
                      gram_all: Optional[torch.Tensor], row_tgt, row_seg,
                      row_val, row_w, reg: float, alpha: float, *,
                      num_segments: int, implicit_prefs: bool,
                      weighted_reg: bool, alpha_is_zero: bool,
                      chunk_rows: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every segment's normal equations against the frozen ``factors``
    (rows in the padded ALX layout): ``(A [S,K,K], rhs [S,K], ridge
    [S])``, solved as ``(A + ridge I) x = rhs``. Implicit feedback adds
    the global Gramian ``gram_all`` (V^T V of all of ``factors``);
    explicit feedback ignores it."""
    if implicit_prefs:
        # Hu-Koren-Volinsky: p = [r > 0], c = 1 + alpha * |r|;
        # A_s = V^T V + sum (c-1) f f^T + lam I ; b_s = sum c p f, with
        # rhs values c*p/(c-1) so that value * weight = c * p exactly.
        # alpha == 0 is c = 1: the Gramian correction vanishes and the
        # rhs is a plain preference sum.
        p = (row_val > 0).to(row_val.dtype)
        if alpha_is_zero:
            _, rhs, cnt = rows_gram_rhs(
                factors, row_tgt, row_seg, p, row_w,
                num_segments=num_segments, chunk_rows=chunk_rows)
            k = factors.shape[1]
            A = gram_all.expand(num_segments, k, k).contiguous()
        else:
            cm1 = alpha * row_val.abs()                  # c - 1
            vals = torch.where(
                cm1 > 0, (1.0 + cm1) * p / torch.clamp_min(cm1, 1e-12),
                torch.zeros_like(cm1))
            gram, rhs, _ = rows_gram_rhs(
                factors, row_tgt, row_seg, vals, row_w * cm1,
                num_segments=num_segments, chunk_rows=chunk_rows)
            cnt = segment_count(row_seg, row_w.sum(dim=1), num_segments)
            A = gram_all[None, :, :] + gram
        return A, rhs, _reg_per_segment(reg, cnt, weighted_reg)
    gram, rhs, cnt = rows_gram_rhs(
        factors, row_tgt, row_seg, row_val, row_w,
        num_segments=num_segments, chunk_rows=chunk_rows)
    return gram, rhs, _reg_per_segment(reg, cnt, weighted_reg)


def _half_sweep_dyn(opposite: torch.Tensor, row_tgt, row_seg, row_val,
                    row_w, seg_per_shard: int, *, reg, alpha,
                    implicit_prefs: bool, weighted_reg: bool,
                    alpha_is_zero: bool, chunk_rows: int) -> torch.Tensor:
    """Solve this side's factors against the full opposite factor
    matrix; rows are the padded ALX layout. One batched K x K solve."""
    A, rhs, lam = _normal_equations(
        opposite, _global_gram(opposite) if implicit_prefs else None,
        row_tgt, row_seg, row_val, row_w, reg, alpha,
        num_segments=seg_per_shard, implicit_prefs=implicit_prefs,
        weighted_reg=weighted_reg, alpha_is_zero=alpha_is_zero,
        chunk_rows=chunk_rows)
    return batched_spd_solve(A, rhs, diag=lam)


def _half_sweep(opposite: torch.Tensor, rows: ShardedRows,
                params: ALSParams) -> torch.Tensor:
    """Static-params wrapper over `_half_sweep_dyn` (the training
    path)."""
    return _half_sweep_dyn(
        opposite, rows.tgt[0], rows.seg[0], rows.val[0], rows.w[0],
        rows.seg_per_shard, reg=params.reg, alpha=params.alpha,
        implicit_prefs=params.implicit_prefs,
        weighted_reg=params.weighted_reg,
        alpha_is_zero=(params.alpha == 0), chunk_rows=params.chunk_size)


def _global_gram(opposite: torch.Tensor) -> torch.Tensor:
    """The K x K Gramian of the full opposite factor matrix (the
    implicit solver's V^T V term), once per half-sweep. One device: the
    reference's sharded psum is the multi-GPU slice's."""
    return opposite.T @ opposite


def _half_sweep_subspace_dyn(x_prev: torch.Tensor, opposite: torch.Tensor,
                             row_tgt, row_seg, row_val, row_w,
                             seg_per_shard: int, *, reg, alpha,
                             implicit_prefs: bool, weighted_reg: bool,
                             alpha_is_zero: bool, chunk_rows: int,
                             block_size: int) -> torch.Tensor:
    """Block coordinate descent half-sweep (iALS++, arXiv:2110.14044):
    for each rank block of width b, solve every row's b x b system
    against the frozen remainder of its own factors (``x_prev``, updated
    block by block), with the per-rating predictions maintained
    incrementally. The per-segment counts and, for implicit feedback,
    the global Gramian are built once and reused by every block."""
    k = opposite.shape[1]
    b = max(1, min(block_size, k))
    starts = block_starts(k, block_size)
    # block buffers are [C, L, b] vs the full path's [C, L, K]
    chunk_b = chunk_rows * max(1, k // b)

    cnt = segment_count(row_seg, row_w.sum(dim=1), seg_per_shard)
    lam = _reg_per_segment(reg, cnt, weighted_reg)
    if implicit_prefs:
        gram_all = _global_gram(opposite)                       # [K, K]
        p = (row_val > 0).to(row_val.dtype)
        if alpha_is_zero:
            gram_w = torch.zeros_like(row_w)
            rhs_val = row_w * p
        else:
            cm1 = alpha * row_val.abs()                         # c - 1
            gram_w = row_w * cm1
            rhs_val = row_w * (1.0 + cm1) * p
    else:
        gram_all = None
        gram_w = row_w
        rhs_val = row_w * row_val

    pred = row_predict_add(opposite, x_prev, row_tgt, row_seg,
                           torch.zeros_like(row_val), chunk_rows=chunk_rows)

    x = x_prev.clone()
    for j, s in enumerate(starts):
        f_b = opposite[:, s:s + b]
        x_b = x[:, s:s + b].clone()
        gram, rhs = block_gram_rhs(
            f_b, x_b, row_tgt, row_seg, pred, rhs_val, gram_w,
            num_segments=seg_per_shard, chunk_rows=chunk_b)
        if implicit_prefs:
            # dense all-items term from the cached global Gramian:
            # A += G[B,B]; rhs -= (x G)[:,B] - x_B G[B,B]
            g_col = gram_all[:, s:s + b]
            g_bb = g_col[s:s + b]
            gram = gram + g_bb[None, :, :]
            rhs = rhs - (x @ g_col - x_b @ g_bb)
        y = batched_spd_solve(gram, rhs, diag=lam)
        if j + 1 < len(starts):
            # fold this block's delta into the running predictions (the
            # last block's update feeds nothing)
            pred = row_predict_add(f_b, y - x_b, row_tgt, row_seg, pred,
                                   chunk_rows=chunk_b)
        x[:, s:s + b] = y
    return x


def _half_sweep_subspace(x_prev: torch.Tensor, opposite: torch.Tensor,
                         rows: ShardedRows, params: ALSParams
                         ) -> torch.Tensor:
    return _half_sweep_subspace_dyn(
        x_prev, opposite, rows.tgt[0], rows.seg[0], rows.val[0], rows.w[0],
        rows.seg_per_shard, reg=params.reg, alpha=params.alpha,
        implicit_prefs=params.implicit_prefs,
        weighted_reg=params.weighted_reg,
        alpha_is_zero=(params.alpha == 0), chunk_rows=params.chunk_size,
        block_size=params.block_size)


def _init_item_factors(n_items: int, n_items_pad: int, k: int, seed: int,
                       device: torch.device) -> torch.Tensor:
    """Initial item factors: standard normal from a generator seeded by
    ``seed``, divided by sqrt(k); padding rows start (and stay) zero, as
    in the reference (nonzero pads would pollute the implicit solvers'
    global Gramian). torch cannot reproduce the reference's
    ``jax.random`` draw: to start from the reference's factors pass
    ``init_V`` to :func:`train_als`."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    V = torch.randn((n_items_pad, k), generator=g, device=device,
                    dtype=torch.float32) / math.sqrt(k)
    V[n_items:] = 0.0
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


def train_als(data: ALSData, params: ALSParams, device=None,
              init_V: Optional[np.ndarray] = None, checkpointer=None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Train on one device and return host ``(U [n_users, K], V
    [n_items, K])``.

    ``init_V`` (``[n_items, K]`` or ``[n_items_pad, K]``, numpy) replaces
    the seeded initial item factors, e.g. with the reference's. The rows
    are uploaded once (:meth:`ALSData.to`); each iteration runs the user
    half-sweep against V, then the item half-sweep against the new U.

    With a ``workflow.checkpoint.Checkpointer`` the iterations run in
    chunks of ``checkpointer.interval`` and V (and U for ``subspace``,
    whose state is both) is snapshotted between chunks under
    :func:`als_fingerprint`. A run whose latest snapshot of that
    fingerprint is below ``num_iterations`` and fits the data resumes
    from it and runs only the remaining iterations."""
    validate_solver(params)
    dev = resolve_device(device)
    data = data.to(dev)
    k = params.rank
    it = 0
    V = U = None
    fp = None
    if checkpointer is not None:
        fp = als_fingerprint(data, params)
        snap = checkpointer.latest(fingerprint=fp)
        # a snapshot at or past the target (a stale run with fewer
        # iterations) would skip every sweep: train from scratch instead
        if snap is not None and snap[0] < params.num_iterations \
                and getattr(snap[1].get("V"), "shape", None) \
                == (data.n_items, k):
            it, state = snap
            V = _padded(state["V"], data.n_items, data.n_items_pad, dev)
            su = state.get("U")
            if getattr(su, "shape", None) == (data.n_users, k):
                U = _padded(su, data.n_users, data.n_users_pad, dev)
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
    while it < params.num_iterations:
        if params.solver == "subspace":
            U = _half_sweep_subspace(U, V, data.by_user, params)
            V = _half_sweep_subspace(V, U, data.by_item, params)
        else:
            U = _half_sweep(V, data.by_user, params)
            V = _half_sweep(U, data.by_item, params)
        it += 1
        if (checkpointer is not None and it < params.num_iterations
                and (it - start) % checkpointer.interval == 0):
            state = {"V": V[:data.n_items]}
            if params.solver == "subspace":
                state["U"] = U[:data.n_users]
            checkpointer.save(it, state, fingerprint=fp)
    return (U[:data.n_users].cpu().numpy(),
            V[:data.n_items].cpu().numpy())


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
        self.last_solve: dict = {}

    @property
    def rank(self) -> int:
        return self._shape[1]

    def _gram_dev(self) -> Optional[torch.Tensor]:
        """V^T V of the whole factor matrix, once per solver (implicit
        feedback only)."""
        if self._gram is None and self.params.implicit_prefs:
            self._gram = _global_gram(self._dev)
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
            self._dev, self._gram_dev(), torch.from_numpy(row_tgt).to(dev),
            torch.from_numpy(seg_arr).to(dev),
            torch.from_numpy(row_val).to(dev),
            torch.from_numpy(row_w).to(dev), p.reg, p.alpha,
            num_segments=b_pad, implicit_prefs=p.implicit_prefs,
            weighted_reg=p.weighted_reg, alpha_is_zero=(p.alpha == 0),
            chunk_rows=1024)
        t1 = time.perf_counter()
        cuda = dev.type == "cuda"
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        out = batched_spd_solve(A, rhs, diag=lam)
        t2 = time.perf_counter()
        if cuda:
            end.record()
        x = out[:b].cpu().numpy()
        self.last_solve = {
            "S": b_pad, "K": self.rank, "rows": b,
            "system_ms": (t1 - t0) * 1e3, "solve_call_ms": (t2 - t1) * 1e3,
            "solve_event_ms": start.elapsed_time(end) if cuda else None}
        return x
