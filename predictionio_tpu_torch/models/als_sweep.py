"""Device-batched k-fold x hyperparameter ALS evaluation sweep (port of
the reference's ``models/als_sweep.py``).

The fold split is built once on the host (``build_sweep_data``): fold
ids ride as a packed column beside the ratings in one padded-row layout
per side, and each (candidate, fold) unit's training weights are formed
on the device as ``w * (fold != f)``, so test entries weigh nothing and
no fold is built apart. Candidates that differ only in reg, alpha, seed
or num_iterations share a group; rank, the solver family and the
implicit / weighted-reg flags split the grid into groups
(``group_candidates``).

Each group trains its units together over a leading unit axis ``b``
(the reference ``vmap``s over it) through the train's own half-sweeps
(``models/als._half_sweep_dyn`` / ``_half_sweep_subspace_dyn``, which a
train runs at ``b = 1``): the Gramian assembly runs over the rows once
for all units, and each half-sweep flattens the units' ``[b, S, K, K]``
systems into one B1 solve of ``b * S`` systems, each unit's reg (and
count, under weighted reg) carried in the solve's per-system ``diag``
(one solve per rank block for the subspace solver). Units whose own ``num_iterations`` are done keep their
factors. The metric pass (held-out squared error; with ``rank_metrics``
the rank of every held-out item among all items, for precision@k and
the top-N MSE) runs over the same axis, and each candidate's sums are
pooled over its folds, as in the reference.

One process and one device: the reference's multi-process split of the
groups and its unit sharding over local devices belong to a later slice.
The reference's ``eval_*`` spans and counters are plain numbers in the
result (:class:`SweepResult`). Knobs, read as the reference reads them:
``PIO_EVAL_BATCH_MAX`` (units per launch, default 256) and
``PIO_EVAL_CHUNK_MB`` (the chunk buffers' budget, default 256 MiB).
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.models import als as als_mod
from predictionio_tpu_torch.models.als import (
    ALSParams, _auto_row_len, _row_positions, validate_solver,
)
from predictionio_tpu_torch.obs.eval_stats import (
    eval_batch_size, eval_candidates_counter, eval_compile_groups,
)
from predictionio_tpu_torch.obs.tracing import span
from predictionio_tpu_torch.utils.device import resolve_device, synchronize

#: units (candidate x fold) per launch; larger groups split into launches
#: of this many
BATCH_MAX_ENV = "PIO_EVAL_BATCH_MAX"
_DEFAULT_BATCH_MAX = 256
#: per-chunk buffer budget in MiB (the gather and score buffers scale
#: with units x chunk)
CHUNK_MB_ENV = "PIO_EVAL_CHUNK_MB"
_DEFAULT_CHUNK_MB = 256


# ---------------------------------------------------------------------------
# Shared fold-masked data layout (numpy, as in the reference)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SweepSide:
    """One side's padded rows plus the fold id of every rating, packed
    into the same positions as the values (fold -1 = padding)."""

    tgt: np.ndarray    # int32 [R, L]
    seg: np.ndarray    # int32 [R]
    val: np.ndarray    # float32 [R, L]
    w: np.ndarray      # float32 [R, L] (0 = padding)
    fold: np.ndarray   # int32 [R, L] (-1 = padding)
    n_segments: int
    row_len: int


@dataclasses.dataclass
class ALSSweepData:
    """The whole grid's training data, built once: both padded-row sides
    with fold columns, and the COO triples the metric pass reads."""

    by_user: SweepSide
    by_item: SweepSide
    user_idx: np.ndarray   # int32 [nnz]
    item_idx: np.ndarray   # int32 [nnz]
    ratings: np.ndarray    # float32 [nnz]
    fold_of: np.ndarray    # int32 [nnz]
    n_users: int
    n_items: int
    nnz: int
    k_folds: int


def _pack_sweep_side(seg_idx, tgt_idx, values, fold_of, n_segments,
                     row_len) -> SweepSide:
    order = np.argsort(seg_idx, kind="stable")
    rrow, col, n_rows, row_seg = _row_positions(
        seg_idx[order].astype(np.int64), row_len, n_segments)
    tgt = np.zeros((n_rows, row_len), np.int32)
    val = np.zeros((n_rows, row_len), np.float32)
    w = np.zeros((n_rows, row_len), np.float32)
    fold = np.full((n_rows, row_len), -1, np.int32)
    if rrow is not None:
        tgt[rrow, col] = tgt_idx[order]
        val[rrow, col] = values[order]
        w[rrow, col] = 1.0
        fold[rrow, col] = fold_of[order]
    return SweepSide(tgt=tgt, seg=row_seg, val=val, w=w, fold=fold,
                     n_segments=n_segments, row_len=row_len)


def build_sweep_data(user_idx: np.ndarray, item_idx: np.ndarray,
                     ratings: np.ndarray, fold_of: np.ndarray,
                     n_users: int, n_items: int,
                     row_len: Optional[int] = None) -> ALSSweepData:
    """Pack the full rating set once; fold membership rides along as a
    packed column instead of k separate data builds."""
    user_idx = np.ascontiguousarray(user_idx, np.int32)
    item_idx = np.ascontiguousarray(item_idx, np.int32)
    ratings = np.ascontiguousarray(ratings, np.float32)
    fold_of = np.ascontiguousarray(fold_of, np.int32)
    nnz = len(ratings)
    if row_len is None:
        row_len = _auto_row_len(nnz, max(n_users, n_items))
    return ALSSweepData(
        by_user=_pack_sweep_side(user_idx, item_idx, ratings, fold_of,
                                 n_users, row_len),
        by_item=_pack_sweep_side(item_idx, user_idx, ratings, fold_of,
                                 n_items, row_len),
        user_idx=user_idx, item_idx=item_idx, ratings=ratings,
        fold_of=fold_of, n_users=n_users, n_items=n_items, nnz=nnz,
        k_folds=int(fold_of.max()) + 1 if nnz else 0)


# ---------------------------------------------------------------------------
# Grouping
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupStatic:
    """What shapes a group's program: candidates differing only in
    reg/alpha/seed/num_iterations share a group; each distinct (rank,
    solver, block_size) family and flag set is its own."""

    rank: int
    implicit_prefs: bool
    weighted_reg: bool
    alpha_is_zero: bool
    chunk_size: int
    solver: str = "full"
    block_size: int = 0     # 0 for the full solver (no block structure)

    @property
    def label(self) -> str:
        return f"rank={self.rank}" + \
            ("/implicit" if self.implicit_prefs else "") + \
            (f"/sub{self.block_size}" if self.solver == "subspace" else "")


def group_candidates(candidates: Sequence[ALSParams]
                     ) -> "OrderedDict[GroupStatic, List[int]]":
    groups: "OrderedDict[GroupStatic, List[int]]" = OrderedDict()
    for i, p in enumerate(candidates):
        validate_solver(p)
        key = GroupStatic(
            rank=int(p.rank), implicit_prefs=bool(p.implicit_prefs),
            weighted_reg=bool(p.weighted_reg),
            alpha_is_zero=bool(p.implicit_prefs and p.alpha == 0),
            chunk_size=int(p.chunk_size),
            solver=str(p.solver),
            # block_size shapes only subspace groups: full-solver
            # candidates share one group whatever block_size they carry
            block_size=(int(p.block_size) if p.solver == "subspace" else 0))
        groups.setdefault(key, []).append(i)
    return groups


def _chunk_for_budget(per_element_bytes: int, n_rows: int) -> int:
    """Largest power-of-two chunk whose units x chunk buffer fits the
    ``PIO_EVAL_CHUNK_MB`` budget (the reference's rule)."""
    budget = int(os.environ.get(CHUNK_MB_ENV, _DEFAULT_CHUNK_MB)) << 20
    c = max(64, budget // max(per_element_bytes, 1))
    c = 1 << int(np.floor(np.log2(c)))
    return int(min(max(n_rows, 1), c))


# ---------------------------------------------------------------------------
# Unit-batched training
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Side:
    """One side's rows on the device."""

    tgt: torch.Tensor
    seg: torch.Tensor
    val: torch.Tensor
    w: torch.Tensor
    fold: torch.Tensor
    n_segments: int

    @classmethod
    def upload(cls, side: SweepSide, dev: torch.device) -> "_Side":
        return cls(*(torch.from_numpy(a).to(dev) for a in (
            side.tgt, side.seg, side.val, side.w, side.fold)),
            n_segments=side.n_segments)

    def unit_weights(self, fold_c: torch.Tensor) -> torch.Tensor:
        """``[b, R, L]``: each unit's fold held out (weight 0)."""
        return self.w[None] * (self.fold[None] != fold_c[:, None, None])


def _train_units(user: _Side, item: _Side, static: GroupStatic,
                 max_iters: int, fold_c, reg_c, alpha_c, iters_c,
                 V0: torch.Tensor, n_users: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train ``b`` units from their initial item factors ``V0 [b,
    n_items, K]``: ``max_iters`` iterations, each a user then an item
    half-sweep; a unit past its own iteration count keeps its
    factors."""
    b, _, k = V0.shape
    chunk_u = min(static.chunk_size, _chunk_for_budget(
        b * user.tgt.shape[1] * k * 4, user.tgt.shape[0]))
    chunk_i = min(static.chunk_size, _chunk_for_budget(
        b * item.tgt.shape[1] * k * 4, item.tgt.shape[0]))
    uw, iw = user.unit_weights(fold_c), item.unit_weights(fold_c)
    flags = dict(reg=reg_c, alpha=alpha_c,
                 implicit_prefs=static.implicit_prefs,
                 weighted_reg=static.weighted_reg,
                 alpha_is_zero=static.alpha_is_zero)
    if static.solver == "subspace":
        def half(x_prev, opp, side, w, chunk):
            return als_mod._half_sweep_subspace_dyn(
                x_prev, opp, side.tgt, side.seg, side.val, w,
                side.n_segments, chunk_rows=chunk,
                block_size=static.block_size, **flags)
    else:
        def half(x_prev, opp, side, w, chunk):
            return als_mod._half_sweep_dyn(
                opp, side.tgt, side.seg, side.val, w, side.n_segments,
                chunk_rows=chunk, **flags)
    U = V0.new_zeros((b, n_users, k))
    V = V0
    for it in range(max_iters):
        U2 = half(U, V, user, uw, chunk_u)
        V2 = half(V, U2, item, iw, chunk_i)
        keep = (iters_c > it)[:, None, None]
        U = torch.where(keep, U2, U)
        V = torch.where(keep, V2, V)
    return U, V


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def _unit_metrics(U: torch.Tensor, V: torch.Tensor, entries, fold_c,
                  rank_spec: Optional[Tuple[int, int, float]]) -> np.ndarray:
    """Per-unit raw sums ``[b, 5]`` (squared error, test count, hits,
    qualifying count, top-N squared error) over the held-out entries, so
    folds pool exactly as the sequential metric does.

    With ``rank_spec`` (query_num, precision_k, threshold) the rank of
    each held-out item is the number of items scoring strictly higher
    (the item is in the served top-m iff rank < m), all scores read from
    one product. (The reference compares the product's scores with the
    item's score summed apart, which can round higher or lower, so the
    item can outrank itself.) A user with no
    training rating solves to an all-zero row, whose held-out item would
    rank 0; the sequential path serves such a user nothing, so those
    users are masked out of the hits."""
    u_idx, i_idx, vals, fold_e = entries
    b, _, k = U.shape
    n_items = V.shape[1]
    n = u_idx.shape[0]
    if rank_spec is None:
        chunk = _chunk_for_budget(b * max(k, 1) * 4, n)
    else:
        # the [b, C, n_items] score buffer dominates
        chunk = _chunk_for_budget(b * n_items * 4, n)
        query_num, prec_k, threshold = rank_spec
        qn_eff = min(query_num, n_items)
        cut = min(prec_k, qn_eff)
    sums = torch.zeros((b, 5), dtype=torch.float64, device=U.device)
    Vt = V.transpose(1, 2)
    for lo in range(0, n, chunk):
        u, i = u_idx[lo:lo + chunk], i_idx[lo:lo + chunk]
        v, f = vals[lo:lo + chunk], fold_e[lo:lo + chunk]
        uvec = U[:, u]                                         # [b, C, K]
        s_i = (uvec * V[:, i]).sum(dim=-1)                     # [b, C]
        test = f[None] == fold_c[:, None]
        testf = test.to(s_i.dtype)
        sums[:, 0] += (testf * (s_i - v) ** 2).sum(dim=-1)
        sums[:, 1] += testf.sum(dim=-1)
        if rank_spec is None:
            continue
        scores = torch.matmul(uvec, Vt)                        # [b, C, I]
        own = scores.gather(-1, i.long()[None, :, None].expand(b, -1, 1))
        rk = (scores > own).sum(dim=-1)
        pred = torch.where(rk < qn_eff, s_i, torch.zeros_like(s_i))
        qual = test & (v >= threshold)[None]
        known = (uvec != 0).any(dim=-1)
        hit = qual & known & (rk < cut)
        sums[:, 2] += hit.sum(dim=-1)
        sums[:, 3] += qual.sum(dim=-1)
        sums[:, 4] += (testf * (pred - v) ** 2).sum(dim=-1)
    return sums.cpu().numpy()


# ---------------------------------------------------------------------------
# The sweep runner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CandidateResult:
    """Pooled-over-folds metrics and cost attribution for one
    candidate."""

    params: ALSParams
    group: str
    wall_s: float
    heldout_rmse: float
    n_test: int
    precision: Optional[float] = None
    n_qual: Optional[int] = None
    topn_mse: Optional[float] = None

    def to_json_dict(self) -> dict:
        return {
            "group": self.group,
            "wallTimeS": round(self.wall_s, 4),
            "heldoutRmse": self.heldout_rmse,
            "nTest": self.n_test,
            **({"precision": self.precision, "nQual": self.n_qual,
                "topnMse": self.topn_mse}
               if self.precision is not None else {}),
        }


@dataclasses.dataclass
class SweepResult:
    """The candidates' results in input order, and what the sweep did:
    groups, units per launch, the mode, and the seconds of the upload,
    the trains and the metric passes (the reference's ``eval_*`` spans as
    plain numbers)."""

    candidates: List[CandidateResult]
    n_groups: int
    batch_sizes: List[int]
    mode: str
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


def run_sweep(data: ALSSweepData, candidates: Sequence[ALSParams], *,
              rank_metrics: Optional[Tuple[int, int, float]] = None,
              batched: bool = True, warm_start: bool = False,
              device=None) -> SweepResult:
    """Evaluate every candidate over every fold on ``device`` (default
    ``cuda``).

    ``rank_metrics`` (query_num, precision_k, threshold) adds
    full-catalog precision@k and the top-N MSE (a ``[units, chunk,
    n_items]`` score pass; the held-out RMSE alone reads only the
    held-out entries). ``batched=False`` runs the same code one
    (candidate, fold) unit at a time. ``warm_start=True`` starts each
    group's item factors from the previous (smaller-rank) group's
    trained factors of the same fold, padded with fresh noise: an
    accuracy/speed knob that departs from seeded-init parity, off by
    default."""
    if not candidates:
        raise ValueError("candidates must not be empty")
    if data.k_folds < 1:
        raise ValueError("sweep data has no folds (empty rating set?)")
    dev = resolve_device(device)
    mode = "batched" if batched else "sequential"
    k_folds = data.k_folds
    group_items = list(group_candidates(candidates).items())
    if warm_start:
        group_items.sort(key=lambda kv: kv[0].rank)

    t0 = time.perf_counter()
    user = _Side.upload(data.by_user, dev)
    item = _Side.upload(data.by_item, dev)
    entries = tuple(torch.from_numpy(a).to(dev) for a in (
        data.user_idx, data.item_idx, data.ratings, data.fold_of))
    synchronize(dev)
    seconds = {"upload": time.perf_counter() - t0, "train": 0.0,
               "metric": 0.0}

    batch_max = int(os.environ.get(BATCH_MAX_ENV, _DEFAULT_BATCH_MAX))
    results: Dict[int, CandidateResult] = {}
    batch_sizes: List[int] = []
    prev_v: Dict[int, np.ndarray] = {}      # fold -> trained V (warm start)

    for gi, (static, members) in enumerate(group_items):
        group_label = f"g{gi}:{static.label}"
        units = [(ci, f) for ci in members for f in range(k_folds)]
        b = min(len(units), batch_max) if batched else 1
        max_iters = max(int(candidates[ci].num_iterations)
                        for ci in members)
        sums = {ci: np.zeros(5, np.float64) for ci in members}
        t_group = time.perf_counter()
        for lo in range(0, len(units), b):
            launch = units[lo:lo + b]

            def column(get, dtype):
                return torch.tensor([get(ci, f) for ci, f in launch],
                                    dtype=dtype, device=dev)

            fold_c = column(lambda ci, f: f, torch.int32)
            reg_c = column(lambda ci, f: candidates[ci].reg, torch.float32)
            alpha_c = column(lambda ci, f: candidates[ci].alpha,
                             torch.float32)
            iters_c = column(lambda ci, f: candidates[ci].num_iterations,
                             torch.int64)
            V0 = _initial_factors(launch, candidates, static.rank,
                                  data.n_items, prev_v, warm_start, dev)
            t0 = time.perf_counter()
            with span("eval_train_group"):
                U, V = _train_units(user, item, static, max_iters, fold_c,
                                    reg_c, alpha_c, iters_c, V0,
                                    data.n_users)
                synchronize(dev)
            seconds["train"] += time.perf_counter() - t0
            batch_sizes.append(len(launch))
            eval_batch_size().observe(len(launch))
            t0 = time.perf_counter()
            with span("eval_metrics"):
                out = _unit_metrics(U, V, entries, fold_c, rank_metrics)
            seconds["metric"] += time.perf_counter() - t0
            for j, (ci, _f) in enumerate(launch):
                sums[ci] += out[j]
            if warm_start:
                v_host = V.cpu().numpy()
                for j, (_ci, f) in enumerate(launch):
                    prev_v[f] = v_host[j]         # the latest group wins
        group_wall = time.perf_counter() - t_group

        for ci in members:
            se, nt, hits, nq, tse = sums[ci]
            res = CandidateResult(
                params=candidates[ci], group=group_label,
                wall_s=group_wall / len(members),
                heldout_rmse=float(np.sqrt(se / nt)) if nt else float("nan"),
                n_test=int(nt))
            if rank_metrics is not None:
                qn, pk, _thr = rank_metrics
                denom = min(pk, min(qn, data.n_items))
                res.precision = (float(hits / (denom * nq)) if nq
                                 else float("nan"))
                res.n_qual = int(nq)
                res.topn_mse = float(tse / nt) if nt else float("nan")
            results[ci] = res

    eval_candidates_counter().inc(len(candidates), mode=mode)
    eval_compile_groups().set(len(group_items))
    return SweepResult(
        candidates=[results[i] for i in range(len(candidates))],
        n_groups=len(group_items), batch_sizes=batch_sizes, mode=mode,
        seconds=seconds)


def _initial_factors(launch, candidates, rank: int, n_items: int,
                     prev_v: Dict[int, np.ndarray], warm_start: bool,
                     dev: torch.device) -> torch.Tensor:
    """``[b, n_items, rank]``: each unit's seeded initial item factors
    (``models/als._init_item_factors``, drawn once per seed), or its
    warm start."""
    if warm_start:
        return torch.from_numpy(np.stack([
            _warm_init(prev_v.get(f), rank, n_items,
                       int(candidates[ci].seed), f)
            for ci, f in launch])).to(dev, torch.float32)
    by_seed: Dict[int, torch.Tensor] = {}
    for ci, _f in launch:
        seed = int(candidates[ci].seed)
        if seed not in by_seed:
            by_seed[seed] = als_mod._init_item_factors(
                n_items, n_items, rank, seed, dev)
    return torch.stack([by_seed[int(candidates[ci].seed)]
                        for ci, _f in launch])


def _warm_init(v_prev: Optional[np.ndarray], rank: int, n_items: int,
               seed: int, fold: int) -> np.ndarray:
    """V0 for a warm-started unit: the previous group's fold factors in
    the leading columns, fresh scaled noise in the rest (or everywhere
    when no previous group trained this fold)."""
    rng = np.random.default_rng(seed * 1009 + fold)
    v0 = (rng.standard_normal((n_items, rank)).astype(np.float32)
          / np.sqrt(rank))
    if v_prev is not None:
        keep = min(rank, v_prev.shape[1])
        v0[:, :keep] = v_prev[:n_items, :keep]
    return v0
