"""The port's batched evaluation sweep (``models/als_sweep``) held against
the reference's on the same numpy-seeded ratings and the reference's
initial item factors (``jax.random``, handed to the port through its
``_init_item_factors``).

Tolerances are the reference's own (``tests/test_eval_sweep.py``):
held-out RMSE within 1e-4, equal test and qualifying counts, hits within
max(1, n_qual // 100), the top-N MSE within 0.05, and the same best
candidate. The rank metrics are held to a recompute from the reference's
own trained factors: the reference ranks a held-out item by comparing
the product's scores with the item's score summed apart, which rounds
differently and lets the item outrank itself; the port ranks within one
product (``_unit_metrics``), and the recompute does the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.core import cross_validation as ref_cv
from predictionio_tpu.models import als_sweep as ref_sweep
from predictionio_tpu.models.als import ALSParams as RefParams
from predictionio_tpu_torch.core import cross_validation as port_cv
from predictionio_tpu_torch.models import als as port_als
from predictionio_tpu_torch.models import als_sweep as port_sweep
from predictionio_tpu_torch.models.als import ALSParams as PortParams
from predictionio_tpu_torch.ops import segment as port_segment


def _reference_init_V(seed, n_items, k):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (n_items, k), jnp.float32)
                      / jnp.sqrt(jnp.float32(k)))


@pytest.fixture(autouse=True)
def reference_init(monkeypatch):
    """The port's seeded init hands out the reference's initial V."""
    def init(n_items, n_items_pad, k, seed, device):
        V = np.zeros((n_items_pad, k), np.float32)
        V[:n_items] = _reference_init_V(seed, n_items, k)
        return torch.from_numpy(V).to(device)

    monkeypatch.setattr(port_als, "_init_item_factors", init)


def _synthetic(nu, ni, nnz, seed=0):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, nu, nnz).astype(np.int32)
    items = rng.integers(0, ni, nnz).astype(np.int32)
    lu, lv = rng.normal(size=(nu, 3)), rng.normal(size=(ni, 3))
    ratings = np.clip(np.round(
        2.5 + np.einsum("nk,nk->n", lu[users], lv[items])), 1, 5
    ).astype(np.float32)
    return users, items, ratings


def _both(nu, ni, nnz, k_folds, seed):
    users, items, ratings = _synthetic(nu, ni, nnz, seed=seed)
    fold_of = ref_cv.fold_assignments(k_folds, nnz)
    return (ref_sweep.build_sweep_data(users, items, ratings, fold_of,
                                       nu, ni),
            port_sweep.build_sweep_data(users, items, ratings, fold_of,
                                        nu, ni))


def _cands(cls, ranks, regs, **kw):
    return [cls(rank=r, reg=g, **kw) for r in ranks for g in regs]


# -- fold helpers ---------------------------------------------------------------

@pytest.mark.parametrize("k,n", [(1, 5), (3, 7), (4, 21), (5, 5)])
def test_fold_helpers_equal_the_reference(k, n):
    assert np.array_equal(port_cv.fold_assignments(k, n),
                          ref_cv.fold_assignments(k, n))
    assert np.array_equal(port_cv.fold_masks(k, n), ref_cv.fold_masks(k, n))
    for (pt, pe), (rt, re_) in zip(port_cv.split_data(k, n),
                                   ref_cv.split_data(k, n)):
        assert np.array_equal(pt, rt) and np.array_equal(pe, re_)
    items = [f"x{j}" for j in range(n)]
    assert list(port_cv.k_fold(items, k)) == list(ref_cv.k_fold(items, k))


@pytest.mark.parametrize("call", [lambda cv: list(cv.split_data(5, 3)),
                                  lambda cv: list(cv.k_fold([1, 2], 3)),
                                  lambda cv: cv.fold_assignments(4, 2),
                                  lambda cv: list(cv.split_data(0, 10))])
def test_fold_helpers_reject_what_the_reference_rejects(call):
    for cv in (ref_cv, port_cv):
        with pytest.raises(ValueError):
            call(cv)


def test_sweep_data_layout_equals_the_reference():
    ref_data, port_data = _both(31, 17, 800, 3, seed=2)
    for side in ("by_user", "by_item"):
        r, p = getattr(ref_data, side), getattr(port_data, side)
        for name in ("tgt", "seg", "val", "w", "fold"):
            assert np.array_equal(getattr(r, name), getattr(p, name))
    assert port_data.k_folds == ref_data.k_folds == 3


# -- the unit-batched segment ops ------------------------------------------------

def test_unit_segment_ops_equal_the_single_unit_ops():
    """``b`` units in one pass equal each unit run alone (``b = 1``, as a
    train runs them): the unit axis mixes nothing across units."""
    g = torch.Generator().manual_seed(0)
    b, f, k, r, l, s = 3, 9, 4, 13, 5, 6
    factors = torch.randn(b, f, k, generator=g)
    tgt = torch.randint(0, f, (r, l), generator=g)
    seg = torch.sort(torch.randint(0, s, (r,), generator=g)).values
    val = torch.randn(r, l, generator=g)
    w = (torch.rand(b, r, l, generator=g) > 0.3).float()
    x = torch.randn(b, s, 2, generator=g)
    pred = torch.randn(b, r, l, generator=g)
    rhs_val = torch.randn(b, r, l, generator=g)
    gram, rhs, cnt = port_segment.rows_gram_rhs(
        factors, tgt, seg, val[None], w, s, chunk_rows=4)
    bgram, brhs = port_segment.block_gram_rhs(
        factors[..., :2], x, tgt, seg, pred, rhs_val, w, s, chunk_rows=3)
    bpred = port_segment.row_predict_add(factors[..., :2], x, tgt, seg,
                                         pred, chunk_rows=3)
    for u in range(b):
        one = port_segment.rows_gram_rhs(factors[u:u + 1], tgt, seg,
                                         val[None], w[u:u + 1], s,
                                         chunk_rows=4)
        for got, want in zip((gram[u], rhs[u], cnt[u]), one):
            assert torch.allclose(got, want[0], atol=1e-6)
        one = port_segment.block_gram_rhs(
            factors[u:u + 1, :, :2], x[u:u + 1], tgt, seg, pred[u:u + 1],
            rhs_val[u:u + 1], w[u:u + 1], s, chunk_rows=3)
        for got, want in zip((bgram[u], brhs[u]), one):
            assert torch.allclose(got, want[0], atol=1e-6)
        assert torch.allclose(bpred[u], port_segment.row_predict_add(
            factors[u:u + 1, :, :2], x[u:u + 1], tgt, seg, pred[u:u + 1],
            chunk_rows=3)[0], atol=1e-6)


# -- the sweep against the reference -------------------------------------------

def _reference_factors(ref_data, cands, static, launch):
    """U, V of each (candidate, fold) unit as the reference trains them,
    from its own jitted train function."""
    b = len(launch)
    bu, bi = ref_data.by_user, ref_data.by_item
    max_iters = max(cands[ci].num_iterations for ci, _ in launch)
    fn = ref_sweep._build_train_fn(
        static, ref_data.n_users, ref_data.n_items, max_iters, b,
        (bu.tgt.shape[0], bi.tgt.shape[0], bu.row_len), False)
    data_args = [jnp.asarray(a) for a in (
        bu.tgt, bu.seg, bu.val, bu.w, bu.fold,
        bi.tgt, bi.seg, bi.val, bi.w, bi.fold)]
    cand_args = (
        np.asarray([f for _, f in launch], np.int32),
        np.asarray([cands[ci].reg for ci, _ in launch], np.float32),
        np.asarray([cands[ci].alpha for ci, _ in launch], np.float32),
        np.asarray([cands[ci].num_iterations for ci, _ in launch], np.int32),
        np.asarray([cands[ci].seed for ci, _ in launch], np.int32))
    U, V = fn(*data_args, *cand_args)
    return np.asarray(U), np.asarray(V)


def _rank_sums(U, V, data, fold, rank_spec):
    """(hits, qualifying, top-N squared error) of one unit, ranking each
    held-out item within one product of its user's scores."""
    qn, pk, thr = rank_spec
    qn_eff = min(qn, data.n_items)
    cut = min(pk, qn_eff)
    test = data.fold_of == fold
    u, i, v = data.user_idx[test], data.item_idx[test], data.ratings[test]
    scores = U[u] @ V.T
    own = scores[np.arange(len(i)), i]
    rk = (scores > own[:, None]).sum(axis=1)
    s_i = (U[u] * V[i]).sum(axis=1)
    pred = np.where(rk < qn_eff, s_i, 0.0)
    qual = v >= thr
    known = np.any(U[u] != 0, axis=1)
    hits = int(np.sum(qual & known & (rk < cut)))
    return hits, int(qual.sum()), float(np.sum((pred - v) ** 2.0))


def _reference_rank_metrics(ref_data, cands, rank_spec):
    """Per candidate (hits, n_qual, topn_mse) from the reference's
    trained factors, pooled over folds."""
    out = []
    groups = ref_sweep.group_candidates(cands)
    by_cand = {}
    for static, members in groups.items():
        launch = [(ci, f) for ci in members
                  for f in range(ref_data.k_folds)]
        U, V = _reference_factors(ref_data, cands, static, launch)
        for j, (ci, f) in enumerate(launch):
            h, q, t = _rank_sums(U[j], V[j], ref_data, f, rank_spec)
            acc = by_cand.setdefault(ci, [0, 0, 0.0])
            acc[0] += h
            acc[1] += q
            acc[2] += t
    for ci in range(len(cands)):
        h, q, t = by_cand[ci]
        out.append((h, q, t / ref_data.nnz))
    return out


_KINDS = {
    "explicit": {},
    "implicit": {"implicit_prefs": True, "alpha": 1.0},
    "implicit_alpha0": {"implicit_prefs": True, "alpha": 0.0},
    "subspace": {"solver": "subspace", "block_size": 2},
    "subspace_implicit": {"solver": "subspace", "block_size": 2,
                          "implicit_prefs": True},
}


def _best(cands):
    return min(range(len(cands)), key=lambda i: cands[i].heldout_rmse)


@pytest.mark.parametrize("batched", [True, False],
                         ids=["batched", "sequential"])
@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_run_sweep_matches_the_reference(kind, batched):
    nu, ni, nnz = 50, 30, 1500
    ref_data, port_data = _both(nu, ni, nnz, 3, seed=1)
    kw = dict(num_iterations=3, chunk_size=2048, **_KINDS[kind])
    ref_cands = _cands(RefParams, (3, 5), (0.02, 0.2), **kw)
    port_cands = _cands(PortParams, (3, 5), (0.02, 0.2), **kw)
    spec = (5, 4, 2.0)
    ref = ref_sweep.run_sweep(ref_data, ref_cands, rank_metrics=spec)
    port = port_sweep.run_sweep(port_data, port_cands, rank_metrics=spec,
                                batched=batched, device="cpu")
    assert port.mode == ("batched" if batched else "sequential")
    assert port.n_groups == ref.n_groups == 2
    assert port.batch_sizes == ([6, 6] if batched else [1] * 12)
    assert set(port.seconds) == {"upload", "train", "metric"}
    rank_ref = _reference_rank_metrics(ref_data, ref_cands, spec)
    denom = min(4, min(5, ni))
    for r, p, (hits_r, nq_r, tmse_r) in zip(ref.candidates, port.candidates,
                                            rank_ref):
        assert p.heldout_rmse == pytest.approx(r.heldout_rmse, abs=1e-4)
        assert p.n_test == r.n_test and p.n_qual == r.n_qual == nq_r
        hits_p = round(p.precision * denom * p.n_qual)
        assert abs(hits_p - hits_r) <= max(1, p.n_qual // 100), \
            (hits_p, hits_r, p.n_qual)
        assert p.topn_mse == pytest.approx(tmse_r, abs=0.05)
        assert p.group == r.group
    assert _best(port.candidates) == _best(ref.candidates)


def test_rank_three_matches_the_reference_sweep_itself():
    """At rank 3 the reference's two score sums agree here, so its own
    precision and top-N MSE hold the port directly."""
    ref_data, port_data = _both(50, 30, 1500, 3, seed=1)
    ref = ref_sweep.run_sweep(
        ref_data, _cands(RefParams, (3,), (0.02, 0.2), num_iterations=3),
        rank_metrics=(5, 4, 2.0))
    port = port_sweep.run_sweep(
        port_data, _cands(PortParams, (3,), (0.02, 0.2), num_iterations=3),
        rank_metrics=(5, 4, 2.0), device="cpu")
    for r, p in zip(ref.candidates, port.candidates):
        assert p.precision == pytest.approx(r.precision, abs=1e-9)
        assert p.topn_mse == pytest.approx(r.topn_mse, abs=1e-4)


def test_sweep_pools_folds_and_attributes_cost():
    ref_data, port_data = _both(31, 17, 800, 2, seed=2)
    res = port_sweep.run_sweep(
        port_data, [PortParams(rank=4, num_iterations=2, reg=g)
                    for g in (0.1, 0.3)], device="cpu")
    for c in res.candidates:
        assert np.isfinite(c.heldout_rmse)
        assert c.n_test == 800          # every rating held out exactly once
        assert c.wall_s > 0 and c.group.endswith("rank=4")
        assert c.precision is None
    assert res.batch_sizes == [4]        # 2 candidates x 2 folds, one launch


def test_mixed_iterations_share_a_group():
    ref_data, port_data = _both(23, 13, 500, 2, seed=4)
    ref = ref_sweep.run_sweep(ref_data, [RefParams(rank=4, num_iterations=it,
                                                   reg=0.1) for it in (1, 4)])
    port = port_sweep.run_sweep(
        port_data, [PortParams(rank=4, num_iterations=it, reg=0.1)
                    for it in (1, 4)], device="cpu")
    assert port.n_groups == 1 and port.batch_sizes == [4]
    assert port.candidates[0].heldout_rmse != pytest.approx(
        port.candidates[1].heldout_rmse, abs=1e-9)
    for r, p in zip(ref.candidates, port.candidates):
        assert p.heldout_rmse == pytest.approx(r.heldout_rmse, abs=1e-4)


def test_groups_split_by_solver_family():
    ref_data, port_data = _both(21, 11, 400, 2, seed=7)

    def cands(cls):
        return [cls(rank=4, num_iterations=2, reg=0.1),
                cls(rank=4, num_iterations=2, reg=0.2, block_size=9),
                cls(rank=4, num_iterations=2, reg=0.1, solver="subspace",
                    block_size=2),
                cls(rank=4, num_iterations=2, reg=0.1, solver="subspace",
                    block_size=3)]

    ref = ref_sweep.run_sweep(ref_data, cands(RefParams))
    port = port_sweep.run_sweep(port_data, cands(PortParams), device="cpu")
    assert port.n_groups == ref.n_groups == 3
    groups = [c.group for c in port.candidates]
    assert groups == [c.group for c in ref.candidates]
    assert groups[0] == groups[1]
    assert groups[2].endswith("/sub2") and groups[3].endswith("/sub3")
    for r, p in zip(ref.candidates, port.candidates):
        assert p.heldout_rmse == pytest.approx(r.heldout_rmse, abs=1e-4)
    with pytest.raises(ValueError, match="unknown ALS solver"):
        port_sweep.run_sweep(port_data, [PortParams(rank=4, solver="nope")],
                             device="cpu")


def test_cold_users_are_misses_not_free_hits():
    """A user whose every rating is held out trains to an all-zero row;
    its held-out item must count as a miss, as the sequential path
    serves such a user nothing."""
    n = 10
    users = np.arange(n, dtype=np.int32)
    items = np.arange(n, dtype=np.int32) % 4
    ratings = np.full(n, 5.0, np.float32)
    data = port_sweep.build_sweep_data(users, items, ratings,
                                       port_cv.fold_assignments(2, n), n, 4)
    res = port_sweep.run_sweep(
        data, [PortParams(rank=2, num_iterations=2, reg=0.1)],
        rank_metrics=(3, 3, 2.0), device="cpu")
    assert res.candidates[0].n_qual == n
    assert res.candidates[0].precision == 0.0


@pytest.mark.parametrize("prev_rank", [None, 2, 5])
def test_warm_init_is_bit_equal_to_the_reference(prev_rank):
    prev = (None if prev_rank is None else np.random.default_rng(3)
            .standard_normal((9, prev_rank)).astype(np.float32))
    got = port_sweep._warm_init(prev, 4, 9, seed=7, fold=2)
    want = ref_sweep._warm_init(prev, 4, 9, seed=7, fold=2)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_warm_start_runs_and_converges_no_worse():
    _, data = _both(40, 22, 1200, 2, seed=3)
    cands = [PortParams(rank=r, num_iterations=4, reg=0.1) for r in (3, 5)]
    cold = port_sweep.run_sweep(data, cands, device="cpu")
    warm = port_sweep.run_sweep(data, cands, warm_start=True, device="cpu")
    for cc, cw in zip(cold.candidates, warm.candidates):
        assert np.isfinite(cw.heldout_rmse)
        assert cw.heldout_rmse < cc.heldout_rmse * 1.5 + 1.0


# -- B1 launches --------------------------------------------------------------

def _counting_solve(monkeypatch):
    """Wrap the half-sweeps' solve as the CPU rehearsals wrap the
    trains': every call is one launch on the card, with its system
    count."""
    calls = []
    real = port_als.batched_spd_solve

    def counted(A, b, jitter=1e-6, diag=None):
        calls.append((A.shape[0], A.shape[-1], diag.shape[0]))
        return real(A, b, jitter=jitter, diag=diag)

    monkeypatch.setattr(port_als, "batched_spd_solve", counted)
    return calls


@pytest.mark.parametrize("batched", [True, False],
                         ids=["batched", "sequential"])
def test_one_solve_per_half_sweep_over_every_unit(monkeypatch, batched):
    nu, ni, iters = 31, 17, 3
    _, data = _both(nu, ni, 800, 3, seed=5)
    calls = _counting_solve(monkeypatch)
    cands = _cands(PortParams, (3, 4), (0.05, 0.1, 0.5),
                   num_iterations=iters)
    res = port_sweep.run_sweep(data, cands, device="cpu")
    if not batched:
        calls.clear()
        res = port_sweep.run_sweep(data, cands, batched=False, device="cpu")
    units = 3 * 3                        # candidates of a group x folds
    b = units if batched else 1
    assert len(calls) == 2 * iters * (res.n_groups if batched
                                      else 2 * units)
    for j, (s, k, n_diag) in enumerate(calls):
        side = nu if (j % 2 == 0) else ni
        assert s == n_diag == b * side
        assert k in (3, 4)


def test_subspace_solves_once_per_block(monkeypatch):
    nu, ni, iters = 21, 11, 2
    _, data = _both(nu, ni, 400, 2, seed=8)
    calls = _counting_solve(monkeypatch)
    port_sweep.run_sweep(data, [PortParams(rank=5, num_iterations=iters,
                                           reg=g, solver="subspace",
                                           block_size=2)
                                for g in (0.1, 0.2)], device="cpu")
    blocks = len(port_als.block_starts(5, 2))
    assert len(calls) == 2 * iters * blocks
    assert {k for _, k, _ in calls} == {2}
    assert {s for s, _, _ in calls} == {4 * nu, 4 * ni}


def test_run_sweep_without_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rule is moot")
    _, data = _both(5, 4, 20, 2, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_sweep.run_sweep(data, [PortParams(rank=2, num_iterations=1)])
