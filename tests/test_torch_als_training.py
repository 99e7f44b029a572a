"""ALS training of the port against the JAX package's.

* The host-side layout: ``shard_rows`` and ``ALSData.build`` give arrays
  equal to the reference's (one shard), ``coo_digest`` is equal, and
  ``assign_indices`` gives the same vocab and codes.
* ``train_als`` from the reference's initial item factors (computed here
  as the reference computes them, ``models/als.py:620-628``) matches the
  reference's ``train_als`` on a one-device mesh after 5 iterations, for
  explicit feedback and implicit feedback with alpha in {0, 1}, with
  ``weighted_reg`` on and off, under the ``full`` solver and the
  ``subspace`` solver at rank 10 with block 4 (blocks at 0, 4 and 6: the
  last one shifted left to end at the rank).
* ``rmse`` is equal.

Tolerance: factors within atol 5e-5 + rtol 1e-4 of the reference's, and
the two models' predictions on every training rating within 2e-4
(5 alternating sweeps in f32; each solve and Gramian sums in another
order, and the differences pass through the sweeps: about 1e-5 at most
on these inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import predictionio_tpu.models.als as ref_als
import predictionio_tpu_torch.models.als as port_als
from predictionio_tpu.data.bimap import assign_indices as ref_assign
from predictionio_tpu_torch.data.bimap import assign_indices as port_assign

N_USERS, N_ITEMS, NNZ = 90, 60, 1400
ATOL, RTOL, PRED_TOL = 5e-5, 1e-4, 2e-4


def _ratings(seed=5, implicit=False):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, N_USERS, NNZ).astype(np.int32)
    i = rng.integers(0, N_ITEMS, NNZ).astype(np.int32)
    u[:N_USERS] = np.arange(N_USERS)          # every id occurs
    i[:N_ITEMS] = np.arange(N_ITEMS)
    if implicit:
        r = rng.choice(np.asarray([-1.0, 1.0, 2.0, 4.0], np.float32), NNZ)
    else:
        r = rng.integers(1, 6, NNZ).astype(np.float32)
    return u, i, r


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]), axis_names=("data",))


def _rows_equal(a, b):
    for f in ("tgt", "val", "w", "seg"):
        assert np.array_equal(getattr(a, f), np.asarray(getattr(b, f))), f
    assert (a.seg_per_shard, a.n_segments, a.row_len) == (
        b.seg_per_shard, b.n_segments, b.row_len)


@pytest.mark.parametrize("row_len", [None, 16])
def test_shard_rows_and_build_equal_reference(row_len):
    u, i, r = _ratings()
    w = np.random.default_rng(1).random(NNZ).astype(np.float32)
    _rows_equal(port_als.shard_rows(u, i, r, N_USERS, weights=w,
                                    row_len=row_len),
                ref_als.shard_rows(u, i, r, N_USERS, 1, weights=w,
                                   row_len=row_len))
    got = port_als.ALSData.build(u, i, r, N_USERS, N_ITEMS, row_len=row_len)
    want = ref_als.ALSData.build(u, i, r, N_USERS, N_ITEMS, 1,
                                 row_len=row_len)
    _rows_equal(got.by_user, want.by_user)
    _rows_equal(got.by_item, want.by_item)
    for f in ("n_users", "n_items", "n_users_pad", "n_items_pad", "nnz",
              "digest"):
        assert getattr(got, f) == getattr(want, f), f


def test_coo_digest_equal_and_order_free():
    u, i, r = _ratings()
    d = port_als.coo_digest(u, i, r)
    assert d == ref_als.coo_digest(u, i, r)
    perm = np.random.default_rng(2).permutation(NNZ)
    assert port_als.coo_digest(u[perm].astype(np.int64), i[perm],
                               r[perm]) == d
    r2 = r.copy()
    r2[7] += 1.0
    assert port_als.coo_digest(u, i, r2) != d


@pytest.mark.parametrize("ids", [
    np.asarray(["u10", "u2", "u10", "a", "zz", "u2"]),            # U, ASCII
    np.asarray(["user-%d" % n for n in (5, 3, 5, 400000)], object),
    np.asarray(["é", "e", "é", "ß"]),                              # non-ASCII
    np.asarray([f"{n}" for n in np.random.default_rng(0).integers(
        0, 500, 3000)]),
])
def test_assign_indices_equal_reference(ids):
    pv, pc = port_assign(ids)
    rv, rc = ref_assign(ids)
    assert list(pv) == list(rv)
    assert np.array_equal(pc, rc) and pc.dtype == np.int32
    assert list(pv) == sorted(pv)
    assert np.array_equal(pv[pc], np.asarray(ids))


def test_assign_indices_refuses_null_id():
    with pytest.raises(ValueError, match="null"):
        port_assign(np.asarray(["a", None, "b"], object))


def _reference_init_V(params, n_items_pad, n_items):
    key = jax.random.PRNGKey(params.seed)
    V = (jax.random.normal(key, (n_items_pad, params.rank), jnp.float32)
         / jnp.sqrt(jnp.asarray(params.rank, jnp.float32)))
    V = jnp.where((jnp.arange(n_items_pad) < n_items)[:, None], V, 0.0)
    return np.asarray(V)


CASES = {
    "explicit": dict(),
    "implicit_alpha0": dict(implicit_prefs=True, alpha=0.0),
    "implicit_alpha1": dict(implicit_prefs=True, alpha=1.0),
}


@pytest.mark.parametrize("solver", ["full", "subspace"])
@pytest.mark.parametrize("weighted_reg", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_train_als_matches_reference(mesh1, case, weighted_reg, solver):
    kw = CASES[case]
    u, i, r = _ratings(implicit=kw.get("implicit_prefs", False))
    params = dict(rank=10, num_iterations=5, reg=0.05, seed=11,
                  weighted_reg=weighted_reg, chunk_size=64, solver=solver,
                  block_size=4, **kw)
    ref_params = ref_als.ALSParams(**params)
    data_ref = ref_als.ALSData.build(u, i, r, N_USERS, N_ITEMS, 1)
    U_ref, V_ref = ref_als.train_als(mesh1, data_ref, ref_params)

    data = port_als.ALSData.build(u, i, r, N_USERS, N_ITEMS)
    init_V = _reference_init_V(ref_params, data.n_items_pad, data.n_items)
    U, V = port_als.train_als(data, port_als.ALSParams(**params),
                              device="cpu", init_V=init_V)
    assert U.shape == U_ref.shape and V.shape == V_ref.shape
    np.testing.assert_allclose(U, U_ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(V, V_ref, atol=ATOL, rtol=RTOL)
    pred = np.einsum("nk,nk->n", U[u], V[i])
    pred_ref = np.einsum("nk,nk->n", U_ref[u], V_ref[i])
    assert np.abs(pred - pred_ref).max() <= PRED_TOL
    assert port_als.rmse(U, V, u, i, r) == ref_als.rmse(U, V, u, i, r)


def test_block_starts_and_validate_solver_as_reference():
    for rank, block in ((10, 4), (64, 16), (8, 16), (17, 5), (1, 1)):
        assert port_als.block_starts(rank, block) == \
            ref_als.block_starts(rank, block)
    with pytest.raises(ValueError, match="unknown ALS solver"):
        port_als.validate_solver(port_als.ALSParams(solver="sub"))
    with pytest.raises(ValueError, match="block_size"):
        port_als.validate_solver(port_als.ALSParams(solver="subspace",
                                                    block_size=0))


def test_seeded_init_is_deterministic_and_zeroes_pads():
    import torch

    a = port_als._init_item_factors(5, 8, 3, 7, torch.device("cpu"))
    b = port_als._init_item_factors(5, 8, 3, 7, torch.device("cpu"))
    assert torch.equal(a, b) and (a[5:] == 0).all() and (a[:5] != 0).all()
