"""The classifiers, cooccurrence and the eval sweep of the port over a
mesh of positions (ROADMAP A12, part 2), held against the JAX package
and against the port's own one-process runs, on the CPU.

* One process: the naive Bayes count's mesh branch, logistic
  regression and the forest on an 8-position mesh (the CPU repeated)
  against the reference's ``mesh8`` fits; the forest also on a 4 x 2
  mesh (trees shard over the first axis only); cooccurrence on one axis
  (8) and on 4 x 2 against the reference's sharded ``shard_map`` path.
* Two processes of one gloo group (``tests/torch_distributed_child.py``
  phase ``models``, one spawn for every check): the three classifier
  fits over the 2-position process mesh, each process then predicting
  its own whole X; ``cooccurrence_topn_distributed`` on a disjoint half
  of the events in each process; ``run_sweep`` (one group a process);
  seqrec over a data 1 x model 2 mesh. Each is held against the same
  port function run here in one process.

Tolerances: the naive Bayes log-probabilities, the forest's node arrays,
the cooccurrence counts and ids: exactly equal (integer counts); logistic
regression's W and b within ``LOGREG_TOL`` (1e-4, scaled by max(1,
|W|)) of the reference's and within ``SAME`` (1e-5) across process
counts (f32 gradient sums in another order); the sweep's held-out RMSEs
within ``SWEEP_TOL`` (1e-6 relative); seqrec's per-step losses within
1e-5 relative and its parameters within ``SAME`` of the same mesh shape
inside one process, and its answers equal on both processes.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh

import predictionio_tpu.models.forest as ref_forest
import predictionio_tpu.models.logreg as ref_logreg
import predictionio_tpu.models.naive_bayes as ref_nb
from predictionio_tpu.models import cooccurrence as ref_co
from predictionio_tpu_torch.models import cooccurrence as co
from predictionio_tpu_torch.models import forest, logreg, naive_bayes
from predictionio_tpu_torch.models.als_sweep import (
    build_sweep_data, run_sweep,
)
from predictionio_tpu_torch.models.seqrec import SeqRecParams, train_seqrec
from predictionio_tpu_torch.parallel.mesh import make_mesh

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_parallel import run_children  # noqa: E402
import torch_distributed_child as child  # noqa: E402

sys.path.pop(0)

CPU = torch.device("cpu")
LOGREG_TOL = 1e-4
SAME = 1e-5
SWEEP_TOL = 1e-6


def port_mesh(shape=(8,), axes=("data",)):
    return make_mesh(shape, axes, devices=[CPU] * int(np.prod(shape)))


def ref_mesh42():
    return RefMesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                   axis_names=("data", "model"))


# -- one process, eight positions ----------------------------------------------------

def test_nb_mesh_branch_matches_reference(mesh8, monkeypatch):
    """The sharded count at the reference's own organic gate (no patched
    threshold): 140,000 x 8 crosses ``DEVICE_MIN_SIZE``; the mesh
    branch runs, and a predict on the same X reads the process's whole
    X resident on the device."""
    rng = np.random.default_rng(12)
    X = rng.poisson(1.0, size=(140_000, 8)).astype(np.float32)
    y = np.where(rng.random(len(X)) < 0.5, "a", "b")
    want = ref_nb.train_multinomial_nb(X, y, mesh=mesh8)
    got = naive_bayes.train_multinomial_nb(X, y, mesh=port_mesh())
    assert got.branches["train_mesh"] == 1
    np.testing.assert_array_equal(got.log_prob, want.log_prob)
    np.testing.assert_array_equal(got.log_prior, want.log_prior)
    assert list(got.predict(X[:500])) == list(want.predict(X[:500]))
    assert got.branches["predict_host"] == 1      # a new array: host
    got.predict(X)
    assert got.branches["predict_device"] == 1    # the resident whole X


def test_nb_mesh_of_a_ragged_row_count_counts_every_row(monkeypatch):
    monkeypatch.setattr(naive_bayes, "DEVICE_MIN_SIZE", 0)
    monkeypatch.setattr(ref_nb, "DEVICE_MIN_SIZE", 0)
    rng = np.random.default_rng(2)
    X = rng.poisson(1.0, size=(203, 17)).astype(np.float32)
    y = np.where(rng.random(203) < 0.5, "a", "b")
    want = ref_nb.train_multinomial_nb(X, y, mesh=RefMesh(
        np.asarray(jax.devices()[:8]), ("data",)))
    for mesh in (port_mesh(), port_mesh((4, 2), ("data", "model"))):
        got = naive_bayes.train_multinomial_nb(X, y, mesh=mesh)
        np.testing.assert_array_equal(got.log_prob, want.log_prob)
        assert list(got.predict(X)) == list(want.predict(X))


def test_logreg_mesh_matches_reference(mesh8):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(117, 5)).astype(np.float32)
    y = np.where(X @ rng.normal(size=(5,)) > 0, "pos", "neg")
    p = dict(iterations=60, learning_rate=0.2, seed=0)
    want = ref_logreg.train_logreg(X, y, ref_logreg.LogRegParams(**p),
                                   mesh=mesh8)
    W0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (5, 2),
                                      jnp.float32) * 0.01)
    got = logreg.train_logreg(X, y, logreg.LogRegParams(**p),
                              mesh=port_mesh(), init_W=W0)
    scale = max(1.0, float(np.abs(want.W).max()))
    np.testing.assert_allclose(got.W, want.W, atol=LOGREG_TOL * scale)
    np.testing.assert_allclose(got.b, want.b, atol=LOGREG_TOL * scale)
    assert list(got.predict(X)) == list(want.predict(X))
    one = logreg.train_logreg(X, y, logreg.LogRegParams(**p), device="cpu",
                              init_W=W0)
    np.testing.assert_allclose(got.W, one.W, atol=SAME)


@pytest.mark.parametrize("num_trees", [8, 6])
def test_forest_mesh_matches_reference(mesh8, num_trees):
    """Trees shard over the first axis; a tree count that is not a
    multiple of it pads with copies of tree 0, sliced off: the model is
    the reference's (and the one-device one) on every mesh shape."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(150, 4)).astype(np.float32)
    y = np.where(X[:, 0] - X[:, 2] > 0, "hi", "lo")
    kw = dict(num_trees=num_trees, max_depth=3, max_bins=16, seed=9)
    want = ref_forest.train_forest(X, y, ref_forest.ForestParams(**kw),
                                   mesh=mesh8)
    for mesh in (port_mesh(), port_mesh((4, 2), ("data", "model")),
                 port_mesh((3,))):
        got = forest.train_forest(X, y, forest.ForestParams(**kw),
                                  mesh=mesh)
        assert got.feat.shape[0] == num_trees
        for k in ("feat", "thr", "leaf", "thresholds"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                          err_msg=k)
        assert list(got.predict(X)) == list(want.predict(X))


@pytest.mark.parametrize("shape,axes", [((8,), ("data",)),
                                        ((4, 2), ("data", "model"))])
@pytest.mark.parametrize("nu,ni,k", [(50, 37, 5), (180, 1400, 7)])
def test_cooccurrence_mesh_matches_reference(shape, axes, nu, ni, k):
    """C's row blocks over the first axis: counts and ids exactly the
    reference's sharded path's (ties keep the lower id in both)."""
    rng = np.random.default_rng(6)
    u = rng.integers(0, nu, 12 * ni).astype(np.int32)
    i = rng.integers(0, ni, 12 * ni).astype(np.int32)
    du, di = co.distinct_pairs(u, i)
    ref = RefMesh(np.asarray(jax.devices()[:8]).reshape(shape), axes)
    want_v, want_i = ref_co.cooccurrence_topn(ref, du, di, nu, ni, k)
    stats = {}
    got_v, got_i = co.cooccurrence_topn(du, di, nu, ni, k,
                                        mesh=port_mesh(shape, axes),
                                        stats=stats)
    assert stats["path"] == "mesh" and stats["shards"] == shape[0]
    np.testing.assert_array_equal(got_v, np.asarray(want_v, np.int64))
    np.testing.assert_array_equal(got_i, want_i)
    one_v, one_i = co.cooccurrence_topn_slabs(du, di, nu, ni, k,
                                              device="cpu")
    np.testing.assert_array_equal(got_v, one_v)
    np.testing.assert_array_equal(got_i, one_i)


def test_train_cooccurrence_on_a_mesh_matches_reference():
    rng = np.random.default_rng(9)
    u = rng.integers(0, 40, 500).astype(np.int32)
    i = rng.integers(0, 25, 500).astype(np.int32)
    want = ref_co.train_cooccurrence(u, i, 40, 25, 6, mesh=ref_mesh42())
    stats = {}
    got = co.train_cooccurrence(u, i, 40, 25, 6,
                                mesh=port_mesh((4, 2), ("data", "model")),
                                stats=stats)
    assert stats["path"] == "mesh"
    assert got == want


def test_mesh_budget_counts_the_first_axis_shards():
    """The card's per-position bytes divide the uint8 block by the
    FIRST axis's shards (not the total position count) and add the
    gathered full-width A^T."""
    nu, ni = 138_000, 27_000
    nu_pad, ni_pad, slab = co.slab_geometry(nu, ni, 4)
    full = nu_pad * ni_pad
    assert co.device_bytes(nu, ni, 4) == full // 4 + full + slab * ni_pad * 12
    cuda = torch.device("cuda")
    assert co.fits_dense(nu, ni, cuda, 4)
    assert not co.fits_dense(138_000, 100_000, cuda, 4)
    assert co.device_bytes(nu, ni) == full_one(nu, ni)


def full_one(nu, ni):
    nu_pad, ni_pad, slab = co.slab_geometry(nu, ni)
    return nu_pad * ni_pad + slab * ni_pad * 12


# -- two processes ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    return run_children("models", tmp_path_factory.mktemp("models"))


def test_two_process_classifiers_equal_one_process(two_process,
                                                   monkeypatch):
    monkeypatch.setattr(naive_bayes, "DEVICE_MIN_SIZE", 0)
    X, y = child.nb_data()
    nb = naive_bayes.train_multinomial_nb(X, y, device="cpu")
    Xl, yl = child.logreg_data()
    lr = logreg.train_logreg(Xl, yl, logreg.LogRegParams(
        iterations=60, learning_rate=0.2), device="cpu")
    Xf, yf = child.forest_data()
    fm = forest.train_forest(Xf, yf, forest.ForestParams(
        num_trees=7, max_depth=3, max_bins=16, seed=5), device="cpu")
    for res in two_process.values():
        assert res["nb_branches"] == {"train_mesh": 1, "predict_device": 1}
        np.testing.assert_array_equal(np.float32(res["nb_log_prob"]),
                                      nb.log_prob)
        np.testing.assert_array_equal(np.float32(res["nb_log_prior"]),
                                      nb.log_prior)
        assert res["nb_predict"] == nb.predict(X).tolist()
        np.testing.assert_allclose(res["lr_W"], lr.W, atol=SAME, rtol=0)
        np.testing.assert_allclose(res["lr_b"], lr.b, atol=SAME, rtol=0)
        assert res["lr_predict"] == lr.predict(Xl).tolist()
        for got, want in zip(res["forest_nodes"], (fm.feat, fm.thr,
                                                    fm.leaf)):
            np.testing.assert_array_equal(np.asarray(got), want)
        assert res["forest_predict"] == fm.predict(Xf).tolist()


def test_two_process_distributed_cooccurrence_equals_one_process(
        two_process):
    users, items, nu, ni = child.cooc_events()
    du, di = co.distinct_pairs(users, items)
    want_v, want_i = co.cooccurrence_topn_slabs(du, di, nu, ni, 5,
                                                device="cpu")
    one_v, one_i = co.cooccurrence_topn_distributed(
        make_mesh(device="cpu"), users, items, nu, ni, 5)
    np.testing.assert_array_equal(one_v, want_v)
    np.testing.assert_array_equal(one_i, want_i)
    for res in two_process.values():
        np.testing.assert_array_equal(np.asarray(res["cooc_vals"]), want_v)
        np.testing.assert_array_equal(np.asarray(res["cooc_ids"]), want_i)


def test_two_process_sweep_splits_the_groups_and_equals_one_process(
        two_process):
    args, cands = child.sweep_grid()
    one = run_sweep(build_sweep_data(*args), cands, device="cpu")
    for pid, res in two_process.items():
        # two rank groups: one a process, 2 candidates x 3 folds each
        assert res["sweep_batches"] == [6]
        assert res["sweep_groups"] == [c.group for c in one.candidates]
        np.testing.assert_allclose(
            res["sweep_rmse"], [c.heldout_rmse for c in one.candidates],
            rtol=SWEEP_TOL, atol=0)


def test_two_process_seqrec_data_by_model_equals_one_process(two_process):
    """tp across the processes against the same 1 x 2 mesh inside one
    process (its two positions on the one CPU)."""
    losses = []
    one = train_seqrec(port_mesh((1, 2), ("data", "model")),
                       child.seqrec_sessions(), SeqRecParams(**child.SEQREC),
                       losses=losses)
    r0, r1 = two_process[0], two_process[1]
    assert r0["seqrec_recs"] == r1["seqrec_recs"]
    for res in (r0, r1):
        np.testing.assert_allclose(res["seqrec_losses"], losses, rtol=1e-5,
                                   atol=0)
        for k, v in res["seqrec_params"].items():
            np.testing.assert_allclose(np.float32(v), one.params[k],
                                       atol=SAME, rtol=0, err_msg=k)
    assert r0["seqrec_params"]["emb"] == r1["seqrec_params"]["emb"]


def test_two_process_models_load_no_jax(two_process):
    assert [r["forbidden_modules"] for r in two_process.values()] == [[], []]
