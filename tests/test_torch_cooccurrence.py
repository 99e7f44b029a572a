"""Item cooccurrence (the port's ``models/cooccurrence.py``) against the
JAX package's on the same (user, item) codes, made from a seed with
numpy.

* The port's slabbed product, forced on CPU tensors (``topn_slabs`` /
  ``cooccurrence_topn_slabs``, the code the card runs), against the
  reference's slabbed ``shard_map`` path on a 2-device CPU mesh: counts
  exactly equal, ids exactly equal (both keep the lower id first among
  equal counts), several slabs a block, the diagonal zero.
* Counts of 255, 256, 257, 300 and 5000 come back exact (a bf16 output
  would give 256 for 257).
* The CPU path (``cooccurrence_topn`` on ``cpu``) is the reference's
  single-device fallback: the same counts and ids.
* The budget gate keeps the n_items^2 term on the CPU, where the
  reference's drops it: past it the port counts host pairs (counts
  exact, ids equal up to ties) where the reference would build the
  dense matrix.
* ``train_cooccurrence`` and ``CooccurrenceModel.similar`` give the
  reference's lists and answers.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from predictionio_tpu.models import cooccurrence as ref_co
from predictionio_tpu_torch.models import cooccurrence as co


def _pairs(seed, nu, ni, nnz):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, nu, nnz).astype(np.int32)
    i = rng.integers(0, ni, nnz).astype(np.int32)
    return co.distinct_pairs(u, i)


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), axis_names=("data",))


def _dense(du, di, nu, ni):
    a = np.zeros((nu, ni), np.int64)
    a[du, di] = 1
    c = a.T @ a
    np.fill_diagonal(c, 0)
    return c


def _lowest_id_top(c, k):
    """Each row's top-k: counts descending, equal counts by ascending id."""
    order = np.lexsort((np.broadcast_to(np.arange(c.shape[1]), c.shape),
                        -c), axis=1)[:, :k]
    return np.take_along_axis(c, order, axis=1), order


@pytest.mark.parametrize("seed,nu,ni,k", [
    (8, 180, 1400, 5), (3, 60, 300, 12), (5, 400, 97, 20)])
def test_slab_path_matches_reference_slabbed(seed, nu, ni, k):
    du, di = _pairs(seed, nu, ni, 6 * nu)
    want_v, want_i = ref_co.cooccurrence_topn(_mesh(2), du, di, nu, ni, k)
    got_v, got_i = co.cooccurrence_topn_slabs(du, di, nu, ni, k,
                                              device="cpu")
    np.testing.assert_array_equal(got_v, want_v.astype(np.int64))
    # the reference's lax.top_k puts the lower index first among ties,
    # and so does the port's key: the ids are equal exactly
    np.testing.assert_array_equal(got_i, want_i)
    ref_v, ref_i = _lowest_id_top(_dense(du, di, nu, ni), k)
    np.testing.assert_array_equal(want_i, ref_i)
    np.testing.assert_array_equal(got_v, ref_v)


@pytest.mark.parametrize("slab", [128, 256, 384])
def test_several_slabs_a_block(slab):
    """The slab loop at heights that split the block into 11, 6 and 4
    slabs (the card takes ``KERNEL_SLAB`` rows past 256 MB)."""
    nu, ni, k = 150, 1300, 7
    du, di = _pairs(11, nu, ni, 4000)
    at = torch.from_numpy(co.incidence(du, di, nu, ni)).view(torch.int8)
    got_v, got_i = co.topn_slabs(at, ni, k, slab)
    want_v, want_i = _lowest_id_top(_dense(du, di, nu, ni), k)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    # the diagonal is zeroed: no item lists itself with a count
    rows = np.arange(ni)[:, None]
    assert not ((got_i.numpy() == rows) & (got_v.numpy() > 0)).any()


def test_counts_past_bf16_exact():
    counts = (255, 256, 257, 300, 5000)
    u, i = [], []
    for p, c in enumerate(counts):
        for it in (2 * p, 2 * p + 1):
            u.append(np.arange(c))
            i.append(np.full(c, it))
    u = np.concatenate(u).astype(np.int32)
    i = np.concatenate(i).astype(np.int32)
    nu, ni = 5008, 12
    got_v, got_i = co.cooccurrence_topn_slabs(u, i, nu, ni, ni - 1,
                                              device="cpu")
    for p, c in enumerate(counts):
        row = list(got_i[2 * p])
        assert got_v[2 * p][row.index(2 * p + 1)] == c
    want_v, want_i = _lowest_id_top(_dense(u, i, nu, ni), ni - 1)
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_i, want_i)
    # the reference's slabbed path multiplies in f32 on the CPU: exact
    ref_v, _ = ref_co.cooccurrence_topn(_mesh(2), u, i, nu, ni, ni - 1)
    np.testing.assert_array_equal(got_v, ref_v.astype(np.int64))


def test_cpu_path_is_the_reference_fallback():
    nu, ni, k = 90, 140, 6
    du, di = _pairs(2, nu, ni, 700)
    want_v, want_i = ref_co.cooccurrence_topn(_mesh(1), du, di, nu, ni, k)
    stats = {}
    got_v, got_i = co.cooccurrence_topn(du, di, nu, ni, k, device="cpu",
                                        stats=stats)
    assert stats["path"] == "host_dense"
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_i, want_i)


def test_gate_keeps_the_items_squared_term(monkeypatch):
    # item-heavy: n_users * ni_pad fits the reference's gate, n_items^2
    # does not; the CPU path would build the [n_items, n_items] matrix
    assert 1000 * 400_000 <= ref_co.DENSE_BUDGET
    assert not co.fits_dense(1000, 400_000, torch.device("cpu"))
    assert co.fits_dense(400, 2000, torch.device("cpu"))
    # on the card the slabbed product never holds n_items^2: the gate
    # counts its own bytes, and the ML-20M shape passes
    cuda = torch.device("cuda")
    assert co.device_bytes(138_000, 27_000) == (
        138_000 * 27_008 + 512 * 27_008 * 12)
    assert co.device_bytes(138_000, 27_000) <= co.DEVICE_HBM_BUDGET
    assert co.fits_dense(138_000, 27_000, cuda)
    assert not co.fits_dense(138_000, 100_000, cuda)

    nu, ni, n = 40, 300, 6
    du, di = _pairs(4, nu, ni, 500)
    monkeypatch.setattr(co, "DENSE_BUDGET", 50_000)
    assert nu * 384 <= 50_000 < ni * ni
    stats = {}
    got = co.train_cooccurrence(du, di, nu, ni, n, device="cpu",
                                stats=stats)
    assert stats["path"] == "host_pairs"
    want = ref_co.train_cooccurrence(du, di, nu, ni, n, mesh=_mesh(1))
    assert sorted(got) == sorted(want)
    c = _dense(du, di, nu, ni)
    for item, lst in want.items():
        # counts exact; ids up to ties (the host path's sort is stable
        # over its own pair order, argpartition has no tie rule)
        assert [x[1] for x in got[item]] == [x[1] for x in lst]
        assert all(c[item, j] == cnt for j, cnt in got[item])


@pytest.mark.parametrize("seed", [0, 1])
def test_train_and_similar_match_reference(seed):
    nu, ni, n = 70, 120, 8
    rng = np.random.default_rng(seed)
    u = rng.integers(0, nu, 900).astype(np.int32)
    i = rng.integers(0, ni, 900).astype(np.int32)
    want = ref_co.train_cooccurrence(u, i, nu, ni, n, mesh=_mesh(1))
    got = co.train_cooccurrence(u, i, nu, ni, n, device="cpu")
    assert got == want
    vocab = np.asarray([f"i{j:03d}" for j in range(ni)])
    ref_m = ref_co.CooccurrenceModel(item_vocab=vocab,
                                     top_cooccurrences=want)
    m = co.CooccurrenceModel(item_vocab=vocab, top_cooccurrences=got)
    for q in range(12):
        items = [str(vocab[j]) for j in rng.choice(ni, 1 + q % 3)]
        kw = dict(num=int(rng.integers(1, 10)))
        if q % 4 == 1:
            kw["black_list"] = [str(vocab[j]) for j in rng.choice(ni, 5)]
        if q % 4 == 2:
            kw["white_list"] = [str(vocab[j]) for j in rng.choice(ni, 30)]
        if q % 4 == 3:
            kw["candidate_filter"] = lambda idx: idx % 2 == 0
        assert m.similar(items, **kw) == ref_m.similar(items, **kw)
