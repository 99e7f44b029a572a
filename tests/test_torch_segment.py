"""The port's segment reductions against the JAX package's
``ops/segment.py``: ``segment_count``, ``rows_gram_rhs``,
``row_predict_add`` and ``block_gram_rhs`` on the same seeded padded-row
inputs (built by the reference's ``shard_rows``). The port's ops take a
leading unit axis (a train is one unit; the evaluation sweep's units are
several): one unit is held to the reference's op, and several units
each to the reference's op on that unit's factors and weights (the
reference ``vmap``s it). ``chunk_rows`` values that do not divide R
exercise the short last chunk (the reference pads it with rows aimed at
the last segment with weight 0; the port slices it).

Tolerance: rtol 1e-5 / atol 1e-5 (f32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.models.als import shard_rows
from predictionio_tpu.ops import segment as ref
from predictionio_tpu_torch.ops import segment as port

TOL = dict(rtol=1e-5, atol=1e-5)
N_SEG, N_OPP, NNZ, K, ROW_LEN = 37, 53, 900, 6, 16


def _rows(seed=0):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, N_SEG - 2, NNZ)          # two empty segments
    seg[:60] = 3                                   # a heavy segment
    tgt = rng.integers(0, N_OPP, NNZ)
    val = rng.integers(1, 6, NNZ).astype(np.float32)
    rows = shard_rows(seg, tgt, val, N_SEG, 1, row_len=ROW_LEN)
    r = rows.tgt.shape[1]
    return dict(
        tgt=rows.tgt[0], seg=rows.seg[0], val=rows.val[0], w=rows.w[0],
        factors=rng.standard_normal((N_OPP, K)).astype(np.float32),
        x=rng.standard_normal((N_SEG, K)).astype(np.float32),
        pred=rng.standard_normal((r, ROW_LEN)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


@pytest.fixture(scope="module")
def rows():
    d = _rows()
    assert d["tgt"].shape[0] % 100 != 0
    return d


def test_segment_count(rows):
    w = rows["w"].sum(axis=1)
    got = port.segment_count(_t(rows["seg"]), _t(w)[None], N_SEG)[0]
    want = np.asarray(ref.segment_count(_j(rows["seg"]), _j(w), N_SEG))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("chunk", [100, 7, 10_000])
def test_unit_axis_equals_the_reference_per_unit(rows, chunk):
    """Three units at once: each unit's Gramians, right-hand sides and
    counts are the reference's on that unit's factors and weights."""
    rng = np.random.default_rng(chunk)
    b = 3
    factors = rng.standard_normal((b, N_OPP, K)).astype(np.float32)
    w = (rows["w"][None] * (rng.random((b,) + rows["w"].shape) > 0.3)
         ).astype(np.float32)
    got = port.rows_gram_rhs(
        _t(factors), _t(rows["tgt"]), _t(rows["seg"]),
        _t(rows["val"])[None], _t(w), N_SEG, chunk_rows=chunk)
    cnt = port.segment_count(_t(rows["seg"]), _t(w.sum(axis=2)), N_SEG)
    for u in range(b):
        want = ref.rows_gram_rhs(
            _j(factors[u]), _j(rows["tgt"]), _j(rows["seg"]),
            _j(rows["val"]), _j(w[u]), num_segments=N_SEG,
            chunk_rows=chunk)
        for g, x in zip(got, want):
            np.testing.assert_allclose(g[u].numpy(), np.asarray(x), **TOL)
        np.testing.assert_allclose(cnt[u].numpy(), np.asarray(want[2]),
                                   **TOL)


@pytest.mark.parametrize("chunk", [100, 7, 10_000])
def test_rows_gram_rhs(rows, chunk):
    got = port.rows_gram_rhs(
        _t(rows["factors"])[None], _t(rows["tgt"]), _t(rows["seg"]),
        _t(rows["val"])[None], _t(rows["w"])[None], N_SEG,
        chunk_rows=chunk)
    want = ref.rows_gram_rhs(
        _j(rows["factors"]), _j(rows["tgt"]), _j(rows["seg"]),
        _j(rows["val"]), _j(rows["w"]), num_segments=N_SEG,
        chunk_rows=chunk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("chunk", [100, 7])
def test_row_predict_add(rows, chunk):
    got = port.row_predict_add(
        _t(rows["factors"])[None], _t(rows["x"])[None], _t(rows["tgt"]),
        _t(rows["seg"]), _t(rows["pred"])[None], chunk_rows=chunk)[0]
    want = ref.row_predict_add(
        _j(rows["factors"]), _j(rows["x"]), _j(rows["tgt"]),
        _j(rows["seg"]), _j(rows["pred"]), chunk_rows=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("chunk", [100, 7])
def test_block_gram_rhs(rows, chunk):
    s, b = 2, 3
    f_b = rows["factors"][:, s:s + b]
    x_b = rows["x"][:, s:s + b]
    rhs_val = rows["w"] * rows["val"]
    gram_w = rows["w"] * 0.7
    got = [a[0] for a in port.block_gram_rhs(
        _t(f_b)[None], _t(x_b)[None], _t(rows["tgt"]), _t(rows["seg"]),
        _t(rows["pred"])[None], _t(rhs_val)[None], _t(gram_w)[None], N_SEG,
        chunk_rows=chunk)]
    want = ref.block_gram_rhs(
        _j(f_b), _j(x_b), _j(rows["tgt"]), _j(rows["seg"]),
        _j(rows["pred"]), _j(rhs_val), _j(gram_w), num_segments=N_SEG,
        chunk_rows=chunk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
