"""The port's segment reductions against the JAX package's
``ops/segment.py``: ``segment_count``, ``_pad_rows_sorted``,
``rows_gram_rhs``, ``row_predict_add`` and ``block_gram_rhs`` on the
same seeded padded-row inputs (built by the reference's ``shard_rows``).
``chunk_rows`` values that do not divide R exercise the padding rows
(aimed at the last segment with weight 0).

Tolerance: rtol 1e-5 / atol 1e-5 (f32 sums in another order); the
padding arrays are equal exactly.
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
    got = port.segment_count(_t(rows["seg"]), _t(w), N_SEG).numpy()
    want = np.asarray(ref.segment_count(_j(rows["seg"]), _j(w), N_SEG))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("chunk", [100, 7, 10_000])
def test_pad_rows_sorted(rows, chunk):
    args = (rows["tgt"], rows["seg"], (rows["val"], rows["w"]))
    p_tgt, p_seg, p_extra, p_n, p_c = port._pad_rows_sorted(
        *(_t(a) for a in args[:2]), tuple(_t(a) for a in args[2]),
        N_SEG, chunk)
    r_tgt, r_seg, r_extra, r_n, r_c = ref._pad_rows_sorted(
        *(_j(a) for a in args[:2]), tuple(_j(a) for a in args[2]),
        N_SEG, chunk)
    assert (p_n, p_c) == (r_n, r_c)
    assert np.array_equal(p_tgt.numpy(), np.asarray(r_tgt))
    assert np.array_equal(p_seg.numpy(), np.asarray(r_seg))
    for a, b in zip(p_extra, r_extra):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert (np.diff(p_seg.numpy()) >= 0).all()


@pytest.mark.parametrize("chunk", [100, 7, 10_000])
def test_rows_gram_rhs(rows, chunk):
    got = port.rows_gram_rhs(
        _t(rows["factors"]), _t(rows["tgt"]), _t(rows["seg"]),
        _t(rows["val"]), _t(rows["w"]), N_SEG, chunk_rows=chunk)
    want = ref.rows_gram_rhs(
        _j(rows["factors"]), _j(rows["tgt"]), _j(rows["seg"]),
        _j(rows["val"]), _j(rows["w"]), num_segments=N_SEG,
        chunk_rows=chunk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("chunk", [100, 7])
def test_row_predict_add(rows, chunk):
    got = port.row_predict_add(
        _t(rows["factors"]), _t(rows["x"]), _t(rows["tgt"]),
        _t(rows["seg"]), _t(rows["pred"]), chunk_rows=chunk)
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
    got = port.block_gram_rhs(
        _t(f_b), _t(x_b), _t(rows["tgt"]), _t(rows["seg"]),
        _t(rows["pred"]), _t(rhs_val), _t(gram_w), N_SEG, chunk_rows=chunk)
    want = ref.block_gram_rhs(
        _j(f_b), _j(x_b), _j(rows["tgt"]), _j(rows["seg"]),
        _j(rows["pred"]), _j(rhs_val), _j(gram_w), num_segments=N_SEG,
        chunk_rows=chunk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
