"""The port's one-device attention (``ops/attention.py``) against the
JAX package's, on the CPU, on the same seeded numpy inputs.

Tolerance: ``ATT_TOL`` (1e-5, absolute and relative) for every output;
f32 products summed in another order. Fully masked query rows must be
exactly 0 in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import predictionio_tpu.ops.attention as ref_att
import predictionio_tpu_torch.ops.attention as port_att

ATT_TOL = 1e-5


def qkv(b=2, lq=12, lk=12, h=2, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, lq, h, d), (b, lk, h, d), (b, lk, h, d)))


def left_padded_mask(b, lk, seed=1):
    """``[B, Lk]`` key masks of left-padded sessions: row i keeps its
    last ``n_i`` keys, one row with no key at all."""
    rng = np.random.default_rng(seed)
    n = rng.integers(1, lk + 1, size=b)
    n[0] = 0
    return np.arange(lk)[None, :] >= (lk - n)[:, None]


def both(fn_name, q, k, v, key_mask=None, **kw):
    ref = np.asarray(getattr(ref_att, fn_name)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_mask=None if key_mask is None else jnp.asarray(key_mask), **kw))
    got = getattr(port_att, fn_name)(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        key_mask=None if key_mask is None else torch.from_numpy(key_mask),
        **kw).numpy()
    return ref, got


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_mha_matches_reference(causal, masked):
    q, k, v = qkv(b=3)
    mask = left_padded_mask(3, 12) if masked else None
    ref, got = both("mha", q, k, v, key_mask=mask, causal=causal)
    np.testing.assert_allclose(got, ref, rtol=ATT_TOL, atol=ATT_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("block_k", [4, 5, 12, 64])
def test_blockwise_matches_reference(causal, masked, block_k):
    """Block sizes that divide the key length, that do not (5: K/V
    padded with masked keys) and that exceed it."""
    q, k, v = qkv(b=3)
    mask = left_padded_mask(3, 12) if masked else None
    ref, got = both("blockwise_attention", q, k, v, key_mask=mask,
                    causal=causal, block_k=block_k)
    np.testing.assert_allclose(got, ref, rtol=ATT_TOL, atol=ATT_TOL)


@pytest.mark.parametrize("fn", ["mha", "blockwise_attention"])
def test_fully_masked_rows_are_zero_not_nan(fn):
    """Left padding under the causal mask: every query at a pad position
    sees only pad keys; both packages give exactly 0 there, and the
    all-pad session is 0 everywhere."""
    q, k, v = qkv(b=3, lq=10, lk=10)
    mask = left_padded_mask(3, 10)
    kw = {"block_k": 3} if fn == "blockwise_attention" else {}
    ref, got = both(fn, q, k, v, key_mask=mask, causal=True, **kw)
    assert np.isfinite(got).all()
    pad_rows = ~mask                       # query i is a pad iff key i is
    assert (got[pad_rows] == 0).all() and (ref[pad_rows] == 0).all()
    np.testing.assert_allclose(got, ref, rtol=ATT_TOL, atol=ATT_TOL)


def test_blockwise_equals_mha_on_the_port():
    q, k, v = qkv(b=2, lq=9, lk=17)
    mask = left_padded_mask(2, 17)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    dense = port_att.mha(*t, key_mask=torch.from_numpy(mask))
    blocks = port_att.blockwise_attention(*t, block_k=4,
                                          key_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(blocks.numpy(), dense.numpy(), rtol=ATT_TOL,
                               atol=ATT_TOL)


def test_causal_mask_offsets_match_reference():
    s = np.random.default_rng(3).standard_normal((2, 2, 5, 7)).astype(
        np.float32)
    ref = np.asarray(ref_att._causal_mask(jnp.asarray(s), 3, 1))
    got = port_att._causal_mask(torch.from_numpy(s), 3, 1).numpy()
    np.testing.assert_array_equal(got, ref)
    assert port_att.NEG_INF == ref_att.NEG_INF


def test_gradients_match_reference_through_masked_rows():
    """Autograd of blockwise attention against ``jax.grad`` of the
    reference's, with pad rows: finite, within ``ATT_TOL``."""
    import jax

    q, k, v = qkv(b=2, lq=8, lk=8)
    mask = left_padded_mask(2, 8)
    w = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)

    def ref_loss(q, k, v):
        out = ref_att.blockwise_attention(q, k, v, block_k=3, causal=True,
                                          key_mask=jnp.asarray(mask))
        return (out * w).sum()

    ref = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = port_att.blockwise_attention(*t, block_k=3, causal=True,
                                       key_mask=torch.from_numpy(mask))
    (out * torch.from_numpy(w)).sum().backward()
    for r, g in zip(ref, t):
        assert torch.isfinite(g.grad).all()
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(r),
                                   rtol=ATT_TOL, atol=ATT_TOL)
