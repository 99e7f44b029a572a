"""The port's batched SPD solve against the JAX package's.

``cholesky_solve_vec`` (the plain version of the hand-written kernel) and
the ``xla`` path (``torch.linalg.cholesky_ex`` + ``cholesky_solve``) are
held against ``np.linalg.solve`` and against the reference's
``cholesky_solve_vec`` and ``cholesky_solve_pallas(..., interpret=True)``
on the same seeded SPD systems, at S in {1, 127, 128, 300} (one system,
a ragged tile, one full tile, several tiles) and K in {1, 3, 10, 16, 64}.
The Pallas interpreter is used for K <= 16: at K = 64 its 64-step
unrolled program takes about a minute to trace per batch shape on a
CPU, so K = 64 is held against the reference's vectorized and library
solves and numpy instead.

Tolerance: rtol 1e-4 / atol 1e-4 against numpy's f64-accumulated solve
and the reference (f32 Cholesky, sums in another order; the systems are
well conditioned, A = M M^T + 2K I). Empty segments must be exactly 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import linalg as ref
from predictionio_tpu_torch.ops import kernels
from predictionio_tpu_torch.ops import linalg as port

RTOL = ATOL = 1e-4


def _spd_problem(s, k, seed=0):
    rng = np.random.default_rng(seed + 1000 * k + s)
    m = rng.normal(size=(s, k, k)).astype(np.float32)
    A = m @ m.transpose(0, 2, 1) + 2.0 * k * np.eye(k, dtype=np.float32)
    b = rng.normal(size=(s, k)).astype(np.float32)
    x_np = np.linalg.solve(A.astype(np.float64),
                           b.astype(np.float64)[..., None])[..., 0]
    return A, b, x_np


SHAPES = [(s, k) for k in (1, 3, 10, 16, 64) for s in (1, 127, 128, 300)]


@pytest.mark.parametrize("s,k", SHAPES)
@pytest.mark.parametrize("path", ["vec", "xla"])
def test_port_solve_matches_numpy_and_reference(s, k, path):
    A, b, x_np = _spd_problem(s, k)
    fn = port.cholesky_solve_vec if path == "vec" else port.cholesky_solve_xla
    got = fn(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    assert got.shape == (s, k) and got.dtype == np.float32
    np.testing.assert_allclose(got, x_np, rtol=RTOL, atol=ATOL)
    want = np.asarray(ref.cholesky_solve_vec(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if k <= 16:
        pallas = np.asarray(ref.cholesky_solve_pallas(
            jnp.asarray(A), jnp.asarray(b), interpret=True))
        np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [1, 10, 16, 64])
def test_empty_segments_stay_exactly_zero(k, monkeypatch):
    """Empty ALS segments (A = lam I or 0, b = 0) solve to exactly 0
    through every method, as through the reference's dispatch."""
    A = np.zeros((6, k, k), np.float32)
    A[:3] = 0.01 * np.eye(k, dtype=np.float32)
    b = np.zeros((6, k), np.float32)
    for method in ("auto", "vec", "xla", "pallas"):
        monkeypatch.setenv("PIO_TPU_SOLVE", method)
        out = port.batched_spd_solve(torch.from_numpy(A),
                                     torch.from_numpy(b)).numpy()
        assert np.isfinite(out).all()
        assert (out == 0.0).all(), method
    monkeypatch.setenv("PIO_TPU_SOLVE", "vec")
    ref_out = np.asarray(ref.batched_spd_solve(jnp.asarray(A),
                                               jnp.asarray(b)))
    assert (ref_out == 0.0).all()


def test_mixed_batch_with_empty_segments_matches_reference():
    A, b, _ = _spd_problem(40, 10, seed=3)
    A[::7] = 0.05 * np.eye(10, dtype=np.float32)
    b[::7] = 0.0
    got = port.batched_spd_solve(torch.from_numpy(A),
                                 torch.from_numpy(b)).numpy()
    want = np.asarray(ref.batched_spd_solve(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got[::7] == 0.0).all()


@pytest.mark.parametrize("method", ["auto", "vec", "xla", "pallas",
                                    " Vec "])
def test_solve_method_dispatch(method, monkeypatch):
    """PIO_TPU_SOLVE values as the reference reads them: the same answer
    from each method on CPU tensors, and no kernel launch (the kernel
    runs only on CUDA tensors)."""
    A, b, x_np = _spd_problem(33, 10, seed=2)
    monkeypatch.setenv("PIO_TPU_SOLVE", method)
    calls = []
    for name in ("cholesky_solve_vec", "cholesky_solve_xla"):
        real = getattr(port, name)
        monkeypatch.setattr(port, name,
                            lambda *a, _n=name, _r=real: calls.append(_n)
                            or _r(*a))
    before = kernels.SPD_SOLVE_LAUNCHES
    got = port.batched_spd_solve(torch.from_numpy(A), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), x_np, rtol=RTOL, atol=ATOL)
    assert kernels.SPD_SOLVE_LAUNCHES == before
    want = ("cholesky_solve_xla" if method.strip().lower() == "xla"
            else "cholesky_solve_vec")
    assert calls == [want]
    ref_got = np.asarray(ref.batched_spd_solve(jnp.asarray(A),
                                               jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), ref_got, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bad", ["cholesky", "cuda", ""])
def test_bad_solve_method_raises_like_reference(bad, monkeypatch):
    A, b, _ = _spd_problem(2, 3)
    monkeypatch.setenv("PIO_TPU_SOLVE", bad)
    with pytest.raises(ValueError, match="auto|xla|vec|pallas"):
        port.batched_spd_solve(torch.from_numpy(A), torch.from_numpy(b))
    with pytest.raises(ValueError, match="auto|xla|vec|pallas"):
        ref.batched_spd_solve(jnp.asarray(A), jnp.asarray(b))


def test_auto_routes_cuda_tensors_by_k(monkeypatch):
    """The ``auto`` rule on a CUDA tensor: the kernel for K <= 64, the
    vectorized path above (checked with the dispatch's own predicate;
    CUDA tensors need a card)."""
    launched = []
    monkeypatch.setattr(port, "spd_solve",
                        lambda A, b, *terms: launched.append(A.shape[-1])
                        or b)

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    for k, want_kernel in ((10, True), (64, True), (65, False)):
        launched.clear()
        A = torch.eye(k).expand(2, k, k).clone().as_subclass(FakeCuda)
        b = torch.zeros((2, k)).as_subclass(FakeCuda)
        monkeypatch.setenv("PIO_TPU_SOLVE", "auto")
        port.batched_spd_solve(A, b)
        assert (launched == [k]) == want_kernel, (k, launched)


# ---------------------------------------------------------------------------
# the ridge term as a per-system diagonal
# ---------------------------------------------------------------------------

def _ridge_problem(s, k, seed=0, reg=0.05, n=24):
    """Systems built like an ALS half-sweep's: the Gramian of seeded
    factors over cnt <= n ratings, the ridge ``lam = reg * max(cnt, 1)``
    kept apart, about 10% of segments empty (gram = 0, b = 0)."""
    rng = np.random.default_rng(seed + 7 * k + s)
    cnt = rng.integers(1, n + 1, s)
    cnt[rng.random(s) < 0.1] = 0
    cnt[0] = 0
    w = (np.arange(n)[None, :] < cnt[:, None]).astype(np.float32)
    f = (rng.standard_normal((s, n, k)) / np.sqrt(k)).astype(np.float32)
    r = rng.integers(1, 6, (s, n)).astype(np.float32)
    fw = f * w[..., None]
    gram = np.einsum("snk,snl->skl", fw, f).astype(np.float32)
    rhs = np.einsum("snk,sn->sk", fw, r).astype(np.float32)
    lam = (reg * np.maximum(cnt, 1)).astype(np.float32)
    return gram, rhs, lam, cnt == 0


@pytest.mark.parametrize("k", [1, 10, 16, 33, 64])
@pytest.mark.parametrize("method", ["auto", "vec", "xla", "pallas"])
def test_diag_matches_reference_gram_plus_lam(k, method, monkeypatch):
    """``batched_spd_solve(gram, b, diag=lam)`` against the reference's
    ``batched_spd_solve(gram + lam I, b)`` on the same numpy inputs.
    Tolerance: max |dx| <= 1e-4 * max(1, max |x|) (f32 Cholesky, sums in
    another order); empty segments exactly 0 in both."""
    gram, rhs, lam, empty = _ridge_problem(130, k)
    A_t = torch.from_numpy(gram)
    monkeypatch.setenv("PIO_TPU_SOLVE", method)
    got = port.batched_spd_solve(A_t, torch.from_numpy(rhs),
                                 diag=torch.from_numpy(lam)).numpy()
    assert np.array_equal(A_t.numpy(), gram)          # A is not written
    monkeypatch.setenv("PIO_TPU_SOLVE", "vec")
    A_ref = jnp.asarray(gram) + jnp.asarray(lam)[:, None, None] * jnp.eye(
        k, dtype=jnp.float32)
    want = np.asarray(ref.batched_spd_solve(A_ref, jnp.asarray(rhs)))
    assert got.shape == want.shape == (130, k)
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * max(1.0, float(np.abs(want).max())), err
    assert (got[empty] == 0).all() and (want[empty] == 0).all()


@pytest.mark.parametrize("k", [1, 10, 16, 33, 64])
def test_diag_empty_segments_exactly_zero(k, monkeypatch):
    """Empty segments with the ridge passed apart (gram = 0, diag = lam,
    b = 0) solve to exactly 0 through every method, as the reference's
    ``gram + lam I`` does."""
    s = 5
    gram = np.zeros((s, k, k), np.float32)
    lam = np.array([0.01, 0.5, 3.0, 1e-4, 20.0], np.float32)
    b = np.zeros((s, k), np.float32)
    for method in ("auto", "vec", "xla", "pallas"):
        monkeypatch.setenv("PIO_TPU_SOLVE", method)
        out = port.batched_spd_solve(torch.from_numpy(gram),
                                     torch.from_numpy(b),
                                     diag=torch.from_numpy(lam)).numpy()
        assert (out == 0.0).all(), method
    monkeypatch.setenv("PIO_TPU_SOLVE", "vec")
    A_ref = lam[:, None, None] * np.eye(k, dtype=np.float32)
    assert (np.asarray(ref.batched_spd_solve(jnp.asarray(A_ref),
                                             jnp.asarray(b))) == 0).all()


def test_with_diagonal_sums_in_reference_order():
    """The diagonal is ``(A_ii + diag_s) + jitter`` bit for bit, as the
    reference's ``gram + lam I`` then ``+ jitter I`` gives it; the rest
    of A is copied unchanged and A itself is not written."""
    gram, _, lam, _ = _ridge_problem(40, 10, seed=5)
    A_t = torch.from_numpy(gram)
    got = port.with_diagonal(A_t, torch.from_numpy(lam), 1e-6).numpy()
    eye = jnp.eye(10, dtype=jnp.float32)
    want = (jnp.asarray(gram) + jnp.asarray(lam)[:, None, None] * eye) \
        + 1e-6 * eye
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(A_t.numpy(), gram)
    plain = port.with_diagonal(A_t, None, 1e-6).numpy()
    assert np.array_equal(plain, np.asarray(jnp.asarray(gram) + 1e-6 * eye))
