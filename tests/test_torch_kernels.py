"""The hand-written CUDA kernels against their plain PyTorch versions.

The kernel tests need a CUDA device and nvcc (a kernel has no CPU mode)
and skip without one. This file imports neither jax nor the JAX
package, so on the card it runs without the repo's conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

The wrappers' CPU dispatch and their input checks run everywhere.

Tolerances. Shortlist: vals rtol 1e-5 / atol 1e-6 (f32 sums in another
order); ids equal wherever the value is finite (random int8 data,
tie-free). SPD solve: max |x - x_plain| <= 1e-4 * max(1, max |x_plain|)
(f32 Cholesky, sums and rsqrt in another order, and a reciprocal of
L[j][j] where the plain version divides; systems built like a
half-sweep's, well conditioned); empty segments exactly 0; A unchanged.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.ops import kernels
from predictionio_tpu_torch.ops.linalg import (
    cholesky_solve_vec, spd_solve, with_diagonal,
)
from predictionio_tpu_torch.ops.scoring import (
    shortlist_topc, shortlist_topc_reference,
)


def _inputs(n_items, tile, rank, b, seed, device):
    g = np.random.default_rng(seed)
    nt = -(-n_items // tile)
    tiles = g.integers(-127, 128, (nt, tile, rank)).astype(np.int8)
    scales = ((0.5 + g.random((nt, tile))) / 127).astype(np.float32)
    u = g.standard_normal((b, rank)).astype(np.float32)
    mask = g.random((b, nt * tile)) < 0.4
    return [torch.from_numpy(a).to(device) for a in (u, tiles, scales, mask)]


def _assert_match(got, want):
    gv, gi = (a.cpu().numpy() for a in got)
    wv, wi = (a.cpu().numpy() for a in want)
    assert gv.shape == wv.shape and gi.shape == wi.shape
    fin = np.isfinite(wv)
    assert np.array_equal(fin, np.isfinite(gv))
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=1e-5, atol=1e-6)
    assert np.array_equal(gi[fin], wi[fin])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the shortlist kernel has "
                    "no CPU mode (chip_smoke.py runs it on the card)")
    return torch.device("cuda")


# rank 32 / 8 / 12 / 5 cover the 16-, 8-, 4- and 1-byte load paths;
# tile 16384 is the serving tile; c = tile emits every item of a tile
@pytest.mark.parametrize("n_items,tile,rank,b,cand", [
    (3000, 256, 32, 8, 1),
    (3000, 256, 32, 8, 16),
    (1000, 128, 8, 3, 4),
    (1000, 128, 12, 5, 7),
    (500, 64, 5, 2, 3),
    (40000, 16384, 32, 4, 16),
    (200, 128, 16, 2, 128),
])
@pytest.mark.parametrize("masked", [False, True])
def test_shortlist_kernel_matches_plain_on_card(cuda_device, n_items, tile,
                                                rank, b, cand, masked):
    u, tiles, scales, mask = _inputs(n_items, tile, rank, b, n_items + rank,
                                     cuda_device)
    m = mask if masked else None
    before = kernels.SHORTLIST_LAUNCHES
    got = shortlist_topc(u, tiles, scales, n_items, m, cand)
    torch.cuda.synchronize()
    assert kernels.SHORTLIST_LAUNCHES == before + 1
    want = shortlist_topc_reference(u, tiles, scales, n_items, m, cand)
    _assert_match(got, want)


def test_shortlist_kernel_refuses_bad_inputs_on_card(cuda_device):
    u, tiles, scales, mask = _inputs(300, 128, 16, 2, 0, cuda_device)
    with pytest.raises(ValueError, match="cand"):
        shortlist_topc(u, tiles, scales, 300, None, 129)
    with pytest.raises(ValueError, match="mask shape"):
        shortlist_topc(u, tiles, scales, 300, mask[:, :10].contiguous(), 1)
    with pytest.raises(ValueError, match="u:"):
        shortlist_topc(u.double(), tiles, scales, 300, None, 1)
    with pytest.raises(ValueError, match="shape mismatch"):
        shortlist_topc(u[:, :8].contiguous(), tiles, scales, 300, None, 1)


def test_cpu_tensors_take_the_plain_version():
    u, tiles, scales, mask = _inputs(300, 128, 16, 2, 0, "cpu")
    before = kernels.SHORTLIST_LAUNCHES
    got = shortlist_topc(u, tiles, scales, 300, mask, 4)
    want = shortlist_topc_reference(u, tiles, scales, 300, mask, 4)
    _assert_match(got, want)
    assert kernels.SHORTLIST_LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.shortlist_topc_cuda(u, tiles, scales, 300, mask, 4)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernels.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build_all()


def test_launch_counts_reset():
    kernels.SPD_SOLVE_LAUNCHES = 5
    kernels.reset_counts()
    assert kernels.counts() == {"shortlist": 0, "spd_solve": 0}


def _spd_inputs(s, k, seed, device):
    """Half-sweep-like systems, made on ``device`` from a seeded
    generator: the Gramian of random factors over cnt <= 24 ratings and
    its ridge 0.01 * max(cnt, 1) kept apart as ``lam``; about 1% of
    segments empty (gram = 0, b = 0). Returns (gram, lam, b, empty)."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = 24
    cnt = torch.randint(1, n + 1, (s,), generator=g, device=device)
    cnt[torch.rand((s,), generator=g, device=device) < 0.01] = 0
    cnt[0] = 0                                # at least one empty segment
    w = (torch.arange(n, device=device)[None, :] < cnt[:, None]).float()
    f = torch.randn((s, n, k), generator=g, device=device) / k ** 0.5
    r = torch.randint(1, 6, (s, n), generator=g, device=device).float()
    fw_t = (f * w[..., None]).transpose(1, 2)
    gram = torch.bmm(fw_t, f).contiguous()
    lam = 0.01 * cnt.clamp_min(1).float()
    b = torch.bmm(fw_t, r[..., None])[..., 0].contiguous()
    return gram, lam, b, cnt == 0


def _check_spd(gram, lam, b, empty, with_diag):
    """One launch, held to the plain version on ``gram + lam I + 1e-6 I``:
    either the kernel adds the diagonal (``with_diag``) or it is given
    the sum. A must come back unchanged."""
    jitter = 1e-6
    summed = with_diagonal(gram, lam, jitter)
    A = gram if with_diag else summed
    before_A = A.clone()
    before = kernels.SPD_SOLVE_LAUNCHES
    if with_diag:
        got = spd_solve(A, b, lam, jitter)
    else:
        got = spd_solve(A, b)
    torch.cuda.synchronize()
    assert kernels.SPD_SOLVE_LAUNCHES == before + 1
    assert torch.equal(A, before_A)
    want = cholesky_solve_vec(summed, b)
    s, k = b.shape
    assert got.shape == want.shape == (s, k)
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= 1e-4 * max(1.0, float(want.abs().max())), err
    assert (got[empty] == 0).all()


@pytest.mark.parametrize("k", [1, 3, 10, 16, 33, 64])
@pytest.mark.parametrize("s", [1, 129, 4097, 27_000, 138_000])
@pytest.mark.parametrize("with_diag", [False, True])
def test_spd_solve_kernel_matches_plain_on_card(cuda_device, s, k,
                                                with_diag):
    """The smoke's shapes (S up to 138,000 users, K up to 64) and odd K,
    with the ridge given as ``diag`` and already summed into A."""
    _check_spd(*_spd_inputs(s, k, s + k, cuda_device), with_diag)


@pytest.mark.parametrize("k", range(1, 65))
@pytest.mark.parametrize("s", [1, 127, 128, 129, 4097])
def test_spd_solve_every_k_on_card(cuda_device, s, k):
    """Every K the kernel takes: each of regime A's 16 instantiations
    (one system per thread, blocks of 64 or 128 systems, so S = 127,
    128 and 129 are a ragged, a full and a one-over block) and regime
    B's two ceilings (one warp per system, K = 17..32 and 33..64)."""
    _check_spd(*_spd_inputs(s, k, 1000 * k + s, cuda_device), True)


@pytest.mark.parametrize("k", [4, 12, 16, 17, 40, 64])
def test_spd_solve_floored_pivot_on_card(cuda_device, k):
    """A pivot at or below the 1e-30 floor: row and column j of A are
    zero but for A[j][j] = -1 (and 0 in a second system), so d =
    rsqrt(1e-30) and L[j][j] = A[j][j] * d; the kernel must agree with
    the plain version, which divides by that L[j][j]."""
    gram, lam, b, _ = _spd_inputs(3, k, 7 * k, cuda_device)
    A = with_diagonal(gram, lam, 1e-6)
    j = k // 2
    A[:, j, :] = 0.0
    A[:, :, j] = 0.0
    A[0, j, j] = -1.0
    A[1, j, j] = 1e-31
    b[1, j] = 0.0
    want = cholesky_solve_vec(A, b)
    assert torch.isfinite(want[:2]).all()
    got = spd_solve(A.contiguous(), b)
    torch.cuda.synchronize()
    assert torch.isfinite(got[:2]).all()
    err = float((got[:2] - want[:2]).abs().max())
    assert err <= 1e-4 * max(1.0, float(want[:2].abs().max())), err


@pytest.mark.parametrize("k", [12, 16, 17, 24, 40, 64])
def test_spd_solve_floored_pivots_in_full_rows_on_card(cuda_device, k):
    """Three adjacent pivots at the 1e-30 floor (A[j][j] = -1) whose rows
    and columns are not zeroed: entries of 1e-15 scale with every other
    row, so L[i][j] = A[i][j] * rsqrt(1e-30) is of order 1 and L[j][j]
    about -1e15, while the three rows are 0 to one another. The plain
    version stays finite; the kernel must agree with it, so no product
    of those large entries may reach a finished column."""
    rng = np.random.default_rng(k)
    m = rng.normal(size=(k, 3 * k))
    a = m @ m.T / (3 * k) + 10.0 * np.eye(k)
    js = [k // 2 - 1, k // 2, k // 2 + 1]
    for j in js:
        v = 1e-15 * rng.uniform(-0.5, 0.5, size=k)
        a[j, :] = v
        a[:, j] = v
    for j in js:
        a[j, js] = 0.0
        a[j, j] = -1.0
    A = torch.tensor(a[None], dtype=torch.float32, device=cuda_device)
    b = torch.tensor(rng.normal(size=(1, k)), dtype=torch.float32,
                     device=cuda_device)
    want = cholesky_solve_vec(A, b)
    assert torch.isfinite(want).all()
    got = spd_solve(A, b)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= 1e-4 * max(1.0, float(want.abs().max())), err


def test_spd_solve_kernel_refuses_bad_inputs_on_card(cuda_device):
    gram, lam, b, _ = _spd_inputs(4, 8, 0, cuda_device)
    A = with_diagonal(gram, lam, 1e-6)
    with pytest.raises(ValueError, match="A:"):
        kernels.spd_solve_cuda(A.double(), b)
    with pytest.raises(ValueError, match="shape mismatch"):
        kernels.spd_solve_cuda(A, b[:, :4].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.spd_solve_cuda(A.transpose(1, 2), b)
    big = torch.eye(65, device=cuda_device).expand(2, 65, 65).contiguous()
    with pytest.raises(ValueError, match="K=65"):
        kernels.spd_solve_cuda(big, torch.zeros((2, 65), device=cuda_device))
    with pytest.raises(ValueError, match="diag:"):
        kernels.spd_solve_cuda(gram, b, lam.double())
    with pytest.raises(ValueError, match="diag shape"):
        kernels.spd_solve_cuda(gram, b, lam[:3].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.spd_solve_cuda(gram, b, torch.stack([lam, lam], 1)[:, 0])
    with pytest.raises(ValueError, match="diag is on"):
        kernels.spd_solve_cuda(gram, b, lam.cpu())


def test_spd_solve_cpu_tensors_take_the_plain_version():
    gram, lam, b, empty = _spd_inputs(50, 10, 1, "cpu")
    A = with_diagonal(gram, lam, 1e-6)
    before = kernels.SPD_SOLVE_LAUNCHES
    got = spd_solve(A, b)
    assert kernels.SPD_SOLVE_LAUNCHES == before
    assert torch.equal(got, cholesky_solve_vec(A, b))
    assert empty.any() and (got[empty] == 0).all()
    # the ridge given apart: the same sum, the same answer, A unchanged
    gram_before = gram.clone()
    assert torch.equal(spd_solve(gram, b, lam, 1e-6), got)
    assert torch.equal(gram, gram_before)
    assert kernels.SPD_SOLVE_LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.spd_solve_cuda(A, b)
