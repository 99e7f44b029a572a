"""The hand-written CUDA kernels against their plain PyTorch versions.

The kernel tests need a CUDA device and nvcc (the kernel has no CPU
mode) and skip without one. This file imports neither jax nor the JAX
package, so on the card it runs without the repo's conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

The wrapper's CPU dispatch and its input checks run everywhere.

Tolerance: vals rtol 1e-5 / atol 1e-6 (f32 sums in another order); ids
equal wherever the value is finite (random int8 data, tie-free).
"""

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.ops import kernels
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
    kernels.reset_counts()
    assert kernels.counts() == {"shortlist": 0}
