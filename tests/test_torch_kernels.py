"""The hand-written CUDA kernels against their plain PyTorch versions.

The kernel tests need a CUDA device and nvcc (a kernel has no CPU mode)
and skip without one. This file imports neither jax nor the JAX
package, so on the card it runs without the repo's conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

The wrappers' CPU dispatch, their input checks and the shortlist
kernel's launch plans (shared memory, cluster size, rows per group) run
everywhere.

Tolerances. Shortlist: vals rtol 1e-5 / atol 1e-6 (f32 sums in another
order); ids equal wherever the value is finite (random int8 data,
tie-free). Shortlist on tie-heavy data (small integers, one scale, so
every score is exact in f32 in any order): values and ids equal to a
stable numpy order by (value desc, id asc). SPD solve: max |x - x_plain| <= 1e-4 * max(1, max |x_plain|)
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


def _forced_plan(b, nt, tile, rank, cand, masked=False, rows=None,
                 cluster=None, list_size=None):
    """The wrapper's plan with some of its parts forced (the card tests
    reach instances and cluster sizes the served shapes do not pick)."""
    auto = kernels.shortlist_plan(b, nt, tile, rank, cand, masked)
    return kernels.make_shortlist_plan(
        b, nt, tile, rank, cand, masked,
        auto.list_size if list_size is None else list_size,
        auto.rows if rows is None else rows,
        auto.cluster if cluster is None else cluster,
        auto.stage_items, auto.chunk, auto.sort_smem)


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


def _tie_inputs(n_items, tile, rank, b, seed, device, finite=None):
    """Tie-heavy shortlist inputs: int8 entries in [-2, 2], query rows in
    [-3, 3] and one power-of-two scale, so each score is a small multiple
    of 1/128, exact in f32 whatever the order of the sum, and most of a
    tile shares a handful of values. ``finite`` keeps only that many
    unmasked items per row and tile (the rest masked)."""
    g = np.random.default_rng(seed)
    nt = -(-n_items // tile)
    tiles = g.integers(-2, 3, (nt, tile, rank)).astype(np.int8)
    scales = np.full((nt, tile), 1 / 128, np.float32)
    u = g.integers(-3, 4, (b, rank)).astype(np.float32)
    mask = np.zeros((b, nt * tile), bool)
    if finite is not None:
        for t in range(nt):
            keep = g.permutation(tile)[:finite]
            m = np.ones(tile, bool)
            m[keep] = False
            mask[:, t * tile:(t + 1) * tile] = m
    arrays = [u, tiles, scales, mask]
    return arrays, [torch.from_numpy(a).to(device) for a in arrays]


def _stable_topc(u, tiles, scales, mask, n_items, cand):
    """Each tile's top-``cand`` in the stable order (value desc, id asc),
    -inf for padding and masked items; [B, nt*cand] values and ids, the
    ids of -inf slots left out of the comparison (-1)."""
    nt, tile, _ = tiles.shape
    sc = np.einsum("br,ntr->bnt", u.astype(np.float64),
                   tiles.astype(np.float64)) * scales[None].astype(np.float64)
    sc = sc.reshape(u.shape[0], nt * tile).astype(np.float32)
    ids = np.arange(nt * tile)
    sc[:, ids >= n_items] = -np.inf
    sc[mask] = -np.inf
    vals = np.empty((u.shape[0], nt * cand), np.float32)
    out = np.empty((u.shape[0], nt * cand), np.int64)
    for t in range(nt):
        block = sc[:, t * tile:(t + 1) * tile]
        order = np.argsort(-block, axis=1, kind="stable")[:, :cand]
        v = np.take_along_axis(block, order, 1)
        vals[:, t * cand:(t + 1) * cand] = v
        out[:, t * cand:(t + 1) * cand] = np.where(np.isfinite(v),
                                                   order + t * tile, -1)
    return vals, out


def _assert_stable(got, want):
    gv, gi = (a.cpu().numpy() for a in got)
    wv, wi = want
    assert gv.shape == wv.shape
    assert np.array_equal(np.isfinite(gv), np.isfinite(wv))
    fin = np.isfinite(wv)
    assert np.array_equal(gv[fin], wv[fin])
    assert np.array_equal(gi[fin], wi[fin])


# (n_items, tile, rank, b, cand): c = T; the list sizes' edges (2, 3,
# 16, 17 = the first c that keeps every score); the tensor-core product
# (R 32, groups of 8 rows, c <= 4); a cluster of 8 at T 4096;
# B not a multiple of the row group; R 8, 10 (2-byte rows) and 32
@pytest.mark.parametrize("n_items,tile,rank,b,cand", [
    (4096, 4096, 8, 1, 512),
    (4096, 4096, 10, 3, 1024),
    (8192, 4096, 32, 8, 16),
    (8192, 4096, 32, 8, 17),
    (20000, 4096, 32, 64, 4),
    (5000, 4096, 10, 64, 2),
    (5000, 4096, 8, 5, 3),
    (300, 128, 32, 2, 128),
    (40000, 16384, 10, 3, 256),
])
def test_shortlist_ties_keep_stable_order_on_card(cuda_device, n_items, tile,
                                                  rank, b, cand):
    arrays, ts = _tie_inputs(n_items, tile, rank, b, n_items + cand,
                             cuda_device)
    got = shortlist_topc(ts[0], ts[1], ts[2], n_items, None, cand)
    torch.cuda.synchronize()
    _assert_stable(got, _stable_topc(*arrays, n_items, cand))


@pytest.mark.parametrize("cand", [2, 16, 100])
def test_shortlist_fewer_finite_than_c_on_card(cuda_device, cand):
    """A mask that leaves 7 finite scores a tile: those 7 in order, then
    -inf in every later slot."""
    arrays, ts = _tie_inputs(12288, 4096, 8, 3, cand, cuda_device, finite=7)
    got = shortlist_topc(ts[0], ts[1], ts[2], 12288, ts[3], cand)
    torch.cuda.synchronize()
    want = _stable_topc(*arrays, 12288, cand)
    _assert_stable(got, want)
    finite = np.isfinite(want[0]).reshape(3, 3, cand).sum(axis=2)
    assert (finite == min(7, cand)).all()


@pytest.mark.parametrize("cand", [1, 16, 300])
def test_shortlist_ragged_tile_with_padding_slices_on_card(cuda_device,
                                                           cand):
    """The last of two 4096-item tiles holds 700 items: with a cluster of
    8 (slices of 512) its CTAs 2..7 score only padding."""
    n_items = 4096 + 700
    u, tiles, scales, mask = _inputs(n_items, 4096, 16, 2, 11, cuda_device)
    plan = _forced_plan(2, 2, 4096, 16, cand, cluster=8)
    assert plan.cluster == 8 and plan.slice_items == 512
    got = kernels._shortlist_launch(plan, u, tiles, scales, n_items, None,
                                    cand)
    torch.cuda.synchronize()
    want = shortlist_topc_reference(u, tiles, scales, n_items, None, cand)
    _assert_match(got, want)


@pytest.mark.parametrize("cand", [2, 16])
@pytest.mark.parametrize("cluster", [None, 2])
def test_shortlist_many_clusters_on_card(cuda_device, cand, cluster):
    """Hundreds of clusters at once (245 tiles of 16384, as the serve
    cell's grid): CTAs of a cluster finish scoring at different times, and
    one's results must not land in another's staging buffers."""
    n_items = 245 * 16384 - 1000
    u, tiles, scales, mask = _inputs(n_items, 16384, 32, 1, cand,
                                     cuda_device)
    plan = _forced_plan(1, 245, 16384, 32, cand, cluster=cluster)
    assert plan.cluster > 1
    got = kernels._shortlist_launch(plan, u, tiles, scales, n_items, None,
                                    cand)
    torch.cuda.synchronize()
    _assert_match(got, shortlist_topc_reference(u, tiles, scales, n_items,
                                                None, cand))


@pytest.mark.parametrize("b", [1, 3, 8, 64])
@pytest.mark.parametrize("rank", [8, 10, 32])
def test_shortlist_batches_and_ranks_on_card(cuda_device, b, rank):
    u, tiles, scales, mask = _inputs(20000, 4096, rank, b, b * rank,
                                     cuda_device)
    for cand, m in ((2, None), (16, mask), (512, mask), (1024, None)):
        got = shortlist_topc(u, tiles, scales, 20000, m, cand)
        torch.cuda.synchronize()
        _assert_match(got, shortlist_topc_reference(u, tiles, scales, 20000,
                                                    m, cand))


@pytest.mark.parametrize("cand", [2, 300, 8192, 32768])
def test_shortlist_largest_tile_on_card(cuda_device, cand):
    """T = 32768, the kernel's largest tile: c 8192 sorts in shared
    memory, c = T in the wrapper's global scratch."""
    u, tiles, scales, mask = _inputs(40000, 32768, 8, 2, cand, cuda_device)
    plan = kernels.shortlist_plan(2, 2, 32768, 8, cand, True)
    assert plan.sort_smem == (cand < 32768)
    got = shortlist_topc(u, tiles, scales, 40000, mask, cand)
    torch.cuda.synchronize()
    _assert_match(got, shortlist_topc_reference(u, tiles, scales, 40000,
                                                mask, cand))


def _instances():
    """Every compiled (C, rows) of the kernel, with the c it is forced at."""
    out = [(0, br, 40) for br in (1, 2, 4, 8)]
    for c in kernels.SHORTLIST_LIST_SIZES:
        out += [(c, br, c - 1 if c > 2 else 1) for br in (1, 2, 4, 8)
                if br <= kernels.shortlist_max_rows(c)]
    return out


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("inst", _instances())
def test_shortlist_every_instance_and_cluster_on_card(cuda_device, inst,
                                                      cluster):
    """Each template instance of the kernel at each cluster size, forced
    through the plan, at a ragged B and a masked batch."""
    c, br, cand = inst
    b = br + 1
    u, tiles, scales, mask = _inputs(9000, 4096, 12, b, cand + br,
                                     cuda_device)
    plan = _forced_plan(b, 3, 4096, 12, cand, True, rows=br,
                        cluster=cluster, list_size=c)
    assert (plan.list_size, plan.rows, plan.cluster) == (c, br, cluster)
    before = kernels.SHORTLIST_LAUNCHES
    got = kernels._shortlist_launch(plan, u, tiles, scales, 9000, mask, cand)
    torch.cuda.synchronize()
    assert kernels.SHORTLIST_LAUNCHES == before + 1
    _assert_match(got, shortlist_topc_reference(u, tiles, scales, 9000, mask,
                                                cand))


def test_shortlist_smem_formula_matches_kernel_on_card(cuda_device):
    """The host's shared-memory formula against the kernel's own layout,
    over a grid of plans (the launch refuses a disagreement)."""
    lib = kernels._lib("shortlist")
    for c, br, _ in _instances():
        for g in (1, 2, 4, 8):
            for tile, rank, cand in ((4096, 10, 1024), (16384, 32, 16),
                                     (32768, 8, 32768), (100, 5, 3),
                                     (1024, 5000, 300)):
                if c and cand > c:
                    cand = c
                for stage, chunk in (
                        [(x, rank) for x in kernels.SHORTLIST_STAGE_ITEMS]
                        + [(256, x) for x in (16, 48, 256) if x < rank]):
                    for sort_smem in (True, False):
                        for masked in (False, True):
                            want = kernels.shortlist_smem_bytes(
                                c, br, g, tile, rank, cand, stage,
                                sort_smem, masked, chunk)
                            got = lib.pio_shortlist_smem_bytes(
                                c, br, g, tile, rank, cand, stage,
                                int(sort_smem), int(masked), chunk)
                            assert got == want, (c, br, g, tile, rank,
                                                 cand, stage, chunk, masked)


@pytest.mark.parametrize("rank", [300, 500])
@pytest.mark.parametrize("b,cand,masked", [
    (1, 2, False), (3, 16, True), (8, 16, False), (2, 12, True),
    (64, 4, False),
])
def test_shortlist_long_rows_match_plain_on_card(cuda_device, rank, b, cand,
                                                 masked):
    """Scan ranks whose rows do not fit stages of 256 items: smaller
    stages (and clusters) take them."""
    u, tiles, scales, mask = _inputs(9000, 4096, rank, b, rank + cand,
                                     cuda_device)
    plan = kernels.shortlist_plan(b, 3, 4096, rank, cand, masked)
    assert plan.stage_items < 256
    m = mask if masked else None
    got = shortlist_topc(u, tiles, scales, 9000, m, cand)
    torch.cuda.synchronize()
    _assert_match(got, shortlist_topc_reference(u, tiles, scales, 9000, m,
                                                cand))


# long rows held exactly (values near 0 of a sum of hundreds of terms
# carry f32 errors above the file's atol): R 300 and 500 on stages under
# 256 items, c 512 on a ragged tile; rows of 4800 and 5000 bytes on
# stages of 256 items holding a chunk of each row: 16-byte copies
# (4800), byte copies (5000, 8 mod 16)
@pytest.mark.parametrize("n_items,tile,rank,b,cand", [
    (9000, 4096, 300, 2, 512),
    (9000, 4096, 500, 2, 512),
    (2048, 1024, 4800, 2, 16),
    (2048, 1024, 4800, 9, 2),
    (1024, 1024, 5000, 1, 300),
    (1500, 1024, 5000, 3, 8),
])
def test_shortlist_chunked_rows_keep_stable_order_on_card(
        cuda_device, n_items, tile, rank, b, cand):
    arrays, ts = _tie_inputs(n_items, tile, rank, b, rank + cand,
                             cuda_device)
    nt = -(-n_items // tile)
    plan = kernels.shortlist_plan(b, nt, tile, rank, cand)
    assert plan.chunk < rank or plan.stage_items < 256
    got = shortlist_topc(ts[0], ts[1], ts[2], n_items, None, cand)
    torch.cuda.synchronize()
    _assert_stable(got, _stable_topc(*arrays, n_items, cand))


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


#: (B, nt, T, R, c) of every shortlist call the smoke and the served
#: configurations make: the 10M-item serve cell (611 tiles of 16384, scan
#: rank 32) at B 1/8/64 and each query kind's c; similar-product's ML-1M
#: catalog (one tile of 4096, c 512 and 1024) and the 27,000-item catalog
#: (two tiles of 16384, c 256) at R 8 and 10; the ML-100k lifecycle and
#: e-commerce catalogs (one tile, c 512); the tie row; T = 32768.
_SERVED_SHAPES = sorted(
    {(b, 611, 16384, 32, c) for b in (1, 8, 64) for c in (1, 2, 4, 16)}
    | {(b, nt, t, r, c) for b in (1, 8, 64) for r in (8, 10)
       for nt, t, c in ((1, 4096, 512), (1, 4096, 1024), (2, 16384, 256))}
    | {(b, 1, 2048, 10, 512) for b in (1, 8, 64)}
    | {(b, 1, 2048, 10, c) for b in (1, 4) for c in (16, 32)}
    | {(1, 1, 32768, 8, 32768), (64, 1, 32768, 32, 32768),
       (64, 2, 32768, 32, 4096), (1, 6, 16384, 64, 2),
       (64, 611, 16384, 64, 16), (8, 1, 4096, 8, 1024)})


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", _SERVED_SHAPES)
def test_shortlist_plan_fits_the_card(shape, masked):
    b, nt, t, r, cand = shape
    plan = kernels.shortlist_plan(b, nt, t, r, cand, masked)
    assert plan.masked == masked
    assert plan.smem_bytes <= kernels.SMEM_LIMIT
    assert plan.cluster in (1, 2, 4, 8)
    assert plan.cluster <= kernels.SHORTLIST_MAX_CLUSTER
    assert plan.rows in (1, 2, 4, 8)
    if plan.list_size:
        assert cand <= plan.list_size
        assert plan.list_size in kernels.SHORTLIST_LIST_SIZES
        assert plan.rows <= kernels.shortlist_max_rows(plan.list_size)
        if plan.list_size != kernels.SHORTLIST_QUEUE:
            assert plan.list_size * plan.rows <= 32
    else:
        assert cand > max(kernels.SHORTLIST_LIST_SIZES)
    assert plan.groups * plan.rows >= b > (plan.groups - 1) * plan.rows
    assert plan.ctas == plan.cluster * nt * plan.groups
    assert plan.slice_items * plan.cluster >= t
    assert plan.slice_items % 16 == 0
    assert plan.smem_bytes == kernels.shortlist_smem_bytes(
        plan.list_size, plan.rows, plan.cluster, t, r, cand,
        plan.stage_items, plan.sort_smem, masked, plan.chunk)
    assert plan.chunk == r
    assert plan == kernels.shortlist_plan(b, nt, t, r, cand, masked)


@pytest.mark.parametrize("rank", [100, 300, 500, 1000, 4800, 5000, 20000,
                                  60000])
@pytest.mark.parametrize("tile,cand", [(1024, 16), (4096, 2), (4096, 512),
                                       (32768, 32768)])
def test_shortlist_plan_takes_long_rows(rank, tile, cand):
    """Every scan rank fits: stages shrink to 16 items, then hold a chunk
    (a multiple of 16 bytes) of each row, 256 items at a time."""
    for b in (1, 64):
        plan = kernels.shortlist_plan(b, 2, tile, rank, cand, True)
        assert plan.smem_bytes <= kernels.SMEM_LIMIT
        assert plan.stage_items in kernels.SHORTLIST_STAGE_ITEMS
        if plan.chunk < rank:
            assert plan.chunk % 16 == 0 and plan.stage_items == 256
        else:
            assert plan.chunk == rank
        assert plan.smem_bytes == kernels.shortlist_smem_bytes(
            plan.list_size, plan.rows, plan.cluster, tile, rank, cand,
            plan.stage_items, plan.sort_smem, True, plan.chunk)


@pytest.mark.parametrize("b,nt,t,cluster", [
    (1, 611, 16384, 2), (8, 611, 16384, 1), (64, 611, 16384, 1),
    (1, 1, 4096, 8), (64, 1, 4096, 8), (1, 2, 16384, 8), (1, 1, 256, 1),
])
def test_shortlist_plan_spreads_small_grids_over_clusters(b, nt, t, cluster):
    """A tile is split over more CTAs only while the grid's CTAs times
    rows is small next to the card and each slice keeps at least
    SHORTLIST_MIN_SLICE items."""
    plan = kernels.shortlist_plan(b, nt, t, 32, 2)
    assert plan.cluster == cluster
    assert (plan.ctas * plan.rows >= kernels.SHORTLIST_MIN_CTAS
            or plan.cluster == 8
            or -(-t // (2 * plan.cluster)) < kernels.SHORTLIST_MIN_SLICE)


def test_shortlist_plan_row_groups_and_limits():
    assert kernels.shortlist_plan(3, 1, 4096, 10, 2).rows == 4
    assert kernels.shortlist_plan(64, 1, 4096, 10, 16).rows == 8
    assert kernels.shortlist_plan(64, 1, 4096, 10, 16).list_size == 16
    assert kernels.shortlist_plan(64, 1, 4096, 10, 8).rows == 4
    assert kernels.shortlist_plan(64, 1, 4096, 10, 17).rows == 8
    # the tensor cores take R 32, groups of 8 rows and lists of 2 or 4
    for b, r, cand, tc in ((64, 32, 2, True), (8, 32, 4, True),
                           (5, 32, 1, True), (4, 32, 2, False),
                           (64, 10, 2, False), (64, 32, 5, False),
                           (64, 32, 300, False)):
        plan = kernels.shortlist_plan(b, 1, 4096, r, cand)
        assert plan.tensor_cores == tc, (b, r, cand)
    # a sort of 32768 keys does not fit beside the rest: global scratch
    assert not kernels.shortlist_plan(1, 1, 32768, 8, 32768).sort_smem
    assert kernels.shortlist_plan(1, 1, 32768, 8, 8192).sort_smem
    # large R: the stage shrinks to one item a thread, then further, then
    # holds chunks of the rows and of u
    assert kernels.shortlist_plan(1, 1, 4096, 200, 512).stage_items == 256
    assert kernels.shortlist_plan(1, 1, 4096, 500, 512).stage_items == 128
    assert kernels.shortlist_plan(1, 1, 1024, 5000, 16).chunk < 5000
    assert kernels.shortlist_plan(1, 1, 1000, 60000, 2).chunk < 60000
    # a mask adds each row's bytes to every stage
    assert (kernels.shortlist_plan(8, 1, 4096, 32, 2, True).smem_bytes
            == kernels.shortlist_plan(8, 1, 4096, 32, 2).smem_bytes
            + 3 * 8 * 512)


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
