"""The port's scorers (predictionio_tpu_torch/ops/scoring.py) against the
reference's (predictionio_tpu/ops/scoring.py), on the same numpy inputs:

* quantization, the principal rotation and tile packing are bit-equal,
  and so are the tiles and scales a built scorer holds;
* the shortlist kernel's plain version matches the reference's
  ``_shortlist_scan`` (masked and unmasked, c in {1, 4, 16}, a ragged
  last tile) and, unmasked, the Pallas kernel in interpret mode;
* the two-stage scorer asks stage 1 for the reference's per-tile
  candidate count at every k, masked and unmasked;
* ``ItemScorer.topk`` matches for the four non-exact modes, and the
  parity gate demotes in the same cases;
* ``merge_topk`` keeps the reference's tie rule;
* the scorer knobs resolve with the reference's precedence.

Tolerances: vals/scores rtol 1e-5 — the products run in another order in
torch than in XLA; ids equal wherever the value is finite (the data is
tie-free). The CUDA kernel itself is held against the plain version on
the card by tests/test_torch_kernels.py and, at the serving shapes, by
chip_smoke.py.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from predictionio_tpu.ops import scoring as ref
from predictionio_tpu.ops.topk import merge_topk as ref_merge_topk
from predictionio_tpu.utils.server_config import ScorerConfig as RefConfig
from predictionio_tpu_torch.ops import kernels
from predictionio_tpu_torch.ops import scoring as port
from predictionio_tpu_torch.ops.topk import host_topk, merge_topk
from predictionio_tpu_torch.utils.server_config import (
    ScorerConfig, scorer_config,
)

NONEXACT_MODES = ("fused", "fused_bf16", "fused_int8", "twostage")
CPU = torch.device("cpu")


def _factors(n, k=12, seed=0, decay=1.2):
    """ALS-like factors under a geometrically decaying spectrum."""
    rng = np.random.default_rng(seed)
    spec = np.power(10.0, -decay * np.arange(k) / max(1, k - 1))
    return (rng.standard_normal((n, k)) * spec).astype(np.float32)


# ---------------------------------------------------------------------------
# host-side packing: bit-equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,seed", [(1, 4, 0), (300, 12, 1),
                                      (1000, 32, 2), (257, 64, 3)])
def test_quantize_rotate_pack_bit_equal(n, k, seed):
    v = _factors(n, k=k, seed=seed)
    v[0] = 0.0                          # zero row: scale 1
    q_p, s_p = port._quantize_int8(v)
    q_r, s_r = ref._quantize_int8(v)
    assert q_p.dtype == q_r.dtype and np.array_equal(q_p, q_r)
    assert np.array_equal(s_p, s_r)
    rot_p, dims_p = port._principal_rotation(v)
    rot_r, dims_r = ref._principal_rotation(v)
    assert dims_p == dims_r and np.array_equal(rot_p, rot_r)
    for tile in (1, 128, 256):
        (t_p, n_p), (t_r, n_r) = (port._pack_tiles(q_p, tile),
                                  ref._pack_tiles(q_r, tile))
        assert n_p == n_r and np.array_equal(t_p, t_r)
        assert port._pow2_tile(tile, n) == ref._pow2_tile(tile, n)


def test_bucketing_and_vocab_lookups_match_reference():
    from predictionio_tpu.data import bimap as ref_bimap
    from predictionio_tpu.ops import bucketing as ref_bucketing
    from predictionio_tpu_torch.data import bimap
    from predictionio_tpu_torch.ops import bucketing

    for n in range(-1, 70):
        for cap in (None, 0, 8, 48, 64):
            assert (bucketing.bucket_size(n, cap)
                    == ref_bucketing.bucket_size(n, cap))
            assert (bucketing.padding_waste(n, 64)
                    == ref_bucketing.padding_waste(n, 64))
        assert bucketing.bucket_count(n) == ref_bucketing.bucket_count(n)
    rows = np.arange(6, dtype=np.float32).reshape(3, 2)
    assert np.array_equal(bucketing.pad_rows(rows, 4, fill=-1.0),
                          ref_bucketing.pad_rows(rows, 4, fill=-1.0))
    vocab = np.sort(np.asarray(["a", "c", "e", "g"], dtype=object))
    keys = ["a", "b", "g", "z", ""]
    assert np.array_equal(bimap.batch_lookup(vocab, keys),
                          ref_bimap.batch_lookup(vocab, keys))
    # the port's model files hold fixed-width unicode vocabularies
    assert np.array_equal(bimap.batch_lookup(vocab.astype(str), keys),
                          ref_bimap.batch_lookup(vocab, keys))
    for key in keys:
        assert (bimap.vocab_index(vocab.astype(str), key)
                == ref_bimap.vocab_index(vocab, key))


# ---------------------------------------------------------------------------
# the shortlist kernel's plain version
# ---------------------------------------------------------------------------

def _shortlist_inputs(n_items=300, tile=128, rank=16, b=4, seed=0):
    v = _factors(n_items, k=rank, seed=seed)
    q, s = port._quantize_int8(v)
    tiles, n_pad = port._pack_tiles(q, tile)
    scales, _ = port._pack_tiles(s, tile)
    u = _factors(b, k=rank, seed=seed + 1)
    mask = np.random.default_rng(seed + 2).random((b, n_pad)) < 0.4
    mask[:, n_items:] = True
    return u, tiles, scales, mask


def _assert_shortlists_match(got, want):
    gv, gi = (np.asarray(a) for a in got)
    wv, wi = (np.asarray(a) for a in want)
    assert gv.shape == wv.shape and gi.shape == wi.shape
    fin = np.isfinite(wv)
    assert np.array_equal(fin, np.isfinite(gv))
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=1e-5, atol=1e-6)
    assert np.array_equal(gi[fin], wi[fin])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cand", [1, 4, 16])
def test_shortlist_reference_matches_shortlist_scan(cand, masked):
    n_items, tile = 300, 128             # 3 tiles, the last one ragged
    u, tiles, scales, mask = _shortlist_inputs(n_items, tile)
    m = mask if masked else None
    want = ref._shortlist_scan(
        jnp.asarray(u), jnp.asarray(tiles), jnp.asarray(scales),
        jnp.int32(n_items), jnp.asarray(m) if masked else None, cand, tile)
    got = port.shortlist_topc_reference(
        torch.from_numpy(u), torch.from_numpy(tiles),
        torch.from_numpy(scales), n_items,
        torch.from_numpy(m) if masked else None, cand)
    _assert_shortlists_match(got, want)
    # the dispatching wrapper takes the plain version for CPU tensors,
    # and launches nothing
    before = kernels.SHORTLIST_LAUNCHES
    again = port.shortlist_topc(
        torch.from_numpy(u), torch.from_numpy(tiles),
        torch.from_numpy(scales), n_items,
        torch.from_numpy(m) if masked else None, cand)
    _assert_shortlists_match(again, want)
    assert kernels.SHORTLIST_LAUNCHES == before


@pytest.mark.parametrize("cand", [1, 4])
def test_shortlist_reference_matches_pallas_interpret(cand):
    pytest.importorskip("jax.experimental.pallas")
    n_items, tile, rank = 256, 128, 8
    u, tiles, scales, _ = _shortlist_inputs(n_items, tile, rank=rank, b=4,
                                            seed=60)
    nt, b = tiles.shape[0], u.shape[0]
    fn = ref.build_pallas_shortlist(tile, cand, interpret=True)
    vals, ids = fn(u, tiles, scales, n_items)
    # [nt, B, c] -> [B, nt * c], the layout of _shortlist_scan
    want = (np.moveaxis(np.asarray(vals), 0, 1).reshape(b, nt * cand),
            np.moveaxis(np.asarray(ids), 0, 1).reshape(b, nt * cand))
    got = port.shortlist_topc_reference(
        torch.from_numpy(u), torch.from_numpy(tiles),
        torch.from_numpy(scales), n_items, None, cand)
    _assert_shortlists_match(got, want)


# ---------------------------------------------------------------------------
# ItemScorer.topk and the parity gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", NONEXACT_MODES)
def test_item_scorer_topk_matches_reference(mode):
    n_items, k = 385, 10
    V = _factors(n_items, seed=3)
    U = _factors(6, seed=4)
    mask = np.random.default_rng(5).random((6, n_items)) < 0.3
    r = ref.build_scorer(V, RefConfig(mode=mode, tile_items=128,
                                      shortlist=64))
    p = port.build_scorer(V, ScorerConfig(mode=mode, tile_items=128,
                                          shortlist=64), device=CPU)
    assert (p.active_mode, p.scan_rank, p.n_tiles, p.cand_per_tile,
            p.factor_bytes) == (r.active_mode, r.scan_rank, r.n_tiles,
                                r.cand_per_tile, r.factor_bytes)
    assert p.recall_probe == r.recall_probe
    assert p.quant_error == pytest.approx(r.quant_error, rel=1e-6)
    for m in (None, mask):
        sc_r, ix_r = r.topk(U, k, mask=m)
        sc_p, ix_p = p.topk(U, k, mask=m)
        fin = np.isfinite(sc_r)
        assert np.array_equal(fin, np.isfinite(sc_p))
        assert np.array_equal(np.asarray(ix_p)[fin], np.asarray(ix_r)[fin])
        np.testing.assert_allclose(sc_p[fin], sc_r[fin], rtol=1e-5)


@pytest.mark.parametrize("mode", NONEXACT_MODES)
def test_built_scorer_bytes_match_reference(mode):
    """The built scorer's device tiles and scales (quantized and packed in
    torch) are the reference's bytes, a ragged last tile and a zero row
    included."""
    V = _factors(300, k=16, seed=9)
    V[7] = 0.0
    r = ref.build_scorer(V, RefConfig(mode=mode, tile_items=128))
    p = port.build_scorer(V, ScorerConfig(mode=mode, tile_items=128),
                          device=CPU)
    assert p.active and r.active

    def raw(a):
        a = np.asarray(a)
        return a.view(np.int16) if a.dtype.itemsize == 2 else a

    got = p._tiles.view(torch.int16) if p._tiles.dtype == torch.bfloat16 \
        else p._tiles
    assert np.array_equal(got.numpy(), raw(r._tiles))
    if r._scales is None:
        assert p._scales is None
    else:
        assert np.array_equal(p._scales.numpy(), np.asarray(r._scales))


def test_parity_gate_demotes_like_reference():
    rng = np.random.default_rng(17)
    near_tie = (np.ones((400, 8)) + 1e-5 * rng.standard_normal((400, 8))
                ).astype(np.float32)
    good = _factors(400, seed=18)
    for V, demoted in ((near_tie, True), (good, False)):
        r = ref.build_scorer(V, RefConfig(mode="fused_int8", tile_items=128))
        p = port.build_scorer(V, ScorerConfig(mode="fused_int8",
                                              tile_items=128), device=CPU)
        assert (not r.active) == demoted and (not p.active) == demoted
        assert p.recall_probe == r.recall_probe
        if demoted:
            assert p.factor_bytes == 0 and p._tiles is None
            with pytest.raises(RuntimeError, match="parity-demoted"):
                p.topk(V[:2], 3)


def test_twostage_k_beyond_shortlist_matches_reference():
    V = _factors(520, seed=70)
    U = _factors(3, seed=71)
    r = ref.build_scorer(V, RefConfig(mode="twostage", tile_items=128,
                                      shortlist=16), min_recall=0.0)
    p = port.build_scorer(V, ScorerConfig(mode="twostage", tile_items=128,
                                          shortlist=16), min_recall=0.0,
                          device=CPU)
    for k in (100, 520):
        sc_r, ix_r = r.topk(U, k)
        sc_p, ix_p = p.topk(U, k)
        assert sc_p.shape == (3, k)
        assert np.array_equal(ix_p, ix_r)
        np.testing.assert_allclose(sc_p, sc_r, rtol=1e-5)


@pytest.mark.parametrize("shortlist", [16, 1024])
def test_twostage_cand_matches_reference(monkeypatch, shortlist):
    """The per-tile candidate count of each call (the shape the kernel
    runs at) follows the reference's rule: widened for k beyond the
    shortlist, to k per tile for masked batches."""
    n_items, tile = 1000, 128               # 8 tiles, the last ragged
    V = _factors(n_items, seed=80)
    U = _factors(2, seed=81)
    r = ref.build_scorer(V, RefConfig(mode="twostage", tile_items=tile,
                                      shortlist=shortlist), min_recall=0.0)
    p = port.build_scorer(V, ScorerConfig(mode="twostage", tile_items=tile,
                                          shortlist=shortlist),
                          min_recall=0.0, device=CPU)
    assert p.cand_per_tile == r.cand_per_tile == port.shortlist_per_tile(
        shortlist, p.n_tiles, tile)
    seen = {"ref": [], "port": []}
    real_cached, real_topc = ref.shape_cached_fn, port.shortlist_topc

    def ref_cached(family, key, build, *a, **kw):
        if family == ref.TWOSTAGE_FAMILY:
            seen["ref"].append(key[1])      # key = (u.shape, cand, ...)
        return real_cached(family, key, build, *a, **kw)

    def port_topc(u, tiles, scales, n_items, mask, cand):
        seen["port"].append(cand)
        return real_topc(u, tiles, scales, n_items, mask, cand)

    monkeypatch.setattr(ref, "shape_cached_fn", ref_cached)
    monkeypatch.setattr(port, "shortlist_topc", port_topc)
    mask = np.zeros((2, n_items), bool)
    mask[:, ::7] = True
    cases = [(k, m) for k in (1, 10, 100, 1000) for m in (None, mask)]
    for k, m in cases:
        r.topk(U, k, mask=m)
        p.topk(U, k, mask=m)
    want = [port.twostage_cand(p.cand_per_tile, p.n_tiles, tile, k,
                               m is not None) for k, m in cases]
    assert seen["port"] == seen["ref"] == want


# ---------------------------------------------------------------------------
# merge_topk tie rule (the cases of tests/test_sharded_scoring.py)
# ---------------------------------------------------------------------------

def _merge_cases():
    a = (np.array([[1.0, 1.0]], np.float32), np.array([[7, 3]]))
    b = (np.array([[1.0, 0.5]], np.float32), np.array([[5, 9]]))
    wide = (np.array([[3.0, 1.0, 0.5]], np.float32), np.array([[0, 1, 2]]))
    narrow = (np.array([[2.0]], np.float32), np.array([[10]]))
    bad = (np.array([[np.nan, 2.0, -np.inf, 1.0]], np.float32),
           np.array([[0, 1, 2, -5]]))
    tie = (np.array([[0.0, 0.0]], np.float32), np.array([[4, -1]]))
    empty = (np.zeros((2, 0), np.float32), np.zeros((2, 0), np.int64))
    rng = np.random.default_rng(7)
    ties = [(rng.integers(0, 3, (4, 6)).astype(np.float32),
             rng.permutation(24).reshape(4, 6)) for _ in range(3)]
    return [([a, b], 3), ([b, a], 3), ([wide, narrow], 6), ([bad], 4),
            ([tie], 2), ([empty, empty], 5), ([a], 0), (ties, 7),
            (ties[::-1], 24)]


@pytest.mark.parametrize("case", range(len(_merge_cases())))
def test_merge_topk_matches_reference(case):
    lists, k = _merge_cases()[case]
    vals, ids = merge_topk(lists, k)
    want_v, want_i = ref_merge_topk(lists, k)
    assert np.array_equal(ids, want_i)
    assert np.array_equal(vals, want_v)


def test_merge_topk_tie_break_is_lowest_id():
    a = (np.array([[1.0, 1.0]], np.float32), np.array([[7, 3]]))
    b = (np.array([[1.0, 0.5]], np.float32), np.array([[5, 9]]))
    for lists in ([a, b], [b, a]):
        vals, ids = merge_topk(lists, 3)
        assert ids.tolist() == [[3, 5, 7]]
    scores = np.random.default_rng(3).standard_normal((3, 40))
    assert np.array_equal(host_topk(scores, 5)[1],
                          np.argsort(-scores, axis=1)[:, :5])


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env,variant,server", [
    ({}, None, {}),
    ({"PIO_SCORER_MODE": "twostage"}, {"mode": "fused"}, {"mode": "exact"}),
    ({}, {"mode": "fused_int8", "tileItems": 64}, {"shortlist": 99}),
    ({"PIO_SCORER_TILE_ITEMS": "4096", "PIO_SCORER_SHORTLIST": "bad"},
     {"shortlist": 1024}, {"minRecall": 1.5}),
])
def test_scorer_config_precedence_matches_reference(monkeypatch, tmp_path,
                                                    env, variant, server):
    import json

    from predictionio_tpu.utils.server_config import (
        scorer_config as ref_scorer_config,
    )

    path = tmp_path / "server.json"
    path.write_text(json.dumps({"scorer": server}))
    monkeypatch.setenv("PIO_SERVER_CONF", str(path))
    for name in ("PIO_SCORER_MODE", "PIO_SCORER_TILE_ITEMS",
                 "PIO_SCORER_SHORTLIST", "PIO_SCORER_SHARDS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    got = scorer_config(variant)
    want = ref_scorer_config(variant)
    assert got.cache_key() == want.cache_key()


def test_scorer_shards_env_serves_sharded(monkeypatch):
    """Sharded serving is ported now: ``PIO_SCORER_SHARDS=2`` resolves
    to two shards (it raised before) and a model scores through a
    ``ShardedScorer`` whose answers are the exact top-k."""
    from predictionio_tpu_torch.ops.scoring import (
        ShardedScorer, scorer_for,
    )

    monkeypatch.setenv("PIO_SCORER_SHARDS", "2")
    cfg = ScorerConfig.from_env()
    assert cfg.shards == 2
    rng = np.random.default_rng(3)
    V = rng.standard_normal((300, 8)).astype(np.float32)
    holder = types.SimpleNamespace(device=torch.device("cpu"),
                                   _scorer_cfg_override=cfg)
    scorer = scorer_for(holder, V)
    assert isinstance(scorer, ShardedScorer) and scorer.n_shards == 2
    u = rng.standard_normal((4, 8)).astype(np.float32)
    _, ids = scorer.topk(u, 10)
    np.testing.assert_array_equal(ids, np.argsort(-(u @ V.T), axis=1)[:, :10])


@pytest.mark.parametrize("mode", ["exact", "fused", "twostage"])
def test_sharded_scorer_matches_reference(mode):
    """``ShardedScorer`` against the reference's at 3 shards: the same
    ranges, bytes and status block, and the same answers with no mask,
    a random mask and a whitelist concentrated in one shard (every
    other shard fully sentineled)."""
    n_items, k, shards = 385, 10, 3
    V = _factors(n_items, seed=6)
    U = _factors(6, seed=7)
    cfg_r = RefConfig(mode=mode, tile_items=64, shortlist=32, shards=shards)
    cfg_p = ScorerConfig(mode=mode, tile_items=64, shortlist=32,
                         shards=shards)
    r = ref.build_sharded_scorer(V, cfg_r)
    p = port.build_sharded_scorer(V, cfg_p, device=CPU)
    st_r, st_p = r.status(), p.status()
    for s_ in (st_r, st_p):
        for sub in s_["shardStatus"]:
            sub.pop("device", None)
            sub.pop("buildSeconds", None)
            sub.pop("gateSeconds", None)
    assert st_p == st_r
    rng = np.random.default_rng(8)
    lo, hi = p.ranges[1]
    concentrated = np.ones((6, n_items), bool)
    concentrated[:, lo:lo + 12] = False
    for m in (None, rng.random((6, n_items)) < 0.3, concentrated):
        sc_r, ix_r = r.topk(U, k, mask=m)
        sc_p, ix_p = p.topk(U, k, mask=m)
        fin = np.isfinite(sc_r)
        assert np.array_equal(fin, np.isfinite(sc_p))
        assert np.array_equal(np.asarray(ix_p)[fin], np.asarray(ix_r)[fin])
        np.testing.assert_allclose(sc_p[fin], sc_r[fin], rtol=1e-5)
    # the concentrated whitelist serves only its 12 items
    _, ix = p.topk(U, k, mask=concentrated)
    assert ((ix >= lo) & (ix < lo + 12)).all()
    # an exact shard keeps its rows as a tensor on the serving device
    # and scores there; a shard a scorer serves holds none
    for scorer, v_dev, v_shard in zip(p.shards, p._v_devices, p._v_shards):
        if mode == "exact":
            assert v_dev is not None and v_dev.device == CPU
            np.testing.assert_array_equal(v_dev.numpy(), v_shard)
        else:
            assert scorer.active and v_dev is None


def test_demoted_shard_serves_exact_on_its_device(monkeypatch):
    """A shard whose parity gate demoted it serves the exact product
    over its own rows on the shard's device (the unsharded exact
    scorer's product and top-k), not the host's: the answers equal the
    reference's demoted shards (which serve host BLAS), and no host
    product of the factors runs."""
    n_items, k, shards = 300, 10, 2
    V = _factors(n_items, seed=11)
    U = _factors(5, seed=12)
    cfg = dict(mode="twostage", tile_items=32, shortlist=2, shards=shards)
    r = ref.build_sharded_scorer(V, RefConfig(**cfg), min_recall=1.01)
    p = port.build_sharded_scorer(V, ScorerConfig(**cfg), min_recall=1.01,
                                  device=CPU)
    assert p.active_mode == r.active_mode == "exact"
    assert all(not s.active for s in p.shards)
    assert all(v is not None and v.device == CPU for v in p._v_devices)
    calls = []
    real = port._exact_shard_topk

    def spy(u, v_dev, k_s, mask):
        calls.append(v_dev.device)
        return real(u, v_dev, k_s, mask)

    monkeypatch.setattr(port, "_exact_shard_topk", spy)
    rng = np.random.default_rng(13)
    for m in (None, rng.random((5, n_items)) < 0.4):
        sc_r, ix_r = r.topk(U, k, mask=m)
        sc_p, ix_p = p.topk(U, k, mask=m)
        np.testing.assert_array_equal(ix_p, ix_r)
        np.testing.assert_allclose(sc_p, sc_r, rtol=1e-5)
    assert calls == [CPU] * (2 * shards)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gate_on_appended_rows_matches_reference(seed):
    """The item fold at 10M items (16 new ids, all in the last tile,
    two candidates a tile) left a rebuilt twostage scorer that its
    parity gate demoted. The same shape at a small size: 256 tiles of
    16, 2 candidates a tile, 16 new items folded from 24 raters each
    (rating 5.0, as the fold-in leg folds them) appended to a catalog
    whose own scorer passes. Both packages probe the same rows, reach
    the same recall and demote alike. Every id the probes miss is a new
    item: the new rows are long, so they crowd the exact top-10s, and
    they share the last tile, whose shortlist keeps two."""
    from predictionio_tpu_torch.models.als import ALSParams, FoldInSolver

    k, tile, n_tiles, n_new = 16, 16, 256, 16
    V = _factors(n_tiles * tile - n_new, k=k, seed=seed, decay=1.5)
    U = _factors(3000, k=k, seed=seed + 1, decay=1.5)
    rng = np.random.default_rng(seed + 2)
    rated = [rng.choice(len(U), 24, replace=False) for _ in range(n_new)]
    rows = FoldInSolver(U, ALSParams(rank=k, reg=0.05), device="cpu").solve(
        rated, [np.full(24, 5.0, np.float32)] * n_new)
    grown = np.concatenate([V, rows.astype(np.float32)])
    # 2 candidates a tile on both catalogs (255 and 256 tiles)
    cfg = dict(mode="twostage", tile_items=tile, shortlist=2 * n_tiles - 2)
    for catalog, demoted in ((V, False), (grown, True)):
        r = ref.build_scorer(catalog, RefConfig(**cfg))
        p = port.build_scorer(catalog, ScorerConfig(**cfg), device=CPU)
        assert p.cand_per_tile == r.cand_per_tile == 2
        assert p.recall_probe == r.recall_probe
        assert (not p.active) == (not r.active) == demoted
    # where the recall goes: the gate's probe rows, scored undemoted
    p = port.build_scorer(grown, ScorerConfig(**cfg), min_recall=0.0,
                          device=CPU)
    probe_rows = np.linspace(0, len(grown) - 1,
                             num=port.PARITY_PROBE_QUERIES).astype(int)
    _, exact = host_topk(grown[probe_rows] @ grown.T, 10)
    _, got = p.topk(grown[probe_rows], 10)
    missed = set().union(*[set(a.tolist()) - set(b.tolist())
                           for a, b in zip(exact, got)])
    assert missed and min(missed) >= len(V)   # new items, the last tile
    assert probe_rows[-1] >= len(V)           # the last probe is one
