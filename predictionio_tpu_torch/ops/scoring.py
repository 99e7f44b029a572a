"""Fused low-precision top-k scoring for large catalogs (port of the
reference's ``ops/scoring.py``).

The serving cost of every ALS model is one ``[B,K] @ [K,N]`` product and
a top-k. Besides the exact scorer (models/als.py) this module holds the
four scorers that never build the ``[B,N]`` score matrix:

* ``fused`` / ``fused_bf16`` / ``fused_int8`` — item tiles of
  ``tile_items`` rows are dequantized, scored and folded into a per-query
  running top-k (a torch loop over tiles; the reference's ``lax.scan``).
  Quantized modes overfetch and rescore exactly in f32 on the host.
* ``twostage`` — the factors are rotated into the eigenbasis of
  ``V^T V``, truncated to the leading columns carrying ``ENERGY_TARGET``
  of the spectrum and quantized int8. Stage 1 emits each tile's local
  top-c (:func:`shortlist_topc`: the hand-written CUDA kernel
  ``csrc/shortlist.cu`` on the card, :func:`shortlist_topc_reference` on
  the CPU); stage 2 rescores the shortlist exactly in f32 from the host
  factor copy. Final scores are exact; only shortlist membership is
  approximate.

Quantization, the rotation and tile packing stay in numpy so the bytes
the port serves are bit-identical to the reference's. Every non-exact
scorer is parity-gated at build against the exact scorer: below
``min_recall`` recall@10 it is demoted to exact serving.

Mode selection rides the reference's knob chain (env > engine.json
``"scorer"`` > server.json ``"scorer"``), resolved by
:func:`predictionio_tpu_torch.utils.server_config.scorer_config` and
pinned per process with :func:`set_process_scorer_config`.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.ops import kernels
from predictionio_tpu_torch.ops.bucketing import bucket_size
from predictionio_tpu_torch.ops.topk import host_topk, merge_topk
from predictionio_tpu_torch.utils.device import resolve_device
from predictionio_tpu_torch.utils.server_config import (
    SCORER_MODES, check_unsharded,
)

logger = logging.getLogger("pio.torch.scoring")

#: spectrum fraction the two-stage scan's truncated principal columns
#: must carry
ENERGY_TARGET = 0.96

#: queries in the build-time parity probe (catalog rows as queries)
PARITY_PROBE_QUERIES = 8
PARITY_PROBE_K = 10

#: factor rows sampled for the quantization-error figure
QUANT_ERROR_SAMPLE_ROWS = 4096

#: quantized fused scans carry OVERFETCH*k candidates (min
#: FUSED_MIN_CARRY) and rescore them exactly on the host
FUSED_OVERFETCH = 4
FUSED_MIN_CARRY = 32


# ---------------------------------------------------------------------------
# process-level scorer selection
# ---------------------------------------------------------------------------

_PROCESS_CFG = None
_CFG_LOCK = threading.Lock()


def set_process_scorer_config(cfg) -> None:
    """Pin the resolved scorer knobs for this process (the deploy CLI
    passes the engine.json-aware config through; ``None`` resets to lazy
    env > server.json resolution — the test hook)."""
    global _PROCESS_CFG
    with _CFG_LOCK:
        _PROCESS_CFG = cfg


def process_scorer_config():
    """The scorer knobs every model in this process scores under,
    resolved lazily from env > server.json when nothing pinned one."""
    global _PROCESS_CFG
    with _CFG_LOCK:
        if _PROCESS_CFG is None:
            from predictionio_tpu_torch.utils.server_config import (
                scorer_config,
            )

            _PROCESS_CFG = scorer_config(None)
        return _PROCESS_CFG


def holder_scorer_config(holder):
    """The scorer knobs THIS holder scores under: a per-holder override
    (``_scorer_cfg_override``) beats the process pin."""
    override = getattr(holder, "_scorer_cfg_override", None)
    return override if override is not None else process_scorer_config()


# ---------------------------------------------------------------------------
# tile scans
# ---------------------------------------------------------------------------

def _tile_scores(u: torch.Tensor, v_tile: torch.Tensor,
                 s_tile: Optional[torch.Tensor]) -> torch.Tensor:
    """One tile's [B, T] f32 scores: dequantize + product with f32
    accumulation. ``s_tile is None`` means the tile needs no scale."""
    if v_tile.dtype == torch.bfloat16:
        # bf16 x bf16 -> f32 accumulation, as the reference: u is cast
        # to bf16; a product of two bf16 values is exact in f32, so an
        # f32 product of the widened operands is that accumulation
        sc = u.to(torch.bfloat16).float() @ v_tile.float().T
    elif v_tile.dtype == torch.int8:
        sc = u @ v_tile.float().T
    else:
        sc = u @ v_tile.T
    if s_tile is not None:
        sc = sc * s_tile[None, :]
    return sc


def _scan_xs(b: int, v_tiles: torch.Tensor, scales: Optional[torch.Tensor],
             mask: Optional[torch.Tensor], tile: int) -> tuple:
    """One tile-scan's per-step inputs, each with a leading tile axis:
    factor tiles, optional scales, the optional mask re-laid
    [B, n_pad] -> [n_tiles, B, T], and the per-tile id bases."""
    n_tiles = v_tiles.shape[0]
    xs = [v_tiles]
    if scales is not None:
        xs.append(scales)
    if mask is not None:
        xs.append(mask.reshape(b, n_tiles, tile).movedim(1, 0))
    xs.append(torch.arange(n_tiles, dtype=torch.int32,
                           device=v_tiles.device) * tile)
    return tuple(xs)


def _step_scores(u: torch.Tensor, xs: tuple, has_scales: bool,
                 has_mask: bool, n_items: int):
    """Unpack one step's inputs (as `_scan_xs` laid them out) into the
    tile's sentineled [B, T] scores + global ids: ``-inf`` for padding
    rows (ids >= n_items) and masked items."""
    parts = list(xs)
    v_tile = parts.pop(0)
    s_tile = parts.pop(0) if has_scales else None
    m_tile = parts.pop(0) if has_mask else None
    base = parts.pop(0)
    sc = _tile_scores(u, v_tile, s_tile)
    ids = base + torch.arange(sc.shape[1], dtype=torch.int32,
                              device=sc.device)[None, :].expand_as(sc)
    sentinel = ids >= n_items
    if m_tile is not None:
        sentinel = sentinel | m_tile
    return sc.masked_fill(sentinel, float("-inf")), ids


def _steps(xs: tuple):
    for t in range(xs[0].shape[0]):
        yield tuple(x[t] for x in xs)


def _fused_topk_scan(u, v_tiles, scales, n_items: int, mask, num: int,
                     tile: int):
    """Streaming top-k: loop over item tiles, fold each into a per-query
    running top-``num`` — the [B, N] score matrix never exists."""
    b = u.shape[0]
    has_scales, has_mask = scales is not None, mask is not None
    vals = torch.full((b, num), float("-inf"), dtype=torch.float32,
                      device=u.device)
    idx = torch.full((b, num), -1, dtype=torch.int32, device=u.device)
    for xs in _steps(_scan_xs(b, v_tiles, scales, mask, tile)):
        sc, ids = _step_scores(u, xs, has_scales, has_mask, n_items)
        cv = torch.cat([vals, sc], dim=1)
        ci = torch.cat([idx, ids], dim=1)
        vals, ti = torch.topk(cv, num, dim=1)
        idx = torch.gather(ci, 1, ti)
    return vals, idx


def shortlist_topc_reference(u: torch.Tensor, tiles: torch.Tensor,
                             scales: torch.Tensor, n_items: int,
                             mask: Optional[torch.Tensor], cand: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the shortlist kernel (the counterpart of
    the reference's ``_shortlist_scan``): each tile's local top-``cand``
    of its sentineled scores, laid out ``[B, n_tiles * cand]``."""
    b = u.shape[0]
    tile = tiles.shape[1]
    has_mask = mask is not None
    vals, ids = [], []
    for xs in _steps(_scan_xs(b, tiles, scales, mask, tile)):
        sc, tid = _step_scores(u, xs, True, has_mask, n_items)
        tv, ti = torch.topk(sc, cand, dim=1)
        vals.append(tv)
        ids.append(torch.gather(tid, 1, ti))
    # [n_tiles, B, c] -> [B, n_tiles * c]
    return (torch.stack(vals, 1).reshape(b, -1),
            torch.stack(ids, 1).reshape(b, -1))


def shortlist_topc(u: torch.Tensor, tiles: torch.Tensor,
                   scales: torch.Tensor, n_items: int,
                   mask: Optional[torch.Tensor], cand: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage stage 1 (the counterpart of the reference's
    ``_shortlist_scan``): each tile emits its LOCAL top-``cand`` — no
    cross-tile merge, which the exact rescore makes unnecessary —
    as ``(vals [B, nt*cand] f32, ids [B, nt*cand] i32)``. CUDA tensors
    launch ``csrc/shortlist.cu`` (or raise); CPU tensors take
    :func:`shortlist_topc_reference`."""
    if u.is_cuda:
        return kernels.shortlist_topc_cuda(u, tiles, scales, n_items,
                                           mask, cand)
    return shortlist_topc_reference(u, tiles, scales, n_items, mask, cand)


def shortlist_per_tile(shortlist: int, n_tiles: int, tile: int) -> int:
    """The configured two-stage shortlist spread over the tiles: each
    tile's local top-c, at least one."""
    return min(tile, max(1, -(-max(1, int(shortlist)) // n_tiles)))


def twostage_cand(per_tile: int, n_tiles: int, tile: int, k: int,
                  masked: bool) -> int:
    """Per-tile candidates of one two-stage call: ``per_tile``, widened
    when the shortlist would hold fewer than k ids, and to k per tile
    for masked batches (a concentrated whitelist leaves every other
    tile fully sentineled)."""
    cand = per_tile
    if n_tiles * cand < k:
        cand = min(tile, bucket_size(-(-k // n_tiles)))
    if masked:
        cand = max(cand, min(tile, bucket_size(k)))
    return cand


# ---------------------------------------------------------------------------
# quantization + packing (numpy: bit-identical to the reference)
# ---------------------------------------------------------------------------

def _pow2_tile(tile_items: int, n_items: int) -> int:
    """The tile width: the configured tile rounded up to a power of two,
    shrunk to one tile for small catalogs."""
    t = bucket_size(max(1, tile_items))
    return min(t, bucket_size(n_items))


def _pack_tiles(arr: np.ndarray, tile: int):
    """[N, K] -> ([n_tiles, tile, K], n_pad): pad item rows up to a
    whole tile grid (pad rows are sentineled by id inside the scans)."""
    n = arr.shape[0]
    n_pad = -(-n // tile) * tile
    if n_pad != n:
        arr = np.concatenate(
            [arr, np.zeros((n_pad - n,) + arr.shape[1:], arr.dtype)])
    return arr.reshape(n_pad // tile, tile, *arr.shape[1:]), n_pad


def _quantize_int8(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8: q = round(v / s), s = row-max / 127.
    Zero rows get scale 1 so dequantization stays finite."""
    s = np.abs(v).max(axis=1) / 127.0
    s = np.where(s == 0, 1.0, s).astype(np.float32)
    q = np.clip(np.rint(v / s[:, None]), -127, 127).astype(np.int8)
    return q, s


def _principal_rotation(v: np.ndarray) -> Tuple[np.ndarray, int]:
    """Eigenbasis of V^T V (descending eigenvalue) and the column count
    carrying ``ENERGY_TARGET`` of the spectrum, rounded up to 8."""
    g = (v.T @ v).astype(np.float64)
    w, vecs = np.linalg.eigh(g)
    order = np.argsort(w)[::-1]
    w, vecs = np.maximum(w[order], 0.0), vecs[:, order]
    total = w.sum()
    if total <= 0:
        return vecs.astype(np.float32), v.shape[1]
    energy = np.cumsum(w) / total
    dims = int(np.searchsorted(energy, ENERGY_TARGET) + 1)
    dims = min(v.shape[1], max(8, -(-dims // 8) * 8))
    return vecs.astype(np.float32), dims


# ---------------------------------------------------------------------------
# the scorer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ItemScorer:
    """Device-resident (possibly quantized) item factors plus the tiled
    top-k over them, for ONE factor matrix identity.

    ``active_mode`` is the mode actually serving: the build-time parity
    probe demotes a scorer whose recall@10 against the exact path falls
    under ``min_recall`` to ``"exact"`` (the caller then serves the exact
    path)."""

    mode: str                 # requested mode
    active_mode: str          # mode after the parity gate
    n_items: int
    rank: int
    tile: int
    n_tiles: int
    scan_rank: int            # truncated rank of the stage-1 scan
    shortlist: int            # candidates per query (twostage; else 0)
    cand_per_tile: int        # local top-c per tile (twostage; else 0)
    quantization: str         # "float32" | "bfloat16" | "int8"
    factor_bytes: int         # device-resident factor + scale bytes
    exact_bytes: int          # the f32 baseline those bytes replace
    recall_probe: float       # build-time probe recall@PARITY_PROBE_K
    quant_error: float        # sampled max relative dequantization error
    device: torch.device = torch.device("cpu")
    build_s: float = 0.0      # the whole build, the parity gate included
    gate_s: float = 0.0       # the parity gate alone
    _tiles: Optional[torch.Tensor] = None     # [n_tiles, T, scan_rank]
    _scales: Optional[torch.Tensor] = None    # [n_tiles, T] (int8 only)
    _v_host: Optional[np.ndarray] = None      # f32 rescore source
    _rotation: Optional[np.ndarray] = None    # [K, scan_rank] (twostage)

    @property
    def active(self) -> bool:
        """False when the parity gate demoted this scorer to exact."""
        return self.active_mode != "exact"

    # -- scoring -------------------------------------------------------------

    def topk(self, u_batch: np.ndarray, k: int,
             mask: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-``k`` (scores, ids) for ``u_batch`` [B, K] f32 rows;
        ``mask`` [B, n_items] bool excludes items (True = excluded).
        The batch pads to its power-of-two bucket; results come back
        trimmed to [B, k]."""
        if not self.active:
            raise RuntimeError(
                "scorer was parity-demoted to exact and holds no device "
                "residency — callers must check .active and route the "
                "exact path")
        b = u_batch.shape[0]
        k = min(k, self.n_items)
        b_pad = bucket_size(b)
        u = np.zeros((b_pad, self.rank), np.float32)
        u[:b] = u_batch
        mask_pad = None
        if mask is not None:
            n_pad = self.n_tiles * self.tile
            mask_pad = np.ones((b_pad, n_pad), bool)
            mask_pad[:b, :self.n_items] = mask
        if self.active_mode == "twostage":
            scores, idx = self._topk_twostage(u, k, mask_pad)
        else:
            scores, idx = self._topk_fused(u, k, mask_pad)
        return scores[:b, :k], idx[:b, :k]

    def _to_device(self, a: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        if a is None:
            return None
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _topk_fused(self, u: np.ndarray, k: int,
                    mask_pad: Optional[np.ndarray]):
        quantized = self.quantization != "float32"
        # quantized scans overfetch the running carry and rescore the
        # carried set exactly in f32 from the host copy
        want = max(k, 1) if not quantized else max(FUSED_OVERFETCH * k,
                                                   FUSED_MIN_CARRY)
        k_pad = min(bucket_size(want), self.n_items)
        vals, idx = _fused_topk_scan(
            self._to_device(u), self._tiles, self._scales, self.n_items,
            self._to_device(mask_pad), k_pad, self.tile)
        scores, idx = vals.cpu().numpy(), idx.cpu().numpy()
        if not quantized:
            return scores, idx
        return self._rescore_exact(u, scores, idx, k)

    def _rescore_exact(self, u: np.ndarray, approx: np.ndarray,
                       cand: np.ndarray, k: int):
        """Exact f32 rescore of per-query candidate ids from the host
        factor copy + host top-k. Candidates the scan sentineled to
        -inf (masked / padding / carry inits) stay -inf."""
        valid = np.isfinite(approx) & (cand >= 0) & (cand < self.n_items)
        safe = np.where(valid, cand, 0)
        sc = np.einsum("bk,bsk->bs", u, self._v_host[safe],
                       dtype=np.float32, casting="same_kind")
        sc = np.where(valid, sc, -np.inf)
        return merge_topk([(sc, np.where(valid, cand, -1))], k)

    def _topk_twostage(self, u: np.ndarray, k: int,
                       mask_pad: Optional[np.ndarray]):
        u_scan = u if self._rotation is None else \
            np.ascontiguousarray((u @ self._rotation).astype(np.float32))
        cand = twostage_cand(self.cand_per_tile, self.n_tiles, self.tile,
                             k, mask_pad is not None)
        approx, ids = shortlist_topc(
            self._to_device(u_scan), self._tiles, self._scales,
            self.n_items, self._to_device(mask_pad), cand)
        approx, ids = approx.cpu().numpy(), ids.cpu().numpy()
        # stage 2: EXACT f32 rescore of the shortlist
        return self._rescore_exact(u, approx, ids, k)

    # -- status --------------------------------------------------------------

    def status(self) -> dict:
        return {
            "mode": self.mode,
            "activeMode": self.active_mode,
            "quantization": self.quantization,
            "items": self.n_items,
            "rank": self.rank,
            "scanRank": self.scan_rank,
            "tileItems": self.tile,
            "tiles": self.n_tiles,
            "shortlist": self.shortlist,
            "factorBytes": self.factor_bytes,
            "exactBytes": self.exact_bytes,
            "recallProbe": round(self.recall_probe, 4),
            "quantError": round(self.quant_error, 6),
            "device": str(self.device),
            "buildSeconds": self.build_s,
            "gateSeconds": self.gate_s,
        }


def build_scorer(V: np.ndarray, cfg=None,
                 min_recall: Optional[float] = None,
                 device=None) -> ItemScorer:
    """Build an :class:`ItemScorer` over item factors ``V`` [N, K] f32
    under the resolved scorer knobs, running the parity gate before it
    may serve. ``cfg`` defaults to the process scorer config; ``device``
    to ``cuda`` (see utils/device)."""
    device = resolve_device(device)
    t_build = time.perf_counter()
    if cfg is None:
        cfg = process_scorer_config()
    mode = cfg.mode
    if mode not in SCORER_MODES:
        raise ValueError(f"unknown scorer mode {mode!r}: expected one of "
                         f"{'|'.join(SCORER_MODES)}")
    if mode == "exact":
        raise ValueError("exact mode never builds an ItemScorer — the "
                         "caller serves the materialized path")
    v = np.ascontiguousarray(np.asarray(V), np.float32)
    n_items, rank = v.shape
    tile = _pow2_tile(cfg.tile_items, n_items)
    exact_bytes = v.nbytes
    rotation = None
    scan_rank = rank
    quant_error = 0.0

    if mode in ("twostage", "fused_int8"):
        v_scan = v
        if mode == "twostage":
            rot, dims = _principal_rotation(v)
            rotation = np.ascontiguousarray(rot[:, :dims])
            scan_rank = dims
            v_scan = np.ascontiguousarray((v @ rotation).astype(np.float32))
        q, s = _quantize_int8(v_scan)
        quant_error = _sampled_quant_error(v_scan, q, s)
        tiles = torch.from_numpy(_pack_tiles(q, tile)[0])
        scales = torch.from_numpy(_pack_tiles(s, tile)[0])
        quantization = "int8"
    elif mode == "fused_bf16":
        tiles = torch.from_numpy(_pack_tiles(v, tile)[0]).to(torch.bfloat16)
        quant_error = _sampled_quant_error(
            v, torch.from_numpy(v).to(torch.bfloat16).float().numpy(), None)
        scales = None
        quantization = "bfloat16"
    else:   # fused (f32, tiled — memory unchanged, [B,N] never built)
        tiles = torch.from_numpy(_pack_tiles(v, tile)[0])
        scales = None
        quantization = "float32"

    n_tiles = tiles.shape[0]
    shortlist = 0
    cand_per_tile = 0
    if mode == "twostage":
        cand_per_tile = shortlist_per_tile(cfg.shortlist, n_tiles, tile)
        shortlist = cand_per_tile * n_tiles

    factor_bytes = int(tiles.numel() * tiles.element_size()
                       + (scales.numel() * 4 if scales is not None else 0))
    scorer = ItemScorer(
        mode=mode, active_mode=mode, n_items=n_items, rank=rank,
        tile=tile, n_tiles=n_tiles, scan_rank=scan_rank,
        shortlist=shortlist, cand_per_tile=cand_per_tile,
        quantization=quantization, factor_bytes=factor_bytes,
        exact_bytes=exact_bytes, recall_probe=1.0,
        quant_error=quant_error, device=device,
        _tiles=tiles.to(device),
        _scales=scales.to(device) if scales is not None else None,
        _v_host=v, _rotation=rotation)
    t_gate = time.perf_counter()
    _parity_gate(scorer, v,
                 cfg.min_recall if min_recall is None else min_recall)
    scorer.gate_s = time.perf_counter() - t_gate
    scorer.build_s = time.perf_counter() - t_build
    return scorer


def _sampled_quant_error(v: np.ndarray, q: np.ndarray,
                         s: Optional[np.ndarray]) -> float:
    """Max relative dequantization error over a row sample."""
    n = v.shape[0]
    rows = np.linspace(0, n - 1,
                       num=min(QUANT_ERROR_SAMPLE_ROWS, n)).astype(int)
    vv = v[rows]
    deq = (q[rows].astype(np.float32) * s[rows, None] if s is not None
           else q[rows].astype(np.float32))
    denom = max(float(np.abs(vv).max()), 1e-30)
    return float(np.abs(deq - vv).max() / denom)


def _parity_gate(scorer: ItemScorer, v: np.ndarray,
                 min_recall: float) -> None:
    """Recall@k parity probe vs the exact scorer: catalog rows as probe
    queries, exact side on host BLAS. Runs once per scorer build and
    demotes a failing scorer to exact."""
    n = scorer.n_items
    k = min(PARITY_PROBE_K, n)
    if k == 0:
        return
    rows = np.linspace(0, n - 1,
                       num=min(PARITY_PROBE_QUERIES, n)).astype(int)
    probe = np.ascontiguousarray(v[rows])
    _, exact_idx = host_topk(probe @ v.T, k)
    _, got_idx = scorer.topk(probe, k)
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(exact_idx, got_idx))
    recall = hits / float(exact_idx.shape[0] * k)
    scorer.recall_probe = recall
    if recall < min_recall:
        logger.warning(
            "scorer parity gate failed: mode=%s recall@%d=%.4f < %.4f "
            "on a %dx%d catalog — falling back to exact serving",
            scorer.mode, k, recall, min_recall, scorer.n_items,
            scorer.rank)
        scorer.active_mode = "exact"
        # a demoted scorer must not hold quantized copies nobody reads
        scorer._tiles = None
        scorer._scales = None
        scorer.factor_bytes = 0


# ---------------------------------------------------------------------------
# model-side cache
# ---------------------------------------------------------------------------

#: serializes scorer BUILDS (not lookups): a cold cache under the query
#: server's threaded predict executor would otherwise pay N duplicate
#: quantize+probe builds of the same factor matrix at once
_BUILD_LOCK = threading.Lock()


def scorer_for(holder, V: np.ndarray) -> Optional[ItemScorer]:
    """The cached :class:`ItemScorer` for ``holder``'s factor matrix
    ``V`` under the current scorer config, rebuilt when V's identity or
    the config changed (a fold-in that swaps V requantizes). Returns
    ``None`` in exact mode. The scorer lives on ``holder.device``."""
    cfg = holder_scorer_config(holder)
    check_unsharded(cfg)
    if cfg.mode == "exact":
        return None
    key = cfg.cache_key()
    cached = getattr(holder, "_scorer_cache", None)
    if cached is not None and cached[0] is V and cached[1] == key:
        return cached[2]
    with _BUILD_LOCK:
        cached = getattr(holder, "_scorer_cache", None)   # lost the race?
        if cached is None or cached[0] is not V or cached[1] != key:
            built = build_scorer(V, cfg, device=holder.device)
            cached = (V, key, built)
            holder._scorer_cache = cached
    return cached[2]


def unit_scorer_status(result) -> list:
    """Status of every model in a TrainResult that has built a scorer."""
    out = []
    for model in getattr(result, "models", ()) or ():
        cached = getattr(model, "_scorer_cache", None)
        if cached is not None:
            out.append(cached[2].status())
    return out
