"""ALS model, serving side (port of the reference's ``models/als.py``
``ALSModel`` and its exact top-k scorer).

Training is not ported yet: a model comes from the reference's factor
arrays (:meth:`ALSModel.from_arrays`) or from a ``.npz`` written by
``workflow/serialization.save_model``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.data.bimap import vocab_index
from predictionio_tpu_torch.ops.bucketing import bucket_size, pad_rows
from predictionio_tpu_torch.ops.topk import host_topk
from predictionio_tpu_torch.utils.device import resolve_device, synchronize


def _topk_scores_batch(user_vecs: torch.Tensor, V: torch.Tensor,
                       mask: torch.Tensor, num: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact masked top-k: one [B,K]@[K,N] f32 product, then top-k."""
    scores = (user_vecs @ V.T).masked_fill(mask, float("-inf"))
    return torch.topk(scores, num, dim=1)


def _topk_scores_batch_nomask(user_vecs: torch.Tensor, V: torch.Tensor,
                              num: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """No-exclusion fast path: skips the [B, n_items] mask build and its
    host->device transfer."""
    return torch.topk(user_vecs @ V.T, num, dim=1)


#: measured seconds for one tiny dispatch + fetch per device — the fixed
#: per-request cost of touching the device at all. Serving compares it
#: against the host-BLAS cost of the same product and sends the batch
#: wherever it finishes sooner. Re-probed when the scorer MODE changes.
#: Tests that force the device lane assign ``_DEVICE_ROUNDTRIP_S = 0.0``.
_DEVICE_ROUNDTRIP_S: Optional[float] = None
_DEVICE_ROUNDTRIP_MODE: Optional[str] = None
_PROBE_LOCK = threading.Lock()


def device_roundtrip_s(device: torch.device) -> float:
    global _DEVICE_ROUNDTRIP_S, _DEVICE_ROUNDTRIP_MODE
    from predictionio_tpu_torch.ops.scoring import process_scorer_config

    mode = process_scorer_config().mode
    with _PROBE_LOCK:
        if _DEVICE_ROUNDTRIP_S is None or (
                _DEVICE_ROUNDTRIP_MODE is not None
                and _DEVICE_ROUNDTRIP_MODE != mode):
            x = torch.ones((8, 8), dtype=torch.float32, device=device)

            def probe():
                vals, idx = torch.topk(x @ x.T, 4, dim=1)
                return vals.cpu(), idx.cpu()

            probe()                       # first-use costs off the clock
            synchronize(device)
            t0 = time.perf_counter()
            for _ in range(3):
                probe()
            _DEVICE_ROUNDTRIP_S = (time.perf_counter() - t0) / 3
            _DEVICE_ROUNDTRIP_MODE = mode
        return _DEVICE_ROUNDTRIP_S


#: rough host matmul+argpartition throughput (flop/s) for the crossover
#: estimate; measured lazily the first time a model serves from host
_HOST_FLOPS: Optional[float] = None


def _host_flops() -> float:
    global _HOST_FLOPS
    if _HOST_FLOPS is None:
        u = np.ones((16, 32), np.float32)
        v = np.ones((2048, 32), np.float32)
        host_topk(u @ v.T, 10)                  # warm the BLAS path
        t0 = time.perf_counter()
        host_topk(u @ v.T, 10)
        dt = max(time.perf_counter() - t0, 1e-7)
        _HOST_FLOPS = 2.0 * u.shape[0] * v.shape[0] * v.shape[1] / dt
    return _HOST_FLOPS


@dataclasses.dataclass
class ALSModel:
    """Trained factors + id maps, served on ``device``.

    ``U`` and ``V`` stay numpy on the host (the exact rescore and the
    host-BLAS lane read them); ``V_device`` is the resident copy of V on
    the device for the exact device scorer, and quantized scorers keep
    their own residency (ops/scoring)."""

    user_vocab: np.ndarray   # sorted distinct user ids (index = row of U)
    item_vocab: np.ndarray   # sorted distinct item ids (index = row of V)
    U: np.ndarray            # [n_users, K] f32
    V: np.ndarray            # [n_items, K] f32
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @classmethod
    def from_arrays(cls, user_vocab, item_vocab, U, V,
                    device=None) -> "ALSModel":
        """The port's model from a trained model's four arrays (the
        reference's ``ALSModel`` fields)."""
        U = np.ascontiguousarray(np.asarray(U), np.float32)
        V = np.ascontiguousarray(np.asarray(V), np.float32)
        user_vocab, item_vocab = np.asarray(user_vocab), np.asarray(item_vocab)
        if U.ndim != 2 or V.ndim != 2 or U.shape[1] != V.shape[1]:
            raise ValueError(f"factor shapes U {U.shape} / V {V.shape} "
                             "must be [n, K] with one K")
        if len(user_vocab) != U.shape[0] or len(item_vocab) != V.shape[0]:
            raise ValueError("vocab lengths must match the factor rows")
        return cls(user_vocab=user_vocab, item_vocab=item_vocab, U=U, V=V,
                   device=device)

    @property
    def V_device(self) -> torch.Tensor:
        """Item factors resident on the device across requests;
        re-uploaded only when V is swapped."""
        cached = getattr(self, "_resident", None)
        if cached is None or cached[0] is not self.V:
            cached = (self.V, torch.from_numpy(self.V).to(self.device))
            self._resident = cached
        return cached[1]

    def user_index(self, user_id: str) -> Optional[int]:
        return vocab_index(self.user_vocab, user_id)

    def item_index(self, item_id: str) -> Optional[int]:
        return vocab_index(self.item_vocab, item_id)

    def _query_mask(self, exclude_items: Tuple[str, ...],
                    allow_items) -> np.ndarray:
        mask = np.zeros(len(self.item_vocab), dtype=bool)
        for it in exclude_items:
            ii = self.item_index(it)
            if ii is not None:
                mask[ii] = True
        if allow_items is not None:
            allow = np.ones(len(self.item_vocab), dtype=bool)
            for it in allow_items:
                ii = self.item_index(it)
                if ii is not None:
                    allow[ii] = False
            mask |= allow
        return mask

    def recommend(self, user_id: str, num: int,
                  exclude_items: Tuple[str, ...] = (),
                  allow_items: Optional[Tuple[str, ...]] = None):
        """Top-num (item_id, score), optionally excluding/allowlisting."""
        return self.recommend_batch(
            [(user_id, num, exclude_items, allow_items)])[0]

    def _use_host(self, n_rows: int, any_mask: bool) -> bool:
        """Route the batch to host BLAS when the estimated host scoring
        time undercuts one device round-trip. Host BLAS IS the exact
        scorer, so it only competes in exact mode: a non-exact scorer
        mode always routes to the device."""
        from predictionio_tpu_torch.ops.scoring import holder_scorer_config

        cfg = holder_scorer_config(self)
        if cfg.mode != "exact":
            return False
        flops = 2.0 * n_rows * len(self.item_vocab) * self.U.shape[1]
        host_s = flops / _host_flops()
        device_s = device_roundtrip_s(self.device) * (1.5 if any_mask
                                                      else 1.0)
        return host_s < device_s

    def _fused_scorer(self):
        """The cached ops/scoring scorer for the current scorer mode, or
        None when exact (or when the parity gate demoted it)."""
        from predictionio_tpu_torch.ops import scoring

        scorer = scoring.scorer_for(self, self.V)
        if scorer is None or not scorer.active:
            return None
        return scorer

    def recommend_batch(self, requests):
        """Batched recommend: one [B,K]@[K,N] product + top-k for B
        queries. ``requests``: sequence of (user_id, num, exclude_items,
        allow_items). Returns a list parallel to requests; [] for
        unknown users."""
        out = [[] for _ in requests]
        scored = self._score_topk(requests)
        if scored is None:
            return out
        rows, scores, idx, _k = scored
        n_items = len(self.item_vocab)
        finite = np.isfinite(scores)
        score_rows = scores.tolist()
        for b, j in enumerate(rows):
            want = min(requests[j][1], n_items)
            names = self.item_vocab[idx[b][:want]]
            fin_b, s_b = finite[b], score_rows[b]
            out[j] = [(str(names[t]), s_b[t])
                      for t in range(want) if fin_b[t]]
        return out

    def recommend_batch_arrays(self, requests):
        """`recommend_batch` as flat columns: ``(items, scores, counts)``;
        request ``j`` owns the slice ``sum(counts[:j]) :
        sum(counts[:j+1])`` of ``items`` and ``scores`` (float64)."""
        counts = np.zeros(len(requests), dtype=np.int64)
        scored = self._score_topk(requests)
        empty = np.asarray([], dtype=object)
        if scored is None:
            return empty, np.asarray([], dtype=np.float64), counts
        rows, scores, idx, k = scored
        n_items = len(self.item_vocab)
        want = np.fromiter(
            (min(requests[j][1], n_items) for j in rows),
            dtype=np.int64, count=len(rows))
        take = np.isfinite(scores) & (np.arange(k)[None, :] < want[:, None])
        counts[np.asarray(rows)] = take.sum(axis=1)
        return (self.item_vocab[idx[take]],
                scores[take].astype(np.float64), counts)

    def _score_topk(self, requests):
        """Shared scoring core: validate, gather known users, run the
        host-BLAS, quantized or exact device scorer. Returns (rows,
        scores[B,k], idx[B,k], k) over the known-user rows, or None when
        no request has a known user."""
        n_items = len(self.item_vocab)
        for _u, num, _ex, _allow in requests:
            if num < 0:
                raise ValueError(f"num must be >= 0, got {num}")
        rows, uidx = [], []
        any_mask = False
        for j, (user_id, _num, ex, allow) in enumerate(requests):
            ui = self.user_index(user_id)
            if ui is not None:
                rows.append(j)
                uidx.append(ui)
                if ex or allow is not None:
                    any_mask = True
        if not rows:
            return None
        k = min(max(min(requests[j][1], n_items) for j in rows), n_items)
        u_batch = self.U[np.asarray(uidx)]

        if self._use_host(len(rows), any_mask):
            scores = u_batch @ self.V.T                  # [B, N] host BLAS
            if any_mask:
                for b, j in enumerate(rows):
                    m = self._query_mask(requests[j][2], requests[j][3])
                    scores[b, m] = -np.inf
            scores, idx = host_topk(scores, k)
        elif (scorer := self._fused_scorer()) is not None:
            # fused/quantized/two-stage scorer (ops/scoring): the
            # [B, n_items] score matrix never materializes
            mask = None
            if any_mask:
                mask = np.stack(
                    [self._query_mask(requests[j][2], requests[j][3])
                     for j in rows])
            scores, idx = scorer.topk(u_batch, k, mask=mask)
        else:
            # exact device scorer, B and k bucketed to powers of two as
            # the reference buckets them
            b_pad = bucket_size(len(rows))
            k_pad = min(bucket_size(k), n_items)
            u_dev = torch.from_numpy(pad_rows(u_batch, b_pad)).to(
                self.device)
            if any_mask:
                mask = np.stack(
                    [self._query_mask(requests[j][2], requests[j][3])
                     for j in rows]
                    + [np.ones(n_items, bool)] * (b_pad - len(rows)))
                scores, idx = _topk_scores_batch(
                    u_dev, self.V_device,
                    torch.from_numpy(mask).to(self.device), k_pad)
            else:
                scores, idx = _topk_scores_batch_nomask(
                    u_dev, self.V_device, k_pad)
            scores = scores.cpu().numpy()[:len(rows), :k]
            idx = idx.cpu().numpy()[:len(rows), :k]
        return rows, scores, idx, k
