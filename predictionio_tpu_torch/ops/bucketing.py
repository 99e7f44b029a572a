"""Shape bucketing for serving-time batches (copy of the reference's
``ops/bucketing.py``).

Batches pad up to the next power of two, capped at the configured
``max_batch``, so the shortlist kernel and the exact scorer see at most
``bucket_count(max_batch)`` batch shapes (1, 2, 4, ..., cap) — the same
ladder the reference compiles, which keeps the port's answers and the
warm-up ladder (deploy/warm.py) identical to the reference's.

The helpers are pad-mask aware by convention: callers remember the real
row count, slice padded rows off every result, and never let a padding
row reach user-visible output (`server.query_server._predict_batch_unit`,
`models/als.ALSModel.recommend_batch`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def bucket_size(n: int, cap: Optional[int] = None) -> int:
    """The padded size for a batch of `n`: the next power of two, capped
    at `cap` (a non-power-of-two cap is itself the terminal bucket, so
    the shape set stays ``{1, 2, 4, ..., cap}``). n <= 0 buckets to 0 —
    empty batches never reach a compiled scorer."""
    if n <= 0:
        return 0
    b = 1 << (n - 1).bit_length()
    if cap is not None and cap > 0:
        b = min(b, max(cap, n))
    return b


def bucket_count(cap: int) -> int:
    """How many distinct bucket shapes `bucket_size(-, cap)` can emit —
    the bound the compile-count acceptance check asserts against."""
    if cap <= 0:
        return 0
    # powers of two <= cap, plus the cap itself when it is not a power
    return cap.bit_length() + (0 if cap & (cap - 1) == 0 else 1)


def pad_rows(rows: np.ndarray, bucket: int,
             fill: float = 0.0) -> np.ndarray:
    """Pad a [B, ...] array with `fill` rows up to `bucket` (no-op when
    already there). Callers slice ``result[:B]`` afterwards."""
    n = rows.shape[0]
    if n >= bucket:
        return rows
    pad = np.full((bucket - n,) + rows.shape[1:], fill, dtype=rows.dtype)
    return np.concatenate([rows, pad])


def padding_waste(n: int, bucket: int) -> int:
    """Rows of throwaway compute a padded batch carries (>= 0) — the
    `pio_batch_pad_waste_rows_total` increment."""
    return max(0, bucket - n) if n > 0 else 0
