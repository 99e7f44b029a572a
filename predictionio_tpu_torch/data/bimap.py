"""Sorted-vocab id lookups (copy of the reference's ``data/bimap.py``
``vocab_index`` and ``batch_lookup``).

A model's user and item ids are a sorted array (``vocab``); the row of
an id in the factor matrix is its position in that array.
"""

from __future__ import annotations

import numpy as np


def batch_lookup(vocab: np.ndarray, values) -> np.ndarray:
    """Vectorized `vocab_index` for whole columns: int32 codes into the
    sorted `vocab`, with -1 for values not present."""
    arr = np.asarray(values, dtype=object)
    if arr.size == 0 or len(vocab) == 0:
        return np.full(arr.size, -1, np.int32)
    idx = np.searchsorted(vocab, arr)
    idx_c = np.minimum(idx, len(vocab) - 1)
    hit = vocab[idx_c] == arr
    return np.where(hit, idx_c, -1).astype(np.int32)


def vocab_index(vocab: np.ndarray, key: str) -> "int | None":
    """Index of `key` in a sorted vocab array (binary search), else None.

    The shared lookup for every model's user/item id maps."""
    i = int(np.searchsorted(vocab, key))
    if i < len(vocab) and vocab[i] == key:
        return i
    return None
