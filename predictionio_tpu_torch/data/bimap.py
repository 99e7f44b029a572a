"""Sorted-vocab ids (copy of the reference's ``data/bimap.py``
``assign_indices``, ``vocab_index`` and ``batch_lookup``).

A model's user and item ids are a sorted array (``vocab``); the row of
an id in the factor matrix is its position in that array. The reference
interns through ``pandas.factorize`` where pandas is installed; the port
keeps only its numpy path (the machine with the card has no pandas), and
both give the same sorted vocab and codes.
"""

from __future__ import annotations

from typing import Sequence, Tuple

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


def _assign_indices_u64(arr: np.ndarray):
    """Fast path for short ASCII ids (<= 8 chars, the ML-20M shape):
    null-padded bytes viewed as BIG-endian uint64 compare exactly like
    the strings (lexicographic bytes == unicode order for ASCII, and the
    null padding ranks shorter prefixes first), so the distinct + sort
    runs on machine integers. Returns None when the precondition fails
    (not a fixed-width unicode array, long or non-ASCII ids)."""
    if arr.dtype.kind != "U" or arr.dtype.itemsize > 32 or arr.size == 0:
        return None
    n_chars = arr.dtype.itemsize // 4
    # numpy unicode is UTF-32: view the raw codepoints with zero copies
    cps = np.ascontiguousarray(arr).view(np.uint32).reshape(-1, n_chars)
    if cps.max(initial=0) > 127:
        return None                     # non-ASCII: byte order != str order
    packed = np.zeros((len(arr), 8), np.uint8)
    packed[:, :n_chars] = cps.astype(np.uint8)
    ints = packed.view(">u8").reshape(-1).astype(np.uint64)
    uniq_int, codes = np.unique(ints, return_inverse=True)
    # rebuild the vocab strings from the sorted distinct ints (small)
    ub = uniq_int.astype(">u8").view(np.uint8).reshape(-1, 8)[:, :n_chars]
    vocab = np.ascontiguousarray(
        ub.astype(np.uint32)).view(arr.dtype).reshape(-1)
    return vocab, codes.reshape(-1).astype(np.int32)


def assign_indices(values: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Distinct-id assignment for the training path: ``(vocab, codes)``
    with ``vocab`` the sorted distinct ids and ``codes[i]`` the index of
    ``values[i]`` in it (the sorted order ``vocab_index`` relies on)."""
    arr = np.asarray(values)
    fast = _assign_indices_u64(arr)
    if fast is not None:
        return fast
    try:
        vocab, codes = np.unique(arr, return_inverse=True)
    except TypeError as e:      # None or NaN beside strings
        raise ValueError("null/NaN id in values — every entity id must "
                         "be a concrete string") from e
    return vocab, codes.reshape(-1).astype(np.int32)
