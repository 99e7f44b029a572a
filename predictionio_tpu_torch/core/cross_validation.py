"""Shared k-fold cross-validation helpers (a copy of the reference's
``core/cross_validation.py``, numpy only).

The analog of the reference's e2 CommonHelperFunctions.splitData
(e2/src/main/scala/org/apache/predictionio/e2/evaluation/
CrossValidation.scala:36): fold membership by index modulo, shared by
every engine's readEval instead of hand-rolled per template.

The split exists in two shapes:

* ``split_data`` / ``k_fold`` — per-fold index/item views, the
  reference-parity API the sequential eval path consumes.
* ``fold_assignments`` / ``fold_masks`` — ONE vectorized pass emitting
  the fold id per data point (and boolean test-mask columns derived from
  it). The device-batched eval sweep trains every fold from a single
  shared data layout with test entries zero-weighted, so it needs fold
  membership as an array aligned with the data, not K index subsets.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple, TypeVar

import numpy as np

T = TypeVar("T")


def _check_k(k: int, n: int) -> None:
    if k < 1:
        raise ValueError(f"kFold must be >= 1, got {k}")
    if k > n:
        # index-mod-k membership would silently yield EMPTY test folds for
        # every fold >= n, and a sweep scored on an empty fold reports NaN
        # instead of the configuration error it actually is
        raise ValueError(
            f"kFold={k} exceeds the number of data points ({n}); "
            "every fold needs at least one test point")


def fold_assignments(k: int, n: int) -> np.ndarray:
    """int32 [n] fold id per data point (index mod k), validated once.

    The single source of truth for fold membership: ``split_data`` and the
    batched sweep's per-fold weight masks both derive from it, so the
    sequential and vectorized eval paths can never disagree on the split.
    """
    _check_k(k, n)
    return (np.arange(n, dtype=np.int64) % k).astype(np.int32)


def fold_masks(k: int, n: int) -> np.ndarray:
    """bool [k, n] — row f is the TEST mask of fold f (train = ~row).

    The mask-column view of ``fold_assignments``, built by one
    vectorized comparison instead of K index scans — for host-side
    consumers that want boolean columns. (The device-batched eval sweep
    itself packs the raw ``fold_assignments`` ids into its row layout
    and derives ``fold_ids != fold`` on device; both views share the
    same assignment, so they can never disagree.)
    """
    fold_of = fold_assignments(k, n)
    return fold_of[None, :] == np.arange(k, dtype=np.int32)[:, None]


def split_data(k: int, n: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (train_indices, test_indices) per fold for n data points,
    fold membership = index mod k (CrossValidation.scala:36 parity)."""
    fold_of = fold_assignments(k, n)
    idx = np.arange(n)
    for fold in range(k):
        test_mask = fold_of == fold
        yield idx[~test_mask], idx[test_mask]


def k_fold(items: Sequence[T], k: int) -> Iterator[Tuple[List[T], List[T]]]:
    """Yield (train_items, test_items) per fold over a concrete sequence."""
    for train_idx, test_idx in split_data(k, len(items)):
        yield ([items[i] for i in train_idx],
               [items[i] for i in test_idx])
