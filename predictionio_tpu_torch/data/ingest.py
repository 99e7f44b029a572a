"""The columnar training-ingest helpers the engines share (the part of
the reference's ``data/ingest.py`` that the ALS engines use): entity
properties for a training read, id interning, and the (user, item)
aggregations on flat numpy arrays, with no per-event Python objects.

The training read itself is ``EventStoreClient.training_columns``. The
reference's snapshot-digest scan cache, its ``ingest_*`` spans and its
sharded multi-process read are not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from predictionio_tpu_torch.data.bimap import assign_indices


def aggregate_scan(app_name: str, entity_type: str,
                   channel_name: Optional[str] = None, *, required=None):
    """Entity properties for a training read: ``{entity_id:
    PropertyMap}`` of the vectorized ``$set``/``$unset``/``$delete``
    fold (``EventStoreClient.aggregate_properties``)."""
    from predictionio_tpu_torch.data.eventstore import EventStoreClient

    return EventStoreClient.aggregate_properties(
        app_name, entity_type, channel_name=channel_name,
        required=required)


def intern_pairs(users: np.ndarray, items: np.ndarray):
    """Id interning for an interaction table: ``(user_vocab,
    user_codes, item_vocab, item_codes)`` through ``assign_indices``."""
    user_vocab, user_codes = assign_indices(users)
    item_vocab, item_codes = assign_indices(items)
    return user_vocab, user_codes, item_vocab, item_codes


def pair_counts(users: np.ndarray, items: np.ndarray,
                weights: Optional[np.ndarray] = None):
    """Aggregate duplicate (user, item) rows: the distinct pairs and the
    sum of ``weights`` (default 1.0 each) per pair, the vectorized
    ``counts[(u, i)] += w`` fold. Returns ``(users', items', sums)``
    sorted by interned codes (factorization does not depend on the
    order)."""
    if len(users) == 0:
        return (np.empty(0, object), np.empty(0, object),
                np.empty(0, np.float32))
    user_vocab, ucodes, item_vocab, icodes = intern_pairs(users, items)
    combined = ucodes.astype(np.int64) * len(item_vocab) + icodes
    uniq, inv = np.unique(combined, return_inverse=True)
    w = (np.ones(len(users), np.float32) if weights is None
         else np.asarray(weights, np.float32))
    sums = np.bincount(inv.reshape(-1), weights=w,
                       minlength=len(uniq)).astype(np.float32)
    u_out = user_vocab[(uniq // len(item_vocab)).astype(np.int64)]
    i_out = item_vocab[(uniq % len(item_vocab)).astype(np.int64)]
    return u_out, i_out, sums


def latest_per_pair(users: np.ndarray, items: np.ndarray,
                    times: np.ndarray, values: np.ndarray):
    """Latest-wins per (user, item) by event time, the vectorized
    ``if e.t > latest[key].t`` fold with its strict ``>``: of events with
    equal timestamps the FIRST in scan order wins (the descending
    position tiebreak below). Returns ``(users', items', values')`` for
    the distinct pairs."""
    if len(users) == 0:
        return users, items, values
    user_vocab, ucodes, item_vocab, icodes = intern_pairs(users, items)
    combined = ucodes.astype(np.int64) * len(item_vocab) + icodes
    order = np.lexsort((np.arange(len(users))[::-1], times, combined))
    cs = combined[order]
    is_last = np.r_[cs[1:] != cs[:-1], True]
    winners = order[is_last]
    return users[winners], items[winners], values[winners]
