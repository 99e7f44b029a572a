"""The columnar training-ingest helpers the engines share (port of the
reference's ``data/ingest.py``): the training read, entity properties
for a training read, id interning, and the (user, item) aggregations on
flat numpy arrays, with no per-event Python objects.

* **scan cache** — keyed by the store's ``snapshot_digest()``, so the
  repeated folds of ``pio eval`` (k-fold re-reads) and back-to-back
  ``pio train`` runs skip the rescan while the store has not changed
  (``_CACHE_MAX`` reads a process, first in first out). Disable with
  ``PIO_INGEST_CACHE=0``. A cached read's numpy columns are read-only:
  every caller gets the same arrays.
* **``pio_ingest_*`` metrics** — rows scanned, rows/s, cache hit/miss
  counters on the process registry, and the ``ingest_scan``,
  ``ingest_aggregate``, ``ingest_intern`` and ``ingest_assemble`` spans
  through the obs span histogram.

The training read is :func:`training_columns`, which
``EventStoreClient.training_columns`` calls. The reference's sharded
multi-process read is not ported (ROADMAP item A12).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

import numpy as np

from predictionio_tpu_torch.data.bimap import assign_indices
from predictionio_tpu_torch.obs.registry import (
    MetricsRegistry, default_registry,
)
from predictionio_tpu_torch.obs.tracing import span

#: scans cached a process; small: each entry is one app's filtered
#: training read (the k-fold reuse window, not a general query cache)
_CACHE_MAX = 8

_scan_cache: dict = {}
_scan_lock = threading.Lock()


def clear_scan_cache() -> None:
    with _scan_lock:
        _scan_cache.clear()


def _cache_enabled() -> bool:
    return os.environ.get("PIO_INGEST_CACHE", "1") != "0"


def _registry() -> MetricsRegistry:
    return default_registry()


def _count_rows(app_name: str, n: int, seconds: float) -> None:
    reg = _registry()
    reg.counter("pio_ingest_rows_total",
                "Event rows delivered to training reads by the columnar "
                "ingest path", labelnames=("app",)).inc(n, app=app_name)
    if seconds > 0:
        reg.gauge("pio_ingest_rows_per_second",
                  "Throughput of the most recent columnar training scan",
                  labelnames=("app",)).set(n / seconds, app=app_name)


def _count_cache(app_name: str, hit: bool) -> None:
    name = ("pio_ingest_cache_hits_total" if hit
            else "pio_ingest_cache_misses_total")
    verb = "hits" if hit else "misses"
    _registry().counter(
        name, f"Ingest scan-cache {verb} (snapshot-digest keyed)",
        labelnames=("app",)).inc(app=app_name)


def _cache_get(app_name: str, key):
    """Lookup and hit/miss accounting, shared by both cached reads."""
    with _scan_lock:
        hit = _scan_cache.get(key)
    _count_cache(app_name, hit is not None)
    return hit


def _cache_put(key, value) -> None:
    """Size-capped first-in-first-out insert."""
    with _scan_lock:
        if len(_scan_cache) >= _CACHE_MAX and key not in _scan_cache:
            _scan_cache.pop(next(iter(_scan_cache)))
        _scan_cache[key] = value


def _digest(app_name: str, channel_name: Optional[str]) -> Optional[str]:
    from predictionio_tpu_torch.data.eventstore import EventStoreClient

    return EventStoreClient.snapshot_digest(app_name, channel_name)


def training_columns(app_name: str, channel_name: Optional[str] = None, *,
                     cache: bool = True, **filters) -> Dict[str, np.ndarray]:
    """The shared columnar training read: the store's numpy columns of
    the matching events (``find_columns`` filters and ``columns``),
    without the time sort unless the caller asks for it (training math
    is permutation-invariant), snapshot-digest cached, under the
    ``ingest_scan`` span. Returns a fresh dict of read-only arrays."""
    from predictionio_tpu_torch.data.eventstore import EventStoreClient

    filters.setdefault("ordered", False)
    key = None
    if cache and _cache_enabled():
        digest = _digest(app_name, channel_name)
        if digest is not None:
            key = (app_name, channel_name, digest, None,
                   tuple(sorted(
                       (k, tuple(v) if isinstance(v, list) else v)
                       for k, v in filters.items())))
            hit = _cache_get(app_name, key)
            if hit is not None:
                return dict(hit)
    t0 = time.perf_counter()
    with span("ingest_scan", registry=_registry()):
        cols = EventStoreClient.find_columns(app_name, channel_name,
                                             **filters)
    n = len(next(iter(cols.values()))) if cols else 0
    _count_rows(app_name, n, time.perf_counter() - t0)
    for a in cols.values():
        a.flags.writeable = False
    if key is not None:
        _cache_put(key, cols)
    return dict(cols)


def aggregate_scan(app_name: str, entity_type: str,
                   channel_name: Optional[str] = None, *, required=None,
                   cache: bool = True):
    """Entity properties for a training read: ``{entity_id:
    PropertyMap}`` of the vectorized ``$set``/``$unset``/``$delete``
    fold (``EventStoreClient.aggregate_properties``), behind the same
    snapshot-digest cache as :func:`training_columns` and under the
    ``ingest_aggregate`` span. A fresh dict a call (the immutable
    PropertyMaps are shared with the cache)."""
    from predictionio_tpu_torch.data.eventstore import EventStoreClient

    key = None
    if cache and _cache_enabled():
        digest = _digest(app_name, channel_name)
        if digest is not None:
            key = ("aggregate", app_name, channel_name, entity_type,
                   tuple(required) if required else None, digest)
            hit = _cache_get(app_name, key)
            if hit is not None:
                return dict(hit)
    with span("ingest_aggregate", registry=_registry()):
        out = EventStoreClient.aggregate_properties(
            app_name, entity_type, channel_name=channel_name,
            required=required)
    if key is not None:
        _cache_put(key, out)
        return dict(out)
    return out


def intern_pairs(users: np.ndarray, items: np.ndarray):
    """Id interning for an interaction table: ``(user_vocab,
    user_codes, item_vocab, item_codes)`` through ``assign_indices``,
    under an ``ingest_intern`` span."""
    with span("ingest_intern", registry=_registry()):
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
    with span("ingest_assemble", registry=_registry()):
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
    with span("ingest_assemble", registry=_registry()):
        user_vocab, ucodes, item_vocab, icodes = intern_pairs(users, items)
        combined = ucodes.astype(np.int64) * len(item_vocab) + icodes
        order = np.lexsort((np.arange(len(users))[::-1], times, combined))
        cs = combined[order]
        is_last = np.r_[cs[1:] != cs[:-1], True]
        winners = order[is_last]
    return users[winners], items[winners], values[winners]


def sessions_by_entity(users: np.ndarray, items: np.ndarray,
                       times: np.ndarray):
    """Group an interaction scan into per-user time-ordered item lists
    (the sessionrec data source's assembly): one lexsort and a segment
    split, equal event times kept in scan order. Sessions come out in
    sorted-user order, under the ``ingest_assemble`` span."""
    if len(users) == 0:
        return []
    with span("ingest_assemble", registry=_registry()):
        _, codes = assign_indices(users)
        order = np.lexsort((np.arange(len(users)), times, codes))
        codes_s = codes[order]
        items_s = items[order]
        starts = np.flatnonzero(np.r_[True, codes_s[1:] != codes_s[:-1]])
        bounds = np.r_[starts, len(codes_s)]
        return [items_s[bounds[i]:bounds[i + 1]].tolist()
                for i in range(len(starts))]
