"""Shared query/result types and helpers of the ALS engine family (port
of the reference's ``engines/common.py``).

The similar-product and e-commerce engines share the reference's
``{"itemScores": [{"item": ..., "score": ...}]}`` wire shape and the
category / white / black candidate rules (isCandidateItem in both
templates); every ALS engine resolves its training solver here.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from predictionio_tpu_torch.data.bimap import batch_lookup


@dataclasses.dataclass
class Item:
    categories: Optional[List[str]] = None


@dataclasses.dataclass
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass
class PredictedResult:
    item_scores: List[ItemScore]

    def to_dict(self):
        return {"itemScores": [{"item": s.item, "score": s.score}
                               for s in self.item_scores]}


def categories_match(item: Optional[Item], wanted) -> bool:
    """True when there is no category filter, or the item shares a
    category with it."""
    if not wanted:
        return True
    cats = (item or Item()).categories or []
    return bool(set(wanted) & set(cats))


@dataclasses.dataclass
class InteractionColumns:
    """Columnar entity -> target interactions: parallel arrays straight
    from the event store's columnar read. Engines that never read times
    or likes leave them None."""

    users: np.ndarray                     # object (string ids)
    items: np.ndarray                     # object
    times: Optional[np.ndarray] = None    # int64 epoch ms
    likes: Optional[np.ndarray] = None    # bool (like=True)

    def __len__(self) -> int:
        return len(self.users)


def item_meta_join(item_vocab, items: Dict[str, Item]) -> Dict[int, Item]:
    """Join ``$set`` item metadata onto a trained sorted vocab with one
    batch lookup."""
    ids = np.asarray(list(items), dtype=object)
    idxs = batch_lookup(item_vocab, ids)
    return {int(ix): items[str(k)] for ix, k in zip(idxs, ids) if ix >= 0}


class EntityEventCache:
    """Short-TTL per-entity cache over the columnar event read: the
    serving-time business-rule lookups (e-commerce's unseen-only,
    recent-items and unavailable-items rules).

    Each lookup is one projected ``find_columns`` read decoded straight
    to target ids, and repeated lookups of one entity inside ``ttl_s``
    come from memory. The TTL (default 1 s, ``PIO_ENTITY_CACHE_TTL_S``)
    bounds the staleness: a just-viewed item may be recommended for up
    to ``ttl_s`` more. Hits and misses are counted per lookup kind in
    ``pio_serving_entity_cache_{hits,misses}_total``."""

    MAX_ENTRIES = 4096

    def __init__(self, app_name: str, channel_name: Optional[str] = None,
                 ttl_s: Optional[float] = None, registry=None):
        from predictionio_tpu_torch.obs.foldin_stats import (
            entity_cache_hits, entity_cache_misses,
        )

        self.app_name = app_name
        self.channel_name = channel_name
        if ttl_s is None:
            try:
                ttl_s = float(os.environ.get("PIO_ENTITY_CACHE_TTL_S",
                                             "1.0"))
            except ValueError:
                ttl_s = 1.0
        self.ttl_s = max(0.0, ttl_s)
        self._lock = threading.Lock()
        self._cache: dict = {}
        #: ``pio_serving_entity_cache_{hits,misses}_total{lookup}``
        self._hits = entity_cache_hits(registry)
        self._misses = entity_cache_misses(registry)

    def _get(self, key, lookup: str):
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None and time.monotonic() - hit[0] < self.ttl_s:
                self._hits.inc(lookup=lookup)
                return hit[1]
        self._misses.inc(lookup=lookup)
        return None

    def _put(self, key, value) -> None:
        with self._lock:
            if len(self._cache) >= self.MAX_ENTRIES:
                self._cache.clear()     # TTL entries: a wholesale reset
            self._cache[key] = (time.monotonic(), value)

    def _columns(self, **filters) -> Dict[str, np.ndarray]:
        from predictionio_tpu_torch.data.eventstore import EventStoreClient

        return EventStoreClient.find_columns(self.app_name,
                                             self.channel_name, **filters)

    def targets(self, entity_type: str, entity_id: str, event_names,
                target_entity_type: Optional[str] = None,
                limit: Optional[int] = None, latest: bool = True,
                lookup: str = "targets") -> tuple:
        """Distinct target entity ids of the entity's matching events
        (latest first when ``limit`` bounds the read)."""
        names = tuple(event_names)
        key = ("targets", entity_type, entity_id, names,
               target_entity_type, limit, latest)
        cached = self._get(key, lookup)
        if cached is not None:
            return cached
        filters = dict(entity_type=entity_type, entity_id=entity_id,
                       event_names=list(names), ordered=bool(limit),
                       columns=("target_entity_id",))
        if target_entity_type is not None:
            filters["target_entity_type"] = target_entity_type
        if limit is not None and limit > 0:
            filters["limit"] = limit
            filters["reversed_order"] = latest
        tids = self._columns(**filters)["target_entity_id"]
        seen, out = set(), []
        for t in tids:
            if t is not None and t not in seen:
                seen.add(t)
                out.append(t)
        value = tuple(out)
        self._put(key, value)
        return value

    def latest_properties(self, entity_type: str, entity_id: str,
                          event_names, lookup: str = "constraint"):
        """The latest matching event's properties dict (None when the
        entity has no such event): the unavailable-items read."""
        names = tuple(event_names)
        key = ("props", entity_type, entity_id, names)
        cached = self._get(key, lookup)
        if cached is not None:
            return cached[0]
        raw = self._columns(entity_type=entity_type, entity_id=entity_id,
                            event_names=list(names), limit=1,
                            reversed_order=True,
                            columns=("properties",))["properties"]
        props = None
        if len(raw):
            props = json.loads(raw[0]) if raw[0] else {}
        # a tuple, so a cached None is told apart from a miss
        self._put(key, (props,))
        return props


def resolved_als_solver(algo_params, logger) -> "tuple[str, int]":
    """Resolve and log the ALS training solver for an engine's train():
    the algo params' optional ``solver`` section through
    ``utils/server_config.als_solver_config`` (the server.json ``train``
    section and ``PIO_ALS_*`` env apply)."""
    from predictionio_tpu_torch.utils.server_config import als_solver_config

    solver, block_size = als_solver_config(
        getattr(algo_params, "solver", None))
    logger.info("ALS solver: %s (block_size=%d, rank=%d)",
                solver, block_size, algo_params.rank)
    return solver, block_size
