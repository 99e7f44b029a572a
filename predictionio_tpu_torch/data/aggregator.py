"""Folding ``$set``/``$unset``/``$delete`` events into per-entity
PropertyMaps (copy of the reference's ``data/aggregator.py``, the
LEventAggregator semantics). Per entity, over events sorted by event
time:

  * ``$set``    — merge properties into the current map (later values
                  win); (re)creates the entity if deleted or absent
  * ``$unset``  — remove the named keys (no-op if the entity is absent)
  * ``$delete`` — drop the entity (a later ``$set`` recreates it)
  * any other event — ignored
  * first_updated / last_updated — min/max event time over the special
    events

Entities whose fold ends with no live map (never ``$set``, or deleted
last) are left out of the result. This is the row-at-a-time fold; the
training read reaches the same semantics through the vectorized fold
over the store's columns (``data/columnar.aggregate_properties_columns``).
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict, Iterable, Optional

from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import Event, millis

#: event names that drive aggregation (LEventAggregator.scala:91)
AGGREGATOR_EVENT_NAMES = ("$set", "$unset", "$delete")


class _Fold:
    __slots__ = ("fields", "first", "last")

    def __init__(self):
        # fields is None <=> entity absent/deleted; {} is a live empty entity
        self.fields: Optional[dict] = None
        self.first: Optional[_dt.datetime] = None
        self.last: Optional[_dt.datetime] = None

    def step(self, e: Event) -> None:
        name = e.event
        if name not in AGGREGATOR_EVENT_NAMES:
            return
        t = e.event_time
        self.first = t if self.first is None or t < self.first else self.first
        self.last = t if self.last is None or t > self.last else self.last
        if name == "$set":
            if self.fields is None:
                self.fields = dict(e.properties.fields)
            else:
                self.fields.update(e.properties.fields)
        elif name == "$unset":
            if self.fields is not None:
                for k in e.properties.key_set():
                    self.fields.pop(k, None)
        else:  # $delete
            self.fields = None

    def result(self) -> Optional[PropertyMap]:
        if self.fields is None:
            return None
        return PropertyMap(self.fields, self.first, self.last)


def aggregate_properties_single(events: Iterable[Event]
                                ) -> Optional[PropertyMap]:
    """Fold one entity's events (sorted by time here, stably) into a
    PropertyMap (LEventAggregator.aggregatePropertiesSingle)."""
    fold = _Fold()
    for e in sorted(events, key=lambda ev: millis(ev.event_time)):
        fold.step(e)
    return fold.result()


def aggregate_properties(events: Iterable[Event]) -> Dict[str, PropertyMap]:
    """Group events by entity id and fold each group, keeping live
    entities (LEventAggregator.aggregateProperties)."""
    by_entity: Dict[str, list] = {}
    for e in events:
        by_entity.setdefault(e.entity_id, []).append(e)
    out: Dict[str, PropertyMap] = {}
    for entity_id, evs in by_entity.items():
        pm = aggregate_properties_single(evs)
        if pm is not None:
            out[entity_id] = pm
    return out
