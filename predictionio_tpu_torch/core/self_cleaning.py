"""Self-cleaning data source: sliding event-window cleanup (port of the
reference's ``core/self_cleaning.py``).

Parity with SelfCleaningDataSource (core/.../core/
SelfCleaningDataSource.scala:42-324): a DataSource may declare an
EventWindow; ``clean_persisted_events`` then

  * drops events older than the window's duration     (:160 cleanPersisted)
  * compresses each entity's ``$set`` chain into one ``$set`` carrying the
    folded properties                                   (:106 compressProperties)
  * removes identical events                            (removeDuplicates)
  * rewrites the store crash-safely: the cleaned events under new ids
    first, then the old rows deleted                    (:176 wipe)

``get_cleaned_events`` applies the same rules read-only, for training.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import logging
from typing import Iterable, List, Optional

from predictionio_tpu_torch.data.aggregator import aggregate_properties_single
from predictionio_tpu_torch.data.event import UTC, Event, millis

logger = logging.getLogger("pio.selfcleaning")


@dataclasses.dataclass
class EventWindow:
    """EventWindow parity: a duration such as "30 days" or "12 hours",
    and the two flags."""

    duration: Optional[str] = None
    remove_duplicates: bool = False
    compress_properties: bool = False

    def cutoff(self, now: Optional[_dt.datetime] = None
               ) -> Optional[_dt.datetime]:
        if not self.duration:
            return None
        now = now or _dt.datetime.now(tz=UTC)
        value, _, unit = self.duration.partition(" ")
        seconds_per = {"second": 1, "minute": 60, "hour": 3600, "day": 86400,
                       "week": 604800}
        unit = unit.rstrip("s") or "day"
        if unit not in seconds_per:
            raise ValueError(f"unknown EventWindow duration unit {unit!r}")
        return now - _dt.timedelta(seconds=float(value) * seconds_per[unit])


def _dedup_key(e: Event) -> tuple:
    return (e.event, e.entity_type, e.entity_id, e.target_entity_type,
            e.target_entity_id, e.properties.to_json(), millis(e.event_time))


def clean_events(events: Iterable[Event], window: EventWindow,
                 now: Optional[_dt.datetime] = None) -> List[Event]:
    """The window's rules applied to an event list."""
    events = list(events)
    cutoff = window.cutoff(now)
    if cutoff is not None:
        events = [e for e in events if e.event_time >= cutoff]
    if window.compress_properties:
        special, rest = [], []
        for e in events:
            (special if e.event in ("$set", "$unset", "$delete")
             else rest).append(e)
        compressed = []
        by_entity: dict = {}
        for e in special:
            by_entity.setdefault((e.entity_type, e.entity_id), []).append(e)
        for (etype, eid), evs in by_entity.items():
            pm = aggregate_properties_single(evs)
            if pm is None:
                continue  # entity deleted within the window
            compressed.append(Event(
                event="$set", entity_type=etype, entity_id=eid,
                properties=pm.fields, event_time=pm.last_updated,
                creation_time=pm.last_updated))
        events = sorted(compressed + rest, key=lambda e: millis(e.event_time))
    if window.remove_duplicates:
        seen = set()
        out = []
        for e in events:
            k = _dedup_key(e)
            if k not in seen:
                seen.add(k)
                out.append(e)
        events = out
    return events


class SelfCleaningDataSource:
    """Mixin for DataSources (SelfCleaningDataSource.scala:42).

    Subclasses set ``event_window`` and ``app_name`` (and optionally
    ``channel_name``); ``get_cleaned_events()`` reads cleaned events,
    ``clean_persisted_events()`` rewrites the store in place.
    """

    event_window: Optional[EventWindow] = None
    app_name: str = ""
    channel_name: Optional[str] = None

    def get_cleaned_events(self, **find_kwargs) -> List[Event]:
        """getCleanedPEvents:77 parity (read-only)."""
        from predictionio_tpu_torch.data.eventstore import EventStoreClient

        events = EventStoreClient.find(
            app_name=self.app_name, channel_name=self.channel_name,
            **find_kwargs)
        if self.event_window is None:
            return list(events)
        return clean_events(events, self.event_window)

    def clean_persisted_events(self) -> int:
        """cleanPersistedPEvents:160: rewrite the store with the cleaned
        events; returns how many were written."""
        if self.event_window is None:
            return 0
        from predictionio_tpu_torch.data.eventstore import resolve_app
        from predictionio_tpu_torch.storage.registry import Storage

        app_id, channel_id = resolve_app(self.app_name, self.channel_name)
        store = Storage.get_events()
        old = list(store.find(app_id, channel_id))
        cleaned = clean_events(old, self.event_window)
        # crash-safe order: the cleaned events under NEW ids first, then
        # the old rows deleted: a crash in between leaves duplicates
        # (cleanable again), never a loss
        fresh = [dataclasses.replace(e, event_id=None) for e in cleaned]
        if fresh:
            store.insert_batch(fresh, app_id, channel_id)
        for e in old:
            if e.event_id:
                store.delete(e.event_id, app_id, channel_id)
        logger.info("cleaned %s events for app %s", len(fresh), self.app_name)
        return len(fresh)
