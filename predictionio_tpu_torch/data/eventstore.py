"""App-name-facing event store facade (port of the reference's
``data/eventstore.py``, with the single-process training read of
``data/ingest.py``: ``training_scan`` + ``event_columns``).

App name (+ channel name) -> (app_id, channel_id) resolution is cached,
as in store/Common.scala:25-60. The multi-process sharded read belongs
to a later slice of the port.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.storage.base import StorageError
from predictionio_tpu_torch.storage.registry import Storage

_channel_cache: Dict[Tuple[str, Optional[str]], Tuple[int, Optional[int]]] = {}
_channel_cache_lock = threading.Lock()


def resolve_app(app_name: str, channel_name: Optional[str] = None
                ) -> Tuple[int, Optional[int]]:
    """app name (+ optional channel name) -> (app_id, channel_id),
    cached."""
    key = (app_name, channel_name)
    with _channel_cache_lock:
        if key in _channel_cache:
            return _channel_cache[key]
    app = Storage.get_meta_data_apps().get_by_name(app_name)
    if app is None:
        raise StorageError(f"Invalid app name {app_name}")
    channel_id = None
    if channel_name is not None:
        channels = Storage.get_meta_data_channels().get_by_appid(app.id)
        matched = [c for c in channels if c.name == channel_name]
        if not matched:
            raise StorageError(
                f"Invalid channel name {channel_name} for app {app_name}")
        channel_id = matched[0].id
    with _channel_cache_lock:
        _channel_cache[key] = (app.id, channel_id)
    return app.id, channel_id


def clear_cache() -> None:
    with _channel_cache_lock:
        _channel_cache.clear()


class EventStoreClient:
    """The configured event store, by app name."""

    @staticmethod
    def find(app_name: str, channel_name: Optional[str] = None,
             **filters) -> Iterator[Event]:
        """PEventStore.find:59 / LEventStore.find:197 parity."""
        app_id, channel_id = resolve_app(app_name, channel_name)
        return Storage.get_events().find(app_id=app_id,
                                         channel_id=channel_id, **filters)

    @staticmethod
    def find_columns(app_name: str, channel_name: Optional[str] = None,
                     **filters) -> Dict[str, np.ndarray]:
        """The store's numpy columns of the matching events (the
        reference's ``find_columnar``; ``SqliteEvents.find_columns``
        filters and ``columns``)."""
        app_id, channel_id = resolve_app(app_name, channel_name)
        return Storage.get_events().find_columns(app_id, channel_id,
                                                 **filters)

    @staticmethod
    def aggregate_properties(app_name: str, entity_type: str,
                             channel_name: Optional[str] = None,
                             start_time=None, until_time=None,
                             required: Optional[Sequence[str]] = None
                             ) -> Dict[str, PropertyMap]:
        """PEventStore.aggregateProperties:87 parity: ``{entity_id:
        PropertyMap}`` of the live entities of ``entity_type``
        (``required``: only those carrying every named field)."""
        app_id, channel_id = resolve_app(app_name, channel_name)
        return Storage.get_events().aggregate_properties(
            app_id, entity_type, channel_id=channel_id,
            start_time=start_time, until_time=until_time,
            required=required)

    @staticmethod
    def training_columns(app_name: str, channel_name: Optional[str] = None,
                         **filters) -> Dict[str, np.ndarray]:
        """The training read (single-process ``training_scan`` +
        ``event_columns``): the store's numpy columns (the reference
        reads a pyarrow table), without the time sort (training math is
        permutation-invariant) unless the caller asks for it."""
        filters.setdefault("ordered", False)
        return EventStoreClient.find_columns(app_name, channel_name,
                                             **filters)


def property_column(properties: np.ndarray, key: str,
                    dtype=np.float32) -> np.ndarray:
    """One numeric property out of a column of JSON property strings
    (the reference's ``data/columnar.property_column``): each distinct
    string is parsed once; absent keys and NULL properties give NaN."""
    if len(properties) == 0:
        return np.empty(0, dtype=dtype)
    parsed: Dict[Optional[str], float] = {}
    for p in set(properties.tolist()):
        parsed[p] = np.nan if p is None else json.loads(p).get(key, np.nan)
    lut = np.asarray(list(parsed.values()), dtype=dtype)
    index = {p: j for j, p in enumerate(parsed)}
    return lut[np.fromiter((index[p] for p in properties.tolist()),
                           np.int64, count=len(properties))]
