"""evlog event store: an append-only binary log with a native (C++) codec
(port of the reference's ``storage/evlog_backend.py``).

The event store for bulk event volume, the analog of PredictionIO's HBase
backend (storage/hbase/.../HBEventsUtil.scala:49-408, HBLEvents.scala:
37-209). Where HBase keys rows by MD5(entityType-entityId) ++ eventTime
++ uuid so entity and time-range queries become prefix scans
(HBEventsUtil.scala:76-131), evlog frames every record with (eventTime
millis, FNV-1a entity hash, 16-byte id), so the codec (``native/evlog``)
filters by time range, entity or id without parsing the JSON payloads.
Deletions append tombstone frames (flags bit 0) that carry the original
record's id, time and hash.

One file per (app, channel) namespace, ``events_<app>[_<channel>].evlog``
under the source's PATH (HBase's table a namespace,
``<ns>:events_<app>[_<ch>]``, HBEventsUtil.scala:53), byte for byte the
reference's files. The training read is the base class's
``find_columns``, through ``find``; there is no ``read_snapshot`` (a
multi-process train reads the whole store in every process) and no
snapshot digest (the scan cache never keys on it).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import hashlib
import os
import threading
from typing import Dict, Iterator, List, Optional, Sequence

from predictionio_tpu_torch.data.event import Event, millis as _to_ms
from predictionio_tpu_torch.native.evlog import (
    T_MAX, T_MIN, TOMBSTONE, EvlogError, entity_hash, get_codec,
)
from predictionio_tpu_torch.storage import base
from predictionio_tpu_torch.storage.base import (
    StorageError, UNFILTERED, generate_id,
)


def _id_bytes(event_id: str) -> bytes:
    """16 raw bytes for the frame id: a uuid's hex directly, else the MD5
    of the id (user-supplied ids still get a fixed-width scan key)."""
    if len(event_id) == 32:
        try:
            return bytes.fromhex(event_id)
        except ValueError:
            pass
    return hashlib.md5(event_id.encode()).digest()


def _matches(value: Optional[str], want) -> bool:
    """A filter of one id (a string) or of any of a list of ids."""
    return value == want if isinstance(want, str) else value in want


class EvlogClient:
    """A directory of evlog files, a lock a file and the loaded codec
    (``codec.name`` says which one was chosen)."""

    def __init__(self, path: str, codec: Optional[str] = None):
        self.base_dir = path
        os.makedirs(path, exist_ok=True)
        self.codec = get_codec(codec)
        self._locks: Dict[str, threading.Lock] = {}
        self._locks_guard = threading.Lock()

    def lock(self, path: str) -> threading.Lock:
        with self._locks_guard:
            if path not in self._locks:
                self._locks[path] = threading.Lock()
            return self._locks[path]

    def close(self) -> None:
        pass


class EvlogEvents(base.EventStore):
    """EventStore over the evlog codec (LEvents trait parity)."""

    def __init__(self, client: EvlogClient):
        self.client = client

    # -- namespaces ---------------------------------------------------------

    def _path(self, app_id: int, channel_id: Optional[int]) -> str:
        name = f"events_{app_id}" + (
            f"_{channel_id}" if channel_id is not None else "")
        return os.path.join(self.client.base_dir, name + ".evlog")

    def _existing(self, app_id: int, channel_id: Optional[int]) -> str:
        path = self._path(app_id, channel_id)
        if not os.path.exists(path):
            raise StorageError(f"no evlog at {path}")
        return path

    def init_channel(self, app_id: int,
                     channel_id: Optional[int] = None) -> bool:
        try:
            self.client.codec.create(self._path(app_id, channel_id))
            return True
        except EvlogError:
            return False

    def remove_channel(self, app_id: int,
                       channel_id: Optional[int] = None) -> bool:
        path = self._path(app_id, channel_id)
        with self.client.lock(path):
            if os.path.exists(path):
                os.unlink(path)
                return True
        return False

    def close(self) -> None:
        self.client.close()

    # -- writes -------------------------------------------------------------

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        path = self._path(app_id, channel_id)
        if not os.path.exists(path):
            raise StorageError(
                f"cannot insert into app {app_id} channel {channel_id}: "
                f"no evlog at {path}. Was the app initialized (pio app new)?")
        records, ids = [], []
        for e in events:
            eid = e.event_id or generate_id()
            ids.append(eid)
            stored = dataclasses.replace(e, event_id=eid)
            records.append((
                _to_ms(e.event_time),
                entity_hash(e.entity_type, e.entity_id),
                0, _id_bytes(eid), stored.to_json().encode()))
        with self.client.lock(path):
            self.client.codec.append(path, records)
        return ids

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        path = self._path(app_id, channel_id)
        if not os.path.exists(path):
            return False
        rid = _id_bytes(event_id)
        with self.client.lock(path):
            matches = self.client.codec.scan(path, rid=rid)
            if not matches or matches[-1][2] & TOMBSTONE:
                return False
            t, h, _flags, _rid, _payload = matches[-1]
            self.client.codec.append(path, [(t, h, TOMBSTONE, rid, b"")])
        return True

    # -- reads --------------------------------------------------------------

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        path = self._existing(app_id, channel_id)
        matches = self.client.codec.scan(path, rid=_id_bytes(event_id))
        if not matches or matches[-1][2] & TOMBSTONE:
            return None
        return Event.from_json(matches[-1][4].decode())

    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id=None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type=UNFILTERED,
        target_entity_id=UNFILTERED,
        limit: Optional[int] = None,
        reversed_order: bool = False,
    ) -> Iterator[Event]:
        """LEvents.futureFind:188 over one scan of the log. ``entity_id``
        and ``target_entity_id`` also take a list of ids (any of them
        matches), as the sqlite store's do."""
        path = self._existing(app_id, channel_id)
        t_lo = _to_ms(start_time) if start_time is not None else T_MIN
        t_hi = _to_ms(until_time) if until_time is not None else T_MAX
        # the entity filter rides the frame hash (the HBase prefix-scan
        # analog) when both halves name one entity; the hash is a
        # prefilter only: exact equality is applied on the decoded event
        ehash = (entity_hash(entity_type, entity_id)
                 if entity_type is not None and isinstance(entity_id, str)
                 else 0)
        records = self.client.codec.scan(path, t_lo, t_hi, ehash)

        # a record is dead only if a tombstone for its id appears LATER in
        # the log: re-inserting after a delete resurrects the id
        dead = {}
        for i, r in enumerate(records):
            if r[2] & TOMBSTONE:
                dead[r[3]] = i
        events = []
        for i, (_t, _h, flags, rid, payload) in enumerate(records):
            if flags & TOMBSTONE or dead.get(rid, -1) > i:
                continue
            e = Event.from_json(payload.decode())
            if entity_type is not None and e.entity_type != entity_type:
                continue
            if entity_id is not None and not _matches(e.entity_id,
                                                      entity_id):
                continue
            if event_names is not None and e.event not in event_names:
                continue
            if target_entity_type is not UNFILTERED and \
                    e.target_entity_type != target_entity_type:
                continue
            if target_entity_id is not UNFILTERED and (
                    e.target_entity_id != target_entity_id
                    if target_entity_id is None
                    else not _matches(e.target_entity_id,
                                      target_entity_id)):
                continue
            events.append(e)
        # stable: equal times keep the log's (append) order
        events.sort(key=lambda e: e.event_time, reverse=reversed_order)
        if limit is not None and limit >= 0:
            events = events[:limit]
        return iter(events)
