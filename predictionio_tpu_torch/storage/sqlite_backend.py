"""Event store and app metadata on sqlite3 (port of the reference's
``storage/sqlite_backend.py``: ``SqliteClient``, ``SqliteEvents``,
``SqliteApps``).

The tables are byte-for-byte the reference's (one event table per app
and channel, ``pio_event_<app>[_<channel>]``, and ``pio_apps``), so a
store written by either package is read by the other. All SQL uses bound
parameters. Connections are per thread; WAL mode lets readers run during
writes. The training read, :meth:`SqliteEvents.find_columns`, turns SQL
rows straight into numpy columns (the reference builds a pyarrow table).
"""

from __future__ import annotations

import datetime as _dt
import json
import sqlite3
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import UTC, Event, millis as _to_ms
from predictionio_tpu_torch.storage import base
from predictionio_tpu_torch.storage.base import (
    App, StorageError, UNFILTERED, generate_id,
)


def _from_ms(ms: int, tz_offset_min: Optional[int] = None) -> _dt.datetime:
    tz = (UTC if not tz_offset_min
          else _dt.timezone(_dt.timedelta(minutes=tz_offset_min)))
    return _dt.datetime.fromtimestamp(ms / 1000, tz=UTC).astimezone(tz)


def _tz_offset_min(t: _dt.datetime) -> int:
    """The UTC offset in minutes, so reads restore the original zone."""
    off = t.utcoffset()
    return 0 if off is None else int(off.total_seconds() // 60)


class SqliteClient:
    """Shared connection manager for one sqlite database file."""

    def __init__(self, path: str = ":memory:"):
        self.path = path
        self._local = threading.local()
        # reentrant: for :memory: the write lock and the shared-connection
        # guard are the same lock, and holders of write_lock() call conn()
        self._lock = threading.RLock()
        self._memory_conn: Optional[sqlite3.Connection] = None
        if path != ":memory:":
            Path(path).parent.mkdir(parents=True, exist_ok=True)

    def conn(self) -> sqlite3.Connection:
        # one shared connection for :memory: (per-thread connections would
        # each see their own empty db); per-thread connections for files
        if self.path == ":memory:":
            with self._lock:
                if self._memory_conn is None:
                    self._memory_conn = sqlite3.connect(
                        ":memory:", check_same_thread=False)
                return self._memory_conn
        c = getattr(self._local, "conn", None)
        if c is None:
            c = sqlite3.connect(self.path)
            c.execute("PRAGMA journal_mode=WAL")
            c.execute("PRAGMA synchronous=NORMAL")
            self._local.conn = c
        return c

    def close(self) -> None:
        if self._memory_conn is not None:
            self._memory_conn.close()
            self._memory_conn = None
        c = getattr(self._local, "conn", None)
        if c is not None:
            c.close()
            self._local.conn = None

    def write_lock(self):
        return self._lock


# ---------------------------------------------------------------------------
# Events
# ---------------------------------------------------------------------------

_EVENT_COLS = ("id, event, entityType, entityId, targetEntityType, "
               "targetEntityId, properties, eventTime, eventTimeZone, tags, "
               "prId, creationTime, creationTimeZone")

#: column name of a training read -> the table's column (the reference's
#: columnar schema names, ``data/columnar.SQL_COLUMN_OF``)
SQL_COLUMN_OF = {
    "event_id": "id", "event": "event", "entity_type": "entityType",
    "entity_id": "entityId", "target_entity_type": "targetEntityType",
    "target_entity_id": "targetEntityId", "properties": "properties",
    "event_time_ms": "eventTime", "creation_time_ms": "creationTime",
}


def event_table_name(app_id: int, channel_id: Optional[int]) -> str:
    """JDBCUtils.eventTableName:108 parity: pio_event_<app>[_<channel>]."""
    suffix = f"_{channel_id}" if channel_id is not None else ""
    return f"pio_event_{app_id}{suffix}"


class SqliteEvents(base.EventStore):
    """EventStore over sqlite (JDBCLEvents.scala behavioural parity)."""

    def __init__(self, client: SqliteClient):
        self.client = client

    def init_channel(self, app_id: int,
                     channel_id: Optional[int] = None) -> bool:
        name = event_table_name(app_id, channel_id)
        with self.client.write_lock():
            self.client.conn().execute(f"""
                CREATE TABLE IF NOT EXISTS {name} (
                  id TEXT NOT NULL PRIMARY KEY,
                  event TEXT NOT NULL,
                  entityType TEXT NOT NULL,
                  entityId TEXT NOT NULL,
                  targetEntityType TEXT,
                  targetEntityId TEXT,
                  properties TEXT,
                  eventTime INTEGER NOT NULL,
                  eventTimeZone INTEGER NOT NULL,
                  tags TEXT,
                  prId TEXT,
                  creationTime INTEGER NOT NULL,
                  creationTimeZone INTEGER NOT NULL)""")
            self.client.conn().execute(
                f"CREATE INDEX IF NOT EXISTS {name}_time ON {name} (eventTime)")
            self.client.conn().commit()
        return True

    def close(self) -> None:
        self.client.close()

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        name = event_table_name(app_id, channel_id)
        rows, ids = [], []
        for e in events:
            eid = e.event_id or generate_id()
            ids.append(eid)
            rows.append((
                eid, e.event, e.entity_type, e.entity_id,
                e.target_entity_type, e.target_entity_id,
                e.properties.to_json() if not e.properties.is_empty else None,
                _to_ms(e.event_time), _tz_offset_min(e.event_time),
                ",".join(e.tags) if e.tags else None,
                e.pr_id, _to_ms(e.creation_time),
                _tz_offset_min(e.creation_time),
            ))
        try:
            with self.client.write_lock():
                self.client.conn().executemany(
                    f"INSERT INTO {name} VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)",
                    rows)
                self.client.conn().commit()
        except sqlite3.OperationalError as ex:
            raise StorageError(
                f"cannot insert into app {app_id} channel {channel_id}: {ex}. "
                "Was the app initialized (pio app new)?") from ex
        return ids

    def _find_sql(
        self,
        select_cols: str,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type=UNFILTERED,
        target_entity_id=UNFILTERED,
        limit: Optional[int] = None,
        reversed_order: bool = False,
        ordered: bool = True,
    ):
        """(sql, params) for a filtered event scan, shared by the row
        path (`find`) and the columnar training path (`find_columns`).
        The reference's ``shard`` partitioning belongs to multi-process
        training, which the port does not have yet."""
        name = event_table_name(app_id, channel_id)
        where, params = ["1=1"], []
        if start_time is not None:
            where.append("eventTime >= ?")
            params.append(_to_ms(start_time))
        if until_time is not None:
            where.append("eventTime < ?")
            params.append(_to_ms(until_time))
        if entity_type is not None:
            where.append("entityType = ?")
            params.append(entity_type)
        if entity_id is not None:
            where.append("entityId = ?")
            params.append(entity_id)
        if event_names:
            qs = ",".join("?" * len(event_names))
            where.append(f"event IN ({qs})")
            params.extend(event_names)
        if target_entity_type is not UNFILTERED:
            if target_entity_type is None:
                where.append("targetEntityType IS NULL")
            else:
                where.append("targetEntityType = ?")
                params.append(target_entity_type)
        if target_entity_id is not UNFILTERED:
            if target_entity_id is None:
                where.append("targetEntityId IS NULL")
            else:
                where.append("targetEntityId = ?")
                params.append(target_entity_id)
        sql = f"SELECT {select_cols} FROM {name} WHERE {' AND '.join(where)}"
        if ordered:
            sql += f" ORDER BY eventTime {'DESC' if reversed_order else 'ASC'}"
        if limit is not None and limit >= 0:
            sql += " LIMIT ?"
            params.append(limit)
        return sql, params

    def _rows(self, sql, params, app_id, channel_id):
        try:
            return self.client.conn().execute(sql, params)
        except sqlite3.OperationalError as ex:
            raise StorageError(
                f"cannot read app {app_id} channel {channel_id}: {ex}") from ex

    def snapshot_digest(self, app_id: int,
                        channel_id: Optional[int] = None) -> str:
        """(min rowid, max rowid, count, max creationTime): appends grow
        the window, deletes shrink the count, and the creationTime term
        tells delete-then-insert pairs apart."""
        name = event_table_name(app_id, channel_id)
        row = self._rows(
            f"SELECT MIN(rowid), MAX(rowid), COUNT(*), "
            f"MAX(creationTime) FROM {name}", (), app_id,
            channel_id).fetchone()
        return f"rowid:{row[0]}:{row[1]}:{row[2]}:{row[3]}"

    def find(self, app_id: int, channel_id: Optional[int] = None,
             **filters) -> Iterator[Event]:
        sql, params = self._find_sql(_EVENT_COLS, app_id, channel_id,
                                     **filters)
        for row in self._rows(sql, params, app_id, channel_id):
            yield _row_to_event(row)

    def find_columns(self, app_id: int, channel_id: Optional[int] = None,
                     columns: Sequence[str] = (), ordered: bool = True,
                     **filters) -> Dict[str, np.ndarray]:
        """The named columns (``SQL_COLUMN_OF`` names) of the matching
        events as numpy arrays: object arrays for strings (None where
        NULL; an empty properties string reads as None, as in the
        reference's table), int64 for ``event_time_ms`` /
        ``creation_time_ms``. ``reversed_order``/``limit`` need the time
        sort, so they force it on."""
        names = list(columns) or list(SQL_COLUMN_OF)
        unknown = [n for n in names if n not in SQL_COLUMN_OF]
        if unknown:
            raise KeyError(f"unknown event columns {unknown}; known: "
                           f"{sorted(SQL_COLUMN_OF)}")
        if filters.get("reversed_order") or filters.get("limit") is not None:
            ordered = True
        sql, params = self._find_sql(
            ", ".join(SQL_COLUMN_OF[n] for n in names), app_id, channel_id,
            ordered=ordered, **filters)
        rows = self._rows(sql, params, app_id, channel_id).fetchall()
        out = {}
        for j, n in enumerate(names):
            if n.endswith("_ms"):
                out[n] = np.fromiter((r[j] for r in rows), np.int64,
                                     count=len(rows))
                continue
            col = np.empty(len(rows), dtype=object)
            col[:] = [r[j] for r in rows]
            if n == "properties":
                col[col == ""] = None
            out[n] = col
        return out


def _row_to_event(row) -> Event:
    (eid, event, etype, eidv, ttype, tid, props, etime, etz, tags, prid,
     ctime, ctz) = row
    return Event(
        event_id=eid,
        event=event,
        entity_type=etype,
        entity_id=eidv,
        target_entity_type=ttype,
        target_entity_id=tid,
        properties=DataMap(json.loads(props)) if props else DataMap(),
        event_time=_from_ms(etime, etz),
        tags=tuple(tags.split(",")) if tags else (),
        pr_id=prid,
        creation_time=_from_ms(ctime, ctz),
    )


# ---------------------------------------------------------------------------
# App metadata
# ---------------------------------------------------------------------------

class SqliteApps(base.Apps):
    def __init__(self, client: SqliteClient):
        self.client = client
        with client.write_lock():
            client.conn().execute("""CREATE TABLE IF NOT EXISTS pio_apps (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                name TEXT NOT NULL UNIQUE,
                description TEXT)""")
            client.conn().commit()

    def _exec(self, sql, params=()):
        with self.client.write_lock():
            cur = self.client.conn().execute(sql, params)
            self.client.conn().commit()
            return cur

    def _query(self, sql, params=()):
        return self.client.conn().execute(sql, params)

    def insert(self, app: App) -> Optional[int]:
        try:
            if app.id == 0:
                cur = self._exec(
                    "INSERT INTO pio_apps (name, description) VALUES (?,?)",
                    (app.name, app.description))
            else:
                cur = self._exec(
                    "INSERT INTO pio_apps (id, name, description) "
                    "VALUES (?,?,?)", (app.id, app.name, app.description))
        except sqlite3.IntegrityError:
            return None
        return cur.lastrowid if app.id == 0 else app.id

    def get(self, app_id: int) -> Optional[App]:
        row = self._query(
            "SELECT id, name, description FROM pio_apps WHERE id=?",
            (app_id,)).fetchone()
        return App(*row) if row else None

    def get_by_name(self, name: str) -> Optional[App]:
        row = self._query(
            "SELECT id, name, description FROM pio_apps WHERE name=?",
            (name,)).fetchone()
        return App(*row) if row else None

    def get_all(self) -> List[App]:
        return [App(*r) for r in self._query(
            "SELECT id, name, description FROM pio_apps ORDER BY id")]
