"""Event store, metadata and model blobs on sqlite3 (port of the
reference's ``storage/sqlite_backend.py``: ``SqliteClient``,
``SqliteEvents`` and the apps, access keys, channels, engine instances,
releases and models tables).

The tables are byte-for-byte the reference's (one event table per app
and channel, ``pio_event_<app>[_<channel>]``, ``pio_apps``,
``pio_accesskeys``, ``pio_channels``, ``pio_engineinstances``,
``pio_releases``, ``pio_models``), so a store written by either package
is read by the other. All SQL uses bound
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
    AccessKey, App, Channel, EngineInstance, Model, Release, StorageError,
    UNFILTERED, generate_id,
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


def _equal_or_in(column: str, value, params: list) -> str:
    """``column = ?`` for one id, ``column IN (?, ...)`` for a list."""
    if isinstance(value, str):
        params.append(value)
        return f"{column} = ?"
    values = list(value)
    if not values:
        return "0"
    params.extend(values)
    return f"{column} IN ({','.join('?' * len(values))})"


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

    def remove_channel(self, app_id: int,
                       channel_id: Optional[int] = None) -> bool:
        name = event_table_name(app_id, channel_id)
        with self.client.write_lock():
            self.client.conn().execute(f"DROP TABLE IF EXISTS {name}")
            self.client.conn().commit()
        return True

    def close(self) -> None:
        self.client.close()

    def _insert(self, verb: str, events: Sequence[Event], app_id: int,
                channel_id: Optional[int]) -> List[str]:
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
                    f"{verb} INTO {name} VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)",
                    rows)
                self.client.conn().commit()
        except sqlite3.OperationalError as ex:
            raise StorageError(
                f"cannot insert into app {app_id} channel {channel_id}: {ex}. "
                "Was the app initialized (pio app new)?") from ex
        return ids

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        return self._insert("INSERT", events, app_id, channel_id)

    def insert_batch_idempotent(self, events: Sequence[Event], app_id: int,
                                channel_id: Optional[int] = None
                                ) -> List[str]:
        """Retry-path insert: INSERT OR IGNORE on the id primary key, so a
        replayed flush skips rows an earlier attempt committed."""
        if any(not e.event_id for e in events):
            raise StorageError(
                "insert_batch_idempotent requires pre-assigned event ids")
        return self._insert("INSERT OR IGNORE", events, app_id, channel_id)

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        row = self._rows(
            f"SELECT {_EVENT_COLS} FROM {event_table_name(app_id, channel_id)}"
            " WHERE id = ?", (event_id,), app_id, channel_id).fetchone()
        return _row_to_event(row) if row else None

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        name = event_table_name(app_id, channel_id)
        try:
            with self.client.write_lock():
                cur = self.client.conn().execute(
                    f"DELETE FROM {name} WHERE id = ?", (event_id,))
                self.client.conn().commit()
        except sqlite3.OperationalError as ex:
            raise StorageError(
                f"cannot delete from app {app_id} channel {channel_id}: "
                f"{ex}") from ex
        return cur.rowcount > 0

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
        ``entity_id`` and ``target_entity_id`` also take a list of ids
        (any of them matches: one scan for a fold-in tick's entities).
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
            where.append(_equal_or_in("entityId", entity_id, params))
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
                where.append(_equal_or_in("targetEntityId",
                                          target_entity_id, params))
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
# Metadata and model blobs
# ---------------------------------------------------------------------------

class _MetaBase:
    def __init__(self, client: SqliteClient):
        self.client = client
        with client.write_lock():
            self._ddl(client.conn())
            client.conn().commit()

    def _ddl(self, conn):
        raise NotImplementedError

    def _exec(self, sql, params=()):
        with self.client.write_lock():
            cur = self.client.conn().execute(sql, params)
            self.client.conn().commit()
            return cur

    def _query(self, sql, params=()):
        return self.client.conn().execute(sql, params)


class SqliteApps(_MetaBase, base.Apps):
    def _ddl(self, conn):
        conn.execute("""CREATE TABLE IF NOT EXISTS pio_apps (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            name TEXT NOT NULL UNIQUE,
            description TEXT)""")

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

    def delete(self, app_id: int) -> None:
        self._exec("DELETE FROM pio_apps WHERE id=?", (app_id,))


class SqliteAccessKeys(_MetaBase, base.AccessKeys):
    def _ddl(self, conn):
        conn.execute("""CREATE TABLE IF NOT EXISTS pio_accesskeys (
            accesskey TEXT PRIMARY KEY,
            appid INTEGER NOT NULL,
            events TEXT)""")

    def insert(self, k: AccessKey) -> Optional[str]:
        key = k.key or self.generate_key()
        try:
            self._exec("INSERT INTO pio_accesskeys VALUES (?,?,?)",
                       (key, k.appid, ",".join(k.events)))
        except sqlite3.IntegrityError:
            return None
        return key

    def get(self, key: str) -> Optional[AccessKey]:
        row = self._query(
            "SELECT accesskey, appid, events FROM pio_accesskeys "
            "WHERE accesskey=?", (key,)).fetchone()
        return _row_to_accesskey(row) if row else None

    def get_all(self) -> List[AccessKey]:
        return [_row_to_accesskey(r) for r in self._query(
            "SELECT accesskey, appid, events FROM pio_accesskeys")]

    def get_by_appid(self, appid: int) -> List[AccessKey]:
        return [_row_to_accesskey(r) for r in self._query(
            "SELECT accesskey, appid, events FROM pio_accesskeys "
            "WHERE appid=?", (appid,))]


def _row_to_accesskey(row) -> AccessKey:
    key, appid, events = row
    return AccessKey(key=key, appid=appid,
                     events=tuple(e for e in (events or "").split(",") if e))


class SqliteChannels(_MetaBase, base.Channels):
    def _ddl(self, conn):
        conn.execute("""CREATE TABLE IF NOT EXISTS pio_channels (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            name TEXT NOT NULL,
            appid INTEGER NOT NULL,
            UNIQUE (name, appid))""")

    def insert(self, channel: Channel) -> Optional[int]:
        try:
            if channel.id == 0:
                return self._exec(
                    "INSERT INTO pio_channels (name, appid) VALUES (?,?)",
                    (channel.name, channel.appid)).lastrowid
            self._exec(
                "INSERT INTO pio_channels (id, name, appid) VALUES (?,?,?)",
                (channel.id, channel.name, channel.appid))
            return channel.id
        except sqlite3.IntegrityError:
            return None

    def get(self, channel_id: int) -> Optional[Channel]:
        row = self._query(
            "SELECT id, name, appid FROM pio_channels WHERE id=?",
            (channel_id,)).fetchone()
        return Channel(*row) if row else None

    def get_by_appid(self, appid: int) -> List[Channel]:
        return [Channel(*r) for r in self._query(
            "SELECT id, name, appid FROM pio_channels WHERE appid=? "
            "ORDER BY id", (appid,))]


_EI_COLS = ("id, status, startTime, endTime, engineId, engineVersion, "
            "engineVariant, engineFactory, batch, env, runtimeConf, "
            "dataSourceParams, preparatorParams, algorithmsParams, "
            "servingParams")


class SqliteEngineInstances(_MetaBase, base.EngineInstances):
    def _ddl(self, conn):
        conn.execute("""CREATE TABLE IF NOT EXISTS pio_engineinstances (
            id TEXT PRIMARY KEY, status TEXT, startTime INTEGER, endTime INTEGER,
            engineId TEXT, engineVersion TEXT, engineVariant TEXT,
            engineFactory TEXT, batch TEXT, env TEXT, runtimeConf TEXT,
            dataSourceParams TEXT, preparatorParams TEXT,
            algorithmsParams TEXT, servingParams TEXT)""")

    def insert(self, i: EngineInstance) -> str:
        i.id = i.id or generate_id()
        self._exec(
            f"INSERT INTO pio_engineinstances ({_EI_COLS}) "
            "VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
            (i.id, i.status, _to_ms(i.start_time), _to_ms(i.end_time),
             i.engine_id, i.engine_version, i.engine_variant,
             i.engine_factory, i.batch, json.dumps(i.env),
             json.dumps(i.runtime_conf), i.data_source_params,
             i.preparator_params, i.algorithms_params, i.serving_params))
        return i.id

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        row = self._query(
            f"SELECT {_EI_COLS} FROM pio_engineinstances WHERE id=?",
            (instance_id,)).fetchone()
        return _row_to_ei(row) if row else None

    def get_all(self) -> List[EngineInstance]:
        return [_row_to_ei(r) for r in self._query(
            f"SELECT {_EI_COLS} FROM pio_engineinstances")]

    def get_completed(self, engine_id, engine_version, engine_variant):
        return [_row_to_ei(r) for r in self._query(
            f"SELECT {_EI_COLS} FROM pio_engineinstances "
            "WHERE status='COMPLETED' AND engineId=? AND engineVersion=? "
            "AND engineVariant=? ORDER BY startTime DESC",
            (engine_id, engine_version, engine_variant))]

    def update(self, i: EngineInstance) -> None:
        self._exec(
            "UPDATE pio_engineinstances SET status=?, startTime=?, "
            "endTime=?, engineId=?, engineVersion=?, engineVariant=?, "
            "engineFactory=?, batch=?, env=?, runtimeConf=?, "
            "dataSourceParams=?, preparatorParams=?, algorithmsParams=?, "
            "servingParams=? WHERE id=?",
            (i.status, _to_ms(i.start_time), _to_ms(i.end_time),
             i.engine_id, i.engine_version, i.engine_variant,
             i.engine_factory, i.batch, json.dumps(i.env),
             json.dumps(i.runtime_conf), i.data_source_params,
             i.preparator_params, i.algorithms_params, i.serving_params,
             i.id))


def _row_to_ei(row) -> EngineInstance:
    return EngineInstance(
        id=row[0], status=row[1], start_time=_from_ms(row[2]),
        end_time=_from_ms(row[3]), engine_id=row[4], engine_version=row[5],
        engine_variant=row[6], engine_factory=row[7], batch=row[8],
        env=json.loads(row[9] or "{}"),
        runtime_conf=json.loads(row[10] or "{}"),
        data_source_params=row[11], preparator_params=row[12],
        algorithms_params=row[13], serving_params=row[14])


_REL_COLS = ("id, version, engineId, engineVersion, engineVariant, "
             "instanceId, paramsDigest, modelDigest, modelSizeBytes, "
             "status, createdTime, trainSeconds, batch, history")


class SqliteReleases(_MetaBase, base.Releases):
    def _ddl(self, conn):
        conn.execute("""CREATE TABLE IF NOT EXISTS pio_releases (
            id TEXT PRIMARY KEY, version INTEGER NOT NULL,
            engineId TEXT, engineVersion TEXT, engineVariant TEXT,
            instanceId TEXT, paramsDigest TEXT, modelDigest TEXT,
            modelSizeBytes INTEGER, status TEXT, createdTime INTEGER,
            trainSeconds REAL, batch TEXT, history TEXT)""")
        # two trains of one variant never share a version, also across
        # processes on one sqlite file (the write lock is per process)
        conn.execute(
            "CREATE UNIQUE INDEX IF NOT EXISTS pio_releases_variant_version "
            "ON pio_releases (engineId, engineVersion, engineVariant, "
            "version)")

    def insert(self, r: Release) -> str:
        r.id = r.id or generate_id()
        for _attempt in range(8):
            with self.client.write_lock():
                conn = self.client.conn()
                row = conn.execute(
                    "SELECT COALESCE(MAX(version), 0) FROM pio_releases "
                    "WHERE engineId=? AND engineVersion=? AND "
                    "engineVariant=?",
                    (r.engine_id, r.engine_version,
                     r.engine_variant)).fetchone()
                r.version = int(row[0]) + 1
                try:
                    conn.execute(
                        f"INSERT INTO pio_releases ({_REL_COLS}) "
                        "VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                        (r.id, r.version, r.engine_id, r.engine_version,
                         r.engine_variant, r.instance_id, r.params_digest,
                         r.model_digest, r.model_size_bytes, r.status,
                         _to_ms(r.created_time), r.train_seconds, r.batch,
                         json.dumps(r.history)))
                    conn.commit()
                    return r.id
                except sqlite3.IntegrityError:
                    # another process claimed this version between the
                    # MAX read and the insert: read again
                    conn.rollback()
        raise StorageError(
            f"could not claim a release version for {r.engine_id}/"
            f"{r.engine_variant} after 8 attempts")

    def get(self, release_id: str) -> Optional[Release]:
        row = self._query(
            f"SELECT {_REL_COLS} FROM pio_releases WHERE id=?",
            (release_id,)).fetchone()
        return _row_to_release(row) if row else None

    def get_all(self) -> List[Release]:
        return [_row_to_release(r) for r in self._query(
            f"SELECT {_REL_COLS} FROM pio_releases "
            "ORDER BY engineId, engineVariant, version DESC")]

    def get_for_variant(self, engine_id, engine_version, engine_variant):
        return [_row_to_release(r) for r in self._query(
            f"SELECT {_REL_COLS} FROM pio_releases WHERE engineId=? AND "
            "engineVersion=? AND engineVariant=? ORDER BY version DESC",
            (engine_id, engine_version, engine_variant))]

    def update(self, r: Release) -> None:
        self._exec(
            "UPDATE pio_releases SET version=?, engineId=?, "
            "engineVersion=?, engineVariant=?, instanceId=?, "
            "paramsDigest=?, modelDigest=?, modelSizeBytes=?, status=?, "
            "createdTime=?, trainSeconds=?, batch=?, history=? WHERE id=?",
            (r.version, r.engine_id, r.engine_version, r.engine_variant,
             r.instance_id, r.params_digest, r.model_digest,
             r.model_size_bytes, r.status, _to_ms(r.created_time),
             r.train_seconds, r.batch, json.dumps(r.history), r.id))


def _row_to_release(row) -> Release:
    return Release(
        id=row[0], version=row[1], engine_id=row[2], engine_version=row[3],
        engine_variant=row[4], instance_id=row[5], params_digest=row[6],
        model_digest=row[7], model_size_bytes=row[8], status=row[9],
        created_time=_from_ms(row[10]), train_seconds=row[11],
        batch=row[12], history=json.loads(row[13] or "[]"))


class SqliteModels(_MetaBase, base.Models):
    """Model blobs in sqlite (JDBCModels.scala:28-55 parity)."""

    def _ddl(self, conn):
        conn.execute("""CREATE TABLE IF NOT EXISTS pio_models (
            id TEXT PRIMARY KEY, models BLOB NOT NULL)""")

    def insert(self, model: Model) -> None:
        self._exec("INSERT OR REPLACE INTO pio_models VALUES (?,?)",
                   (model.id, model.models))

    def get(self, model_id: str) -> Optional[Model]:
        row = self._query("SELECT id, models FROM pio_models WHERE id=?",
                          (model_id,)).fetchone()
        return Model(id=row[0], models=bytes(row[1])) if row else None

    def delete(self, model_id: str) -> None:
        self._exec("DELETE FROM pio_models WHERE id=?", (model_id,))
