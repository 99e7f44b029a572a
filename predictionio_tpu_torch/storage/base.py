"""Storage interfaces the backends implement, and the metadata records
(port of the reference's ``storage/base.py``: apps, access keys,
channels, engine instances, model blobs, releases and events; the
evaluation instances come with the evaluation slice).

Instead of Scala's Option[Option[T]] target filters, the sentinel
``UNFILTERED`` distinguishes "no filter" from "must be absent" (None).
The training read is :meth:`EventStore.find_columns`, numpy columns in
place of the reference's pyarrow table (the machine with the card has no
pyarrow).
"""

from __future__ import annotations

import abc
import dataclasses
import datetime as _dt
import os
import random
import re
import secrets
import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import UTC, Event


class StorageError(Exception):
    """Backend-level storage failure (parity with StorageException)."""


class _Unfiltered:
    """Sentinel: this filter is not applied at all."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "UNFILTERED"


UNFILTERED = _Unfiltered()

#: urandom-seeded PRNG for ids: uniqueness (128 random bits), not
#: cryptographic strength; reseeded in a forked child so parent and
#: child never emit the same stream
_id_rng = random.Random()
if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_id_rng.seed)


def generate_id() -> str:
    """Random identifier for events (JDBCUtils.generateId parity)."""
    return f"{_id_rng.getrandbits(128):032x}"


@dataclasses.dataclass(frozen=True)
class App:
    """Apps.scala:32 — (id, name, description)."""
    id: int
    name: str
    description: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class AccessKey:
    """AccessKeys.scala:35 — (key, appid, allowed event names; () = all)."""
    key: str
    appid: int
    events: Sequence[str] = ()


CHANNEL_NAME_RE = re.compile(r"^[a-zA-Z0-9-]{1,16}$")
CHANNEL_NAME_CONSTRAINT = ("Only alphanumeric and - characters are allowed "
                           "and max length is 16.")


def is_valid_channel_name(name: str) -> bool:
    """Channels.scala:54-57 — 1-16 alphanumeric or '-' characters."""
    return bool(CHANNEL_NAME_RE.match(name))


@dataclasses.dataclass(frozen=True)
class Channel:
    """Channels.scala:32 — (id, name unique within app, appid)."""
    id: int
    name: str
    appid: int

    def __post_init__(self):
        if not is_valid_channel_name(self.name):
            raise ValueError(f"Invalid channel name: {self.name}. "
                             f"{CHANNEL_NAME_CONSTRAINT}")


def _utcnow() -> _dt.datetime:
    return _dt.datetime.now(tz=UTC)


@dataclasses.dataclass
class EngineInstance:
    """EngineInstances.scala:46 — one train run and its deployable
    model. ``runtime_conf`` holds the workflow's runtime settings (the
    reference's sparkConf)."""
    id: str = ""
    status: str = "INIT"  # INIT -> COMPLETED (failed runs stay INIT)
    start_time: _dt.datetime = dataclasses.field(default_factory=_utcnow)
    end_time: _dt.datetime = dataclasses.field(default_factory=_utcnow)
    engine_id: str = ""
    engine_version: str = ""
    engine_variant: str = ""
    engine_factory: str = ""
    batch: str = ""
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    runtime_conf: Dict[str, str] = dataclasses.field(default_factory=dict)
    data_source_params: str = ""
    preparator_params: str = ""
    algorithms_params: str = ""
    serving_params: str = ""


@dataclasses.dataclass(frozen=True)
class Model:
    """Models.scala:33 — serialized model blob keyed by engine instance
    id."""
    id: str
    models: bytes


#: the release lifecycle: REGISTERED by a train, CANARY while a traffic
#: split judges it, LIVE when serving, RETIRED when superseded,
#: ROLLED_BACK when rejected
RELEASE_STATUSES = ("REGISTERED", "CANARY", "LIVE", "RETIRED",
                    "ROLLED_BACK")


@dataclasses.dataclass
class Release:
    """One deployable version of an engine variant: a version that grows
    by one per (engine_id, engine_version, engine_variant), content
    digests of the params and of the model blob, and a status whose
    lineage is kept in ``history`` as ``[{"status", "timeMs",
    "reason"}, ...]``."""

    id: str = ""
    version: int = 0                 # assigned by insert(): max+1 per variant
    engine_id: str = ""
    engine_version: str = ""
    engine_variant: str = ""
    instance_id: str = ""            # the COMPLETED EngineInstance behind it
    params_digest: str = ""
    model_digest: str = ""
    model_size_bytes: int = 0
    status: str = "REGISTERED"
    created_time: _dt.datetime = dataclasses.field(default_factory=_utcnow)
    train_seconds: float = 0.0
    batch: str = ""
    history: List[Dict] = dataclasses.field(default_factory=list)


class Apps(abc.ABC):
    @abc.abstractmethod
    def insert(self, app: App) -> Optional[int]:
        """Insert; generates an id when app.id == 0. Returns the id."""

    @abc.abstractmethod
    def get(self, app_id: int) -> Optional[App]: ...

    @abc.abstractmethod
    def get_by_name(self, name: str) -> Optional[App]: ...

    @abc.abstractmethod
    def get_all(self) -> List[App]: ...

    @abc.abstractmethod
    def delete(self, app_id: int) -> None: ...


class AccessKeys(abc.ABC):
    @abc.abstractmethod
    def insert(self, k: AccessKey) -> Optional[str]:
        """Insert; generates a key when k.key is empty. Returns the key
        (None when it exists already)."""

    @abc.abstractmethod
    def get(self, key: str) -> Optional[AccessKey]: ...

    @abc.abstractmethod
    def get_all(self) -> List[AccessKey]: ...

    @abc.abstractmethod
    def get_by_appid(self, appid: int) -> List[AccessKey]: ...

    @staticmethod
    def generate_key() -> str:
        """Random URL-safe key (AccessKeys.scala:68 parity)."""
        return secrets.token_urlsafe(48)


class Channels(abc.ABC):
    @abc.abstractmethod
    def insert(self, channel: Channel) -> Optional[int]:
        """Insert; generates an id when channel.id == 0. Returns the id."""

    @abc.abstractmethod
    def get(self, channel_id: int) -> Optional[Channel]: ...

    @abc.abstractmethod
    def get_by_appid(self, appid: int) -> List[Channel]: ...


class EngineInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, i: EngineInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> List[EngineInstance]: ...

    @abc.abstractmethod
    def get_completed(self, engine_id: str, engine_version: str,
                      engine_variant: str) -> List[EngineInstance]:
        """COMPLETED instances, latest start_time first
        (EngineInstances.scala:88)."""

    def get_latest_completed(self, engine_id: str, engine_version: str,
                             engine_variant: str
                             ) -> Optional[EngineInstance]:
        """EngineInstances.scala:82."""
        completed = self.get_completed(engine_id, engine_version,
                                       engine_variant)
        return completed[0] if completed else None

    @abc.abstractmethod
    def update(self, i: EngineInstance) -> None: ...


class Models(abc.ABC):
    """Binary model blob store (Models.scala:33-86)."""

    @abc.abstractmethod
    def insert(self, model: Model) -> None: ...

    @abc.abstractmethod
    def get(self, model_id: str) -> Optional[Model]: ...

    @abc.abstractmethod
    def delete(self, model_id: str) -> None: ...


class Releases(abc.ABC):
    """Versioned release manifests."""

    @abc.abstractmethod
    def insert(self, release: Release) -> str:
        """Persist; assigns ``id`` (when empty) and the next ``version``
        of the release's (engine_id, engine_version, engine_variant).
        Returns the id."""

    @abc.abstractmethod
    def get(self, release_id: str) -> Optional[Release]: ...

    @abc.abstractmethod
    def get_all(self) -> List[Release]: ...

    @abc.abstractmethod
    def get_for_variant(self, engine_id: str, engine_version: str,
                        engine_variant: str) -> List[Release]:
        """All releases of one variant, newest version first."""

    @abc.abstractmethod
    def update(self, release: Release) -> None: ...

    def get_by_version(self, engine_id: str, engine_version: str,
                       engine_variant: str, version: int
                       ) -> Optional[Release]:
        for r in self.get_for_variant(engine_id, engine_version,
                                      engine_variant):
            if r.version == version:
                return r
        return None

    def latest(self, engine_id: str, engine_version: str,
               engine_variant: str,
               status: Optional[str] = None) -> Optional[Release]:
        """Newest release of the variant, optionally of one status."""
        for r in self.get_for_variant(engine_id, engine_version,
                                      engine_variant):
            if status is None or r.status == status:
                return r
        return None

    def set_status(self, release_id: str, status: str,
                   reason: str = "") -> Optional[Release]:
        """Move a release to ``status``, appending to its history.
        Returns the updated release (None when unknown). Re-asserting the
        current status is a no-op: no second history entry, no write."""
        if status not in RELEASE_STATUSES:
            raise ValueError(f"unknown release status {status!r}")
        release = self.get(release_id)
        if release is None:
            return None
        if release.status == status:
            return release
        release.status = status
        release.history = list(release.history) + [{
            "status": status, "timeMs": int(time.time() * 1000),
            "reason": reason}]
        self.update(release)
        return release


class EventStore(abc.ABC):
    """Event writes and reads per (app_id, channel_id) namespace."""

    @abc.abstractmethod
    def init_channel(self, app_id: int,
                     channel_id: Optional[int] = None) -> bool:
        """Initialize the namespace (LEvents.init:53)."""

    @abc.abstractmethod
    def remove_channel(self, app_id: int,
                       channel_id: Optional[int] = None) -> bool:
        """Remove the namespace and all its events (LEvents.remove:63)."""

    @abc.abstractmethod
    def close(self) -> None: ...

    @abc.abstractmethod
    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        """Insert events, returning their ids."""

    @abc.abstractmethod
    def insert_batch_idempotent(self, events: Sequence[Event], app_id: int,
                                channel_id: Optional[int] = None
                                ) -> List[str]:
        """Like insert_batch, but events whose (pre-assigned) id is
        already stored are skipped: the retry path of the group-commit
        flush (``data/write_buffer``), where an earlier attempt may have
        committed. Every event must carry an event_id."""

    @abc.abstractmethod
    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]: ...

    @abc.abstractmethod
    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool: ...

    @abc.abstractmethod
    def find(
        self,
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
    ) -> Iterator[Event]:
        """LEvents.futureFind:188 — time range [start, until), optional
        filters; limit None or -1 -> all; reversed_order = latest
        first."""

    @abc.abstractmethod
    def find_columns(self, app_id: int, channel_id: Optional[int] = None,
                     columns: Sequence[str] = (), ordered: bool = True,
                     **filters) -> Dict[str, np.ndarray]:
        """Training-path read: the named columns of the matching events
        as numpy arrays (object arrays for strings, int64 for the
        ``*_ms`` times), with ``find``'s filters. ``ordered=False``
        accepts any row order."""

    def aggregate_properties(
        self,
        app_id: int,
        entity_type: str,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> Dict[str, PropertyMap]:
        """LEvents.futureAggregateProperties:215: the entities' special
        events folded into PropertyMaps, through the columnar read and
        the vectorized fold (``data/columnar``)."""
        from predictionio_tpu_torch.data.aggregator import (
            AGGREGATOR_EVENT_NAMES,
        )
        from predictionio_tpu_torch.data.columnar import (
            AGGREGATE_COLUMNS, aggregate_properties_columns,
        )

        cols = self.find_columns(
            app_id, channel_id, columns=AGGREGATE_COLUMNS,
            ordered=False,      # the fold sorts per entity itself
            start_time=start_time, until_time=until_time,
            entity_type=entity_type,
            event_names=list(AGGREGATOR_EVENT_NAMES))
        return aggregate_properties_columns(cols, required=required)
