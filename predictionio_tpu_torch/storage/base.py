"""Storage interfaces the sqlite backend implements, and the ``App``
record (the subset of the reference's ``storage/base.py`` that training
reads through).

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
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data.event import Event


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


class EventStore(abc.ABC):
    """Event writes and reads per (app_id, channel_id) namespace."""

    @abc.abstractmethod
    def init_channel(self, app_id: int,
                     channel_id: Optional[int] = None) -> bool:
        """Initialize the namespace (LEvents.init:53)."""

    @abc.abstractmethod
    def close(self) -> None: ...

    @abc.abstractmethod
    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        """Insert events, returning their ids."""

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
