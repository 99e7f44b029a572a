"""Partitioned event store: P independent stores behind one EventStore
(port of the reference's ``storage/partitioned.py``).

Events hash by ``(app, channel, entity)`` into one of ``P`` partitions
(:func:`partition_of`, a stable crc32, never Python's salted ``hash``),
each partition a full sqlite store with its own file, writer lock, WAL
and compaction. That gives ingest P independent commit streams (the
write buffer runs one group-commit lane per partition,
``data/write_buffer``) and gives training reads P independently
scannable slices, scanned at once.

The layout is governed by a small partition-map control file committed
through ``storage/logstore``: ``{"count": P, "gen": G}``. Partition data
lives under generation-qualified names (``...-g<G>-p<k>``); data whose
generation differs from the committed map is garbage by definition and
is collected on open. That makes :meth:`PartitionedEvents.reshard`
crash-safe:

1. **stage**: copy every event into the new generation's partitions
   (idempotent inserts, original event ids) while the old map is still
   committed; a crash leaves invisible staging garbage (kill point
   ``reshard:staged``).
2. **commit**: atomically replace the partition map; this one rename is
   the cutover (kill point ``reshard:committed``).
3. **gc**: destroy the other generations; a crash in between leaves
   only invisible old-generation data that the next open collects (kill
   point ``reshard:old-removed``).

Readers only ever open the committed generation, so at every kill point
they see exactly one complete copy of every event. Like ``compact()``,
resharding is a single-operator maintenance step: run it with no
concurrent writers.

The file names and the map file are the reference's, so a store either
package partitions opens in the other with the same rows in each
partition. Differences from the reference:

* the training read is :meth:`PartitionedEvents.find_columns` (numpy
  columns, where the reference builds a pyarrow table): each
  partition's columns concatenated in partition order, then, when the
  time order is asked for, a stable sort on ``event_time_ms`` (Arrow's
  ``sort_by`` is stable too), so ties keep partition order and the rows
  come out in the reference's order;
* ``entity_id`` may be a list of ids (the fold-in history read): the
  ids are grouped by :func:`partition_of` and each partition is asked
  only for its own. ``target_entity_id`` is not hashed, so it fans out
  to every partition;
* sqlite sub-stores only: :class:`ParquetPartitions` waits with the
  parquet store (ROADMAP Queue 1 item 8). A sharded read
  (``shard=(index, count[, snapshot])``, multi-process training) maps
  the reader shards onto the partitions (:func:`shard_partitions`)
  under the composite snapshot of :meth:`PartitionedEvents.read_snapshot`.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import os
import re
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.storage import base, logstore
from predictionio_tpu_torch.storage.base import StorageError
from predictionio_tpu_torch.storage.faults import maybe_kill

log = logging.getLogger("pio.torch.storage")

#: events copied per idempotent insert during a reshard stage
RESHARD_BATCH = 2048

#: partition-map control file name (committed through storage/logstore)
MAP_NAME = "_pio_partitions.json"

_PART_RE = re.compile(r"-g(\d+)-p(\d+)$")


def partition_of(app_id: int, channel_id: Optional[int],
                 entity_id: Optional[str], count: int) -> int:
    """The one routing function: ``(app, channel, entity) -> partition``,
    the crc32 of ``f"{app}:{channel or 0}:{entity or ''}"`` modulo
    ``count``: stable across processes, restarts and Python versions.
    Events without an entity id hash with an empty key."""
    key = f"{app_id}:{channel_id or 0}:{entity_id or ''}"
    return zlib.crc32(key.encode()) % count


def shard_partitions(shard_idx: int, shard_count: int, partitions: int
                     ) -> List[Tuple[int, Optional[Tuple[int, int]]]]:
    """Which ``(partition, sub_shard)`` pieces reader shard ``shard_idx``
    of ``shard_count`` scans over ``partitions`` partitions.

    * ``shard_count <= partitions``: shard i reads every partition p
      with ``p % shard_count == i`` in full (``sub_shard=None``);
    * ``shard_count > partitions``: shard i reads only partition
      ``i % partitions``, sub-sharded among the ``k_p`` shards mapped to
      it.

    The pieces are disjoint and complete over all shards."""
    if not (0 <= shard_idx < shard_count):
        raise StorageError(f"bad shard ({shard_idx}, {shard_count})")
    if shard_count <= partitions:
        return [(p, None) for p in range(partitions)
                if p % shard_count == shard_idx]
    p = shard_idx % partitions
    k_p = len(range(p, shard_count, partitions))
    return [(p, (shard_idx // partitions, k_p))]


# ---------------------------------------------------------------------------
# partition layouts (how one backend materializes generation/partition k)
# ---------------------------------------------------------------------------

class SqlitePartitions:
    """Sqlite layout: one DB file per (generation, partition) beside the
    configured path (``pio-g<G>-p<k>.db`` for ``pio.db``), so each
    partition has its own writer lock and WAL: sqlite serializes writers
    per file. ``:memory:`` keeps an in-process table of clients."""

    def __init__(self, path: str):
        self.path = path
        self.memory = path == ":memory:"
        if self.memory:
            self._mem_clients: Dict[Tuple[int, int], object] = {}
            self._mem_map: Optional[dict] = None
        else:
            self._dir = os.path.dirname(os.path.abspath(path))
            self._stem, self._ext = os.path.splitext(os.path.basename(path))
            os.makedirs(self._dir, exist_ok=True)

    def _part_path(self, gen: int, k: int) -> str:
        return os.path.join(self._dir,
                            f"{self._stem}-g{gen}-p{k}{self._ext}")

    def open(self, gen: int, k: int) -> base.EventStore:
        from predictionio_tpu_torch.storage.sqlite_backend import (
            SqliteClient, SqliteEvents,
        )

        if self.memory:
            client = self._mem_clients.get((gen, k))
            if client is None:
                client = self._mem_clients[(gen, k)] = SqliteClient(
                    ":memory:")
            return SqliteEvents(client)
        return SqliteEvents(SqliteClient(self._part_path(gen, k)))

    def destroy(self, gen: int, k: int) -> None:
        if self.memory:
            client = self._mem_clients.pop((gen, k), None)
            if client is not None:
                client.close()
            return
        for suffix in ("", "-wal", "-shm"):
            try:
                os.unlink(self._part_path(gen, k) + suffix)
            except OSError:
                pass

    def parts(self) -> List[Tuple[int, int]]:
        if self.memory:
            return sorted(self._mem_clients)
        found = []
        for name in os.listdir(self._dir):
            s, ext = os.path.splitext(name)
            m = _PART_RE.search(s)
            if m and ext == self._ext and s[:m.start()] == self._stem:
                found.append((int(m.group(1)), int(m.group(2))))
        return sorted(found)

    def map_read(self) -> Optional[dict]:
        if self.memory:
            return self._mem_map
        return logstore.read_json(
            os.path.join(self._dir, f"{self._stem}.{MAP_NAME}"))

    def map_commit(self, doc: dict) -> None:
        if self.memory:
            self._mem_map = dict(doc)
            return
        logstore.commit_json(self._dir, f"{self._stem}.{MAP_NAME}", doc)

    def close(self) -> None:
        if self.memory:
            for client in self._mem_clients.values():
                client.close()


class ParquetPartitions:
    """The reference's parquet layout (one fragment root per generation
    and partition). The parquet event store needs pyarrow, which the
    card's machine lacks."""

    def __init__(self, client=None):
        raise NotImplementedError(
            "a parquet partition layout is not ported to PyTorch: the "
            "parquet event store waits for pyarrow (ROADMAP Queue 1 item "
            "8; see predictionio_tpu/storage/partitioned.py)")


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

class PartitionedEvents(base.EventStore):
    """P sqlite stores behind one EventStore, routed by entity hash.

    Construction reads (or initializes) the committed partition map and
    collects any generation that is not the committed one: the
    roll-forward half of the reshard discipline (module docstring)."""

    def __init__(self, layout, initial_count: int = 1):
        if initial_count < 1:
            raise StorageError(f"bad partition count {initial_count}")
        self.layout = layout
        doc = layout.map_read()
        if doc is None:
            doc = {"count": int(initial_count), "gen": 0}
            layout.map_commit(doc)
        self._count = int(doc["count"])
        self._gen = int(doc["gen"])
        self._recover()
        self._stores = [layout.open(self._gen, k)
                        for k in range(self._count)]

    def _recover(self) -> None:
        """Collect partition data whose generation is not the committed
        one: staging from a reshard that died before its commit, or old
        generations from one that died after it."""
        for gen, k in self.layout.parts():
            if gen != self._gen or k >= self._count:
                self.layout.destroy(gen, k)

    # -- introspection ------------------------------------------------------
    @property
    def partition_count(self) -> int:
        return self._count

    @property
    def generation(self) -> int:
        return self._gen

    def partition_store(self, k: int) -> base.EventStore:
        return self._stores[k]

    def _entity_pieces(self, app_id: int, channel_id: Optional[int],
                       entity_id) -> List[Tuple[int, object]]:
        """``(partition, entity filter)`` pairs for an ``entity_id``
        filter: one id routes to its partition, a list of ids to each
        partition that owns any of them (asked for those only)."""
        if isinstance(entity_id, str):
            return [(partition_of(app_id, channel_id, entity_id,
                                  self._count), entity_id)]
        groups: Dict[int, List[str]] = {}
        for e in entity_id:
            groups.setdefault(
                partition_of(app_id, channel_id, e, self._count),
                []).append(e)
        return sorted(groups.items())

    # -- namespace lifecycle ------------------------------------------------
    def init_channel(self, app_id: int,
                     channel_id: Optional[int] = None) -> bool:
        return all([s.init_channel(app_id, channel_id)
                    for s in self._stores])

    def remove_channel(self, app_id: int,
                       channel_id: Optional[int] = None) -> bool:
        return all([s.remove_channel(app_id, channel_id)
                    for s in self._stores])

    def close(self) -> None:
        for s in self._stores:
            s.close()
        self.layout.close()

    # -- writes -------------------------------------------------------------
    def _insert_grouped(self, method: str, events: Sequence[Event],
                        app_id: int, channel_id: Optional[int]
                        ) -> List[str]:
        groups: Dict[int, Tuple[List[int], List[Event]]] = {}
        for i, e in enumerate(events):
            p = partition_of(app_id, channel_id, e.entity_id, self._count)
            idxs, evs = groups.setdefault(p, ([], []))
            idxs.append(i)
            evs.append(e)
        ids: List[Optional[str]] = [None] * len(events)
        for p, (idxs, evs) in groups.items():
            for i, eid in zip(idxs, getattr(self._stores[p], method)(
                    evs, app_id, channel_id)):
                ids[i] = eid
        return ids  # type: ignore[return-value]

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        return self._insert_grouped("insert_batch", events, app_id,
                                    channel_id)

    def insert_batch_idempotent(self, events: Sequence[Event], app_id: int,
                                channel_id: Optional[int] = None
                                ) -> List[str]:
        return self._insert_grouped("insert_batch_idempotent", events,
                                    app_id, channel_id)

    # -- point reads / deletes ----------------------------------------------
    # an id carries no entity, so these probe every partition; an id
    # lives in at most one, so the first hit wins
    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        for s in self._stores:
            e = s.get(event_id, app_id, channel_id)
            if e is not None:
                return e
        return None

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        for s in self._stores:
            if s.delete(event_id, app_id, channel_id):
                return True
        return False

    # -- maintenance --------------------------------------------------------
    def compact(self, app_id: int, channel_id: Optional[int] = None,
                ttl_days: Optional[float] = None) -> Dict[str, int]:
        total: Dict[str, int] = {}
        for s in self._stores:
            for key, n in s.compact(app_id, channel_id,
                                    ttl_days=ttl_days).items():
                total[key] = total.get(key, 0) + n
        return total

    # -- queries ------------------------------------------------------------
    def find(self, app_id: int, channel_id: Optional[int] = None,
             **filters) -> Iterator[Event]:
        entity_id = filters.get("entity_id")
        reversed_order = bool(filters.get("reversed_order", False))
        limit = filters.pop("limit", None)
        if entity_id is not None:
            pieces = self._entity_pieces(app_id, channel_id, entity_id)
            streams = [self._stores[p].find(
                app_id, channel_id, **dict(filters, entity_id=ents),
                limit=limit) for p, ents in pieces]
        else:
            streams = [s.find(app_id, channel_id, **filters)
                       for s in self._stores]
        if len(streams) == 1:
            merged = streams[0]
        else:
            # each partition's stream is time-ordered; a lazy k-way merge
            # keeps the global order without materializing
            merged = heapq.merge(*streams, key=lambda e: e.event_time,
                                 reverse=reversed_order)
        if limit is not None and limit >= 0:
            merged = itertools.islice(merged, limit)
        yield from merged

    def find_columns(self, app_id: int, channel_id: Optional[int] = None,
                     columns: Sequence[str] = (), ordered: bool = True,
                     **filters) -> Dict[str, np.ndarray]:
        """The partitions' numpy columns (``SqliteEvents.find_columns``
        filters and ``columns``), scanned at once and concatenated in
        partition order; with the time order asked for (``ordered``,
        ``reversed_order`` or ``limit``), a stable sort on
        ``event_time_ms`` after the concatenation."""
        shard = filters.pop("shard", None)
        limit = filters.get("limit")
        reversed_order = bool(filters.get("reversed_order", False))
        entity_id = filters.pop("entity_id", None)
        if shard is not None:
            # a reader shard's partitions; an entity filter applies in
            # each of them as it stands
            ents = {} if entity_id is None else {"entity_id": entity_id}
            pieces = [(p, dict(ents, shard=inner))
                      for p, inner in self._shard_pieces(shard)]
        elif entity_id is not None:
            pieces = [(p, {"entity_id": ents}) for p, ents in
                      self._entity_pieces(app_id, channel_id, entity_id)]
        else:
            pieces = [(p, {}) for p in range(self._count)]
        want_limit = limit is not None and limit >= 0
        sort_needed = ordered or reversed_order or want_limit
        names = list(columns)
        inner = names
        if sort_needed and names and "event_time_ms" not in names:
            # the merge sorts on event_time_ms: fetch it, drop it after
            inner = names + ["event_time_ms"]

        def scan_one(piece):
            p, extra = piece
            return self._stores[p].find_columns(
                app_id, channel_id, columns=inner,
                ordered=False if sort_needed else ordered,
                **filters, **extra)

        if len(pieces) == 1:
            parts = [scan_one(pieces[0])]
        else:
            # each partition is its own sqlite file: the reads overlap
            with ThreadPoolExecutor(max_workers=len(pieces)) as pool:
                parts = list(pool.map(scan_one, pieces))
        if not parts:
            return self._stores[0].find_columns(
                app_id, channel_id, columns=names, ordered=False,
                **filters, entity_id=[])
        keys = list(parts[0])
        out = {k: np.concatenate([c[k] for c in parts]) for k in keys}
        n = len(out[keys[0]]) if keys else 0
        if sort_needed and n:
            t = out["event_time_ms"]
            order = np.argsort(-t if reversed_order else t, kind="stable")
            out = {k: v[order] for k, v in out.items()}
        if want_limit:
            out = {k: v[:limit] for k, v in out.items()}
        if inner is not names:
            out.pop("event_time_ms")
        return out

    def _shard_pieces(self, shard) -> List[Tuple[int, Optional[tuple]]]:
        """The shard protocol resolved onto ``(partition, inner_shard)``
        scan pieces, checking a held composite snapshot against the
        current partition count."""
        snap = shard[2] if len(shard) > 2 else None
        if snap is not None:
            if not (isinstance(snap, (list, tuple)) and len(snap) == 3
                    and snap[0] == "pmap"):
                raise StorageError(
                    "shard snapshot was not captured from this "
                    "partitioned store; capture read_snapshot() here")
            if int(snap[1]) != self._count:
                raise StorageError(
                    f"partition count changed under a held snapshot "
                    f"({snap[1]} -> {self._count}, a reshard ran); "
                    "capture a fresh read_snapshot() and retry")
        pieces = []
        for p, sub in shard_partitions(shard[0], shard[1], self._count):
            psnap = snap[2][p] if snap is not None else None
            if sub is not None:
                inner = (sub[0], sub[1], psnap) if psnap is not None else sub
            else:
                # a whole partition under a held snapshot reads as the
                # one-shard read of that snapshot
                inner = (0, 1, psnap) if psnap is not None else None
            pieces.append((p, inner))
        return pieces

    # -- snapshots -----------------------------------------------------------
    def read_snapshot(self, app_id: int,
                      channel_id: Optional[int] = None):
        """Composite snapshot: each partition's rowid window, tagged with
        the partition count it was captured under. A reshard between
        capture and read changes the count, and the sharded read then
        refuses (capture again and retry) instead of skewing."""
        return ("pmap", self._count,
                tuple(s.read_snapshot(app_id, channel_id)
                      for s in self._stores))

    def snapshot_digest(self, app_id: int,
                        channel_id: Optional[int] = None) -> Optional[str]:
        """The partitions' digests joined under the partition count: a
        write to any partition or a reshard changes it (the scan cache's
        key)."""
        digests = [s.snapshot_digest(app_id, channel_id)
                   for s in self._stores]
        if any(d is None for d in digests):
            return None
        return f"pmap:{self._count}:" + "|".join(digests)

    # -- resharding ----------------------------------------------------------
    def reshard(self, new_count: int,
                apps: Iterable[Tuple[int, Optional[int]]]) -> Dict[str, int]:
        """Change the partition count, exactly-once at every kill point.

        ``apps`` are the (app_id, channel_id) namespaces to carry over
        (the CLI lists them from the metadata). Stages a full copy into
        generation G+1 (idempotent inserts, original event ids: a retried
        run converges instead of duplicating), commits the partition map
        (the cutover), then collects the old generation; ``_recover``
        rolls either crash half forward."""
        if new_count < 1:
            raise StorageError(f"bad partition count {new_count}")
        old_count, old_gen = self._count, self._gen
        if new_count == old_count:
            return {"copied": 0, "count": old_count, "gen": old_gen}
        new_gen = old_gen + 1
        # an earlier attempt may have died mid-stage: its staging is
        # garbage of our new generation, so the copy restarts from scratch
        for gen, k in self.layout.parts():
            if gen == new_gen:
                self.layout.destroy(gen, k)
        new_stores = [self.layout.open(new_gen, k)
                      for k in range(new_count)]
        copied = 0
        for app_id, channel_id in apps:
            for s in new_stores:
                s.init_channel(app_id, channel_id)
            for old in self._stores:
                pending: Dict[int, List[Event]] = {}
                for e in old.find(app_id, channel_id):
                    p = partition_of(app_id, channel_id, e.entity_id,
                                     new_count)
                    batch = pending.setdefault(p, [])
                    batch.append(e)
                    if len(batch) >= RESHARD_BATCH:
                        new_stores[p].insert_batch_idempotent(
                            pending.pop(p), app_id, channel_id)
                        copied += len(batch)
                for p, batch in pending.items():
                    new_stores[p].insert_batch_idempotent(
                        batch, app_id, channel_id)
                    copied += len(batch)
        maybe_kill("reshard:staged")
        self.layout.map_commit({"count": new_count, "gen": new_gen})
        maybe_kill("reshard:committed")
        # swap the live view before the collection, so a crash in it
        # still leaves this object serving the committed generation
        old_stores, self._stores = self._stores, new_stores
        self._count, self._gen = new_count, new_gen
        for s in old_stores:
            s.close()
        for gen, k in self.layout.parts():
            if gen != new_gen:
                self.layout.destroy(gen, k)
        maybe_kill("reshard:old-removed")
        return {"copied": copied, "count": new_count, "gen": new_gen,
                "old_count": old_count}


def maybe_partitioned(store, layout_factory, requested: int):
    """Wrap ``store`` in a :class:`PartitionedEvents` when partitioning
    is requested (``PIO_INGEST_PARTITIONS`` > 1) or a committed partition
    map already exists: the map is authoritative, so a store partitioned
    once keeps reading its partitions with the knob unset (a count
    change takes ``pio reshard``). Returns ``store`` unchanged when
    unpartitioned."""
    layout = layout_factory()
    existing = layout.map_read()
    if requested <= 1 and existing is None:
        layout.close()
        return store
    if existing is not None and requested > 1 \
            and int(existing["count"]) != requested:
        log.warning(
            "PIO_INGEST_PARTITIONS=%d but the committed partition map "
            "says %d; the map wins — run `pio reshard --partitions %d` "
            "to change it", requested, int(existing["count"]), requested)
    return PartitionedEvents(layout, initial_count=max(requested, 1))
