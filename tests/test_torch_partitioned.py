"""The partitioned event store and the commit lanes of the port
(``predictionio_tpu_torch/storage/partitioned.py``, ``storage/audit.py``,
``data/write_buffer.py``), held against the JAX package on the CPU, on
stores in ``tmp_path``, with seeds from numpy.

* ``partition_of`` and ``shard_partitions`` equal the reference's over a
  seeded set of keys and counts.
* Stores cross the packages: one the reference partitions at P 3 opens
  in the port with the same map and the same rows in each partition; one
  the port writes and reshards opens in the reference the same way.
* Round trips are exactly-once and idempotent; every reshard kill point
  gives exactly-once after a reopen, and a reshard down keeps every row.
* The lanes lose nothing and duplicate nothing under retried faults, and
  shed per lane with the reference's ``retry_after``.
* Every engine's training-scan shape (the reference's ``ENGINE_SCANS``)
  gives the same rows in the same order in both packages on the same
  partitioned files, and so does ``aggregate_scan`` with planted equal
  timestamps; the scan cache keys on the composite digest.
* The fold-in history read and pull on P 4 equal those on P 1.
* ``pio compact`` and ``pio reshard`` print the reference's lines, and
  ``PIO_INGEST_PARTITIONS=4`` starts the event server with four lanes.
* The write path: many rows a statement store the reference's rows in
  its rowid order, a failed insert leaves nothing behind on the
  connection a lane keeps, and a lane keeps its flush thread until an
  attempt hangs.
"""

import datetime as dt
import json
import threading
import time

import numpy as np
import pytest

import predictionio_tpu.data.eventstore as ref_eventstore
import predictionio_tpu.data.ingest as ref_ingest
import predictionio_tpu.data.write_buffer as ref_wb
import predictionio_tpu.storage.partitioned as ref_part
import predictionio_tpu_torch.data.eventstore as port_eventstore
import predictionio_tpu_torch.data.ingest as port_ingest
import predictionio_tpu_torch.data.write_buffer as port_wb
import predictionio_tpu_torch.deploy.foldin as port_foldin
import predictionio_tpu_torch.storage.partitioned as port_part
from predictionio_tpu.data.datamap import DataMap as RefDataMap
from predictionio_tpu.data.event import Event as RefEvent
from predictionio_tpu.storage import App as RefApp
from predictionio_tpu.storage import Storage as RefStorage
from predictionio_tpu.storage import faults as ref_faults
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import UTC, Event
from predictionio_tpu_torch.models.als import ALSParams
from predictionio_tpu_torch.obs.registry import MetricsRegistry
from predictionio_tpu_torch.storage import faults
from predictionio_tpu_torch.storage.audit import audit_exactly_once
from predictionio_tpu_torch.storage.base import App, StorageError
from predictionio_tpu_torch.storage.faults import CrashError, FaultyEvents
from predictionio_tpu_torch.storage.registry import Storage

APP = 7
T0 = dt.datetime(2026, 1, 1, tzinfo=UTC)

#: each engine's training-scan shape (the reference's
#: tests/test_partitioned.py ENGINE_SCANS; ``sharded`` is the
#: reference's multi-process opt-in and is dropped for the port)
ENGINE_SCANS = {
    "ecommerce": dict(
        entity_type="user", event_names=["view", "buy"],
        target_entity_type="item",
        columns=("event", "entity_id", "target_entity_id")),
    "recommendation": dict(
        sharded=True, entity_type="user", event_names=["rate", "buy"],
        target_entity_type="item", ordered=False,
        columns=("event", "entity_id", "target_entity_id", "properties")),
    "recommended_user": dict(
        entity_type="user", event_names=["follow"],
        target_entity_type="user",
        columns=("entity_id", "target_entity_id", "event_time_ms")),
    "sessionrec": dict(
        entity_type="user", event_names=["view", "buy"],
        target_entity_type="item",
        columns=("entity_id", "target_entity_id", "event_time_ms")),
    "similarproduct": dict(
        entity_type="user", event_names=["view", "like", "dislike"],
        target_entity_type="item",
        columns=("event", "entity_id", "target_entity_id",
                 "event_time_ms")),
}


def ev(i, *, name="view", entity=None, cls=Event):
    return cls(
        event=name, entity_type="user", entity_id=entity or f"u{i}",
        target_entity_type="item", target_entity_id=f"i{i}",
        event_time=T0 + dt.timedelta(seconds=i))


def stored_ids(store, app=APP):
    return sorted(e.event_id for e in store.find(app))


def partition_ids(store, app=APP):
    return [sorted(e.event_id for e in store.partition_store(k).find(app))
            for k in range(store.partition_count)]


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.set_kill_points([])
    ref_faults.set_kill_points([])
    Storage.reset()
    RefStorage.reset()
    port_eventstore.clear_cache()
    ref_eventstore.clear_cache()


def make_parts(path, count, mod=port_part):
    store = mod.PartitionedEvents(mod.SqlitePartitions(str(path)),
                                  initial_count=count)
    store.init_channel(APP)
    return store


def reopen(path, mod=port_part):
    """A fresh layout and store on the same path: a process restart."""
    return mod.PartitionedEvents(mod.SqlitePartitions(str(path)))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_partition_of_equals_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(2000):
        app = int(rng.integers(0, 50))
        channel = [None, 0, int(rng.integers(1, 9))][int(rng.integers(3))]
        entity = [None, "", f"u{int(rng.integers(0, 10**6))}",
                  "é-" + str(rng.random())][int(rng.integers(4))]
        count = int(rng.integers(1, 17))
        assert port_part.partition_of(app, channel, entity, count) \
            == ref_part.partition_of(app, channel, entity, count)


def test_shard_partitions_equals_the_reference():
    for partitions in (1, 2, 3, 4, 8):
        for shards in (1, 2, 3, 4, 5, 16):
            for s in range(shards):
                assert port_part.shard_partitions(s, shards, partitions) \
                    == ref_part.shard_partitions(s, shards, partitions)
    for bad in ((-1, 2), (2, 2)):
        with pytest.raises(Exception, match="bad shard"):
            port_part.shard_partitions(*bad, 4)


def test_parquet_layout_refuses_and_sharded_read_partitions(tmp_path):
    """The parquet layout still refuses; a sharded read (which refused
    before multi-process training was ported) partitions the rows: the
    reader shards of one snapshot are disjoint and complete, and a
    snapshot taken before a reshard refuses after it."""
    with pytest.raises(NotImplementedError, match="item 8"):
        port_part.ParquetPartitions(None)
    store = make_parts(tmp_path / "ev.db", 2)
    store.insert_batch([ev(i) for i in range(6)], APP)
    assert len(store.find_columns(APP, shard=(0, 1))["event_id"]) == 6
    snap = store.read_snapshot(APP)
    for readers in (2, 3, 5):
        got = [store.find_columns(APP, shard=(i, readers, snap))["event_id"]
               for i in range(readers)]
        ids = np.concatenate(got)
        assert len(ids) == 6 and len(set(ids.tolist())) == 6
        if readers == 2:
            assert 0 < len(got[0]) < 6
    store.reshard(3, [(APP, None)])
    with pytest.raises(StorageError, match="reshard"):
        store.find_columns(APP, shard=(0, 2, snap))
    store.close()


# ---------------------------------------------------------------------------
# stores across the packages
# ---------------------------------------------------------------------------

def test_reference_store_opens_in_the_port(tmp_path):
    path = tmp_path / "ev.db"
    ref = make_parts(path, 3, ref_part)
    ids = ref.insert_batch([ev(i, cls=RefEvent) for i in range(90)], APP)
    want = partition_ids(ref)
    ref.close()
    port = reopen(path)
    assert (port.partition_count, port.generation) == (3, 0)
    assert partition_ids(port) == want
    assert stored_ids(port) == sorted(ids)
    assert port.layout.map_read() == {"count": 3, "gen": 0}
    port.close()


def test_port_store_resharded_opens_in_the_reference(tmp_path):
    path = tmp_path / "ev.db"
    port = make_parts(path, 2)
    ids = port.insert_batch([ev(i) for i in range(80)], APP)
    stats = port.reshard(3, [(APP, None)])
    assert stats == {"copied": 80, "count": 3, "gen": 1, "old_count": 2}
    want = partition_ids(port)
    port.close()
    ref = reopen(path, ref_part)
    assert (ref.partition_count, ref.generation) == (3, 1)
    assert partition_ids(ref) == want
    assert stored_ids(ref) == sorted(ids)
    ref.close()


# ---------------------------------------------------------------------------
# exactly-once
# ---------------------------------------------------------------------------

def test_roundtrip_exactly_once_and_idempotent(tmp_path):
    store = make_parts(tmp_path / "ev.db", 4)
    ids = store.insert_batch([ev(i) for i in range(120)], APP)
    assert len(set(ids)) == 120
    # the idempotent path (a retried flush, a reshard stage) converges
    store.insert_batch_idempotent(list(store.find(APP)), APP)
    assert stored_ids(store) == sorted(ids)
    assert sum(1 for ids_k in partition_ids(store) if ids_k) >= 2
    (one,) = store.insert_batch([ev(500)], APP)
    assert store.get(one, APP).event_id == one
    assert store.delete(one, APP) and store.get(one, APP) is None
    store.close()


@pytest.mark.parametrize("kill_point", [
    "reshard:staged", "reshard:committed", "reshard:old-removed"])
def test_kill_mid_reshard_exactly_once(tmp_path, kill_point):
    path = tmp_path / "ev.db"
    store = make_parts(path, 2)
    ids = store.insert_batch([ev(i) for i in range(80)], APP)
    faults.set_kill_points([kill_point])
    with pytest.raises(CrashError):
        store.reshard(4, [(APP, None)])
    faults.set_kill_points([])
    survivor = reopen(path)
    assert stored_ids(survivor) == sorted(ids)
    assert survivor.partition_count == (
        2 if kill_point == "reshard:staged" else 4)
    stats = survivor.reshard(4, [(APP, None)])
    assert survivor.partition_count == 4
    assert stored_ids(survivor) == sorted(ids)
    if kill_point == "reshard:staged":
        assert stats["copied"] == 80
    assert {g for g, _ in survivor.layout.parts()} == {survivor.generation}
    survivor.close()


def test_reshard_down_keeps_every_row(tmp_path):
    store = make_parts(tmp_path / "ev.db", 4)
    ids = store.insert_batch([ev(i) for i in range(60)], APP)
    assert store.reshard(2, [(APP, None)])["copied"] == 60
    assert store.partition_count == 2 and stored_ids(store) == sorted(ids)
    some = next(iter(store.find(APP)))
    got = list(store.find(APP, entity_id=some.entity_id,
                          entity_type="user"))
    assert any(e.event_id == some.event_id for e in got)
    assert store.reshard(2, [(APP, None)]) == {"copied": 0, "count": 2,
                                               "gen": 1}
    store.close()


def test_audit_matches_the_reference(tmp_path):
    """Planted missing and extra ids and a cross-partition duplicate:
    the port's audit of a store the reference wrote equals the
    reference's audit of it."""
    from predictionio_tpu.storage.audit import (
        audit_exactly_once as ref_audit,
    )

    path = tmp_path / "ev.db"
    ref = make_parts(path, 2, ref_part)
    ids = ref.insert_batch([ev(i, cls=RefEvent) for i in range(10)], APP)
    dup = RefEvent(event="view", entity_type="user", entity_id="u77",
                   target_entity_type="item", target_entity_id="i77",
                   event_id="dup-77")
    ref.partition_store(0).insert_batch([dup], APP)
    ref.partition_store(1).insert_batch([dup], APP)
    ref.partition_store(1).insert_batch([RefEvent(
        event="view", entity_type="user", entity_id="u9",
        event_id="stowaway-1")], APP)
    ledger = ids + ["dup-77", "ghost-1"]
    want = ref_audit(ref, APP, ledger)
    ref.close()
    port = reopen(path)
    got = audit_exactly_once(port, APP, ledger)
    assert not got.ok
    assert (got.missing, got.duplicates, got.extras) == (
        want.missing, want.duplicates, want.extras) == (
        ["ghost-1"], ["dup-77"], ["stowaway-1"])
    assert got.partitions == want.partitions
    assert got.as_dict() == want.as_dict()
    assert got.summary() == want.summary()
    port.close()


# ---------------------------------------------------------------------------
# commit lanes
# ---------------------------------------------------------------------------

def test_lanes_retry_faults_no_loss_no_dup(tmp_path):
    store = make_parts(tmp_path / "ev.db", 4)
    faulty = FaultyEvents(store, fail_n=3, when="before")
    reg = MetricsRegistry()
    buf = port_wb.WriteBuffer(lambda: faulty, partitions=4, retries=5,
                              backoff_s=0.001, backoff_cap_s=0.002,
                              linger_s=0.01, registry=reg)
    # single events and submits spanning several lanes
    futures = [buf.submit([ev(i)], APP) for i in range(60)]
    futures += [buf.submit([ev(100 + j * 10 + k) for k in range(10)], APP)
                for j in range(9)]
    ids = [i for f in futures for i in f.result(timeout=30)]
    buf.stop()
    assert faulty.faults_fired == 3
    assert len(set(ids)) == 150 and stored_ids(store) == sorted(ids)
    # a spanning submit's ids come back in input order
    span = futures[60].result()
    assert [store.get(i, APP).entity_id for i in span] \
        == [f"u{100 + k}" for k in range(10)]
    flush = reg.get("pio_ingest_partition_flush_size")
    assert flush.total_count() > 0
    assert sum(flush.count(partition=str(k)) for k in range(4)) \
        == flush.total_count()
    assert reg.get("pio_ingest_partition_commit_seconds").total_count() > 0
    assert reg.get("pio_ingest_retry_total").value() == 3
    depth = reg.get("pio_ingest_partition_queue_depth")
    assert sorted(s[0]["partition"] for s in depth.samples()) \
        == ["0", "1", "2", "3"]
    assert all(s[1] == 0 for s in depth.samples())
    assert audit_exactly_once(store, APP, ids).ok
    store.close()


def _shed_run(wb_mod, part_mod, path, cls):
    """A wedged lane 0 sheds its own submits while lane 1 accepts; returns
    (depth, retry_after) of the shed, the submits lane 0 took, and
    whether lane 1 committed."""
    store = make_parts(path, 2, part_mod)
    lane_of = lambda e: part_mod.partition_of(APP, None, e, 2)  # noqa
    lane0 = next(f"u{i}" for i in range(100) if lane_of(f"u{i}") == 0)
    lane1 = next(f"u{i}" for i in range(100) if lane_of(f"u{i}") == 1)
    gate = threading.Event()

    class Wedged:
        def insert_batch(self, events, app_id, channel_id=None):
            if part_mod.partition_of(app_id, channel_id,
                                     events[0].entity_id, 2) == 0:
                assert gate.wait(10), "gate never released"
            return store.insert_batch(events, app_id, channel_id)

        def __getattr__(self, name):
            return getattr(store, name)

    buf = wb_mod.WriteBuffer(store_fn=Wedged, partitions=2, queue_max=8,
                             linger_s=0.0, flush_max=4)
    held = []
    try:
        for i in range(20):
            held.append(buf.submit([ev(i, entity=lane0, cls=cls)], APP))
            time.sleep(0.01)
        shed = None
    except wb_mod.BufferFull as e:
        shed = (e.depth, e.retry_after)
    ok = buf.submit([ev(50, entity=lane1, cls=cls)], APP).result(
        timeout=10)
    gate.set()
    for f in held:
        f.result(timeout=20)
    buf.stop()
    n = len(stored_ids(store))
    store.close()
    return shed, len(held), bool(ok), n


def test_buffer_sheds_per_lane_like_the_reference(tmp_path):
    got = _shed_run(port_wb, port_part, tmp_path / "port.db", Event)
    want = _shed_run(ref_wb, ref_part, tmp_path / "ref.db", RefEvent)
    assert got == want
    (depth, retry_after), held, ok, n = got
    assert depth == 4 and retry_after == 1 and held == 4 and ok
    assert n == held + 1


# ---------------------------------------------------------------------------
# training reads on the same partitioned files
# ---------------------------------------------------------------------------

def _config(path):
    return {"sources": {"DB": {"TYPE": "sqlite", "PATH": str(path)}},
            "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                             for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}}


def _seed_engine_events(app_name):
    """The reference's engine workload, written by the reference into a
    partitioned store, with every fourth event at a shared timestamp."""
    app_id = RefStorage.get_meta_data_apps().insert(
        RefApp(id=0, name=app_name))
    store = RefStorage.get_events()
    store.init_channel(app_id)
    rng = np.random.default_rng(23)
    events = [RefEvent(event="$set", entity_type="user", entity_id=f"u{u}",
                       properties=RefDataMap({"plan": int(u % 3)}),
                       event_time=T0 + dt.timedelta(seconds=u))
              for u in range(8)]
    kinds = ["view", "buy", "like", "dislike", "rate", "follow"]
    for k in range(120):
        kind = kinds[int(rng.integers(len(kinds)))]
        u = int(rng.integers(8))
        t = T0 + dt.timedelta(seconds=100 + (k // 4 if k % 4 == 0 else k))
        if kind == "follow":
            events.append(RefEvent(
                event="follow", entity_type="user", entity_id=f"u{u}",
                target_entity_type="user",
                target_entity_id=f"u{int(rng.integers(8))}", event_time=t))
        else:
            props = (RefDataMap({"rating": float(rng.integers(1, 6))})
                     if kind == "rate" else RefDataMap())
            events.append(RefEvent(
                event=kind, entity_type="user", entity_id=f"u{u}",
                target_entity_type="item",
                target_entity_id=f"i{int(rng.integers(6))}",
                properties=props, event_time=t))
    store.insert_batch(events, app_id)
    return app_id


@pytest.fixture()
def partitioned_files(tmp_path, monkeypatch):
    """One sqlite source partitioned at P 4 by the reference, configured
    in both packages."""
    monkeypatch.setenv("PIO_INGEST_PARTITIONS", "4")
    RefStorage.configure(_config(tmp_path / "pio.db"))
    _seed_engine_events("ParityApp")
    # the reference's $set folds in the order the merge gives: plant
    # equal-time property events across the partitions
    store = RefStorage.get_events()
    store.insert_batch([RefEvent(
        event="$set", entity_type="user", entity_id=f"u{u}",
        properties=RefDataMap({"attr": f"v{u}-{j}"}),
        event_time=T0 + dt.timedelta(seconds=50)) for u in range(8)
        for j in range(3)], 1)
    Storage.configure(_config(tmp_path / "pio.db"))
    assert hasattr(Storage.get_events(), "partition_count")
    assert Storage.get_events().partition_count == 4
    return tmp_path


def _ref_rows(table, columns):
    return list(zip(*[table.column(c).to_pylist() for c in columns]))


def _port_rows(cols, columns):
    return list(zip(*[cols[c].tolist() for c in columns]))


@pytest.mark.parametrize("engine", sorted(ENGINE_SCANS))
def test_training_scan_equals_the_reference(partitioned_files, engine):
    shape = dict(ENGINE_SCANS[engine])
    columns = shape["columns"]
    want = _ref_rows(ref_ingest.training_scan(
        "ParityApp", cache=False, **shape).table, columns)
    shape.pop("sharded", None)
    got = _port_rows(port_ingest.training_columns(
        "ParityApp", cache=False, **shape), columns)
    assert got == want and len(got) > 0
    # the time order asked for: the stable merge keeps partition order
    # within a shared timestamp, as Arrow's sort does
    for flags in ({"ordered": True}, {"reversed_order": True},
                  {"limit": 17}):
        shape.update(flags)
        want = _ref_rows(ref_ingest.training_scan(
            "ParityApp", cache=False, **shape).table, columns)
        got = _port_rows(port_ingest.training_columns(
            "ParityApp", cache=False, **shape), columns)
        assert got == want, flags


def test_aggregate_scan_equals_the_reference(partitioned_files):
    want = ref_ingest.aggregate_scan("ParityApp", "user", cache=False)
    got = port_ingest.aggregate_scan("ParityApp", "user", cache=False)
    assert sorted(got) == sorted(want) == [f"u{u}" for u in range(8)]
    for u in got:
        assert got[u].fields == want[u].fields, u
        assert got[u].first_updated == want[u].first_updated
        assert got[u].last_updated == want[u].last_updated


def test_scan_cache_keys_on_the_composite_digest(partitioned_files):
    digest = port_eventstore.EventStoreClient.snapshot_digest("ParityApp")
    assert digest == ref_eventstore.EventStoreClient.snapshot_digest(
        "ParityApp")
    assert digest.startswith("pmap:4:") and digest.count("|") == 3
    port_ingest.clear_scan_cache()
    shape = dict(ENGINE_SCANS["sessionrec"])
    first = port_ingest.training_columns("ParityApp", **shape)
    again = port_ingest.training_columns("ParityApp", **shape)
    assert again["entity_id"] is first["entity_id"]      # a hit
    Storage.get_events().insert_batch([ev(999)], 1)
    after = port_ingest.training_columns("ParityApp", **shape)
    assert after["entity_id"] is not first["entity_id"]  # a miss
    assert port_eventstore.EventStoreClient.snapshot_digest(
        "ParityApp") != digest


# ---------------------------------------------------------------------------
# fold-in over partitions
# ---------------------------------------------------------------------------

def _foldin_spec():
    return port_foldin.FoldinSpec(
        app_name="FoldApp", als_params=ALSParams(rank=4),
        event_names=("rate", "buy", "view"),
        event_weights={"buy": 4.0, "view": 1.0}, rate_event="rate",
        fold_items=True)


def _foldin_store(path, partitions, monkeypatch):
    if partitions > 1:
        monkeypatch.setenv("PIO_INGEST_PARTITIONS", str(partitions))
    else:
        monkeypatch.delenv("PIO_INGEST_PARTITIONS", raising=False)
    Storage.configure(_config(path))
    port_eventstore.clear_cache()
    app_id = Storage.get_meta_data_apps().insert(App(id=0, name="FoldApp"))
    store = Storage.get_events()
    store.init_channel(app_id)
    rng = np.random.default_rng(5)
    names = ["rate", "buy", "view", "like"]
    rows = []
    for k in range(400):
        name = names[int(rng.integers(4))]
        props = ({"rating": float(rng.integers(1, 6))}
                 if name == "rate" else {})
        rows.append(Event(
            event=name, entity_type="user",
            entity_id=f"u{int(rng.integers(40))}",
            target_entity_type="item",
            target_entity_id=f"i{int(rng.integers(25))}",
            properties=DataMap(props),
            event_time=T0 + dt.timedelta(seconds=int(k // 3))))
    store.insert_batch(rows, app_id)
    return store


def _history(spec, ids, side):
    out = port_foldin.read_entities_ratings(spec, ids, side)
    return {e: sorted(zip([str(o) for o in others], values.tolist()))
            for e, (others, values) in out.items()}


def test_foldin_reads_on_four_partitions_equal_one(tmp_path, monkeypatch):
    spec = _foldin_spec()
    users = [f"u{u}" for u in range(40)] + ["nobody"]
    items = [f"i{i}" for i in range(25)]
    since = dt.datetime.fromtimestamp(
        (T0 + dt.timedelta(seconds=60)).timestamp(), tz=UTC)
    pull_cols = ("event_id", "event", "entity_id", "target_entity_type",
                 "target_entity_id", "event_time_ms")
    seen = []
    for partitions in (1, 4):
        store = _foldin_store(tmp_path / f"p{partitions}.db", partitions,
                              monkeypatch)
        assert getattr(store, "partition_count", 1) == partitions
        pulled = port_eventstore.EventStoreClient.find_columns(
            "FoldApp", start_time=since, entity_type="user",
            event_names=["rate", "buy", "view"], ordered=False,
            columns=pull_cols)
        seen.append((_history(spec, users, "user"),
                     _history(spec, items, "item"),
                     sorted(_port_rows(pulled, pull_cols[1:]))))
        Storage.reset()
    assert seen[0] == seen[1]
    assert seen[0][0]["nobody"] == [] and len(seen[0][2]) > 100


# ---------------------------------------------------------------------------
# the maintenance commands
# ---------------------------------------------------------------------------

def _port_cli(args, capsys):
    from predictionio_tpu_torch.cli.main import main

    capsys.readouterr()
    try:
        rc = main(args)
    except SystemExit as e:
        rc = e.code
    return rc, capsys.readouterr().out.strip().splitlines()


def _ref_cli(args):
    from click.testing import CliRunner

    from predictionio_tpu.cli.main import cli

    res = CliRunner().invoke(cli, args, catch_exceptions=False)
    return res.exit_code, res.output.strip().splitlines()


def _cli_store(path, pkg, partitions, monkeypatch):
    monkeypatch.setenv("PIO_INGEST_PARTITIONS", str(partitions))
    if pkg == "ref":
        RefStorage.configure(_config(path))
        app_id = RefStorage.get_meta_data_apps().insert(
            RefApp(id=0, name="MaintApp"))
        store = RefStorage.get_events()
        store.init_channel(app_id)
        old = [ev(i, cls=RefEvent) for i in range(30)]
        new = [RefEvent(event="view", entity_type="user",
                        entity_id=f"n{i}", event_time=dt.datetime.now(UTC))
               for i in range(10)]
    else:
        Storage.configure(_config(path))
        app_id = Storage.get_meta_data_apps().insert(
            App(id=0, name="MaintApp"))
        store = Storage.get_events()
        store.init_channel(app_id)
        old = [ev(i) for i in range(30)]
        new = [Event(event="view", entity_type="user", entity_id=f"n{i}",
                     event_time=dt.datetime.now(UTC)) for i in range(10)]
    return store.insert_batch(old + new, app_id)


def test_compact_and_reshard_print_the_reference_lines(
        tmp_path, monkeypatch, capsys):
    steps = [["reshard", "-p", "4"], ["reshard", "--partitions", "2"],
             ["compact", "--appname", "MaintApp", "--ttl-days", "30"],
             ["compact", "--appid", "1"],
             ["compact", "--appid", "1", "--channel", "nope"],
             ["compact"]]
    outputs = {}
    for pkg in ("ref", "port"):
        ids = _cli_store(tmp_path / f"{pkg}.db", pkg, 2, monkeypatch)
        outputs[pkg] = [(_ref_cli if pkg == "ref" else
                         lambda a: _port_cli(a, capsys))(args)
                        for args in steps]
        store = (RefStorage if pkg == "ref" else Storage).get_events()
        assert store.partition_count == 2
        # the 30 events of 2026-01-01 are past the 30-day retention
        assert stored_ids(store, 1) == sorted(ids[30:])
        (RefStorage if pkg == "ref" else Storage).reset()
    assert outputs["port"] == outputs["ref"]
    assert outputs["port"][0] == (0, [
        '[INFO] Resharded 1 namespace(s): {"copied": 40, "count": 4, '
        '"gen": 1, "old_count": 2}'])
    assert outputs["port"][2] == (0, [
        '[INFO] Compacted app 1: {"removed_rows": 30}'])
    assert [rc for rc, _ in outputs["port"]] == [0, 0, 0, 0, 1, 1]


def test_reshard_refuses_an_unpartitioned_store(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.delenv("PIO_INGEST_PARTITIONS", raising=False)
    Storage.configure(_config(tmp_path / "flat.db"))
    rc, lines = _port_cli(["reshard", "-p", "2"], capsys)
    assert rc == 1 and "not partitioned" in lines[-1]


def test_event_server_runs_four_commit_lanes(tmp_path, monkeypatch):
    """PIO_INGEST_PARTITIONS=4 starts the event server with four lanes
    over a partitioned store; every acked id is stored once."""
    import asyncio
    import http.client

    from predictionio_tpu_torch.server.event_server import EventServer
    from predictionio_tpu_torch.storage.base import AccessKey

    monkeypatch.setenv("PIO_INGEST_PARTITIONS", "4")
    Storage.configure(_config(tmp_path / "es.db"))
    app_id = Storage.get_meta_data_apps().insert(App(id=0, name="EsApp"))
    Storage.get_meta_data_access_keys().insert(
        AccessKey(key="k4", appid=app_id, events=()))
    Storage.get_events().init_channel(app_id)
    server = EventServer()
    assert server.buffer.partitions == 4

    def post(port, body):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        c.request("POST", "/batch/events.json?accessKey=k4",
                  body=json.dumps(body))
        r = c.getresponse()
        return r.status, json.loads(r.read())

    async def main():
        port = await server.start("127.0.0.1", 0)
        try:
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(None, post, port, [
                {"event": "view", "entityType": "user",
                 "entityId": f"u{i}", "targetEntityType": "item",
                 "targetEntityId": f"i{i}"} for i in range(40)])
        finally:
            await server.close()

    status, body = asyncio.run(main())
    assert status == 200 and all(b["status"] == 201 for b in body)
    store = Storage.get_events()
    assert store.partition_count == 4
    assert audit_exactly_once(store, app_id,
                              [b["eventId"] for b in body]).ok
    assert sum(1 for ids_k in partition_ids(store, app_id) if ids_k) == 4


# ---------------------------------------------------------------------------
# the write path under the lanes
# ---------------------------------------------------------------------------

def test_multi_row_inserts_store_what_the_reference_stores(tmp_path):
    """The port inserts many rows a statement: the same rows, in the same
    rowid order, as the reference's row-at-a-time insert of the same
    events (ties on event time read in that order)."""
    from predictionio_tpu.storage.sqlite_backend import (
        SqliteClient as RefClient, SqliteEvents as RefEvents,
    )
    from predictionio_tpu_torch.storage.sqlite_backend import (
        SqliteClient, SqliteEvents,
    )

    rng = np.random.default_rng(3)
    rows = [(f"id{i:04d}", f"u{int(rng.integers(30))}",
             float(rng.integers(1, 6)), int(rng.integers(0, 20)))
            for i in range(150)]
    dumps = []
    for client, events_cls, ev_cls, dm in (
            (RefClient, RefEvents, RefEvent, RefDataMap),
            (SqliteClient, SqliteEvents, Event, DataMap)):
        client = client(str(tmp_path / f"{events_cls.__module__}.db"))
        store = events_cls(client)
        store.init_channel(APP)
        store.insert_batch([ev_cls(
            event="rate", entity_type="user", entity_id=u,
            target_entity_type="item", target_entity_id=f"i{t}",
            properties=dm({"rating": r}), event_id=eid,
            event_time=T0 + dt.timedelta(seconds=t),
            creation_time=T0) for eid, u, r, t in rows], APP)
        dumps.append(client.conn().execute(
            f"SELECT rowid, * FROM pio_event_{APP} ORDER BY rowid"
        ).fetchall())
        client.close()
    assert dumps[1] == dumps[0] and len(dumps[1]) == 150


def test_failed_insert_leaves_nothing_behind(tmp_path):
    """A batch that fails part-way (a duplicate id past the first
    statement's rows) rolls back whole, and the connection, which a
    lane's flush thread keeps, commits nothing of it later."""
    from predictionio_tpu_torch.storage.sqlite_backend import (
        SqliteClient, SqliteEvents,
    )

    client = SqliteClient(str(tmp_path / "ev.db"))
    store = SqliteEvents(client)
    store.init_channel(APP)
    first = store.insert_batch([ev(0)], APP)
    bad = [ev(i) for i in range(1, 100)] + [
        Event(event="view", entity_type="user", entity_id="dup",
              event_id=first[0])]
    bad = [e if e.event_id else port_wb._with_id(e) for e in bad]
    with pytest.raises(Exception):
        store.insert_batch(bad, APP)
    store.insert_batch([ev(500)], APP)
    assert len(stored_ids(store)) == 2
    # the idempotent path skips the stored id and keeps the rest
    store.insert_batch_idempotent(bad, APP)
    assert len(stored_ids(store)) == 101
    client.close()


def test_a_lane_keeps_its_flush_thread_until_an_attempt_hangs(tmp_path):
    store = make_parts(tmp_path / "ev.db", 1)
    gate = threading.Event()
    seen = []

    class Hanging:
        def insert_batch(self, events, app_id, channel_id=None):
            seen.append(threading.current_thread())
            if len(seen) == 2:
                gate.wait(10)
            return store.insert_batch(events, app_id, channel_id)

        def __getattr__(self, name):
            return getattr(store, name)

    buf = port_wb.WriteBuffer(lambda: Hanging(), linger_s=0.0, retries=2,
                              flush_timeout_s=0.2)
    assert buf.submit([ev(0)], APP).result(timeout=10)
    with pytest.raises(Exception, match="hung"):
        buf.submit([ev(1)], APP).result(timeout=10)
    gate.set()
    assert buf.submit([ev(2)], APP).result(timeout=10)
    assert buf.submit([ev(3)], APP).result(timeout=10)
    buf.stop()
    # one thread for the first two attempts, a fresh one after the hang,
    # kept for the flush after it
    assert seen[0] is seen[1] and seen[2] is not seen[1]
    assert seen[3] is seen[2] and len(seen) == 4
    # the hung attempt committed once it was let go: nothing lost twice
    time.sleep(0.1)
    assert len(stored_ids(store)) == 4
    store.close()
