"""The port's evlog codec and event store (``predictionio_tpu_torch/
native/evlog.py``, ``csrc/evlog.cc``, ``storage/evlog_backend.py``) held
against the JAX package's on the CPU, in ``tmp_path``, with seeds from
numpy.

* The four codecs (the port's native and Python ones, the reference's
  ``EvlogCodec`` over its own ``native/evlog.cc`` built by the test with
  g++, and its ``PyCodec``) each pass the reference's codec cases
  (``tests/test_evlog.py``: round trip, time, entity and id filters,
  idempotent create, corruption, a truncated tail, a missing file), write
  byte-identical files from the same seeded records, read each other's,
  agree on every filter, and share ``entity_hash``.
* The port's library is built from ``csrc/evlog.cc`` alone, named by
  its digest under ``build/torch_kernels/``; a failed build falls back
  to the Python codec under ``auto`` (a warning with the compiler's
  output) and raises under ``native``; a source's ``CODEC`` comes before
  ``PIO_EVLOG_CODEC``.
* ``EvlogEvents`` runs the reference's event-store contract
  (``tests/test_storage.py:55-210``) with both codecs, and against the
  reference's store on the same events (fixed ids and creation times):
  equal ``find`` under every filter, order and limit, byte-identical log
  files, each package reading the other's log, a re-insert after a delete
  resurrecting the id, the shard refusal, and ``find_columns`` equal
  column for column to ``SqliteEvents.find_columns`` after a stable sort.
* A small ALS trained on the CPU through the CLI from an evlog store
  equals one trained from sqlite on the same events; the CLI's app,
  import, export, data-delete and compact commands and the event
  server's ``/events.json`` (through the write buffer) work unchanged on
  an evlog source; the registry serves ``evlog`` for EVENTDATA only.

Without ``g++`` the native cases skip with that reason; nothing passes
vacuously.
"""

import asyncio
import ctypes
import dataclasses
import datetime as dt
import http.client
import json
import logging
import os
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

import predictionio_tpu.native.evlog as ref_evlog
import predictionio_tpu_torch.native.evlog as evlog
from predictionio_tpu.data.datamap import DataMap as RefDataMap
from predictionio_tpu.data.event import Event as RefEvent
from predictionio_tpu.storage.evlog_backend import (
    EvlogClient as RefEvlogClient, EvlogEvents as RefEvlogEvents,
)
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.storage.base import App, StorageError
from predictionio_tpu_torch.storage.evlog_backend import (
    EvlogClient, EvlogEvents,
)
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.storage.sqlite_backend import (
    SqliteClient, SqliteEvents,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
UTC = dt.timezone.utc
T0 = dt.datetime(2024, 1, 1, tzinfo=UTC)
CODECS = ("port-native", "port-python", "ref-native", "ref-python")


def t(days):
    return T0 + dt.timedelta(days=days)


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ absent: the native evlog codec cannot be built")


@pytest.fixture(scope="module")
def ref_native(tmp_path_factory):
    """The reference's EvlogCodec over its own ``native/evlog.cc``, built
    into a directory of this test (the reference's own build writes
    beside its package, which other test processes may do at once)."""
    _need_gxx()
    so = tmp_path_factory.mktemp("ref_evlog") / "libpioevlog.so"
    subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-std=c++17", "-o",
                    str(so), str(ROOT / "native" / "evlog.cc")], check=True,
                   capture_output=True, timeout=300)
    return ref_evlog.EvlogCodec(ctypes.CDLL(str(so)))


def _codec(name, request):
    if name == "port-python":
        return evlog.PyCodec()
    if name == "ref-python":
        return ref_evlog.PyCodec()
    _need_gxx()
    if name == "port-native":
        return evlog.get_codec("native")
    return request.getfixturevalue("ref_native")


@pytest.fixture(params=CODECS)
def codec(request):
    return _codec(request.param, request)


def _records():
    return [
        (1000, evlog.entity_hash("user", "u1"), 0, b"\x01" * 16, b'{"a":1}'),
        (2000, evlog.entity_hash("user", "u2"), 0, b"\x02" * 16, b'{"b":2}'),
        (3000, evlog.entity_hash("item", "i1"), 0, b"\x03" * 16, b""),
        (2000, evlog.entity_hash("user", "u2"), 1, b"\x02" * 16, b""),
    ]


def _seeded_records(n=600, seed=0):
    """Records of every shape the store writes: times spread over both
    signs, a few entities, tombstones, empty and long payloads."""
    rng = np.random.default_rng(seed)
    ents = [("user", f"u{j}") for j in range(9)] + [("item", "ü-é"),
                                                     ("x", "")]
    out = []
    for j in range(n):
        et, eid = ents[int(rng.integers(len(ents)))]
        flags = int(rng.random() < 0.1)
        size = 0 if flags else int(rng.integers(0, 300))
        payload = bytes(rng.integers(0, 256, size, dtype=np.uint8))
        out.append((int(rng.integers(-10**12, 10**13)),
                    evlog.entity_hash(et, eid), flags,
                    bytes(rng.integers(0, 256, 16, dtype=np.uint8)),
                    payload))
    return out


# -- the codec: the reference's cases, on every codec ------------------------

def test_round_trip(tmp_path, codec):
    path = str(tmp_path / "t.evlog")
    codec.create(path)
    codec.append(path, _records())
    assert codec.scan(path) == _records()
    assert codec.verify(path) == 4


def test_time_filter(tmp_path, codec):
    path = str(tmp_path / "t.evlog")
    codec.create(path)
    codec.append(path, _records())
    got = codec.scan(path, t_lo=1500, t_hi=2500)
    assert [r[0] for r in got] == [2000, 2000]
    assert codec.scan(path, t_lo=9999, t_hi=evlog.T_MAX) == []


def test_entity_and_id_filters(tmp_path, codec):
    path = str(tmp_path / "t.evlog")
    codec.create(path)
    codec.append(path, _records())
    by_entity = codec.scan(path, ehash=evlog.entity_hash("user", "u2"))
    assert len(by_entity) == 2
    by_id = codec.scan(path, rid=b"\x01" * 16)
    assert len(by_id) == 1 and by_id[0][4] == b'{"a":1}'


def test_create_is_idempotent(tmp_path, codec):
    path = str(tmp_path / "t.evlog")
    codec.create(path)
    codec.append(path, _records()[:1])
    codec.create(path)   # must not truncate
    assert codec.verify(path) == 1


def test_corruption_detected(tmp_path, codec):
    path = str(tmp_path / "t.evlog")
    codec.create(path)
    codec.append(path, _records())
    with open(path, "r+b") as f:
        f.seek(len(evlog.HEADER) + 45)   # inside the first payload
        f.write(b"X")
    with pytest.raises((evlog.EvlogError, ref_evlog.EvlogError)):
        codec.verify(path)
    with pytest.raises((evlog.EvlogError, ref_evlog.EvlogError)):
        codec.scan(path)
    # a scan that does not match the corrupt record does not check it
    assert len(codec.scan(path, t_lo=1500)) == 3


def test_truncated_tail_is_tolerated_by_scan(tmp_path, codec):
    """A torn final write (a crash mid-append) must not break reads. A
    torn record head ends the log for verify too; a whole head with a
    torn payload is what verify reports."""
    path = str(tmp_path / "t.evlog")
    codec.create(path)
    codec.append(path, _records())
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 3)
    assert codec.scan(path, evlog.T_MIN, evlog.T_MAX) == _records()[:3]
    assert codec.verify(path) == 3
    torn = str(tmp_path / "torn.evlog")
    codec.create(torn)
    codec.append(torn, _records()[:2])
    with open(torn, "r+b") as f:
        f.truncate(os.path.getsize(torn) - 2)
    assert codec.scan(torn) == _records()[:1]
    with pytest.raises((evlog.EvlogError, ref_evlog.EvlogError)):
        codec.verify(torn)


def test_append_to_missing_file_raises(tmp_path, codec):
    with pytest.raises((evlog.EvlogError, ref_evlog.EvlogError)):
        codec.append(str(tmp_path / "nope.evlog"), _records()[:1])
    assert not (tmp_path / "nope.evlog").exists()


def test_bad_header_raises(tmp_path, codec):
    path = tmp_path / "t.evlog"
    path.write_bytes(b"NOTEVLOG" + bytes(8))
    with pytest.raises((evlog.EvlogError, ref_evlog.EvlogError)):
        codec.scan(str(path))


# -- the codecs against each other -------------------------------------------

def test_files_byte_identical_and_read_across(tmp_path, request):
    recs = _seeded_records()
    codecs = {n: _codec(n, request) for n in CODECS}
    paths = {}
    for name, c in codecs.items():
        paths[name] = str(tmp_path / f"{name}.evlog")
        c.create(paths[name])
        for s in range(0, len(recs), 97):       # several appends
            c.append(paths[name], recs[s:s + 97])
    blobs = {n: open(p, "rb").read() for n, p in paths.items()}
    assert len(set(blobs.values())) == 1, {n: len(b) for n, b in
                                           blobs.items()}
    for reader in codecs.values():
        for path in paths.values():
            assert reader.scan(path) == recs
            assert reader.verify(path) == len(recs)


def test_scan_filters_agree(tmp_path, request):
    recs = _seeded_records(seed=1)
    codecs = {n: _codec(n, request) for n in CODECS}
    path = str(tmp_path / "t.evlog")
    evlog.PyCodec().create(path)
    evlog.PyCodec().append(path, recs)
    rng = np.random.default_rng(2)
    for _ in range(12):
        lo, hi = sorted(int(x) for x in rng.integers(-10**12, 10**13, 2))
        pick = recs[int(rng.integers(len(recs)))]
        for args in ({"t_lo": lo, "t_hi": hi}, {"ehash": pick[1]},
                     {"rid": pick[3]},
                     {"t_lo": lo, "t_hi": hi, "ehash": pick[1]}):
            want = [r for r in recs
                    if args.get("t_lo", evlog.T_MIN) <= r[0]
                    < args.get("t_hi", evlog.T_MAX)
                    and args.get("ehash", r[1]) == r[1]
                    and args.get("rid", r[3]) == r[3]]
            for c in codecs.values():
                assert c.scan(path, **args) == want


def test_entity_hash_matches_reference_and_native(request):
    native = _codec("port-native", request)
    rng = np.random.default_rng(3)
    pairs = [("user", "u1"), ("item", "long-id-" * 10), ("x", ""),
             ("", ""), ("ü", "日本")]
    pairs += [(f"t{rng.integers(100)}", f"e{rng.integers(10**9)}")
              for _ in range(200)]
    for et, eid in pairs:
        data = et.encode() + b"\x00" + eid.encode()
        h = evlog.entity_hash(et, eid)
        assert h == ref_evlog.entity_hash(et, eid) != 0
        assert native._lib.evlog_entity_hash(data, len(data)) == h


# -- the port's build ---------------------------------------------------------

def test_library_built_from_the_port_source_by_digest():
    _need_gxx()
    codec = evlog.get_codec("native")
    assert codec.name == "native"
    path = evlog.library_path()
    assert path.exists() and path.parent == ROOT / "build" / "torch_kernels"
    assert evlog.SOURCE == ROOT / "predictionio_tpu_torch" / "csrc" \
        / "evlog.cc"
    assert path.name.startswith("libevlog-") and path.suffix == ".so"
    assert not list(path.parent.glob("libevlog-*.tmp"))
    # the reference's library is neither built nor loaded by the port
    assert evlog.get_codec("native") is codec
    assert evlog.build() == path


def test_failed_build_falls_back_under_auto_and_raises_under_native(
        tmp_path, monkeypatch, caplog):
    _need_gxx()
    bad = tmp_path / "evlog.cc"
    bad.write_text("this is not C++ (deliberately)\n")
    monkeypatch.setattr(evlog, "SOURCE", bad)
    monkeypatch.setattr(evlog, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(evlog, "_native", None)
    monkeypatch.delenv("PIO_EVLOG_CODEC", raising=False)
    with caplog.at_level(logging.WARNING, logger="pio.torch.evlog"):
        codec = evlog.get_codec()
    assert codec.name == "python"
    assert "g++ failed" in caplog.text and "deliberately" in caplog.text
    with pytest.raises(evlog.EvlogError, match="g\\+\\+ failed"):
        evlog.get_codec("native")
    monkeypatch.setenv("PIO_EVLOG_CODEC", "native")
    with pytest.raises(evlog.EvlogError):
        evlog.get_codec()
    assert not list((tmp_path / "build").glob("*"))


def test_source_codec_comes_before_the_env(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_EVLOG_CODEC", "python")
    assert EvlogClient(str(tmp_path / "a")).codec.name == "python"
    _need_gxx()
    assert EvlogClient(str(tmp_path / "b"),
                       codec="native").codec.name == "native"
    monkeypatch.setenv("PIO_EVLOG_CODEC", "native")
    assert EvlogClient(str(tmp_path / "c"),
                       codec="python").codec.name == "python"


# -- the event store: the reference's contract --------------------------------

@pytest.fixture(params=["native", "python"])
def store(tmp_path, request):
    if request.param == "native":
        _need_gxx()
    s = EvlogEvents(EvlogClient(str(tmp_path / "evlog"),
                                codec=request.param))
    assert s.client.codec.name == request.param
    s.init_channel(1)
    yield s
    s.close()


def ev(i, name="view", etype="user", eid="u1", **kw):
    base = dict(event=name, entity_type=etype, entity_id=eid,
                event_time=t(i), creation_time=t(i))
    base.update(kw)
    return Event(**base)


def test_insert_and_get_back(store):
    events = [ev(0), ev(1, eid="u2"), ev(2, name="buy")]
    ids = store.insert_batch(events, 1)
    assert len(set(ids)) == 3
    for eid, orig in zip(ids, events):
        got = store.get(eid, 1)
        assert got is not None
        assert (got.event, got.entity_id, got.event_time) == (
            orig.event, orig.entity_id, orig.event_time)


def test_get_missing_returns_none(store):
    assert store.get("nonexistent", 1) is None


def test_delete(store):
    eid = store.insert_batch([ev(0)], 1)[0]
    assert store.delete(eid, 1) is True
    assert store.get(eid, 1) is None
    assert store.delete(eid, 1) is False


def test_find_filters(store):
    store.insert_batch([
        ev(0, "view", eid="u1"),
        ev(1, "buy", eid="u1"),
        ev(2, "view", eid="u2", etype="customer"),
        ev(3, "view", eid="u1",
           target_entity_type="item", target_entity_id="i1"),
    ], 1)
    assert len(list(store.find(1))) == 4
    assert len(list(store.find(1, event_names=["view"]))) == 3
    assert len(list(store.find(1, entity_type="user"))) == 3
    assert len(list(store.find(1, entity_id="u2"))) == 1
    assert len(list(store.find(1, start_time=t(1)))) == 3
    assert len(list(store.find(1, until_time=t(1)))) == 1
    assert len(list(store.find(1, start_time=t(1), until_time=t(3)))) == 2
    assert len(list(store.find(1, limit=2))) == 2
    assert len(list(store.find(1, target_entity_type=None))) == 3
    assert len(list(store.find(1, target_entity_type="item"))) == 1
    assert len(list(store.find(1, target_entity_id="i1"))) == 1


def test_find_ordering(store):
    store.insert_batch([ev(2), ev(0), ev(1)], 1)
    times = [e.event_time for e in store.find(1)]
    assert times == sorted(times)
    rev = [e.event_time for e in store.find(1, reversed_order=True)]
    assert rev == sorted(times, reverse=True)


def test_properties_round_trip(store):
    e = ev(0, properties=DataMap({"a": 1, "nested": {"x": [1, 2]}}),
           tags=("t1", "t2"), pr_id="pr9")
    got = store.get(store.insert_batch([e], 1)[0], 1)
    assert got.properties == DataMap({"a": 1, "nested": {"x": [1, 2]}})
    assert got.tags == ("t1", "t2")
    assert got.pr_id == "pr9"


def test_aggregate_properties(store):
    store.insert_batch([
        ev(0, "$set", eid="u1", properties=DataMap({"a": 1, "b": 2})),
        ev(1, "$set", eid="u1", properties=DataMap({"a": 3})),
        ev(2, "$unset", eid="u1", properties=DataMap({"b": None})),
        ev(0, "$set", eid="u2", properties=DataMap({"c": 9})),
        ev(1, "$delete", eid="u2"),
        ev(0, "$set", eid="i1", etype="item", properties=DataMap({"p": 1})),
    ], 1)
    out = store.aggregate_properties(1, "user")
    assert set(out) == {"u1"}
    assert out["u1"].fields == {"a": 3}
    assert set(store.aggregate_properties(1, "item")) == {"i1"}


def test_aggregate_required_filter(store):
    store.insert_batch([
        ev(0, "$set", eid="u1", properties=DataMap({"a": 1})),
        ev(0, "$set", eid="u2", properties=DataMap({"a": 1, "b": 2})),
    ], 1)
    assert set(store.aggregate_properties(1, "user",
                                          required=["b"])) == {"u2"}


def test_channels_isolated(store):
    store.init_channel(1, channel_id=7)
    store.insert_batch([ev(0)], 1)
    store.insert_batch([ev(1)], 1, channel_id=7)
    assert len(list(store.find(1))) == 1
    assert len(list(store.find(1, channel_id=7))) == 1
    store.remove_channel(1, channel_id=7)
    with pytest.raises(StorageError):
        list(store.find(1, channel_id=7))


def test_insert_into_missing_app_raises(store):
    with pytest.raises(StorageError):
        store.insert_batch([ev(0)], 999)


def test_find_columns_ratings(store):
    store.insert_batch([
        ev(0, "rate", eid="u1", target_entity_type="item",
           target_entity_id="i1", properties=DataMap({"rating": 4.0})),
        ev(1, "rate", eid="u2", target_entity_type="item",
           target_entity_id="i2", properties=DataMap({"rating": 2.5})),
    ], 1)
    from predictionio_tpu_torch.data.eventstore import property_column

    cols = store.find_columns(1, event_names=["rate"])
    assert list(cols["entity_id"]) == ["u1", "u2"]
    assert list(cols["target_entity_id"]) == ["i1", "i2"]
    assert list(property_column(cols["properties"], "rating")) == [4.0, 2.5]


def test_reinsert_after_delete_resurrects(store):
    """find honours the log's order for tombstones, not just id sets."""
    eid = store.insert_batch([ev(0)], 1)[0]
    assert store.delete(eid, 1)
    assert list(store.find(1)) == []
    store.insert_batch([ev(0, event_id=eid)], 1)
    found = list(store.find(1))
    assert len(found) == 1 and found[0].event_id == eid
    assert store.get(eid, 1) is not None


def test_shard_refused(store):
    store.insert_batch([ev(0)], 1)
    with pytest.raises(StorageError, match="sharded"):
        store.find_columns(1, shard=(0, 2))
    assert not hasattr(store, "read_snapshot")
    assert store.snapshot_digest(1) is None


def test_idempotent_insert_and_compact(store):
    """The base class's defaults: the retry path skips stored ids (a
    deleted one is stored again), and ``compact`` drops expired events
    through the row API."""
    old = [ev(0, event_id=f"{j:032x}") for j in range(3)]
    store.insert_batch(old, 1)
    store.delete(old[1].event_id, 1)
    fresh = [dataclasses.replace(old[0]), dataclasses.replace(old[1]),
             Event(event="view", entity_type="user", entity_id="u9",
                   event_id="f" * 32)]
    assert store.insert_batch_idempotent(fresh, 1) == [
        e.event_id for e in fresh]
    ids = sorted(e.event_id for e in store.find(1))
    assert ids == sorted([old[0].event_id, old[1].event_id,
                          old[2].event_id, "f" * 32])
    with pytest.raises(StorageError):
        store.insert_batch_idempotent([ev(0)], 1)
    assert store.compact(1, ttl_days=30) == {"removed_rows": 3}
    assert [e.event_id for e in store.find(1)] == ["f" * 32]


# -- the event store against the reference's -----------------------------------

def _contract_events(n=240, seed=0):
    """(port events, reference events): the same fields, fixed ids and
    creation times, equal event times in places (the stable sort)."""
    rng = np.random.default_rng(seed)
    port, ref = [], []
    for j in range(n):
        kind = j % 5
        props = ({"rating": float(rng.integers(1, 6))} if kind == 0 else
                 {"a": int(rng.integers(9)), "n": {"x": [1, j]}}
                 if kind == 1 else {})
        kw = dict(
            event=("rate", "$set", "view", "buy", "$unset")[kind],
            entity_type="user" if kind != 3 else "customer",
            entity_id=f"u{rng.integers(0, 12)}",
            target_entity_type=None if kind in (1, 4) else "item",
            target_entity_id=None if kind in (1, 4) else f"i{j % 7}",
            event_time=T0 + dt.timedelta(hours=int(rng.integers(0, 40))),
            creation_time=T0 + dt.timedelta(seconds=j),
            tags=("t",) if j % 11 == 0 else (),
            pr_id="pr" if j % 13 == 0 else None,
            event_id=(f"{j:032x}" if j % 3 else f"user-supplied-{j}"))
        if kind == 4:
            props = {"a": None}
        port.append(Event(properties=DataMap(props), **kw))
        ref.append(RefEvent(properties=RefDataMap(props), **kw))
    return port, ref


def _filters():
    h = T0 + dt.timedelta(hours=1)
    return [
        {}, {"event_names": ["rate"]}, {"event_names": ["view", "buy"]},
        {"entity_type": "user"}, {"entity_type": "user", "entity_id": "u3"},
        {"entity_id": "u3"}, {"start_time": h + dt.timedelta(hours=9)},
        {"until_time": h + dt.timedelta(hours=20)},
        {"start_time": h + dt.timedelta(hours=5),
         "until_time": h + dt.timedelta(hours=25)},
        {"target_entity_type": None}, {"target_entity_type": "item"},
        {"target_entity_id": "i3"}, {"target_entity_id": None},
        {"limit": 17}, {"limit": 0}, {"limit": -1},
        {"reversed_order": True}, {"reversed_order": True, "limit": 9},
        {"entity_type": "user", "entity_id": "u5", "reversed_order": True,
         "event_names": ["rate", "$set"], "limit": 3},
    ]


@pytest.fixture(params=["native", "python"])
def both(tmp_path, request):
    """The port's and the reference's store on the same events, with the
    same codec kind."""
    if request.param == "native":
        _need_gxx()
    port = EvlogEvents(EvlogClient(str(tmp_path / "port"),
                                   codec=request.param))
    ref = RefEvlogEvents(RefEvlogClient(str(tmp_path / "ref"),
                                        codec="python"))
    if request.param == "native":
        ref.client.codec = request.getfixturevalue("ref_native")
    pe, re_ = _contract_events()
    for s, evs in ((port, pe), (ref, re_)):
        s.init_channel(4)
        s.insert_batch(evs[:100], 4)
        s.insert_batch(evs[100:], 4)
        for j in (5, 17, 60):
            assert s.delete(evs[j].event_id, 4)
    return port, ref, tmp_path


def test_find_equals_reference_under_every_filter(both):
    port, ref, _ = both
    for f in _filters():
        got = [e.to_json() for e in port.find(4, **f)]
        want = [e.to_json() for e in ref.find(4, **f)]
        assert got == want, f


def test_log_files_byte_identical(both):
    _, _, tmp = both
    a = (tmp / "port" / "events_4.evlog").read_bytes()
    b = (tmp / "ref" / "events_4.evlog").read_bytes()
    assert a == b and len(a) > 16


def test_each_package_reads_the_others_log(both, tmp_path):
    port, ref, tmp = both
    # the port reads the reference's directory and the reference the port's
    port_on_ref = EvlogEvents(EvlogClient(str(tmp / "ref"),
                                          codec=port.client.codec.name))
    ref_on_port = RefEvlogEvents(RefEvlogClient(str(tmp / "port"),
                                                codec="python"))
    for f in _filters()[:6]:
        assert [e.to_json() for e in port_on_ref.find(4, **f)] == \
            [e.to_json() for e in ref.find(4, **f)]
        assert [e.to_json() for e in ref_on_port.find(4, **f)] == \
            [e.to_json() for e in port.find(4, **f)]
    # a delete by one package is seen by the other
    pe, _ = _contract_events()
    assert port_on_ref.delete(pe[7].event_id, 4)
    assert ref.get(pe[7].event_id, 4) is None


def test_find_columns_equal_sqlite_after_a_stable_sort(both, tmp_path):
    port, _, _ = both
    sq = SqliteEvents(SqliteClient(str(tmp_path / "s.db")))
    sq.init_channel(4)
    pe, _ = _contract_events()
    sq.insert_batch(pe, 4)
    for j in (5, 17, 60):
        sq.delete(pe[j].event_id, 4)
    for cols in ((), ("entity_id", "target_entity_id", "properties",
                      "event_time_ms"), ("event", "creation_time_ms")):
        for f in ({}, {"event_names": ["rate"]}, {"entity_type": "user"},
                  {"entity_id": ["u1", "u3"]},
                  {"target_entity_id": ["i1", "i2"]}):
            got = port.find_columns(4, columns=cols, ordered=False, **f)
            want = sq.find_columns(4, columns=cols, ordered=False, **f)
            # both in the store's order; sqlite's rowid order, the log's
            # time order: a stable sort on (time, creation) aligns them
            keys = ("event_time_ms", "creation_time_ms")
            gk = port.find_columns(4, columns=keys, ordered=False, **f)
            wk = sq.find_columns(4, columns=keys, ordered=False, **f)
            go = np.lexsort((gk["creation_time_ms"], gk["event_time_ms"]))
            wo = np.lexsort((wk["creation_time_ms"], wk["event_time_ms"]))
            assert list(got) == list(want)
            for name in got:
                assert got[name].dtype == want[name].dtype, name
                assert got[name][go].tolist() == want[name][wo].tolist(), \
                    (name, f)


def test_list_filters_equal_sqlite(both, tmp_path):
    """The port's extension of the reference's filters: a list of entity
    or target ids (the fold-in history read's) selects as sqlite's."""
    port, _, _ = both
    sq = SqliteEvents(SqliteClient(str(tmp_path / "s.db")))
    sq.init_channel(4)
    pe, _ = _contract_events()
    sq.insert_batch(pe, 4)
    for j in (5, 17, 60):
        sq.delete(pe[j].event_id, 4)
    for f in ({"entity_id": ["u2", "u7", "nobody"]}, {"entity_id": []},
              {"entity_type": "user", "entity_id": ["u1"]},
              {"target_entity_id": ["i4", "i6"],
               "target_entity_type": "item"}):
        assert sorted(e.event_id for e in port.find(4, **f)) == \
            sorted(e.event_id for e in sq.find(4, **f)), f


# -- training, the CLI and the event server on an evlog source ------------------

def _store_config(tmp, events: str, codec="python"):
    meta = {"TYPE": "sqlite", "PATH": str(tmp / "meta.db")}
    sources = {"META": meta,
               "MODELS": {"TYPE": "localfs", "PATH": str(tmp / "models")}}
    if events == "evlog":
        sources["EV"] = {"TYPE": "evlog", "PATH": str(tmp / "evlog"),
                         "CODEC": codec}
    else:
        sources["EV"] = {"TYPE": "sqlite", "PATH": str(tmp / "ev.db")}
    return {"sources": sources, "repositories": {
        "METADATA": {"NAME": "pio", "SOURCE": "META"},
        "EVENTDATA": {"NAME": "pio", "SOURCE": "EV"},
        "MODELDATA": {"NAME": "pio", "SOURCE": "MODELS"}}}


@pytest.fixture()
def reset_storage():
    from predictionio_tpu_torch.data import eventstore

    yield
    Storage.reset()
    eventstore.clear_cache()


def _rate_events(n=600, seed=4):
    rng = np.random.default_rng(seed)
    return [Event(event="rate", entity_type="user",
                  entity_id=f"u{rng.integers(0, 40)}",
                  target_entity_type="item",
                  target_entity_id=f"i{rng.integers(0, 30)}",
                  properties={"rating": float(rng.integers(1, 6))},
                  event_time=T0 + dt.timedelta(minutes=int(j // 3)),
                  creation_time=T0, event_id=f"{j:032x}")
            for j in range(n)]


def test_als_trained_from_evlog_equals_sqlite(tmp_path, capsys,
                                              reset_storage):
    """The same events (equal event times in threes, so the log's stable
    time sort and sqlite's rowid order differ) train the same model on
    the CPU: the sorted vocabularies give the same indices in any row
    order, and the factors agree within 1e-5 (f32 sums in another
    order)."""
    from predictionio_tpu_torch.cli.main import main
    from predictionio_tpu_torch.data import eventstore
    from predictionio_tpu_torch.workflow.serialization import load_model

    evs = _rate_events()
    variant = tmp_path / "engine.json"
    variant.write_text(json.dumps({
        "datasource": {"params": {"appName": "Same"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 4, "numIterations": 5, "seed": 3}}]}))
    models, lines = {}, {}
    for kind in ("sqlite", "evlog"):
        d = tmp_path / kind
        Storage.configure(_store_config(d, kind))
        eventstore.clear_cache()
        app_id = Storage.get_meta_data_apps().insert(App(id=0, name="Same"))
        store = Storage.get_events()
        store.init_channel(app_id)
        # the log gets them in reverse: the read must not care
        store.insert_batch(evs if kind == "sqlite" else evs[::-1], app_id)
        out = d / "m.npz"
        capsys.readouterr()
        assert main(["train", "--variant", str(variant), "--out", str(out),
                     "--device", "cpu"]) == 0
        lines[kind] = json.loads(capsys.readouterr().out.splitlines()[-1])
        models[kind] = load_model(str(out), device="cpu")
        Storage.reset()
    assert lines["evlog"]["nnz"] == lines["sqlite"]["nnz"] == len(evs)
    assert lines["evlog"]["ingest"]["scan_s"] > 0
    a, b = models["sqlite"], models["evlog"]
    assert list(a.user_vocab) == list(b.user_vocab)
    assert list(a.item_vocab) == list(b.item_vocab)
    for x, y in ((a.U, b.U), (a.V, b.V)):
        x, y = np.asarray(x), np.asarray(y)
        assert np.isfinite(x).all()
        assert np.abs(x - y).max() <= 1e-5 * max(1.0, np.abs(x).max())


def test_cli_and_event_server_on_an_evlog_source(tmp_path, capsys,
                                                 reset_storage):
    """``app new`` (init_channel), ``import``, ``export``, the event
    server's POST/GET/DELETE ``/events.json`` (the write buffer's flush
    into ``insert_batch``), ``compact``, ``app data-delete``
    (remove_channel) and ``app delete`` on an evlog EVENTDATA source."""
    from predictionio_tpu_torch.cli.main import main
    from predictionio_tpu_torch.data import eventstore
    from predictionio_tpu_torch.server.event_server import EventServer

    Storage.configure(_store_config(tmp_path, "evlog"))
    eventstore.clear_cache()
    assert main(["app", "new", "Log", "--access-key", "k"]) == 0
    app_id = Storage.get_meta_data_apps().get_by_name("Log").id
    path = tmp_path / "evlog" / f"events_{app_id}.evlog"
    assert path.read_bytes() == evlog.HEADER
    src = tmp_path / "in.jsonl"
    evs = _rate_events(40)
    src.write_text("".join(e.to_json() + "\n" for e in evs))
    assert main(["import", "--appname", "Log", "--input", str(src)]) == 0

    def call(port, method, target, body=None):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        c.request(method, target, body=None if body is None
                  else json.dumps(body))
        r = c.getresponse()
        return r.status, json.loads(r.read() or b"null")

    async def serve():
        server = EventServer()
        port = await server.start("127.0.0.1", 0)
        loop = asyncio.get_running_loop()
        try:
            def drive():
                st, body = call(port, "POST", "/events.json?accessKey=k", {
                    "event": "buy", "entityType": "user", "entityId": "u1",
                    "targetEntityType": "item", "targetEntityId": "i2",
                    "eventTime": "2024-01-02T00:00:00.000Z"})
                assert st == 201, body
                eid = body["eventId"]
                got = call(port, "GET", f"/events/{eid}.json?accessKey=k")
                assert got[0] == 200 and got[1]["event"] == "buy"
                gone = evs[0].event_id
                assert call(port, "DELETE",
                            f"/events/{gone}.json?accessKey=k")[0] == 200
                assert call(port, "GET",
                            f"/events/{gone}.json?accessKey=k")[0] == 404
                st, found = call(port, "GET", "/events.json?accessKey=k"
                                 "&entityType=user&entityId=u1&limit=-1")
                return eid, st, found
            return await loop.run_in_executor(None, drive)
        finally:
            await server.close()

    eid, st, found = asyncio.run(serve())
    want = [e for e in evs[1:] if e.entity_id == "u1"]
    assert st == 200 and len(found) == len(want) + 1
    out = tmp_path / "out.jsonl"
    assert main(["export", "--appname", "Log", "--output", str(out)]) == 0
    exported = [json.loads(x) for x in out.read_text().splitlines()]
    assert sorted(x["eventId"] for x in exported) == sorted(
        [e.event_id for e in evs[1:]] + [eid])
    capsys.readouterr()
    assert main(["compact", "--appname", "Log", "--ttl-days", "1"]) == 0
    assert '"removed_rows": 40' in capsys.readouterr().out
    assert list(Storage.get_events().find(app_id)) == []
    assert main(["app", "data-delete", "Log", "--force"]) == 0
    assert path.read_bytes() == evlog.HEADER
    assert main(["app", "delete", "Log", "--force"]) == 0
    assert not path.exists()


# -- the registry ----------------------------------------------------------------

def test_registry_serves_evlog_for_eventdata_only(tmp_path, monkeypatch,
                                                  reset_storage):
    assert port_registry._NOT_PORTED == {
        "parquet": "storage/parquet_events.py"}
    monkeypatch.setenv("PIO_HOME", str(tmp_path / "home"))
    cfg = _store_config(tmp_path, "evlog")
    del cfg["sources"]["EV"]["PATH"]
    Storage.configure(cfg)
    store = Storage.get_events()
    assert isinstance(store, EvlogEvents)
    assert store.client.base_dir == str(tmp_path / "home" / "evlog")
    assert store.client.codec.name == "python"
    cfg["repositories"]["METADATA"]["SOURCE"] = "EV"
    Storage.configure(cfg)
    with pytest.raises(StorageError, match="only supports EVENTDATA"):
        Storage.get_meta_data_apps()
