"""The port's group-commit WriteBuffer (``data/write_buffer``), on a
real sqlite event store: concurrent submits coalesce into fewer flushes,
a full queue raises BufferFull with a retry_after, ``stop()`` drains
everything, a flush that fails once is retried without duplicates, and
16 threads lose and duplicate nothing."""

import sys
import threading

import pytest

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.write_buffer import BufferFull, WriteBuffer
from predictionio_tpu_torch.storage.base import StorageError
from predictionio_tpu_torch.storage.sqlite_backend import (
    SqliteClient, SqliteEvents,
)

APP = 1


@pytest.fixture()
def store(tmp_path):
    s = SqliteEvents(SqliteClient(str(tmp_path / "wb.db")))
    s.init_channel(APP)
    yield s
    s.close()


def _events(tag, n):
    return [Event(event="rate", entity_type="user", entity_id=f"{tag}-{i}",
                  target_entity_type="item", target_entity_id="i",
                  properties={"rating": 1.0}) for i in range(n)]


def _stored(store):
    return [e.entity_id for e in store.find(APP)]


def test_concurrent_submits_coalesce(store):
    gate = threading.Event()
    calls = []

    class Slow:
        def insert_batch(self, events, app_id, channel_id=None):
            calls.append(len(events))
            gate.wait(5)           # the first flush holds the writer
            return store.insert_batch(events, app_id, channel_id)

    buf = WriteBuffer(lambda: Slow(), flush_max=1000, linger_s=0.05)
    futures = [buf.submit(_events(f"s{i}", 3), APP) for i in range(20)]
    gate.set()
    ids = [f.result(timeout=10) for f in futures]
    buf.stop()
    assert all(len(x) == 3 for x in ids)
    assert sum(calls) == 60 and buf.flushes == len(calls) < 20
    assert len(set(_stored(store))) == 60


def test_full_queue_raises_buffer_full_with_retry_after(store):
    gate = threading.Event()

    class Blocked:
        def insert_batch(self, events, app_id, channel_id=None):
            gate.wait(5)
            return store.insert_batch(events, app_id, channel_id)

    buf = WriteBuffer(lambda: Blocked(), queue_max=10, flush_max=4,
                      linger_s=0.0)
    first = buf.submit(_events("a", 6), APP)
    second = buf.submit(_events("b", 4), APP)       # exactly at the bound
    with pytest.raises(BufferFull) as e:
        buf.submit(_events("c", 1), APP)
    assert e.value.depth == 10 and e.value.retry_after >= 1
    gate.set()
    assert len(first.result(timeout=10)) == 6
    assert len(second.result(timeout=10)) == 4
    buf.stop()
    # the bound frees up once flushed
    assert sorted(_stored(store)) == sorted(
        e.entity_id for e in _events("a", 6) + _events("b", 4))


def test_stop_drains_everything_then_refuses(store):
    buf = WriteBuffer(lambda: store, flush_max=7, linger_s=0.01)
    futures = [buf.submit(_events(f"d{i}", 5), APP) for i in range(30)]
    buf.stop(drain=True)
    assert all(f.done() and len(f.result()) == 5 for f in futures)
    assert len(_stored(store)) == 150
    with pytest.raises(StorageError, match="shut down"):
        buf.submit(_events("late", 1), APP)


def test_failed_flush_is_retried_idempotently(store):
    """The first attempt commits and then fails (an ambiguous fault); the
    retry must neither lose nor duplicate."""
    state = {"calls": 0}

    class Flaky:
        def insert_batch(self, events, app_id, channel_id=None):
            state["calls"] += 1
            store.insert_batch(events, app_id, channel_id)
            raise StorageError("connection reset after commit")

        def insert_batch_idempotent(self, events, app_id, channel_id=None):
            state["calls"] += 1
            return store.insert_batch_idempotent(events, app_id, channel_id)

    buf = WriteBuffer(lambda: Flaky(), retries=2, backoff_s=0.0)
    ids = buf.submit(_events("r", 4), APP).result(timeout=10)
    buf.stop()
    assert state["calls"] == 2
    assert sorted(e.event_id for e in store.find(APP)) == sorted(ids)


def test_exhausted_retries_fail_the_future(store):
    class Broken:
        def insert_batch(self, *a, **k):
            raise OSError("disk gone")

        insert_batch_idempotent = insert_batch

    buf = WriteBuffer(lambda: Broken(), retries=1, backoff_s=0.0)
    with pytest.raises(StorageError, match="disk gone"):
        buf.submit(_events("x", 2), APP).result(timeout=10)
    buf.stop()


def test_sixteen_threads_no_loss_no_duplicates(store):
    buf = WriteBuffer(lambda: store, queue_max=100_000, flush_max=64,
                      linger_s=0.001)
    acked, errors = [], []
    lock = threading.Lock()

    def writer(t):
        for j in range(25):
            try:
                ids = buf.submit(_events(f"t{t}-{j}", 4), APP).result(
                    timeout=30)
            except Exception as e:     # noqa: BLE001 — asserted below
                errors.append(e)
                return
            with lock:
                acked.extend(ids)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    buf.stop()
    assert not any(th.is_alive() for th in threads)
    assert not errors
    stored = [e.event_id for e in store.find(APP)]
    assert len(acked) == len(set(acked)) == 16 * 25 * 4
    assert sorted(stored) == sorted(acked)
    assert buf.flushes < 16 * 25
