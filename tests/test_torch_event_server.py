"""The port's Event Server against the reference's, request for request.

Each case of ``tests/test_event_server.py`` (stats and plugins aside)
runs against both servers, each on its own sqlite store set up alike
(the same app, access keys and channel): the reference's through its
aiohttp ``TestClient``, the port's over a socket. Statuses must be
equal, and JSON bodies equal once the generated event ids and creation
times are masked. The group-commit paths (429 on a full queue with
Retry-After, 503 after a failed flush, the unbuffered write) are held
the same way, and events posted through either server are read
identically by the other package's ``SqliteEvents``.
"""

import base64
import datetime as dt
import re

import aiohttp
import pytest
from aiohttp.test_utils import TestClient, TestServer

from predictionio_tpu.server.event_server import (
    create_event_server as ref_create_event_server,
)
from predictionio_tpu.storage import (
    AccessKey as RefAccessKey, App as RefApp, Channel as RefChannel,
    Storage as RefStorage,
)
from predictionio_tpu.storage import sqlite_backend as ref_sqlite
from predictionio_tpu.utils.server_config import (
    IngestConfig as RefIngestConfig,
)
from predictionio_tpu_torch.server.event_server import EventServer
from predictionio_tpu_torch.storage import sqlite_backend as port_sqlite
from predictionio_tpu_torch.storage.base import (
    AccessKey, App, Channel, StorageError,
)
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.server_config import IngestConfig

pytestmark = pytest.mark.anyio

KEY, RESTRICTED = "key-all", "key-view-only"
EV = {"event": "view", "entityType": "user", "entityId": "u1",
      "targetEntityType": "item", "targetEntityId": "i1",
      "eventTime": "2024-02-01T10:00:00.000Z"}


def _config(path):
    return {"sources": {"DB": {"TYPE": "sqlite", "PATH": str(path)}},
            "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                             for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}}


def _setup(storage, app_cls, key_cls, channel_cls, path):
    storage.configure(_config(path))
    app_id = storage.get_meta_data_apps().insert(app_cls(id=0, name="es"))
    storage.get_events().init_channel(app_id)
    keys = storage.get_meta_data_access_keys()
    keys.insert(key_cls(key=KEY, appid=app_id, events=()))
    keys.insert(key_cls(key=RESTRICTED, appid=app_id, events=("view",)))
    cid = storage.get_meta_data_channels().insert(
        channel_cls(id=0, name="ch1", appid=app_id))
    storage.get_events().init_channel(app_id, cid)
    return app_id, cid


@pytest.fixture()
def stores(tmp_path):
    ref = _setup(RefStorage, RefApp, RefAccessKey, RefChannel,
                 tmp_path / "ref.db")
    port = _setup(Storage, App, AccessKey, Channel, tmp_path / "port.db")
    assert ref == port
    yield {"ref": tmp_path / "ref.db", "port": tmp_path / "port.db",
           "app_id": ref[0], "channel_id": ref[1]}
    RefStorage.reset()
    Storage.reset()


class Sides:
    """One call function per server: ``call(method, path, json=...,
    headers=...) -> (status, body, headers)``."""

    def __init__(self, ref_client, port, session):
        self.ref_client, self.port, self.session = ref_client, port, session

    async def ref(self, method, path, **kw):
        resp = await self.ref_client.request(method, path, **kw)
        try:
            body = await resp.json()
        except (aiohttp.ContentTypeError, ValueError):
            body = None
        return resp.status, body, resp.headers

    async def port_call(self, method, path, **kw):
        async with self.session.request(
                method, f"http://127.0.0.1:{self.port}{path}", **kw) as resp:
            return resp.status, await resp.json(), resp.headers


async def _open(ref_ingest=None, port_ingest=None):
    ref_client = TestClient(TestServer(ref_create_event_server(
        stats=True, ingest=ref_ingest)))
    await ref_client.start_server()
    port_server = EventServer(ingest=port_ingest or IngestConfig())
    port = await port_server.start("127.0.0.1", 0)
    session = aiohttp.ClientSession()
    return ref_client, port_server, session, Sides(ref_client, port, session)


async def _close(ref_client, port_server, session):
    await session.close()
    await port_server.close()
    await ref_client.close()


@pytest.fixture()
async def sides(stores):
    ref_client, port_server, session, s = await _open()
    yield s
    await _close(ref_client, port_server, session)


def _mask(body):
    """Generated values masked: event ids and creation times."""
    if isinstance(body, list):
        return [_mask(b) for b in body]
    if isinstance(body, dict):
        return {k: ("<generated>" if k in ("eventId", "creationTime")
                    else _mask(v)) for k, v in body.items()}
    return body


async def _both(sides, case):
    """Run ``case(call)`` against both servers; the observations (status
    and masked body of every request) must be equal."""
    got = {}
    for name, call in (("ref", sides.ref), ("port", sides.port_call)):
        seen = []

        async def observe(method, path, _call=call, _seen=seen, **kw):
            status, body, headers = await _call(method, path, **kw)
            _seen.append((method, re.sub(r"[0-9a-f]{32}", "<id>",
                                         path.split("?")[0]),
                          status, _mask(body)))
            return status, body, headers

        await case(observe)
        got[name] = seen
    assert got["port"] == got["ref"]
    return got["port"]


async def test_root_alive(sides):
    async def case(call):
        await call("GET", "/")

    (obs,) = await _both(sides, case)
    assert obs[2:] == (200, {"status": "alive"})


async def test_create_and_get_event(sides):
    async def case(call):
        status, body, _ = await call("POST", f"/events.json?accessKey={KEY}",
                                     json=EV)
        assert status == 201
        await call("GET", f"/events/{body['eventId']}.json?accessKey={KEY}")
        await call("GET", f"/events/nope.json?accessKey={KEY}")

    obs = await _both(sides, case)
    assert [o[2] for o in obs] == [201, 200, 404]
    assert obs[1][3]["entityId"] == "u1"
    assert obs[1][3]["eventTime"] == "2024-02-01T10:00:00.000+00:00"


async def test_auth_missing_invalid_and_basic(sides):
    token = base64.b64encode(f"{KEY}:".encode()).decode()

    async def case(call):
        await call("POST", "/events.json", json=EV)
        await call("POST", "/events.json?accessKey=WRONG", json=EV)
        await call("POST", "/events.json", json=EV,
                   headers={"Authorization": f"Basic {token}"})
        await call("POST", "/events.json", json=EV,
                   headers={"Authorization": "Basic !!notbase64"})

    obs = await _both(sides, case)
    assert [o[2] for o in obs] == [401, 401, 201, 401]
    assert obs[0][3] == {"message": "Missing accessKey."}


async def test_restricted_key_forbids_event(sides):
    async def case(call):
        await call("POST", f"/events.json?accessKey={RESTRICTED}", json=EV)
        await call("POST", f"/events.json?accessKey={RESTRICTED}",
                   json=dict(EV, event="buy"))

    obs = await _both(sides, case)
    assert [o[2] for o in obs] == [201, 403]
    assert "not allowed" in obs[1][3]["message"]


async def test_invalid_event_rejected(sides):
    async def case(call):
        await call("POST", f"/events.json?accessKey={KEY}",
                   json={"event": "$set", "entityType": "user"})
        await call("POST", f"/events.json?accessKey={KEY}",
                   json={"event": "pio_bad", "entityType": "user",
                         "entityId": "u1"})
        await call("POST", f"/events.json?accessKey={KEY}",
                   data=b"{not json", headers={
                       "Content-Type": "application/json"})

    obs = await _both(sides, case)
    assert [o[2] for o in obs] == [400, 400, 400]


async def test_find_events_with_filters(sides):
    async def case(call):
        for i in range(3):
            await call("POST", f"/events.json?accessKey={KEY}",
                       json=dict(EV, entityId=f"u{i}",
                                 eventTime=f"2024-01-0{i + 1}T00:00:00Z"))
        for q in ("", "&entityId=u1", "&startTime=2024-01-02T00:00:00Z",
                  "&untilTime=2024-01-03T00:00:00Z", "&limit=2",
                  "&event=view&entityType=user", "&targetEntityId=i1",
                  "&entityId=zzz", "&reversed=true",
                  "&entityType=user&entityId=u1&reversed=true",
                  "&limit=notanumber", "&startTime=garbage"):
            await call("GET", f"/events.json?accessKey={KEY}{q}")

    obs = await _both(sides, case)
    assert [o[2] for o in obs[3:]] == [200, 200, 200, 200, 200, 200, 200,
                                       404, 400, 200, 400, 400]
    assert [len(o[3]) for o in obs[3:10]] == [3, 1, 2, 2, 2, 3, 3]


async def test_delete_event(sides):
    async def case(call):
        _, body, _ = await call("POST", f"/events.json?accessKey={KEY}",
                                json=EV)
        path = f"/events/{body['eventId']}.json?accessKey={KEY}"
        await call("DELETE", path)
        await call("DELETE", path)
        await call("GET", path)

    obs = await _both(sides, case)
    assert [o[2] for o in obs] == [201, 200, 404, 404]
    assert obs[1][3] == {"message": "Found"}


async def test_channel_isolation(sides):
    async def case(call):
        await call("POST", f"/events.json?accessKey={KEY}&channel=ch1",
                   json=EV)
        await call("GET", f"/events.json?accessKey={KEY}")
        await call("GET", f"/events.json?accessKey={KEY}&channel=ch1")
        await call("POST", f"/events.json?accessKey={KEY}&channel=nope",
                   json=EV)

    obs = await _both(sides, case)
    assert [o[2] for o in obs] == [201, 404, 200, 401]
    assert len(obs[2][3]) == 1


async def test_batch_partially_malformed(sides):
    batch = [dict(EV, entityId="ok1"),
             {"event": "view", "entityType": "user"},   # no entityId
             dict(EV, entityId="ok2"), "not an object",
             dict(EV, entityId="ok3", properties=[1])]

    async def case(call):
        await call("POST", f"/batch/events.json?accessKey={KEY}",
                   json=batch)
        await call("GET", f"/events.json?accessKey={KEY}")

    obs = await _both(sides, case)
    assert [r["status"] for r in obs[0][3]] == [201, 400, 201, 400, 400]
    assert len(obs[1][3]) == 2


async def test_batch_forbidden_event_status(sides):
    async def case(call):
        await call("POST", f"/batch/events.json?accessKey={RESTRICTED}",
                   json=[dict(EV), dict(EV, event="buy")])

    obs = await _both(sides, case)
    assert [r["status"] for r in obs[0][3]] == [201, 403]


async def test_batch_too_large_or_not_a_list(sides):
    async def case(call):
        await call("POST", f"/batch/events.json?accessKey={KEY}",
                   json=[dict(EV, entityId=f"u{i}") for i in range(51)])
        await call("POST", f"/batch/events.json?accessKey={KEY}",
                   json={"event": "view"})

    obs = await _both(sides, case)
    assert [o[2] for o in obs] == [400, 400]
    assert "50" in obs[0][3]["message"]


@pytest.mark.parametrize("buffered", [True, False])
async def test_storage_failure_status(stores, monkeypatch, buffered):
    """A failed write answers 503 after the buffer's retries (500 with
    the buffer off; 503 per event in a batch either way), in both
    servers."""
    ref_client, port_server, session, s = await _open(
        RefIngestConfig(buffer=buffered, retries=1, backoff_s=0.0),
        IngestConfig(buffer=buffered, retries=1, backoff_s=0.0))

    def fail(*_a, **_k):
        raise StorageError("disk on fire")

    def ref_fail(*_a, **_k):
        from predictionio_tpu.storage.base import StorageError as RefError
        raise RefError("disk on fire")

    for cls, fn in ((port_sqlite.SqliteEvents, fail),
                    (ref_sqlite.SqliteEvents, ref_fail)):
        monkeypatch.setattr(cls, "insert_batch", fn)
        monkeypatch.setattr(cls, "insert_batch_idempotent", fn)
    try:
        async def case(call):
            await call("POST", f"/events.json?accessKey={KEY}", json=EV)
            await call("POST", f"/batch/events.json?accessKey={KEY}",
                       json=[EV, {"event": "view"}])

        obs = await _both(s, case)
    finally:
        await _close(ref_client, port_server, session)
    assert obs[0][2] == (503 if buffered else 500)
    assert [r["status"] for r in obs[1][3]] == [503, 400]


async def test_full_queue_sheds_429_with_retry_after(stores):
    ref_client, port_server, session, s = await _open(
        RefIngestConfig(queue_max=1), IngestConfig(queue_max=1))
    try:
        async def case(call):
            _, _, headers = await call(
                "POST", f"/batch/events.json?accessKey={KEY}",
                json=[EV, dict(EV, entityId="u2")])
            assert int(headers["Retry-After"]) >= 1

        obs = await _both(s, case)
    finally:
        await _close(ref_client, port_server, session)
    assert obs[0][2] == 429


def _by_id(events):
    return {e.event_id: (e.event, e.entity_type, e.entity_id,
                         e.target_entity_type, e.target_entity_id,
                         dict(e.properties.fields), e.event_time,
                         e.creation_time, tuple(e.tags)) for e in events}


async def test_each_package_reads_what_the_other_server_wrote(stores,
                                                              sides):
    batch = [dict(EV, entityId=f"u{i}", properties={"rating": i + 0.5},
                  eventTime=f"2024-03-0{i + 1}T12:00:00.123+02:00",
                  tags=["a", "b"]) for i in range(5)]
    for call in (sides.ref, sides.port_call):
        status, body, _ = await call(
            "POST", f"/batch/events.json?accessKey={KEY}", json=batch)
        assert status == 200 and all(r["status"] == 201 for r in body)
    app_id = stores["app_id"]
    for path in (stores["ref"], stores["port"]):
        ref_read = _by_id(ref_sqlite.SqliteEvents(
            ref_sqlite.SqliteClient(str(path))).find(app_id))
        port_read = _by_id(port_sqlite.SqliteEvents(
            port_sqlite.SqliteClient(str(path))).find(app_id))
        assert len(port_read) == 5 and port_read == ref_read
        for row in port_read.values():
            assert row[6].utcoffset() == dt.timedelta(hours=2)
