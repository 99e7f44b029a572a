"""The port's webhook connectors and its event server's
``/webhooks/<name>.json`` routes, held against the reference's on the
same payloads: each connector's event dict or its ConnectorError, and
each request's status and body (the cases of
``tests/test_event_server.py``'s webhook tests and their error paths)."""

import re

import aiohttp
import pytest
from aiohttp.test_utils import TestClient, TestServer

from predictionio_tpu.data import webhooks as ref_webhooks
from predictionio_tpu.server.event_server import (
    create_event_server as ref_create_event_server,
)
from predictionio_tpu.storage import (
    AccessKey as RefAccessKey, App as RefApp, Channel as RefChannel,
    Storage as RefStorage,
)
from predictionio_tpu_torch.data import webhooks as port_webhooks
from predictionio_tpu_torch.server.event_server import EventServer
from predictionio_tpu_torch.storage.base import AccessKey, App, Channel
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.server_config import IngestConfig

pytestmark = pytest.mark.anyio

KEY = "hook-key"

USER_ACTION = {
    "type": "userAction", "userId": "as34smg4", "event": "do_something",
    "context": {"ip": "24.5.68.47", "prop1": 2.345, "prop2": "value1"},
    "anotherProperty1": 100, "anotherProperty2": "optional1",
    "timestamp": "2015-01-02T00:30:12.984Z"}
USER_ACTION_ITEM = {
    "type": "userActionItem", "userId": "as34smg4", "event": "rate",
    "itemId": "kfjd312bc", "context": {"ip": "1.23.4.56"},
    "anotherPropertyA": 4.567, "anotherPropertyB": False,
    "timestamp": "2015-01-15T04:20:23.567Z"}
MAILCHIMP_SUBSCRIBE = {
    "type": "subscribe", "fired_at": "2009-03-26 21:35:57",
    "data[id]": "8a25ff1d98", "data[list_id]": "a6b5da1054",
    "data[email]": "api@mailchimp.com", "data[email_type]": "html",
    "data[merges][EMAIL]": "api@mailchimp.com",
    "data[merges][FNAME]": "MailChimp", "data[merges][LNAME]": "API",
    "data[merges][INTERESTS]": "Group1,Group2",
    "data[ip_opt]": "10.20.10.30", "data[ip_signup]": "10.20.10.30"}

#: (connector, payload) -> an event dict or a ConnectorError
CONNECTOR_CASES = {
    "examplejson_user_action": ("examplejson", USER_ACTION),
    "examplejson_user_action_item": ("examplejson", USER_ACTION_ITEM),
    "examplejson_no_timestamp": ("examplejson", {
        k: v for k, v in USER_ACTION.items() if k != "timestamp"}),
    "examplejson_missing_user": ("examplejson", {
        k: v for k, v in USER_ACTION.items() if k != "userId"}),
    "examplejson_missing_item": ("examplejson", {
        k: v for k, v in USER_ACTION_ITEM.items() if k != "itemId"}),
    "examplejson_unknown_type": ("examplejson", dict(USER_ACTION,
                                                     type="other")),
    "exampleform_user_action": ("exampleform", {
        "type": "userAction", "userId": "as34smg4",
        "event": "do_something",
        "context[ip]": "24.5.68.47", "context": '{"ip": "24.5.68.47"}',
        "anotherProperty1": "100", "anotherProperty2": "optional1",
        "timestamp": "2015-01-02T00:30:12.984Z"}),
    "exampleform_user_action_item": ("exampleform", {
        "type": "userActionItem", "userId": "u9", "event": "rate",
        "itemId": "i3", "context": "not json", "anotherPropertyA": "4.5",
        "anotherPropertyB": "true"}),
    "exampleform_unknown_type": ("exampleform", {"type": "x"}),
    "segmentio_identify": ("segmentio", {
        "version": "2", "type": "identify", "userId": "019mr8mf4r",
        "traits": {"email": "achilles@segment.com", "name": "Achilles"},
        "context": {"ip": "8.8.8.8"},
        "timestamp": "2012-12-02T00:30:08.276Z"}),
    "segmentio_track": ("segmentio", {
        "version": "2", "type": "track", "userId": "u42",
        "event": "Signed Up", "timestamp": "2015-01-02T00:30:12.984Z",
        "properties": {"plan": "pro"},
        "sent_at": "2015-01-02T00:30:12.984Z"}),
    "segmentio_alias": ("segmentio", {
        "version": "2", "type": "alias", "anonymousId": "anon-1",
        "previousId": "p-0"}),
    "segmentio_page": ("segmentio", {
        "version": "2", "type": "page", "user_id": "u7", "name": "Home",
        "properties": {"title": "Welcome"}}),
    "segmentio_screen": ("segmentio", {
        "version": "2", "type": "screen", "anonymous_id": "a8",
        "name": "Main"}),
    "segmentio_group": ("segmentio", {
        "version": "2", "type": "group", "userId": 12,
        "group_id": "g1", "traits": {"size": 3}}),
    "segmentio_no_version": ("segmentio", {"type": "track",
                                           "userId": "u1"}),
    "segmentio_unknown_type": ("segmentio", {"version": "2",
                                             "type": "nope",
                                             "userId": "u1"}),
    "segmentio_no_user": ("segmentio", {"version": "2",
                                        "type": "identify"}),
    "mailchimp_subscribe": ("mailchimp", MAILCHIMP_SUBSCRIBE),
    "mailchimp_unsubscribe": ("mailchimp", dict(
        MAILCHIMP_SUBSCRIBE, type="unsubscribe",
        **{"data[action]": "unsub", "data[reason]": "manual"})),
    "mailchimp_profile": ("mailchimp", dict(MAILCHIMP_SUBSCRIBE,
                                            type="profile")),
    "mailchimp_upemail": ("mailchimp", {
        "type": "upemail", "fired_at": "2009-03-26 22:15:09",
        "data[list_id]": "a6b5da1054", "data[new_id]": "51da8c3259",
        "data[new_email]": "api+new@mailchimp.com",
        "data[old_email]": "api+old@mailchimp.com"}),
    "mailchimp_cleaned": ("mailchimp", {
        "type": "cleaned", "fired_at": "2009-03-26 22:01:00",
        "data[list_id]": "a6b5da1054", "data[campaign_id]": "4fjk2ma9xd",
        "data[reason]": "hard", "data[email]": "api+cleaned@mailchimp.com"}),
    "mailchimp_campaign": ("mailchimp", {
        "type": "campaign", "fired_at": "2009-03-26 21:31:21",
        "data[id]": "5aa2102003", "data[subject]": "Test Campaign Subject",
        "data[status]": "sent", "data[reason]": "",
        "data[list_id]": "a6b5da1054"}),
    "mailchimp_no_type": ("mailchimp", {"fired_at": "2009-03-26 21:35:57"}),
    "mailchimp_unknown_type": ("mailchimp", {"type": "other"}),
    "mailchimp_no_fired_at": ("mailchimp", {"type": "subscribe",
                                            "data[id]": "x"}),
    "mailchimp_bad_fired_at": ("mailchimp", dict(MAILCHIMP_SUBSCRIBE,
                                                 fired_at="yesterday")),
    "mailchimp_no_id": ("mailchimp", {"type": "subscribe",
                                      "fired_at": "2009-03-26 21:35:57"}),
}


def _outcome(module, name, payload):
    connector = module.get_connector(name)
    try:
        return ("event", connector.to_event_dict(dict(payload)))
    except module.ConnectorError as e:
        return ("error", str(e))


@pytest.mark.parametrize("case", sorted(CONNECTOR_CASES))
def test_connector_matches_reference(case):
    name, payload = CONNECTOR_CASES[case]
    got = _outcome(port_webhooks, name, payload)
    assert got == _outcome(ref_webhooks, name, payload)
    if got[0] == "event":
        # the dict builds the same Event in both packages
        port_ev = port_webhooks.get_connector(name).to_event(dict(payload))
        ref_ev = ref_webhooks.get_connector(name).to_event(dict(payload))
        # a payload without a time gets each Event's own "now"
        now = () if "eventTime" in got[1] else ("eventTime",)
        assert _mask(port_ev.to_dict(), now) == _mask(ref_ev.to_dict(), now)


def test_registry_matches_reference():
    for name in ("segmentio", "mailchimp", "examplejson", "exampleform",
                 "unknown"):
        port_c = port_webhooks.get_connector(name)
        ref_c = ref_webhooks.get_connector(name)
        assert (port_c is None) == (ref_c is None)
        if port_c is not None:
            assert port_c.form_based == ref_c.form_based


# -- the event server's routes ------------------------------------------------

def _config(path):
    return {"sources": {"DB": {"TYPE": "sqlite", "PATH": str(path)}},
            "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                             for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}}


def _setup(storage, app_cls, key_cls, channel_cls, path):
    storage.configure(_config(path))
    app_id = storage.get_meta_data_apps().insert(app_cls(id=0, name="hooks"))
    storage.get_events().init_channel(app_id)
    storage.get_meta_data_access_keys().insert(
        key_cls(key=KEY, appid=app_id, events=()))
    cid = storage.get_meta_data_channels().insert(
        channel_cls(id=0, name="side", appid=app_id))
    storage.get_events().init_channel(app_id, cid)
    return app_id, cid


@pytest.fixture()
def stores(tmp_path):
    ref = _setup(RefStorage, RefApp, RefAccessKey, RefChannel,
                 tmp_path / "ref.db")
    port = _setup(Storage, App, AccessKey, Channel, tmp_path / "port.db")
    assert ref == port
    yield {"app_id": ref[0], "channel_id": ref[1]}
    RefStorage.reset()
    Storage.reset()


def _mask(body, also=()):
    if isinstance(body, list):
        return [_mask(b, also) for b in body]
    if isinstance(body, dict):
        return {k: ("<generated>" if k in ("eventId", "creationTime", *also)
                    else _mask(v, also)) for k, v in body.items()}
    return body


@pytest.fixture(params=["buffered", "direct"])
async def sides(request, stores):
    """``call(side, method, path, **kw) -> (status, body)`` for the
    reference's server (aiohttp test client) and the port's (a socket)."""
    buffered = request.param == "buffered"
    ref_client = TestClient(TestServer(ref_create_event_server()))
    await ref_client.start_server()
    port_server = EventServer(ingest=IngestConfig(buffer=buffered,
                                                  linger_s=0.0))
    port = await port_server.start("127.0.0.1", 0)
    session = aiohttp.ClientSession()

    async def call(side, method, path, **kw):
        if side == "ref":
            resp = await ref_client.request(method, path, **kw)
            try:
                return resp.status, await resp.json()
            except (aiohttp.ContentTypeError, ValueError):
                return resp.status, None
        async with session.request(
                method, f"http://127.0.0.1:{port}{path}", **kw) as resp:
            return resp.status, await resp.json()

    yield call
    await session.close()
    await port_server.close()
    await ref_client.close()


async def _both(call, case):
    """``case(observe)`` against both servers: every request's status and
    masked body equal."""
    got = {}
    for side in ("ref", "port"):
        seen = []

        async def observe(method, path, _side=side, _seen=seen, **kw):
            status, body = await call(_side, method, path, **kw)
            _seen.append((method, re.sub(r"[0-9a-f]{32}", "<id>",
                                         path.split("?")[0]), status,
                          _mask(body)))
            return status, body

        await case(observe)
        got[side] = seen
    assert got["port"] == got["ref"]
    return got["port"]


async def test_webhook_json(sides):
    async def case(call):
        _, body = await call("POST", f"/webhooks/examplejson.json?accessKey="
                             f"{KEY}", json=USER_ACTION)
        await call("GET", f"/events/{body['eventId']}.json?accessKey={KEY}")
        await call("GET", f"/webhooks/examplejson.json?accessKey={KEY}")
        await call("POST", f"/webhooks/unknown.json?accessKey={KEY}",
                   json={})
        await call("GET", f"/webhooks/unknown.json?accessKey={KEY}")

    obs = await _both(sides, case)
    assert [o[2] for o in obs] == [201, 200, 200, 404, 404]
    assert obs[2][3] == {"message": "webhooks connection for examplejson "
                                    "is ok."}
    assert obs[3][3] == {"message": "webhooks connection for unknown is "
                                    "not supported."}


async def test_webhook_segmentio(sides):
    payload = {"version": "2", "type": "track", "userId": "u42",
               "event": "Signed Up", "timestamp": "2015-01-02T00:30:12.984Z",
               "properties": {"plan": "pro"},
               "sent_at": "2015-01-02T00:30:12.984Z"}

    async def case(call):
        _, body = await call("POST", f"/webhooks/segmentio.json?accessKey="
                             f"{KEY}", json=payload)
        await call("GET", f"/events/{body['eventId']}.json?accessKey={KEY}")

    obs = await _both(sides, case)
    assert obs[1][3]["properties"]["event"] == "Signed Up"


async def test_webhook_mailchimp_form(sides):
    async def case(call):
        _, body = await call("POST", f"/webhooks/mailchimp.json?accessKey="
                             f"{KEY}", data=MAILCHIMP_SUBSCRIBE)
        await call("GET", f"/events/{body['eventId']}.json?accessKey={KEY}")

    obs = await _both(sides, case)
    assert obs[1][3]["targetEntityId"] == "a6b5da1054"
    assert obs[1][3]["eventTime"].startswith("2009-03-26T21:35:57")


async def test_webhook_exampleform_and_channel(sides):
    form = {"type": "userActionItem", "userId": "u1", "event": "rate",
            "itemId": "i1", "context": '{"ip": "1.2.3.4"}',
            "anotherPropertyA": "", "timestamp": "2015-01-15T04:20:23Z"}

    async def case(call):
        _, body = await call(
            "POST", f"/webhooks/exampleform.json?accessKey={KEY}"
                    "&channel=side", data=form)
        await call("GET", f"/events/{body['eventId']}.json?accessKey={KEY}"
                          "&channel=side")
        await call("GET", f"/events/{body['eventId']}.json?accessKey={KEY}")
        await call("POST", f"/webhooks/exampleform.json?accessKey={KEY}"
                           "&channel=nope", data=form)

    obs = await _both(sides, case)
    assert [o[2] for o in obs] == [201, 200, 404, 401]
    assert obs[1][3]["properties"]["context"] == {"ip": "1.2.3.4"}


async def test_webhook_errors(sides):
    async def case(call):
        await call("POST", "/webhooks/examplejson.json", json=USER_ACTION)
        await call("POST", "/webhooks/examplejson.json?accessKey=WRONG",
                   json=USER_ACTION)
        await call("GET", "/webhooks/examplejson.json")
        await call("POST", f"/webhooks/examplejson.json?accessKey={KEY}",
                   data=b"not json",
                   headers={"Content-Type": "application/json"})
        await call("POST", f"/webhooks/examplejson.json?accessKey={KEY}",
                   json=dict(USER_ACTION, type="other"))
        await call("POST", f"/webhooks/segmentio.json?accessKey={KEY}",
                   json={"type": "track", "userId": "u1"})
        await call("POST", f"/webhooks/mailchimp.json?accessKey={KEY}",
                   data={"type": "subscribe"})
        await call("POST", f"/webhooks/exampleform.json?accessKey={KEY}",
                   data={"type": "userAction", "userId": "u1",
                         "event": "$bad"})
        await call("POST", f"/webhooks/examplejson.json?accessKey={KEY}",
                   json=[1, 2])

    obs = await _both(sides, case)
    assert [o[2] for o in obs] == [401, 401, 401, 400, 400, 400, 400, 400,
                                   400]


async def test_webhook_event_stored_as_direct_post(stores):
    """An event through a webhook is stored as the same event sent to
    ``POST /events.json`` is (ids and creation times aside)."""
    server = EventServer(ingest=IngestConfig(linger_s=0.0))
    port = await server.start("127.0.0.1", 0)
    url = f"http://127.0.0.1:{port}"
    try:
        async with aiohttp.ClientSession() as s:
            for name, payload, form in (
                    ("examplejson", USER_ACTION_ITEM, False),
                    ("mailchimp", MAILCHIMP_SUBSCRIBE, True),
                    ("segmentio", CONNECTOR_CASES["segmentio_identify"][1],
                     False)):
                kw = {"data": payload} if form else {"json": payload}
                async with s.post(f"{url}/webhooks/{name}.json?accessKey="
                                  f"{KEY}", **kw) as r:
                    assert r.status == 201
                    hooked = (await r.json())["eventId"]
                direct = port_webhooks.get_connector(name).to_event_dict(
                    dict(payload))
                async with s.post(f"{url}/events.json?accessKey={KEY}",
                                  json=direct) as r:
                    assert r.status == 201
                    posted = (await r.json())["eventId"]
                got = []
                for eid in (hooked, posted):
                    async with s.get(f"{url}/events/{eid}.json?accessKey="
                                     f"{KEY}") as r:
                        got.append(_mask(await r.json()))
                assert got[0] == got[1]
    finally:
        await server.close()
