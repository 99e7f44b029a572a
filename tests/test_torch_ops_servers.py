"""The port's admin server and dashboard against the reference's: the
admin sequence of ``tests/test_ops_servers.py`` (each on its own store,
set up alike), ``/cmd/releases`` and the dashboard's JSON endpoints over
one store both packages read, the key middleware as
``tests/test_server_config.py`` drives it, ``/cmd/slo`` over a live
target, and the console's sections."""

import datetime as dt
import re

import aiohttp
import pytest
from aiohttp.test_utils import TestClient, TestServer

from predictionio_tpu.server.admin import (
    create_admin_server as ref_create_admin_server,
)
from predictionio_tpu.server.dashboard import (
    create_dashboard as ref_create_dashboard,
)
from predictionio_tpu.storage import (
    EvaluationInstance as RefEvaluationInstance, Release as RefRelease,
    Storage as RefStorage,
)
from predictionio_tpu.utils.server_config import (
    ServerConfig as RefServerConfig,
)
from predictionio_tpu_torch.server.admin import create_admin_server
from predictionio_tpu_torch.server.dashboard import (
    create_dashboard, sparkline,
)
from predictionio_tpu_torch.server.http import HttpServer
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.server_config import ServerConfig

pytestmark = pytest.mark.anyio

UTC = dt.timezone.utc


def _config(path):
    return {"sources": {"DB": {"TYPE": "sqlite", "PATH": str(path)}},
            "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                             for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}}


@pytest.fixture()
def one_store(tmp_path):
    """Both packages' storage on one sqlite file."""
    RefStorage.configure(_config(tmp_path / "o.db"))
    Storage.configure(_config(tmp_path / "o.db"))
    yield tmp_path / "o.db"
    RefStorage.reset()
    Storage.reset()


@pytest.fixture()
def two_stores(tmp_path):
    RefStorage.configure(_config(tmp_path / "ref.db"))
    Storage.configure(_config(tmp_path / "port.db"))
    yield
    RefStorage.reset()
    Storage.reset()


class Sides:
    """The reference's app under aiohttp's test client, the port's
    server on a socket: ``call(side, method, path, **kw) -> (status,
    content type, body)`` (JSON decoded, else text)."""

    def __init__(self, ref_app, port_server):
        self.ref_app, self.port_server = ref_app, port_server

    async def __aenter__(self):
        self.ref = TestClient(TestServer(self.ref_app))
        await self.ref.start_server()
        self.port = await self.port_server.start("127.0.0.1", 0)
        self.session = aiohttp.ClientSession()
        return self

    async def __aexit__(self, *exc):
        await self.session.close()
        await self.port_server.close()
        await self.ref.close()

    @staticmethod
    async def _read(resp):
        ctype = resp.headers.get("Content-Type", "").split(";")[0]
        if ctype == "application/json":
            return resp.status, ctype, await resp.json()
        return resp.status, ctype, await resp.text()

    async def call(self, side, method, path, **kw):
        if side == "ref":
            return await self._read(await self.ref.request(method, path,
                                                           **kw))
        async with self.session.request(
                method, f"http://127.0.0.1:{self.port}{path}", **kw) as r:
            return await self._read(r)

    async def both(self, method, path, **kw):
        ref = await self.call("ref", method, path, **kw)
        port = await self.call("port", method, path, **kw)
        return ref, port


def _mask(body):
    if isinstance(body, list):
        return [_mask(b) for b in body]
    if isinstance(body, dict):
        return {k: ("<key>" if k == "accessKey" else
                    ["<key>"] * len(v) if k == "accessKeys" else _mask(v))
                for k, v in body.items()}
    return body


async def test_admin_app_sequence_matches_reference(two_stores):
    """tests/test_ops_servers.py:37-66, request for request."""
    steps = [("GET", "/", {}),
             ("POST", "/cmd/app", {"json": {"name": "adminapp"}}),
             ("POST", "/cmd/app", {"json": {"name": "adminapp"}}),
             ("POST", "/cmd/app", {"data": b"x"}),
             ("POST", "/cmd/app", {"json": {"nope": 1}}),
             ("POST", "/cmd/app", {"json": {"name": "second", "id": 7,
                                            "description": "d"}}),
             ("GET", "/cmd/app", {}),
             ("DELETE", "/cmd/app/adminapp/data", {}),
             ("DELETE", "/cmd/app/missing/data", {}),
             ("DELETE", "/cmd/app/adminapp", {}),
             ("DELETE", "/cmd/app/adminapp", {}),
             ("GET", "/cmd/app", {}),
             ("GET", "/cmd/nothing", {})]
    async with Sides(ref_create_admin_server(),
                     create_admin_server()) as s:
        for method, path, kw in steps:
            ref, port = await s.both(method, path, **kw)
            assert port[0] == ref[0], (method, path, port, ref)
            if ref[1] == "application/json" and path != "/cmd/nothing":
                assert _mask(port[2]) == _mask(ref[2]), (method, path)
    # the created apps exist in the port's store alone, with a key each
    apps = {a.name: a for a in Storage.get_meta_data_apps().get_all()}
    assert set(apps) == {"second"} and apps["second"].id == 7
    assert Storage.get_meta_data_access_keys().get_by_appid(7)


def _release(version, status, variant="default"):
    return RefRelease(
        id="", engine_id="predictionio_tpu.engines.recommendation:engine",
        engine_version="1", engine_variant=variant, version=version,
        instance_id=f"inst-{variant}-{version}", status=status,
        params_digest="p", model_digest="m", model_size_bytes=10,
        train_seconds=1.5, batch="",
        created_time=dt.datetime(2024, 1, version, tzinfo=UTC),
        history=[{"status": status, "at": "2024-01-01T00:00:00+00:00"}])


async def test_admin_releases_match_reference(one_store):
    releases = RefStorage.get_meta_data_releases()
    for r in (_release(1, "RETIRED"), _release(2, "LIVE"),
              _release(1, "LIVE", variant="other")):
        releases.insert(r)
    async with Sides(ref_create_admin_server(),
                     create_admin_server()) as s:
        for q in ("", "?engineVariant=default", "?engineVariant=other",
                  "?engineId=nope",
                  "?engineId=predictionio_tpu.engines.recommendation:engine"
                  "&engineVariant=default"):
            ref, port = await s.both("GET", f"/cmd/releases{q}")
            assert port == ref, q
        assert len(port[2]["releases"]) == 2


async def test_admin_slo_view_matches_reference(two_stores, tmp_path,
                                                monkeypatch):
    """The host's spec and a live target's /slo.json (a stub server), a
    dead target's error entry."""
    conf = tmp_path / "server.json"
    conf.write_text('{"slo": {"objectives": [{"name": "lat", "kind": '
                    '"latency", "thresholdS": 0.05, "budget": 0.01}], '
                    '"windows": [{"seconds": 300, "burnThreshold": 14.4}]}}')
    monkeypatch.setenv("PIO_SERVER_CONF", str(conf))

    async def slo(_req):
        return 200, {"enabled": True, "breached": True, "objectives": []}

    stub = HttpServer([("GET", "/slo.json", slo)])
    stub_port = await stub.start("127.0.0.1", 0)
    try:
        async with Sides(ref_create_admin_server(),
                         create_admin_server()) as s:
            ref, port = await s.both("GET", "/cmd/slo")
            assert port == ref and port[2]["spec"]["objectives"]
            ref, port = await s.both(
                "GET", f"/cmd/slo?targets=127.0.0.1:{stub_port}")
            assert port == ref
            assert port[2]["breached"] == [f"127.0.0.1:{stub_port}"]
            ref, port = await s.both("GET", "/cmd/slo?targets=127.0.0.1:9")
            assert port[0] == ref[0] == 200
            assert "error" in port[2]["fleet"]["127.0.0.1:9"]
            assert port[2]["breached"] == ref[2]["breached"] == []
    finally:
        await stub.close()


def _evaluation(cls, name, status="EVALCOMPLETED"):
    return cls(status=status, evaluation_class=name,
               evaluator_results=f"[{name}] 0.9",
               evaluator_results_html=f"<html><body>{name} detail"
                                      "</body></html>",
               evaluator_results_json='{"score": 0.9}',
               start_time=dt.datetime(2024, 1, 1, tzinfo=UTC),
               end_time=dt.datetime(2024, 1, 2, tzinfo=UTC))


async def test_dashboard_json_matches_reference(one_store):
    evis = RefStorage.get_meta_data_evaluation_instances()
    ids = []
    for name, status in (("MyEval", "EVALCOMPLETED"),
                         ("Other", "EVALCOMPLETED"),
                         ("Failed", "EVALFAILED")):
        inst = _evaluation(RefEvaluationInstance, name, status)
        iid = evis.insert(inst)
        inst.id = iid
        evis.update(inst)
        ids.append(iid)
    plain = _evaluation(RefEvaluationInstance, "Plain")
    plain.evaluator_results_html = ""
    plain.evaluator_results = "<b>0.5</b>"
    pid = evis.insert(plain)
    plain.id = pid
    evis.update(plain)
    async with Sides(ref_create_dashboard(), create_dashboard()) as s:
        for path in ("/evaluations.json", f"/evaluations/{ids[0]}.json",
                     f"/evaluations/{ids[2]}.json", "/evaluations/nope.json",
                     f"/engine_instances/{ids[1]}",
                     f"/engine_instances/{pid}", "/engine_instances/nope"):
            ref, port = await s.both("GET", path)
            assert port == ref, path
        ref, port = await s.both("GET", "/evaluations.json")
        assert {e["id"] for e in port[2]} == {ids[0], ids[1], pid}
        page = (await s.call("port", "GET", "/"))
        assert page[0] == 200 and page[1] == "text/html"
        for want in ("MyEval", ids[0], "<h2>Releases</h2>",
                     "<h2>SLO burn (trailing hour)</h2>",
                     "<h2>Capacity ledger (trailing hour)</h2>",
                     "<h2>Completed evaluations</h2>"):
            assert want in page[2]
        assert "<script" not in page[2] and "http://" not in page[2]
        # the console's sections, row for row, as the reference renders
        ref_page = (await s.call("ref", "GET", "/"))[2]
        assert _sections(page[2]) == _sections(ref_page)


def _sections(page):
    """The console's section titles and table headers (the volatile
    trace and event rows aside)."""
    return re.findall(r"<h2>[^<]*</h2>|<th>[^<]*</th>", page)


async def test_dashboard_releases_section(one_store):
    RefStorage.get_meta_data_releases().insert(_release(3, "LIVE"))
    async with Sides(ref_create_dashboard(), create_dashboard()) as s:
        page = (await s.call("port", "GET", "/"))[2]
        assert "recommendation:engine/default" in page
        # insert() assigns the version: the first of the variant
        assert "<b>LIVE</b>" in page and ">v1<" in page


@pytest.mark.parametrize("key", ["dashkey", ""])
async def test_dashboard_key_auth_matches_reference(one_store, key):
    """tests/test_server_config.py:170: 401 without or with a wrong
    key, 200 with it; the scraper paths stay open."""
    async with Sides(ref_create_dashboard(RefServerConfig(key=key)),
                     create_dashboard(ServerConfig(key=key))) as s:
        for path in ("/evaluations.json", "/evaluations.json?accessKey=wrong",
                     "/evaluations.json?accessKey=dashkey", "/",
                     "/evaluations/x.json", "/nothing/here",
                     "/capacity.json", "/history/series.json",
                     "/metrics.json"):
            ref, port = await s.both("GET", path)
            assert port[0] == ref[0], path
            if path.startswith("/evaluations") or ref[0] == 401:
                assert port[2] == ref[2], path


@pytest.mark.parametrize("values", [[], [0, 0, 0], [1, 2, 3, 4, 8],
                                    [5.0] * 40, [0.5, 0.0, 1.0]])
def test_sparkline_matches_reference(values):
    from predictionio_tpu.server.dashboard import sparkline as ref_sparkline

    assert sparkline(values) == ref_sparkline(values)
