"""server.json's key, TLS and serving sections in the port, held
against the reference's ``utils/server_config`` on the same files and
environment; the port's HTTP layer over TLS and its form bodies against
aiohttp's."""

import asyncio
import dataclasses
import http.client
import json
import ssl
import subprocess

import pytest
from aiohttp import web
from aiohttp.test_utils import TestServer

from predictionio_tpu.utils import server_config as ref_sc
from predictionio_tpu_torch.server.http import HttpServer, Request
from predictionio_tpu_torch.utils import server_config as port_sc

pytestmark = pytest.mark.anyio

ENV_KNOBS = ("PIO_SERVER_KEY", "PIO_SSL_CERTFILE", "PIO_SSL_KEYFILE",
             "PIO_BATCH_MAX", "PIO_BATCH_LINGER_S", "PIO_BATCH_INFLIGHT",
             "PIO_SERVER_CONF", "PIO_CONF_DIR")

#: (server.json contents or None for no file, environment)
CASES = {
    "no_file": (None, {}),
    "defaults_file": ({}, {}),
    "key_and_ssl": ({"key": "filekey", "ssl": {
        "enabled": True, "certfile": "c.pem", "keyfile": "k.pem"}}, {}),
    "env_key_wins": ({"key": "filekey"}, {"PIO_SERVER_KEY": "envkey"}),
    "env_cert_turns_tls_on": ({"ssl": {"enabled": False}}, {
        "PIO_SSL_CERTFILE": "/x/c.pem", "PIO_SSL_KEYFILE": "/x/k.pem"}),
    "ssl_null": ({"key": None, "ssl": None, "serving": None}, {}),
    "serving_file": ({"serving": {"batchMax": 8, "batchInflight": 2,
                                  "batchLingerS": 0.004}}, {}),
    "serving_env_wins": ({"serving": {"batchMax": 8}}, {
        "PIO_BATCH_MAX": "4", "PIO_BATCH_LINGER_S": "0.002"}),
    "serving_malformed": ({"serving": {"batchMax": "many",
                                       "batchLingerS": [1],
                                       "batchInflight": 0}},
                          {"PIO_BATCH_INFLIGHT": "x"}),
    "serving_floors": ({"serving": {"batchMax": -3}},
                       {"PIO_BATCH_INFLIGHT": "-1"}),
    "every_section": ({"key": "k", "deploy": {"canaryFraction": 0.3},
                       "ingest": {"maxEventsPerBatch": 10},
                       "train": {"alsSolver": "full"},
                       "foldin": {"enabled": True},
                       "scorer": {"mode": "twostage", "shortlist": 1024},
                       "batchpredict": {"chunkSize": 16},
                       "orchestrator": {"intervalS": 3},
                       "telemetry": {"intervalS": 1},
                       "multitenant": {"budgetBytes": 1000}}, {}),
}


@pytest.fixture()
def clean_env(monkeypatch):
    for var in ENV_KNOBS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _write_conf(tmp_path, monkeypatch, data, env):
    conf = tmp_path / "server.json"
    if data is not None:
        conf.write_text(json.dumps(data))
    monkeypatch.setenv("PIO_SERVER_CONF", str(conf))
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("case", sorted(CASES))
def test_server_config_load_matches_reference(case, tmp_path, clean_env):
    data, env = CASES[case]
    _write_conf(tmp_path, clean_env, data, env)
    got = dataclasses.asdict(port_sc.ServerConfig.load())
    want = dataclasses.asdict(ref_sc.ServerConfig.load())
    assert got == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_serving_config_matches_reference(case, tmp_path, clean_env):
    data, env = CASES[case]
    _write_conf(tmp_path, clean_env, data, env)
    section = (data or {}).get("serving")
    assert dataclasses.asdict(port_sc.ServingConfig.from_env(section)) == \
        dataclasses.asdict(ref_sc.ServingConfig.from_env(section))


def test_server_config_reads_pio_conf_dir(tmp_path, clean_env):
    (tmp_path / "server.json").write_text(json.dumps({"key": "dirkey"}))
    clean_env.setenv("PIO_CONF_DIR", str(tmp_path))
    assert port_sc.ServerConfig.load().key == \
        ref_sc.ServerConfig.load().key == "dirkey"


@pytest.mark.parametrize("key,provided", [
    ("", None), ("", "anything"), ("sekrit", "sekrit"),
    ("sekrit", "wrong"), ("sekrit", None), ("sekrit", ""),
    ("sekrit", "sekrit2")])
def test_check_key_matches_reference(key, provided):
    got = port_sc.ServerConfig(key=key).check_key(provided)
    assert got is ref_sc.ServerConfig(key=key).check_key(provided)


@pytest.mark.parametrize("enabled,cert,key", [
    (False, "c.pem", "k.pem"), (True, None, "k.pem"), (True, "c.pem", None)])
def test_ssl_context_none_unless_enabled_with_both_files(enabled, cert,
                                                         key):
    assert port_sc.ServerConfig(ssl_enabled=enabled, certfile=cert,
                                keyfile=key).ssl_context() is None
    assert ref_sc.ServerConfig(ssl_enabled=enabled, certfile=cert,
                               keyfile=key).ssl_context() is None


def self_signed(tmp_path):
    """(certfile, keyfile) of a fresh self-signed certificate, or a skip
    when ``openssl`` is absent (as tests/test_server_config.py does)."""
    cert, key = tmp_path / "c.pem", tmp_path / "k.pem"
    try:
        p = subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", str(key), "-out", str(cert), "-days", "1",
             "-subj", "/CN=localhost"], capture_output=True)
    except FileNotFoundError:
        p = None
    if p is None or p.returncode != 0:
        pytest.skip("openssl unavailable: no certificate to load")
    return str(cert), str(key)


def test_ssl_context_from_self_signed_cert(tmp_path):
    cert, key = self_signed(tmp_path)
    port_ctx = port_sc.ServerConfig(ssl_enabled=True, certfile=cert,
                                    keyfile=key).ssl_context()
    ref_ctx = ref_sc.ServerConfig(ssl_enabled=True, certfile=cert,
                                  keyfile=key).ssl_context()
    assert isinstance(port_ctx, ssl.SSLContext)
    assert port_ctx.protocol == ref_ctx.protocol


def https_get(port: int, path: str, method: str = "GET"):
    """(status, JSON body) over HTTPS to a self-signed certificate."""
    conn = http.client.HTTPSConnection(
        "127.0.0.1", port, timeout=10,
        context=ssl._create_unverified_context())
    try:
        conn.request(method, path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def plain_http_refused(port: int) -> bool:
    """True when a plain-HTTP request to ``port`` gets no HTTP answer."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", "/")
        conn.getresponse().read()
    except (OSError, http.client.HTTPException):
        return True
    finally:
        conn.close()
    return False


async def test_http_server_over_tls(tmp_path):
    cert, key = self_signed(tmp_path)
    ctx = port_sc.ServerConfig(ssl_enabled=True, certfile=cert,
                               keyfile=key).ssl_context()

    async def hello(req: Request):
        return 200, {"path": req.path, "q": req.query.get("x")}

    server = HttpServer([("GET", "/hello", hello)])
    port = await server.start("127.0.0.1", 0, ssl_context=ctx)
    loop = asyncio.get_running_loop()
    try:
        got = await loop.run_in_executor(None, https_get, port,
                                         "/hello?x=1")
        assert got == (200, {"path": "/hello", "q": "1"})
        assert await loop.run_in_executor(None, plain_http_refused, port)
        # the listener keeps serving TLS after a refused plain request
        got = await loop.run_in_executor(None, https_get, port, "/nope")
        assert got[0] == 404
    finally:
        await server.close()


#: (body, content type) cases of a form POST
FORM_CASES = {
    "plain": (b"a=1&b=two", "application/x-www-form-urlencoded"),
    "blank_values": (b"a=&b=&c=3", "application/x-www-form-urlencoded"),
    "repeated_keys": (b"a=1&a=2&b=3&a=4",
                      "application/x-www-form-urlencoded"),
    "percent_encoding": (b"data%5Bmerges%5D%5BFNAME%5D=Mail+Chimp&e=a%40b.c"
                         b"&u=%E2%82%AC", "application/x-www-form-urlencoded"),
    "charset_latin1": ("n=caf%E9".encode(),
                       "application/x-www-form-urlencoded; charset=latin-1"),
    "no_content_type": (b"x=1&y=%20", None),
    "empty_content_type": (b"x=1&y=%20", ""),
    "trailing_newline": (b"a=1&b=2\r\n", "application/x-www-form-urlencoded"),
    "json_type": (b'{"a": 1}', "application/json"),
    "empty": (b"", "application/x-www-form-urlencoded"),
    "multipart": (b"--XyZ\r\nContent-Disposition: form-data; name=\"a\"\r\n"
                  b"\r\nvalue one\r\n--XyZ\r\nContent-Disposition: form-data;"
                  b" name=\"b\"\r\n\r\n\r\n--XyZ\r\nContent-Disposition: "
                  b"form-data; name=\"a\"\r\n\r\nsecond\r\n--XyZ--\r\n",
                  "multipart/form-data; boundary=XyZ"),
}


def _raw_post(port: int, body: bytes, headers: dict) -> dict:
    """POST exactly these headers (http.client adds Content-Length only)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("POST", "/f", body=body, headers=headers)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


@pytest.mark.parametrize("case", sorted(FORM_CASES))
async def test_form_body_matches_aiohttp(case):
    body, ctype = FORM_CASES[case]
    headers = {"Content-Type": ctype} if ctype is not None else {}

    async def handler(request):
        return web.json_response(dict(await request.post()))

    app = web.Application()
    app.router.add_post("/f", handler)
    server = TestServer(app)
    await server.start_server()
    try:
        want = await asyncio.get_running_loop().run_in_executor(
            None, _raw_post, server.port, body, headers)
    finally:
        await server.close()
    got = Request(method="POST", path="/f", query={},
                  headers={k.lower(): v for k, v in headers.items()},
                  body=body).form()
    assert got == want


def test_form_of_a_get_is_empty():
    assert Request(method="GET", path="/", query={}, headers={},
                   body=b"a=1").form() == {}


def _tenant_spec(**kw):
    import numpy as np

    from predictionio_tpu_torch.engines import recommendation as rec
    from predictionio_tpu_torch.models.als import ALSModel
    from predictionio_tpu_torch.server.multitenant import TenantSpec
    from predictionio_tpu_torch.storage.base import EngineInstance

    rng = np.random.default_rng(0)
    model = ALSModel.from_arrays(
        np.array(["u0", "u1"]), np.array(["a", "b", "c"]),
        rng.standard_normal((2, 4)), rng.standard_normal((3, 4)),
        device="cpu")
    eng = rec.engine()
    return TenantSpec(
        name="t", engine=eng,
        train_result=eng.prepare_deploy(rec.default_engine_params("A"),
                                        [model]),
        instance=EngineInstance(id="t-inst", status="COMPLETED",
                                engine_id="e", engine_version="1",
                                engine_variant="t"),
        deploy_config=port_sc.DeployConfig(warmup=False), **kw)


@pytest.mark.parametrize("entry", ["eventserver", "adminserver",
                                   "dashboard", "multiserve"])
def test_servers_read_the_key_and_tls(entry, tmp_path, clean_env):
    """Each server's run function listens over server.json's TLS, and
    the key guards it: the dashboard's middleware, the tenants' deploy
    API (a missing ``access_key`` falls back to the file's)."""
    from predictionio_tpu_torch.server import (
        admin, dashboard, event_server, multitenant,
    )

    cert, key = self_signed(tmp_path)
    (tmp_path / "server.json").write_text(json.dumps({
        "key": "file-key", "ssl": {"enabled": True, "certfile": cert,
                                   "keyfile": key},
        "serving": {"batchMax": 5}}))
    clean_env.setenv("PIO_SERVER_CONF", str(tmp_path / "server.json"))
    clean_env.setenv("PIO_TELEMETRY", "0")
    seen = {}
    module, run = {
        "eventserver": (event_server, lambda: event_server.run_event_server(
            "127.0.0.1", 0)),
        "adminserver": (admin, lambda: admin.run_admin_server(
            "127.0.0.1", 0)),
        "dashboard": (dashboard, lambda: dashboard.run_dashboard(
            "127.0.0.1", 0)),
        "multiserve": (multitenant, lambda: multitenant.run_multitenant_server(
            [_tenant_spec(serving_config=port_sc.ServingConfig.from_env(
                port_sc.read_server_json().get("serving")))],
            ip="127.0.0.1", port=0, access_key=None))}[entry]

    def capture(server, host, port, on_ready=None, ssl_context=None):
        seen.update(server=server, ssl=ssl_context)

    clean_env.setattr(module, "serve_until_stopped", capture)
    run()
    assert isinstance(seen["ssl"], ssl.SSLContext)
    server = seen["server"]
    if entry == "dashboard":
        assert server.config.key == "file-key"
    if entry == "multiserve":
        tenant = server.tenants["t"].server
        assert server.access_key == tenant.access_key == "file-key"
        assert tenant.max_batch == 5


def test_tenant_serving_config_outranks_the_pair():
    from predictionio_tpu_torch.server.multitenant import MultiTenantServer

    host = MultiTenantServer([_tenant_spec(
        serving_config=port_sc.ServingConfig(batch_max=3,
                                             batch_linger_s=0.0),
        max_batch=40)])
    assert host.tenants["t"].server.max_batch == 3
    host = MultiTenantServer([_tenant_spec(max_batch=40)])
    assert host.tenants["t"].server.max_batch == 40
