"""The port's operator commands against the reference's CLI on the same
stores: ``export`` line for line, the app/channel/key management
commands' output and what they leave in the store, ``analyze --json``
over one telemetry root, ``version``, ``run`` and ``shell``; a deploy
under server.json's key, TLS and ``serving`` section with
``PIO_BATCH_MAX``; and the reference's deploy-key fault."""

import collections
import concurrent.futures
import datetime as dt
import http.client
import io
import json
import os
import pathlib
import re
import ssl
import subprocess
import sys
import time

import numpy as np
import pytest
from click.testing import CliRunner

from predictionio_tpu.cli.main import cli as ref_cli
from predictionio_tpu.storage import Storage as RefStorage
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.storage.base import AccessKey, App
from predictionio_tpu_torch.storage.registry import Storage

ROOT = pathlib.Path(__file__).resolve().parent.parent
UTC = dt.timezone.utc


def _config(path):
    return {"sources": {"DB": {"TYPE": "sqlite", "PATH": str(path)}},
            "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                             for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}}


def _events(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        kind = j % 4
        props = ({"rating": float(rng.integers(1, 6))} if kind == 0 else
                 {"tags": ["a", "b"], "nested": {"x": j}} if kind == 1
                 else {})
        out.append(Event(
            event=("rate", "$set", "view", "buy")[kind], entity_type="user",
            entity_id=f"u{rng.integers(0, 20)}",
            target_entity_type=None if kind == 1 else "item",
            target_entity_id=None if kind == 1 else f"i{j % 7}",
            properties=DataMap(props),
            event_time=dt.datetime(2024, 1, 1, tzinfo=UTC)
            + dt.timedelta(seconds=int(rng.integers(0, 10_000)))))
    return out


@pytest.fixture()
def one_store(tmp_path):
    """An app of 200 events (and a channel of 30) in one store both
    packages read."""
    Storage.configure(_config(tmp_path / "o.db"))
    RefStorage.configure(_config(tmp_path / "o.db"))
    apps = Storage.get_meta_data_apps()
    app_id = apps.insert(App(id=0, name="Shop"))
    store = Storage.get_events()
    store.init_channel(app_id)
    store.insert_batch(_events(200), app_id)
    from predictionio_tpu_torch.storage.base import Channel

    cid = Storage.get_meta_data_channels().insert(
        Channel(id=0, name="side", appid=app_id))
    store.init_channel(app_id, cid)
    store.insert_batch(_events(30, seed=1), app_id, cid)
    Storage.get_meta_data_access_keys().insert(
        AccessKey(key="shop-key", appid=app_id, events=()))
    yield {"app_id": app_id, "channel_id": cid, "dir": tmp_path}
    Storage.reset()
    RefStorage.reset()


def _ref(*args):
    out = CliRunner().invoke(ref_cli, list(args), catch_exceptions=False)
    return out.exit_code, out.output


def _port(capsys, *args):
    try:
        rc = main(list(args))
    except SystemExit as e:
        rc = e.code
    return rc, capsys.readouterr().out


def _lines(path):
    return [json.loads(x) for x in pathlib.Path(path).read_text()
            .splitlines()]


@pytest.mark.parametrize("target", [("--appname", "Shop"),
                                    ("--appname", "Shop", "--channel",
                                     "side"),
                                    ("--appid", "1")])
def test_export_matches_reference_line_for_line(one_store, capsys, target):
    d = one_store["dir"]
    rc, out = _ref("export", *target, "--output", str(d / "ref.jsonl"))
    assert rc == 0
    prc, pout = _port(capsys, "export", *target, "--output",
                      str(d / "port.jsonl"))
    assert prc == 0
    assert pout.strip() == out.strip().replace(str(d / "ref.jsonl"),
                                               str(d / "port.jsonl"))
    assert _lines(d / "port.jsonl") == _lines(d / "ref.jsonl")
    assert len(_lines(d / "port.jsonl")) == (30 if "side" in target
                                             else 200)


def test_export_unknown_app_and_missing_target(one_store, capsys):
    d = one_store["dir"]
    for args in (("--appname", "Nope"), ()):
        rc, out = _ref("export", *args, "--output", str(d / "x.jsonl"))
        prc, pout = _port(capsys, "export", *args, "--output",
                          str(d / "x.jsonl"))
        assert (prc, pout.replace("[ERROR] ", "").strip()) == \
            (rc, out.replace("[ERROR] ", "").strip())
        assert not (d / "x.jsonl").exists()


def test_export_parquet_raises(one_store):
    with pytest.raises(ValueError, match="Queue 1 item 8"):
        main(["export", "--appname", "Shop", "--output",
              str(one_store["dir"] / "x.parquet"), "--format", "parquet"])


def test_interrupted_export_leaves_no_file(one_store, monkeypatch):
    store = Storage.get_events()
    real = type(store).find

    def dying(self, *a, **kw):
        for i, e in enumerate(real(self, *a, **kw)):
            if i == 50:
                raise KeyboardInterrupt
            yield e

    monkeypatch.setattr(type(store), "find", dying)
    out = one_store["dir"] / "cut.jsonl"
    with pytest.raises(KeyboardInterrupt):
        main(["export", "--appname", "Shop", "--output", str(out)])
    assert not out.exists()
    assert not list(one_store["dir"].glob("cut.jsonl.tmp-*"))


def test_export_then_import_round_trips(one_store, capsys):
    d = one_store["dir"]
    assert _port(capsys, "export", "--appname", "Shop", "--output",
                 str(d / "all.jsonl"))[0] == 0
    assert _port(capsys, "app", "new", "Copy")[0] == 0
    assert _port(capsys, "import", "--appname", "Copy", "--input",
                 str(d / "all.jsonl"))[0] == 0
    copy = Storage.get_meta_data_apps().get_by_name("Copy").id

    def bag(app_id):
        return collections.Counter(
            json.dumps({k: v for k, v in e.to_dict().items()
                        if k != "creationTime"}, sort_keys=True)
            for e in Storage.get_events().find(app_id))

    assert bag(copy) == bag(one_store["app_id"])
    assert sum(bag(copy).values()) == 200


def _mask(text):
    return re.sub(r"Access Key: \S+|Created new access key: \S+",
                  "<key>", text)


def _two_stores(tmp_path):
    """The same app, key and channel in two stores, one a package."""
    from predictionio_tpu.storage import AccessKey as RefAccessKey
    from predictionio_tpu.storage import App as RefApp
    from predictionio_tpu.storage import Channel as RefChannel
    from predictionio_tpu.storage.base import Channel

    out = []
    for st, app_cls, key_cls, ch_cls, path in (
            (RefStorage, RefApp, RefAccessKey, RefChannel, "ref.db"),
            (Storage, App, AccessKey, Channel, "port.db")):
        st.configure(_config(tmp_path / path))
        app_id = st.get_meta_data_apps().insert(app_cls(
            id=0, name="Mgmt", description="managed"))
        st.get_events().init_channel(app_id)
        st.get_meta_data_access_keys().insert(key_cls(
            key="k-all", appid=app_id, events=()))
        st.get_meta_data_access_keys().insert(key_cls(
            key="k-view", appid=app_id, events=("view", "buy")))
        cid = st.get_meta_data_channels().insert(ch_cls(
            id=0, name="old", appid=app_id))
        st.get_events().init_channel(app_id, cid)
        out.append(app_id)
    assert out[0] == out[1]
    return out[0]


def _state(storage, app_id):
    """What the store holds of an app: its row, keys, channels and the
    events of each channel."""
    app = storage.get_meta_data_apps().get(app_id)
    channels = storage.get_meta_data_channels().get_by_appid(app_id)
    events = storage.get_events()

    def n(cid):
        try:
            return len(list(events.find(app_id, cid)))
        except Exception:       # noqa: BLE001 — a dropped table
            return None

    return {"app": None if app is None else (app.name, app.description),
            "keys": sorted((k.key, tuple(k.events)) for k in
                           storage.get_meta_data_access_keys()
                           .get_by_appid(app_id)),
            "channels": sorted(c.name for c in channels),
            "events": {c.name: n(c.id) for c in channels} | {None: n(None)}}


def _seed_events(storage, event_cls, datamap_cls, app_id, channel_id, n):
    storage.get_events().insert_batch([
        event_cls(event="view", entity_type="user", entity_id=f"u{j}",
                  target_entity_type="item", target_entity_id="i",
                  properties=datamap_cls({}))
        for j in range(n)], app_id, channel_id)


def test_management_commands_match_reference(tmp_path, capsys):
    from predictionio_tpu.data.datamap import DataMap as RefDataMap
    from predictionio_tpu.data.event import Event as RefEvent

    app_id = _two_stores(tmp_path)
    steps = [("app", "show", "Mgmt"),
             ("app", "channel-new", "Mgmt", "side"),
             ("app", "channel-new", "Mgmt", "side"),
             ("app", "channel-new", "Mgmt", "bad name!"),
             ("app", "channel-new", "Nope", "x"),
             ("app", "show", "Mgmt"),
             "seed",
             ("app", "data-delete", "Mgmt", "--channel", "side",
              "--force"),
             ("app", "data-delete", "Mgmt", "--channel", "nope", "--force"),
             ("app", "channel-delete", "Mgmt", "side", "--force"),
             ("app", "channel-delete", "Mgmt", "side", "--force"),
             ("app", "data-delete", "Mgmt", "--force"),
             ("accesskey", "delete", "k-view"),
             ("accesskey", "list", "Mgmt"),
             ("app", "show", "Nope"),
             ("app", "delete", "Nope", "--force"),
             ("app", "data-delete", "Mgmt", "--all", "--force"),
             ("app", "delete", "Mgmt", "--force"),
             ("app", "list")]
    states = []
    for step in steps:
        if step == "seed":
            # events in the default channel and in each named one
            for st, ev, dm in ((RefStorage, RefEvent, RefDataMap),
                               (Storage, Event, DataMap)):
                for c in [None] + [c.id for c in st.get_meta_data_channels()
                                   .get_by_appid(app_id)]:
                    _seed_events(st, ev, dm, app_id, c, 3)
            states.append((_state(RefStorage, app_id),
                           _state(Storage, app_id)))
            continue
        rc, out = _ref(*step)
        prc, pout = _port(capsys, *step)
        assert (prc, _mask(pout).strip()) == (rc, _mask(out).strip()), step
        states.append((_state(RefStorage, app_id), _state(Storage, app_id)))
    for ref_state, port_state in states:
        assert port_state == ref_state
    # the data-delete of "side" emptied it and left the default channel
    seeded = steps.index("seed")
    assert states[seeded + 1][1]["events"] == {"old": 3, "side": 0,
                                               None: 3}
    # nothing of the app is left
    assert states[-1][1] == {"app": None, "keys": [], "channels": [],
                             "events": {None: None}}
    Storage.reset()
    RefStorage.reset()


def test_app_delete_asks_first(tmp_path, capsys, monkeypatch):
    _two_stores(tmp_path)
    monkeypatch.setattr("sys.stdin", io.StringIO("n\n"))
    assert _port(capsys, "app", "delete", "Mgmt")[1].strip().endswith(
        "[INFO] Aborted.")
    assert Storage.get_meta_data_apps().get_by_name("Mgmt") is not None
    monkeypatch.setattr("sys.stdin", io.StringIO("y\n"))
    assert _port(capsys, "app", "delete", "Mgmt")[0] == 0
    assert Storage.get_meta_data_apps().get_by_name("Mgmt") is None
    Storage.reset()
    RefStorage.reset()


def test_version_matches_reference(capsys):
    rc, out = _ref("version")
    assert _port(capsys, "version") == (rc, out)


def test_run_runs_a_module_as_main(tmp_path, capsys, monkeypatch):
    mod = tmp_path / "opsmod.py"
    mod.write_text("import sys\nif __name__ == '__main__':\n"
                   "    print('ran', sys.argv[1:])\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    assert _port(capsys, "run", "opsmod", "a", "--b") == \
        (0, "ran ['a', '--b']\n")


def test_shell_runs_piped_lines():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "shell"],
        input="print('in shell', Storage.__name__, "
              "EventStoreClient.__name__, WorkflowContext.__name__)\n",
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "in shell Storage EventStoreClient WorkflowContext" in \
        out.stdout + out.stderr


# -- analyze ------------------------------------------------------------------

def _anatomy_root(root: pathlib.Path):
    """A telemetry root with one query server's anatomy histograms: a
    window 15 minutes back and one 5 minutes back, queue_wait planted
    10x slower in the second."""
    from predictionio_tpu_torch.obs import anatomy, registry, tsdb

    rng = np.random.default_rng(7)
    reg = registry.MetricsRegistry()
    metrics = anatomy.anatomy_metrics(reg)
    db = tsdb.TSDB(str(root / "query_server-8000"))
    now_ms = int(time.time() * 1000)
    for back_s, slow in ((900, 1.0), (300, 10.0)):
        for stage in anatomy.SERVING_WALL_STAGES:
            scale = 0.002 * (slow if stage == "queue_wait" else 1.0)
            for v in rng.exponential(scale, size=40):
                metrics.stage.observe(float(v), path="serving",
                                      stage=stage)
        db.append_snapshot(reg.to_snapshot(), ts_ms=now_ms - back_s * 1000)
    db.flush()
    db.close()


@pytest.mark.parametrize("flags", [("--since", "10m"),
                                   ("--since", "10m", "--diff"),
                                   ("--since", "30m"),
                                   ("--since", "1m"),
                                   ("--path", "ingest", "--since", "1h")])
def test_analyze_json_matches_reference(tmp_path, capsys, flags):
    _anatomy_root(tmp_path / "tel")
    args = ("analyze", "--json", "--dir", str(tmp_path / "tel"), *flags)
    rc, out = _ref(*args)
    prc, pout = _port(capsys, *args)
    assert prc == rc == 0
    got, want = json.loads(pout), json.loads(out)
    assert abs(got.pop("sinceMs") - want.pop("sinceMs")) < 60_000
    assert got == want
    if flags == ("--since", "10m", "--diff"):
        assert got["diff"]["stage"] == "queue_wait"


@pytest.mark.parametrize("flags", [("--since", "10m"), ("--since", "1h",
                                                        "--diff")])
def test_analyze_text_matches_reference(tmp_path, capsys, flags):
    _anatomy_root(tmp_path / "tel")
    args = ("analyze", "--dir", str(tmp_path / "tel"), *flags)
    assert _port(capsys, *args) == _ref(*args)


# -- deploy under server.json -------------------------------------------------

def _model_file(tmp_path):
    from predictionio_tpu_torch.models.als import ALSModel
    from predictionio_tpu_torch.workflow.serialization import save_model

    rng = np.random.default_rng(3)
    users = np.array([f"u{j}" for j in range(40)])
    items = np.array([f"i{j}" for j in range(60)])
    path = tmp_path / "m.npz"
    save_model(path, ALSModel.from_arrays(
        users, items, rng.standard_normal((40, 8)),
        rng.standard_normal((60, 8)), device="cpu"))
    return path


def _tls_files(tmp_path):
    cert, key = tmp_path / "c.pem", tmp_path / "k.pem"
    try:
        p = subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", str(key), "-out", str(cert), "-days", "1",
             "-subj", "/CN=localhost"], capture_output=True)
    except FileNotFoundError:
        return None
    return (str(cert), str(key)) if p.returncode == 0 else None


class _Deploy:
    """``deploy --model`` in a subprocess under ``PIO_HOME=home``; the
    port and scheme from its listening line."""

    def __init__(self, home, model, env, extra=()):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli.main",
             "deploy", "--model", str(model), "--ip", "127.0.0.1",
             "--port", "0", "--device", "cpu", *extra],
            cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=dict(os.environ, PIO_HOME=str(home),
                                PIO_TELEMETRY="0", PYTHONPATH=str(ROOT),
                                **env))
        self.lines = []
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = self.proc.stdout.readline()
            if not line:
                break
            self.lines.append(line)
            m = re.search(r"listening on (https?)://[^:]+:(\d+)", line)
            if m:
                self.scheme, self.port = m.group(1), int(m.group(2))
                return
        self.proc.kill()
        raise AssertionError("".join(self.lines))

    def call(self, method, path, body=None):
        if self.scheme == "https":
            conn = http.client.HTTPSConnection(
                "127.0.0.1", self.port, timeout=30,
                context=ssl._create_unverified_context())
        else:
            conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                              timeout=30)
        try:
            conn.request(method, path, body=None if body is None
                         else json.dumps(body))
            r = conn.getresponse()
            return r.status, r.read()
        finally:
            conn.close()

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)


def _batch_buckets(metrics: bytes) -> dict:
    out = {}
    for line in metrics.decode().splitlines():
        m = re.match(r'pio_batch_size_bucket\{le="([^"]+)"\} (\S+)', line)
        if m:
            out[m.group(1)] = float(m.group(2))
        m = re.match(r"pio_batch_size_count (\S+)", line)
        if m:
            out["count"] = float(m.group(1))
    return out


def test_deploy_reads_server_json_key_tls_and_serving(tmp_path):
    """server.json gives the key and TLS; ``serving.batchMax`` 8 under
    ``PIO_BATCH_MAX=4``: no micro-batch above 4 under 32 concurrent
    clients; /stop 401 without the key, 200 with it."""
    (tmp_path / "conf").mkdir()
    tls = _tls_files(tmp_path)
    conf = {"key": "file-key", "serving": {"batchMax": 8,
                                           "batchInflight": 1}}
    if tls is not None:
        conf["ssl"] = {"enabled": True, "certfile": tls[0],
                       "keyfile": tls[1]}
    (tmp_path / "conf" / "server.json").write_text(json.dumps(conf))
    dep = _Deploy(tmp_path, _model_file(tmp_path),
                  {"PIO_BATCH_MAX": "4", "PIO_BATCH_LINGER_S": "0.01"})
    try:
        assert dep.scheme == ("https" if tls else "http")
        assert any("micro-batches of at most 4" in x for x in dep.lines)
        with concurrent.futures.ThreadPoolExecutor(32) as pool:
            answers = list(pool.map(
                lambda j: dep.call("POST", "/queries.json",
                                   {"user": f"u{j % 40}", "num": 5}),
                range(256)))
        assert all(s == 200 for s, _ in answers)
        status, metrics = dep.call("GET", "/metrics")
        buckets = _batch_buckets(metrics)
        assert buckets["count"] >= 1
        assert buckets["4"] == buckets["count"], buckets
        assert buckets["2"] < buckets["count"], buckets   # they batched
        assert dep.call("POST", "/stop")[0] == 401
        assert dep.call("POST", "/stop?accessKey=wrong")[0] == 401
        assert dep.call("POST", "/stop?accessKey=file-key")[0] == 200
        assert dep.proc.wait(timeout=30) == 0
    finally:
        dep.stop()


def test_deploy_accesskey_outranks_server_json(tmp_path):
    (tmp_path / "conf").mkdir()
    (tmp_path / "conf" / "server.json").write_text(
        json.dumps({"key": "file-key"}))
    dep = _Deploy(tmp_path, _model_file(tmp_path), {"PIO_SERVER_KEY": ""},
                  extra=("--accesskey", "flag-key"))
    try:
        assert dep.scheme == "http"
        assert dep.call("POST", "/stop?accessKey=file-key")[0] == 401
        assert dep.call("POST", "/stop?accessKey=flag-key")[0] == 200
        assert dep.proc.wait(timeout=30) == 0
    finally:
        dep.stop()


def test_reference_deploy_ignores_server_json_key(tmp_path, monkeypatch):
    """The reference's fault, not copied: ``pio deploy`` passes
    ``access_key=None`` when ``--accesskey`` is not given, so
    ``run_query_server``'s ``setdefault("access_key", cfg.key)`` never
    applies and the deploy API is open despite server.json's key. The
    port's deploy falls back to the key
    (``test_deploy_reads_server_json_key_tls_and_serving``)."""
    from predictionio_tpu.server import query_server as ref_qs

    conf = tmp_path / "server.json"
    conf.write_text(json.dumps({"key": "file-key"}))
    monkeypatch.setenv("PIO_SERVER_CONF", str(conf))
    monkeypatch.delenv("PIO_SERVER_KEY", raising=False)
    seen = {}

    class _Server:
        app = None

    def create(*_a, **kw):
        seen.update(kw)
        return _Server()

    monkeypatch.setattr(ref_qs, "create_query_server", create)
    monkeypatch.setattr(ref_qs.web, "run_app", lambda *a, **kw: None)
    # as the reference's deploy command calls it without --accesskey
    ref_qs.run_query_server(None, None, None, None, access_key=None,
                            telemetry=None)
    assert seen["access_key"] is None
    # given no access_key at all, the file's key would apply
    seen.clear()
    ref_qs.run_query_server(None, None, None, None, telemetry=None)
    assert seen["access_key"] == "file-key"
