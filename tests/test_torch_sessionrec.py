"""The port's session-recommendation engine (``engines/sessionrec.py``,
``data/ingest.sessions_by_entity``, the ``seqrec`` codec, the CLI
template) against the JAX package's, on the CPU, on one sqlite store
that the reference writes and both packages read.

Tolerances:

* sessions and ``read_eval``'s folds: equal (the same rows, the same
  time order, equal times kept in scan order);
* the engine trained by both packages on the cyclic fixture of
  ``tests/test_sessionrec.py``: answers' scores within ``SCORE_TOL``
  (1e-4 absolute; the two trainings agree to about 1e-5 on these
  inputs) and ids equal except among scores within that of each other;
* the codec: an exact round trip (vocabulary, every parameter bit for
  bit, the hyperparameters), and the same answers after it;
* the CLI: every answer equal to the stored model's on the CPU.
"""

import asyncio
import dataclasses
import datetime as dt
import http.client
import json
import os
import pathlib
import socket
import subprocess
import sys
import time
import types

import numpy as np
import pytest

import predictionio_tpu.data.eventstore as ref_eventstore
import predictionio_tpu.data.ingest as ref_ingest
import predictionio_tpu.engines.sessionrec as ref_sr
import predictionio_tpu_torch.data.eventstore as port_eventstore
import predictionio_tpu_torch.data.ingest as port_ingest
import predictionio_tpu_torch.engines.sessionrec as port_sr
from predictionio_tpu.data import Event as RefEvent
from predictionio_tpu.storage import App as RefApp, Storage as RefStorage
from predictionio_tpu.workflow.context import WorkflowContext as RefContext
from predictionio_tpu_torch.deploy.foldin import resolve_foldin
from predictionio_tpu_torch.deploy.warm import EngineInstance
from predictionio_tpu_torch.models.seqrec import SeqRecModel
from predictionio_tpu_torch.obs.capacity import model_capacity
from predictionio_tpu_torch.server.query_server import create_query_server
from predictionio_tpu_torch.storage.registry import Storage as PortStorage
from predictionio_tpu_torch.utils.server_config import FoldinConfig
from predictionio_tpu_torch.workflow.serialization import (
    deserialize_models, load_model, save_model, serialize_models,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
APP = "SessApp"
TIE_APP = "SessTies"
SCORE_TOL = 1e-4
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)


def _config(path):
    return {"sources": {"DB": {"TYPE": "sqlite", "PATH": str(path)}},
            "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                             for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}}


def _reset():
    RefStorage.reset()
    PortStorage.reset()
    ref_eventstore.clear_cache()
    port_eventstore.clear_cache()


def _view(u, item, t, name="view"):
    return RefEvent(event=name, entity_type="user", entity_id=u,
                    target_entity_type="item", target_entity_id=item,
                    event_time=t)


def cyclic_events():
    """tests/test_sessionrec.py's fixture: 60 users browsing a cyclic
    15-item catalog, i(k) -> i(k+1) -> ..."""
    rng = np.random.default_rng(7)
    events = []
    for u in range(60):
        start = int(rng.integers(0, 15))
        for j in range(int(rng.integers(4, 9))):
            events.append(_view(f"u{u}", f"i{(start + j) % 15:02d}",
                                T0 + dt.timedelta(minutes=u * 100 + j)))
    return events


def tie_events():
    """Users whose events share timestamps, written out of time order,
    with buys, likes (not read) and non-item targets."""
    rng = np.random.default_rng(3)
    events = []
    for u in range(25):
        for j in range(int(rng.integers(1, 12))):
            t = T0 + dt.timedelta(minutes=int(rng.integers(0, 4)))
            name = ("view", "buy", "like")[int(rng.integers(0, 3))]
            events.append(_view(f"t{u % 7}", f"i{int(rng.integers(0, 9))}",
                                t, name))
    rng.shuffle(events)
    return events


@pytest.fixture()
def sess_store(tmp_path):
    _reset()
    RefStorage.configure(_config(tmp_path / "sess.db"))
    for name, events in ((APP, cyclic_events()), (TIE_APP, tie_events())):
        app_id = RefStorage.get_meta_data_apps().insert(RefApp(id=0,
                                                               name=name))
        store = RefStorage.get_events()
        store.init_channel(app_id)
        store.insert_batch(events, app_id)
    PortStorage.configure(_config(tmp_path / "sess.db"))
    yield tmp_path
    _reset()


def _ref_ctx():
    import jax

    return RefContext(mode="Training", devices=jax.devices()[:1])


ALGO = dict(d_model=32, n_heads=2, n_layers=1, max_len=16, epochs=15,
            batch_size=32)


def assert_same_answers(got, want, tol):
    """Scores within ``tol``; ids equal except at near-ties."""
    assert len(got) == len(want), (got, want)
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=0, atol=tol)
    want_score = dict(want)
    for (gi, _), (wi, w) in zip(got, want):
        if gi != wi:
            assert abs(want_score.get(gi, want[-1][1]) - w) <= 2 * tol


# -- sessions and folds -------------------------------------------------------------

@pytest.mark.parametrize("app", [APP, TIE_APP])
def test_sessions_match_reference(sess_store, app):
    ref = ref_sr.SessionDataSource(
        ref_sr.DataSourceParams(app_name=app))._read_sessions()
    got = port_sr.SessionDataSource(
        port_sr.DataSourceParams(app_name=app))._read_sessions()
    assert got == ref and len(got) == (60 if app == APP else 7)


def test_sessions_by_entity_on_arrays_matches_reference():
    """Equal times keep the scan order; sessions come out in sorted-user
    order."""
    rng = np.random.default_rng(9)
    n = 400
    users = np.asarray([f"u{k}" for k in rng.integers(0, 30, n)], object)
    items = np.asarray([f"i{k}" for k in rng.integers(0, 50, n)], object)
    times = rng.integers(0, 5, n).astype(np.int64)
    assert port_ingest.sessions_by_entity(users, items, times) == \
        ref_ingest.sessions_by_entity(users, items, times)
    assert port_ingest.sessions_by_entity(users[:0], items[:0],
                                          times[:0]) == []


def test_read_eval_folds_match_reference(sess_store):
    ep = {"kFold": 3, "queryNum": 5}
    ref = ref_sr.SessionDataSource(ref_sr.DataSourceParams(
        app_name=APP, eval_params=ep)).read_eval(None)
    got = port_sr.SessionDataSource(port_sr.DataSourceParams(
        app_name=APP, eval_params=ep)).read_eval(None)
    assert len(got) == len(ref) == 3
    for (td, info, qa), (rtd, rinfo, rqa) in zip(got, ref):
        assert td.sessions == rtd.sessions and info == rinfo
        assert [(q.items, q.num, a.item) for q, a in qa] == \
            [(q.items, q.num, a.item) for q, a in rqa]


# -- the engine -----------------------------------------------------------------------

def _train_both():
    ref_result = ref_sr.engine().train(
        _ref_ctx(), ref_sr.default_engine_params(APP, **ALGO))
    result = port_sr.engine().train(
        types.SimpleNamespace(device="cpu"),
        port_sr.default_engine_params(APP, **ALGO))
    return ref_result, result


def test_engine_train_and_predict_like_reference(sess_store):
    ref_result, result = _train_both()
    algo, model = result.algorithms[0], result.models[0]
    ref_algo, ref_model = ref_result.algorithms[0], ref_result.models[0]
    pred = algo.predict(model, port_sr.Query(items=["i03", "i04", "i05"],
                                             num=3))
    items = [s.item for s in pred.item_scores]
    assert "i06" in items            # the learned cyclic successor
    assert "i05" not in items        # seen items excluded
    scores = [s.score for s in pred.item_scores]
    assert scores == sorted(scores, reverse=True)
    assert set(pred.to_dict()) == {"itemScores"}
    assert algo.predict(model, port_sr.Query(items=["nope"],
                                             num=3)).item_scores == []
    assert algo.warmup_query(model) == port_sr.Query(items=["i00"], num=10)
    assert algo.warmup_query(None) is None
    for q in (["i03", "i04", "i05"], ["i14"], ["i00", "i01", "i02", "i03"],
              ["i07", "nope", "i09"]):
        for num in (3, 10):
            got = algo.predict(model, port_sr.Query(items=q, num=num))
            want = ref_algo.predict(ref_model, ref_sr.Query(items=q, num=num))
            assert_same_answers(
                [(s.item, s.score) for s in got.item_scores],
                [(s.item, s.score) for s in want.item_scores], SCORE_TOL)


def test_engine_trains_on_a_mesh_like_reference(sess_store):
    """``SeqRecAlgorithm.train`` on ``mesh_of(ctx)``: a 2 x 2 ``("data",
    "model")`` mesh of positions (the CPU repeated) trains the model the
    reference's trains on a 2 x 2 mesh of its devices, and answers as
    it does."""
    import jax
    from jax.sharding import Mesh as RefMesh

    from predictionio_tpu.models.seqrec import train_seqrec as ref_train
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    ctx = types.SimpleNamespace(device="cpu", mesh=mesh)
    td = port_sr.SessionPreparator().prepare(
        ctx, port_sr.SessionDataSource(
            port_sr.DataSourceParams(app_name=APP)).read_training(ctx))
    kw = dict(ALGO, epochs=3)
    algo = port_sr.SeqRecAlgorithm(port_sr.AlgorithmParams(**kw))
    model = algo.train(ctx, td)
    want = ref_train(RefMesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model")), td.sessions,
                     ref_sr.AlgorithmParams(**kw))
    for q in (["i03", "i04", "i05"], ["i14"], ["i07", "nope", "i09"]):
        got = algo.predict(model, port_sr.Query(items=q, num=5))
        assert_same_answers(
            [(s.item, s.score) for s in got.item_scores],
            want.recommend_next(q, 5), SCORE_TOL)


def test_foldin_stays_off_for_sessionrec(sess_store):
    result = port_sr.engine().train(
        types.SimpleNamespace(device="cpu"),
        port_sr.default_engine_params(APP, **dict(ALGO, epochs=2)))
    assert resolve_foldin(result) is None
    server = create_query_server(
        port_sr.engine(), result, EngineInstance(id="sess-foldin"),
        foldin_config=FoldinConfig(enabled=True))
    server.warm()
    server._start_foldin()
    assert server.foldin_status() == {"enabled": False}
    q = port_sr.Query(items=["i03", "i04"], num=2)
    assert len(server._predict_unit(server._unit, q).item_scores) == 2


# -- the codec --------------------------------------------------------------------------

def test_seqrec_codec_round_trip_is_exact(sess_store, tmp_path):
    result = port_sr.engine().train(
        types.SimpleNamespace(device="cpu"),
        port_sr.default_engine_params(APP, **dict(ALGO, epochs=3)))
    model = result.models[0]
    blob = serialize_models([model])
    assert blob.startswith(b"PK") and b"pickle" not in blob
    path = tmp_path / "seqrec.npz"
    save_model(path, model)
    for back in (deserialize_models(blob, device="cpu")[0],
                 load_model(path, device="cpu")):
        assert type(back) is SeqRecModel
        assert list(back.item_vocab) == list(model.item_vocab)
        assert dataclasses.asdict(back.hyper) == \
            dataclasses.asdict(model.hyper)
        assert sorted(back.params) == sorted(model.params)
        for k, v in model.params.items():
            assert back.params[k].dtype == np.float32
            np.testing.assert_array_equal(back.params[k], v)
        for q in (["i03", "i04"], ["i11"], ["nope"]):
            assert back.recommend_next(q, 5) == model.recommend_next(q, 5)


# -- the device contract under /reload ---------------------------------------------------

@pytest.mark.anyio
async def test_reload_releases_the_model_and_capacity_counts_it(sess_store):
    """Three trains of the variant: the server answers on the first;
    ``/reload`` twice makes the first the dropped standby, whose device
    copy is released; the capacity ledger counts the served model's
    parameters as its device bytes."""
    import aiohttp

    from predictionio_tpu_torch.workflow.train import (
        load_for_deploy, run_train,
    )

    eng = port_sr.engine()
    params = port_sr.default_engine_params(APP, **dict(ALGO, epochs=2))
    factory = "predictionio_tpu_torch.engines.sessionrec:engine"
    instances = [run_train(eng, params, engine_factory=factory,
                           device="cpu")[0]]
    result, _ctx = load_for_deploy(eng, instances[0], device="cpu")
    first = result.models[0]
    server = create_query_server(eng, result, instances[0])
    port = await server.start("127.0.0.1", 0)
    try:
        async with aiohttp.ClientSession() as http:
            async def query():
                async with http.post(
                        f"http://127.0.0.1:{port}/queries.json",
                        json={"items": ["i03", "i04"], "num": 3}) as r:
                    assert r.status == 200
                    return await r.json()

            assert len((await query())["itemScores"]) == 3
            want = sum(v.nbytes for v in first.params.values())
            entry = model_capacity(first)
            assert first.device_bytes() == want
            assert entry["modelFactorBytes"] == entry["residentBytes"] \
                == want
            for _ in range(2):
                instances.append(run_train(eng, params,
                                           engine_factory=factory,
                                           device="cpu")[0])
                async with http.get(f"http://127.0.0.1:{port}/reload") as r:
                    assert r.status == 200, await r.text()
                    assert (await r.json())["engineInstanceId"] == \
                        instances[-1].id
                assert len((await query())["itemScores"]) == 3
            deadline = time.monotonic() + 30
            while first.device_bytes() and time.monotonic() < deadline:
                await asyncio.sleep(0.05)
            assert first.device_bytes() == 0
            assert model_capacity(first)["residentBytes"] == 0
            served = server._unit.result.models[0]
            assert served.device_bytes() == want
    finally:
        await server.close()


# -- the CLI on the CPU -------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, body, timeout_s=120):
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            c.request("POST", "/queries.json", body=json.dumps(body))
            r = c.getresponse()
            return r.status, json.loads(r.read())
        except (ConnectionRefusedError, ConnectionResetError):
            assert time.monotonic() < deadline, "the deploy never listened"
            time.sleep(0.1)


def test_cli_template_train_deploy_on_cpu(sess_store):
    """``template list|get sessionrec`` -> ``train`` -> ``deploy`` ->
    ``POST /queries.json`` through ``python -m
    predictionio_tpu_torch.cli.main``, the engine.json naming the
    reference's factory string: every answer is the stored model's."""
    tmp_path = sess_store
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               PIO_HOME=str(tmp_path / "home"), **{
        "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "sess.db"),
        **{f"PIO_STORAGE_REPOSITORIES_{r}_{k}": v
           for r in ("METADATA", "EVENTDATA", "MODELDATA")
           for k, v in (("NAME", "pio"), ("SOURCE", "DB"))}})
    cli = [sys.executable, "-m", "predictionio_tpu_torch.cli.main"]

    def run(*args):
        out = subprocess.run([*cli, *args], cwd=str(tmp_path), env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
        return out.stdout.strip().splitlines()

    listed = run("template", "list")
    assert len(listed) == 6 and any(
        "sessionrec" in x and "engines.sessionrec:engine" in x
        for x in listed)
    run("template", "get", "sessionrec", "tpl")
    template = json.loads((tmp_path / "tpl" / "engine.json").read_text())
    assert template["algorithms"] == [{"name": "seqrec", "params": {
        "d_model": 64, "n_heads": 2, "n_layers": 2, "max_len": 32,
        "epochs": 10}}]
    variant = tmp_path / "engine.json"
    variant.write_text(json.dumps(dict(
        template, engineFactory="predictionio_tpu.engines.sessionrec:engine",
        datasource={"params": {"appName": APP}})))
    line = json.loads(run("train", "--variant", str(variant), "--device",
                          "cpu")[-1])
    assert line["items"] == 15 and line["d_model"] == 64
    model = deserialize_models(PortStorage.get_model_data_models().get(
        line["instance"]).models, device="cpu")[0]
    port = _free_port()
    deploy = subprocess.Popen(
        [*cli, "deploy", "--variant", str(variant), "--port", str(port),
         "--device", "cpu"], cwd=str(tmp_path), env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        for q in (["i03", "i04", "i05"], ["i12"], ["nope"],
                  ["i01", "nope", "i02"]):
            status, body = _post(port, {"items": q, "num": 4})
            assert status == 200, body
            assert body == {"itemScores": [
                {"item": i, "score": s}
                for i, s in model.recommend_next(q, 4)]}, (q, body)
    finally:
        deploy.terminate()
        deploy.communicate(timeout=60)
