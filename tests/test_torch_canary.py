"""Staged rollouts of the port (``deploy/canary.py``, ``obs/slo.py``,
``utils/server_config.DeployConfig`` and the deploy API of
``server/query_server.py``), held against the JAX package:

* ``TrafficSplitter`` routes the same sequence as the reference's for
  fractions {0, 0.1, 0.25, 0.5, 0.9, 1.0} over 1,000 queries;
  ``SlidingStats`` and ``judge_relative`` (through ``CanaryController``)
  give the same verdicts, reasons and window figures on the same seeded
  observation streams: a latency breach, an error breach, a late error
  breach and a healthy promote.
* ``CanaryConfig.normalized()``, ``CanaryController.to_dict()`` and
  ``DeployConfig`` under the same env and server.json equal the
  reference's.
* The server over the port's HTTP layer: a slow candidate (+60 ms a
  batch) and a failing one auto-roll back with the reference's reason
  slugs, as the reference's server does on the same models; a healthy
  candidate promotes; a shadow serves nothing of the candidate; a second
  canary and ``/reload`` during a canary get 409; an operator rollback
  aborts the canary; ``/deploy.json`` answers 404 for an unknown version
  and 401 without the key; fold-in holds its deltas while a canary is
  judged and applies them after the verdict. Every release status is
  read straight after the response that caused it, with no flush of the
  server's executor, in a loop of 20 rollbacks.
* The canary path's served answers equal the reference's, query by
  query, on models both packages trained from the same store
  (``test_torch_train_lifecycle``'s fixture).
"""

import asyncio
import dataclasses
import json
import time
import types

import aiohttp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

import predictionio_tpu.deploy.canary as ref_canary
import predictionio_tpu.engines.recommendation as ref_rec
import predictionio_tpu_torch.deploy.canary as port_canary
import predictionio_tpu_torch.engines.recommendation as port_rec
import predictionio_tpu_torch.models.als as port_als
from predictionio_tpu.core.engine import Engine as RefEngine
from predictionio_tpu.deploy.releases import (
    record_release as ref_record_release,
)
from predictionio_tpu.models.als import ALSModel as RefALSModel
from predictionio_tpu.server.query_server import QueryServer as RefQueryServer
from predictionio_tpu.storage import Model as RefModel
from predictionio_tpu.storage import Storage as RefStorage
from predictionio_tpu.storage.base import EngineInstance as RefEngineInstance
from predictionio_tpu.utils import server_config as ref_config
from predictionio_tpu.workflow.serialization import (
    serialize_models as ref_serialize_models,
)
from predictionio_tpu_torch.core.engine import Engine
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.deploy.releases import record_release
from predictionio_tpu_torch.models.als import ALSModel
from predictionio_tpu_torch.obs import slo as port_slo
from predictionio_tpu_torch.server.query_server import QueryServer
from predictionio_tpu_torch.storage.base import App, EngineInstance, Model
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils import server_config as port_config
from predictionio_tpu_torch.utils.server_config import (
    DeployConfig, FoldinConfig, ScorerConfig,
)
from predictionio_tpu_torch.workflow.serialization import serialize_models

pytestmark = pytest.mark.anyio

N_USERS, N_ITEMS, RANK = 40, 30, 6
ENGINE_ID, VARIANT = "canary-test-engine", "default"
APP = "CanaryApp"
KEY = "op-key"


# ---------------------------------------------------------------------------
# splitter, judge and configs against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fraction", [0.0, 0.1, 0.25, 0.5, 0.9, 1.0])
def test_splitter_routes_like_reference(fraction):
    ref = ref_canary.TrafficSplitter(fraction)
    port = port_canary.TrafficSplitter(fraction)
    got = [port.route() for _ in range(1000)]
    assert got == [ref.route() for _ in range(1000)]
    assert abs(sum(got) - round(1000 * fraction)) <= 1
    assert port.state() == ref.state()
    for junk in (None, "x", float("nan"), -0.5, 1.0, 0.375):
        ref.restore(junk)
        port.restore(junk)
        assert port.state() == ref.state()


def _stream(kind: str, seed: int = 0):
    """A seeded observation stream (role, seconds, ok) of one scenario;
    the canary takes every other query."""
    rng = np.random.default_rng(seed)
    out = []
    for n in range(400):
        role = "canary" if n % 2 else "incumbent"
        sec = float(rng.gamma(4.0, 0.0025))
        ok = True
        if role == "canary":
            if kind == "latency" and n > 60:
                sec += 0.080
            elif kind == "errors":
                ok = rng.random() > 0.3
            elif kind == "late_errors" and n > 120:
                ok = rng.random() > 0.5
        out.append((role, sec, ok))
    return out


@pytest.mark.parametrize("kind,want", [
    ("latency", "slo_latency"), ("errors", "slo_errors"),
    ("late_errors", "slo_errors"), ("healthy", "healthy")])
def test_judge_matches_reference(kind, want):
    cfg = dict(fraction=0.5, window=50, min_samples=10, promote_after=150)
    ref = ref_canary.CanaryController(ref_canary.CanaryConfig(**cfg))
    port = port_canary.CanaryController(port_canary.CanaryConfig(**cfg))
    verdicts = []
    for role, sec, ok in _stream(kind):
        got = port.observe(role, sec, ok)
        assert got == ref.observe(role, sec, ok)
        if got is not None:
            verdicts.append(got)
        assert port.to_dict() == ref.to_dict()
    assert len(verdicts) == 1 and verdicts[0][1].split(":")[0] == want
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert port.canary.quantile(q) == ref.canary.quantile(q)
        assert port.incumbent.quantile(q) == ref.incumbent.quantile(q)
    # the judge alone, straight on the windows
    kw = dict(min_samples=10, error_rate_slack=0.05, p99_ratio=2.0,
              latency_slack_s=0.025, promote_after=150)
    assert port_slo.judge_relative(port.incumbent, port.canary, **kw) == \
        ref_canary.judge_relative(ref.incumbent, ref.canary, **kw)


@pytest.mark.parametrize("cfg", [
    {}, {"fraction": 1.5}, {"fraction": -1.0, "window": 0},
    {"window": 10, "min_samples": 50, "promote_after": 3},
    {"shadow": True, "fraction": 0.4},
    {"window": 7, "min_samples": 2, "promote_after": 4}])
def test_canary_config_matches_reference(cfg):
    ref = ref_canary.CanaryConfig(**cfg)
    port = port_canary.CanaryConfig(**cfg)
    assert dataclasses.asdict(port.normalized()) == \
        dataclasses.asdict(ref.normalized())
    assert port_canary.CanaryConfig.MAX_FRACTION == \
        ref_canary.CanaryConfig.MAX_FRACTION
    assert port_canary.CanaryController(port).to_dict() == \
        ref_canary.CanaryController(ref).to_dict()
    assert (port_canary.ROLE_INCUMBENT, port_canary.ROLE_CANARY,
            port_canary.ROLE_SHADOW) == (ref_canary.ROLE_INCUMBENT,
                                         ref_canary.ROLE_CANARY,
                                         ref_canary.ROLE_SHADOW)


@pytest.mark.parametrize("env,section", [
    ({}, {}),
    ({}, {"warmup": False, "drainTimeoutS": 2.5, "canaryFraction": 0.3,
          "canaryWindow": 50, "canaryMinSamples": 7,
          "canaryPromoteAfter": 70, "canaryP99Ratio": 1.5,
          "canaryLatencySlackS": 0.01, "canaryErrorRateSlack": 0.1}),
    ({"PIO_DEPLOY_WARMUP": "0", "PIO_CANARY_FRACTION": "0.2",
      "PIO_CANARY_WINDOW": "300", "PIO_CANARY_ERROR_SLACK": "0.02",
      "PIO_DEPLOY_DRAIN_TIMEOUT_S": "9"},
     {"warmup": True, "canaryFraction": 0.7, "canaryWindow": 40}),
    ({"PIO_CANARY_MIN_SAMPLES": "many", "PIO_CANARY_P99_RATIO": ""},
     {"canaryPromoteAfter": "lots", "canaryLatencySlackS": "0.5"}),
])
def test_deploy_config_matches_reference(monkeypatch, tmp_path, env,
                                         section):
    for name in [n for n in __import__("os").environ
                 if n.startswith(("PIO_DEPLOY_", "PIO_CANARY_"))]:
        monkeypatch.delenv(name)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    path = tmp_path / "server.json"
    path.write_text(json.dumps({"deploy": section}))
    monkeypatch.setenv("PIO_SERVER_CONF", str(path))
    ref = ref_config.DeployConfig.from_env(section)
    assert dataclasses.asdict(port_config.DeployConfig.from_env(section)) \
        == dataclasses.asdict(ref)
    assert dataclasses.asdict(port_config.deploy_config()) == \
        dataclasses.asdict(ref_config.ServerConfig.load(str(path)).deploy)


# ---------------------------------------------------------------------------
# the deploy API over the port's HTTP layer
# ---------------------------------------------------------------------------

def _arrays(seed, n_items=N_ITEMS):
    rng = np.random.default_rng(seed)
    return (np.sort(np.asarray([f"u{i}" for i in range(N_USERS)],
                               dtype=object)),
            np.sort(np.asarray([f"i{i}" for i in range(n_items)],
                               dtype=object)),
            rng.normal(size=(N_USERS, RANK)).astype(np.float32),
            rng.normal(size=(n_items, RANK)).astype(np.float32))


class SlowALS(port_rec.ALSAlgorithm):
    """The injected latency regression: every batch pays +60 ms."""

    def batch_predict(self, model, queries):
        time.sleep(0.06)
        return super().batch_predict(model, queries)


class LateErrorALS(port_rec.ALSAlgorithm):
    """Passes warm-up and verify, then fails every query."""

    calls = 0

    def batch_predict(self, model, queries):
        type(self).calls += 1
        if type(self).calls > 8:
            raise RuntimeError("late regression")
        return super().batch_predict(model, queries)

    def predict(self, model, query):
        if type(self).calls > 8:
            raise RuntimeError("late regression")
        return super().predict(model, query)


class ErrorALS(port_rec.ALSAlgorithm):
    """Fails from the start: the verify health gate refuses it."""

    def predict(self, model, query):
        raise RuntimeError("regressed model")

    def batch_predict(self, model, queries):
        raise RuntimeError("regressed model")


class RefSlowALS(ref_rec.ALSAlgorithm):
    def batch_predict(self, model, queries):
        time.sleep(0.06)
        return super().batch_predict(model, queries)


class RefLateErrorALS(ref_rec.ALSAlgorithm):
    calls = 0

    def batch_predict(self, model, queries):
        type(self).calls += 1
        if type(self).calls > 8:
            raise RuntimeError("late regression")
        return super().batch_predict(model, queries)

    def predict(self, model, query):
        if type(self).calls > 8:
            raise RuntimeError("late regression")
        return super().predict(model, query)


def _port_engine(algo=port_rec.ALSAlgorithm) -> Engine:
    return Engine(data_source_classes=port_rec.RecommendationDataSource,
                  preparator_classes=port_rec.RecommendationPreparator,
                  algorithm_classes={"als": algo},
                  serving_classes=port_rec.RecommendationServing)


def _ref_engine(algo=ref_rec.ALSAlgorithm) -> RefEngine:
    return RefEngine(data_source_classes=ref_rec.RecommendationDataSource,
                     preparator_classes=ref_rec.RecommendationPreparator,
                     algorithm_classes={"als": algo},
                     serving_classes=ref_rec.RecommendationServing)


def _config(path):
    return {"sources": {"DB": {"TYPE": "sqlite", "PATH": str(path)}},
            "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                             for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}}


@pytest.fixture()
def port_store(tmp_path):
    Storage.reset()
    Storage.configure(_config(tmp_path / "port.db"))
    yield tmp_path
    Storage.reset()


@pytest.fixture()
def ref_store(tmp_path):
    RefStorage.reset()
    RefStorage.configure(_config(tmp_path / "ref.db"))
    yield tmp_path
    RefStorage.reset()


def _instance(cls, instance_id):
    return cls(id=instance_id, status="COMPLETED", engine_id=ENGINE_ID,
               engine_version="1", engine_variant=VARIANT,
               data_source_params=json.dumps({"appName": APP}),
               algorithms_params=json.dumps(
                   [{"name": "als", "params": {"rank": RANK}}]))


def _register(seed, instance_id):
    """A COMPLETED instance, its blob and its release in the port's
    stores."""
    inst = _instance(EngineInstance, instance_id)
    Storage.get_meta_data_engine_instances().insert(inst)
    blob = serialize_models([ALSModel.from_arrays(*_arrays(seed),
                                                  device="cpu")])
    Storage.get_model_data_models().insert(Model(id=inst.id, models=blob))
    return inst, record_release(inst, train_seconds=1.0, blob=blob)


def _ref_register(seed, instance_id):
    inst = _instance(RefEngineInstance, instance_id)
    RefStorage.get_meta_data_engine_instances().insert(inst)
    users, items, U, V = _arrays(seed)
    blob = ref_serialize_models([RefALSModel(user_vocab=users,
                                             item_vocab=items, U=U, V=V)])
    RefStorage.get_model_data_models().insert(RefModel(id=inst.id,
                                                       models=blob))
    return inst, ref_record_release(inst, train_seconds=1.0, blob=blob)


def _port_server(algo=port_rec.ALSAlgorithm, seed=0, foldin=None,
                 deploy=None, access_key=None) -> QueryServer:
    """The incumbent: v1 (``_register(seed, "incumbent")``) served."""
    inst, rel = _register(seed, "incumbent")
    model = ALSModel.from_arrays(*_arrays(seed), device="cpu")
    # the incumbent scores with the plain algorithm; candidates prepared
    # through /deploy.json with ``algo``
    result = port_rec.engine().prepare_deploy(
        port_rec.default_engine_params(APP, rank=RANK), [model])
    return QueryServer(
        _port_engine(algo), result, inst, scorer_config=ScorerConfig(mode="exact"),
        max_batch=16, linger_s=0.0, release=rel, access_key=access_key,
        foldin_config=foldin or FoldinConfig(enabled=False),
        deploy_config=deploy or DeployConfig(warmup=True,
                                             drain_timeout_s=10.0))


def _ref_server(algo=ref_rec.ALSAlgorithm, seed=0) -> RefQueryServer:
    inst, rel = _ref_register(seed, "incumbent")
    users, items, U, V = _arrays(seed)
    model = RefALSModel(user_vocab=users, item_vocab=items, U=U, V=V)
    from predictionio_tpu.core.engine import TrainResult
    from predictionio_tpu.core.params import EngineParams

    result = TrainResult(
        models=[model], algorithms=[ref_rec.ALSAlgorithm(
            ref_rec.AlgorithmParams(rank=RANK))],
        serving=ref_rec.RecommendationServing(),
        engine_params=EngineParams())
    return RefQueryServer(
        _ref_engine(algo), result, inst, ctx=None,
        serving_config=ref_config.ServingConfig(batch_max=16,
                                                batch_linger_s=0.0),
        deploy_config=ref_config.DeployConfig(warmup=True,
                                              drain_timeout_s=10.0),
        release=rel)


class _Http:
    """An aiohttp session against a started port server."""

    def __init__(self, port):
        self.base = f"http://127.0.0.1:{port}"
        self.session = aiohttp.ClientSession()

    async def call(self, method, path, body=None):
        async with self.session.request(method, self.base + path,
                                        json=body) as r:
            return r.status, await r.json()

    async def close(self):
        await self.session.close()


async def _started(server):
    return _Http(await server.start("127.0.0.1", 0))


def _status(release_id):
    return Storage.get_meta_data_releases().get(release_id).status


async def _drive(call, n, start=0):
    """n single queries; their statuses and bodies."""
    out = []
    for i in range(n):
        out.append(await call("POST", "/queries.json",
                              {"user": f"u{(start + i) % N_USERS}",
                               "num": 3}))
    return out


async def _verdict_lands(server):
    """Wait for the verdict task off the request path."""
    for _ in range(200):
        if server._canary is None:
            return
        await asyncio.sleep(0.01)
    raise AssertionError("the canary never reached its verdict")


REGRESSIONS = {
    "slow": ((SlowALS, RefSlowALS), {
        "canaryWindow": 40, "canaryMinSamples": 5,
        "canaryPromoteAfter": 200, "canaryP99Ratio": 1.5,
        "canaryLatencySlackS": 0.005}, "slo_latency"),
    "failing": ((LateErrorALS, RefLateErrorALS), {
        "canaryMinSamples": 5, "canaryPromoteAfter": 200,
        "canaryErrorRateSlack": 0.2}, "slo_errors"),
}


@pytest.mark.parametrize("case", sorted(REGRESSIONS))
async def test_regressed_canary_rolls_back_like_reference(
        port_store, ref_store, case):
    (port_algo, ref_algo), knobs, slug = REGRESSIONS[case]
    LateErrorALS.calls = RefLateErrorALS.calls = 0
    body = {"version": 2, "canaryFraction": 0.5, **knobs}
    # the reference's server on the same models and body
    ref_server = _ref_server(ref_algo)
    _, ref_rel = _ref_register(2, "candidate")
    ref_client = TestClient(TestServer(ref_server.app))
    await ref_client.start_server()
    try:
        resp = await ref_client.post("/deploy.json", json=body)
        assert resp.status == 200, await resp.json()
        for i in range(40):
            r = await ref_client.post("/queries.json", json={
                "user": f"u{i % N_USERS}", "num": 3})
            await r.read()
        for _ in range(200):
            if ref_server._canary is None:
                break
            await asyncio.sleep(0.01)
        ref_slugs = {k for k in ("slo_latency", "slo_errors")
                     if ref_server._deploy.rollback_total.value(reason=k)}
    finally:
        await ref_client.close()

    server = _port_server(port_algo)
    _, rel = _register(2, "candidate")
    http = await _started(server)
    try:
        status, out = await http.call("POST", "/deploy.json", body)
        assert status == 200 and out["message"] == "Canary started", out
        assert _status(rel.id) == "CANARY"
        answers = await _drive(http.call, 40)
        await _verdict_lands(server)
        _, st = await http.call("GET", "/deploy/status.json")
        assert st["canary"] is None
        assert set(st["deploy"]["rollbacks"]) == ref_slugs == {slug}
        assert st["deploy"]["requests"]["canary"] > 0
        assert st["deploy"]["requests"]["incumbent"] > 0
        assert _status(rel.id) == "ROLLED_BACK"
        history = Storage.get_meta_data_releases().get(rel.id).history
        assert history[-1]["reason"].startswith(slug)
        assert server.instance.id == "incumbent"
        assert all(s == 200 for s, _ in await _drive(http.call, 5))
        if case == "failing":
            assert 400 in [s for s, _ in answers]
    finally:
        await http.close()
        await server.close()


async def test_candidate_failing_verify_is_refused(port_store):
    server = _port_server(ErrorALS)
    _, rel = _register(2, "candidate")
    http = await _started(server)
    try:
        status, out = await http.call("POST", "/deploy.json", {
            "version": 2, "canaryFraction": 0.5, "warmup": False})
        assert status == 500 and server._canary is None
        assert _status(rel.id) == "ROLLED_BACK"
        assert "prepare failed" in Storage.get_meta_data_releases().get(
            rel.id).history[-1]["reason"]
        _, st = await http.call("GET", "/deploy/status.json")
        assert st["deploy"]["swaps"] == {"cold/failed": 1}
        assert all(s == 200 for s, _ in await _drive(http.call, 4))
    finally:
        await http.close()
        await server.close()


async def test_healthy_canary_promotes(port_store):
    server = _port_server()
    _, rel = _register(3, "candidate")
    want = ALSModel.from_arrays(*_arrays(3), device="cpu")
    http = await _started(server)
    try:
        status, out = await http.call("POST", "/deploy.json", {
            "releaseId": rel.id, "canaryFraction": 0.5,
            "canaryMinSamples": 5, "canaryPromoteAfter": 10,
            "canaryP99Ratio": 10.0, "canaryLatencySlackS": 1.0})
        assert status == 200, out
        assert set(out["prepare"]) == {"loadS", "warmupS", "verifyS",
                                       "scorer"}
        _, st = await http.call("GET", "/deploy/status.json")
        assert st["canary"]["releaseVersion"] == 2
        assert st["canary"]["fraction"] == 0.5
        await _drive(http.call, 40)
        await _verdict_lands(server)
        _, st = await http.call("GET", "/deploy/status.json")
        assert st["canary"] is None
        assert st["deploy"]["promotes"] == {"healthy": 1}
        assert st["active"]["releaseVersion"] == 2
        assert st["standby"]["engineInstanceId"] == "incumbent"
        _, rels = await http.call("GET", "/releases.json")
        assert {r["version"]: r["status"] for r in rels["releases"]} == \
            {2: "LIVE", 1: "RETIRED"}
        status, got = await http.call("POST", "/queries.json",
                                      {"user": "u5", "num": 3})
        assert [s["item"] for s in got["itemScores"]] == \
            [i for i, _ in want.recommend("u5", 3)]
    finally:
        await http.close()
        await server.close()


async def test_shadow_never_serves_the_candidate(port_store):
    server = _port_server()
    _, rel = _register(4, "candidate")
    http = await _started(server)
    try:
        before = [b for _, b in await _drive(http.call, 20)]
        status, out = await http.call("POST", "/deploy.json", {
            "version": 2, "shadow": True, "canaryMinSamples": 5,
            "canaryPromoteAfter": 10_000})
        assert status == 200, out
        assert server._canary.config.shadow is True
        during = [b for _, b in await _drive(http.call, 20)]
        assert during == before
        for _ in range(200):
            if server._canary.controller.canary.total == 20:
                break
            await asyncio.sleep(0.01)
        _, st = await http.call("GET", "/deploy/status.json")
        assert st["canary"]["shadow"] is True
        assert st["canary"]["canary"]["total"] == 20
        assert st["deploy"]["requests"]["shadow"] == 20
        assert "canary" not in st["deploy"]["requests"]
        status, out = await http.call("POST", "/rollback.json")
        assert status == 200 and out["message"] == "Canary aborted"
        assert _status(rel.id) == "ROLLED_BACK"
        assert server.instance.id == "incumbent"
    finally:
        await http.close()
        await server.close()


async def test_second_canary_and_reload_get_409(port_store):
    server = _port_server()
    _, rel = _register(3, "candidate")
    http = await _started(server)
    try:
        body = {"releaseId": rel.id, "canaryFraction": 0.3,
                "canaryPromoteAfter": 10_000}
        assert (await http.call("POST", "/deploy.json", body))[0] == 200
        status, out = await http.call("POST", "/deploy.json", body)
        assert status == 409 and "already in progress" in out["message"]
        assert (await http.call("GET", "/reload"))[0] == 409
        assert (await http.call("POST", "/deploy.json",
                                {"version": 2}))[0] == 409
    finally:
        await http.close()
        await server.close()


async def test_operator_rollback_aborts_the_canary(port_store):
    server = _port_server()
    _, rel = _register(3, "candidate")
    http = await _started(server)
    try:
        assert (await http.call("POST", "/deploy.json", {
            "releaseId": rel.id, "canaryFraction": 0.3,
            "canaryPromoteAfter": 10_000}))[0] == 200
        await _drive(http.call, 10)
        status, out = await http.call("POST", "/rollback.json")
        assert status == 200 and out["message"] == "Canary aborted"
        assert out["engineInstanceId"] == "candidate"
        assert server._canary is None
        assert _status(rel.id) == "ROLLED_BACK"
        _, st = await http.call("GET", "/deploy/status.json")
        assert st["deploy"]["rollbacks"] == {"operator": 1}
        assert st["active"]["engineInstanceId"] == "incumbent"
        assert st["standby"] is None
        # nothing resident to roll back to, and v1 is the oldest release
        assert (await http.call("POST", "/rollback.json"))[0] == 404
    finally:
        await http.close()
        await server.close()


async def test_deploy_404_and_401(port_store):
    server = _port_server(access_key=KEY)
    http = await _started(server)
    try:
        status, out = await http.call("POST", f"/deploy.json?accessKey={KEY}",
                                      {"version": 7})
        assert status == 404 and "No deployable" in out["message"]
        assert (await http.call("POST", "/deploy.json",
                                {"version": 1}))[0] == 401
        assert (await http.call("POST", "/deploy.json?accessKey=bad",
                                {"version": 1}))[0] == 401
        assert (await http.call("POST", f"/deploy.json?accessKey={KEY}",
                                [1]))[0] == 400
    finally:
        await http.close()
        await server.close()


async def test_statuses_land_before_each_answer(port_store):
    """20 rollbacks, every release status read straight from the store
    after the response that caused it: a full deploy then an operator
    rollback, and a canary then its abort, in turn."""
    server = _port_server()
    _, v2 = _register(3, "candidate")
    v1 = server._unit.release
    http = await _started(server)
    try:
        for n in range(20):
            if n % 2 == 0:
                status, _ = await http.call("POST", "/deploy.json",
                                            {"version": 2})
                assert status == 200
                assert (_status(v2.id), _status(v1.id)) == \
                    ("LIVE", "RETIRED")
                status, out = await http.call("POST", "/rollback.json")
                assert status == 200 and out["message"] == "Rolled back"
            else:
                status, _ = await http.call("POST", "/deploy.json", {
                    "version": 2, "canaryFraction": 0.5,
                    "canaryPromoteAfter": 10_000})
                assert status == 200 and _status(v2.id) == "CANARY"
                status, out = await http.call("POST", "/rollback.json")
                assert status == 200 and out["message"] == "Canary aborted"
            assert (_status(v2.id), _status(v1.id)) == \
                ("ROLLED_BACK", "LIVE")
            _, rels = await http.call("GET", "/releases.json")
            assert {r["version"]: r["status"] for r in rels["releases"]} \
                == {2: "ROLLED_BACK", 1: "LIVE"}
        _, st = await http.call("GET", "/deploy/status.json")
        assert st["deploy"]["rollbacks"] == {"operator": 20}
    finally:
        await http.close()
        await server.close()


async def test_foldin_holds_while_a_canary_is_judged(port_store):
    """Deltas marked while a canary is open stay pending (no apply, the
    ``held`` outcome), then fold onto the promoted unit after the
    verdict; the reference's controller holds alike."""
    import predictionio_tpu_torch.deploy.foldin as port_foldin

    server = _port_server(foldin=FoldinConfig(
        enabled=True, apply_interval_s=3600.0, max_pending=64))
    app_id = Storage.get_meta_data_apps().insert(App(id=0, name=APP))
    Storage.get_events().init_channel(app_id)
    _, rel = _register(3, "candidate")
    http = await _started(server)
    loop = asyncio.get_running_loop()
    try:
        ctl = server._foldin
        assert ctl is not None
        assert (await http.call("POST", "/deploy.json", {
            "version": 2, "canaryFraction": 0.5, "canaryMinSamples": 5,
            "canaryPromoteAfter": 10, "canaryP99Ratio": 10.0,
            "canaryLatencySlackS": 1.0}))[0] == 200
        events = [Event(event="rate", entity_type="user", entity_id="fresh",
                        target_entity_type="item", target_entity_id=f"i{j}",
                        properties=DataMap({"rating": 4.0}))
                  for j in range(5)]
        Storage.get_events().insert_batch(events, app_id)
        ctl.offer(events)
        assert await loop.run_in_executor(server._deploy_executor,
                                          ctl.apply_pending) is None
        assert ctl.pending_rows() == 1 and ctl.applies == 0
        assert ctl.outcomes["held"] == 1
        await _drive(http.call, 40)
        await _verdict_lands(server)
        assert server._unit.release_version == 2
        stats = await loop.run_in_executor(server._deploy_executor,
                                           ctl.apply_pending)
        assert stats is not None and stats["users"] == 1
        assert ctl.pending_rows() == 0
        _, got = await http.call("POST", "/queries.json",
                                 {"user": "fresh", "num": 3})
        assert len(got["itemScores"]) == 3
        assert server._unit.foldin_of.release_version == 2
    finally:
        await http.close()
        await server.close()
    # the reference holds its deltas alike while a canary is open
    import predictionio_tpu.deploy.foldin as ref_foldin

    import collections

    for ctl_class in (ref_foldin.FoldInController,
                      port_foldin.FoldInController):
        holder = types.SimpleNamespace(
            server=types.SimpleNamespace(_canary=object()),
            outcomes=collections.Counter())
        assert ctl_class.apply_pending(holder) is None


# ---------------------------------------------------------------------------
# the canary path's answers against the reference's, on trained models
# ---------------------------------------------------------------------------

from test_torch_train_lifecycle import (  # noqa: E402
    APP as TRAIN_APP, ITERS, QUERIES, RANK as TRAIN_RANK, _config as
    _train_config, _event_rows, _ref_write, _reference_init_V, stores,
)

__all__ = ["stores"]


def _port_trained(monkeypatch, iters):
    """The port's train from the reference's initial factors."""
    def init(n_items, n_items_pad, k, s, device):
        import torch

        V = np.zeros((n_items_pad, k), np.float32)
        V[:n_items] = _reference_init_V(s, n_items)
        return torch.from_numpy(V).to(device)

    monkeypatch.setattr(port_als, "_init_item_factors", init)
    engine = port_rec.engine()
    params = port_rec.default_engine_params(TRAIN_APP, rank=TRAIN_RANK,
                                            num_iterations=iters)
    return engine.train(types.SimpleNamespace(device="cpu"),
                        params).models[0]


async def test_canary_answers_match_reference(stores, monkeypatch):
    """Both packages train v1 (8 sweeps) and v2 (3 sweeps) from the same
    store and params, serve v1 and canary v2 at fraction 0.5 through
    ``POST /deploy.json``; the same queries go to the same arm and get
    the same items, scores within rtol 1e-3."""
    import jax

    from predictionio_tpu.workflow import run_train
    from predictionio_tpu.workflow.context import WorkflowContext
    from predictionio_tpu.workflow.train import load_for_deploy

    db = stores / "ref.db"
    _ref_write(db, _event_rows())
    ref_engine = ref_rec.engine()
    ref_insts = [run_train(
        ref_engine, ref_rec.default_engine_params(
            TRAIN_APP, rank=TRAIN_RANK, num_iterations=iters),
        engine_factory="predictionio_tpu.engines.recommendation:engine",
        ctx=WorkflowContext(mode="Training", devices=jax.devices()[:1]))
        for iters in (ITERS, 3)]
    ref_result, ref_ctx = load_for_deploy(ref_engine, ref_insts[0])
    ref_rels = RefStorage.get_meta_data_releases().get_for_variant(
        ref_insts[0].engine_id, ref_insts[0].engine_version,
        ref_insts[0].engine_variant)
    assert [r.version for r in ref_rels] == [2, 1]
    ref_server = RefQueryServer(
        ref_engine, ref_result, ref_insts[0], ctx=ref_ctx,
        serving_config=ref_config.ServingConfig(batch_max=4,
                                                batch_linger_s=0.0),
        deploy_config=ref_config.DeployConfig(warmup=False),
        release=ref_rels[1])

    # the port trains from the same store, then records into its own
    Storage.configure(_train_config(db))
    models = [_port_trained(monkeypatch, iters) for iters in (ITERS, 3)]
    Storage.reset()
    Storage.configure(_train_config(stores / "port.db"))
    port_engine = port_rec.engine()
    insts = []
    for n, model in enumerate(models):
        inst = EngineInstance(
            id=f"port-v{n + 1}", status="COMPLETED",
            engine_id=ref_insts[0].engine_id, engine_version="1",
            engine_variant=ref_insts[0].engine_variant,
            data_source_params=json.dumps({"appName": TRAIN_APP}),
            algorithms_params=json.dumps([{"name": "als", "params": {
                "rank": TRAIN_RANK}}]))
        Storage.get_meta_data_engine_instances().insert(inst)
        blob = serialize_models([model])
        Storage.get_model_data_models().insert(Model(id=inst.id,
                                                     models=blob))
        insts.append((inst, record_release(inst, 1.0, blob), model))
    (inst1, rel1, model1), _ = insts
    server = QueryServer(
        port_engine, port_engine.prepare_deploy(
            port_engine.engine_params_from_json({"algorithms": [
                {"name": "als", "params": {"rank": TRAIN_RANK}}]}),
            [model1]), inst1,
        scorer_config=ScorerConfig(mode="exact"), max_batch=4,
        linger_s=0.0, release=rel1,
        deploy_config=DeployConfig(warmup=False))
    body = {"version": 2, "canaryFraction": 0.5, "canaryPromoteAfter":
            10_000, "canaryP99Ratio": 1000.0, "canaryLatencySlackS": 100.0}
    ref_client = TestClient(TestServer(ref_server.app))
    await ref_client.start_server()
    http = await _started(server)
    try:
        resp = await ref_client.post("/deploy.json", json=body)
        assert resp.status == 200, await resp.json()
        status, out = await http.call("POST", "/deploy.json", body)
        assert status == 200, out
        for q in QUERIES * 3:
            resp = await ref_client.post("/queries.json", json=q)
            want = await resp.json()
            status, got = await http.call("POST", "/queries.json", q)
            assert status == resp.status == 200
            assert [s["item"] for s in got["itemScores"]] == \
                [s["item"] for s in want["itemScores"]], q
            np.testing.assert_allclose(
                [s["score"] for s in got["itemScores"]],
                [s["score"] for s in want["itemScores"]], rtol=1e-3)
        assert server._canary.controller.to_dict()["canary"]["total"] == \
            ref_server._canary.controller.to_dict()["canary"]["total"] == \
            len(QUERIES) * 3 // 2
    finally:
        await http.close()
        await server.close()
        await ref_client.close()
