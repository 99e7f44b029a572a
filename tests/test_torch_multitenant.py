"""Multi-tenant serving of the port (``server/multitenant.py``, the warm
residency of ``server/query_server.py``, ``server/http.py``'s mounts and
``utils/server_config.MultiTenantConfig``), held against the JAX
package's host on the same specs: models made with numpy from a seed at
2,000 items x rank 16, the port's on ``device="cpu"``. The reference's
host runs under aiohttp's test client, the port's on its own HTTP layer.

* ``MultiTenantConfig``'s precedence and clamps and the host's name
  validation equal the reference's.
* Per-tenant routing answers as the reference's host does (ids equal up
  to ties broken by ``ops/topk.merge_topk``'s rule, scores within
  1e-5); ``/tenants.json`` and ``/residency.json`` have its keys and
  residency flags; a tenant's ``deploy/status.json`` is reached through
  the mount.
* An evicted and reloaded tenant answers byte-identically, with the same
  ledger bytes, and its models hold no device copy while warm; the LRU
  order on a miss and on a sweep is the reference's for the same query
  sequence (each package's budget the same fraction of its own
  standalone sum); the ``min_resident`` floor holds; eviction is refused
  mid-canary, mid-reload and on a warm unit; a reload that times out
  answers 503 with Retry-After; a deploy racing a warm reload wins
  (``warm_reload_raced``); each of the four kill points leaves the
  tenant whole or warm, never half-resident.
* A burning tenant gets 429 and a quiet one is unaffected, the 429s not
  counted as failures; the tenant label overflows to ``other`` past
  ``max_tenant_series``.
* ``fused_int8`` and ``fused_bf16`` tenants run in one process, each
  holder resolving its own config, the process pin untouched.
* The port's router over the port's host answers
  ``/t/{tenant}/queries.json``.
"""

import asyncio
import json
import threading
import time

import aiohttp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

import predictionio_tpu.engines.recommendation as ref_rec
import predictionio_tpu.models.als as ref_als
import predictionio_tpu.server.multitenant as ref_mt
import predictionio_tpu.storage.faults as ref_faults
import predictionio_tpu_torch.engines.recommendation as port_rec
import predictionio_tpu_torch.models.als as port_als
import predictionio_tpu_torch.server.multitenant as port_mt
import predictionio_tpu_torch.storage.faults as port_faults
from predictionio_tpu.core.engine import Engine as RefEngine
from predictionio_tpu.core.engine import TrainResult as RefTrainResult
from predictionio_tpu.core.params import EngineParams as RefEngineParams
from predictionio_tpu.deploy.releases import (
    record_release as ref_record_release,
)
from predictionio_tpu.models.als import ALSModel as RefALSModel
from predictionio_tpu.storage import Model as RefModel
from predictionio_tpu.storage import Storage as RefStorage
from predictionio_tpu.storage.base import EngineInstance as RefEngineInstance
from predictionio_tpu.utils import server_config as ref_config
from predictionio_tpu.workflow.serialization import (
    serialize_models as ref_serialize_models,
)
from predictionio_tpu_torch.deploy.releases import record_release
from predictionio_tpu_torch.models.als import ALSModel
from predictionio_tpu_torch.ops import scoring as port_scoring
from predictionio_tpu_torch.server.http import HttpServer, Request
from predictionio_tpu_torch.storage.base import EngineInstance, Model
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils import server_config as port_config
from predictionio_tpu_torch.workflow.serialization import serialize_models

pytestmark = pytest.mark.anyio

N_USERS, N_ITEMS, RANK = 24, 2000, 16
ENGINE_ID = "mt-test-engine"
SCORE_TOL = 1e-5
USERS = ("u1", "u5", "u17", "nosuchuser")


def _arrays(seed, n_items=N_ITEMS):
    rng = np.random.default_rng(seed)
    return (np.sort(np.asarray([f"u{i}" for i in range(N_USERS)],
                               dtype=object)),
            np.sort(np.asarray([f"i{i}" for i in range(n_items)],
                               dtype=object)),
            rng.normal(size=(N_USERS, RANK)).astype(np.float32),
            rng.normal(size=(n_items, RANK)).astype(np.float32))


def _config(path):
    return {"sources": {"DB": {"TYPE": "sqlite", "PATH": str(path)}},
            "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                             for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}}


@pytest.fixture()
def stores(tmp_path):
    Storage.reset()
    RefStorage.reset()
    Storage.configure(_config(tmp_path / "port.db"))
    RefStorage.configure(_config(tmp_path / "ref.db"))
    yield tmp_path
    Storage.reset()
    RefStorage.reset()
    port_faults.set_kill_points([])
    ref_faults.set_kill_points([])


@pytest.fixture()
def device_resident(monkeypatch):
    """Both packages score on the device lane (the exact scorer's
    resident V is what the capacity ledger attributes)."""
    monkeypatch.setattr(ref_als, "_DEVICE_ROUNDTRIP_S", 0.0)
    monkeypatch.setattr(port_als, "_DEVICE_ROUNDTRIP_S", 0.0)


def _instance(cls, name):
    return cls(id=f"mt-{name}", status="COMPLETED", engine_id=ENGINE_ID,
               engine_version="1", engine_variant=name,
               data_source_params=json.dumps({"appName": f"{name}App"}),
               algorithms_params=json.dumps(
                   [{"name": "als", "params": {"rank": RANK}}]))


def port_spec(name, seed, n_items=N_ITEMS, slo=None, mode="exact"):
    """A persisted, reloadable tenant of the port: instance, blob and
    release in the store, so the warm reload has something to load."""
    model = ALSModel.from_arrays(*_arrays(seed, n_items), device="cpu")
    inst = _instance(EngineInstance, name)
    Storage.get_meta_data_engine_instances().insert(inst)
    blob = serialize_models([model])
    Storage.get_model_data_models().insert(Model(id=inst.id, models=blob))
    release = record_release(inst, train_seconds=1.0, blob=blob)
    result = port_rec.engine().prepare_deploy(
        port_rec.default_engine_params(f"{name}App", rank=RANK), [model])
    return port_mt.TenantSpec(
        name=name, engine=port_rec.engine(), train_result=result,
        instance=inst, release=release,
        scorer_config=port_config.ScorerConfig(mode=mode),
        deploy_config=port_config.DeployConfig(warmup=False,
                                               drain_timeout_s=5.0),
        slo=slo, max_batch=8, linger_s=0.0)


def ref_spec(name, seed, n_items=N_ITEMS, slo=None, mode="exact"):
    users, items, U, V = _arrays(seed, n_items)
    model = RefALSModel(user_vocab=users, item_vocab=items, U=U, V=V)
    inst = _instance(RefEngineInstance, name)
    RefStorage.get_meta_data_engine_instances().insert(inst)
    blob = ref_serialize_models([model])
    RefStorage.get_model_data_models().insert(RefModel(id=inst.id,
                                                       models=blob))
    release = ref_record_release(inst, train_seconds=1.0, blob=blob)
    result = RefTrainResult(
        models=[model],
        algorithms=[ref_rec.ALSAlgorithm(ref_rec.AlgorithmParams(
            rank=RANK))],
        serving=ref_rec.RecommendationServing(),
        engine_params=RefEngineParams(
            data_source_params=ref_rec.DataSourceParams(
                app_name=f"{name}App")))
    return ref_mt.TenantSpec(
        name=name, engine=RefEngine(
            data_source_classes=ref_rec.RecommendationDataSource,
            preparator_classes=ref_rec.RecommendationPreparator,
            algorithm_classes={"als": ref_rec.ALSAlgorithm},
            serving_classes=ref_rec.RecommendationServing),
        train_result=result, instance=inst, ctx=None, release=release,
        scorer_config=ref_config.ScorerConfig(mode=mode),
        serving_config=ref_config.ServingConfig(batch_max=8,
                                                batch_linger_s=0.0),
        deploy_config=ref_config.DeployConfig(warmup=False,
                                              drain_timeout_s=5.0),
        slo=slo)


def _mt_config(cfg_mod, **cfg):
    defaults = dict(budget_bytes=0, reload_wait_s=5.0,
                    sweep_interval_s=60.0, min_resident=0)
    defaults.update(cfg)
    return cfg_mod.MultiTenantConfig(**defaults)


class PortHost:
    """The port's host, started on this loop, driven over HTTP."""

    def __init__(self, specs, **cfg):
        self.host = port_mt.MultiTenantServer(
            specs, config=_mt_config(port_config, **cfg))

    async def __aenter__(self):
        port = await self.host.start("127.0.0.1", 0)
        self.base = f"http://127.0.0.1:{port}"
        self.session = aiohttp.ClientSession()
        return self

    async def __aexit__(self, *exc):
        await self.session.close()
        await self.host.close()

    async def call(self, method, path, body=None, data=None):
        async with self.session.request(
                method, self.base + path, json=body, data=data,
                headers={"Content-Type": "application/json"}) as r:
            return r.status, await r.json(), dict(r.headers)


class RefHost:
    """The reference's host under aiohttp's test client."""

    def __init__(self, specs, **cfg):
        self.host = ref_mt.MultiTenantServer(
            specs, config=_mt_config(ref_config, **cfg))

    async def __aenter__(self):
        self.client = TestClient(TestServer(self.host.app))
        await self.client.start_server()
        return self

    async def __aexit__(self, *exc):
        await self.client.close()

    async def call(self, method, path, body=None, data=None):
        r = await self.client.request(
            method, path, json=body, data=data,
            headers={"Content-Type": "application/json"})
        return r.status, await r.json(), dict(r.headers)


async def scores(h, tenant, user="u1", num=10):
    status, body, _ = await h.call("POST", f"/t/{tenant}/queries.json",
                                   {"user": user, "num": num})
    assert status == 200, body
    return body["itemScores"]


def assert_same_answer(got, want):
    """Ids equal up to ties (equal scores may come in either order),
    scores within SCORE_TOL."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g["score"] - w["score"]) <= SCORE_TOL, (g, w)
    gs = sorted((round(x["score"], 4), x["item"]) for x in got)
    ws = sorted((round(x["score"], 4), x["item"]) for x in want)
    assert [i for _, i in gs] == [i for _, i in ws]


# ---------------------------------------------------------------------------
# config and names
# ---------------------------------------------------------------------------

CONFIG_CASES = {
    "file": ({"budgetBytes": 1024, "reloadWaitS": 3.0,
              "admission": False}, {}),
    "env_beats_file": ({"budgetBytes": 1024, "sweepIntervalS": 7.0},
                       {"PIO_MT_DEVICE_BUDGET_BYTES": "2048",
                        "PIO_MT_SWEEP_INTERVAL_S": "junk",
                        "PIO_MT_MIN_RESIDENT": "3"}),
    "clamps": ({"reloadWaitS": 0.0, "budgetBytes": -5},
               {"PIO_MT_MAX_TENANT_SERIES": "0",
                "PIO_MT_SWEEP_INTERVAL_S": "0.001",
                "PIO_MT_RETRY_AFTER_S": "-1", "PIO_MT_MIN_RESIDENT": "-2"}),
    "bools": ({"admission": "off"}, {"PIO_MT_ADMISSION": "yes",
                                     "PIO_MT_RELOAD_WAIT_S": "2.5"}),
}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_multitenant_config_matches_reference(monkeypatch, tmp_path, case):
    data, env = CONFIG_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = port_config.MultiTenantConfig.from_env(data)
    assert vars(got) == vars(ref_config.MultiTenantConfig.from_env(data))
    # the server.json "multitenant" section through the resolver
    conf = tmp_path / "server.json"
    conf.write_text(json.dumps({"multitenant": data}))
    monkeypatch.setenv("PIO_SERVER_CONF", str(conf))
    assert vars(port_config.multitenant_config()) == \
        vars(ref_config.multitenant_config())


@pytest.mark.parametrize("names", [[""], ["a/b"], ["a b"], ["-lead"],
                                   ["{x}"], ["ok", "ok"], []])
def test_tenant_name_validation_matches_reference(stores, names):
    def build(mod, spec_fn):
        specs = [spec_fn("ok", seed=1)] if names else []
        out = []
        for n in names:
            spec = specs[0] if n == "ok" else None
            if spec is None:
                spec = mod.TenantSpec(
                    name=n, engine=specs[0].engine if specs else None,
                    train_result=None, instance=None,
                    **({"ctx": None} if mod is ref_mt else {}))
            out.append(spec)
        with pytest.raises(ValueError) as err:
            mod.MultiTenantServer(out)
        return str(err.value)

    assert build(port_mt, port_spec) == build(ref_mt, ref_spec)


# ---------------------------------------------------------------------------
# routing and answers
# ---------------------------------------------------------------------------

async def test_routing_answers_and_surfaces_match_reference(stores):
    """Three variants in one process answer as the reference's host does,
    each from its own factors; the host's documents have its keys and
    flags; a tenant's own routes answer through the mount."""
    tenants = (("alpha", 1), ("beta", 2), ("gamma", 3))
    async with PortHost([port_spec(n, s) for n, s in tenants]) as p, \
            RefHost([ref_spec(n, s) for n, s in tenants]) as r:
        got = {}
        for name, _ in tenants:
            for user in USERS:
                a, b = await scores(p, name, user), await scores(r, name,
                                                                 user)
                assert_same_answer(a, b)
                got[name, user] = a
        assert len({json.dumps(got[n, "u1"]) for n, _ in tenants}) == 3
        for path in ("/", "/tenants.json", "/residency.json"):
            ps, pdoc, _ = await p.call("GET", path)
            rs, rdoc, _ = await r.call("GET", path)
            assert ps == rs == 200
            assert set(pdoc) == set(rdoc)
            if "tenants" in pdoc and isinstance(pdoc["tenants"][0], dict):
                for pt, rt in zip(pdoc["tenants"], rdoc["tenants"]):
                    assert set(pt) == set(rt)
                    assert (pt["tenant"], pt["resident"], pt["canary"],
                            pt["engineInstanceId"], pt["scorerMode"]) == \
                        (rt["tenant"], rt["resident"], rt["canary"],
                         rt["engineInstanceId"], rt["scorerMode"])
            else:
                assert pdoc["tenants"] == rdoc["tenants"]
        ps, pst, _ = await p.call("GET", "/t/beta/deploy/status.json")
        rs, rst, _ = await r.call("GET", "/t/beta/deploy/status.json")
        assert ps == rs == 200
        assert pst["resident"] is rst["resident"] is True
        assert pst["active"]["engineInstanceId"] == \
            rst["active"]["engineInstanceId"] == "mt-beta"
        for h in (p, r):
            status, body, _ = await h.call("POST", "/t/nosuch/queries.json",
                                           {"user": "u1", "num": 3})
            assert status == 404 and "nosuch" in body["message"]
        assert (await p.call("GET", "/t/nosuch/deploy/status.json"))[0] \
            == 404
        for name, _ in tenants:
            assert p.host._queries.value(tenant=name) == \
                r.host._queries.value(tenant=name) == len(USERS)


async def test_mounted_routes_are_observed_once(stores):
    """The host's middleware (service ``multitenant``) observes a mounted
    route once, under its full path; the tenant's own middleware does
    not run; the gate's exact route outranks the mount."""
    async with PortHost([port_spec("alpha", 1)]) as p:
        await scores(p, "alpha")
        await p.call("GET", "/t/alpha/deploy/status.json")
        hist = p.host.registry.get("pio_http_request_duration_seconds")
        seen = {(lb["service"], lb["handler"]): hist.count(**lb)
                for lb, _ in hist.samples()}
        assert seen == {
            ("multitenant", "/t/alpha/queries.json"): 1,
            ("multitenant", "/t/alpha/deploy/status.json"): 1}
        srv = p.host.tenants["alpha"].server
        assert srv._query_hist.total_count() == 1


async def test_http_mount_precedence():
    """An own route outranks a mount; a mounted path answers with the
    prefix cut; a wrong method under a mount answers 405; a path no
    route and no mount takes answers 404."""
    async def own(req):
        return 200, {"own": req.path}

    async def sub_route(req):
        return 200, {"sub": req.path, "params": req.params}

    inner = HttpServer([("GET", "/x.json", sub_route),
                        ("GET", "/items/{id}.json", sub_route)])
    outer = HttpServer([("GET", "/t/a/x.json", own)])
    outer.mount("/t/a/", inner)

    def req(method, path):
        return Request(method=method, path=path, query={}, headers={},
                       body=b"")

    assert await outer.dispatch(req("GET", "/t/a/x.json")) == \
        (200, {"own": "/t/a/x.json"}, {})
    assert await outer.dispatch(req("GET", "/t/a/items/7.json")) == \
        (200, {"sub": "/t/a/items/7.json", "params": {"id": "7"}}, {})
    assert (await outer.dispatch(req("POST", "/t/a/items/7.json")))[0] \
        == 405
    assert (await outer.dispatch(req("GET", "/t/b/x.json")))[0] == 404
    assert (await outer.dispatch(req("GET", "/t/a")))[0] == 404


# ---------------------------------------------------------------------------
# eviction and reload
# ---------------------------------------------------------------------------

async def test_evict_reload_byte_identical(stores, device_resident):
    """A full evict -> warm-reload cycle: the factors drop (the unit's
    models hold no device copy), the next hits reload through the
    deploy ladder, the answers are byte-identical and the ledger's
    bytes the same; the counters are the reference's."""
    async with PortHost([port_spec("alpha", 1)]) as p, \
            RefHost([ref_spec("alpha", 1)]) as r:
        for h in (p, r):
            server = h.host.tenants["alpha"].server
            before = {u: await scores(h, "alpha", u) for u in USERS}
            bytes_before = server.warm_bytes
            assert bytes_before > 0
            models = list(server._unit.result.models)
            assert await server.evict_to_warm("test") is True
            assert not server.resident
            assert server.warm_bytes == bytes_before
            assert server._unit.result is None and server._standby is None
            if h is p:
                for m in models:
                    assert getattr(m, "_resident", None) is None
                    assert getattr(m, "_scorer_cache", None) is None
            status, doc, _ = await h.call("GET", "/residency.json")
            assert doc["residentBytes"] == 0
            assert doc["tenants"][0]["warmBytes"] == bytes_before
            after = {u: await scores(h, "alpha", u) for u in USERS}
            assert after == before
            assert server.resident and server.warm_bytes == bytes_before
            assert server._evict_total.value(reason="test") == 1
            assert server._reload_total.value(status="warm_reload") == 1
        pb = p.host.tenants["alpha"].server.warm_bytes
        assert pb == r.host.tenants["alpha"].server.warm_bytes
        st = (await p.call("GET", "/t/alpha/deploy/status.json"))[1]
        kinds = [e["kind"] for e in st["deploy"]["recentEvents"]]
        assert kinds == ["evict", "swap"]
        assert st["deploy"]["swaps"] == {"evict/ok": 1,
                                         "warm_reload/ok": 1}
        reload = st["deploy"]["recentEvents"][1]
        assert reload["mode"] == "warm_reload" and reload["loadS"] >= 0


async def test_eviction_releases_a_foldin_drift_and_its_solver(
        stores, device_resident):
    """The port's own rule: evicting a unit that is a fold-in drift drops
    the device copies it shares with its base (the standby), and the
    fold-in controller's solver and vocab caches; the controller holds
    its deltas while the unit is warm; the next query reloads the
    stored instance."""
    from predictionio_tpu_torch.deploy import foldin as port_foldin

    async with PortHost([port_spec("alpha", 1)]) as p:
        server = p.host.tenants["alpha"].server
        base_answer = await scores(p, "alpha")
        base = server._unit
        model = base.result.models[0]
        drift = base.result.algorithms[0].foldin_apply(
            model, None, {"u1": np.ones(RANK, np.float32)}, {}, {})
        assert drift._resident is model._resident      # shared copy
        server.swap_foldin_unit(server.build_foldin_unit([drift], 1))
        assert server._standby is base
        ctl = port_foldin.FoldInController(
            server, port_config.FoldinConfig(enabled=True,
                                             apply_interval_s=3600.0))
        server._foldin = ctl
        ctl._solver_cache = (model.V, object())
        ctl._vocab_cache = (model, model.item_vocab)
        assert await server.evict_to_warm("test") is True
        for m in (model, drift):
            assert m._resident is None and m._scorer_cache is None
        assert ctl._solver_cache is None and ctl._vocab_cache is None
        assert base.result is None and server._standby is None
        held = ctl._m_applies.value(outcome="held")
        from predictionio_tpu_torch.data.event import Event

        ctl.offer([Event(event="rate", entity_type="user", entity_id="u2",
                         target_entity_type="item", target_entity_id="i3",
                         properties={"rating": 4.0})])
        assert ctl.apply_pending() is None
        assert "u2" in ctl._dirty_users          # held, not dropped
        assert ctl._m_applies.value(outcome="held") == held + 1
        server._foldin = None
        assert await scores(p, "alpha") == base_answer


async def test_budget_lru_order_matches_reference(stores, device_resident):
    """An undersized budget: the sweep evicts the least-recently-queried
    tenant, a miss on it evicts the next least-recent, and back; the
    residency after each step is the reference's, each package's budget
    1.5x its own larger tenant."""
    async def trajectory(h, n_items=300):
        t = h.host.tenants
        steps = []

        def flags():
            return tuple(t[n].server.resident for n in ("alpha", "beta"))

        a = await scores(h, "alpha")
        b = await scores(h, "beta")
        sizes = [t[n].server.warm_bytes for n in ("alpha", "beta")]
        h.host.config.budget_bytes = int(max(sizes) * 1.5)
        assert sum(sizes) > h.host.config.budget_bytes
        await scores(h, "alpha")
        await h.host.enforce_budget()
        steps.append(("sweep", flags(),
                      h.host.resident_bytes() <= h.host.config.budget_bytes))
        steps.append(("miss beta", await scores(h, "beta") == b, flags()))
        steps.append(("miss alpha", await scores(h, "alpha") == a, flags()))
        await h.host.enforce_budget()
        steps.append(("sweep again", flags()))
        return steps

    specs = [("alpha", 1), ("beta", 2)]
    async with PortHost([port_spec(n, s, n_items=300)
                         for n, s in specs]) as p, \
            RefHost([ref_spec(n, s, n_items=300) for n, s in specs]) as r:
        got, want = await trajectory(p), await trajectory(r)
    assert got == want
    assert got[0] == ("sweep", (True, False), True)


@pytest.mark.parametrize("min_resident", [1, 2])
async def test_min_resident_floor_holds(stores, device_resident,
                                        min_resident):
    """The sweep never evicts below ``min_resident``, even when nothing
    fits, as the reference's."""
    async def left(h):
        for n in ("alpha", "beta"):
            await scores(h, n)
        h.host.config.budget_bytes = 1
        await h.host.enforce_budget()
        return sorted(t.name for t in h.host.tenants.values()
                      if t.server.resident)

    specs = [("alpha", 1), ("beta", 2)]
    async with PortHost([port_spec(n, s) for n, s in specs],
                        min_resident=min_resident) as p, \
            RefHost([ref_spec(n, s) for n, s in specs],
                    min_resident=min_resident) as r:
        got, want = await left(p), await left(r)
    assert got == want and len(got) == min_resident


async def test_evict_refused_mid_canary_mid_reload_and_when_warm(stores):
    async with PortHost([port_spec("alpha", 1)]) as p:
        server = p.host.tenants["alpha"].server
        server._reload_event = asyncio.Event()
        assert await server.evict_to_warm() is False
        server._reload_event = None
        server._canary = object()       # only `is not None` is read
        assert await server.evict_to_warm() is False
        # the budgeter skips a tenant mid-canary
        p.host.config.budget_bytes = 1
        assert await p.host._evict_lru() is False
        server._canary = None
        assert await server.evict_to_warm() is True
        assert await server.evict_to_warm() is False


async def test_reload_timeout_answers_503_with_retry_after(stores):
    """Queries during a stuck reload wait at most ``reload_wait_s``:
    then a clean 503 with Retry-After; once the reload completes the
    tenant serves the same answers again."""
    async with PortHost([port_spec("alpha", 1)], reload_wait_s=0.2,
                        retry_after_s=2.0) as p:
        server = p.host.tenants["alpha"].server
        gate = threading.Event()
        real_prepare = server._prepare_unit

        def stalled_prepare(*args, **kwargs):
            gate.wait(10)
            return real_prepare(*args, **kwargs)

        server._prepare_unit = stalled_prepare
        try:
            baseline = await scores(p, "alpha")
            assert await server.evict_to_warm() is True
            status, _, headers = await p.call(
                "POST", "/t/alpha/queries.json", {"user": "u1", "num": 10})
            assert status == 503 and headers["Retry-After"] == "2"
            assert p.host._reload_timeouts.value(tenant="alpha") == 1
            gate.set()
            deadline = time.monotonic() + 5
            while not server.resident and time.monotonic() < deadline:
                await asyncio.sleep(0.02)
            assert await scores(p, "alpha") == baseline
        finally:
            gate.set()


async def test_deploy_racing_warm_reload_wins(stores):
    """A deploy that lands while a warm reload is in flight wins: the
    reloaded unit is dropped (counted ``warm_reload_raced``), never
    installed over the newer cutover."""
    async with PortHost([port_spec("alpha", 1)]) as p:
        server = p.host.tenants["alpha"].server
        await scores(p, "alpha")
        assert await server.evict_to_warm() is True
        warm = server._unit
        hold = threading.Event()
        real_prepare = server._prepare_unit
        raced_units = []

        def slow_prepare(*args, **kwargs):
            out = real_prepare(*args, **kwargs)
            raced_units.append(out[0])
            hold.wait(10)
            return out

        server._prepare_unit = slow_prepare
        ev = asyncio.Event()
        server._reload_event = ev
        task = asyncio.get_running_loop().create_task(
            server._reload_from_warm(ev))
        try:
            while not raced_units:
                await asyncio.sleep(0.01)
            deployed, _, _ = await asyncio.to_thread(
                real_prepare, warm.instance, warm.release)
            await server._swap_to(deployed, mode="deploy",
                                  reason="race-test")
            hold.set()
            await task
        finally:
            hold.set()
        assert server._unit is deployed
        assert server._reload_total.value(status="warm_reload_raced") == 1
        assert raced_units[0].result is None        # dropped, not leaked
        assert server.resident and await scores(p, "alpha")


@pytest.mark.parametrize("point", ["mt:evict:drained", "mt:evict:committed",
                                   "mt:reload:loaded",
                                   "mt:reload:committed"])
async def test_kill_points_never_half_resident(stores, device_resident,
                                               point):
    """A crash at each of the four boundaries leaves the active unit
    whole or warm (as the reference's does at the same point), and the
    next query recovers the same answers."""
    async def run(h, faults):
        server = h.host.tenants["alpha"].server
        baseline = await scores(h, "alpha")
        if point.startswith("mt:reload"):
            assert await server.evict_to_warm("chaos") is True
            ev = asyncio.Event()
            server._reload_event = ev
            faults.set_kill_points([point])
            with pytest.raises(faults.CrashError):
                await server._reload_from_warm(ev)
            assert ev.is_set() and server._reload_event is None
        else:
            faults.set_kill_points([point])
            with pytest.raises(faults.CrashError):
                await server.evict_to_warm("chaos")
        faults.set_kill_points([])
        landed = server.resident
        assert (server._unit.result is None) is not landed
        assert await scores(h, "alpha") == baseline and server.resident
        return landed

    async with PortHost([port_spec("alpha", 1)]) as p, \
            RefHost([ref_spec("alpha", 1)]) as r:
        got = await run(p, port_faults)
        want = await run(r, ref_faults)
    assert got == want == (point == "mt:reload:committed")


# ---------------------------------------------------------------------------
# admission and labels
# ---------------------------------------------------------------------------

SLO = {"objectives": [{"name": "errors", "kind": "errors",
                       "budget": 0.1}],
       "windows": [{"seconds": 60, "burnThreshold": 1.0}],
       "evalIntervalS": 60}


async def test_burning_tenant_is_shed_quiet_tenant_unaffected(stores):
    """A tenant burning its error budget gets 429 with Retry-After, the
    co-hosted quiet tenant keeps answering, and the shed queries are not
    failures; the same counts as the reference's."""
    async def run(h):
        noisy = h.host.tenants["noisy"]
        t0 = time.monotonic()
        noisy.slo.tick(now=t0)
        bad = [(await h.call("POST", "/t/noisy/queries.json",
                             data=b"{not json"))[0] for _ in range(5)]
        noisy.slo.tick(now=t0 + 31)
        breached = noisy.slo.breached(exclude_kinds=("freshness",))
        status, _, headers = await h.call(
            "POST", "/t/noisy/queries.json", {"user": "u1", "num": 3})
        quiet = await scores(h, "quiet")
        h.host.config.admission = False
        again = await scores(h, "noisy")
        return (bad, breached, status, headers.get("Retry-After"),
                h.host._rejected.value(tenant="noisy"),
                h.host._failures.value(tenant="noisy"),
                h.host._rejected.value(tenant="quiet"), len(quiet),
                len(again))

    specs = [("noisy", 1), ("quiet", 2)]
    async with PortHost([port_spec(n, s, slo=SLO) for n, s in specs],
                        admission=True, retry_after_s=2.0) as p, \
            RefHost([ref_spec(n, s, slo=SLO) for n, s in specs],
                    admission=True, retry_after_s=2.0) as r:
        got, want = await run(p), await run(r)
    assert got == want
    assert got[:5] == ([400] * 5, True, 429, "2", 1)


async def test_tenant_label_explosion_collapses_to_other(stores):
    """The tenant label rides the registry's ``max_series`` guard: new
    tenant values past ``max_tenant_series`` collapse into ``other``,
    the established tenants keep their series, as the reference's."""
    async def run(h):
        host = h.host
        caps = (host._queries.max_series, host._hist.max_series)
        await scores(h, "alpha")
        await scores(h, "beta")
        for i in range(40):
            host._queries.inc(tenant=f"exploded-{i}")
        await scores(h, "alpha")
        overflow = host.registry.get("pio_obs_label_overflow_total")
        return (caps, host._queries.value(tenant="other"),
                host._queries.series_count(),
                host._queries.value(tenant="alpha"),
                host._queries.value(tenant="beta"),
                overflow.value(metric="pio_tenant_queries_total"))

    specs = [("alpha", 1), ("beta", 2)]
    async with PortHost([port_spec(n, s) for n, s in specs],
                        max_tenant_series=2) as p, \
            RefHost([ref_spec(n, s) for n, s in specs],
                    max_tenant_series=2) as r:
        got, want = await run(p), await run(r)
    assert got == want == ((2, 2), 40, 3, 2, 1, 40)


# ---------------------------------------------------------------------------
# scorer residency
# ---------------------------------------------------------------------------

async def test_per_tenant_scorer_residency_in_one_process(stores,
                                                         device_resident):
    """An int8 tenant and a bf16 tenant in one process: each holder
    resolves its own config, builds its own quantization, answers as
    the reference's tenant of the same mode, and the process pin is
    untouched."""
    pin = port_config.ScorerConfig(mode="exact")
    port_scoring.set_process_scorer_config(pin)
    try:
        specs = [("int8", 1, "fused_int8"), ("bf16", 2, "fused_bf16")]
        async with PortHost([port_spec(n, s, mode=m)
                             for n, s, m in specs]) as p, \
                RefHost([ref_spec(n, s, mode=m)
                         for n, s, m in specs]) as r:
            for name, _, mode in specs:
                for user in USERS:
                    assert_same_answer(await scores(p, name, user),
                                       await scores(r, name, user))
                model = p.host.tenants[name].server.result.models[0]
                assert port_scoring.holder_scorer_config(model).mode == mode
                scorer = model._scorer_cache[2]
                assert scorer.quantization == mode.split("_")[1].replace(
                    "bf16", "bfloat16")
            assert port_scoring.process_scorer_config() is pin
    finally:
        port_scoring.set_process_scorer_config(None)


# ---------------------------------------------------------------------------
# the router over the host
# ---------------------------------------------------------------------------

async def test_port_router_proxies_tenant_queries_to_the_host(stores):
    from predictionio_tpu_torch.server import router as port_router

    async with PortHost([port_spec("alpha", 1),
                         port_spec("beta", 2)]) as p:
        router = port_router.Router(
            port_config.RouterConfig(replicas=1, health_interval_s=0.05,
                                     health_fail_after=2, proxy_retries=1,
                                     drain_timeout_s=5.0),
            spawn=None, replica_urls=(p.base,))
        port = await router.start("127.0.0.1", 0)
        try:
            assert await router.wait_replica_healthy(0, timeout_s=10)
            async with aiohttp.ClientSession() as s:
                for name in ("alpha", "beta"):
                    async with s.post(
                            f"http://127.0.0.1:{port}/t/{name}/queries.json",
                            json={"user": "u5", "num": 10}) as resp:
                        assert resp.status == 200
                        body = await resp.json()
                    assert body["itemScores"] == await scores(p, name, "u5")
                async with s.post(
                        f"http://127.0.0.1:{port}/t/nosuch/queries.json",
                        json={"user": "u5", "num": 10}) as resp:
                    assert resp.status == 404
        finally:
            await router.close()
