"""The slice as a whole: a model trained by the JAX package (sqlite event
store, as tests/test_recommendation_e2e.py trains it) is written to the
port's ``.npz`` and served by the port's stdlib query server on an
ephemeral port; its ``/queries.json`` answers match the reference's
``create_query_server`` on the same queries — same items, scores within
rtol 1e-4 — in ``exact`` and ``twostage`` modes. The error contract
(400 with ``{"message": ...}``) matches too.
"""

import json

import aiohttp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from predictionio_tpu.data import DataMap, Event
from predictionio_tpu.engines.recommendation import (
    default_engine_params, engine as ref_engine_factory,
)
from predictionio_tpu.ops import scoring as ref_scoring
from predictionio_tpu.server.query_server import (
    create_query_server as ref_create_query_server,
)
from predictionio_tpu.storage import App, Storage
from predictionio_tpu.utils.server_config import ScorerConfig as RefConfig
from predictionio_tpu.workflow import run_train
from predictionio_tpu.workflow.train import load_for_deploy
from predictionio_tpu_torch.deploy.warm import EngineInstance
from predictionio_tpu_torch.engines.recommendation import engine
from predictionio_tpu_torch.ops import kernels
from predictionio_tpu_torch.ops import scoring as port_scoring
from predictionio_tpu_torch.server.query_server import create_query_server
from predictionio_tpu_torch.utils.server_config import ScorerConfig
from predictionio_tpu_torch.workflow.serialization import (
    load_model, save_model,
)

pytestmark = pytest.mark.anyio


@pytest.fixture()
def trained(tmp_path):
    """Train the reference recommendation engine on synthetic ratings in
    a sqlite event store (30 users x 20 items, block structure)."""
    Storage.configure({
        "sources": {"DB": {"TYPE": "sqlite",
                           "PATH": str(tmp_path / "e2e.db")}},
        "repositories": {
            "METADATA": {"NAME": "pio", "SOURCE": "DB"},
            "EVENTDATA": {"NAME": "pio", "SOURCE": "DB"},
            "MODELDATA": {"NAME": "pio", "SOURCE": "DB"},
        },
    })
    from predictionio_tpu.data.eventstore import clear_cache
    clear_cache()
    app_id = Storage.get_meta_data_apps().insert(App(id=0, name="TorchApp"))
    store = Storage.get_events()
    store.init_channel(app_id)
    rng = np.random.default_rng(7)
    events = []
    for u in range(30):
        for it in range(20):
            if (u % 2) == (it % 2) and rng.random() < 0.7:
                rating = float(rng.integers(3, 6))
            elif rng.random() < 0.2:
                rating = float(rng.integers(1, 3))
            else:
                continue
            events.append(Event(
                event="rate", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{it}",
                properties=DataMap({"rating": rating})))
    store.insert_batch(events, app_id)
    ref_engine = ref_engine_factory()
    instance = run_train(
        ref_engine, default_engine_params("TorchApp", rank=8,
                                          num_iterations=8),
        engine_factory="predictionio_tpu.engines.recommendation:engine")
    result, ctx = load_for_deploy(ref_engine, instance)
    yield ref_engine, instance, result, ctx
    ref_scoring.set_process_scorer_config(None)
    port_scoring.set_process_scorer_config(None)
    Storage.reset()
    clear_cache()


QUERIES = [
    {"user": "u1", "num": 4},
    {"user": "u2", "num": 5},
    {"user": "u3", "num": 3, "blackList": ["i1", "i3"]},
    {"user": "u4", "num": 6, "whiteList": ["i0", "i2", "i4", "i5", "i7"]},
    {"user": "ghost", "num": 4},
    {"user": "u5", "num": 0},
    {"user": "u6", "num": 50},
]


@pytest.mark.parametrize("mode", ["exact", "twostage"])
async def test_port_server_answers_like_reference(trained, tmp_path, mode,
                                                  monkeypatch):
    ref_engine, instance, result, ctx = trained
    ref_model = result.models[0]
    path = tmp_path / "model.npz"
    save_model(path, ref_model)

    ref_cfg = RefConfig(mode=mode, tile_items=128)
    ref_server = ref_create_query_server(ref_engine, result, instance, ctx,
                                         scorer_config=ref_cfg)
    ref_client = TestClient(TestServer(ref_server.app))
    await ref_client.start_server()

    eng = engine()
    port_result = eng.prepare_deploy(
        eng.engine_params_from_json(
            {"algorithms": [{"name": "als", "params": {"rank": 8}}]}),
        [load_model(path, device="cpu")])
    server = create_query_server(
        eng, port_result, EngineInstance(id=instance.id),
        scorer_config=ScorerConfig(mode=mode, tile_items=128))
    # launches before and during warm-up are reported apart; GET /
    # counts from zero once the server takes traffic (the CPU launches
    # no kernel, so the count stays zero)
    monkeypatch.setattr(kernels, "SHORTLIST_LAUNCHES", 3)
    report = server.warm()
    assert report.buckets == [1, 2, 4, 8, 16, 32, 64]
    assert kernels.counts() == {"shortlist": 0, "spd_solve": 0}
    port = await server.start("127.0.0.1", 0)
    base = f"http://127.0.0.1:{port}"
    try:
        async with aiohttp.ClientSession() as session:
            for q in QUERIES:
                want_resp = await ref_client.post("/queries.json", json=q)
                want = await want_resp.json()
                async with session.post(base + "/queries.json",
                                        json=q) as resp:
                    assert resp.status == want_resp.status == 200
                    got = await resp.json()
                assert ([s["item"] for s in got["itemScores"]]
                        == [s["item"] for s in want["itemScores"]]), q
                np.testing.assert_allclose(
                    [s["score"] for s in got["itemScores"]],
                    [s["score"] for s in want["itemScores"]], rtol=1e-4)
            # the error contract: 400 + {"message": ...}
            for body in (b"not json", json.dumps({"flavor": "?"}).encode(),
                         json.dumps({"user": "u1", "num": -1}).encode()):
                want_resp = await ref_client.post("/queries.json", data=body)
                async with session.post(base + "/queries.json",
                                        data=body) as resp:
                    assert resp.status == want_resp.status == 400
                    assert "message" in await resp.json()
            async with session.get(base + "/") as resp:
                info = await resp.json()
            assert info["status"] == "alive"
            assert info["queryCount"] == len(QUERIES)
            assert info["engineInstance"]["id"] == instance.id
            assert info["warmupKernelLaunches"] == {"shortlist": 3,
                                                    "spd_solve": 0}
            assert info["kernelLaunches"] == {"shortlist": 0,
                                              "spd_solve": 0}
            scorers = info["scorer"]
            if mode == "twostage":
                assert scorers[0]["activeMode"] == "twostage"
            else:
                assert scorers == []
            async with session.get(base + "/nope") as resp:
                assert resp.status == 404
    finally:
        await server.close()
        await ref_client.close()


async def test_concurrent_queries_coalesce_into_batches(trained, tmp_path):
    """Concurrent clients ride the micro-batcher: every answer is the
    single-query answer (same items; scores within rtol 1e-5, since a
    batched product may sum in another order), and batches larger than
    one were dispatched."""
    import asyncio

    _, instance, result, _ = trained
    path = tmp_path / "model.npz"
    save_model(path, result.models[0])
    eng = engine()
    server = create_query_server(
        eng, eng.prepare_deploy(
            eng.engine_params_from_json({"algorithms": [{"name": "als"}]}),
            [load_model(path, device="cpu")]),
        EngineInstance(id="c"), scorer_config=ScorerConfig(mode="exact"),
        linger_s=0.05)
    port = await server.start("127.0.0.1", 0)
    base = f"http://127.0.0.1:{port}/queries.json"
    try:
        async with aiohttp.ClientSession() as session:
            async def ask(i):
                async with session.post(
                        base, json={"user": f"u{i % 30}", "num": 3}) as r:
                    return await r.json()

            got = await asyncio.gather(*(ask(i) for i in range(40)))
            for i, body in enumerate(got):
                alone = (await ask(i))["itemScores"]
                assert ([s["item"] for s in body["itemScores"]]
                        == [s["item"] for s in alone])
                np.testing.assert_allclose(
                    [s["score"] for s in body["itemScores"]],
                    [s["score"] for s in alone], rtol=1e-5)
    finally:
        await server.close()
    assert max(server.batcher.batch_sizes) > 1
