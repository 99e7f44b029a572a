"""Server plugins of the port (``server/plugins.py`` and their hooks in
``server/query_server.py`` and ``server/event_server.py``), held against
the JAX package:

* ``PluginContext.describe()`` has the reference's shape for the same
  registered plugins, and a registration of anything else raises alike;
  entry points load from the port's own groups.
* On the query server an output blocker edits the answer and an output
  sniffer sees the edited answer, in the reference's order, with the
  same answer from both packages' servers on the same model; a blocker
  that raises is logged and skipped; ``GET /plugins.json``.
* On the event server an input blocker gets 403 with its message on
  ``POST /events.json`` and on its events of ``/batch/events.json``
  (the others stored), an input sniffer sees each stored event, and
  ``/plugins/<type>/<name>/...`` dispatches to the plugin's
  ``handle_rest`` (404 for an unknown plugin, 401 without a key).
"""

import aiohttp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

import predictionio_tpu.server.plugins as ref_plugins
import predictionio_tpu_torch.server.plugins as port_plugins
from predictionio_tpu.core.engine import TrainResult as RefTrainResult
from predictionio_tpu.core.params import EngineParams as RefEngineParams
from predictionio_tpu.engines import recommendation as ref_rec
from predictionio_tpu.models.als import ALSModel as RefALSModel
from predictionio_tpu.server.query_server import QueryServer as RefQueryServer
from predictionio_tpu.storage.base import EngineInstance as RefEngineInstance
from predictionio_tpu.utils.server_config import (
    DeployConfig as RefDeployConfig, ServingConfig as RefServingConfig,
)
from predictionio_tpu_torch.engines import recommendation as port_rec
from predictionio_tpu_torch.models.als import ALSModel
from predictionio_tpu_torch.server.event_server import EventServer
from predictionio_tpu_torch.server.query_server import QueryServer
from predictionio_tpu_torch.storage.base import AccessKey, App, EngineInstance
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.server_config import (
    IngestConfig, ScorerConfig,
)

pytestmark = pytest.mark.anyio

KEY = "plugin-key"


def _plugin_classes(mod, seen):
    """The same four plugins written against ``mod``'s classes (the
    reference's or the port's): a blocker that keeps the top-2 and tags
    the answer, a sniffer, an input blocker of ``spam`` events and an
    input sniffer with a REST hook."""

    def out_block(self, engine_instance, query, prediction):
        out = dict(prediction)
        out["itemScores"] = out["itemScores"][:2]
        out["blockedBy"] = engine_instance.id
        return out

    def out_sniff(self, engine_instance, query, prediction):
        seen.append(("out", query["user"], prediction))
        return {"ignored": True}

    def in_block(self, app_id, channel_id, event):
        if event.event == "spam":
            raise ValueError(f"spam from {event.entity_id} is blocked")

    def in_sniff(self, app_id, channel_id, event):
        seen.append(("in", app_id, event.event, event.entity_id))

    def in_rest(self, app_id, channel_id, args):
        return {"appId": app_id, "args": args,
                "seen": sum(1 for s in seen if s[0] == "in")}

    def failing(self, engine_instance, query, prediction):
        raise RuntimeError("a broken blocker")

    E, V = mod.EngineServerPlugin, mod.EventServerPlugin
    return [
        type("TopTwo", (E,), {"plugin_name": "toptwo",
                              "plugin_description": "keeps two",
                              "plugin_type": E.OUTPUT_BLOCKER,
                              "process": out_block}),
        type("Broken", (E,), {"plugin_name": "broken",
                              "plugin_description": "raises",
                              "plugin_type": E.OUTPUT_BLOCKER,
                              "process": failing}),
        type("Watch", (E,), {"plugin_name": "watch",
                             "plugin_description": "sees answers",
                             "plugin_type": E.OUTPUT_SNIFFER,
                             "process": out_sniff}),
        type("NoSpam", (V,), {"plugin_name": "nospam",
                              "plugin_description": "rejects spam",
                              "plugin_type": V.INPUT_BLOCKER,
                              "process": in_block}),
        type("Count", (V,), {"plugin_name": "count",
                             "plugin_description": "counts events",
                             "plugin_type": V.INPUT_SNIFFER,
                             "process": in_sniff,
                             "handle_rest": in_rest}),
    ]


def _context(mod, seen):
    ctx = mod.PluginContext()
    for cls in _plugin_classes(mod, seen):
        ctx.register(cls())
    return ctx


def test_describe_matches_reference():
    ref, port = _context(ref_plugins, []), _context(port_plugins, [])
    assert port.describe() == ref.describe()
    assert list(port.describe()["outputblockers"]) == ["toptwo", "broken"]
    for ctx in (ref, port):
        with pytest.raises(TypeError, match="not a plugin"):
            ctx.register(object())
    assert port_plugins.PluginContext().describe() == \
        ref_plugins.PluginContext().describe()


def test_entry_points_load_from_the_port_groups(monkeypatch):
    import importlib.metadata

    seen = []
    classes = {c.__name__: c for c in _plugin_classes(port_plugins, seen)}
    asked = []

    class _EP:
        def __init__(self, cls):
            self.cls = cls

        def load(self):
            return self.cls

    def entry_points(group):
        asked.append(group)
        return [_EP(classes["Watch"])] if group.startswith(
            "predictionio_tpu_torch.") else []

    monkeypatch.setattr(importlib.metadata, "entry_points", entry_points)
    ctx = port_plugins.PluginContext(port_plugins.ENGINESERVER_GROUP)
    assert list(ctx.output_sniffers) == ["watch"]
    assert port_plugins.PluginContext(
        port_plugins.EVENTSERVER_GROUP).describe()["inputsniffers"] == {}
    assert asked == ["predictionio_tpu_torch.engineserver_plugins",
                     "predictionio_tpu_torch.eventserver_plugins"]


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return (np.asarray([f"u{i}" for i in range(8)], dtype=object),
            np.asarray([f"i{i}" for i in range(12)], dtype=object),
            rng.normal(size=(8, 4)).astype(np.float32),
            rng.normal(size=(12, 4)).astype(np.float32))


async def test_output_plugins_edit_and_see_the_answer():
    port_seen, ref_seen = [], []
    model = ALSModel.from_arrays(*_arrays(), device="cpu")
    eng = port_rec.engine()
    server = QueryServer(
        eng, eng.prepare_deploy(port_rec.default_engine_params(rank=4),
                                [model]),
        EngineInstance(id="plugged"),
        scorer_config=ScorerConfig(mode="exact"), max_batch=4,
        linger_s=0.0, plugin_context=_context(port_plugins, port_seen))
    users, items, U, V = _arrays()
    ref_server = RefQueryServer(
        ref_rec.engine(), RefTrainResult(
            models=[RefALSModel(user_vocab=users, item_vocab=items, U=U,
                                V=V)],
            algorithms=[ref_rec.ALSAlgorithm(ref_rec.AlgorithmParams(
                rank=4))],
            serving=ref_rec.RecommendationServing(),
            engine_params=RefEngineParams()),
        RefEngineInstance(id="plugged"), ctx=None,
        serving_config=RefServingConfig(batch_max=4, batch_linger_s=0.0),
        deploy_config=RefDeployConfig(warmup=False),
        plugin_context=_context(ref_plugins, ref_seen))
    ref_client = TestClient(TestServer(ref_server.app))
    await ref_client.start_server()
    port = await server.start("127.0.0.1", 0)
    try:
        async with aiohttp.ClientSession() as session:
            for user in ("u1", "u5", "nobody"):
                q = {"user": user, "num": 4}
                async with session.post(
                        f"http://127.0.0.1:{port}/queries.json",
                        json=q) as r:
                    assert r.status == 200
                    got = await r.json()
                resp = await ref_client.post("/queries.json", json=q)
                want = await resp.json()
                assert [s["item"] for s in got["itemScores"]] == \
                    [s["item"] for s in want["itemScores"]]
                np.testing.assert_allclose(
                    [s["score"] for s in got["itemScores"]],
                    [s["score"] for s in want["itemScores"]], rtol=1e-5)
                assert got["blockedBy"] == want["blockedBy"] == "plugged"
                assert len(got["itemScores"]) == (0 if user == "nobody"
                                                  else 2)
            async with session.get(
                    f"http://127.0.0.1:{port}/plugins.json") as r:
                listing = await r.json()
            resp = await ref_client.get("/plugins.json")
            assert listing == await resp.json()
        assert [(k, u) for k, u, _ in port_seen] == \
            [(k, u) for k, u, _ in ref_seen] == \
            [("out", "u1"), ("out", "u5"), ("out", "nobody")]
        # the sniffer saw the blocked answer
        assert all(len(p["itemScores"]) <= 2 and p["blockedBy"] == "plugged"
                   for _, _, p in port_seen)
    finally:
        await server.close()
        await ref_client.close()


@pytest.fixture()
def store(tmp_path):
    Storage.reset()
    Storage.configure({
        "sources": {"DB": {"TYPE": "sqlite",
                           "PATH": str(tmp_path / "plugins.db")}},
        "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                         for r in ("METADATA", "EVENTDATA", "MODELDATA")}})
    app_id = Storage.get_meta_data_apps().insert(App(id=0, name="PlugApp"))
    Storage.get_events().init_channel(app_id)
    Storage.get_meta_data_access_keys().insert(
        AccessKey(key=KEY, appid=app_id, events=()))
    yield app_id
    Storage.reset()


def _event(name, user):
    return {"event": name, "entityType": "user", "entityId": user,
            "targetEntityType": "item", "targetEntityId": "i1",
            "properties": {"rating": 3}}


@pytest.mark.parametrize("buffered", [True, False])
async def test_input_plugins_on_both_ingest_routes(store, buffered):
    seen = []
    server = EventServer(ingest=IngestConfig(buffer=buffered, linger_s=0.0),
                         plugin_context=_context(port_plugins, seen))
    port = await server.start("127.0.0.1", 0)
    base = f"http://127.0.0.1:{port}"
    try:
        async with aiohttp.ClientSession() as s:
            async with s.post(f"{base}/events.json?accessKey={KEY}",
                              json=_event("spam", "x")) as r:
                assert r.status == 403
                assert (await r.json())["message"] == \
                    "spam from x is blocked"
            async with s.post(f"{base}/events.json?accessKey={KEY}",
                              json=_event("rate", "a")) as r:
                assert r.status == 201
            batch = [_event("rate", "b"), _event("spam", "y"),
                     _event("rate", "c")]
            async with s.post(f"{base}/batch/events.json?accessKey={KEY}",
                              json=batch) as r:
                assert r.status == 200
                out = await r.json()
            assert [x["status"] for x in out] == [201, 403, 201]
            assert out[1]["message"] == "spam from y is blocked"
            async with s.get(f"{base}/plugins/inputsniffers/count/a/b"
                             f"?accessKey={KEY}") as r:
                assert r.status == 200
                assert await r.json() == {"appId": store, "args": ["a", "b"],
                                          "seen": 3}
            async with s.post(f"{base}/plugins/inputsniffers/count"
                              f"?accessKey={KEY}") as r:
                assert r.status == 200 and (await r.json())["args"] == []
            for path in ("/plugins/inputsniffers/nope/x",
                         "/plugins/outputblockers/toptwo/x",
                         "/plugins/count"):
                async with s.get(f"{base}{path}?accessKey={KEY}") as r:
                    assert r.status == 404, path
            async with s.get(f"{base}/plugins/inputsniffers/count/a") as r:
                assert r.status == 401
            async with s.get(f"{base}/plugins.json") as r:
                listing = await r.json()
        assert listing == {"plugins": _context(ref_plugins, []).describe()}
        assert [x[2:] for x in seen] == [("rate", "a"), ("rate", "b"),
                                         ("rate", "c")]
        stored = sorted(e.entity_id for e in Storage.get_events().find(store))
        assert stored == ["a", "b", "c"]
    finally:
        await server.close()
