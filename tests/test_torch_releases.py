"""The port's engine-instance, model and release stores and the train
workflow that fills them, against the reference: the release-registry
cases of ``tests/test_deploy.py`` (monotonic versions, status lineage,
selectors, ``run_train`` registering a release), ``params_digest`` and
the instance's params JSON equal to the reference's for the same
engine.json, metadata rows read across the packages both ways, and a
reference model blob refused by the port's deploy, unpickled never."""

import datetime as dt
import json

import jax
import numpy as np
import pytest

import predictionio_tpu.deploy.releases as ref_releases
import predictionio_tpu.engines.recommendation as ref_rec
import predictionio_tpu_torch.data.eventstore as port_eventstore
import predictionio_tpu_torch.engines.recommendation as port_rec
from predictionio_tpu.data import Event as RefEvent
from predictionio_tpu.data import eventstore as ref_eventstore
from predictionio_tpu.storage import App as RefApp, Storage as RefStorage
from predictionio_tpu.storage import sqlite_backend as ref_sqlite
from predictionio_tpu.storage.base import (
    EngineInstance as RefEngineInstance, Release as RefRelease,
)
from predictionio_tpu.workflow import run_train as ref_run_train
from predictionio_tpu.workflow.context import (
    WorkflowContext as RefWorkflowContext,
)
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.deploy.releases import (
    model_digest, params_digest, release_of_instance, release_to_json,
    resolve_release,
)
from predictionio_tpu_torch.deploy.warm import DeployError
from predictionio_tpu_torch.storage import sqlite_backend as port_sqlite
from predictionio_tpu_torch.storage.base import (
    App, EngineInstance, Release,
)
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.workflow.serialization import (
    RETRAIN_ON_DEPLOY, ModelFormatError, deserialize_models,
    serialize_models,
)
from predictionio_tpu_torch.workflow.train import (
    engine_params_of_instance, load_for_deploy, run_train,
)

APP = "ReleaseApp"
FACTORY = "predictionio_tpu_torch.engines.recommendation:engine"
VARIANT = {"id": "v1", "engineFactory": FACTORY,
           "datasource": {"params": {"appName": APP}},
           "algorithms": [{"name": "als", "params": {
               "rank": 4, "numIterations": 2, "lambda": 0.05}}]}


def _config(path):
    return {"sources": {"DB": {"TYPE": "sqlite", "PATH": str(path)}},
            "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                             for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}}


def _rows(n_users=12, n_items=9):
    return [(f"u{u}", f"i{(u * 5 + j) % n_items}", float(1 + (u + j) % 5))
            for u in range(n_users) for j in range(4)]


@pytest.fixture()
def store(tmp_path):
    """The port's registry on one sqlite file with the app's events."""
    def reset():
        Storage.reset()
        RefStorage.reset()
        port_eventstore.clear_cache()
        ref_eventstore.clear_cache()

    reset()
    Storage.configure(_config(tmp_path / "rel.db"))
    app_id = Storage.get_meta_data_apps().insert(App(id=0, name=APP))
    events = Storage.get_events()
    events.init_channel(app_id)
    events.insert_batch([
        Event(event="rate", entity_type="user", entity_id=u,
              target_entity_type="item", target_entity_id=i,
              properties={"rating": r}) for u, i, r in _rows()], app_id)
    yield tmp_path / "rel.db"
    reset()


def test_release_versions_monotonic_per_variant(store):
    rels = Storage.get_meta_data_releases()
    a1, a2 = (Release(engine_id="a", engine_version="1", engine_variant="x")
              for _ in range(2))
    b1 = Release(engine_id="b", engine_version="1", engine_variant="x")
    for r in (a1, a2, b1):
        rels.insert(r)
    assert (a1.version, a2.version, b1.version) == (1, 2, 1)
    assert [r.version for r in rels.get_for_variant("a", "1", "x")] == [2, 1]
    assert rels.latest("a", "1", "x").id == a2.id
    assert rels.get_by_version("a", "1", "x", 1).id == a1.id


def test_release_status_lineage(store):
    rels = Storage.get_meta_data_releases()
    r = Release(engine_id="a", engine_version="1", engine_variant="x")
    rels.insert(r)
    rels.set_status(r.id, "CANARY", reason="fraction=0.1")
    rels.set_status(r.id, "CANARY", reason="again")        # a no-op
    rels.set_status(r.id, "ROLLED_BACK", reason="slo_latency: p99")
    got = rels.get(r.id)
    assert got.status == "ROLLED_BACK"
    assert [h["status"] for h in got.history] == ["CANARY", "ROLLED_BACK"]
    assert got.history[-1]["reason"].startswith("slo_latency")
    assert rels.latest("a", "1", "x", status="LIVE") is None
    with pytest.raises(ValueError):
        rels.set_status(r.id, "NONSENSE")
    assert rels.set_status("missing", "LIVE") is None


def test_resolve_release_selectors(store):
    rels = Storage.get_meta_data_releases()
    r1, r2 = (Release(engine_id="a", engine_version="1", engine_variant="x")
              for _ in range(2))
    rels.insert(r1)
    rels.insert(r2)
    assert resolve_release(rels, "a", "1", "x", None).id == r2.id
    assert resolve_release(rels, "a", "1", "x", r1.id).id == r1.id
    assert resolve_release(rels, "a", "1", "x", "1").id == r1.id
    assert resolve_release(rels, "a", "1", "x", "v2").id == r2.id
    assert resolve_release(rels, "a", "1", "x", "v99") is None
    assert resolve_release(rels, "a", "1", "x", "junk") is None
    foreign = Release(engine_id="b", engine_version="1", engine_variant="y")
    rels.insert(foreign)
    assert resolve_release(rels, "a", "1", "x", foreign.id) is None
    assert resolve_release(rels, "b", "1", "y", foreign.id).id == foreign.id
    rels.set_status(r2.id, "ROLLED_BACK", reason="slo breach")
    assert resolve_release(rels, "a", "1", "x", None).id == r1.id
    assert resolve_release(rels, "a", "1", "x", "v2").id == r2.id
    rels.set_status(r1.id, "ROLLED_BACK", reason="slo breach")
    assert resolve_release(rels, "a", "1", "x", None) is None


def _port_train(**kw):
    engine = port_rec.engine()
    return run_train(engine, engine.engine_params_from_json(VARIANT),
                     engine_factory=FACTORY, engine_variant="v1",
                     device="cpu", **kw)


def test_run_train_registers_release(store):
    instance, result = _port_train()
    assert instance.status == "COMPLETED"
    rels = Storage.get_meta_data_releases().get_for_variant(FACTORY, "1",
                                                            "v1")
    assert len(rels) == 1
    r = rels[0]
    assert r.version == 1 and r.status == "REGISTERED"
    assert r.instance_id == instance.id
    assert r.params_digest == params_digest(instance)
    blob = Storage.get_model_data_models().get(instance.id).models
    assert r.model_digest == model_digest(blob)
    assert r.model_size_bytes == len(blob)
    assert release_of_instance(Storage.get_meta_data_releases(),
                               instance).id == r.id
    assert release_to_json(r)["engineInstanceId"] == instance.id
    stored = Storage.get_meta_data_engine_instances().get(instance.id)
    assert stored.status == "COMPLETED" and stored.end_time >= \
        stored.start_time
    # the stored blob deploys to the trained factors
    deployed, ctx = load_for_deploy(port_rec.engine(), stored,
                                    device="cpu")
    np.testing.assert_array_equal(deployed.models[0].V,
                                  result.models[0].V)
    assert str(ctx.device) == "cpu"
    # a retrain becomes v2 of the same variant
    _port_train()
    assert [x.version for x in Storage.get_meta_data_releases()
            .get_for_variant(FACTORY, "1", "v1")] == [2, 1]


def test_failed_train_leaves_instance_init(store, monkeypatch):
    def boom(*_a, **_k):
        raise RuntimeError("solver exploded")

    monkeypatch.setattr(port_rec, "train_als", boom)
    with pytest.raises(RuntimeError, match="exploded"):
        _port_train()
    (inst,) = Storage.get_meta_data_engine_instances().get_all()
    assert inst.status == "INIT"
    assert Storage.get_meta_data_engine_instances().get_latest_completed(
        FACTORY, "1", "v1") is None
    assert Storage.get_meta_data_releases().get_all() == []


def test_completed_train_clears_its_checkpoints(store, tmp_path):
    from predictionio_tpu_torch.workflow.context import WorkflowParams

    ckpt = tmp_path / "ckpt"
    wp = WorkflowParams(runtime_conf={"checkpoint_dir": str(ckpt),
                                      "checkpoint_interval": "1"})
    variant = dict(VARIANT, algorithms=[{"name": "als", "params": {
        "rank": 4, "numIterations": 3}}])
    engine = port_rec.engine()
    run_train(engine, engine.engine_params_from_json(variant),
              engine_factory=FACTORY, engine_variant="v1",
              workflow_params=wp, device="cpu")
    # snapshots were written under the algorithm's namespace, then
    # cleared by the completed train
    assert (ckpt / "algo_0_als").is_dir()
    assert not list(ckpt.rglob("*.pkl"))


def test_params_and_digest_equal_to_reference(store, tmp_path):
    """The same engine.json trained by both packages records the same
    params JSON, hence the same params_digest."""
    instance, _ = _port_train()
    RefStorage.configure(_config(tmp_path / "ref.db"))
    app_id = RefStorage.get_meta_data_apps().insert(RefApp(id=0, name=APP))
    RefStorage.get_events().init_channel(app_id)
    RefStorage.get_events().insert_batch([
        RefEvent(event="rate", entity_type="user", entity_id=u,
                 target_entity_type="item", target_entity_id=i,
                 properties={"rating": r}) for u, i, r in _rows()], app_id)
    ref_engine = ref_rec.engine()
    ref_instance = ref_run_train(
        ref_engine, ref_engine.engine_params_from_json(VARIANT),
        engine_factory=FACTORY, engine_variant="v1",
        ctx=RefWorkflowContext(mode="Training", devices=jax.devices()[:1]))
    for field in ("engine_id", "engine_version", "engine_variant",
                  "data_source_params", "preparator_params",
                  "algorithms_params", "serving_params"):
        assert getattr(instance, field) == getattr(ref_instance, field)
    assert params_digest(instance) == ref_releases.params_digest(
        ref_instance)
    # and the params read back into the same engine params
    ep = engine_params_of_instance(port_rec.engine(), instance)
    assert ep.algorithm_params_list[0][1].reg == 0.05


def test_metadata_rows_cross_both_ways(store):
    t0 = dt.datetime(2024, 5, 1, 12, 30, 15, 250000, tzinfo=dt.timezone.utc)
    rows = dict(status="COMPLETED", start_time=t0,
                end_time=t0 + dt.timedelta(seconds=3), engine_id="e",
                engine_version="1", engine_variant="v", engine_factory="f",
                batch="b", env={"A": "1"}, runtime_conf={"k": "v"},
                data_source_params='{"app_name": "x"}',
                preparator_params="{}",
                algorithms_params='[{"name": "als", "params": {}}]',
                serving_params="{}")
    rel = dict(engine_id="e", engine_version="1", engine_variant="v",
               params_digest="p", model_digest="m", model_size_bytes=12,
               status="REGISTERED", created_time=t0, train_seconds=1.5,
               batch="b", history=[{"status": "REGISTERED", "timeMs": 1,
                                    "reason": "r"}])

    def fields(obj):
        return {k: v for k, v in vars(obj).items()}

    path = str(store)
    port_client = port_sqlite.SqliteClient(path)
    ref_client = ref_sqlite.SqliteClient(path)
    pairs = [
        ((port_sqlite.SqliteEngineInstances, EngineInstance),
         (ref_sqlite.SqliteEngineInstances, RefEngineInstance), rows),
        ((port_sqlite.SqliteReleases, Release),
         (ref_sqlite.SqliteReleases, RefRelease), rel),
    ]
    for (p_store, p_rec), (r_store, r_rec), kw in pairs:
        p, r = p_store(port_client), r_store(ref_client)
        written_by_port = p_rec(**kw)
        p.insert(written_by_port)
        written_by_ref = r_rec(**kw)
        r.insert(written_by_ref)
        assert fields(r.get(written_by_port.id)) == fields(written_by_port)
        assert fields(p.get(written_by_ref.id)) == fields(written_by_ref)
    # both releases of one variant: versions 1 and 2 whoever wrote them
    assert [x.version for x in port_sqlite.SqliteReleases(port_client)
            .get_for_variant("e", "1", "v")] == [2, 1]


def test_reference_model_blob_is_refused_not_unpickled(store, tmp_path,
                                                       monkeypatch):
    """An instance the reference trained carries a pickled blob of its
    JAX classes: the port's deploy refuses it with DeployError and never
    calls pickle."""
    import pickle

    from predictionio_tpu.models.als import ALSModel as RefALSModel
    from predictionio_tpu.workflow.serialization import (
        serialize_models as ref_serialize,
    )
    from predictionio_tpu_torch.storage.base import Model

    rng = np.random.default_rng(0)
    blob = ref_serialize([RefALSModel(
        user_vocab=np.array(["u0", "u1"], dtype=object),
        item_vocab=np.array(["a", "b"], dtype=object),
        U=rng.standard_normal((2, 3)).astype(np.float32),
        V=rng.standard_normal((2, 3)).astype(np.float32))])
    instance = EngineInstance(
        id="from-reference", status="COMPLETED", engine_id=FACTORY,
        engine_version="1", engine_variant="v1",
        data_source_params=json.dumps({"app_name": APP}),
        algorithms_params='[{"name": "als", "params": {}}]')
    Storage.get_meta_data_engine_instances().insert(instance)
    Storage.get_model_data_models().insert(Model(id=instance.id,
                                                 models=blob))

    def no_unpickle(*_a, **_k):
        raise AssertionError("the port unpickled a model blob")

    monkeypatch.setattr(pickle, "loads", no_unpickle)
    monkeypatch.setattr(pickle, "load", no_unpickle)
    with pytest.raises(DeployError, match="JAX package"):
        load_for_deploy(port_rec.engine(), instance, device="cpu")
    with pytest.raises(ModelFormatError):
        deserialize_models(b"PK\x03\x04 truncated zip")


def test_blob_round_trip_with_retrain_slot(store):
    from predictionio_tpu_torch.models.als import ALSModel

    rng = np.random.default_rng(1)
    m = ALSModel.from_arrays(np.array(["u0", "u1"]), np.array(["a", "b"]),
                             rng.standard_normal((2, 3)),
                             rng.standard_normal((2, 3)), device="cpu")
    back = deserialize_models(serialize_models([m, None,
                                                RETRAIN_ON_DEPLOY]),
                              device="cpu")
    assert back[1] is None and back[2] is None
    np.testing.assert_array_equal(back[0].U, m.U)
    assert list(back[0].item_vocab) == ["a", "b"]
    with pytest.raises(TypeError, match="ALS models only"):
        serialize_models([object()])


def test_cli_import_listings_and_releases(store, tmp_path, capsys):
    """``import`` loads JSON lines (read back alike by the reference's
    store), and ``app list``, ``accesskey list`` and ``releases`` list
    what the stores hold."""
    from predictionio_tpu_torch.cli.main import main

    lines = tmp_path / "events.jsonl"
    lines.write_text("\n".join(json.dumps({
        "event": "rate", "entityType": "user", "entityId": f"x{i}",
        "targetEntityType": "item", "targetEntityId": "i1",
        "properties": {"rating": 2.0},
        "eventTime": "2024-06-01T00:00:00.000Z"}) for i in range(7)) + "\n\n")
    assert main(["import", "--appname", APP, "--input", str(lines)]) == 0
    app_id = Storage.get_meta_data_apps().get_by_name(APP).id
    ref_events = list(ref_sqlite.SqliteEvents(
        ref_sqlite.SqliteClient(str(store))).find(app_id, entity_type="user"))
    assert sum(e.entity_id.startswith("x") for e in ref_events) == 7
    with pytest.raises(SystemExit):
        main(["import", "--appname", "nope", "--input", str(lines)])

    assert main(["accesskey", "new", APP, "--key", "kk", "--event",
                 "rate", "--event", "buy"]) == 0
    assert main(["app", "list"]) == 0
    assert main(["accesskey", "list", APP]) == 0
    out = capsys.readouterr().out
    assert "Imported 7 events." in out and "kk | app" in out
    assert "rate,buy" in out and f"{APP:<20}" in out

    variant = tmp_path / "engine.json"
    variant.write_text(json.dumps(VARIANT))
    _port_train()
    _port_train()
    assert main(["releases", "-v", str(variant)]) == 0
    out = capsys.readouterr().out
    assert "v2" in out and "v1" in out
    assert "Finished listing 2 release(s)." in out


def test_deploy_selects_latest_instance_or_release(store):
    """``deploy``'s selection: the latest COMPLETED instance by default,
    ``--release`` (id, N or vN) or ``--engine-instance-id``; an unknown
    selector exits 1 as in the reference."""
    import argparse

    from predictionio_tpu_torch.cli.main import _instance_to_deploy

    i1, _ = _port_train()
    i2, _ = _port_train()

    def pick(release=None, instance=None):
        inst, rel = _instance_to_deploy(
            argparse.Namespace(release=release, engine_instance_id=instance),
            FACTORY, "v1")
        return inst.id, rel.version

    assert pick() == (i2.id, 2)
    assert pick(release="v1") == (i1.id, 1)
    assert pick(release="2") == (i2.id, 2)
    assert pick(instance=i1.id) == (i1.id, 1)
    for bad in (dict(release="v9"), dict(instance="nope")):
        with pytest.raises(SystemExit) as e:
            pick(**bad)
        assert e.value.code == 1
