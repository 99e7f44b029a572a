"""The port's continuous-training orchestrator (``deploy/orchestrator``)
against the reference's, on the same inputs:

* trigger arithmetic — ``evaluate_triggers``, ``cycle_backoff_ms`` and
  ``next_earliest_ms`` give the reference's answers over generated
  configs, states and signals under one seeded RNG;
* durable state — cycle and trigger documents written by either package
  are read by the other; the ``StoreSignals`` digest gate and
  ``snapshot_digest`` agree on one sqlite file;
* cycles — a full cycle promotes and retires the baseline (and the
  first cycle without one), and both packages end in the same registry
  state;
* chaos — a kill at every point of the reference's chaos list (the
  phase boundaries, the in-phase seams and the four release-registry
  commit windows), then ``recover``, converges to the registry state
  the reference converges to: statuses and history by version, one
  LIVE, no CANARY, no INIT debris, and the loop works on;
* gates — failures of the eval gate, the smoke gate and an SLO-judged
  canary roll back; retries, exhaustion, timeouts and the jittered
  failure backoff keep their bounds;
* ``HttpPlane`` drives the port's query server over HTTP on the CPU:
  a canary promoted by the server, one aborted by an operator, and one
  that times out;
* ``orchestrate --once`` through the port's CLI in a subprocess.
"""

import asyncio
import json
import os
import random
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

import predictionio_tpu.data.eventstore as ref_eventstore
import predictionio_tpu.deploy.orchestrator as ref_orch
import predictionio_tpu.deploy.releases as ref_releases
import predictionio_tpu.storage.faults as ref_faults
import predictionio_tpu.utils.server_config as ref_config
import predictionio_tpu_torch.data.eventstore as port_eventstore
import predictionio_tpu_torch.deploy.orchestrator as port_orch
import predictionio_tpu_torch.deploy.releases as port_releases
import predictionio_tpu_torch.storage.faults as port_faults
import predictionio_tpu_torch.utils.server_config as port_config
from predictionio_tpu.obs import registry as ref_registry
from predictionio_tpu.obs import slo as ref_slo
from predictionio_tpu.obs import trace_context as ref_trace
from predictionio_tpu.storage import Storage as RefStorage
from predictionio_tpu.storage import base as ref_base
from predictionio_tpu_torch.data.event import Event as PortEvent
from predictionio_tpu_torch.obs import registry as port_registry
from predictionio_tpu_torch.obs import slo as port_slo
from predictionio_tpu_torch.obs import trace_context as port_trace
from predictionio_tpu_torch.storage import base as port_base
from predictionio_tpu_torch.storage.registry import Storage

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EID, EVER, VAR = "orch-test-engine", "1", "default"

SIDES = {
    "ref": types.SimpleNamespace(
        Storage=RefStorage, orch=ref_orch, releases=ref_releases,
        faults=ref_faults, base=ref_base, config=ref_config,
        registry=ref_registry, slo=ref_slo, trace=ref_trace,
        eventstore=ref_eventstore),
    "port": types.SimpleNamespace(
        Storage=Storage, orch=port_orch, releases=port_releases,
        faults=port_faults, base=port_base, config=port_config,
        registry=port_registry, slo=port_slo, trace=port_trace,
        eventstore=port_eventstore),
}


def _db_config(path):
    return {"sources": {"DB": {"TYPE": "sqlite", "PATH": str(path)}},
            "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                             for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}}


@pytest.fixture()
def stores(tmp_path):
    """Each package's registry on a sqlite file of its own."""
    for name, ns in SIDES.items():
        ns.Storage.reset()
        ns.Storage.configure(_db_config(tmp_path / f"{name}.db"))
        ns.faults.set_kill_points([])
        ns.eventstore.clear_cache()
    yield tmp_path
    for ns in SIDES.values():
        ns.faults.set_kill_points([])
        ns.Storage.reset()
        ns.eventstore.clear_cache()


class FakeClock:
    def __init__(self, start_ms=1_000_000):
        self.ms = start_ms

    def now_ms(self):
        return self.ms

    def sleep(self, seconds):
        self.ms += int(seconds * 1000)


def _completed_instance(ns, batch="", instance_id=""):
    inst = ns.base.EngineInstance(
        id=instance_id, status="COMPLETED", engine_id=EID,
        engine_version=EVER, engine_variant=VAR, batch=batch)
    iid = ns.Storage.get_meta_data_engine_instances().insert(inst)
    inst.id = iid or inst.id
    return inst


def seed_baseline(ns):
    inst = _completed_instance(ns, batch="seed")
    release = ns.releases.record_release(inst, train_seconds=0.5,
                                         blob=b"baseline")
    ns.Storage.get_meta_data_releases().set_status(
        release.id, "LIVE", "seed deploy")
    return ns.Storage.get_meta_data_releases().get(release.id)


def hooks_for(ns):
    def train(doc):
        inst = _completed_instance(ns, batch=doc.cycle_id)
        ns.releases.record_release(
            inst, train_seconds=0.1,
            blob=b"candidate-" + doc.cycle_id.encode())
        return inst

    def evaluate(doc):
        evals = ns.Storage.get_meta_data_evaluation_instances()
        row = ns.base.EvaluationInstance(
            status="EVALCOMPLETED", batch=doc.cycle_id,
            evaluator_results="[score] 0.9")
        row.id = evals.insert(row)
        return 0.9, True, "fake sweep"

    def smoke(doc):
        return {"written": 8, "invalid": 0}

    return ns.orch.OrchestratorHooks(train=train, evaluate=evaluate,
                                     smoke=smoke)


def make_orch(ns, tmp_path, clock=None, judge=None, registry=None,
              rng_seed=7, state="state", **cfg_kw):
    cfg_kw.setdefault("cooldown_s", 0.0)
    cfg_kw.setdefault("phase_retries", 1)
    cfg_kw.setdefault("phase_backoff_s", 0.0)
    cfg_kw.setdefault("phase_timeout_s", 30.0)
    clock = clock or FakeClock()
    return ns.orch.Orchestrator(
        EID, EVER, VAR, ns.config.OrchestratorConfig(**cfg_kw),
        hooks_for(ns), plane=ns.orch.RegistryPlane(judge=judge),
        state_dir=str(tmp_path / f"{state}-{id(ns)}"),
        registry=registry or ns.registry.MetricsRegistry(),
        clock_ms=clock.now_ms, sleep=clock.sleep,
        rng=random.Random(rng_seed))


def registry_summary(ns):
    """The registry state compared across packages: per version, its
    status and its status history; the instance and eval-row
    statuses."""
    rels = ns.Storage.get_meta_data_releases().get_for_variant(
        EID, EVER, VAR)
    return {
        "releases": sorted((r.version, r.status,
                            tuple(h["status"] for h in r.history))
                           for r in rels),
        "live": sum(1 for r in rels if r.status == "LIVE"),
        "instances": sorted(
            i.status for i in
            ns.Storage.get_meta_data_engine_instances().get_all()),
        "evals": sorted(
            e.status for e in
            ns.Storage.get_meta_data_evaluation_instances().get_all()),
    }


# ---------------------------------------------------------------------------
# trigger arithmetic
# ---------------------------------------------------------------------------

def _random_case(rng):
    cfg = dict(min_ingest_events=rng.choice([0, 1, 50, 500]),
               foldin_pending_max=rng.choice([0, 10, 50]),
               slo_trigger=rng.random() < 0.5,
               cooldown_s=rng.choice([0.0, 5.0, 300.0]),
               cycle_backoff_s=rng.choice([1.0, 60.0]),
               cycle_backoff_cap_s=rng.choice([30.0, 3600.0]))
    state = dict(next_earliest_ms=rng.randrange(0, 2_000_000),
                 consecutive_failures=rng.randrange(0, 6))
    signals = dict(ingest_events=rng.randrange(0, 1000),
                   foldin_pending=rng.randrange(0, 100),
                   slo_breached=rng.random() < 0.3,
                   digest=rng.choice([None, "d1"]))
    return cfg, state, signals, rng.randrange(0, 2_000_000)


@pytest.mark.parametrize("seed", range(4))
def test_trigger_arithmetic_matches_reference(seed):
    rng = random.Random(seed)
    rp, rr = random.Random(seed + 100), random.Random(seed + 100)
    for _ in range(300):
        cfg, state, signals, now = _random_case(rng)
        out = []
        for ns, r in ((SIDES["port"], rp), (SIDES["ref"], rr)):
            c = ns.config.OrchestratorConfig(**cfg)
            fired = ns.orch.evaluate_triggers(
                c, ns.orch.TriggerState(**state),
                ns.orch.TriggerSignals(**signals), now)
            failures = state["consecutive_failures"]
            out.append((fired, ns.orch.cycle_backoff_ms(c, failures, r),
                        ns.orch.next_earliest_ms(c, now, failures, r)))
        assert out[0] == out[1], (cfg, state, signals, now)
        fired, backoff, _ = out[0]
        failures = state["consecutive_failures"]
        if failures:
            ceiling = min(cfg["cycle_backoff_cap_s"],
                          cfg["cycle_backoff_s"] * 2 ** (failures - 1))
            assert ceiling * 500 - 1 <= backoff <= ceiling * 1000
        else:
            assert backoff == 0


def test_orchestrator_config_precedence_matches_reference(tmp_path,
                                                          monkeypatch):
    server = tmp_path / "server.json"
    server.write_text(json.dumps({"orchestrator": {
        "intervalS": 0.001, "cooldownS": 7, "minIngestEvents": 20,
        "phaseRetries": -3, "canaryVerdictTimeoutS": 0.2,
        "smokeQueries": "q.jsonl", "sloTrigger": "off"}}))
    monkeypatch.setenv("PIO_SERVER_CONF", str(server))
    monkeypatch.setenv("PIO_ORCH_COOLDOWN_S", "9")
    monkeypatch.setenv("PIO_ORCH_MIN_EVAL_SCORE", "bad")
    variant = {"minIngestEvents": 40, "historyWindowS": -1}
    got = port_config.orchestrator_config(variant)
    want = ref_config.orchestrator_config(variant)
    assert got.__dict__ == want.__dict__
    assert got.cooldown_s == 9 and got.min_ingest_events == 40
    assert got.interval_s == 0.01 and got.phase_retries == 0
    assert got.canary_verdict_timeout_s == 1.0


# ---------------------------------------------------------------------------
# durable state and the digest gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_cycle_and_trigger_documents_cross_read(tmp_path, writer, reader):
    w, r = SIDES[writer].orch, SIDES[reader].orch
    store_w = w.CycleStore(str(tmp_path))
    doc = w.CycleDoc(cycle_id="c1", trace="t:s", trigger="manual",
                     phase="eval", phase_status="running",
                     attempts={"train": 1}, eval_score=0.5,
                     smoke={"written": 3, "invalid": 0})
    store_w.commit_cycle(doc)
    assert [p.name for p in tmp_path.iterdir()
            if ".tmp" in p.name] == []
    store_w.commit_trigger_state(w.TriggerState(
        watermark_ms=42, last_digest="rowid:1:2:3:4",
        consecutive_failures=2, next_earliest_ms=99))
    store_r = r.CycleStore(str(tmp_path))
    back = store_r.load_cycle()
    assert back.to_json() == doc.to_json()
    state = store_r.load_trigger_state(now_ms=0)
    assert (state.watermark_ms, state.last_digest,
            state.consecutive_failures) == (42, "rowid:1:2:3:4", 2)
    doc.outcome = "promoted"
    store_r.archive_cycle(r.CycleDoc.from_json(doc.to_json()))
    assert store_w.load_cycle() is None
    with open(tmp_path / "history" / "c1.json") as f:
        assert json.load(f)["outcome"] == "promoted"


def test_first_run_watermark_is_durable(tmp_path):
    store = port_orch.CycleStore(str(tmp_path))
    assert store.load_trigger_state(now_ms=42_000).watermark_ms == 42_000
    assert store.load_trigger_state(now_ms=99_000).watermark_ms == 42_000
    ref = ref_orch.CycleStore(str(tmp_path))
    assert ref.load_trigger_state(now_ms=1).watermark_ms == 42_000


def test_store_signals_digest_gate_matches_reference(tmp_path):
    """Both packages on ONE sqlite file: the same digest, the same
    bounded count, and an unchanged digest skips the count."""
    from predictionio_tpu.data.event import Event as RefEvent

    for ns in SIDES.values():
        ns.Storage.reset()
        ns.Storage.configure(_db_config(tmp_path / "shared.db"))
        ns.eventstore.clear_cache()
    try:
        app_id = RefStorage.get_meta_data_apps().insert(
            ref_base.App(id=0, name="SigApp"))
        RefStorage.get_events().init_channel(app_id)
        RefStorage.get_events().insert_batch(
            [RefEvent(event="rate", entity_type="user", entity_id=f"u{i}")
             for i in range(5)], app_id)
        outs = {}
        for name, ns in SIDES.items():
            src = ns.orch.StoreSignals("SigApp")
            first = src.observe(watermark_ms=0, last_digest="",
                                ingest_limit=3)
            same = src.observe(watermark_ms=0, last_digest=first.digest,
                               ingest_limit=3)
            digest = ns.eventstore.EventStoreClient.snapshot_digest("SigApp")
            outs[name] = (first.digest, first.ingest_events,
                          same.ingest_events, digest)
        assert outs["port"] == outs["ref"]
        digest, count, skipped, _ = outs["port"]
        assert digest.startswith("rowid:1:5:5:") and count == 3
        assert skipped == 0
        # an append moves the digest in both packages alike
        Storage.get_events().insert_batch(
            [PortEvent(event="rate", entity_type="user", entity_id="u9")],
            app_id)
        moved = {name: ns.eventstore.EventStoreClient.snapshot_digest(
            "SigApp") for name, ns in SIDES.items()}
        assert moved["port"] == moved["ref"] != digest
    finally:
        for ns in SIDES.values():
            ns.Storage.reset()
            ns.eventstore.clear_cache()


# ---------------------------------------------------------------------------
# cycles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("baseline", [True, False])
def test_full_cycle_promotes_like_reference(stores, baseline):
    summaries = {}
    for name, ns in SIDES.items():
        base = seed_baseline(ns) if baseline else None
        orch = make_orch(ns, stores)
        doc = orch.tick(force=True)
        assert doc is not None and doc.outcome == "promoted"
        assert doc.trigger == "manual"
        live = [r for r in ns.Storage.get_meta_data_releases()
                .get_for_variant(EID, EVER, VAR) if r.status == "LIVE"]
        assert [r.id for r in live] == [doc.candidate_release_id]
        if base is not None:
            assert ns.Storage.get_meta_data_releases().get(
                base.id).status == "RETIRED"
        assert orch.store.load_cycle() is None
        with open(os.path.join(orch.store.state_dir, "history",
                               f"{doc.cycle_id}.json")) as f:
            hist = json.load(f)
        assert (hist["outcome"], hist["phase"], hist["phase_status"]) == \
            ("promoted", "promote", "done")
        summaries[name] = (registry_summary(ns), hist["eval_score"],
                           hist["smoke"], hist["attempts"])
    assert summaries["port"] == summaries["ref"]


def test_one_trace_id_spans_the_cycle(stores):
    ns = SIDES["port"]
    seed_baseline(ns)
    ns.trace.recorder().clear()
    doc = make_orch(ns, stores).tick(force=True)
    trace_id = doc.trace.split(":")[0]
    kinds = {}
    for e in ns.trace.recorder().events():
        if e.get("cycleId") == doc.cycle_id:
            kinds.setdefault(e["kind"], []).append(e)
            assert e.get("traceId") == trace_id, e
    assert "orch_trigger" in kinds and "orch_cycle" in kinds
    assert {e["phase"] for e in kinds["orch_phase"]
            if e.get("status") == "done"} == set(port_orch.PHASES)


#: the reference's chaos list (its tests/test_orchestrator.py): the
#: cycle-lifecycle points, the three boundaries of every phase, the
#: in-phase seams and the release-registry commit windows
CHAOS_POINTS = (
    ["orch:cycle:created"]
    + [f"orch:{p}:{edge}" for p in port_orch.PHASES
       for edge in ("enter", "done", "committed")]
    + ["orch:canary:armed", "orch:promote:mid", "orch:cycle:finished",
       "releases:insert:pre", "releases:insert:committed",
       "releases:set-status:pre", "releases:set-status:committed"]
)


def _chaos_run(ns, tmp_path, point):
    baseline = seed_baseline(ns)
    orch = make_orch(ns, tmp_path)
    ns.faults.set_kill_points([point])
    with pytest.raises(ns.faults.CrashError):
        orch.tick(force=True)
    ns.faults.set_kill_points([])
    during = registry_summary(ns)
    orch2 = make_orch(ns, tmp_path)
    action = orch2.recover()
    assert orch2.store.load_cycle() is None, point
    after = registry_summary(ns)
    rels = ns.Storage.get_meta_data_releases()
    listing = rels.get_for_variant(EID, EVER, VAR)
    live = [r for r in listing if r.status == "LIVE"]
    assert len(live) == 1, (point, after)
    assert not [r for r in listing if r.status == "CANARY"], point
    instances = ns.Storage.get_meta_data_engine_instances()
    for r in listing:
        if r.status in ("REGISTERED", "CANARY", "LIVE"):
            inst = instances.get(r.instance_id)
            assert inst is not None and inst.status == "COMPLETED", point
    assert set(after["instances"]) <= {"COMPLETED"}, point
    if live[0].id != baseline.id:
        assert [h["status"] for h in live[0].history].count("LIVE") == 1
        assert rels.get(baseline.id).status == "RETIRED"
    assert set(after["evals"]) <= {"EVALCOMPLETED"}, point
    # the loop keeps working after recovery
    doc2 = orch2.tick(force=True)
    assert doc2 is not None and doc2.outcome == "promoted", point
    return during, action, after, registry_summary(ns)


@pytest.mark.parametrize("point", CHAOS_POINTS)
def test_chaos_kill_converges_like_reference(stores, point):
    got = _chaos_run(SIDES["port"], stores, point)
    want = _chaos_run(SIDES["ref"], stores, point)
    assert got == want


def test_kill_inside_eval_leaves_the_store_as_before(stores):
    outs = {}
    for name, ns in SIDES.items():
        seed_baseline(ns)
        orch = make_orch(ns, stores)
        fake = orch.hooks.evaluate
        armed = {"on": True}

        def killing_eval(doc, ns=ns, fake=fake, armed=armed):
            evals = ns.Storage.get_meta_data_evaluation_instances()
            row = ns.base.EvaluationInstance(status="INIT",
                                             batch=doc.cycle_id)
            row.id = evals.insert(row)
            if armed["on"]:
                armed["on"] = False
                raise ns.faults.CrashError("killed mid-sweep")
            evals.delete(row.id)
            return fake(doc)

        orch.hooks.evaluate = killing_eval
        with pytest.raises(ns.faults.CrashError):
            orch.tick(force=True)
        debris = registry_summary(ns)
        assert "INIT" in debris["evals"]
        orch2 = make_orch(ns, stores)
        orch2.hooks.evaluate = killing_eval
        orch2.recover()
        after = registry_summary(ns)
        assert after["evals"] == ["EVALCOMPLETED"]
        outs[name] = (debris, after)
    assert outs["port"] == outs["ref"]


# ---------------------------------------------------------------------------
# gates, rollbacks, retries, backoff
# ---------------------------------------------------------------------------

GATES = {
    "eval": ("evaluate", lambda ns: lambda doc: (0.1, False, "regressed"),
             "eval gate failed"),
    "smoke_empty": ("smoke", lambda ns: lambda doc: {"written": 0,
                                                     "invalid": 3},
                    "smoke scored no queries"),
    "smoke_invalid": ("smoke", lambda ns: lambda doc: {"written": 1,
                                                       "invalid": 5},
                      "smoke mostly invalid"),
}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_gate_failure_rolls_back_like_reference(stores, gate):
    hook, make, reason = GATES[gate]
    outs = {}
    for name, ns in SIDES.items():
        baseline = seed_baseline(ns)
        orch = make_orch(ns, stores)
        setattr(orch.hooks, hook, make(ns))
        doc = orch.tick(force=True)
        assert doc.outcome == "rolled_back" and reason in doc.reason
        assert ns.Storage.get_meta_data_releases().latest(
            EID, EVER, VAR, status="LIVE").id == baseline.id
        assert ns.Storage.get_meta_data_releases().get(
            doc.candidate_release_id).status == "ROLLED_BACK"
        state = orch.store.load_trigger_state(0)
        outs[name] = (registry_summary(ns), doc.reason,
                      state.consecutive_failures, state.last_outcome)
    assert outs["port"] == outs["ref"]
    assert outs["port"][0]["evals"] == []


def _slo_burn_cycle(ns, tmp_path):
    baseline = seed_baseline(ns)
    registry = ns.registry.MetricsRegistry()
    spec = ns.slo.SLOSpec.from_dict({
        "objectives": [{"name": "err", "kind": "errors", "budget": 0.01}],
        "windows": [{"seconds": 60, "burnThreshold": 1.0}],
        "evalIntervalS": 0.01})
    burst = {"bad": 0.0, "total": 0.0}
    engine = ns.slo.SLOEngine(registry, spec, sources={
        "errors": lambda obj: (burst["bad"], burst["total"])})
    clock = FakeClock()
    orch = make_orch(
        ns, tmp_path, clock=clock, registry=registry,
        judge=ns.orch.make_slo_judge(engine, hold_s=0.2, sleep=clock.sleep,
                                     tick_s=0.05),
        cooldown_s=5.0, cycle_backoff_s=60.0, cycle_backoff_cap_s=600.0,
        min_ingest_events=1)
    engine.tick(now=0.0)
    burst["bad"], burst["total"] = 50.0, 100.0
    doc = orch.tick(force=True)
    assert doc.outcome == "rolled_back" and "slo_burn" in doc.reason
    assert ns.Storage.get_meta_data_releases().latest(
        EID, EVER, VAR, status="LIVE").id == baseline.id
    state = orch.store.load_trigger_state(clock.now_ms())
    gap_ms = state.next_earliest_ms - state.last_cycle_end_ms
    assert 5_000 + 30_000 <= gap_ms <= 5_000 + 60_000

    class Scripted:
        def observe(self, watermark_ms, last_digest, limit):
            return ns.orch.TriggerSignals(ingest_events=10_000)

    orch.hooks.signals = Scripted()
    assert orch.tick() is None          # suppressed by the backoff
    suppressed = {labels["reason"]: v for labels, v in
                  orch.metrics.suppressed_total.samples()}
    return registry_summary(ns), doc.reason, gap_ms, suppressed


def test_slo_judged_canary_rolls_back_with_backoff(stores):
    assert _slo_burn_cycle(SIDES["port"], stores) == \
        _slo_burn_cycle(SIDES["ref"], stores)


def _retry_case(ns, tmp_path, case):
    seed_baseline(ns)
    clock = FakeClock()
    if case == "transient":
        orch = make_orch(ns, tmp_path, clock=clock, phase_retries=3,
                         phase_backoff_s=0.5, phase_backoff_cap_s=2.0)
    elif case == "timeout":
        orch = make_orch(ns, tmp_path, phase_retries=1,
                         phase_timeout_s=0.05)
    else:
        orch = make_orch(ns, tmp_path, phase_retries=2 if case == "poison"
                         else 1)
    calls = {"n": 0}
    real = orch.hooks.train
    release = threading.Event()

    def train(doc):
        calls["n"] += 1
        if case == "transient" and calls["n"] <= 2:
            raise RuntimeError("transient storage hiccup")
        if case == "exhausted":
            raise RuntimeError("datasource down")
        if case == "timeout":
            release.wait(5.0)
            return None
        if case == "poison" and calls["n"] == 1:
            doc.candidate_release_version = 999
            doc.train_instance_id = "poison"
            raise RuntimeError("died after partial writes")
        return real(doc)

    orch.hooks.train = train
    t0 = time.monotonic()
    doc = orch.tick(force=True)
    release.set()
    elapsed = time.monotonic() - t0
    retried = sum(v for _, v in orch.metrics.phase_retries.samples())
    outcomes = {labels["outcome"]: v
                for labels, v in orch.metrics.cycles_total.samples()}
    slept_ms = clock.ms - 1_000_000
    return (doc.outcome, doc.reason.split(":")[0], calls["n"],
            dict(doc.attempts), retried, outcomes,
            doc.candidate_release_version, doc.train_instance_id != "poison",
            registry_summary(ns)), elapsed, slept_ms


@pytest.mark.parametrize("case", ["transient", "exhausted", "timeout",
                                  "poison"])
def test_phase_retries_and_bounds_match_reference(stores, case):
    got, elapsed, slept_ms = _retry_case(SIDES["port"], stores, case)
    want, _, ref_slept = _retry_case(SIDES["ref"], stores, case)
    assert got == want
    if case == "transient":
        assert got[0] == "promoted" and got[2] == 3 and got[4] == 2
        # full jitter: each backoff sleep within its ceiling
        assert 0 <= slept_ms <= 500 + 1000 and slept_ms == ref_slept
    elif case == "exhausted":
        assert got[0] == "failed" and got[1] == \
            "train failed after 2 attempt(s)"
    elif case == "timeout":
        assert got[0] == "failed" and elapsed < 5.0
    else:
        assert got[0] == "promoted" and got[6] == 2 and got[7]


def test_converge_heals_foreign_debris(stores):
    outs = {}
    for name, ns in SIDES.items():
        seed_baseline(ns)
        rels = ns.Storage.get_meta_data_releases()
        canary = ns.releases.record_release(
            _completed_instance(ns, batch="x"), train_seconds=0.1, blob=b"c")
        rels.set_status(canary.id, "CANARY", "manual deploy, process died")
        rels.insert(ns.base.Release(engine_id=EID, engine_version=EVER,
                                    engine_variant=VAR,
                                    instance_id="no-such-instance"))
        second = ns.releases.record_release(
            _completed_instance(ns, batch="y"), train_seconds=0.1, blob=b"d")
        rels.set_status(second.id, "LIVE", "torn manual promote")
        stats = make_orch(ns, stores).converge_registry()
        outs[name] = (stats, registry_summary(ns))
    assert outs["port"] == outs["ref"]
    assert outs["port"][0] == {"ghosts": 1, "orphaned_canaries": 1,
                               "dual_live": 1, "baseline_restored": 0}


def test_tick_recovers_a_pending_cycle_instead_of_triggering(stores):
    ns = SIDES["port"]
    seed_baseline(ns)
    orch = make_orch(ns, stores)
    ns.faults.set_kill_points(["orch:smoke:enter"])
    with pytest.raises(ns.faults.CrashError):
        orch.tick(force=True)
    ns.faults.set_kill_points([])
    orch2 = make_orch(ns, stores)
    assert orch2.tick() is None
    assert orch2.store.load_cycle() is None
    assert registry_summary(ns)["live"] == 1


# ---------------------------------------------------------------------------
# HttpPlane against the port's query server (CPU, over HTTP)
# ---------------------------------------------------------------------------

N_USERS, N_ITEMS, RANK, APP = 24, 40, 4, "PlaneApp"


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return (np.asarray([f"u{i}" for i in range(N_USERS)], dtype=object),
            np.asarray([f"i{i}" for i in range(N_ITEMS)], dtype=object),
            rng.normal(size=(N_USERS, RANK)).astype(np.float32),
            rng.normal(size=(N_ITEMS, RANK)).astype(np.float32))


def _register(seed, instance_id):
    from predictionio_tpu_torch.models.als import ALSModel
    from predictionio_tpu_torch.workflow.serialization import (
        serialize_models,
    )

    inst = port_base.EngineInstance(
        id=instance_id, status="COMPLETED", engine_id=EID,
        engine_version=EVER, engine_variant=VAR,
        data_source_params=json.dumps({"appName": APP}),
        algorithms_params=json.dumps([{"name": "als",
                                       "params": {"rank": RANK}}]))
    Storage.get_meta_data_engine_instances().insert(inst)
    blob = serialize_models([ALSModel.from_arrays(*_arrays(seed),
                                                  device="cpu")])
    Storage.get_model_data_models().insert(
        port_base.Model(id=inst.id, models=blob))
    return inst, port_releases.record_release(inst, 1.0, blob)


class _Served:
    """The port's query server over v1 on a loop thread."""

    def __init__(self):
        from predictionio_tpu_torch.engines.recommendation import (
            default_engine_params, engine,
        )
        from predictionio_tpu_torch.models.als import ALSModel
        from predictionio_tpu_torch.server.query_server import QueryServer
        from predictionio_tpu_torch.utils.server_config import (
            DeployConfig, FoldinConfig, ScorerConfig,
        )

        inst, self.rel1 = _register(0, "incumbent")
        Storage.get_meta_data_releases().set_status(self.rel1.id, "LIVE",
                                                    "seed deploy")
        result = engine().prepare_deploy(
            default_engine_params(APP, rank=RANK),
            [ALSModel.from_arrays(*_arrays(0), device="cpu")])
        self.server = QueryServer(
            engine(), result, inst, scorer_config=ScorerConfig(mode="exact"),
            max_batch=8, linger_s=0.0, release=self.rel1,
            foldin_config=FoldinConfig(enabled=False),
            deploy_config=DeployConfig(
                warmup=True, canary_min_samples=3, canary_promote_after=6,
                canary_p99_ratio=50.0, canary_latency_slack_s=2.0))
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.port = self._run(self.server.start("127.0.0.1", 0))
        self.url = f"http://127.0.0.1:{self.port}"

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(60)

    def query(self, user):
        import urllib.request

        req = urllib.request.Request(
            f"{self.url}/queries.json", method="POST",
            data=json.dumps({"user": user, "num": 3}).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    def close(self):
        self._run(self.server.close())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


@pytest.fixture()
def served(tmp_path):
    Storage.reset()
    Storage.configure(_db_config(tmp_path / "plane.db"))
    s = _Served()
    yield s
    s.close()
    Storage.reset()


def _canary_doc(rel):
    return port_orch.CycleDoc(cycle_id=f"plane-{rel.version}",
                              candidate_release_id=rel.id,
                              candidate_release_version=rel.version)


def test_http_plane_canary_promoted_by_the_server(served):
    _, rel2 = _register(3, "candidate")
    plane = port_orch.HttpPlane(served.url, fraction=0.5, poll_s=0.02,
                                verdict_timeout_s=30.0)
    stop = threading.Event()

    def traffic():
        i = 0
        while not stop.is_set():
            served.query(f"u{i % N_USERS}")
            i += 1

    load = threading.Thread(target=traffic, daemon=True)
    load.start()
    try:
        verdict, reason = plane.canary(_canary_doc(rel2))
    finally:
        stop.set()
        load.join(10)
    assert verdict == "promote", reason
    assert "v2" in reason or "healthy" in reason
    plane.promote(_canary_doc(rel2))
    rels = Storage.get_meta_data_releases()
    assert rels.get(rel2.id).status == "LIVE"
    assert rels.get(served.rel1.id).status == "RETIRED"
    assert plane.get("/deploy/status.json")["active"]["releaseVersion"] == 2


def test_http_plane_operator_rollback_and_timeout(served):
    """An operator's abort during the hold reads as a rollback; a canary
    that never reaches a verdict is aborted by the plane itself."""
    _, rel2 = _register(3, "candidate")
    plane = port_orch.HttpPlane(served.url, fraction=0.5, poll_s=0.02,
                                verdict_timeout_s=30.0)

    def operator():
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if plane.get("/deploy/status.json").get("canary"):
                plane._request("/rollback.json", {})
                return
            time.sleep(0.02)

    t = threading.Thread(target=operator, daemon=True)
    t.start()
    verdict, reason = plane.canary(_canary_doc(rel2))
    t.join(10)
    assert verdict == "rollback" and "server rolled back" in reason, reason
    assert Storage.get_meta_data_releases().get(rel2.id).status == \
        "ROLLED_BACK"
    plane.rollback(_canary_doc(rel2), reason)
    assert Storage.get_meta_data_releases().get(served.rel1.id).status == \
        "LIVE"

    _, rel3 = _register(5, "candidate-3")
    slow = port_orch.HttpPlane(served.url, fraction=0.5, poll_s=0.02,
                               verdict_timeout_s=1.0)
    verdict, reason = slow.canary(_canary_doc(rel3))
    assert verdict == "rollback" and "no canary verdict" in reason
    st = slow.get("/deploy/status.json")
    assert st["canary"] is None and st["active"]["releaseVersion"] == 1
    assert Storage.get_meta_data_releases().get(rel3.id).status == \
        "ROLLED_BACK"


# ---------------------------------------------------------------------------
# orchestrate --once through the CLI (a subprocess on the CPU)
# ---------------------------------------------------------------------------

def test_cli_orchestrate_once_subprocess(tmp_path):
    env = dict(os.environ)
    env.update({
        "PIO_HOME": str(tmp_path),
        "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db"),
        **{f"PIO_STORAGE_REPOSITORIES_{r}_{k}": v
           for r in ("METADATA", "EVENTDATA", "MODELDATA")
           for k, v in (("NAME", "pio"), ("SOURCE", "DB"))},
        "PIO_ORCH_MIN_INGEST_EVENTS": "50", "PIO_ORCH_COOLDOWN_S": "0",
        "PIO_ORCH_PHASE_RETRIES": "0", "PIO_TELEMETRY": "0"})
    env.pop("PIO_FAULT_KILL", None)

    Storage.reset()
    port_eventstore.clear_cache()
    Storage.configure(_db_config(tmp_path / "pio.db"))
    try:
        app_id = Storage.get_meta_data_apps().insert(
            port_base.App(id=0, name="OrchCli"))
        Storage.get_events().init_channel(app_id)
        rng = random.Random(1)

        def rate(n):
            Storage.get_events().insert_batch([PortEvent(
                event="rate", entity_type="user",
                entity_id=f"u{rng.randrange(12)}",
                target_entity_type="item",
                target_entity_id=f"i{rng.randrange(15)}",
                properties={"rating": 1.0 + rng.randrange(5)})
                for _ in range(n)], app_id)

        rate(120)
        variant = tmp_path / "engine.json"
        variant.write_text(json.dumps({
            "id": "default",
            "engineFactory":
                "predictionio_tpu_torch.engines.recommendation:engine",
            "datasource": {"params": {"appName": "OrchCli"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 3, "numIterations": 2, "lambda": 0.05}}]}))
        smoke = tmp_path / "smoke.jsonl"
        smoke.write_text("".join(json.dumps({"user": f"u{i}", "num": 3})
                                 + "\n" for i in range(4)))
        env["PIO_ORCH_SMOKE_QUERIES"] = str(smoke)
        argv = [sys.executable, "-m", "predictionio_tpu_torch.cli.main",
                "orchestrate", "-v", str(variant), "--once",
                "--state-dir", str(tmp_path / "state"), "--device", "cpu"]

        def run(*extra):
            return subprocess.run(argv + list(extra), cwd=ROOT, env=env,
                                  capture_output=True, text=True,
                                  timeout=180)

        out = run("--force")
        assert out.returncode == 0, out.stdout + out.stderr[-3000:]
        assert "promoted" in out.stdout and "trace id" in out.stdout
        assert "candidate release v1" in out.stdout
        # no fresh events since the cycle: nothing fires
        out = run()
        assert out.returncode == 0, out.stderr[-3000:]
        assert "No trigger fired" in out.stdout
        # fresh events past the threshold fire the ingest trigger
        rate(60)
        out = run()
        assert out.returncode == 0, out.stdout + out.stderr[-3000:]
        assert "(ingest_volume): promoted" in out.stdout
        assert "candidate release v2" in out.stdout
        rels = Storage.get_meta_data_releases().get_for_variant(
            "predictionio_tpu_torch.engines.recommendation:engine", "1",
            "default")
        assert [r.status for r in rels] == ["LIVE", "RETIRED"]
        with open(tmp_path / "state" / "trigger.json") as f:
            trig = json.load(f)
        assert trig["last_outcome"] == "promoted"
        assert trig["last_digest"].startswith("rowid:")
    finally:
        Storage.reset()
        port_eventstore.clear_cache()
