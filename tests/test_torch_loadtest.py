"""The load test of the port (``predictionio_tpu_torch/loadtest/``,
``obs/loadtest_stats.py``, ``utils/server_config.LoadtestConfig``, ``pio
loadtest``), held against the JAX package on the CPU.

* The Zipf sampler, ``arrival_offsets``, ``diurnal_rate``, the storm's
  lane split and the population's payloads equal the reference's
  exactly under one seed.
* Scenarios round-trip, and each rejection names the reference's JSON
  path with the reference's message.
* ``LatencyLedger`` percentiles, ``drive_open_loop``'s accounting and
  the invariant engine's verdicts equal the reference's on the same
  inputs; the knobs and the series names are the reference's.
* The port's ``LocalFleet`` runs the reference's storm smoke (3 s, 2
  replicas, 2 partitions, a retrain) on the CPU with every invariant
  holding, a storm with a replica killed and restarted, an SLO burn and
  degraded quality, and ``MultiTenantFleet`` the tenant storm (beta
  shed, alpha and gamma untouched).
"""

import concurrent.futures
import json
import os

import numpy as np
import pytest

import predictionio_tpu.loadtest.harness as ref_harness
import predictionio_tpu.loadtest.invariants as ref_invariants
import predictionio_tpu.loadtest.population as ref_population
import predictionio_tpu.loadtest.scenario as ref_scenario
import predictionio_tpu.loadtest.simulator as ref_simulator
import predictionio_tpu.obs.loadtest_stats as ref_stats
import predictionio_tpu.utils.server_config as ref_config
import predictionio_tpu_torch.loadtest.harness as port_harness
import predictionio_tpu_torch.loadtest.invariants as port_invariants
import predictionio_tpu_torch.loadtest.population as port_population
import predictionio_tpu_torch.loadtest.scenario as port_scenario
import predictionio_tpu_torch.loadtest.simulator as port_simulator
import predictionio_tpu_torch.obs.loadtest_stats as port_stats
import predictionio_tpu_torch.utils.server_config as port_config
from predictionio_tpu.obs.registry import MetricsRegistry as RefRegistry
from predictionio_tpu_torch.obs.registry import MetricsRegistry

PAIRS = {"reference": (ref_harness, ref_invariants, ref_population,
                       ref_scenario),
         "port": (port_harness, port_invariants, port_population,
                  port_scenario)}


# ---------------------------------------------------------------------------
# samplers and payloads: equal draw for draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,alpha,seed", [(1, 1.1, 0), (500, 1.1, 42),
                                          (20_000, 0.9, 7),
                                          (200_000, 1.4, 3)])
def test_zipf_sampler_equals_the_reference(n, alpha, seed):
    ref = ref_population.ZipfSampler(n, alpha=alpha, seed=seed)
    port = port_population.ZipfSampler(n, alpha=alpha, seed=seed)
    assert np.array_equal(port.sample(4096), ref.sample(4096))
    assert [port.sample() for _ in range(16)] \
        == [ref.sample() for _ in range(16)]
    assert port.probability(n - 1) == ref.probability(n - 1)
    with pytest.raises(ValueError):
        port_population.ZipfSampler(0)


@pytest.mark.parametrize("args", [
    (6.0, 150.0, 0.5, 6.0, 0.0, 11), (24.0, 400.0, 0.5, 24.0, 0.0, 7),
    (5.0, 300.0, 0.0, 86400.0, 0.0, 3), (0.0, 100.0, 0.5, 1.0, 0.0, 1),
    (3.0, 30.0, 0.4, 3.0, 1.5, 5)])
def test_arrival_offsets_equal_the_reference(args):
    got = port_population.arrival_offsets(*args[:5], seed=args[5])
    want = ref_population.arrival_offsets(*args[:5], seed=args[5])
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for t in (0.0, 1.3, 7.7):
        assert port_population.diurnal_rate(t, *args[1:5]) \
            == ref_population.diurnal_rate(t, *args[1:5])


def test_storm_lanes_split_like_the_reference():
    doc = dict(ref_scenario.example_scenario(), durationS=14.0,
               baseRate=120.0)
    got = port_simulator._Lanes(port_scenario.Scenario.from_dict(doc))
    want = ref_simulator._Lanes(ref_scenario.Scenario.from_dict(doc))
    for name in ("event_offsets", "query_offsets", "feedback_offsets"):
        assert np.array_equal(getattr(got, name), getattr(want, name))
    assert got.total == want.total > 0


def _payloads(mod, seed):
    pop = mod.Population(10_000, 500, seed=seed)
    out = []
    for i in range(200):
        uid = pop.next_user()
        if i % 5 == 3:
            pop.record_recommendations(uid, [f"i{j}" for j in range(i % 7)])
            ev = pop.feedback_for(uid, i * 0.1)
            d = ev.to_dict() if ev is not None else None
        elif i % 5 == 4:
            d = pop.query_for(uid, num=3 + i % 4)
        else:
            d = pop.event_for(uid, i * 0.05 - (i % 3)).to_dict()
        if d is not None:
            d.pop("creationTime", None)      # wall clock, not seeded
        out.append((uid, d))
    sess = [(s.user_id, list(s.views), s.last_recs, s.events_sent,
             s.queries_sent, s.feedback_sent, s.clock_s)
            for s in pop._sessions.values()]
    return out, sess, pop.active_users


def test_population_payloads_equal_the_reference():
    for seed in (0, 9):
        assert _payloads(port_population, seed) \
            == _payloads(ref_population, seed)
    assert port_population.Population.EPOCH \
        == ref_population.Population.EPOCH


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def test_scenarios_round_trip_like_the_reference(tmp_path):
    for make in ("example_scenario", "example_tenant_scenario"):
        doc = getattr(ref_scenario, make)()
        assert getattr(port_scenario, make)() == doc
        port = port_scenario.Scenario.from_dict(doc)
        ref = ref_scenario.Scenario.from_dict(doc)
        assert port.to_dict() == ref.to_dict()
        assert port_scenario.Scenario.from_dict(port.to_dict()).to_dict() \
            == port.to_dict()
        assert port.effective_period_s == ref.effective_period_s
    path = tmp_path / "storm.json"
    path.write_text(json.dumps(ref_scenario.example_scenario()))
    assert port_scenario.Scenario.load(str(path)).to_dict() \
        == ref_scenario.Scenario.load(str(path)).to_dict()
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(port_scenario.ScenarioError, match="not valid JSON"):
        port_scenario.Scenario.load(str(bad))


REJECTIONS = [
    {"bogusKey": 1}, {"population": "many"}, {"population": 0},
    {"population": 2.5}, {"amplitude": 1.5}, {"backend": "oracle"},
    {"name": ""}, {"durationS": 0.1}, {"replicas": 17},
    {"mix": {"events": 0.5, "queries": 0.5, "feedback": 0.5}},
    {"mix": {"events": 0.5, "queries": 0.5, "surprise": 0.0}},
    {"mix": [1]}, {"incidents": {}},
    {"incidents": [{"kind": "meteor", "atS": 1.0}]},
    {"incidents": [{"kind": "retrain", "atS": 999.0}]},
    {"incidents": [{"kind": "retrain", "atS": 1.0, "restartAfterS": 2.0}]},
    {"incidents": [{"kind": "kill_replica", "atS": 1.0, "target": 9}]},
    {"incidents": [{"kind": "kill_replica", "atS": 1.0, "blast": True}]},
    {"incidents": ["retrain"]},
    {"tenants": [{"name": "a"}, {"name": "a"}]},
    {"tenants": [{"name": ""}]}, {"tenants": [{"name": "a/b"}]},
    {"tenants": [{"name": "a", "rateScale": 0}]},
    {"tenants": [{"name": "a", "surprise": 1}]},
    {"tenants": [{"name": "a"}],
     "incidents": [{"kind": "burn_slo", "atS": 1.0, "tenant": "ghost"}]},
    {"incidents": [{"kind": "retrain", "atS": 1.0, "tenant": "a"}]},
]


@pytest.mark.parametrize("patch", REJECTIONS, ids=lambda p: json.dumps(p))
def test_scenario_rejections_name_the_reference_path(patch):
    msgs = []
    for mod in (ref_scenario, port_scenario):
        doc = dict(mod.example_scenario())
        doc.update(patch)
        with pytest.raises(mod.ScenarioError) as err:
            mod.Scenario.from_dict(doc)
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]
    assert msgs[1].startswith("$")


# ---------------------------------------------------------------------------
# harness, invariants, knobs and series
# ---------------------------------------------------------------------------

def _done(value=None, exc=None):
    f = concurrent.futures.Future()
    if exc is not None:
        f.set_exception(exc)
    else:
        f.set_result(value)
    return f


def _ledger_view(mod, samples):
    led = mod.LatencyLedger()
    for s in samples:
        led.record(s)
    return ([led.percentile_ms(q) for q in (0, 1, 50, 90, 99, 99.9, 100)],
            led.mean_ms(), len(led))


def test_latency_ledger_equals_the_reference():
    rng = np.random.default_rng(4)
    for n in (0, 1, 4, 257, 5000):
        samples = rng.exponential(0.05, size=n).tolist()
        assert _ledger_view(port_harness, samples) \
            == _ledger_view(ref_harness, samples)


def _drive(mod):
    """Acked, failed, raising and weighted submits, then a drive that
    times out; the accounting of each."""
    acked = []

    def submit(i):
        if i % 7 == 3:
            raise RuntimeError("no")
        return _done(i, RuntimeError("boom") if i % 5 == 1 else None)

    res = mod.drive_open_loop(
        [list(range(i % 4 + 1)) for i in range(40)],
        lambda b: submit(len(b) * 10 + b[-1]), max_outstanding=3,
        timeout_s=10.0, weight=len,
        on_ack=lambda item, fut: acked.append(len(item)))
    hung = mod.drive_open_loop(
        [1, 2, 3], lambda i: concurrent.futures.Future(),
        max_outstanding=8, timeout_s=0.3)
    d = res.as_dict()
    for k in ("wall_s", "events_per_s", "ack_p50_ms", "ack_p99_ms"):
        d.pop(k)
    return (d, sorted(acked), len(res.ledger), hung.timed_out,
            hung.dropped, hung.acked)


def test_drive_open_loop_accounts_like_the_reference():
    got, want = _drive(port_harness), _drive(ref_harness)
    assert got == want
    assert got[0]["dropped"] == 0 and got[0]["failed"] > 0
    assert got[3] is True and got[4] == 3


class _Rel:
    def __init__(self, version, status):
        self.version, self.status = version, status


class _Rels:
    def __init__(self, rels):
        self._rels = rels

    def get_all(self):
        return self._rels


class _Cycle:
    def __init__(self, outcome):
        self.outcome = outcome


def _verdicts(pkg):
    harness, invariants, _, _ = PAIRS[pkg]
    reg = MetricsRegistry() if pkg == "port" else RefRegistry()
    eng = invariants.InvariantEngine(reg)
    clean = harness.OpenLoopResult(offered=5, acked=5, failed=0, wall_s=1.0,
                                   ledger=harness.LatencyLedger())
    leaky = harness.OpenLoopResult(offered=5, acked=3, failed=1, wall_s=1.0,
                                   ledger=harness.LatencyLedger(),
                                   timed_out=True)
    out = [
        eng.check_open_loop("no_dropped_acks", clean),
        eng.check_open_loop("no_dropped_acks", leaky),
        eng.check_registry_converged(_Rels([_Rel(1, "RETIRED"),
                                            _Rel(2, "LIVE")])),
        eng.check_registry_converged(_Rels([_Rel(1, "LIVE"),
                                            _Rel(2, "LIVE")])),
        eng.check_retrain_promoted([_Cycle("promoted")]),
        eng.check_retrain_promoted([_Cycle("rolled_back"), None]),
        eng.check_latency("ack_p99_bound", 12.0, 100.0),
        eng.check_latency("ack_p99_bound", 500.0, 100.0),
        eng.check_freshness(10, 0.5, 30.0),
        eng.check_freshness(10, None, 30.0),
        eng.check_freshness(0, None, 30.0),
        eng.check_freshness(10, 31.0, 30.0),
        eng.check("custom", True, "fine"),
    ]
    counts = reg.get("pio_loadtest_invariant_checks_total")
    return (out, eng.ok, eng.report(),
            [r.name for r in eng.failures()],
            sorted((tuple(sorted(lab.items())), v)
                   for lab, v in counts.samples()))


def test_invariant_verdicts_equal_the_reference():
    got, want = _verdicts("port"), _verdicts("reference")
    assert got == want
    assert got[1] is False and len(got[2]) == 13


def test_loadtest_knobs_equal_the_reference(monkeypatch, tmp_path):
    doc = {"population": 500, "durationS": 3, "rateScale": 0.5,
           "seed": 4, "maxOutstanding": 9, "reportDir": "a"}
    env = {"PIO_LOADTEST_POPULATION": "700", "PIO_LOADTEST_SEED": "bad",
           "PIO_LOADTEST_RATE_SCALE": "2.0",
           "PIO_LOADTEST_REPORT_DIR": str(tmp_path)}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = port_config.LoadtestConfig.from_env(doc)
    want = ref_config.LoadtestConfig.from_env(doc)
    assert got.__dict__ == want.__dict__
    sc_port = got.apply(port_scenario.Scenario.from_dict(
        port_scenario.example_scenario()))
    sc_ref = want.apply(ref_scenario.Scenario.from_dict(
        ref_scenario.example_scenario()))
    assert sc_port.to_dict() == sc_ref.to_dict()
    assert port_config.loadtest_config().__dict__ \
        == ref_config.loadtest_config().__dict__


def test_loadtest_series_equal_the_reference():
    port_reg, ref_reg = MetricsRegistry(), RefRegistry()
    names = [n for n in dir(ref_stats) if n.startswith("loadtest_")]
    assert names == [n for n in dir(port_stats) if n.startswith("loadtest_")]
    for n in names:
        p = getattr(port_stats, n)(port_reg)
        r = getattr(ref_stats, n)(ref_reg)
        assert (p.name, p.kind, p.help, tuple(p.labelnames)) \
            == (r.name, r.kind, r.help, tuple(r.labelnames))
    assert port_stats.LATENCY_BUCKETS == tuple(ref_stats.LATENCY_BUCKETS) \
        or list(port_stats.LATENCY_BUCKETS) \
        == list(ref_stats.LATENCY_BUCKETS)


def test_cli_prints_the_reference_example(capsys):
    from click.testing import CliRunner

    from predictionio_tpu.cli.main import cli
    from predictionio_tpu_torch.cli.main import main

    want = CliRunner().invoke(cli, ["loadtest", "--example"]).output
    assert main(["loadtest", "--example"]) == 0
    assert capsys.readouterr().out == want
    assert main(["loadtest", "--show-example"]) == 0
    assert json.loads(capsys.readouterr().out) \
        == ref_scenario.example_scenario()


# ---------------------------------------------------------------------------
# storms on the CPU
# ---------------------------------------------------------------------------

def test_storm_smoke_mixed_lanes_retrain(tmp_path):
    """The reference's storm smoke (tests/test_loadtest.py), through the
    port's fleet on the CPU: every invariant holds, the exactly-once
    audit covers both partitions, a retrain promotes mid-run."""
    from predictionio_tpu_torch.loadtest.fleet import LocalFleet
    from predictionio_tpu_torch.loadtest.simulator import run_storm

    sc = port_scenario.Scenario.from_dict({
        "name": "smoke", "population": 120, "items": 40,
        "durationS": 3.0, "seed": 5, "baseRate": 30.0, "amplitude": 0.4,
        "mix": {"events": 0.6, "queries": 0.3, "feedback": 0.1},
        "replicas": 2, "partitions": 2, "backend": "sqlite",
        "maxOutstanding": 64,
        "incidents": [{"kind": "retrain", "atS": 1.0}],
    })
    fleet = LocalFleet(str(tmp_path / "fleet"), replicas=sc.replicas,
                       partitions=sc.partitions, backend=sc.backend,
                       device="cpu")
    try:
        fleet.start()
        report = run_storm(sc, fleet, check_freshness=False)
    finally:
        fleet.stop()
    assert report["ok"], report["invariants"]
    lanes = report["lanes"]
    assert lanes["events"]["acked"] > 0 and lanes["queries"]["acked"] > 0
    assert all(lane["dropped"] == 0 for lane in lanes.values())
    assert report["audit"]["ok"], report["audit"]["summary"]
    assert sorted(report["audit"]["partitions"]) == ["0", "1"]
    # every acked event and the fleet's 160 seed events, audited
    assert report["audit"]["expected"] == lanes["events"]["acked"] \
        + lanes["feedback"]["acked"] + 160
    assert any(c["outcome"] == "promoted" for c in report["cycles"])
    assert report["active_users"] > 0
    assert [r["name"] for r in report["invariants"]] == [
        "no_dropped_acks", "no_dropped_queries", "no_dropped_feedback",
        "exactly_once_ingest", "registry_one_live",
        "retrain_promoted_mid_run", "ack_p99_bound", "query_p99_bound"]
    # the fleet restored the process-wide knobs it set
    assert "PIO_SERVER_CONF" not in os.environ
    assert "PIO_INGEST_PARTITIONS" not in os.environ


def test_fleet_refuses_parquet_and_a_missing_card(tmp_path):
    import torch

    from predictionio_tpu_torch.loadtest.fleet import LocalFleet

    with pytest.raises(NotImplementedError, match="item 8"):
        LocalFleet(str(tmp_path), backend="parquet", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LocalFleet(str(tmp_path / "f")).start()
        assert not (tmp_path / "f").exists()


def test_tenant_storm_burn_sheds_one_tenant_only(tmp_path):
    """The reference's tenant storm through the port's host: admission
    429s beta while alpha and gamma drop nothing, take no rejection and
    hold their p99."""
    from predictionio_tpu_torch.loadtest.fleet import MultiTenantFleet
    from predictionio_tpu_torch.loadtest.simulator import run_tenant_storm

    sc = port_scenario.Scenario.from_dict({
        "name": "mt-smoke", "durationS": 4.0, "seed": 11,
        "baseRate": 25.0, "amplitude": 0.3, "maxOutstanding": 32,
        "tenants": [
            {"name": "alpha", "population": 300, "items": 80,
             "rateScale": 1.0},
            {"name": "beta", "population": 100, "items": 40,
             "rateScale": 0.6, "itemAlpha": 1.4},
            {"name": "gamma", "population": 500, "items": 120,
             "rateScale": 0.4, "itemAlpha": 0.9},
        ],
        "incidents": [{"kind": "burn_slo", "atS": 0.5, "tenant": "beta",
                       "durationS": 2.5}],
    })
    fleet = MultiTenantFleet(str(tmp_path / "mtfleet"), sc.tenants,
                             device="cpu")
    try:
        fleet.start()
        report = run_tenant_storm(sc, fleet, query_p99_bound_ms=5000.0)
    finally:
        fleet.stop()
    assert report["ok"], report["invariants"]
    tenants = report["tenants"]
    assert set(tenants) == {"alpha", "beta", "gamma"}
    assert tenants["beta"]["rejections"] > 0
    assert all(t["dropped"] == 0 for t in tenants.values())
    assert tenants["alpha"]["rejections"] == 0
    assert tenants["gamma"]["rejections"] == 0
    assert tenants["alpha"]["acked"] > 0 and tenants["gamma"]["acked"] > 0
    names = {inv["name"] for inv in report["invariants"]}
    assert {"tenant_shed:beta", "tenant_p99:alpha",
            "tenant_p99:gamma"} <= names
    assert "tenant_p99:beta" not in names
    # each tenant's queries were answered over its own catalog
    assert tenants["alpha"]["activeUsers"] > 0


def test_tenant_storm_refuses_other_incidents():
    sc = port_scenario.Scenario.from_dict(
        dict(port_scenario.example_tenant_scenario(),
             incidents=[{"kind": "retrain", "atS": 1.0}]))
    with pytest.raises(ValueError, match="burn_slo"):
        port_simulator.run_tenant_storm(sc, object())
    with pytest.raises(ValueError, match="no tenants"):
        port_simulator.run_tenant_storm(port_scenario.Scenario.from_dict(
            port_scenario.example_scenario()), object())


def test_storm_survives_a_replica_killed_and_restarted(tmp_path):
    """The chaos levers the port's sqlite fleet has: a replica killed and
    restarted on its port, an SLO burn and degraded quality mid-storm;
    no query or ack is dropped and the audit is clean
    (``kill_compaction`` is a no-op on sqlite, as in the reference)."""
    from predictionio_tpu_torch.loadtest.fleet import LocalFleet
    from predictionio_tpu_torch.loadtest.simulator import run_storm

    sc = port_scenario.Scenario.from_dict({
        "name": "chaos-sqlite", "population": 200, "items": 60,
        "durationS": 4.0, "seed": 13, "baseRate": 30.0, "amplitude": 0.5,
        "mix": {"events": 0.7, "queries": 0.25, "feedback": 0.05},
        "replicas": 2, "partitions": 2, "backend": "sqlite",
        "maxOutstanding": 64,
        "incidents": [
            {"kind": "kill_replica", "atS": 0.8, "target": 1,
             "restartAfterS": 1.2},
            {"kind": "kill_compaction", "atS": 1.5},
            {"kind": "burn_slo", "atS": 1.0, "durationS": 1.0},
            {"kind": "degrade_quality", "atS": 2.0, "durationS": 1.0}],
    })
    fleet = LocalFleet(str(tmp_path / "fleet"), replicas=2, partitions=2,
                       device="cpu")
    try:
        fleet.start()
        report = run_storm(sc, fleet, check_freshness=False)
        restarted = fleet._replica_servers[1] is not None
    finally:
        fleet.stop()
    assert report["ok"], report["invariants"]
    assert report["audit"]["ok"] and restarted
    assert all(lane["dropped"] == 0 and lane["failed"] == 0
               for lane in report["lanes"].values())


# ---------------------------------------------------------------------------
# the storm's traffic process
# ---------------------------------------------------------------------------

class _StubClient:
    """Answers every lane at once: event batches ack their ids, queries
    answer one slate."""

    def __init__(self):
        self.ratings = []           #: the events lane's ratings
        self.queries = 0

    def submit_event_batch(self, payloads):
        if len(payloads) > 1:       # the events lane's (feedback: one)
            self.ratings.extend(p["properties"].get("rating")
                                for p in payloads)
        fut = concurrent.futures.Future()
        fut.set_result([f"id{len(self.ratings)}-{i}"
                        for i in range(len(payloads))])
        return fut

    def submit_query(self, payload):
        self.queries += 1
        fut = concurrent.futures.Future()
        fut.set_result({"itemScores": [{"item": "i1", "score": 1.0}]})
        return fut


def test_traffic_lanes_offer_the_whole_schedule():
    """``_drive_lanes`` (the traffic process's body) offers every
    arrival of the scenario's mix, returns the acked ids and one
    ``[offset, seconds]`` per query; ``degrade`` forces the ratings it
    sends to 1.0, as the in-process lanes did."""
    import threading

    sc = port_scenario.Scenario.from_dict({
        "name": "lanes", "population": 200, "items": 40,
        "durationS": 0.6, "seed": 5, "baseRate": 200.0,
        "amplitude": 0.4,
        "mix": {"events": 0.6, "queries": 0.3, "feedback": 0.1},
        "maxOutstanding": 64})
    lanes = port_simulator._Lanes(sc)
    started = []
    for degraded in (False, True):
        client, degrade = _StubClient(), threading.Event()
        if degraded:
            degrade.set()
        out = port_simulator._drive_lanes(
            sc, client, degrade, 30.0, on_start=lambda: started.append(1))
        res = out["lanes"]
        assert res["events"]["offered"] == len(lanes.event_offsets)
        assert res["queries"]["offered"] == len(lanes.query_offsets) \
            == client.queries == len(out["query_times"])
        assert res["feedback"]["offered"] == len(lanes.feedback_offsets)
        assert all(r["acked"] == r["offered"] and not r["failed"]
                   for r in res.values())
        assert len(out["ledger"]) == res["events"]["acked"] \
            + res["feedback"]["acked"]
        assert all(len(q) == 2 and q[1] >= 0 for q in out["query_times"])
        assert out["active_users"] > 0
        assert len(client.ratings) == len(lanes.event_offsets)
        assert (set(client.ratings) == {1.0}) == degraded
    assert started == [1, 1]


def test_storm_children_load_neither_jax_nor_torch():
    """The storm's traffic process and the fleet's router process import
    neither the reference, nor torch, nor aiohttp: each answers within a
    second of its start."""
    import subprocess
    import sys

    code = (
        "import json, sys\n"
        "from predictionio_tpu_torch.loadtest.simulator import "
        "_traffic_main, _TrafficClient\n"
        "from predictionio_tpu_torch.loadtest.fleet import _router_main\n"
        "from predictionio_tpu_torch.obs.registry import MetricsRegistry\n"
        "from predictionio_tpu_torch.server.router import Router\n"
        "from predictionio_tpu_torch.utils.server_config import "
        "RouterConfig\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
        " in ('jax', 'torch', 'predictionio_tpu', 'aiohttp'))))\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=port_harness.child_env(), cwd="/",
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
