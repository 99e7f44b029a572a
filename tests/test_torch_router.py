"""The port's serving-fleet router (``server/router``, on ``server/http``
and ``server/http_client``) and autoscaler (``deploy/fleet``) against the
reference's router (on aiohttp) and controller, on the same inputs:

* ``WeightedSplitter`` routes the reference's sequence for the same
  weights and eligibility, and its state round-trips across packages;
* both routers run over the same stub replicas — a small HTTP/1.1
  server on stdlib asyncio that neither package owns — with the same
  queries: per-replica counts and statuses, the retry / eject /
  re-admit trajectory under a scripted failing replica, a 503 only when
  nothing is routable, the probe backoff schedule, a zero-drop drain, a
  sequenced deploy's abort and unwind (the same body and status 502),
  the forwarded trace id, and the ``pio_router_*`` series names and
  labels;
* the splitter's accumulators survive a router restart through the
  port's telemetry store;
* ``fleet.decide`` gives the reference's decisions over generated
  signal sequences, fleet documents are read by either package, a kill
  at each fleet kill point recovers to one applied scale-up as the
  reference's does, and the port's router grows and drains a fleet of
  stubs under load with zero failed queries.
"""

import asyncio
import json
import random
import time
import types
import urllib.parse

import aiohttp
import pytest
from aiohttp import web
from hypothesis import given, settings
from hypothesis import strategies as st

import predictionio_tpu.deploy.fleet as ref_fleet
import predictionio_tpu.server.router as ref_router
import predictionio_tpu.storage.faults as ref_faults
import predictionio_tpu.utils.server_config as ref_config
import predictionio_tpu_torch.deploy.fleet as port_fleet
import predictionio_tpu_torch.server.router as port_router
import predictionio_tpu_torch.storage.faults as port_faults
import predictionio_tpu_torch.utils.server_config as port_config
from predictionio_tpu.obs import registry as ref_registry
from predictionio_tpu.obs import trace_context as ref_trace
from predictionio_tpu_torch.obs import registry as port_registry
from predictionio_tpu_torch.obs import trace_context as port_trace

SIDES = {
    "ref": types.SimpleNamespace(router=ref_router, fleet=ref_fleet,
                                 faults=ref_faults, config=ref_config,
                                 registry=ref_registry, trace=ref_trace),
    "port": types.SimpleNamespace(router=port_router, fleet=port_fleet,
                                  faults=port_faults, config=port_config,
                                  registry=port_registry, trace=port_trace),
}
TRACE_HEADER = port_trace.TRACE_HEADER


@pytest.fixture(autouse=True)
def _clean_slate():
    for ns in SIDES.values():
        ns.trace.recorder().clear()
        ns.faults.set_kill_points([])
    yield
    for ns in SIDES.values():
        ns.faults.set_kill_points([])
        ns.trace.recorder().clear()


def _rcfg(ns, **kw):
    kw.setdefault("health_interval_s", 0.05)
    kw.setdefault("health_fail_after", 2)
    kw.setdefault("proxy_retries", 1)
    kw.setdefault("drain_timeout_s", 5.0)
    return ns.config.RouterConfig(**kw)


# ---------------------------------------------------------------------------
# stub replicas: HTTP/1.1 with keep-alive on stdlib asyncio
# ---------------------------------------------------------------------------

class StubReplica:
    """A controllable replica: the readiness surfaces a deployed query
    server exposes, plus switches for every failure the router must
    survive."""

    def __init__(self):
        self.breached = False
        self.fail_queries = False
        self.fail_probes = False
        self.fail_deploy = False
        self.hold_s = 0.0
        self.trace_headers = []
        self.deploys = []
        self.rollbacks = []
        self.served = 0
        self._server = None
        self._writers = set()

    async def start(self):
        self._server = await asyncio.start_server(self._conn, "127.0.0.1",
                                                  0)
        port = self._server.sockets[0].getsockname()[1]
        return f"http://127.0.0.1:{port}"

    async def _answer(self, method, path, headers, body):
        if path == "/queries.json" and method == "POST":
            self.trace_headers.append(headers.get(TRACE_HEADER.lower()))
            if self.fail_queries:
                return 500, {"message": "boom"}
            if self.hold_s:
                await asyncio.sleep(self.hold_s)
            self.served += 1
            return 200, {"itemScores": []}
        if path == "/slo.json":
            return (503, {}) if self.fail_probes else \
                (200, {"breached": self.breached})
        if path == "/deploy/status.json":
            return (503, {}) if self.fail_probes else \
                (200, {"active": {"releaseVersion": 1}})
        if path == "/deploy.json":
            self.deploys.append(json.loads(body or b"{}"))
            return (500, {"message": "bad"}) if self.fail_deploy else \
                (200, {"message": "Deployed"})
        if path == "/rollback.json":
            self.rollbacks.append(json.loads(body or b"{}"))
            return 200, {"message": "Rolled back"}
        return 404, {"message": "no route"}

    async def _conn(self, reader, writer):
        self._writers.add(writer)
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                method, target, _ = line.decode().split()
                headers = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode().partition(":")
                    headers[k.strip().lower()] = v.strip()
                n = int(headers.get("content-length") or 0)
                body = await reader.readexactly(n) if n else b""
                path = urllib.parse.urlsplit(target).path
                status, doc = await self._answer(method, path, headers, body)
                data = json.dumps(doc).encode()
                writer.write(
                    f"HTTP/1.1 {status} X\r\nContent-Type: application/json"
                    f"\r\nContent-Length: {len(data)}\r\n\r\n".encode()
                    + data)
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError, ValueError):
            pass
        finally:
            self._writers.discard(writer)
            writer.close()

    async def close(self):
        if self._server is not None:
            self._server.close()
            for w in list(self._writers):
                w.close()
            await self._server.wait_closed()
            self._server = None


async def _stubs(n):
    stubs = [StubReplica() for _ in range(n)]
    return stubs, [await s.start() for s in stubs]


class Running:
    """A started router of either package, driven over HTTP."""

    def __init__(self, side, router):
        self.side, self.router = side, router
        self.session = aiohttp.ClientSession()
        self._runner = None

    async def start(self):
        if self.side == "ref":
            self._runner = web.AppRunner(self.router.app)
            await self._runner.setup()
            site = web.TCPSite(self._runner, "127.0.0.1", 0)
            await site.start()
            port = site._server.sockets[0].getsockname()[1]
        else:
            port = await self.router.start("127.0.0.1", 0)
        self.base = f"http://127.0.0.1:{port}"
        for rank in list(self.router.replicas):
            assert await self.router.wait_replica_healthy(rank,
                                                          timeout_s=10)
        return self

    async def call(self, method, path, body=None, headers=None):
        async with self.session.request(method, self.base + path,
                                        json=body, headers=headers) as r:
            return r.status, await r.json()

    async def query(self, headers=None):
        return (await self.call("POST", "/queries.json", {"user": "u"},
                                headers))[0]

    async def close(self):
        await self.session.close()
        if self._runner is not None:
            await self._runner.cleanup()
        else:
            await self.router.close()


async def _wait_for(predicate, timeout_s=10.0, interval_s=0.01):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        await asyncio.sleep(interval_s)
    return predicate()


def _run(coro_fn):
    return asyncio.run(coro_fn())


def _both(scenario):
    """``scenario(side)`` on both packages over fresh stubs; returns
    (port's result, reference's result)."""
    return (_run(lambda: scenario("port")), _run(lambda: scenario("ref")))


def _counter(metric):
    return sorted((tuple(sorted(labels.items())), v)
                  for labels, v in metric.samples())


# ---------------------------------------------------------------------------
# WeightedSplitter
# ---------------------------------------------------------------------------

_weights = st.dictionaries(st.integers(0, 5),
                           st.sampled_from([0.0, 0.1, 0.5, 1.0, 2.0, 3.0]),
                           min_size=0, max_size=6)
_eligible = st.lists(st.one_of(st.none(), st.sets(st.integers(0, 5))),
                     min_size=1, max_size=60)


@settings(max_examples=150, deadline=None)
@given(weights=_weights, draws=_eligible, reweight=_weights)
def test_weighted_splitter_routes_like_reference(weights, draws, reweight):
    port = port_router.WeightedSplitter(weights)
    ref = ref_router.WeightedSplitter(weights)
    half = len(draws) // 2
    for eligible in draws[:half]:
        assert port.route(eligible) == ref.route(eligible)
    port.set_weights(reweight)
    ref.set_weights(reweight)
    for eligible in draws[half:]:
        assert port.route(eligible) == ref.route(eligible)
    assert port.state() == ref.state()
    # the state round-trips across the packages, junk rejected alike
    back = ref_router.WeightedSplitter(reweight)
    back.restore(port.state())
    fwd = port_router.WeightedSplitter(reweight)
    fwd.restore(ref.state())
    assert back.state() == fwd.state() == port.state()
    junk = {0: "x", 1: float("nan"), 2: 99.0, "y": 1.0, 3: -0.5}
    back.restore(junk)
    fwd.restore(junk)
    assert back.state() == fwd.state()
    assert [fwd.route() for _ in range(12)] == \
        [back.route() for _ in range(12)]


def test_weighted_splitter_window_exactness():
    s = port_router.WeightedSplitter({a: 1.0 for a in range(4)})
    counts = {a: 0 for a in range(4)}
    for n in range(1, 401):
        counts[s.route()] += 1
        assert all(abs(c - n / 4) <= 1 for c in counts.values())


# ---------------------------------------------------------------------------
# the routers over the same stubs
# ---------------------------------------------------------------------------

def test_spread_counts_and_status_match_reference():
    async def scenario(side):
        ns = SIDES[side]
        stubs, urls = await _stubs(3)
        run = await Running(side, ns.router.Router(
            _rcfg(ns), replica_urls=urls)).start()
        try:
            statuses = [await run.query() for _ in range(31)]
            _, fleet = await run.call("GET", "/fleet/status.json")
            _, root = await run.call("GET", "/")
            return (statuses, [s.served for s in stubs],
                    _counter(run.router._requests),
                    [{k: v for k, v in r.items() if k != "url"}
                     for r in fleet["replicas"]], fleet["splitter"],
                    fleet["config"], root["service"])
        finally:
            await run.close()
            for s in stubs:
                await s.close()

    port, ref = _both(scenario)
    assert port == ref
    assert sorted(port[1]) == [10, 10, 11] and set(port[0]) == {200}


def test_retry_eject_readmit_trajectory_matches_reference():
    """Replica 0 breaks (queries 500, probes 503): every query still
    answers 200 through the sibling, replica 0 is ejected after
    ``health_fail_after`` proxy failures, and re-admitted by its first
    healthy probe. The health loop is idle (a long interval) so the
    trajectory is the queries' own."""
    async def scenario(side):
        ns = SIDES[side]
        stubs, urls = await _stubs(2)
        run = await Running(side, ns.router.Router(
            _rcfg(ns, health_interval_s=60.0, health_backoff_cap_s=60.0),
            replica_urls=urls)).start()
        r = run.router
        try:
            stubs[0].fail_queries = stubs[0].fail_probes = True
            steps = []
            for _ in range(8):
                status = await run.query()
                steps.append((status, r.replicas[0].healthy,
                              r.replicas[0].fails,
                              [s.served for s in stubs]))
            failed = (_counter(r._retries), _counter(r._dropped),
                      _counter(r._requests), _counter(r._healthy_g))
            # a probe of the still-broken replica fails and backs off
            assert not await r._probe(r.replicas[0])
            stubs[0].fail_queries = stubs[0].fail_probes = False
            assert await r.wait_replica_healthy(0, timeout_s=5)
            readmitted = (r.replicas[0].healthy, r.replicas[0].fails,
                          r.replicas[0].next_probe_at)
            after = [await run.query() for _ in range(4)]
            return (steps, failed, readmitted, after,
                    [s.served for s in stubs],
                    _counter(r._health_total))
        finally:
            await run.close()
            for s in stubs:
                await s.close()

    port, ref = _both(scenario)
    assert port == ref
    steps, failed, readmitted, after, served, _ = port
    assert {s[0] for s in steps} == {200} and set(after) == {200}
    assert steps[-1][1] is False and readmitted == (True, 0, 0.0)
    assert served[0] == 2          # the re-admitted replica serves again


def test_503_only_when_nothing_routable():
    async def scenario(side):
        ns = SIDES[side]
        stubs, urls = await _stubs(2)
        run = await Running(side, ns.router.Router(
            _rcfg(ns, health_interval_s=60.0),
            replica_urls=urls)).start()
        try:
            before = await run.query()
            stubs[0].fail_queries = stubs[1].fail_queries = True
            status, body = await run.call("POST", "/queries.json", {})
            return (before, status, body["message"].split(":")[0],
                    _counter(run.router._dropped),
                    _counter(run.router._requests))
        finally:
            await run.close()
            for s in stubs:
                await s.close()

    port, ref = _both(scenario)
    assert port == ref
    assert port[:3] == (200, 503, "no replica could serve the query")


def test_probe_backoff_schedule_matches_reference():
    """A dead replica's probes back off at interval, 2x, 4x ... up to
    the cap; the first healthy probe resets the schedule."""
    async def scenario(side):
        ns = SIDES[side]
        stubs, urls = await _stubs(2)
        run = await Running(side, ns.router.Router(
            _rcfg(ns, health_interval_s=60.0, health_backoff_cap_s=500.0,
                  health_fail_after=3),
            replica_urls=urls)).start()
        h = run.router.replicas[0]
        try:
            stubs[0].fail_probes = True
            gaps = []
            for _ in range(6):
                now = time.monotonic()
                await run.router._probe(h)
                gaps.append((round(h.next_probe_at - now, -1), h.fails,
                             h.healthy))
            await stubs[0].close()          # the port is gone now
            now = time.monotonic()
            await run.router._probe(h)
            gaps.append((round(h.next_probe_at - now, -1), h.fails,
                         h.healthy))
            return gaps, run.router.replicas[1].next_probe_at
        finally:
            await run.close()
            for s in stubs:
                await s.close()

    port, ref = _both(scenario)
    assert port == ref
    gaps, sibling = port
    assert [g[0] for g in gaps] == [60, 120, 240, 480, 500, 500, 500]
    assert [g[2] for g in gaps] == [True, True, False, False, False,
                                    False, False]
    assert sibling == 0.0


def test_drain_is_zero_drop_like_reference():
    async def scenario(side):
        ns = SIDES[side]
        stubs, urls = await _stubs(2)
        for s in stubs:
            s.hold_s = 0.3
        run = await Running(side, ns.router.Router(
            _rcfg(ns), replica_urls=urls)).start()
        try:
            tasks = [asyncio.ensure_future(run.query()) for _ in range(2)]
            assert await _wait_for(
                lambda: run.router.replicas[1].inflight > 0, timeout_s=2.0)
            drained = await run.router.drain(1)
            statuses = [await t for t in tasks]
            for s in stubs:
                s.hold_s = 0.0
            after = await run.query()
            return (drained, statuses, sorted(run.router.replicas), after,
                    _counter(run.router._dropped),
                    run.router.active_count())
        finally:
            await run.close()
            for s in stubs:
                await s.close()

    port, ref = _both(scenario)
    assert port == ref
    assert port[:4] == (True, [200, 200], [0], 200)


def test_sequenced_deploy_aborts_and_unwinds_like_reference():
    async def scenario(side):
        ns = SIDES[side]
        stubs, urls = await _stubs(3)
        stubs[1].fail_deploy = True
        run = await Running(side, ns.router.Router(
            _rcfg(ns), replica_urls=urls)).start()
        try:
            aborted = await run.call("POST", "/deploy.json?accessKey=k",
                                     {"version": "2"})
            calls = [(len(s.deploys), len(s.rollbacks)) for s in stubs]
            cutovers = [e for e in ns.trace.recorder().events()
                        if e["kind"] == "router_cutover"]
            stubs[1].fail_deploy = False
            full = await run.call("POST", "/deploy.json", {"version": "2"})
            back = await run.call("POST", "/rollback.json", {})
            return (aborted, calls, [(e["outcome"], e.get("unwound"))
                                     for e in cutovers], full, back,
                    [(len(s.deploys), len(s.rollbacks)) for s in stubs],
                    stubs[0].deploys[0], _counter(run.router._deploys))
        finally:
            await run.close()
            for s in stubs:
                await s.close()

    port, ref = _both(scenario)
    assert port == ref
    (status, body), calls = port[0], port[1]
    assert status == 502
    assert set(body) == {"action", "aborted", "failedReplica", "results",
                         "unwound"}
    assert body["aborted"] is True and body["failedReplica"] == 1
    assert body["unwound"] == [0]
    assert calls == [(1, 1), (1, 0), (0, 0)]
    assert port[3][0] == 200 and \
        [r["replica"] for r in port[3][1]["results"]] == [0, 1, 2]


def test_forwarded_trace_id_matches_reference():
    async def scenario(side):
        ns = SIDES[side]
        stubs, urls = await _stubs(1)
        run = await Running(side, ns.router.Router(
            _rcfg(ns), replica_urls=urls)).start()
        try:
            ctx = ns.trace.TraceContext.root()
            await run.query({TRACE_HEADER: ctx.encode()})
            fwd = ns.trace.TraceContext.decode(stubs[0].trace_headers[-1])
            await run.query()
            fresh = ns.trace.TraceContext.decode(
                stubs[0].trace_headers[-1])
            routed = [t for t in ns.trace.recorder().traces(ctx.trace_id)]
            return (fwd.trace_id == ctx.trace_id,
                    fresh is not None and fresh.trace_id != ctx.trace_id,
                    [t["name"] for t in routed])
        finally:
            await run.close()
            for s in stubs:
                await s.close()

    port, ref = _both(scenario)
    assert port == ref == (True, True, ["router POST /queries.json"])


def test_router_series_names_and_labels_match_reference():
    async def scenario(side):
        ns = SIDES[side]
        stubs, urls = await _stubs(2)
        run = await Running(side, ns.router.Router(
            _rcfg(ns), replica_urls=urls)).start()
        try:
            for _ in range(4):
                await run.query()
            await run.call("POST", "/deploy.json", {})
            series = {name: (m["kind"], tuple(m["labelnames"]))
                      for name, m in run.router.registry.to_snapshot()
                      .items() if name.startswith("pio_router_")}
            async with run.session.get(run.base + "/metrics") as r:
                text = await r.text()
            names = sorted({line.split("{")[0].split(" ")[0]
                            for line in text.splitlines()
                            if line.startswith("pio_router_")})
            return series, names
        finally:
            await run.close()
            for s in stubs:
                await s.close()

    port, ref = _both(scenario)
    assert port == ref
    assert set(port[0]) == {
        "pio_router_requests_total", "pio_router_proxy_duration_seconds",
        "pio_router_retries_total", "pio_router_dropped_total",
        "pio_router_replica_healthy", "pio_router_replicas",
        "pio_router_splitter_acc", "pio_router_health_checks_total",
        "pio_router_deploys_total"}


def test_splitter_state_survives_router_restart(tmp_path):
    """The accumulators publish through the port's telemetry store, and
    a NEW router over the same store resumes the exact mid-stream split
    (the reference's splitter resumed from the same snapshot routes the
    same way)."""
    from predictionio_tpu_torch.obs.telemetry import TelemetryRecorder

    tcfg = port_config.TelemetryConfig(dir=str(tmp_path / "telemetry"),
                                       interval_s=60.0)

    async def main():
        stubs, urls = await _stubs(3)
        try:
            reg1 = port_registry.MetricsRegistry()
            run1 = await Running("port", port_router.Router(
                _rcfg(SIDES["port"]), registry=reg1,
                telemetry=TelemetryRecorder("router", tcfg,
                                            registries=[reg1]),
                replica_urls=urls)).start()
            for _ in range(7):
                assert await run1.query() == 200
            saved = run1.router.splitter.state()
            phase1 = [s.served for s in stubs]
            reference = ref_router.WeightedSplitter({0: 1.0, 1: 1.0,
                                                     2: 1.0})
            reference.restore(saved)
            await run1.close()          # the close drains a final scrape
            reg2 = port_registry.MetricsRegistry()
            run2 = await Running("port", port_router.Router(
                _rcfg(SIDES["port"]), registry=reg2,
                telemetry=TelemetryRecorder("router", tcfg,
                                            registries=[reg2]),
                replica_urls=urls)).start()
            try:
                assert run2.router.splitter.state() == \
                    pytest.approx(saved)
                for _ in range(23):
                    assert await run2.query() == 200
                expected = {a: 0 for a in range(3)}
                for _ in range(23):
                    expected[reference.route()] += 1
                for rank, stub in enumerate(stubs):
                    assert abs(stub.served - 10) <= 1
                    assert stub.served - phase1[rank] == expected[rank]
            finally:
                await run2.close()
        finally:
            for s in stubs:
                await s.close()

    _run(main)


# ---------------------------------------------------------------------------
# the fleet controller
# ---------------------------------------------------------------------------

def _fcfg(ns, **kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("burn_sustain_s", 10.0)
    kw.setdefault("idle_qps", 0.5)
    kw.setdefault("idle_sustain_s", 60.0)
    kw.setdefault("cooldown_s", 30.0)
    return ns.config.FleetConfig(**kw)


@pytest.mark.parametrize("seed", range(5))
def test_decide_matches_reference_over_signal_sequences(seed):
    rng = random.Random(seed)
    kw = dict(min_replicas=rng.choice([1, 2]),
              max_replicas=rng.choice([2, 3, 4]),
              burn_sustain_s=rng.choice([0.0, 5.0, 10.0]),
              idle_qps=rng.choice([0.0, 0.5, 5.0]),
              idle_sustain_s=rng.choice([0.0, 20.0, 60.0]),
              cooldown_s=rng.choice([0.0, 30.0]))
    cfgs = {n: _fcfg(ns, **kw) for n, ns in SIDES.items()}
    states = {n: ns.fleet.FleetState() for n, ns in SIDES.items()}
    now, replicas = 0, 2
    for _ in range(400):
        now += rng.choice([0, 500, 1000, 4000, 15_000])
        sig = dict(burning=rng.random() < 0.4,
                   qps=rng.choice([0.0, 0.2, 3.0, 50.0]),
                   healthy=replicas)
        out = {n: ns.fleet.decide(cfgs[n], states[n],
                                  ns.fleet.FleetSignals(**sig), now,
                                  replicas)
               for n, ns in SIDES.items()}
        assert out["port"] == out["ref"]
        assert states["port"].to_json() == states["ref"].to_json()
        action = out["port"][0]
        if action is not None:
            replicas += 1 if action == "scale_up" else -1
            for n, st_ in states.items():
                st_.burn_since_ms = st_.idle_since_ms = 0
                st_.cooldown_until_ms = now + int(kw["cooldown_s"] * 1000)


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_fleet_documents_cross_read(tmp_path, writer, reader):
    w, r = SIDES[writer].fleet, SIDES[reader].fleet
    store = w.FleetStore(str(tmp_path))
    store.commit_state(w.FleetState(burn_since_ms=5, cooldown_until_ms=9,
                                    last_action="scale_up",
                                    last_outcome="done"))
    doc = w.FleetDoc(action_id="a1", action="scale_down", trace="t:s",
                     reason="idle", from_replicas=3, to_replicas=2,
                     phase_status="running", started_ms=1, updated_ms=2)
    store.commit_action(doc)
    other = r.FleetStore(str(tmp_path))
    assert other.load_state().to_json() == store.load_state().to_json()
    assert other.load_action().to_json() == doc.to_json()
    doc.outcome = "done"
    other.archive_action(r.FleetDoc.from_json(doc.to_json()))
    assert store.load_action() is None
    with open(tmp_path / "history" / "a1.json") as f:
        assert json.load(f)["outcome"] == "done"


class FakeActuator:
    def __init__(self, replicas=1, fail=False):
        self.replicas, self.fail = replicas, fail
        self.ups = self.downs = 0

    def count(self):
        return self.replicas

    def scale_up(self):
        if self.fail:
            raise RuntimeError("spawn blew up")
        self.replicas += 1
        self.ups += 1
        return self.replicas - 1

    def scale_down(self):
        self.replicas -= 1
        self.downs += 1
        return True


def _controller(ns, tmp_path, actuator, clock):
    return ns.fleet.FleetController(
        _fcfg(ns), actuator=actuator,
        state_dir=str(tmp_path / f"fleet-{id(ns)}"),
        registry=ns.registry.MetricsRegistry(), clock_ms=clock)


#: the fleet's kill points on a scale-up's path
FLEET_POINTS = [("fleet:action:created", 1), ("fleet:scale_up:enter", 1),
                ("fleet:scale_up:done", 0), ("fleet:scale_up:committed", 0)]


@pytest.mark.parametrize("point,expect_ups", FLEET_POINTS)
def test_fleet_kill_points_recover_like_reference(tmp_path, point,
                                                  expect_ups):
    def scenario(ns):
        clock = {"ms": 0}
        act = FakeActuator(replicas=1)
        ctl = _controller(ns, tmp_path, act, lambda: clock["ms"])
        burn = ns.fleet.FleetSignals(burning=True, qps=9.0, healthy=1)
        ctl.tick(burn)
        clock["ms"] = 11_000
        ns.faults.set_kill_points([point])
        with pytest.raises(ns.faults.CrashError):
            ctl.tick(burn)
        ns.faults.set_kill_points([])
        pending = ctl.store.load_action()
        assert pending is not None and pending.outcome == ""
        act2 = FakeActuator(replicas=act.replicas)
        ctl2 = _controller(ns, tmp_path, act2, lambda: clock["ms"])
        out = ctl2.recover()
        state = ctl2.store.load_state()
        return (out, act2.ups, act2.replicas, ctl2.store.load_action(),
                state.last_outcome, state.cooldown_until_ms,
                ctl2.tick(burn), _counter(ctl2._actions_total))

    got, want = scenario(SIDES["port"]), scenario(SIDES["ref"])
    assert got == want
    assert got[1] == expect_ups and got[2] == 2 and got[3] is None


def test_fleet_scale_actions_commit_like_reference(tmp_path):
    def scenario(ns, fail):
        clock = {"ms": 0}
        act = FakeActuator(replicas=1, fail=fail)
        ctl = _controller(ns, tmp_path / str(fail), act,
                          lambda: clock["ms"])
        burn = ns.fleet.FleetSignals(burning=True, qps=9.0, healthy=1)
        first = ctl.tick(burn)
        clock["ms"] = 11_000
        doc = ctl.tick(burn)
        events = [(e["status"], e["traceId"] == doc.trace.split(":")[0])
                  for e in ns.trace.recorder().events()
                  if e["kind"] == "fleet_scale"
                  and e.get("actionId") == doc.action_id]
        clock["ms"] = 20_000
        cooled = ctl.tick(burn)
        status = ctl.status()
        return (first, doc.outcome, doc.detail, doc.from_replicas,
                doc.to_replicas, act.replicas, ctl.store.load_action(),
                ctl.store.load_state().to_json(), events, cooled,
                {k: v for k, v in status.items() if k != "state"})

    for fail in (False, True):
        assert scenario(SIDES["port"], fail) == scenario(SIDES["ref"], fail)


def test_port_router_autoscale_e2e_zero_drops(tmp_path):
    """Load grows the fleet 1 -> 2 on a sustained burn, idleness drains
    it back 2 -> 1, with traffic through both transitions: zero failed
    queries, both actions archived, one trace id per action."""
    async def main():
        stubs, urls = await _stubs(2)
        fleet = port_fleet.FleetController(
            port_config.FleetConfig(min_replicas=1, max_replicas=2,
                                    burn_sustain_s=0.15,
                                    idle_qps=10_000.0,
                                    idle_sustain_s=0.15, cooldown_s=0.3),
            state_dir=str(tmp_path / "fleet"))
        router = port_router.Router(
            _rcfg(SIDES["port"], replicas=1),
            spawn=lambda rank: urls[rank], stop=lambda h: None,
            fleet=fleet, replica_urls=urls[:1])
        run = await Running("port", router).start()
        statuses, stop = [], asyncio.Event()

        async def load():
            while not stop.is_set():
                try:
                    statuses.append(await run.query())
                except Exception as e:    # a dropped connection IS a drop
                    statuses.append(repr(e))
                await asyncio.sleep(0.005)

        task = asyncio.ensure_future(load())
        try:
            stubs[0].breached = True
            assert await _wait_for(lambda: router.active_count() == 2,
                                   timeout_s=15.0), fleet.status()
            stubs[0].breached = False
            assert await _wait_for(lambda: router.active_count() == 1,
                                   timeout_s=15.0), fleet.status()
            history = tmp_path / "fleet" / "history"
            assert await _wait_for(
                lambda: len(list(history.glob("*.json"))) == 2,
                timeout_s=10.0)
            # this test's actions only (the recorder is process-wide);
            # the tick's thread archives an action BEFORE it records
            # the action's last event, so wait for that event too
            ids = {json.loads(p.read_text())["action_id"]
                   for p in history.glob("*.json")}

            def scale_events():
                by_action = {}
                for e in port_trace.recorder().events():
                    if e["kind"] == "fleet_scale" \
                            and e.get("actionId") in ids:
                        by_action.setdefault(e["actionId"], []).append(e)
                return by_action

            assert await _wait_for(
                lambda: sum(len(es) for es in scale_events().values()) == 4,
                timeout_s=10.0), scale_events()
            stop.set()
            await task
            assert statuses and set(statuses) == {200}
            assert sum(v for _, v in router._dropped.samples()) == 0
            by_action = scale_events()
            outcomes = {es[0]["action"]: [e["status"] for e in es]
                        for es in by_action.values()}
            assert outcomes == {"scale_up": ["start", "done"],
                                "scale_down": ["start", "done"]}
            for es in by_action.values():
                assert len({e["traceId"] for e in es}) == 1
            _, doc = await run.call("GET", "/fleet/status.json")
            assert doc["autoscaler"]["state"]["last_action"] == "scale_down"
        finally:
            stop.set()
            if not task.done():
                await task
            await run.close()
            for s in stubs:
                await s.close()

    _run(main)


def test_http_client_pools_and_recovers_stale_connections():
    """The router's client keeps one keep-alive connection per origin
    across requests, and a pooled connection the peer dropped is
    replaced without failing the request."""
    from predictionio_tpu_torch.server.http_client import HttpClient

    async def main():
        stub = StubReplica()
        url = await stub.start()
        client = HttpClient()
        try:
            for _ in range(5):
                resp = await client.request("POST", url + "/queries.json",
                                            json_body={})
                assert resp.status == 200 and resp.json() == {
                    "itemScores": []}
            assert len(stub._writers) == 1
            for w in list(stub._writers):
                w.close()               # the peer drops the idle socket
            await asyncio.sleep(0.05)
            resp = await client.request("GET", url + "/slo.json")
            assert resp.status == 200 and stub.served == 5
            with pytest.raises(asyncio.TimeoutError):
                stub.hold_s = 1.0
                await client.request("POST", url + "/queries.json",
                                     timeout=0.1)
        finally:
            await client.close()
            await stub.close()

    _run(main)
