"""The port's retry loop, fault injector, release kill points and the
workflows' trace adoption, against the reference on the same inputs:

* ``RetryPolicy.delay_s`` draws the reference's full-jitter delays for
  the same ``random.Random`` seed;
* ``retry_call`` / ``retry_call_async`` keep the reference's semantics
  (attempt counts, backoff sleeps, ``retry_on``, per-attempt timeouts),
  and a ``CrashError`` is never retried;
* ``FaultyEvents`` fires the reference's sequence of faults for the
  same seed, and the env gate wraps the port's event store;
* the four release-registry kill points fire once each and leave the
  registry as the reference's leave it;
* ``run_train`` and ``run_evaluation`` adopt ``PIO_TRACE_CONTEXT``, and
  a kill inside the sweep marks the instance EVALFAILED and re-raises.
"""

import asyncio
import random
import threading
import time

import pytest

import predictionio_tpu.deploy.releases as ref_releases
import predictionio_tpu.storage.faults as ref_faults
import predictionio_tpu.utils.retry as ref_retry
import predictionio_tpu_torch.deploy.releases as port_releases
import predictionio_tpu_torch.storage.faults as port_faults
import predictionio_tpu_torch.utils.retry as port_retry
from predictionio_tpu.storage import Storage as RefStorage
from predictionio_tpu.storage.base import (
    EngineInstance as RefEngineInstance,
)
from predictionio_tpu_torch.storage.base import EngineInstance
from predictionio_tpu_torch.storage.registry import Storage

SIDES = {"ref": (ref_retry, ref_faults), "port": (port_retry, port_faults)}


def _config(path):
    return {"sources": {"DB": {"TYPE": "sqlite", "PATH": str(path)}},
            "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                             for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}}


@pytest.fixture(autouse=True)
def _disarmed():
    for _, faults in SIDES.values():
        faults.set_kill_points([])
    yield
    for _, faults in SIDES.values():
        faults.set_kill_points([])


# ---------------------------------------------------------------------------
# RetryPolicy / retry_call / retry_call_async
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("retries,backoff,cap,seed", [
    (6, 0.1, 1.0, 7), (4, 0.05, 1.0, 0), (8, 10.0, 0.25, 1),
    (3, 0.0, 1.0, 3), (10, 0.5, 30.0, 42)])
def test_delay_s_draws_the_reference_jitter(retries, backoff, cap, seed):
    port = port_retry.RetryPolicy(retries=retries, backoff_s=backoff,
                                  backoff_cap_s=cap)
    ref = ref_retry.RetryPolicy(retries=retries, backoff_s=backoff,
                                backoff_cap_s=cap)
    rp, rr = random.Random(seed), random.Random(seed)
    got = [port.delay_s(a, rp) for a in range(12) for _ in range(5)]
    want = [ref.delay_s(a, rr) for a in range(12) for _ in range(5)]
    assert got == want
    assert port.attempts() == ref.attempts()
    for a in range(12):
        assert 0.0 <= port.delay_s(a, rp) <= min(cap, backoff * 2 ** a)


def _scenario(side, kind):
    """One retry scenario on one package: (outcome, calls, sleeps,
    retry hook log)."""
    retry, faults = SIDES[side]
    calls, sleeps, hooks = [], [], []
    policy = retry.RetryPolicy(retries=3, backoff_s=0.01, backoff_cap_s=1.0)

    def fn():
        calls.append(1)
        n = len(calls)
        if kind == "transient" and n < 3:
            raise ValueError(f"transient {n}")
        if kind == "exhaust":
            raise ValueError(f"boom {n}")
        if kind == "not_listed":
            raise KeyError("nope")
        if kind == "crash":
            raise faults.CrashError("injected kill")
        return "ok"

    try:
        out = retry.retry_call(
            fn, policy=policy, retry_on=(ValueError,),
            on_retry=lambda i, e: hooks.append((i, str(e))),
            sleep=sleeps.append, rng=random.Random(5))
    except BaseException as e:      # noqa: BLE001 — the outcome compared
        out = f"{type(e).__name__}: {e}"
    return out, len(calls), sleeps, hooks


@pytest.mark.parametrize("kind", ["transient", "exhaust", "not_listed",
                                  "crash", "ok"])
def test_retry_call_matches_reference(kind):
    port = _scenario("port", kind)
    assert port == _scenario("ref", kind)
    if kind == "crash":
        # the kill propagates on the FIRST attempt: never retried
        assert port[1] == 1 and port[0].startswith("CrashError")


@pytest.mark.parametrize("side", ["ref", "port"])
def test_retry_call_timeout_abandons_and_raises(side):
    retry, faults = SIDES[side]
    release = threading.Event()
    started = []

    def hangs():
        started.append(time.monotonic())
        release.wait(5.0)

    policy = retry.RetryPolicy(retries=1, backoff_s=0.0, timeout_s=0.05)
    t0 = time.monotonic()
    with pytest.raises(retry.RetryTimeout):
        retry.retry_call(hangs, policy=policy, sleep=lambda s: None)
    release.set()
    assert len(started) == 2 and time.monotonic() - t0 < 2.0

    # a kill inside a timed attempt is relayed, not retried
    calls = []

    def killed():
        calls.append(1)
        raise faults.CrashError("kill on the attempt thread")

    with pytest.raises(faults.CrashError):
        retry.retry_call(killed, policy=retry.RetryPolicy(
            retries=3, backoff_s=0.0, timeout_s=1.0), sleep=lambda s: None)
    assert calls == [1]


def _async_scenario(side, kind):
    retry, faults = SIDES[side]
    calls, hooks = [], []

    async def fn():
        calls.append(1)
        if kind == "transient" and len(calls) < 3:
            raise ValueError("transient")
        if kind == "hang":
            await asyncio.sleep(5.0)
        if kind == "crash":
            raise faults.CrashError("kill")
        return "ok"

    policy = retry.RetryPolicy(retries=2, backoff_s=0.0,
                               timeout_s=0.05 if kind == "hang" else None)

    async def main():
        try:
            return await retry.retry_call_async(
                fn, policy=policy,
                on_retry=lambda i, e: hooks.append(type(e).__name__),
                rng=random.Random(1))
        except BaseException as e:     # noqa: BLE001 — compared
            return type(e).__name__

    return asyncio.run(main()), len(calls), hooks


@pytest.mark.parametrize("kind", ["transient", "hang", "crash", "ok"])
def test_retry_call_async_matches_reference(kind):
    got = _async_scenario("port", kind)
    assert got == _async_scenario("ref", kind)
    if kind == "hang":
        assert got == ("RetryTimeout", 3, ["RetryTimeout"] * 2)
    if kind == "crash":
        assert got[:2] == ("CrashError", 1)


# ---------------------------------------------------------------------------
# FaultyEvents and the env gate
# ---------------------------------------------------------------------------

class _Inner:
    def __init__(self):
        self.writes = []

    def insert(self, x):
        self.writes.append(x)
        return x

    def find(self):
        return list(self.writes)


def _fault_trace(faults, **kw):
    inner = _Inner()
    wrapped = faults.FaultyEvents(inner, **kw)
    trace = []
    for i in range(120):
        for call in (lambda: wrapped.insert(i), wrapped.find):
            try:
                call()
                trace.append("ok")
            except Exception as e:     # noqa: BLE001 — the fault compared
                trace.append(type(e).__name__)
    return trace, inner.writes, wrapped.faults_fired


@pytest.mark.parametrize("kw", [
    dict(error_rate=0.3, seed=11),
    dict(error_rate=0.5, seed=2, when="after"),
    dict(fail_n=4, error_rate=0.1, seed=9),
    dict(fail_n=3, when="after", ops=("insert",)),
    dict(error_rate=0.9, seed=3, ops=("find",))])
def test_faulty_events_fires_the_reference_sequence(kw):
    got = _fault_trace(port_faults, **kw)
    want = _fault_trace(ref_faults, **kw)
    assert got == want
    assert got[2] == sum(1 for t in got[0] if t != "ok")
    if kw.get("when") == "after" or "insert" not in kw.get(
            "ops", ("insert",)):
        # the ambiguous failure: the write landed, then the fault fired
        assert len(got[1]) == 120


def test_faulty_events_from_env_and_registry_gate(tmp_path, monkeypatch):
    env = {"PIO_FAULT_FAIL_N": "2", "PIO_FAULT_WHEN": "after",
           "PIO_FAULT_OPS": "insert_batch, insert", "PIO_FAULT_SEED": "4",
           "PIO_FAULT_ERROR_RATE": "0.25", "PIO_FAULT_LATENCY_S": ""}
    port = port_faults.FaultyEvents.from_env(_Inner(), env)
    ref = ref_faults.FaultyEvents.from_env(_Inner(), env)
    fields = ("_error_rate", "_latency_s", "_when", "_ops",
              "_fail_remaining")
    assert [getattr(port, f) for f in fields] == \
        [getattr(ref, f) for f in fields]
    assert port._rng.random() == ref._rng.random()
    for e in ({}, {"PIO_FAULT_LATENCY_S": "0.1"}, {"PIO_FAULT_KILL": "x"},
              {"PIO_FAULT_FAIL_N": "0"}, {"PIO_FAULT_ERROR_RATE": "0.2"}):
        assert port_faults.env_enabled(e) == ref_faults.env_enabled(e)

    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.storage.base import StorageError

    monkeypatch.setenv("PIO_FAULT_FAIL_N", "1")
    Storage.reset()
    Storage.configure(_config(tmp_path / "f.db"))
    try:
        events = Storage.get_events()
        assert isinstance(events, port_faults.FaultyEvents)
        events.init_channel(1)          # not a faulted op: delegated
        ev = [Event(event="rate", entity_type="user", entity_id="u0")]
        with pytest.raises(StorageError, match="injected fault"):
            events.insert_batch(ev, 1)
        events.insert_batch(ev, 1)      # fail-N spent: the write lands
        assert len(list(events.find(1))) == 1
        assert events.snapshot_digest(1).startswith("rowid:")
    finally:
        Storage.reset()
    monkeypatch.delenv("PIO_FAULT_FAIL_N")
    Storage.configure(_config(tmp_path / "g.db"))
    try:
        assert not isinstance(Storage.get_events(),
                              port_faults.FaultyEvents)
    finally:
        Storage.reset()


def test_kill_points_seed_from_env(monkeypatch):
    monkeypatch.setenv("PIO_FAULT_KILL", " a:b , c:d ,")
    for _, faults in SIDES.values():
        faults._kill_points = None
        assert faults.armed_kill_points() == {"a:b", "c:d"}
        with pytest.raises(faults.CrashError):
            faults.maybe_kill("c:d")
        faults.maybe_kill("c:d")        # fires once
        assert faults.armed_kill_points() == {"a:b"}


# ---------------------------------------------------------------------------
# the four release kill points
# ---------------------------------------------------------------------------

RELEASE_POINTS = ("releases:insert:pre", "releases:insert:committed",
                  "releases:set-status:pre", "releases:set-status:committed")


def _release_kill_run(side, point, tmp_path):
    """Register v1, kill at ``point`` once (registering v2 or moving v1
    LIVE), then run the same step again: (raised, statuses after the
    kill, statuses after the rerun)."""
    if side == "port":
        storage, inst_cls, releases = Storage, EngineInstance, port_releases
        faults = port_faults
    else:
        storage, inst_cls, releases = (RefStorage, RefEngineInstance,
                                       ref_releases)
        faults = ref_faults
    storage.reset()
    storage.configure(_config(tmp_path / f"{side}.db"))
    try:
        def instance(n):
            inst = inst_cls(id=f"i{n}", status="COMPLETED", engine_id="e",
                            engine_version="1", engine_variant="default")
            storage.get_meta_data_engine_instances().insert(inst)
            return inst

        rels = storage.get_meta_data_releases()
        v1 = releases.record_release(instance(1), 0.1, b"m1")
        i2 = instance(2)

        def step():
            if point.startswith("releases:insert"):
                return releases.record_release(i2, 0.1, b"m2")
            return rels.set_status(v1.id, "LIVE", "promote")

        def statuses():
            return sorted((r.version, r.status, len(r.history))
                          for r in rels.get_all())

        faults.set_kill_points([point])
        raised = False
        try:
            step()
        except faults.CrashError:
            raised = True
        after_kill = statuses()
        step()
        return raised, after_kill, statuses()
    finally:
        faults.set_kill_points([])
        storage.reset()


@pytest.mark.parametrize("point", RELEASE_POINTS)
def test_release_kill_points_fire_once_like_the_reference(point, tmp_path):
    got = _release_kill_run("port", point, tmp_path)
    assert got == _release_kill_run("ref", point, tmp_path)
    raised, after_kill, after = got
    assert raised
    committed = point.endswith("committed")
    if point.startswith("releases:insert"):
        # pre: no manifest yet; committed: the manifest landed
        assert len(after_kill) == (2 if committed else 1)
    else:
        assert after_kill[0][1] == ("LIVE" if committed else "REGISTERED")
    # the point fired once: the rerun goes through
    assert ("LIVE" in {s for _, s, _ in after}) or len(after) >= 2


# ---------------------------------------------------------------------------
# trace adoption in train and eval
# ---------------------------------------------------------------------------

@pytest.fixture()
def rated_store(tmp_path):
    from predictionio_tpu_torch.data import eventstore
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.storage.base import App

    Storage.reset()
    eventstore.clear_cache()
    Storage.configure(_config(tmp_path / "t.db"))
    app_id = Storage.get_meta_data_apps().insert(App(id=0, name="Adopt"))
    Storage.get_events().init_channel(app_id)
    rng = random.Random(3)
    Storage.get_events().insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{rng.randrange(8)}",
              target_entity_type="item",
              target_entity_id=f"i{rng.randrange(10)}",
              properties={"rating": float(rng.randrange(1, 6))})
        for _ in range(80)], app_id)
    yield "Adopt"
    Storage.reset()
    eventstore.clear_cache()


def test_train_and_eval_adopt_the_parent_trace(rated_store, monkeypatch):
    from predictionio_tpu_torch.core.evaluation import (
        Evaluation, MetricEvaluatorResult,
    )
    from predictionio_tpu_torch.core.params import EngineParams
    from predictionio_tpu_torch.engines.recommendation import (
        default_engine_params, engine,
    )
    from predictionio_tpu_torch.obs.trace_context import (
        TRACE_ENV, TraceContext, recorder,
    )
    from predictionio_tpu_torch.workflow.evaluate import run_evaluation
    from predictionio_tpu_torch.workflow.train import run_train

    parent = TraceContext.root()
    monkeypatch.setenv(TRACE_ENV, parent.encode())
    recorder().clear()
    instance, _ = run_train(engine(), default_engine_params(
        rated_store, rank=3, num_iterations=2), device="cpu")
    train = [t for t in recorder().traces() if t["name"] == "train"]
    assert train and train[-1]["traceId"] == parent.trace_id
    assert train[-1]["parentSpanId"] == parent.span_id
    assert train[-1]["attrs"]["instance"] == instance.id
    done = [e for e in recorder().events() if e["kind"] == "train_completed"]
    assert done and done[-1]["traceId"] == parent.trace_id

    class OneScore(Evaluation):
        def run(self, ctx, params_list):
            return MetricEvaluatorResult(
                best_score=0.5, best_engine_params=params_list[0],
                best_idx=0, metric_header="m", other_metric_headers=[],
                engine_params_scores=[(params_list[0], 0.5, [])])

    run_evaluation(OneScore(), [EngineParams()], device="cpu")
    ev = [t for t in recorder().traces() if t["name"] == "evaluate"]
    assert ev and ev[-1]["traceId"] == parent.trace_id
    done = [e for e in recorder().events() if e["kind"] == "eval_completed"]
    assert done and done[-1]["traceId"] == parent.trace_id


def test_run_evaluation_marks_evalfailed_on_kill(rated_store):
    """A kill inside the sweep leaves the instance EVALFAILED (never
    stuck INIT) and propagates, as the reference's does."""
    from predictionio_tpu_torch.core.evaluation import Evaluation
    from predictionio_tpu_torch.core.params import EngineParams
    from predictionio_tpu_torch.workflow.evaluate import run_evaluation

    class Killed(Evaluation):
        def run(self, ctx, params_list):
            raise port_faults.CrashError("injected kill mid-sweep")

    with pytest.raises(port_faults.CrashError):
        run_evaluation(Killed(), [EngineParams()], device="cpu")
    rows = Storage.get_meta_data_evaluation_instances().get_all()
    assert [r.status for r in rows] == ["EVALFAILED"]
    assert "CrashError" in rows[0].evaluator_results
