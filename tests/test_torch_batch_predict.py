"""``pio batchpredict`` of the port (``workflow/batch_predict.py``,
``cli/main.py batchpredict``) against the JAX package's, on the CPU.

The same factors, made from a numpy seed (the reference's own
``_synth_result`` fixture), go into both packages' recommendation
engines; the same query file (with malformed rows) goes through both
``run_batch_predict``: the lines must be the same — query echo, key
order and item ids byte-equal, scores within ``RTOL``/``ATOL`` (f32
products summed in another order) — and so must the sidecar records,
the report's fields and, after a sharded merge, the ``.fleet.json``
document (its counters; its timings are the runs' own).

The port alone: a 2-shard merge equals a single run; kills at
``batchpredict:chunk`` and ``batchpredict:merge`` leave nothing at the
final path and a stale manifest does not wedge the next fleet; the
sidecar's life cycle; pad waste; inline equals pipelined byte for byte;
a serving override takes the generic lane; parquet raises before any
output; the two-stage scorer (the shortlist kernel's plain version on
CPU tensors) equals an exact recompute; a fault of the card or of a
kernel wrapper fails the run instead of becoming sidecar rows, while a
query's own fault does become one (and the lane fallback is counted);
every ported engine answers what the port's query server answers; and
the CLI end to end with ``--device cpu``.
"""

import json
import math
import os
import re

import numpy as np
import pytest

import predictionio_tpu_torch.data.eventstore as port_eventstore
from predictionio_tpu.obs.registry import MetricsRegistry as RefRegistry
from predictionio_tpu.workflow.batch_predict import (
    run_batch_predict as ref_run_batch_predict,
)
from predictionio_tpu_torch.core.engine import TrainResult
from predictionio_tpu_torch.core.params import EngineParams
from predictionio_tpu_torch.engines.recommendation import (
    ALSAlgorithm, AlgorithmParams, RecommendationServing,
)
from predictionio_tpu_torch.models.als import ALSModel
from predictionio_tpu_torch.obs.registry import MetricsRegistry
from predictionio_tpu_torch.ops import kernels, scoring
from predictionio_tpu_torch.storage import faults
from predictionio_tpu_torch.storage.registry import Storage as PortStorage
from predictionio_tpu_torch.utils.server_config import (
    BatchPredictConfig, ScorerConfig,
)
from predictionio_tpu_torch.workflow.batch_predict import run_batch_predict

#: scores of the same ids: f32 products summed in another order
RTOL, ATOL = 1e-5, 1e-6
#: the report fields both packages must agree on (the rest are times,
#: trace ids and the fleet document, checked apart)
REPORT_FIELDS = ("written", "invalid", "chunks", "pad_waste", "worker",
                 "merged", "total_written", "total_invalid")


@pytest.fixture(autouse=True)
def _clean_process_state():
    scoring.set_process_scorer_config(None)
    faults.set_kill_points([])
    yield
    scoring.set_process_scorer_config(None)
    faults.set_kill_points([])


def _factors(nu=40, ni=24, rank=4, seed=5):
    """The reference fixture's factors (``tests/test_batch_predict.py``
    ``_synth_result``): vocabularies, U, V; the vocabularies sorted, as a
    trained model's are (both packages look ids up by binary search)."""
    rng = np.random.default_rng(seed)
    users = np.asarray(sorted(f"u{i}" for i in range(nu)), dtype=object)
    items = np.asarray(sorted(f"i{i}" for i in range(ni)), dtype=object)
    U = rng.normal(size=(nu, rank)).astype(np.float32)
    V = rng.normal(size=(ni, rank)).astype(np.float32)
    return users, items, U, V


def _port_result(**kw):
    users, items, U, V = _factors(**kw)
    model = ALSModel.from_arrays(users, items, U, V, device="cpu")
    return TrainResult(models=[model],
                       algorithms=[ALSAlgorithm(AlgorithmParams())],
                       serving=RecommendationServing(),
                       engine_params=EngineParams())


def _ref_result(**kw):
    from predictionio_tpu.core.engine import TrainResult as RefTrainResult
    from predictionio_tpu.core.params import EngineParams as RefParams
    from predictionio_tpu.engines.recommendation import (
        ALSAlgorithm as RefALS, AlgorithmParams as RefAlgoParams,
        RecommendationServing as RefServing,
    )
    from predictionio_tpu.models.als import ALSModel as RefModel

    users, items, U, V = _factors(**kw)
    return RefTrainResult(
        models=[RefModel(user_vocab=users, item_vocab=items, U=U, V=V)],
        algorithms=[RefALS(RefAlgoParams())], serving=RefServing(),
        engine_params=RefParams())


def _write_queries(path, n=60, nu=40, malformed=False):
    """The reference test's query mix (unknown users, a blackList every
    7th query); with ``malformed``, unparseable and ill-fitting rows and
    a blank line among them."""
    lines = []
    for i in range(n):
        q = {"user": f"u{i % (nu + 3)}", "num": 3 + (i % 4)}
        if i % 7 == 0:
            q["black_list"] = [f"i{i % 5}"]
        if i % 11 == 3:
            q["whiteList"] = [f"i{(i + j) % 24}" for j in range(5)]
        lines.append(json.dumps(q))
    if malformed:
        lines[5:5] = ["this is { not json", json.dumps({"wrong": 1}), ""]
        lines.append(json.dumps({"user": "u1"}))
    path.write_text("\n".join(lines) + "\n")
    return n


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


_SCORE = re.compile(r'"score": [-+0-9.eE]+')


def _assert_same_lines(got_path, want_path):
    """Byte-equal lines once the score values are blanked (query echo,
    key order, item ids and their order), scores within RTOL/ATOL."""
    got = open(got_path).read().splitlines()
    want = open(want_path).read().splitlines()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _SCORE.sub('"score": S', g) == _SCORE.sub('"score": S', w)
        gs = [float(m.split(": ")[1]) for m in _SCORE.findall(g)]
        ws = [float(m.split(": ")[1]) for m in _SCORE.findall(w)]
        assert len(gs) == len(ws)
        for a, b in zip(gs, ws):
            assert math.isclose(a, b, rel_tol=RTOL, abs_tol=ATOL), (g, w)


def _report_fields(rep):
    return {f: getattr(rep, f) for f in REPORT_FIELDS}


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,pipelined", [(16, True), (8, False),
                                             (1024, True)])
def test_output_sidecar_and_report_equal_the_reference(tmp_path, chunk,
                                                       pipelined):
    inp = tmp_path / "q.jsonl"
    _write_queries(inp, malformed=True)
    ref_out, port_out = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    ref = ref_run_batch_predict(None, None, str(inp), str(ref_out),
                                chunk_size=chunk, loaded=(_ref_result(), None),
                                pipelined=pipelined, registry=RefRegistry())
    port = run_batch_predict(None, None, str(inp), str(port_out),
                             chunk_size=chunk, loaded=(_port_result(), None),
                             pipelined=pipelined, registry=MetricsRegistry())
    _assert_same_lines(port_out, ref_out)
    assert _report_fields(port) == _report_fields(ref)
    assert port.written == 60 and port.invalid == 3
    assert port.lane == "columnar" and port.lane_fallbacks == 0
    assert port.errors_path == f"{port_out}.errors.jsonl"
    assert ref.errors_path == f"{ref_out}.errors.jsonl"
    assert _read_jsonl(port.errors_path) == _read_jsonl(ref.errors_path)
    assert [e["row"] for e in _read_jsonl(port.errors_path)] == [5, 6, 62]


def test_sharded_merge_and_fleet_document_equal_the_reference(tmp_path):
    inp = tmp_path / "q.jsonl"
    n = _write_queries(inp, malformed=True)
    outs = {}
    for name, run, result, registry in (
            ("ref", ref_run_batch_predict, _ref_result(), RefRegistry),
            ("port", run_batch_predict, _port_result(), MetricsRegistry)):
        out = tmp_path / f"{name}.jsonl"
        reps = [run(None, None, str(inp), str(out), chunk_size=8,
                    loaded=(result, None), worker=(rank, 2),
                    registry=registry()) for rank in (0, 1)]
        outs[name] = (out, reps)
    (ref_out, ref_reps), (port_out, port_reps) = outs["ref"], outs["port"]
    _assert_same_lines(port_out, ref_out)
    for p, r in zip(port_reps, ref_reps):
        assert _report_fields(p) == _report_fields(r)
    assert port_reps[1].total_written == n and port_reps[1].merged
    assert _read_jsonl(f"{port_out}.errors.jsonl") == \
        _read_jsonl(f"{ref_out}.errors.jsonl")
    ref_doc = json.loads(open(f"{ref_out}.fleet.json").read())
    port_doc = json.loads(open(f"{port_out}.fleet.json").read())
    assert port_doc == port_reps[1].fleet
    assert port_doc["processes"] == ref_doc["processes"] == ["0/2", "1/2"]
    assert port_doc["counterTotals"] == ref_doc["counterTotals"]
    assert port_doc["counterTotals"][
        "pio_batchpredict_queries_total"] == n
    assert set(port_doc["metrics"]) == set(ref_doc["metrics"])
    for name, entry in port_doc["metrics"].items():
        assert entry["kind"] == ref_doc["metrics"][name]["kind"]
        if entry["kind"] == "counter":
            assert entry == ref_doc["metrics"][name]
    shape = lambda doc: sorted((t["name"], t["process"], t["status"])  # noqa
                               for t in doc["traces"])
    assert shape(port_doc) == shape(ref_doc)
    # each shard ran without a parent context: a root trace of its own
    assert {t["traceId"] for t in port_doc["traces"]} == {
        r.trace_id for r in port_reps}


# ---------------------------------------------------------------------------
# sharding and crash safety
# ---------------------------------------------------------------------------

def test_sharded_merge_equals_single_process(tmp_path):
    result = _port_result()
    inp = tmp_path / "q.jsonl"
    n = _write_queries(inp)
    single = tmp_path / "single.jsonl"
    rep = run_batch_predict(None, None, str(inp), str(single),
                            chunk_size=16, loaded=(result, None))
    assert rep.written == rep.total_written == n and rep.merged
    merged = tmp_path / "merged.jsonl"
    r0 = run_batch_predict(None, None, str(inp), str(merged), chunk_size=16,
                           loaded=(result, None), worker=(0, 2))
    assert not r0.merged and r0.worker == (0, 2) and not merged.exists()
    r1 = run_batch_predict(None, None, str(inp), str(merged), chunk_size=16,
                           loaded=(result, None), worker=(1, 2))
    assert r1.merged and r1.total_written == n
    assert abs(r0.written - r1.written) <= 1
    assert merged.read_bytes() == single.read_bytes()
    leftovers = [p for p in os.listdir(tmp_path)
                 if ".part-" in p or ".meta-" in p or ".manifest" in p
                 or ".tmp-" in p or ".obs-" in p]
    assert not leftovers, leftovers


def test_kill_mid_run_leaves_no_partial_output(tmp_path):
    result = _port_result()
    inp = tmp_path / "q.jsonl"
    n = _write_queries(inp)
    out = tmp_path / "out.jsonl"
    faults.set_kill_points(["batchpredict:chunk"])
    with pytest.raises(faults.CrashError):
        run_batch_predict(None, None, str(inp), str(out), chunk_size=16,
                          loaded=(result, None))
    assert not out.exists()
    assert not list(tmp_path.glob("out.jsonl.tmp-*"))
    rep = run_batch_predict(None, None, str(inp), str(out), chunk_size=16,
                            loaded=(result, None))
    assert rep.written == n and out.exists()


def test_kill_mid_merge_rolls_forward(tmp_path):
    result = _port_result()
    inp = tmp_path / "q.jsonl"
    n = _write_queries(inp)
    out = tmp_path / "out.jsonl"
    run_batch_predict(None, None, str(inp), str(out), chunk_size=16,
                      loaded=(result, None), worker=(0, 2))
    faults.set_kill_points(["batchpredict:merge"])
    with pytest.raises(faults.CrashError):
        run_batch_predict(None, None, str(inp), str(out), chunk_size=16,
                          loaded=(result, None), worker=(1, 2))
    assert not out.exists()
    assert os.path.exists(f"{out}.manifest.json")
    rep = run_batch_predict(None, None, str(inp), str(out), chunk_size=16,
                            loaded=(result, None), worker=(1, 2))
    assert rep.merged and rep.total_written == n and out.exists()
    assert not os.path.exists(f"{out}.manifest.json")


def test_shard_finishing_mid_merge_does_not_merge_again(tmp_path,
                                                        monkeypatch):
    """Two shards finishing at once: the one that finds a sibling
    mid-merge waits for it and reports no merge of its own, so exactly
    one shard of the fleet says ``merged``."""
    import threading

    from predictionio_tpu_torch.workflow import batch_predict as bp

    result = _port_result()
    inp = tmp_path / "q.jsonl"
    n = _write_queries(inp)
    out = tmp_path / "out.jsonl"
    single = tmp_path / "single.jsonl"
    run_batch_predict(None, None, str(inp), str(single), chunk_size=16,
                      loaded=(result, None))
    run_batch_predict(None, None, str(inp), str(out), chunk_size=16,
                      loaded=(result, None), worker=(0, 2))
    real_merge = bp._do_merge
    entered, go = threading.Event(), threading.Event()
    merges = []

    def held_merge(*args):
        merges.append(args)
        entered.set()
        assert go.wait(30)
        return real_merge(*args)

    monkeypatch.setattr(bp, "_do_merge", held_merge)
    reps = {}
    merger = threading.Thread(target=lambda: reps.setdefault(
        "merger", run_batch_predict(None, None, str(inp), str(out),
                                    chunk_size=16, loaded=(result, None),
                                    worker=(1, 2))))
    merger.start()
    assert entered.wait(30)
    fp = bp._input_fingerprint(str(inp), None)
    late = threading.Thread(target=lambda: reps.setdefault(
        "late", bp._maybe_merge(str(out), 2, fp)))
    late.start()
    late.join(0.3)
    assert late.is_alive()            # waits on the merger's lock
    go.set()
    merger.join(30)
    late.join(30)
    assert reps["merger"].merged and reps["merger"].total_written == n
    assert reps["late"] is None and len(merges) == 1
    assert out.read_bytes() == single.read_bytes()


def test_kill_points_arm_from_the_environment(monkeypatch):
    monkeypatch.setattr(faults, "_kill_points", None)
    monkeypatch.setenv("PIO_FAULT_KILL", " a:b , c ")
    assert faults.armed_kill_points() == {"a:b", "c"}
    with pytest.raises(faults.CrashError, match="a:b"):
        faults.maybe_kill("a:b")
    faults.maybe_kill("a:b")          # each fires once
    assert faults.armed_kill_points() == {"c"}
    assert not isinstance(faults.CrashError("x"), Exception)


def test_stale_manifest_after_commit_does_not_wedge(tmp_path, monkeypatch):
    result = _port_result()
    inp = tmp_path / "q.jsonl"
    _write_queries(inp)
    out = tmp_path / "out.jsonl"
    real_unlink = os.unlink

    def keep_markers(path, *args, **kwargs):
        p = str(path)
        if ".part-" in p or ".meta-" in p or ".manifest" in p:
            return
        return real_unlink(path, *args, **kwargs)

    monkeypatch.setattr(os, "unlink", keep_markers)
    for rank in (0, 1):
        run_batch_predict(None, None, str(inp), str(out), chunk_size=16,
                          loaded=(result, None), worker=(rank, 2))
    monkeypatch.undo()
    assert out.exists() and os.path.exists(f"{out}.manifest.json")
    n2 = _write_queries(inp, n=50)
    single = tmp_path / "single.jsonl"
    run_batch_predict(None, None, str(inp), str(single), chunk_size=16,
                      loaded=(result, None))
    for rank in (0, 1):
        rep = run_batch_predict(None, None, str(inp), str(out),
                                chunk_size=16, loaded=(result, None),
                                worker=(rank, 2))
    assert rep.merged and rep.total_written == n2
    assert out.read_bytes() == single.read_bytes()
    leftovers = [p for p in os.listdir(tmp_path)
                 if ".part-" in p or ".meta-" in p or ".manifest" in p]
    assert not leftovers, leftovers


def test_worker_contract(monkeypatch):
    from predictionio_tpu_torch.parallel.distributed import (
        contiguous_range, process_count, resolve_worker, worker_env,
    )

    monkeypatch.delenv("PIO_NUM_PROCESSES", raising=False)
    assert resolve_worker() == (0, 1) and process_count() == 1
    assert resolve_worker(1, 3) == (1, 3)
    with pytest.raises(ValueError):
        resolve_worker(3, 3)
    env = worker_env(1, 2, base={})
    assert env == {"PIO_PROCESS_ID": "1", "PIO_NUM_PROCESSES": "2"}
    monkeypatch.setenv("PIO_NUM_PROCESSES", "4")
    monkeypatch.setenv("PIO_PROCESS_ID", "2")
    assert resolve_worker() == (2, 4) and process_count() == 4
    monkeypatch.setenv("PIO_PROCESS_ID", "4")
    with pytest.raises(ValueError):
        resolve_worker()
    ranges = [contiguous_range(10, r, 4) for r in range(4)]
    assert ranges == [(0, 3), (3, 6), (6, 8), (8, 10)]


# ---------------------------------------------------------------------------
# malformed input and accounting
# ---------------------------------------------------------------------------

def test_malformed_rows_skip_to_sidecar(tmp_path):
    inp = tmp_path / "q.jsonl"
    inp.write_text("\n".join([
        json.dumps({"user": "u1", "num": 3}),
        "this is { not json",
        json.dumps({"wrong_field": 1}),
        "",
        json.dumps({"user": "u2", "num": 2}),
    ]) + "\n")
    out = tmp_path / "out.jsonl"
    registry = MetricsRegistry()
    rep = run_batch_predict(None, None, str(inp), str(out), chunk_size=8,
                            loaded=(_port_result(), None), registry=registry)
    assert rep.written == 2 and rep.invalid == 2
    assert rep.errors_path == str(out) + ".errors.jsonl"
    assert [ln["query"]["user"] for ln in _read_jsonl(out)] == ["u1", "u2"]
    errors = _read_jsonl(rep.errors_path)
    assert [e["row"] for e in errors] == [1, 2]
    assert "invalid JSON" in errors[0]["error"]
    assert "does not fit" in errors[1]["error"]
    assert registry.counter(
        "pio_batchpredict_invalid_queries_total", "").value() == 2


def test_clean_run_writes_no_sidecar_and_removes_a_stale_one(tmp_path):
    inp = tmp_path / "q.jsonl"
    out = tmp_path / "out.jsonl"
    sidecar = str(out) + ".errors.jsonl"
    inp.write_text(json.dumps({"user": "u1", "num": 3}) + "\nnot json\n")
    rep = run_batch_predict(None, None, str(inp), str(out),
                            loaded=(_port_result(), None))
    assert rep.invalid == 1 and os.path.exists(sidecar)
    inp.write_text(json.dumps({"user": "u1", "num": 3}) + "\n")
    rep = run_batch_predict(None, None, str(inp), str(out),
                            loaded=(_port_result(), None))
    assert rep.invalid == 0 and rep.errors_path is None
    assert not os.path.exists(sidecar)


def test_metrics_and_pad_waste_accounting(tmp_path):
    """13 queries at chunk 8 -> chunks [8, 5]; the short chunk pads up
    its power-of-two bucket (8): 3 throwaway rows."""
    inp = tmp_path / "q.jsonl"
    _write_queries(inp, n=13)
    out = tmp_path / "out.jsonl"
    registry = MetricsRegistry()
    rep = run_batch_predict(None, None, str(inp), str(out), chunk_size=8,
                            loaded=(_port_result(), None), registry=registry)
    assert rep.written == 13 and rep.chunks == 2 and rep.pad_waste == 3
    assert registry.counter(
        "pio_batchpredict_pad_waste_rows_total", "").value() == 3
    assert registry.counter(
        "pio_batchpredict_queries_total", "").value() == 13
    assert registry.gauge("pio_batchpredict_rows_per_second", "").value() > 0
    assert registry.histogram(
        "pio_batchpredict_chunk_seconds", "",
        buckets=registry.get("pio_batchpredict_chunk_seconds").buckets
    ).total_count() == 2
    spans = registry.get("pio_span_duration_seconds")
    assert spans.count(span="batchpredict_score") == 2
    assert spans.count(span="batchpredict_write") == 2
    assert rep.rows_per_second > 0 and rep.seconds > 0


def test_pipelined_false_matches_pipelined_true(tmp_path):
    inp = tmp_path / "q.jsonl"
    _write_queries(inp, malformed=True)
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    result = _port_result()
    run_batch_predict(None, None, str(inp), str(a), chunk_size=16,
                      loaded=(result, None), pipelined=True)
    run_batch_predict(None, None, str(inp), str(b), chunk_size=16,
                      loaded=(result, None), pipelined=False)
    assert a.read_bytes() == b.read_bytes()
    assert open(f"{a}.errors.jsonl").read() == \
        open(f"{b}.errors.jsonl").read()


def test_serving_override_disables_the_columnar_lane(tmp_path):
    from predictionio_tpu_torch.core.base import Serving
    from predictionio_tpu_torch.engines.recommendation import (
        PredictedResult,
    )

    result = _port_result()

    class TopOne(Serving):
        def serve(self, query, predictions):
            return PredictedResult(
                item_scores=predictions[0].item_scores[:1])

    result.serving = TopOne()
    inp = tmp_path / "q.jsonl"
    inp.write_text(json.dumps({"user": "u1", "num": 5}) + "\n")
    out = tmp_path / "out.jsonl"
    rep = run_batch_predict(None, None, str(inp), str(out),
                            loaded=(result, None))
    (line,) = _read_jsonl(out)
    assert len(line["prediction"]["itemScores"]) == 1
    assert rep.lane == "generic"


def test_columnar_lane_equals_the_generic_lane(tmp_path, monkeypatch):
    inp = tmp_path / "q.jsonl"
    _write_queries(inp)
    fast, slow = tmp_path / "fast.jsonl", tmp_path / "slow.jsonl"
    assert run_batch_predict(None, None, str(inp), str(fast), chunk_size=16,
                             loaded=(_port_result(), None)).lane == "columnar"
    monkeypatch.delattr(ALSAlgorithm, "batch_predict_columnar")
    assert run_batch_predict(None, None, str(inp), str(slow), chunk_size=16,
                             loaded=(_port_result(), None)).lane == "generic"
    assert fast.read_bytes() == slow.read_bytes()


@pytest.mark.parametrize("kw", [
    {"inp": "q.parquet"}, {"out": "p.parquet"}, {"out": "p.PQ"},
    {"output_format": "parquet"}, {"input_format": "parquet"},
    {"config": BatchPredictConfig(output_format="parquet"), "out": "p"},
], ids=["input", "output", "output-pq", "output-format", "input-format",
        "configured"])
def test_parquet_raises_before_any_output(tmp_path, kw):
    kw = dict(kw)
    inp = tmp_path / kw.pop("inp", "q.jsonl")
    inp.write_text(json.dumps({"user": "u1", "num": 3}) + "\n")
    out = tmp_path / kw.pop("out", "p.jsonl")
    with pytest.raises(ValueError, match="pyarrow.*A10b"):
        run_batch_predict(None, None, str(inp), str(out),
                          loaded=(_port_result(), None), **kw)
    assert sorted(os.listdir(tmp_path)) == [inp.name]


# ---------------------------------------------------------------------------
# the two-stage scorer and faults of the card
# ---------------------------------------------------------------------------

def _twostage_result():
    """A catalog the two-stage scorer serves on the CPU (the parity gate
    passes): 3,000 items, rank 16, tiles of 512, shortlist 768."""
    rng = np.random.default_rng(7)
    spec = np.power(10.0, -1.0 * np.arange(16) / 15).astype(np.float32)
    U = (rng.standard_normal((64, 16)) * spec).astype(np.float32)
    V = (rng.standard_normal((3000, 16)) * spec).astype(np.float32)
    users = np.array([f"u{i:02d}" for i in range(64)])
    items = np.array([f"i{i:04d}" for i in range(3000)])
    scoring.set_process_scorer_config(ScorerConfig(
        mode="twostage", tile_items=512, shortlist=768))
    model = ALSModel.from_arrays(users, items, U, V, device="cpu")
    return TrainResult(models=[model],
                       algorithms=[ALSAlgorithm(AlgorithmParams())],
                       serving=RecommendationServing(),
                       engine_params=EngineParams()), U, V, items


def _twostage_queries(path):
    qs = []
    for u in range(64):
        q = {"user": f"u{u:02d}", "num": 10}
        if u % 6 == 0:
            q["blackList"] = [f"i{u:04d}"]
        qs.append(q)
    path.write_text("".join(json.dumps(q) + "\n" for q in qs))
    return qs


def test_twostage_scorer_equals_an_exact_recompute(tmp_path):
    result, U, V, items = _twostage_result()
    inp, out = tmp_path / "q.jsonl", tmp_path / "p.jsonl"
    qs = _twostage_queries(inp)
    kernels.reset_counts()
    rep = run_batch_predict(None, None, str(inp), str(out), chunk_size=32,
                            loaded=(result, None))
    model = result.models[0]
    assert model._scorer_cache[2].active_mode == "twostage"
    assert rep.written == 64 and rep.chunks == 2 and rep.lane_fallbacks == 0
    # the plain version ran (CPU tensors): no kernel launch
    assert kernels.counts()["shortlist"] == 0
    exact = U @ V.T
    for q, line in zip(qs, _read_jsonl(out)):
        row = exact[int(q["user"][1:])].copy()
        for it in q.get("blackList", ()):
            row[int(it[1:])] = -np.inf
        want = np.argsort(-row, kind="stable")[:10]
        got = line["prediction"]["itemScores"]
        assert len(got) == 10
        got_ids = [int(s["item"][1:]) for s in got]
        got_scores = np.array([s["score"] for s in got])
        np.testing.assert_allclose(got_scores, row[want], rtol=RTOL,
                                   atol=1e-5)
        # ids equal up to ties
        for g, w in zip(got_ids, want):
            assert g == w or abs(row[g] - row[w]) <= 1e-5


def _raise(exc):
    def fn(*_a, **_k):
        raise exc
    return fn


@pytest.mark.parametrize("fault", [
    kernels.KernelError("shortlist launch failed: CUDA error 700 (an "
                        "illegal memory access was encountered)"),
    RuntimeError("CUDA error: device-side assert triggered"),
    RuntimeError("CUDA out of memory. Tried to allocate 10.00 GiB"),
], ids=["kernel-wrapper", "cuda-runtime", "out-of-memory"])
@pytest.mark.parametrize("lane", ["columnar", "generic"])
def test_a_device_fault_fails_the_run(tmp_path, monkeypatch, fault, lane):
    """A fault of the card or of a kernel wrapper raised inside the
    two-stage scorer propagates out of the run (pipelined), on either
    lane: no output, no sidecar, nothing scored the slow way."""
    result, _U, _V, _items = _twostage_result()
    if lane == "generic":
        monkeypatch.delattr(ALSAlgorithm, "batch_predict_columnar")
    inp, out = tmp_path / "q.jsonl", tmp_path / "p.jsonl"
    _twostage_queries(inp)
    monkeypatch.setattr(scoring, "shortlist_topc", _raise(fault))
    with pytest.raises(type(fault), match=str(fault)[:12]):
        run_batch_predict(None, None, str(inp), str(out), chunk_size=32,
                          loaded=(result, None))
    assert sorted(os.listdir(tmp_path)) == ["q.jsonl"]


def test_a_wrapper_refusing_its_inputs_is_a_device_fault():
    import torch

    u = torch.zeros((1, 4))
    tiles = torch.zeros((1, 8, 4), dtype=torch.int8)
    scales = torch.ones((1, 8))
    try:
        kernels.shortlist_topc_cuda(u, tiles, scales, 8, None, 2)
    except ValueError as e:
        assert kernels.is_device_error(e)
    assert not kernels.is_device_error(ValueError("num must be >= 0"))
    assert not kernels.is_device_error(KeyError("user"))
    wrapped = ValueError("while scoring")
    wrapped.__cause__ = kernels.KernelError("spd_solve launch failed")
    assert kernels.is_device_error(wrapped)


def test_a_query_fault_becomes_a_sidecar_row(tmp_path):
    """A query the model refuses (num < 0) fails the columnar lane and
    the batch: the chunk is scored again on the generic lane, then one
    query at a time; only that row goes to the sidecar, and both
    fallbacks are counted."""
    inp, out = tmp_path / "q.jsonl", tmp_path / "p.jsonl"
    inp.write_text("".join(json.dumps(q) + "\n" for q in [
        {"user": "u1", "num": 3}, {"user": "u2", "num": -1},
        {"user": "u3", "num": 2}]))
    rep = run_batch_predict(None, None, str(inp), str(out), chunk_size=8,
                            loaded=(_port_result(), None))
    assert rep.written == 2 and rep.invalid == 1
    assert rep.lane_fallbacks == 2
    (err,) = _read_jsonl(rep.errors_path)
    assert err["row"] == 1 and "predict failed" in err["error"]
    assert "num must be >= 0" in err["error"]


# ---------------------------------------------------------------------------
# every ported engine against the port's query server
# ---------------------------------------------------------------------------

def _config(path):
    return {"sources": {"DB": {"TYPE": "sqlite", "PATH": str(path)}},
            "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                             for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}}


@pytest.fixture()
def port_store(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_ENTITY_CACHE_TTL_S", "0")
    PortStorage.reset()
    port_eventstore.clear_cache()
    PortStorage.configure(_config(tmp_path / "bp.db"))
    yield PortStorage
    PortStorage.reset()
    port_eventstore.clear_cache()


def _app(store, name):
    from predictionio_tpu_torch.storage.base import App

    app_id = store.get_meta_data_apps().insert(App(id=0, name=name))
    store.get_events().init_channel(app_id)
    return app_id


def _ev(event, etype, eid, props=None, ttype=None, tid=None):
    from predictionio_tpu_torch.data.event import Event

    return Event(event=event, entity_type=etype, entity_id=eid,
                 properties=props or {}, target_entity_type=ttype,
                 target_entity_id=tid)


def _item_sets(n):
    return [_ev("$set", "item", f"i{i}",
                {"categories": ["even" if i % 2 == 0 else "odd"]})
            for i in range(n)]


def _setup_recommendation(store):
    from predictionio_tpu_torch.engines import recommendation as mod

    app_id = _app(store, "BpRec")
    rng = np.random.default_rng(7)
    store.get_events().insert_batch([
        _ev("rate", "user", f"u{u}", {"rating": float(rng.integers(1, 6))},
            "item", f"i{it}")
        for u in range(15) for it in range(10)
        if (u % 2) == (it % 2) and rng.random() < 0.7], app_id)
    queries = [{"user": "u0", "num": 3}, {"user": "u1", "num": 5},
               {"user": "ghost", "num": 3},
               {"user": "u2", "num": 4, "black_list": ["i0", "i2"]},
               {"user": "u3", "num": 2, "white_list": ["i1", "i3", "i5"]}]
    return (mod.engine(), mod.default_engine_params("BpRec", rank=4,
                                                    num_iterations=4),
            queries)


def _similar_events(store, name):
    app_id = _app(store, name)
    rng = np.random.default_rng(3)
    evs = _item_sets(12)
    evs += [_ev("view", "user", f"u{u}", None, "item", f"i{it}")
            for u in range(16) for it in range(12)
            if it % 2 == (u % 2) and rng.random() < 0.8]
    store.get_events().insert_batch(evs, app_id)
    return [{"items": ["i0"], "num": 4}, {"items": ["i1", "i3"], "num": 3},
            {"items": ["i0"], "num": 4, "categories": ["odd"]},
            {"items": ["i2"], "num": 3, "black_list": ["i4"]},
            {"items": ["nope"], "num": 3}]


def _setup_similar_als(store):
    from predictionio_tpu_torch.engines import similarproduct as mod

    queries = _similar_events(store, "BpSim")
    return (mod.engine(), mod.default_engine_params("BpSim", ("als",)),
            queries)


def _setup_similar_cooccurrence(store):
    from predictionio_tpu_torch.engines import similarproduct as mod

    queries = _similar_events(store, "BpCooc")
    return (mod.engine(),
            mod.default_engine_params("BpCooc", ("cooccurrence",)), queries)


def _setup_ecommerce(store):
    from predictionio_tpu_torch.engines import ecommerce as mod

    app_id = _app(store, "BpEcom")
    rng = np.random.default_rng(4)
    evs = _item_sets(14)
    evs += [_ev("$set", "user", f"u{u}") for u in range(12)]
    evs += [_ev("view" if rng.random() < 0.8 else "buy", "user",
                f"u{int(rng.integers(12))}", None, "item",
                f"i{int(rng.integers(14))}") for _ in range(150)]
    store.get_events().insert_batch(evs, app_id)
    queries = [{"user": "u0", "num": 4}, {"user": "u5", "num": 3,
                                         "categories": ["odd"]},
               {"user": "stranger", "num": 3},
               {"user": "u2", "num": 5, "blackList": ["i1", "i2"]}]
    return (mod.engine(), mod.default_engine_params("BpEcom", rank=4,
                                                    num_iterations=4),
            queries)


def _setup_recommended_user(store):
    from predictionio_tpu_torch.engines import recommended_user as mod

    app_id = _app(store, "BpFollow")
    rng = np.random.default_rng(6)
    evs = [_ev("$set", "user", f"u{u}") for u in range(14)]
    evs += [_ev("follow", "user", f"u{a}", None, "user", f"u{b}")
            for a in range(14) for b in range(14)
            if a != b and (a + b) % 3 == 0 and rng.random() < 0.8]
    store.get_events().insert_batch(evs, app_id)
    queries = [{"users": ["u0"], "num": 3}, {"users": ["u1", "u4"], "num": 4},
               {"users": ["u2"], "num": 3, "blackList": ["u5"]},
               {"users": ["nobody"], "num": 2}]
    return (mod.engine(), mod.default_engine_params("BpFollow", rank=4,
                                                    num_iterations=4),
            queries)


def _assert_same_answers(got, expected):
    """The reference test's rule: items, order and shapes exact, floats
    within rel 1e-5 / abs 1e-6."""
    def eq(a, b, path):
        if isinstance(a, float) or isinstance(b, float):
            assert math.isclose(float(a), float(b), rel_tol=RTOL,
                                abs_tol=ATOL), (path, a, b)
        elif isinstance(a, dict):
            assert isinstance(b, dict) and a.keys() == b.keys(), (path, a, b)
            for k in a:
                eq(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, list):
            assert isinstance(b, list) and len(a) == len(b), (path, a, b)
            for i, (x, y) in enumerate(zip(a, b)):
                eq(x, y, f"{path}[{i}]")
        else:
            assert a == b, (path, a, b)

    assert len(got) == len(expected)
    for i, (g, e) in enumerate(zip(got, expected)):
        eq(g, e, f"row{i}")


@pytest.mark.parametrize("setup", [
    _setup_recommendation, _setup_similar_als, _setup_similar_cooccurrence,
    _setup_ecommerce, _setup_recommended_user,
], ids=["recommendation", "similarproduct-als", "similarproduct-cooccurrence",
        "ecommerce", "recommended-user"])
def test_parity_with_the_port_query_server(port_store, tmp_path, setup):
    from predictionio_tpu_torch.core.params import params_from_json
    from predictionio_tpu_torch.server.query_server import (
        _query_class, _to_jsonable, create_query_server,
    )
    from predictionio_tpu_torch.workflow.train import (
        load_for_deploy, run_train,
    )

    eng, params, queries = setup(port_store)
    instance, _ = run_train(eng, params, engine_factory=setup.__name__,
                            device="cpu")
    result, _ctx = load_for_deploy(eng, instance, device="cpu")
    server = create_query_server(eng, result, instance)
    qc = _query_class(result)
    expected = [{"query": q, "prediction": _to_jsonable(
        server._predict_unit(server._unit, params_from_json(q, qc)))}
        for q in queries]
    server._predict_executor.shutdown()
    server._deploy_executor.shutdown()
    inp, out = tmp_path / "queries.jsonl", tmp_path / "preds.jsonl"
    inp.write_text("".join(json.dumps(q) + "\n" for q in queries))
    rep = run_batch_predict(eng, instance, str(inp), str(out), chunk_size=4,
                            device="cpu")
    assert rep.written == len(queries) and rep.invalid == 0
    assert rep.lane_fallbacks == 0
    _assert_same_answers(_read_jsonl(out), expected)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_batchpredict_end_to_end(port_store, tmp_path, monkeypatch,
                                     capsys):
    from predictionio_tpu_torch.cli.main import main

    _setup_recommendation(port_store)
    variant = tmp_path / "engine.json"
    variant.write_text(json.dumps({
        "id": "default",
        "engineFactory": "predictionio_tpu_torch.engines.recommendation:engine",
        "datasource": {"params": {"appName": "BpRec"}},
        "algorithms": [{"name": "als", "params": {"rank": 4,
                                                  "numIterations": 3}}],
        "batchpredict": {"chunkSize": 3}}))
    assert main(["train", "--variant", str(variant), "--device", "cpu"]) == 0
    inp, out = tmp_path / "q.jsonl", tmp_path / "p.jsonl"
    lines = [json.dumps({"user": f"u{u}", "num": 4}) for u in range(15)]
    lines[4:4] = ["{broken", json.dumps({"nope": 1})]
    inp.write_text("\n".join(lines) + "\n")
    capsys.readouterr()
    args = ["batchpredict", "--variant", str(variant), "--input", str(inp),
            "--output", str(out), "--device", "cpu"]
    assert main(args) == 0
    printed = capsys.readouterr().out.splitlines()
    line = json.loads(printed[-1])
    assert line["written"] == 15 and line["invalid"] == 2
    assert line["chunks"] == 6 and line["lane"] == "columnar"
    assert line["lane_fallbacks"] == 0 and line["merged"]
    assert line["worker"] == [0, 1] and line["device"] == "cpu"
    assert line["launches"] == {"shortlist": 0, "spd_solve": 0}
    assert any(p.startswith("[WARN] Skipped 2 invalid queries")
               for p in printed)
    assert [e["row"] for e in _read_jsonl(f"{out}.errors.jsonl")] == [4, 5]
    single = out.read_bytes()
    out.unlink()
    for rank in (0, 1):
        monkeypatch.setenv("PIO_PROCESS_ID", str(rank))
        monkeypatch.setenv("PIO_NUM_PROCESSES", "2")
        assert main(args) == 0
        shard = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert shard["worker"] == [rank, 2] and shard["merged"] == (rank == 1)
    monkeypatch.delenv("PIO_PROCESS_ID")
    monkeypatch.delenv("PIO_NUM_PROCESSES")
    assert out.read_bytes() == single
    # (the counters are this test process's, which ran every shard)
    assert json.loads(open(f"{out}.fleet.json").read())["processes"] == [
        "0/2", "1/2"]
    # parquet: refused before anything is written
    with pytest.raises(SystemExit):
        main(args[:-4] + ["--output", str(tmp_path / "p.parquet"),
                          "--device", "cpu"])
    assert "pyarrow" in capsys.readouterr().out
    assert not (tmp_path / "p.parquet").exists()
    with pytest.raises(SystemExit):
        main(args + ["--output-format", "parquet"])
    # a kernel fault fails the command instead of filling the sidecar
    monkeypatch.setattr(ALSModel, "recommend_batch", _raise(
        kernels.KernelError("shortlist launch failed: CUDA error 700")))
    out.unlink()
    with pytest.raises(kernels.KernelError):
        main(args)
    assert not out.exists()
