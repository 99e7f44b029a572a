"""The port's evaluation (``core/metrics``, ``core/evaluation``,
``workflow/evaluate``, the recommendation engine's eval reads and
metrics, ``pio eval`` and the train debug stops) against the JAX
package's, on the CPU.

Ratings made from a seed with numpy go through both evaluators: the
in-memory engine of the reference's own sweep tests, and a sqlite store
that the reference writes and both packages read. The port trains from
the reference's initial item factors (its seeded init is patched to hand
them out). Both evaluators pick the same best candidate, batched and
sequential; scores agree within 5e-3 (the reference's own tolerance
between its batched and sequential paths: near-tied top-k edges may
flip); ``read_eval``'s folds are the reference's, triple for triple.
"""

import dataclasses
import datetime as dt
import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import predictionio_tpu.data.eventstore as ref_eventstore
import predictionio_tpu_torch.data.eventstore as port_eventstore
from predictionio_tpu.core import (
    Engine as RefEngine, EngineParams as RefEngineParams,
    MetricEvaluator as RefMetricEvaluator,
)
from predictionio_tpu.core import metrics as ref_metrics
from predictionio_tpu.core.evaluation import (
    expand_param_grid as ref_expand_param_grid,
)
from predictionio_tpu.data import DataMap as RefDataMap, Event as RefEvent
from predictionio_tpu.engines import recommendation as ref_rec
from predictionio_tpu.storage import App as RefApp, Storage as RefStorage
from predictionio_tpu_torch.core import metrics as port_metrics
from predictionio_tpu_torch.core.base import SanityCheck
from predictionio_tpu_torch.core.engine import (
    Engine, StopAfterPrepareInterruption, StopAfterReadInterruption,
)
from predictionio_tpu_torch.core.evaluation import (
    Evaluation, MetricEvaluator, expand_param_grid, sweep_kind_of,
)
from predictionio_tpu_torch.core.params import EngineParams
from predictionio_tpu_torch.engines import recommendation as port_rec
from predictionio_tpu_torch.models import als as port_als
from predictionio_tpu_torch.storage.registry import Storage as PortStorage

CPU = types.SimpleNamespace(device="cpu")
#: scores of the two evaluators (quantized precision may flip at near
#: ties of the top-k edge)
SCORE_TOL = 5e-3
APP = "TorchEvalApp"
BASE = dt.datetime(2024, 5, 1, tzinfo=dt.timezone.utc)


class RefCtx:
    pass


@pytest.fixture(autouse=True)
def reference_init(monkeypatch):
    """The port's seeded init hands out the reference's initial V."""
    def init(n_items, n_items_pad, k, seed, device):
        V = np.zeros((n_items_pad, k), np.float32)
        V[:n_items] = np.asarray(
            jax.random.normal(jax.random.PRNGKey(seed), (n_items, k),
                              jnp.float32) / jnp.sqrt(jnp.float32(k)))
        return torch.from_numpy(V).to(device)

    monkeypatch.setattr(port_als, "_init_item_factors", init)


# -- metrics --------------------------------------------------------------------

def _points_metric(mod, base, fn=lambda p: p):
    class M(getattr(mod, base)):
        def calculate_point(self, eval_info, q, p, a):
            return fn(p)
    return M()


def _eval_data(points):
    return [(None, [(None, p, None) for p in points])]


@pytest.mark.parametrize("base,points", [
    ("AverageMetric", [1, 2, 3, 6]),
    ("OptionAverageMetric", [1, None, 5]),
    ("StdevMetric", [1, 3, 7.5]),
    ("OptionStdevMetric", [2, None, 2]),
    ("SumMetric", [1, 2, 3]),
    ("AverageMetric", []),
])
def test_metrics_equal_the_reference(base, points):
    want = _points_metric(ref_metrics, base).calculate(
        None, _eval_data(points))
    got = _points_metric(port_metrics, base).calculate(
        None, _eval_data(points))
    assert got == pytest.approx(want, nan_ok=True)


@pytest.mark.parametrize("agg", ["average", "sum", "stdev"])
def test_qpa_metric_and_zero_metric_equal_the_reference(agg):
    data = _eval_data([0.5, 1.5, 4.0])
    got = port_metrics.QPAMetric(lambda q, p, a: p, agg).calculate(None, data)
    want = ref_metrics.QPAMetric(lambda q, p, a: p, agg).calculate(None, data)
    assert got == want
    assert port_metrics.ZeroMetric().calculate(None, data) == 0.0
    assert port_metrics.ZeroMetric.sweep_kind == "zero"


def test_compare_direction():
    m = _points_metric(port_metrics, "AverageMetric")
    assert m.compare(2.0, 1.0) > 0 and m.compare(1.0, 1.0) == 0
    m.smaller_is_better = True
    assert m.compare(2.0, 1.0) < 0
    assert m.header() == "M"


def test_recommendation_metrics_equal_the_reference():
    actual = [("u1", "i2", 4.0), ("u1", "i9", 1.0)]
    served = [("i2", 3.5), ("i4", 2.0), ("i9", 0.5)]

    def score(rec, metric):
        pred = rec.PredictedResult(item_scores=[
            rec.ItemScore(item=i, score=s) for i, s in served])
        act = rec.ActualResult(ratings=[
            rec.Rating(user=u, item=i, rating=r) for u, i, r in actual])
        return metric.calculate_point(None, rec.Query(user="u1", num=3),
                                      pred, act)

    for name, kw in (("PrecisionAtK", {"k": 2}),
                     ("PrecisionAtK", {"k": 3, "rating_threshold": 4.5}),
                     ("RMSEMetric", {})):
        assert score(port_rec, getattr(port_rec, name)(**kw)) == \
            score(ref_rec, getattr(ref_rec, name)(**kw))
    assert port_rec.PrecisionAtK(k=3).header() == \
        ref_rec.PrecisionAtK(k=3).header()


# -- the evaluator on an in-memory engine ---------------------------------------

def _ratings(nu=40, ni=24, per_user=10, seed=7):
    rng = np.random.default_rng(seed)
    rows = []
    for u in range(nu):
        for i in rng.choice(ni, size=per_user, replace=False):
            rows.append((f"u{u:03d}", f"i{i:03d}",
                         float(rng.integers(1, 6))))
    return rows


def _mem_engine(rec, rows, engine_cls):
    users = np.asarray([r[0] for r in rows], dtype=object)
    items = np.asarray([r[1] for r in rows], dtype=object)
    vals = np.asarray([r[2] for r in rows], dtype=np.float32)

    class MemDS(rec.RecommendationDataSource):
        def _read_columns(self):
            return rec.RatingColumns(users=users, items=items, values=vals)

    return engine_cls(MemDS, rec.RecommendationPreparator,
                      {"als": rec.ALSAlgorithm}, rec.RecommendationServing)


def _grid(rec, params_cls, ranks=(3, 5), regs=(0.05, 0.3), k_fold=2,
          query_num=4, iters=2, app=APP):
    return [params_cls(
        data_source_params=rec.DataSourceParams(
            app_name=app, eval_params={"kFold": k_fold,
                                       "queryNum": query_num}),
        algorithm_params_list=[("als", rec.AlgorithmParams(
            rank=r, num_iterations=iters, reg=g))])
        for r in ranks for g in regs]


def _evaluate_both(monkeypatch, rows, metric, other=(), vectorize="1",
                   **grid):
    monkeypatch.setenv("PIO_EVAL_VECTORIZE", vectorize)
    ref = RefMetricEvaluator(getattr(ref_rec, metric[0])(**metric[1]),
                             [getattr(ref_rec, m)() for m in other],
                             output_path=None).evaluate(
        RefCtx(), _mem_engine(ref_rec, rows, RefEngine),
        _grid(ref_rec, RefEngineParams, **grid))
    port = MetricEvaluator(getattr(port_rec, metric[0])(**metric[1]),
                           [getattr(port_rec, m)() for m in other],
                           output_path=None).evaluate(
        CPU, _mem_engine(port_rec, rows, Engine),
        _grid(port_rec, EngineParams, **grid))
    return ref, port


@pytest.mark.parametrize("vectorize", ["1", "0"],
                         ids=["batched", "sequential"])
def test_evaluator_picks_the_reference_best(monkeypatch, vectorize):
    ref, port = _evaluate_both(monkeypatch, _ratings(),
                               ("PrecisionAtK", {"k": 3}),
                               vectorize=vectorize)
    mode = "batched" if vectorize == "1" else "sequential"
    assert ref.sweep["mode"] == port.sweep["mode"] == mode
    assert port.best_idx == ref.best_idx
    for (_, sr, _o), (_, sp, _p) in zip(ref.engine_params_scores,
                                        port.engine_params_scores):
        assert sp == pytest.approx(sr, abs=SCORE_TOL)
    assert port.to_one_liner().startswith("[Precision@3 (threshold=2.0)] ")
    assert len(port.candidate_details) == 4
    if mode == "batched":
        assert port.sweep["compileGroups"] == 2
        assert port.sweep["batchSizes"] == [4, 4]
        assert set(port.sweep["seconds"]) == {"read", "build", "upload",
                                              "train", "metric"}
        assert port.candidate_details[0]["group"].startswith("g0:")
    else:
        assert port.candidate_details[0]["group"] == "sequential"


def test_batched_and_sequential_pick_the_same_best(monkeypatch):
    _, batched = _evaluate_both(monkeypatch, _ratings(seed=11),
                                ("PrecisionAtK", {"k": 3}), ["RMSEMetric"])
    _, sequential = _evaluate_both(monkeypatch, _ratings(seed=11),
                                   ("PrecisionAtK", {"k": 3}),
                                   ["RMSEMetric"], vectorize="0")
    assert batched.best_idx == sequential.best_idx
    for (_, sb, ob), (_, ss, os_) in zip(batched.engine_params_scores,
                                         sequential.engine_params_scores):
        assert sb == pytest.approx(ss, abs=SCORE_TOL)
        assert len(ob) == len(os_) == 1 and np.isfinite(ob[0])
    js = json.loads(json.dumps(batched.to_json_dict()))
    assert js["sweep"]["mode"] == "batched" and len(js["candidates"]) == 4
    assert "<table" in batched.to_html()


@pytest.mark.parametrize("seed", [7, 11, 17])
def test_batched_sweep_scores_what_the_sequential_loop_serves(monkeypatch,
                                                              seed):
    """The sweep's rank rule (a held-out item is served when fewer than
    queryNum items score strictly higher, all scores from one product)
    against the port's own sequential loop, which trains every fold and
    serves each query's top items through ``batch_predict``: the same
    hits per candidate, and the top-N MSE within 1e-5 relative (f32
    scores summed in another order)."""
    rows = _ratings(seed=seed)

    def evaluate(vectorize):
        monkeypatch.setenv("PIO_EVAL_VECTORIZE", vectorize)
        return MetricEvaluator(
            port_rec.PrecisionAtK(k=3), [port_rec.RMSEMetric()],
            output_path=None).evaluate(
            CPU, _mem_engine(port_rec, rows, Engine),
            _grid(port_rec, EngineParams))

    batched, sequential = evaluate("1"), evaluate("0")
    assert (batched.sweep["mode"], sequential.sweep["mode"]) == \
        ("batched", "sequential")
    denom = 3                             # min(k, queryNum)
    for (_, pb, (mb,)), (_, ps, (ms,)), d in zip(
            batched.engine_params_scores, sequential.engine_params_scores,
            batched.candidate_details):
        nq = d["nQual"]
        assert nq > 0
        assert round(pb * denom * nq) == round(ps * denom * nq)
        assert mb == pytest.approx(ms, rel=1e-5)


def test_rmse_metric_smaller_is_better_picks_the_reference_best(monkeypatch):
    ref, port = _evaluate_both(monkeypatch, _ratings(seed=13),
                               ("RMSEMetric", {}), ranks=(3,),
                               regs=(0.01, 0.3, 3.0))
    assert port.sweep["mode"] == "batched"
    assert port.best_idx == ref.best_idx
    for (_, sr, _o), (_, sp, _p) in zip(ref.engine_params_scores,
                                        port.engine_params_scores):
        assert sp == pytest.approx(sr, abs=0.05)


def test_sweep_kind_not_inherited_past_custom_math():
    class InheritedPrecision(port_rec.PrecisionAtK):     # custom math
        def calculate_point(self, eval_info, q, p, a):
            return 1.0

    class RedeclaredPrecision(InheritedPrecision):
        sweep_kind = "precision_at_k"

    assert sweep_kind_of(port_rec.PrecisionAtK()) == "precision_at_k"
    assert sweep_kind_of(port_rec.RMSEMetric()) == "topn_mse"
    assert sweep_kind_of(InheritedPrecision()) is None
    assert sweep_kind_of(RedeclaredPrecision()) == "precision_at_k"
    result = MetricEvaluator(InheritedPrecision(k=3), output_path=None) \
        .evaluate(CPU, _mem_engine(port_rec, _ratings(seed=19), Engine),
                  _grid(port_rec, EngineParams, ranks=(3,), regs=(0.1,)))
    assert result.sweep["mode"] == "sequential"
    assert result.best_score == 1.0               # the override ran


def test_evaluator_falls_back_without_sweep_support():
    class HostOnlyPrecision(port_rec.PrecisionAtK):
        sweep_kind = None

    result = MetricEvaluator(HostOnlyPrecision(k=3), output_path=None) \
        .evaluate(CPU, _mem_engine(port_rec, _ratings(seed=13), Engine),
                  _grid(port_rec, EngineParams, ranks=(3,), regs=(0.1,)))
    assert result.sweep["mode"] == "sequential"
    with pytest.raises(ValueError, match="must not be empty"):
        MetricEvaluator(HostOnlyPrecision()).evaluate(
            CPU, _mem_engine(port_rec, _ratings(), Engine), [])


@pytest.mark.parametrize("specs", [["rank=4,6", "reg=0.01,0.1,0.5"],
                                   ["seed=1,2", "implicit_prefs=true"], []])
def test_expand_param_grid_equals_the_reference(specs):
    port = expand_param_grid(_grid(port_rec, EngineParams, ranks=(3,),
                                   regs=(0.1,)), specs)
    ref = ref_expand_param_grid(_grid(ref_rec, RefEngineParams, ranks=(3,),
                                      regs=(0.1,)), specs)
    assert [ep.to_json_dict() for ep in port] == \
        [ep.to_json_dict() for ep in ref]


@pytest.mark.parametrize("spec,match", [(["nope=1,2"], "not a parameter"),
                                        (["rank"], "expected"),
                                        (["rank=8,12", "rank=16"], "twice")])
def test_expand_param_grid_rejects_what_the_reference_rejects(spec, match):
    base = _grid(port_rec, EngineParams, ranks=(3,), regs=(0.1,))
    with pytest.raises(ValueError, match=match):
        expand_param_grid(base, spec)


# -- a store both packages read ------------------------------------------------

def _config(path):
    return {"sources": {"DB": {"TYPE": "sqlite", "PATH": str(path)}},
            "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                             for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}}


@pytest.fixture()
def store(tmp_path):
    """Rate events and a few buys written by the reference into one
    sqlite file, which both registries read."""
    def reset():
        RefStorage.reset()
        PortStorage.reset()
        ref_eventstore.clear_cache()
        port_eventstore.clear_cache()

    reset()
    path = tmp_path / "pio.db"
    RefStorage.configure(_config(path))
    app_id = RefStorage.get_meta_data_apps().insert(RefApp(id=0, name=APP))
    events = RefStorage.get_events()
    events.init_channel(app_id)
    rows = _ratings(nu=30, ni=20, per_user=8, seed=23)
    evs = [RefEvent(event="rate", entity_type="user", entity_id=u,
                    target_entity_type="item", target_entity_id=i,
                    properties=RefDataMap({"rating": r}),
                    event_time=BASE + dt.timedelta(seconds=(7 * j) % 50))
           for j, (u, i, r) in enumerate(rows)]
    evs += [RefEvent(event="buy", entity_type="user", entity_id=f"u00{j}",
                     target_entity_type="item", target_entity_id=f"i00{j}",
                     event_time=BASE) for j in range(5)]
    events.insert_batch(evs, app_id)
    PortStorage.configure(_config(path))
    yield tmp_path
    reset()


def test_read_eval_folds_equal_the_reference(store):
    ds = {"app_name": APP, "eval_params": {"kFold": 3, "queryNum": 5}}
    ref = ref_rec.RecommendationDataSource(
        ref_rec.DataSourceParams(**ds)).read_eval(RefCtx())
    port = port_rec.RecommendationDataSource(
        port_rec.DataSourceParams(**ds)).read_eval(CPU)
    assert len(port) == len(ref) == 3

    def triples(ratings):
        return [(r.user, r.item, r.rating) for r in ratings]

    for (ptd, pinfo, pqa), (rtd, rinfo, rqa) in zip(port, ref):
        assert pinfo == rinfo
        assert triples(ptd.ratings) == triples(rtd.ratings)
        assert [(q.user, q.num, triples(a.ratings)) for q, a in pqa] == \
            [(q.user, q.num, triples(a.ratings)) for q, a in rqa]
    grid = port_rec.RecommendationDataSource(
        port_rec.DataSourceParams(**ds)).read_eval_grid(CPU)
    assert (grid.k_fold, grid.query_num) == (3, 5)
    assert list(grid.data.users) == [r.user for r in
                                     ref_rec.RecommendationDataSource(
                                         ref_rec.DataSourceParams(**ds)
                                     )._read_ratings()]


@pytest.mark.parametrize("vectorize", ["1", "0"],
                         ids=["batched", "sequential"])
def test_evaluators_on_one_store_pick_the_same_best(store, monkeypatch,
                                                    vectorize):
    monkeypatch.setenv("PIO_EVAL_VECTORIZE", vectorize)
    ref = RefMetricEvaluator(ref_rec.PrecisionAtK(k=4), output_path=None) \
        .evaluate(RefCtx(), ref_rec.engine(),
                  _grid(ref_rec, RefEngineParams, ranks=(3, 4),
                        regs=(0.05, 0.5), k_fold=3))
    port = MetricEvaluator(port_rec.PrecisionAtK(k=4), output_path=None) \
        .evaluate(CPU, port_rec.engine(),
                  _grid(port_rec, EngineParams, ranks=(3, 4),
                        regs=(0.05, 0.5), k_fold=3))
    assert port.sweep["mode"] == ref.sweep["mode"]
    assert port.best_idx == ref.best_idx
    for (_, sr, _o), (_, sp, _p) in zip(ref.engine_params_scores,
                                        port.engine_params_scores):
        assert sp == pytest.approx(sr, abs=SCORE_TOL)


def test_best_json_is_the_reference_engine_json(store, tmp_path):
    best = tmp_path / "best.json"
    eps = _grid(port_rec, EngineParams, ranks=(3,), regs=(0.05, 0.5))
    result = MetricEvaluator(port_rec.PrecisionAtK(k=4),
                             output_path=str(best)).evaluate(
        CPU, port_rec.engine(), eps)
    written = json.loads(best.read_text())
    ref_ep = _grid(ref_rec, RefEngineParams, ranks=(3,),
                   regs=(0.05, 0.5))[result.best_idx]
    assert written == json.loads(json.dumps(ref_ep.to_json_dict()))
    assert not list(tmp_path.glob("best.json.tmp-*"))
    parsed = port_rec.engine().engine_params_from_json(written)
    assert parsed.data_source_params == eps[result.best_idx].data_source_params
    assert parsed.algorithm_params_list == \
        eps[result.best_idx].algorithm_params_list


# -- the workflow and the CLI ----------------------------------------------------

def test_failed_evaluation_persists_evalfailed(store):
    from predictionio_tpu_torch.workflow.evaluate import run_evaluation

    class BoomEvaluation(Evaluation):
        def run(self, ctx, engine_params_list):
            raise RuntimeError("sweep exploded")

    with pytest.raises(RuntimeError, match="sweep exploded"):
        run_evaluation(BoomEvaluation(),
                       _grid(port_rec, EngineParams, ranks=(3,), regs=(0.1,)),
                       evaluation_class="BoomEvaluation", device="cpu")
    stored = PortStorage.get_meta_data_evaluation_instances().get_all()
    assert [s.status for s in stored] == ["EVALFAILED"]
    assert "RuntimeError: sweep exploded" in stored[0].evaluator_results
    # the reference reads the same row
    ref_rows = RefStorage.get_meta_data_evaluation_instances().get_all()
    assert [(r.id, r.status) for r in ref_rows] == \
        [(stored[0].id, "EVALFAILED")]


def test_evaluation_persists_candidate_breakdown(store):
    from predictionio_tpu_torch.workflow.evaluate import run_evaluation

    eps = _grid(port_rec, EngineParams, ranks=(3, 4), regs=(0.1,))
    ev = Evaluation(engine=port_rec.engine(),
                    metric=port_rec.PrecisionAtK(k=3), output_path=None)
    result = run_evaluation(ev, eps, evaluation_class="MemEval",
                            device="cpu")
    stored = PortStorage.get_meta_data_evaluation_instances().get_completed()
    assert len(stored) == 1 and stored[0].evaluation_class == "MemEval"
    assert stored[0].evaluator_results == result.to_one_liner()
    js = json.loads(stored[0].evaluator_results_json)
    assert len(js["candidates"]) == len(eps)
    for cand in js["candidates"]:
        assert cand["wallTimeS"] >= 0 and "group" in cand
    assert js["sweep"]["mode"] == "batched"
    assert js["sweep"]["compileGroups"] == 2
    assert stored[0].evaluator_results_html.startswith("<html>")


_EVAL_MODULE = '''
from predictionio_tpu_torch.core.evaluation import Evaluation
from predictionio_tpu_torch.core.params import EngineParams
from predictionio_tpu_torch.engines.recommendation import (
    AlgorithmParams, DataSourceParams, PrecisionAtK, RMSEMetric, engine,
)

def _params(app):
    return [EngineParams(
        data_source_params=DataSourceParams(
            app_name=app, eval_params={"kFold": 3, "queryNum": 5}),
        algorithm_params_list=[("als", AlgorithmParams(
            rank=3, num_iterations=2))])]

evaluation = Evaluation(engine=engine(), metric=PrecisionAtK(k=4),
                        other_metrics=[RMSEMetric()], output_path=BEST)
evaluation.engine_params_list = _params(APP)
failing = Evaluation(engine=engine(), metric=PrecisionAtK(k=4),
                     output_path=None)
failing.engine_params_list = _params("NoSuchApp")
'''


def _eval_module(tmp_path, monkeypatch, name):
    (tmp_path / f"{name}.py").write_text(
        f"BEST = {str(tmp_path / 'best.json')!r}\nAPP = {APP!r}\n"
        + _EVAL_MODULE)
    monkeypatch.syspath_prepend(str(tmp_path))
    sys.modules.pop(name, None)
    return name


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_eval_batched_then_sequential(store, tmp_path, monkeypatch,
                                          capsys):
    from predictionio_tpu_torch.cli.main import main

    mod = _eval_module(tmp_path, monkeypatch, "torch_eval_cli_mod")
    grid = ["--grid", "rank=3,4", "--grid", "reg=0.05,0.5"]
    assert main(["eval", f"{mod}:evaluation", *grid, "--device", "cpu"]) == 0
    batched = _last_json(capsys)
    assert batched["mode"] == "batched" and batched["groups"] == 2
    assert batched["candidates"] == 4 and batched["batch_sizes"] == [6, 6]
    best = json.loads((tmp_path / "best.json").read_text())
    assert best == batched["best_params"]
    assert main(["eval", f"{mod}:evaluation", *grid, "--sequential",
                 "--device", "cpu"]) == 0
    sequential = _last_json(capsys)
    assert sequential["mode"] == "sequential"
    assert sequential["best_idx"] == batched["best_idx"]
    assert "PIO_EVAL_VECTORIZE" not in __import__("os").environ
    stored = PortStorage.get_meta_data_evaluation_instances().get_completed()
    assert len(stored) == 2
    assert {s.evaluation_class for s in stored} == {f"{mod}:evaluation"}


def test_cli_eval_overrides_and_failure(store, tmp_path, monkeypatch, capsys):
    from predictionio_tpu_torch.cli.main import main

    mod = _eval_module(tmp_path, monkeypatch, "torch_eval_cli_mod2")
    assert main(["eval", f"{mod}.evaluation", "--k-fold", "2",
                 "--query-num", "3", "--device", "cpu"]) == 0
    line = _last_json(capsys)
    assert line["batch_sizes"] == [2] and line["candidates"] == 1
    with pytest.raises(SystemExit) as e:
        main(["eval", f"{mod}:failing", "--device", "cpu"])
    assert e.value.code == 1
    assert "[ERROR] Evaluation failed" in capsys.readouterr().out
    statuses = sorted(s.status for s in
                      PortStorage.get_meta_data_evaluation_instances()
                      .get_all())
    assert statuses == ["EVALCOMPLETED", "EVALFAILED"]
    with pytest.raises(SystemExit):
        main(["eval", f"{mod}:evaluation", "--grid", "nope=1",
              "--device", "cpu"])


@pytest.mark.parametrize("flag,message", [
    ("--stop-after-read", "interrupted by --stop-after-read"),
    ("--stop-after-prepare", "interrupted by --stop-after-prepare")])
def test_cli_train_debug_stops(store, tmp_path, capsys, flag, message):
    from predictionio_tpu_torch.cli.main import main

    variant = tmp_path / "engine.json"
    variant.write_text(json.dumps({
        "datasource": {"params": {"appName": APP}},
        "algorithms": [{"name": "als", "params": {"rank": 3,
                                                  "numIterations": 2}}]}))
    assert main(["train", "--variant", str(variant), flag,
                 "--skip-sanity-check", "--device", "cpu"]) == 0
    assert f"[INFO] Training {message}." in capsys.readouterr().out
    instances = PortStorage.get_meta_data_engine_instances().get_all()
    assert [i.status for i in instances] == ["INIT"]
    assert PortStorage.get_model_data_models().get(instances[0].id) is None


# -- the engine's sanity hook, stops and eval ------------------------------------

@dataclasses.dataclass
class _Checked(SanityCheck):
    ok: bool

    def sanity_check(self):
        if not self.ok:
            raise ValueError("bad training data")


def _checked_engine(ok):
    class DS(port_rec.RecommendationDataSource):
        def read_training(self, ctx):
            return _Checked(ok)

    class Prep(port_rec.RecommendationPreparator):
        def prepare(self, ctx, td):
            return ("prepared", td)

    return Engine(DS, Prep, {"als": port_rec.ALSAlgorithm},
                  port_rec.RecommendationServing)


def test_engine_runs_sanity_checks_and_debug_stops():
    ep = port_rec.default_engine_params(APP)
    with pytest.raises(ValueError, match="bad training data"):
        _checked_engine(False).train(CPU, ep)
    with pytest.raises(StopAfterReadInterruption) as e:
        _checked_engine(False).train(CPU, ep, skip_sanity_check=True,
                                     stop_after_read=True)
    assert e.value.training_data == _Checked(False)
    with pytest.raises(StopAfterPrepareInterruption) as e:
        _checked_engine(True).train(CPU, ep, stop_after_prepare=True)
    assert e.value.prepared_data == ("prepared", _Checked(True))


def test_engine_eval_and_batch_eval_train_every_fold():
    engine = _mem_engine(port_rec, _ratings(nu=12, ni=9, per_user=4), Engine)
    eps = _grid(port_rec, EngineParams, ranks=(2,), regs=(0.1, 0.2),
                k_fold=2, query_num=3)
    out = engine.batch_eval(CPU, eps)
    assert [ep for ep, _ in out] == eps
    folds = out[0][1]
    assert [info for info, _ in folds] == [{"fold": 0}, {"fold": 1}]
    assert sum(len(qpa) for _, qpa in folds) == 48
    for _info, qpa in folds:
        for q, p, a in qpa:
            assert q.num == 3 and len(p.item_scores) <= 3
            assert a.ratings[0].user == q.user
