"""Evaluation workflow: metric sweeps over engine params (port of the
reference's ``core/evaluation.py``).

Parity map (reference file:line):
  * Evaluation            <- controller/Evaluation.scala:34-125
  * EngineParamsGenerator <- controller/EngineParamsGenerator.scala:30-46
  * MetricEvaluator       <- controller/MetricEvaluator.scala:185-263
    (evaluateBase:218, best selection:246-249, best.json:252)
  * prefix-memoized sweep <- controller/FastEvalEngine.scala:46-346 —
    rebuilt as CachedEvalRunner: datasource / preparator / per-algorithm
    train results are cached by params-JSON prefix across the sweep, the
    compilation-cache analog of FastEvalEngine's pipeline memoization

The BATCHED sweep: when every candidate in the grid shares its
non-algorithm params, the single algorithm supports ``sweep_eval``
(``models/als_sweep``: k-fold x hyperparameter training over a unit
axis) and the metrics declare a device ``sweep_kind``, the whole grid
trains as a few batched groups (one per distinct rank and solver
family), folds realized as zero-weight masks over one shared data
layout, instead of P x K sequential trains. Anything outside that
contract takes the sequential loop (``PIO_EVAL_VECTORIZE=0`` forces it).
The reference's ``eval_*`` spans and counters are plain numbers in the
result's ``sweep`` info here.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.core.engine import Engine, evaluate_fold
from predictionio_tpu_torch.core.metrics import Metric
from predictionio_tpu_torch.core.params import EngineParams, params_to_json

logger = logging.getLogger("pio.torch.evaluation")

#: set to "0" to force the sequential per-candidate loop
VECTORIZE_ENV = "PIO_EVAL_VECTORIZE"


class EngineParamsGenerator:
    """Supplies the list of EngineParams to sweep (EngineParamsGenerator.scala:30)."""

    engine_params_list: Sequence[EngineParams] = ()


class Evaluation:
    """Glue object tying an Engine to a Metric (Evaluation.scala:34).

    Subclass (declaring engine/metric as class attributes, the reference's
    `engineMetric =` style) or instantiate with engine + metric
    (+ other_metrics). The evaluator writes best.json
    (Evaluation.engineMetric_= sugar, :91-99).
    """

    # class-attribute declaration point for subclasses
    engine: Optional[Engine] = None
    metric: Optional[Metric] = None
    other_metrics: Sequence[Metric] = ()
    output_path: Optional[str] = "best.json"
    #: optional params list carried by the evaluation itself
    engine_params_list: Sequence[EngineParams] = ()

    def __init__(self, engine: Optional[Engine] = None,
                 metric: Optional[Metric] = None,
                 other_metrics: Optional[Sequence[Metric]] = None,
                 output_path: Optional[str] = "__default__"):
        # only override class-level declarations when explicitly given
        if engine is not None:
            self.engine = engine
        if metric is not None:
            self.metric = metric
        if other_metrics is not None:
            self.other_metrics = list(other_metrics)
        if output_path != "__default__":
            self.output_path = output_path

    @property
    def evaluator(self) -> "MetricEvaluator":
        return MetricEvaluator(self.metric, self.other_metrics,
                               self.output_path)

    def run(self, ctx, engine_params_list: Sequence[EngineParams]
            ) -> "MetricEvaluatorResult":
        return self.evaluator.evaluate(ctx, self.engine, engine_params_list)


@dataclasses.dataclass
class MetricEvaluatorResult:
    """MetricEvaluator.scala:64-110 — scores per params with the best pick.

    ``candidate_details`` (parallel to ``engine_params_scores``) carries
    per-candidate wall time and the group that trained it — persisted
    into ``evaluator_results_json`` so `pio eval` output and the
    dashboard can show where sweep time went. ``sweep`` summarizes the
    execution (mode, groups under the reference's ``compileGroups``
    key, units per launch, seconds).
    """

    best_score: float
    best_engine_params: EngineParams
    best_idx: int
    metric_header: str
    other_metric_headers: List[str]
    engine_params_scores: List[Tuple[EngineParams, float, List[float]]]
    candidate_details: List[dict] = dataclasses.field(default_factory=list)
    sweep: Optional[dict] = None

    def to_one_liner(self) -> str:
        return f"[{self.metric_header}] {self.best_score}"

    def to_json_dict(self) -> dict:
        return {
            "bestScore": self.best_score,
            "bestEngineParams": self.best_engine_params.to_json_dict(),
            "bestIdx": self.best_idx,
            "metricHeader": self.metric_header,
            "otherMetricHeaders": self.other_metric_headers,
            "engineParamsScores": [
                {"engineParams": ep.to_json_dict(), "score": s, "others": o}
                for ep, s, o in self.engine_params_scores],
            "candidates": self.candidate_details,
            "sweep": self.sweep,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), sort_keys=True)

    def to_html(self) -> str:
        rows = "".join(
            f"<tr><td>{i}</td><td>{s}</td><td><pre>{ep.to_json()}</pre></td></tr>"
            for i, (ep, s, _o) in enumerate(self.engine_params_scores))
        return (f"<html><body><h1>{self.metric_header}</h1>"
                f"<p>Best score: {self.best_score} "
                f"(params #{self.best_idx})</p>"
                f"<table border=1><tr><th>#</th><th>score</th>"
                f"<th>engine params</th></tr>{rows}</table></body></html>")


class CachedEvalRunner:
    """FastEvalEngine.scala:46-346 rebuilt: memoize shared pipeline prefixes.

    Within one sweep, engine params sharing a prefix reuse results:
      * data source (read_eval folds) keyed by datasource params
      * prepared data keyed by (datasource, preparator) params
      * trained models keyed by (datasource, preparator, single algo params)
    """

    def __init__(self, engine: Engine):
        self.engine = engine
        self._ds_cache: Dict[str, Any] = {}
        self._prep_cache: Dict[str, Any] = {}
        self._model_cache: Dict[str, Any] = {}

    @staticmethod
    def _key(*parts: Any) -> str:
        return json.dumps([_jsonable(p) for p in parts], sort_keys=True,
                          default=str)

    def eval(self, ctx, ep: EngineParams):
        ds_key = self._key(ep.data_source_name, ep.data_source_params)
        if ds_key not in self._ds_cache:
            data_source = self.engine._data_source(ep)
            self._ds_cache[ds_key] = list(data_source.read_eval(ctx))
        eval_data = self._ds_cache[ds_key]

        prep_key = self._key(ds_key, ep.preparator_name, ep.preparator_params)
        if prep_key not in self._prep_cache:
            preparator = self.engine._preparator(ep)
            self._prep_cache[prep_key] = [
                preparator.prepare(ctx, td) for td, _ei, _qa in eval_data]
        prepared = self._prep_cache[prep_key]

        named_algos = self.engine._algorithms(ep)
        serving = self.engine._serving(ep)

        results = []
        for fold_idx, ((td, eval_info, qa_pairs), pd) in enumerate(
                zip(eval_data, prepared)):
            models = []
            for (name, algo), (pname, algo_params) in zip(
                    named_algos, ep.algorithm_params_list):
                model_key = self._key(prep_key, fold_idx, pname, algo_params)
                if model_key not in self._model_cache:
                    self._model_cache[model_key] = algo.train(ctx, pd)
                models.append(self._model_cache[model_key])
            qpa = evaluate_fold(named_algos, models, serving, qa_pairs)
            results.append((eval_info, qpa))
        return results


def _jsonable(p: Any) -> Any:
    try:
        return params_to_json(p)
    except TypeError:
        return repr(p)


# ---------------------------------------------------------------------------
# Device-batched sweep plumbing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EvalGrid:
    """What a DataSource hands the vectorized sweep instead of K
    materialized folds: the FULL eval data (engine-specific payload,
    e.g. rating columns) plus the fold count and per-query settings.
    Produced by an optional ``DataSource.read_eval_grid(ctx)``."""

    data: Any
    k_fold: int
    query_num: int = 10


def expand_param_grid(engine_params_list: Sequence[EngineParams],
                      grid_specs: Sequence[str]) -> List[EngineParams]:
    """Cross-product hyperparameter expansion for `pio eval --grid`.

    Each spec is ``name=v1,v2,...`` overriding a field of the (single)
    algorithm's params; the result is base-params x the full cross
    product, in deterministic order. Values parse as JSON scalars when
    possible (ints/floats/bools), else strings.
    """
    if not grid_specs:
        return list(engine_params_list)
    dims: List[Tuple[str, List[Any]]] = []
    for spec in grid_specs:
        name, sep, vals = spec.partition("=")
        name = name.strip()
        values = [v for v in vals.split(",") if v.strip()]
        if not sep or not name or not values:
            raise ValueError(
                f"--grid spec {spec!r}: expected name=v1,v2,...")
        if any(n == name for n, _ in dims):
            # last-spec-wins would silently drop half the grid
            raise ValueError(f"--grid field {name!r} specified twice")
        parsed = []
        for v in values:
            try:
                parsed.append(json.loads(v))
            except json.JSONDecodeError:
                parsed.append(v.strip())
        dims.append((name, parsed))
    out: List[EngineParams] = []
    for ep in engine_params_list:
        if len(ep.algorithm_params_list) != 1:
            raise ValueError(
                "--grid requires exactly one algorithm per EngineParams "
                f"(got {len(ep.algorithm_params_list)})")
        algo_name, algo_params = ep.algorithm_params_list[0]
        for f, _vals in dims:
            if not hasattr(algo_params, f):
                raise ValueError(
                    f"--grid field {f!r} is not a parameter of "
                    f"{type(algo_params).__name__}")
        for combo in itertools.product(*[vals for _n, vals in dims]):
            new_ap = dataclasses.replace(
                algo_params, **{n: v for (n, _), v in zip(dims, combo)})
            out.append(dataclasses.replace(
                ep, algorithm_params_list=[(algo_name, new_ap)]))
    return out


def sweep_kind_of(metric: Metric) -> Optional[str]:
    """The metric's device ``sweep_kind``, or None when it must stay on
    the sequential path.

    Guards against silent inheritance: a subclass that overrides
    ``calculate``/``calculate_point`` (custom math the device kernel
    knows nothing about) WITHOUT re-declaring ``sweep_kind`` in its own
    body would otherwise inherit the parent's kind and get the stock
    device computation instead of its override. The rule: ``sweep_kind``
    counts only if it is declared at or below the most-derived class
    that overrides the calculation methods.
    """
    cls = type(metric)
    kind_cls = next((k for k in cls.__mro__ if "sweep_kind" in k.__dict__),
                    None)
    if kind_cls is None or kind_cls.__dict__["sweep_kind"] is None:
        return None
    for klass in cls.__mro__:
        if klass is kind_cls:
            return kind_cls.__dict__["sweep_kind"]
        if "calculate" in klass.__dict__ \
                or "calculate_point" in klass.__dict__:
            return None       # customized math below the declaration
    return None


def _try_vectorized_sweep(ctx, engine: Engine,
                          engine_params_list: Sequence[EngineParams],
                          metric: Metric, other_metrics: Sequence[Metric]):
    """The device-batched sweep, when the grid fits its contract; None
    when it doesn't (the caller falls back to the sequential loop).

    Contract: every metric declares a ``sweep_kind``; every candidate
    shares datasource/preparator/serving params and carries exactly ONE
    algorithm (same name across the grid); the algorithm implements
    ``sweep_eval`` and the datasource ``read_eval_grid``. Structural
    mismatches return None cheaply (no data read); real errors past
    that point propagate — a broken sweep must fail loudly, not silently
    retrain P x K times.
    """
    if os.environ.get(VECTORIZE_ENV, "1") == "0":
        return None
    all_metrics = [metric, *other_metrics]
    if any(sweep_kind_of(m) is None for m in all_metrics):
        return None
    eps = list(engine_params_list)
    shared = CachedEvalRunner._key(
        eps[0].data_source_name, eps[0].data_source_params,
        eps[0].preparator_name, eps[0].preparator_params,
        eps[0].serving_name, eps[0].serving_params)
    for ep in eps:
        if len(ep.algorithm_params_list) != 1:
            return None
        if CachedEvalRunner._key(
                ep.data_source_name, ep.data_source_params,
                ep.preparator_name, ep.preparator_params,
                ep.serving_name, ep.serving_params) != shared:
            return None
    algo_names = {ep.algorithm_params_list[0][0] for ep in eps}
    if len(algo_names) != 1:
        return None
    name, algo = engine._algorithms(eps[0])[0]
    if not hasattr(algo, "sweep_eval"):
        return None
    data_source = engine._data_source(eps[0])
    if not hasattr(data_source, "read_eval_grid"):
        return None

    t0 = time.perf_counter()
    grid = data_source.read_eval_grid(ctx)
    read_s = time.perf_counter() - t0
    algo_params = [ep.algorithm_params_list[0][1] for ep in eps]
    sweep = algo.sweep_eval(ctx, grid, algo_params, metric,
                            other_metrics=other_metrics)
    if sweep is None:      # the algorithm declined (unsupported combo)
        return None
    sweep["info"].setdefault("seconds", {})["read"] = read_s
    logger.info("batched eval sweep: %d candidates x %d folds in %d "
                "group(s)", len(eps), grid.k_fold,
                sweep["info"].get("compileGroups", 0))
    return sweep


class MetricEvaluator:
    """MetricEvaluator.scala:185 — score every engine params, pick the best."""

    def __init__(self, metric: Metric, other_metrics: Sequence[Metric] = (),
                 output_path: Optional[str] = "best.json"):
        self.metric = metric
        self.other_metrics = list(other_metrics)
        self.output_path = output_path

    def evaluate(self, ctx, engine: Engine,
                 engine_params_list: Sequence[EngineParams]
                 ) -> MetricEvaluatorResult:
        if not engine_params_list:
            raise ValueError("engine_params_list must not be empty")
        scores: List[Tuple[EngineParams, float, List[float]]] = []
        details: List[dict] = []
        sweep_info: Optional[dict] = None

        vec = _try_vectorized_sweep(ctx, engine, engine_params_list,
                                    self.metric, self.other_metrics)
        if vec is not None:
            for i, (ep, (score, others)) in enumerate(
                    zip(engine_params_list, vec["scores"])):
                scores.append((ep, score, list(others)))
                details.append({"index": i, **vec["details"][i]})
            sweep_info = vec["info"]
        else:
            from predictionio_tpu_torch.obs.eval_stats import (
                eval_candidates_counter,
            )

            runner = CachedEvalRunner(engine)
            for i, ep in enumerate(engine_params_list):
                t0 = time.perf_counter()
                eval_data = runner.eval(ctx, ep)
                score = self.metric.calculate(ctx, eval_data)
                others = [m.calculate(ctx, eval_data)
                          for m in self.other_metrics]
                logger.info("engine params %d/%d: %s = %s",
                            i + 1, len(engine_params_list),
                            self.metric.header(), score)
                scores.append((ep, score, others))
                details.append({
                    "index": i, "group": "sequential",
                    "wallTimeS": round(time.perf_counter() - t0, 4)})
            eval_candidates_counter().inc(len(engine_params_list),
                                          mode="sequential")
            sweep_info = {"mode": "sequential", "compileGroups": None,
                          "batchSizes": [],
                          "candidates": len(engine_params_list)}

        import math

        # NaN scores (e.g. empty folds) can never win; if all are NaN the
        # first is reported so the caller still sees the failure
        best_idx = 0
        for i in range(1, len(scores)):
            cur, best = scores[i][1], scores[best_idx][1]
            if isinstance(cur, float) and math.isnan(cur):
                continue
            if (isinstance(best, float) and math.isnan(best)) \
                    or self.metric.compare(cur, best) > 0:
                best_idx = i
        best_ep, best_score, _ = scores[best_idx]
        result = MetricEvaluatorResult(
            best_score=best_score,
            best_engine_params=best_ep,
            best_idx=best_idx,
            metric_header=self.metric.header(),
            other_metric_headers=[m.header() for m in self.other_metrics],
            engine_params_scores=scores,
            candidate_details=details,
            sweep=sweep_info)
        if self.output_path:
            self._save_best_json(best_ep)
        return result

    def _save_best_json(self, ep: EngineParams) -> None:
        """MetricEvaluator.saveEngineJson:193 — the deployable best variant.

        Temp-write + rename: this file is what `pio deploy` reads, so a
        crash mid-write must leave either the previous best or nothing —
        never a torn JSON that a deploy then ships."""
        tmp = f"{self.output_path}.tmp-{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(ep.to_json_dict(), f, indent=2, sort_keys=True)
            os.replace(tmp, self.output_path)
            logger.info("best engine params written to %s",
                        os.path.abspath(self.output_path))
        except OSError as e:
            logger.warning("cannot write %s: %s", self.output_path, e)
            try:
                os.unlink(tmp)
            except OSError:
                pass
