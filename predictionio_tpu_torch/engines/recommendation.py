"""Recommendation engine (ALS) (port of the reference's
``engines/recommendation.py``: training, serving, the online fold-in
hooks, and evaluation: ``read_eval`` folds for the sequential loop,
``read_eval_grid`` and ``ALSAlgorithm.sweep_eval`` for the batched
sweep, and the ``PrecisionAtK`` and ``RMSEMetric`` metrics).

Rate/buy events -> ratings -> ALS -> top-N item scores per user. Rate
events keep their ``rating`` property; buy events weigh 4.0 and view
events 1.0 (DataSource.scala:61-73). Wire format (quickstart): query
{"user": "1", "num": 4} -> {"itemScores": [{"item": "22", "score":
4.07}, ...]}; ``blackList`` excludes items and ``whiteList`` restricts
the answer to its items.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.core.base import (
    Algorithm, DataSource, FirstServing, Preparator,
)
from predictionio_tpu_torch.core.engine import Engine
from predictionio_tpu_torch.core.metrics import (
    AverageMetric, OptionAverageMetric,
)
from predictionio_tpu_torch.core.params import EngineParams, Params
from predictionio_tpu_torch.data.bimap import assign_indices
from predictionio_tpu_torch.data.eventstore import property_column
from predictionio_tpu_torch.engines.common import resolved_als_solver
from predictionio_tpu_torch.models.als import (
    ALSData, ALSModel, ALSParams, train_als,
)

logger = logging.getLogger("pio.torch.engine.recommendation")


# -- data types ---------------------------------------------------------------

@dataclasses.dataclass
class Rating:
    user: str
    item: str
    rating: float


@dataclasses.dataclass
class RatingColumns:
    """The rating set as three parallel arrays straight from the event
    store's columnar read, no per-event Python objects."""

    users: np.ndarray    # object (string ids)
    items: np.ndarray    # object
    values: np.ndarray   # float32

    def __len__(self) -> int:
        return len(self.values)


@dataclasses.dataclass
class TrainingData:
    """The rating set as rows (``ratings``) or columns (``columns``,
    the training path); ``as_columns()`` converts on demand."""

    ratings: Optional[List[Rating]] = None
    columns: Optional[RatingColumns] = None

    def as_columns(self) -> RatingColumns:
        if self.columns is not None:
            return self.columns
        rs = self.ratings or []
        return RatingColumns(
            users=np.asarray([r.user for r in rs], dtype=object),
            items=np.asarray([r.item for r in rs], dtype=object),
            values=np.asarray([r.rating for r in rs], dtype=np.float32))

    def __len__(self) -> int:
        return (len(self.columns) if self.columns is not None
                else len(self.ratings or ()))


@dataclasses.dataclass
class PreparedData:
    ratings: Optional[List[Rating]] = None
    columns: Optional[RatingColumns] = None

    as_columns = TrainingData.as_columns
    __len__ = TrainingData.__len__


@dataclasses.dataclass(frozen=True)
class Query:
    """Quickstart query plus the blacklist / whitelist filters. JSON
    keys: "blackList" / "whiteList"."""

    user: str
    num: int
    black_list: Optional[Tuple[str, ...]] = None
    white_list: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass
class PredictedResult:
    item_scores: List[ItemScore]

    def to_dict(self) -> dict:
        return {"itemScores": [{"item": s.item, "score": s.score}
                               for s in self.item_scores]}


@dataclasses.dataclass
class ActualResult:
    ratings: List[Rating]


@dataclasses.dataclass
class DataSourceParams(Params):
    """Default = the customize-serving variant (rate + buy); the
    train-with-view-event variant sets eventNames=["view"]."""

    app_name: str
    eval_params: Optional[dict] = None  # {"kFold": 5, "queryNum": 10}
    #: which events become ratings; None = ["rate", "buy"]
    event_names: Optional[List[str]] = None
    #: rating per non-"rate" event; None = {"buy": 4.0, "view": 1.0}
    event_weights: Optional[dict] = None


class RecommendationDataSource(DataSource):
    """DataSource.scala:39 — rate events keep their rating property; buy
    events become implicit rating 4.0 (:61-73); view events weigh 1.0."""

    params_class = DataSourceParams
    DEFAULT_WEIGHTS = {"buy": 4.0, "view": 1.0}

    def __init__(self, params: DataSourceParams):
        self.params = params

    def _read_columns(self) -> RatingColumns:
        """The columnar training read: (user, item, value) arrays out of
        the event store, with no per-event objects.

        In a multi-process run the read is partitioned
        (``training_scan(sharded=True)``): each process reads only its
        shard of one snapshot, and the algorithm re-keys rows to their
        owners (``models/als.build_distributed``)."""
        from predictionio_tpu_torch.data.ingest import training_scan
        from predictionio_tpu_torch.parallel.distributed import (
            group_rank_size,
        )

        names = self.params.event_names or ["rate", "buy"]
        weights = {**self.DEFAULT_WEIGHTS,
                   **(self.params.event_weights or {})}
        scan = training_scan(
            self.params.app_name, sharded=True, entity_type="user",
            event_names=names, target_entity_type="item",
            columns=("event", "entity_id", "target_entity_id",
                     "properties"))
        cols = scan.columns
        events = cols["event"]
        is_rate = events == "rate"
        values = np.empty(len(events), np.float32)
        for name in set(events.tolist()):
            if name != "rate":
                values[events == name] = float(weights.get(name, 1.0))
        if is_rate.any():
            # parse only the rate rows' properties
            values[is_rate] = property_column(cols["properties"][is_rate],
                                              "rating")
        bad = bool(np.isnan(values[is_rate]).any())
        if group_rank_size()[1] > 1:
            # a data error lives in ONE process's shard; the raise is
            # collective, or the others wait forever in the training
            # collectives downstream
            from predictionio_tpu_torch.parallel.shuffle import (
                allgather_object,
            )

            bad = any(allgather_object(bad))
        if bad:
            raise ValueError(
                "rate event without a rating property "
                "(DataSource.scala:66 MatchError parity)")
        # a store that cannot partition read the full set everywhere:
        # keep a disjoint strided slice so the exchange by owner sees
        # each rating once
        users, items, values = scan.local_slice(
            (cols["entity_id"], cols["target_entity_id"], values))
        return RatingColumns(users=users, items=items, values=values)

    def read_training(self, ctx) -> TrainingData:
        return TrainingData(columns=self._read_columns())

    def _read_ratings(self) -> List[Rating]:
        c = self._read_columns()
        return [Rating(user=u, item=i, rating=float(v))
                for u, i, v in zip(c.users, c.items, c.values)]

    def read_eval(self, ctx):
        """K-fold split of the training read's rows, in its order
        (DataSource.scala:87-120; ``core/cross_validation``): each
        held-out rating is one query of its user with that rating as
        the actual."""
        from predictionio_tpu_torch.core.cross_validation import k_fold

        ep = self.params.eval_params or {}
        k = int(ep.get("kFold", 3))
        query_num = int(ep.get("queryNum", 10))
        folds = []
        for fold, (train, test) in enumerate(k_fold(self._read_ratings(),
                                                    k)):
            qa = [(Query(user=r.user, num=query_num),
                   ActualResult(ratings=[r])) for r in test]
            folds.append((TrainingData(ratings=train), {"fold": fold}, qa))
        return folds

    def read_eval_grid(self, ctx):
        """One read for the whole batched sweep: the rating columns and
        the fold count; the sweep assigns folds as index mod k over the
        same rows, the assignment ``read_eval`` uses."""
        from predictionio_tpu_torch.core.evaluation import EvalGrid

        ep = self.params.eval_params or {}
        return EvalGrid(data=self._read_columns(),
                        k_fold=int(ep.get("kFold", 3)),
                        query_num=int(ep.get("queryNum", 10)))


class RecommendationPreparator(Preparator):
    """Template passthrough preparator (Preparator.scala parity)."""

    def prepare(self, ctx, td: TrainingData) -> PreparedData:
        return PreparedData(ratings=td.ratings, columns=td.columns)


@dataclasses.dataclass
class AlgorithmParams(Params):
    """ALSAlgorithm.scala params as engine.json carries them: rank,
    numIterations, lambda, seed (+ implicitPrefs, alpha)."""

    json_aliases = {"lambda": "reg"}

    rank: int = 10
    num_iterations: int = 10
    reg: float = 0.01
    seed: int = 3
    implicit_prefs: bool = False
    alpha: float = 1.0
    #: training-solver selection: {"mode": "full"|"subspace",
    #: "block_size": N} — None defers to server.json "train" /
    #: PIO_ALS_SOLVER (utils/server_config.als_solver_config)
    solver: Optional[dict] = None


def _request(q: Query):
    return (q.user, q.num, tuple(q.black_list or ()),
            tuple(q.white_list) if q.white_list is not None else None)


class ALSAlgorithm(Algorithm):
    """ALSAlgorithm.scala:39 — id assignment and ALS training; serving
    from the trained model. Training runs on ``ctx.device`` (None or
    absent: ``cuda``) and resumes from ``ctx.checkpointer`` when the
    workflow has one."""

    params_class = AlgorithmParams

    def __init__(self, params: Optional[AlgorithmParams] = None):
        self.params = params or AlgorithmParams()

    def train(self, ctx, pd: PreparedData) -> ALSModel:
        from predictionio_tpu_torch.parallel.distributed import (
            group_rank_size,
        )
        from predictionio_tpu_torch.workflow.context import mesh_of

        multiproc = group_rank_size()[1] > 1
        n = len(pd)
        if multiproc:
            # the emptiness that matters is global: a process whose
            # shard is empty still joins the collectives below
            from predictionio_tpu_torch.parallel.shuffle import (
                allgather_object,
            )

            n = sum(allgather_object(n))
        if not n:
            raise ValueError(
                "No ratings found. Check the appName or import data first "
                "(ALSAlgorithm.scala:55 empty-check parity).")
        cols = pd.as_columns()
        mesh = mesh_of(ctx)
        t0 = time.perf_counter()
        if multiproc:
            # the partitioned pipeline: `cols` holds this process's shard;
            # ids come from a collective vocabulary union and rows reach
            # their owners through one exchange inside build_distributed
            from predictionio_tpu_torch.models.als import build_distributed
            from predictionio_tpu_torch.parallel.shuffle import global_vocab

            user_vocab = global_vocab(np.asarray(cols.users))
            item_vocab = global_vocab(np.asarray(cols.items))
            user_codes = np.searchsorted(user_vocab, cols.users)
            item_codes = np.searchsorted(item_vocab, cols.items)
            data = build_distributed(mesh, user_codes, item_codes,
                                     cols.values, len(user_vocab),
                                     len(item_vocab))
        else:
            user_vocab, user_codes = assign_indices(cols.users)
            item_vocab, item_codes = assign_indices(cols.items)
            data = ALSData.build(user_codes, item_codes, cols.values,
                                 len(user_vocab), len(item_vocab),
                                 n_shards=mesh.size)
        build_s = time.perf_counter() - t0
        solver, block_size = resolved_als_solver(self.params, logger)
        als_params = ALSParams(
            rank=self.params.rank,
            num_iterations=self.params.num_iterations,
            reg=self.params.reg,
            seed=self.params.seed,
            implicit_prefs=self.params.implicit_prefs,
            alpha=self.params.alpha,
            solver=solver, block_size=block_size)
        from predictionio_tpu_torch.workflow.checkpoint import (
            checkpointer_of,
        )

        device = getattr(ctx, "device", None)
        t0 = time.perf_counter()
        U, V = train_als(data, als_params, mesh=mesh,
                         checkpointer=checkpointer_of(ctx))
        model = ALSModel.from_arrays(user_vocab, item_vocab, U, V,
                                     device=device)
        model.train_info = {"nnz": data.nnz, "build_s": build_s,
                            "solve_s": time.perf_counter() - t0}
        return model

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(self, model: ALSModel, queries):
        """One batched scoring for the whole batch (the micro-batch
        path)."""
        recs = model.recommend_batch([_request(q) for _, q in queries])
        return [
            (i, PredictedResult(item_scores=[
                ItemScore(item=it, score=s) for it, s in r]))
            for (i, _), r in zip(queries, recs)]

    def batch_predict_columnar(self, model: ALSModel, queries):
        """The offline lane of ``workflow/batch_predict``: the scores of
        :meth:`batch_predict`, returned as the JSON-ready wire dicts
        directly, without an ``ItemScore`` a recommended item. Its
        serialized output is byte-identical to ``batch_predict``'s."""
        recs = model.recommend_batch([_request(q) for _, q in queries])
        return [
            (i, {"itemScores": [{"item": it, "score": s} for it, s in r]})
            for (i, _), r in zip(queries, recs)]

    def warmup_query(self, model: ALSModel) -> Optional[Query]:
        """Deploy warm-up probe: any known user drives the bucketed
        scorer family."""
        if model is None or not len(model.user_vocab):
            return None
        return Query(user=str(model.user_vocab[0]), num=10)

    # -- online fold-in (deploy/foldin.py) -----------------------------------
    def foldin_spec(self, model: ALSModel, engine_params):
        """The fold-in contract: the training read's event->rating
        mapping (rate keeps its rating property; buy/view weigh per
        DataSourceParams), each event one rating row, and both sides
        fold (a new item's row is solved from its raters against the
        updated user factors)."""
        from predictionio_tpu_torch.deploy.foldin import FoldinSpec

        ds = getattr(engine_params, "data_source_params", None)
        app_name = getattr(ds, "app_name", None)
        if model is None or not app_name:
            return None
        names = tuple(getattr(ds, "event_names", None) or ["rate", "buy"])
        weights = {**RecommendationDataSource.DEFAULT_WEIGHTS,
                   **(getattr(ds, "event_weights", None) or {})}
        return FoldinSpec(
            app_name=app_name,
            als_params=ALSParams(
                rank=self.params.rank, reg=self.params.reg,
                alpha=self.params.alpha,
                implicit_prefs=self.params.implicit_prefs,
                seed=self.params.seed),
            event_names=names, event_weights=weights,
            rate_event="rate" if "rate" in names else None,
            aggregate="rows", fold_items=True)

    def foldin_factors(self, model: ALSModel):
        from predictionio_tpu_torch.deploy.foldin import FoldinFactors

        return FoldinFactors(user_vocab=model.user_vocab,
                             item_vocab=model.item_vocab,
                             U=model.U, V=model.V,
                             device_copy=lambda: model.V_device)

    def foldin_apply(self, model: ALSModel, spec, user_rows, item_rows,
                     counts) -> ALSModel:
        """The drifted model. A user-only fold keeps V (the same array),
        so it carries the base's resident V copy and quantized scorer:
        nothing is re-uploaded or requantized. An item fold changes V:
        the next scored batch uploads V and rebuilds the scorer."""
        from predictionio_tpu_torch.deploy.foldin import upsert_factor_rows

        user_vocab, U = upsert_factor_rows(model.user_vocab, model.U,
                                           user_rows)
        item_vocab, V = upsert_factor_rows(model.item_vocab, model.V,
                                           item_rows)
        new = ALSModel(user_vocab=user_vocab, item_vocab=item_vocab,
                       U=U, V=V, device=model.device)
        # both caches are keyed on V's identity, so an item fold misses
        # them as it must
        for attr in ("_resident", "_scorer_cache"):
            cached = getattr(model, attr, None)
            if cached is not None:
                setattr(new, attr, cached)
        return new


    #: metric kinds ``sweep_eval`` computes on the device
    SWEEP_KINDS = ("precision_at_k", "topn_mse", "zero")

    def sweep_eval(self, ctx, grid, algo_params_list, metric,
                   other_metrics=()):
        """The batched k-fold x hyperparameter sweep (``pio eval``):
        every (candidate, fold) unit of a group trains together over one
        fold-masked layout, and the metrics are computed on the device
        (``models/als_sweep``), on ``ctx.device``. Returns the
        evaluator's sweep contract (``{scores, details, info}``), or
        None to decline (a metric kind it cannot compute, two precision
        settings in one sweep, or a multi-process run)."""
        from predictionio_tpu_torch.core.cross_validation import (
            fold_assignments,
        )
        from predictionio_tpu_torch.core.evaluation import sweep_kind_of
        from predictionio_tpu_torch.parallel.distributed import (
            group_rank_size,
        )

        if group_rank_size()[1] > 1:
            # a multi-process read is sharded a process; the sweep builds
            # from one process's view, so the sequential path runs instead
            return None
        from predictionio_tpu_torch.models.als_sweep import (
            build_sweep_data, run_sweep,
        )
        from predictionio_tpu_torch.utils.server_config import (
            TrainConfig, als_solver_config, read_server_json,
        )

        metrics = [metric, *other_metrics]
        kinds = [sweep_kind_of(m) for m in metrics]
        if any(k not in self.SWEEP_KINDS for k in kinds):
            return None
        prec_specs = {(m.k, m.rating_threshold)
                      for m, k in zip(metrics, kinds)
                      if k == "precision_at_k"}
        if len(prec_specs) > 1:       # one rank pass per sweep
            return None

        cols = grid.data
        fold_of = fold_assignments(grid.k_fold, len(cols))
        t0 = time.perf_counter()
        user_vocab, user_codes = assign_indices(cols.users)
        item_vocab, item_codes = assign_indices(cols.items)
        data = build_sweep_data(user_codes, item_codes, cols.values,
                                fold_of, len(user_vocab), len(item_vocab))
        build_s = time.perf_counter() - t0
        # the server.json train section, read once for every candidate
        train_cfg = TrainConfig.from_env(
            read_server_json().get("train") or {})

        def with_solver(p):
            solver, block_size = als_solver_config(
                getattr(p, "solver", None), config=train_cfg)
            return ALSParams(
                rank=p.rank, num_iterations=p.num_iterations, reg=p.reg,
                seed=p.seed, implicit_prefs=p.implicit_prefs, alpha=p.alpha,
                solver=solver, block_size=block_size)

        candidates = [with_solver(p) for p in algo_params_list]
        needs_rank = any(k in ("precision_at_k", "topn_mse") for k in kinds)
        if prec_specs:
            pk, threshold = next(iter(prec_specs))
        else:
            pk, threshold = grid.query_num, 2.0
        rank_spec = ((grid.query_num, pk, threshold)
                     if needs_rank else None)
        result = run_sweep(data, candidates, rank_metrics=rank_spec,
                           device=getattr(ctx, "device", None))

        def score_of(m, c):
            kind = sweep_kind_of(m)
            if kind == "precision_at_k":
                return c.precision
            if kind == "topn_mse":
                return c.topn_mse
            return 0.0

        scores = [(score_of(metric, c),
                   [score_of(m, c) for m in other_metrics])
                  for c in result.candidates]
        details = [c.to_json_dict() for c in result.candidates]
        info = {"mode": result.mode, "compileGroups": result.n_groups,
                "batchSizes": result.batch_sizes, "kFold": grid.k_fold,
                "candidates": len(candidates),
                "seconds": {"build": build_s, **result.seconds}}
        return {"scores": scores, "details": details, "info": info}


class RecommendationServing(FirstServing):
    """First prediction wins."""


# -- metrics ------------------------------------------------------------------

class PrecisionAtK(OptionAverageMetric):
    """Evaluation.scala:32-105 — the share of the top-k that is positive
    (actual rating >= threshold); None when the actual is not
    rateable."""

    sweep_kind = "precision_at_k"

    def __init__(self, k: int = 10, rating_threshold: float = 2.0):
        self.k = k
        self.rating_threshold = rating_threshold

    def header(self) -> str:
        return f"Precision@{self.k} (threshold={self.rating_threshold})"

    def calculate_point(self, eval_info, query: Query,
                        prediction: PredictedResult, actual: ActualResult):
        positives = {r.item for r in actual.ratings
                     if r.rating >= self.rating_threshold}
        if not positives:
            return None
        top = [s.item for s in prediction.item_scores[:self.k]]
        if not top:
            return 0.0
        return len(positives & set(top)) / min(self.k, len(top))


class RMSEMetric(AverageMetric):
    """Held-out squared error of the predicted score for (user, item):
    the item's served score, or 0 when it is not served."""

    smaller_is_better = True
    sweep_kind = "topn_mse"

    def header(self) -> str:
        return "MSE (sqrt for RMSE)"

    def calculate_point(self, eval_info, query, prediction, actual):
        by_item = {s.item: s.score for s in prediction.item_scores}
        errs = [(by_item.get(r.item, 0.0) - r.rating) ** 2
                for r in actual.ratings]
        return float(np.mean(errs)) if errs else 0.0


def engine() -> Engine:
    """EngineFactory (Engine.scala:41-49 template parity)."""
    return Engine(
        data_source_classes=RecommendationDataSource,
        preparator_classes=RecommendationPreparator,
        algorithm_classes={"als": ALSAlgorithm},
        serving_classes=RecommendationServing,
    )


def default_engine_params(app_name: Optional[str] = None,
                          **algo_overrides) -> EngineParams:
    """Engine params of the template: the data source reads
    ``app_name`` (None: a deploy-only params set), one ``als``
    algorithm with ``algo_overrides``."""
    return EngineParams(
        data_source_params=(DataSourceParams(app_name=app_name)
                            if app_name is not None else None),
        algorithm_params_list=[("als", AlgorithmParams(**algo_overrides))],
    )
