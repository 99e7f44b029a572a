"""Recommendation engine (ALS) (port of the reference's
``engines/recommendation.py``, training and serving; the evaluation
side comes with a later slice).

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
from predictionio_tpu_torch.core.params import EngineParams, Params
from predictionio_tpu_torch.data.bimap import assign_indices
from predictionio_tpu_torch.data.eventstore import (
    EventStoreClient, property_column,
)
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
        the event store, with no per-event objects."""
        names = self.params.event_names or ["rate", "buy"]
        weights = {**self.DEFAULT_WEIGHTS,
                   **(self.params.event_weights or {})}
        cols = EventStoreClient.training_columns(
            self.params.app_name, entity_type="user", event_names=names,
            target_entity_type="item",
            columns=("event", "entity_id", "target_entity_id",
                     "properties"))
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
        if np.isnan(values[is_rate]).any():
            raise ValueError(
                "rate event without a rating property "
                "(DataSource.scala:66 MatchError parity)")
        return RatingColumns(users=cols["entity_id"],
                             items=cols["target_entity_id"], values=values)

    def read_training(self, ctx) -> TrainingData:
        return TrainingData(columns=self._read_columns())


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
    absent: ``cuda``)."""

    params_class = AlgorithmParams

    def __init__(self, params: Optional[AlgorithmParams] = None):
        self.params = params or AlgorithmParams()

    def train(self, ctx, pd: PreparedData) -> ALSModel:
        if not len(pd):
            raise ValueError(
                "No ratings found. Check the appName or import data first "
                "(ALSAlgorithm.scala:55 empty-check parity).")
        cols = pd.as_columns()
        t0 = time.perf_counter()
        user_vocab, user_codes = assign_indices(cols.users)
        item_vocab, item_codes = assign_indices(cols.items)
        data = ALSData.build(user_codes, item_codes, cols.values,
                             len(user_vocab), len(item_vocab))
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
        device = getattr(ctx, "device", None)
        t0 = time.perf_counter()
        U, V = train_als(data, als_params, device=device)
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

    def warmup_query(self, model: ALSModel) -> Optional[Query]:
        """Deploy warm-up probe: any known user drives the bucketed
        scorer family."""
        if model is None or not len(model.user_vocab):
            return None
        return Query(user=str(model.user_vocab[0]), num=10)


class RecommendationServing(FirstServing):
    """First prediction wins."""


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
