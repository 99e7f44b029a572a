"""Recommendation engine (ALS), serving side (port of the reference's
``engines/recommendation.py``).

Wire format (quickstart): query {"user": "1", "num": 4} ->
{"itemScores": [{"item": "22", "score": 4.07}, ...]}; ``blackList``
excludes items and ``whiteList`` restricts the answer to its items.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from predictionio_tpu_torch.core.base import Algorithm, FirstServing
from predictionio_tpu_torch.core.engine import Engine
from predictionio_tpu_torch.core.params import EngineParams, Params
from predictionio_tpu_torch.models.als import ALSModel


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
class AlgorithmParams(Params):
    """ALS params as engine.json carries them (rank, numIterations,
    lambda, seed, ...). Serving reads none of them; they are parsed so an
    engine.json written for the reference deploys unchanged."""

    json_aliases = {"lambda": "reg"}

    rank: int = 10
    num_iterations: int = 10
    reg: float = 0.01
    seed: int = 3
    implicit_prefs: bool = False
    alpha: float = 1.0
    solver: Optional[dict] = None


def _request(q: Query):
    return (q.user, q.num, tuple(q.black_list or ()),
            tuple(q.white_list) if q.white_list is not None else None)


class ALSAlgorithm(Algorithm):
    """Serving side of the reference's ALSAlgorithm."""

    params_class = AlgorithmParams

    def __init__(self, params: Optional[AlgorithmParams] = None):
        self.params = params or AlgorithmParams()

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
    return Engine(algorithm_classes={"als": ALSAlgorithm},
                  serving_classes=RecommendationServing)


def default_engine_params(**algo_overrides) -> EngineParams:
    return EngineParams(
        algorithm_params_list=[("als", AlgorithmParams(**algo_overrides))])
