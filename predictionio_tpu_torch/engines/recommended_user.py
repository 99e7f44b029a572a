"""Recommended-user engine (user-to-user similarity) (port of the
reference's ``engines/recommended_user.py``, the recommended-user
template): "follow" events between users train an implicit-ALS user
embedding; a query names one or more users and gets back the users most
similar to them.

  * DataSource — users from ``$set`` aggregateProperties, user -> user
    "follow" events; follows whose ids are not ``$set`` users are dropped
  * ALSAlgorithm — trainImplicit on (follower, followed, 1) triples; the
    model keeps the FOLLOWED side's factors, row-normalized, and scores
    candidates by summed cosine similarity to the query users' vectors,
    score > 0 only (one matvec, numpy on the host as in the reference)
  * Serving — the first prediction wins

Query: {"users": [...], "num": N, "whiteList"?, "blackList"?}; result:
{"similarUserScores": [{"user": ..., "score": ...}]}.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.core.base import (
    Algorithm, DataSource, FirstServing, Preparator,
)
from predictionio_tpu_torch.core.engine import Engine
from predictionio_tpu_torch.core.params import EngineParams, Params
from predictionio_tpu_torch.data.bimap import (
    assign_indices, batch_lookup, vocab_index,
)
from predictionio_tpu_torch.data.eventstore import EventStoreClient
from predictionio_tpu_torch.data.ingest import aggregate_scan, pair_counts
from predictionio_tpu_torch.engines.common import resolved_als_solver
from predictionio_tpu_torch.models.als import ALSData, ALSParams, train_als

logger = logging.getLogger("pio.torch.engine.recommended_user")


@dataclasses.dataclass
class FollowColumns:
    """Columnar user -> user follow edges from the event read."""

    users: np.ndarray           # object (follower ids)
    followed: np.ndarray        # object (followed ids)
    times: np.ndarray           # int64 epoch ms

    def __len__(self) -> int:
        return len(self.users)


@dataclasses.dataclass
class TrainingData:
    users: Dict[str, dict]
    follows: FollowColumns


PreparedData = TrainingData


@dataclasses.dataclass(frozen=True)
class Query:
    users: Tuple[str, ...]
    num: int
    white_list: Optional[Tuple[str, ...]] = None
    black_list: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        object.__setattr__(self, "users", tuple(self.users))
        for f in ("white_list", "black_list"):
            v = getattr(self, f)
            if v is not None:
                object.__setattr__(self, f, tuple(v))


@dataclasses.dataclass
class SimilarUserScore:
    user: str
    score: float


@dataclasses.dataclass
class PredictedResult:
    similar_user_scores: List[SimilarUserScore]

    def to_dict(self) -> dict:
        return {"similarUserScores": [{"user": s.user, "score": s.score}
                                      for s in self.similar_user_scores]}


@dataclasses.dataclass
class DataSourceParams(Params):
    app_name: str


class RecommendedUserDataSource(DataSource):
    """DataSource.scala parity: users from aggregated ``$set``s plus
    user -> user "follow" events."""

    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.params = params

    def read_training(self, ctx) -> TrainingData:
        app = self.params.app_name
        users = {uid: dict(pm.fields) for uid, pm in
                 aggregate_scan(app, "user").items()}
        cols = EventStoreClient.training_columns(
            app, entity_type="user", event_names=["follow"],
            target_entity_type="user",
            columns=("entity_id", "target_entity_id", "event_time_ms"))
        return TrainingData(users=users, follows=FollowColumns(
            cols["entity_id"], cols["target_entity_id"],
            cols["event_time_ms"]))


class RecommendedUserPreparator(Preparator):
    def prepare(self, ctx, td: TrainingData) -> PreparedData:
        return td


@dataclasses.dataclass
class ALSAlgorithmParams(Params):
    json_aliases = {"lambda": "reg"}

    rank: int = 10
    num_iterations: int = 20
    reg: float = 0.01
    alpha: float = 1.0
    seed: int = 3
    #: {"mode": "full"|"subspace", "block_size": N}; None defers to
    #: server.json "train" / PIO_ALS_SOLVER
    solver: Optional[dict] = None


@dataclasses.dataclass
class RecommendedUserModel:
    """The followed side's factors and ids (ALSModel in the reference:
    similarUserFeatures / similarUserStringIntMap) and the ``$set`` user
    fields."""

    user_vocab: np.ndarray           # followed users with factors, sorted
    V: np.ndarray                    # [n_users, K] row-normalized
    users: Dict[str, dict]
    device: Optional[torch.device] = None

    def user_index(self, user_id: str) -> Optional[int]:
        return vocab_index(self.user_vocab, user_id)


class ALSAlgorithm(Algorithm):
    """ALSAlgorithm.scala parity: implicit ALS over the follow graph, on
    ``ctx.device`` (None or absent: ``cuda``)."""

    params_class = ALSAlgorithmParams

    def __init__(self, params: Optional[ALSAlgorithmParams] = None):
        self.params = params or ALSAlgorithmParams()

    def train(self, ctx, pd: PreparedData) -> RecommendedUserModel:
        if not len(pd.follows):
            raise ValueError("follow events cannot be empty "
                             "(ALSAlgorithm.scala require parity)")
        if not pd.users:
            raise ValueError("users cannot be empty (use $set user events)")
        # follows whose ids miss the $set user set are dropped (the
        # reference's uindex == -1 filter)
        known = np.unique(np.asarray(list(pd.users), dtype=object))
        valid = ((batch_lookup(known, pd.follows.users) >= 0)
                 & (batch_lookup(known, pd.follows.followed) >= 0))
        # each follow is confidence 1; repeats sum, as MLlib
        # trainImplicit aggregates duplicate triples
        followers, followed, values = pair_counts(
            pd.follows.users[valid], pd.follows.followed[valid])
        if not len(values):
            raise ValueError("no follow events with valid user ids "
                             "(mllibRatings require parity)")
        f_vocab, f_codes = assign_indices(followers)
        t_vocab, t_codes = assign_indices(followed)
        data = ALSData.build(f_codes, t_codes, values, len(f_vocab),
                             len(t_vocab))
        solver, block = resolved_als_solver(self.params, logger)
        device = getattr(ctx, "device", None)
        _, V = train_als(data, ALSParams(
            rank=self.params.rank,
            num_iterations=self.params.num_iterations,
            reg=self.params.reg, alpha=self.params.alpha,
            implicit_prefs=True, seed=self.params.seed,
            solver=solver, block_size=block), device=device)
        norms = np.linalg.norm(V, axis=1, keepdims=True)
        V = V / np.where(norms == 0, 1.0, norms)
        return RecommendedUserModel(user_vocab=t_vocab, V=V,
                                    users=pd.users, device=device)

    def warmup_query(self, model: RecommendedUserModel) -> Optional[Query]:
        if model is None or not len(model.user_vocab):
            return None
        return Query(users=(str(model.user_vocab[0]),), num=10)

    def predict(self, model: RecommendedUserModel,
                query: Query) -> PredictedResult:
        def index_set(ids) -> set:
            return {i for i in (model.user_index(u) for u in ids)
                    if i is not None}

        query_idx = index_set(query.users)
        if not query_idx:
            return PredictedResult(similar_user_scores=[])
        # summed cosine over every candidate: V is row-normalized, so the
        # per-user cosine sum is one matvec V @ sum(q_vecs)
        scores = model.V @ model.V[sorted(query_idx)].sum(axis=0)
        white = (index_set(query.white_list)
                 if query.white_list is not None else None)
        black = index_set(query.black_list or ())
        out = []
        for idx in np.argsort(-scores):
            idx = int(idx)
            if scores[idx] <= 0:       # the reference keeps score > 0
                break
            if idx in query_idx or idx in black:
                continue
            if white is not None and idx not in white:
                continue
            out.append(SimilarUserScore(user=str(model.user_vocab[idx]),
                                        score=float(scores[idx])))
            if len(out) >= query.num:
                break
        return PredictedResult(similar_user_scores=out)


class RecommendedUserServing(FirstServing):
    """Serving.scala parity: the first prediction wins."""


def engine() -> Engine:
    """RecommendedUserEngine factory (Engine.scala parity)."""
    return Engine(
        data_source_classes=RecommendedUserDataSource,
        preparator_classes=RecommendedUserPreparator,
        algorithm_classes={"als": ALSAlgorithm},
        serving_classes=RecommendedUserServing,
    )


def default_engine_params(app_name: str, **algo_overrides) -> EngineParams:
    return EngineParams(
        data_source_params=DataSourceParams(app_name=app_name),
        algorithm_params_list=[("als", ALSAlgorithmParams(**algo_overrides))],
    )
