"""Similar-product engine (implicit ALS + cooccurrence, multi-algorithm)
(port of the reference's ``engines/similarproduct.py``, the
multi-events-multi-algos template): users and items from ``$set``
aggregateProperties, view and like/dislike events, three algorithms
sharing one Query/PredictedResult shape:

  * ``als``          — implicit ALS on deduplicated view counts; predict
    is the summed cosine similarity between the query items' factors and
    every item's (one matvec over row-normalized V)
  * ``cooccurrence`` — the top-N cooccurring items
    (``models/cooccurrence``)
  * ``likealgo``     — the latest like/dislike per (user, item), like = +1
    and dislike = -1, into implicit ALS

Query: {"items": [...], "num": N, "categories"?, "whiteList"?,
"blackList"?}; result: {"itemScores": [{"item": ..., "score": ...}]}.
Serving is FirstServing. Batches of the ALS algorithms without
category or white-list filters score through the two-stage scorer
(``ops/scoring``, the shortlist kernel on the card) unless the scorer
mode is exact.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.core.base import (
    Algorithm, DataSource, FirstServing, Preparator,
)
from predictionio_tpu_torch.core.engine import Engine
from predictionio_tpu_torch.core.params import EngineParams, Params
from predictionio_tpu_torch.data.bimap import assign_indices, vocab_index
from predictionio_tpu_torch.data.eventstore import EventStoreClient
from predictionio_tpu_torch.data.ingest import (
    aggregate_scan, intern_pairs, latest_per_pair, pair_counts,
)
from predictionio_tpu_torch.engines.common import (
    InteractionColumns, Item, ItemScore, PredictedResult, categories_match,
    item_meta_join, resolved_als_solver,
)
from predictionio_tpu_torch.models.als import ALSData, ALSParams, train_als
from predictionio_tpu_torch.workflow.context import mesh_of
from predictionio_tpu_torch.models.cooccurrence import (
    CooccurrenceModel, train_cooccurrence,
)
from predictionio_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("pio.torch.engine.similarproduct")


# -- data types ---------------------------------------------------------------

@dataclasses.dataclass
class TrainingData:
    users: Dict[str, dict]
    items: Dict[str, Item]
    views: InteractionColumns
    likes: InteractionColumns


PreparedData = TrainingData


@dataclasses.dataclass(frozen=True)
class Query:
    items: Tuple[str, ...]
    num: int
    categories: Optional[Tuple[str, ...]] = None
    white_list: Optional[Tuple[str, ...]] = None
    black_list: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        object.__setattr__(self, "items", tuple(self.items))
        for f in ("categories", "white_list", "black_list"):
            v = getattr(self, f)
            if v is not None:
                object.__setattr__(self, f, tuple(v))


# -- DASE ---------------------------------------------------------------------

@dataclasses.dataclass
class DataSourceParams(Params):
    app_name: str


class SimilarProductDataSource(DataSource):
    """DataSource.scala parity: users and items from aggregated
    ``$set``s, view and like/dislike events from ONE columnar read,
    split by mask."""

    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.params = params

    def read_training(self, ctx) -> TrainingData:
        app = self.params.app_name
        users = {uid: dict(pm.fields) for uid, pm in
                 aggregate_scan(app, "user").items()}
        items = {iid: Item(categories=pm.get_opt("categories"))
                 for iid, pm in aggregate_scan(app, "item").items()}
        cols = EventStoreClient.training_columns(
            app, entity_type="user", event_names=["view", "like", "dislike"],
            target_entity_type="item",
            columns=("event", "entity_id", "target_entity_id",
                     "event_time_ms"))
        events, u, i, t = (cols["event"], cols["entity_id"],
                           cols["target_entity_id"], cols["event_time_ms"])
        is_view = events == "view"
        return TrainingData(
            users=users, items=items,
            views=InteractionColumns(u[is_view], i[is_view], t[is_view]),
            likes=InteractionColumns(
                u[~is_view], i[~is_view], t[~is_view],
                likes=(events[~is_view] == "like")))


class SimilarProductPreparator(Preparator):
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
class SimilarityModel:
    """Row-normalized item factors and metadata for cosine scoring; the
    two-stage scorer (``ops/scoring.scorer_for``) lives on ``device``."""

    item_vocab: np.ndarray
    V: np.ndarray                     # [n_items, K] row-normalized
    items: Dict[int, Item]
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def item_index(self, item_id: str) -> Optional[int]:
        return vocab_index(self.item_vocab, item_id)

    def release_device(self) -> None:
        """Drop the quantized scorer's device copies (a retired unit)."""
        self.__dict__.pop("_scorer_cache", None)


def _candidate_ok(idx: int, items: Dict[int, Item], query_idx: set,
                  query: Query, white: Optional[set], black: set) -> bool:
    """isCandidateItem parity (CooccurrenceAlgorithm.scala /
    ALSAlgorithm)."""
    if idx in query_idx:
        return False
    if white is not None and idx not in white:
        return False
    if idx in black:
        return False
    return categories_match(items.get(idx), query.categories)


def _index_set(model, ids) -> set:
    return {i for i in (model.item_index(x) for x in ids) if i is not None}


def _score_and_filter(model: SimilarityModel, scores: np.ndarray,
                      query: Query, query_idx: set) -> PredictedResult:
    """The exact lane: every score, best first, down to the first
    non-positive one, through the candidate rules."""
    white = (_index_set(model, query.white_list)
             if query.white_list is not None else None)
    black = _index_set(model, query.black_list or ())
    out = []
    for idx in np.argsort(-scores):
        idx = int(idx)
        if scores[idx] <= 0:
            break
        if not _candidate_ok(idx, model.items, query_idx, query, white,
                             black):
            continue
        out.append(ItemScore(item=str(model.item_vocab[idx]),
                             score=float(scores[idx])))
        if len(out) >= query.num:
            break
    return PredictedResult(item_scores=out)


class ALSAlgorithm(Algorithm):
    """Implicit ALS on view counts; cosine-similarity predict. Trains on
    ``ctx.device`` (None or absent: ``cuda``)."""

    params_class = ALSAlgorithmParams

    def __init__(self, params: Optional[ALSAlgorithmParams] = None):
        self.params = params or ALSAlgorithmParams()

    def _ratings(self, pd: PreparedData):
        """Deduplicated view counts as (users, items, values) columns."""
        return pair_counts(pd.views.users, pd.views.items)

    def train(self, ctx, pd: PreparedData) -> SimilarityModel:
        users, items, values = self._ratings(pd)
        if not len(values):
            raise ValueError("view/like events cannot be empty "
                             "(ALSAlgorithm.scala:66 require parity)")
        if not pd.items:
            raise ValueError("items cannot be empty (use $set item events)")
        user_vocab, user_codes = assign_indices(users)
        item_vocab, item_codes = assign_indices(items)
        mesh = mesh_of(ctx)
        data = ALSData.build(user_codes, item_codes, values,
                             len(user_vocab), len(item_vocab),
                             n_shards=mesh.size)
        solver, block = resolved_als_solver(self.params, logger)
        device = getattr(ctx, "device", None)
        _, V = train_als(data, ALSParams(
            rank=self.params.rank, num_iterations=self.params.num_iterations,
            reg=self.params.reg, alpha=self.params.alpha,
            implicit_prefs=True, seed=self.params.seed,
            solver=solver, block_size=block), mesh=mesh)
        norms = np.linalg.norm(V, axis=1, keepdims=True)
        V = V / np.where(norms == 0, 1.0, norms)
        return SimilarityModel(item_vocab=item_vocab, V=V,
                               items=item_meta_join(item_vocab, pd.items),
                               device=device)

    def warmup_query(self, model: SimilarityModel) -> Optional[Query]:
        """Any catalog item drives the batched scorer through the bucket
        ladder."""
        if model is None or not len(model.item_vocab):
            return None
        return Query(items=(str(model.item_vocab[0]),), num=10)

    def predict(self, model: SimilarityModel, query: Query
                ) -> PredictedResult:
        query_idx = _index_set(model, query.items)
        if not query_idx:
            return PredictedResult(item_scores=[])
        # summed cosine: V is row-normalized, so scores = V @ sum(q_vecs)
        qsum = model.V[sorted(query_idx)].sum(axis=0)
        return _score_and_filter(model, model.V @ qsum, query, query_idx)

    def batch_predict(self, model: SimilarityModel, queries):
        """The micro-batch path: B summed-cosine matvecs as one [B, K] @
        [K, N] product, candidate filtering on the host. Under a
        non-exact scorer mode a batch whose queries carry no categories
        or whiteList goes through the two-stage scorer instead
        (:meth:`_fused_batch`); the others keep the exact lane."""
        idx_sets = [_index_set(model, q.items) for _, q in queries]
        rows = [b for b, qi in enumerate(idx_sets) if qi]
        out = [(i, PredictedResult(item_scores=[])) for i, _ in queries]
        if not rows:
            return out
        qsums = np.stack([model.V[sorted(idx_sets[b])].sum(axis=0)
                          for b in rows])
        fused = self._fused_batch(model, queries, rows, idx_sets, qsums)
        if fused is not None:
            for b, res in zip(rows, fused):
                out[b] = (queries[b][0], res)
            return out
        scores = qsums @ model.V.T                       # [B, N] host BLAS
        for r, b in enumerate(rows):
            i, q = queries[b]
            out[b] = (i, _score_and_filter(model, scores[r], q,
                                           idx_sets[b]))
        return out

    def _fused_batch(self, model: SimilarityModel, queries, rows,
                     idx_sets, qsums):
        """Score ``rows`` through the two-stage scorer, or None when the
        batch cannot (exact mode, a parity-demoted scorer, or a query
        whose filters need every score). The query-item and blackList
        exclusions are bounded (at most len(items) + len(blackList) of
        the top hits are rejected), so fetching top-(num + bound) and
        filtering on the host reproduces ``_score_and_filter``, its stop
        at the first non-positive score included."""
        from predictionio_tpu_torch.ops import scoring

        if scoring.holder_scorer_config(model).mode == "exact":
            return None
        extra = want_max = 0
        for b in rows:
            q = queries[b][1]
            if q.categories is not None or q.white_list is not None:
                return None
            extra = max(extra, len(idx_sets[b]) + len(q.black_list or ()))
            want_max = max(want_max, q.num)
        scorer = scoring.scorer_for(model, model.V)
        if scorer is None or not scorer.active:
            return None
        k = min(want_max + extra, len(model.item_vocab))
        scores, idx = scorer.topk(qsums, k)
        results = []
        for r, b in enumerate(rows):
            q = queries[b][1]
            black = _index_set(model, q.black_list or ())
            picked = []
            for t in range(idx.shape[1]):
                s = float(scores[r, t])
                if not np.isfinite(s) or s <= 0:
                    break
                i = int(idx[r, t])
                # the candidate rule of the exact lane: the lanes cannot
                # drift apart
                if not _candidate_ok(i, model.items, idx_sets[b], q, None,
                                     black):
                    continue
                picked.append(ItemScore(item=str(model.item_vocab[i]),
                                        score=s))
                if len(picked) >= q.num:
                    break
            results.append(PredictedResult(item_scores=picked))
        return results


class LikeAlgorithm(ALSAlgorithm):
    """LikeAlgorithm.scala parity: the latest like/dislike per (user,
    item), like = +1, dislike = -1, into implicit ALS (p = [r > 0], c =
    1 + alpha |r|)."""

    def _ratings(self, pd: PreparedData):
        values = np.where(pd.likes.likes, 1.0, -1.0).astype(np.float32)
        return latest_per_pair(pd.likes.users, pd.likes.items,
                               pd.likes.times, values)


@dataclasses.dataclass
class CooccurrenceAlgorithmParams(Params):
    n: int = 20


@dataclasses.dataclass
class CooccurrenceEngineModel:
    model: CooccurrenceModel
    items: Dict[int, Item]
    device: Optional[torch.device] = None


class CooccurrenceAlgorithm(Algorithm):
    """The top-N cooccurring items of the query items, counted on the
    workflow mesh (``mesh_of(ctx)``, ``models/cooccurrence``): on
    ``ctx.device`` when it has one position, its first axis's row blocks
    when it has more (every process reads the views whole)."""

    params_class = CooccurrenceAlgorithmParams

    def __init__(self, params: Optional[CooccurrenceAlgorithmParams] = None):
        self.params = params or CooccurrenceAlgorithmParams()

    def train(self, ctx, pd: PreparedData) -> CooccurrenceEngineModel:
        if not len(pd.views):
            raise ValueError("view events cannot be empty")
        user_vocab, user_codes, item_vocab, item_codes = intern_pairs(
            pd.views.users, pd.views.items)
        device = resolve_device(getattr(ctx, "device", None))
        top = train_cooccurrence(user_codes, item_codes, len(user_vocab),
                                 len(item_vocab), self.params.n,
                                 device=device, mesh=mesh_of(ctx))
        return CooccurrenceEngineModel(
            model=CooccurrenceModel(item_vocab=item_vocab,
                                    top_cooccurrences=top),
            items=item_meta_join(item_vocab, pd.items), device=device)

    def warmup_query(self, m: CooccurrenceEngineModel) -> Optional[Query]:
        if m is None or not len(m.model.item_vocab):
            return None
        return Query(items=(str(m.model.item_vocab[0]),), num=10)

    def predict(self, m: CooccurrenceEngineModel, query: Query
                ) -> PredictedResult:
        similar = m.model.similar(
            list(query.items), num=query.num,
            white_list=(list(query.white_list)
                        if query.white_list is not None else None),
            black_list=(list(query.black_list)
                        if query.black_list is not None else None),
            candidate_filter=lambda idx: categories_match(
                m.items.get(idx), query.categories))
        return PredictedResult(item_scores=[
            ItemScore(item=i, score=c) for i, c in similar])

    def batch_predict(self, m: CooccurrenceEngineModel, queries):
        """Host-side top-list merging, nothing to vectorize; the override
        lets the whole multi-algorithm engine take the micro-batched
        path, where the ALS algorithms' batched scoring pays for it."""
        return [(i, self.predict(m, q)) for i, q in queries]


class SimilarProductServing(FirstServing):
    pass


def engine() -> Engine:
    """Engine.scala factory parity (a multi-algorithm engine)."""
    return Engine(
        data_source_classes=SimilarProductDataSource,
        preparator_classes=SimilarProductPreparator,
        algorithm_classes={"als": ALSAlgorithm,
                           "cooccurrence": CooccurrenceAlgorithm,
                           "likealgo": LikeAlgorithm},
        serving_classes=SimilarProductServing,
    )


def default_engine_params(app_name: str,
                          algorithms: Sequence[str] = ("als",)
                          ) -> EngineParams:
    defaults = {"als": ALSAlgorithmParams(),
                "cooccurrence": CooccurrenceAlgorithmParams(),
                "likealgo": ALSAlgorithmParams()}
    return EngineParams(
        data_source_params=DataSourceParams(app_name=app_name),
        algorithm_params_list=[(a, defaults[a]) for a in algorithms],
    )
