"""E-commerce recommendation engine (ALS + business rules) (port of the
reference's ``engines/ecommerce.py``, the train-with-rate-event
template): view and buy events train implicit ALS; the serving-time
business rules read the event store live:

  * unseenOnly       — leave out items the user has already seen
    (ECommAlgorithm.scala:319-352)
  * unavailableItems — the latest ``$set`` of the constraint entity
    "unavailableItems" (ECommAlgorithm.scala:354-384)
  * whiteList / blackList / categories from the query
  * a known user is scored by the user's factors (predictKnownUser:429);
    an unknown user by similarity to the recent views (predictSimilar:497),
    else by popularity (predictDefault:463, buy counts)

Scoring is numpy on the host, as in the reference. Query: {"user": ...,
"num": N, "categories"?, "whiteList"?, "blackList"?}. Online fold-in
re-solves a user's row from its views and buys (B1 on the card) and
adds buys to the popularity counts.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional, Set, Tuple

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
from predictionio_tpu_torch.engines.common import (
    EntityEventCache, InteractionColumns, Item, ItemScore, PredictedResult,
    categories_match, item_meta_join, resolved_als_solver,
)
from predictionio_tpu_torch.models.als import ALSData, ALSParams, train_als
from predictionio_tpu_torch.workflow.context import mesh_of

#: training-time implicit confidence weights (genMLlibRating parity: a
#: buy is worth BUY_WEIGHT views), shared with the fold-in spec so the
#: online path cannot drift from training
VIEW_WEIGHT, BUY_WEIGHT = 1.0, 2.0

logger = logging.getLogger("pio.torch.engine.ecommerce")


@dataclasses.dataclass
class TrainingData:
    users: Dict[str, dict]
    items: Dict[str, Item]
    views: InteractionColumns
    buys: InteractionColumns


PreparedData = TrainingData


@dataclasses.dataclass(frozen=True)
class Query:
    user: str
    num: int
    categories: Optional[Tuple[str, ...]] = None
    white_list: Optional[Tuple[str, ...]] = None
    black_list: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        for f in ("categories", "white_list", "black_list"):
            v = getattr(self, f)
            if v is not None:
                object.__setattr__(self, f, tuple(v))


@dataclasses.dataclass
class DataSourceParams(Params):
    app_name: str


class ECommerceDataSource(DataSource):
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
            app, entity_type="user", event_names=["view", "buy"],
            target_entity_type="item",
            columns=("event", "entity_id", "target_entity_id"))
        events, u, i = (cols["event"], cols["entity_id"],
                        cols["target_entity_id"])
        is_view = events == "view"
        return TrainingData(
            users=users, items=items,
            views=InteractionColumns(u[is_view], i[is_view]),
            buys=InteractionColumns(u[~is_view], i[~is_view]))


class ECommercePreparator(Preparator):
    def prepare(self, ctx, td: TrainingData) -> PreparedData:
        return td


@dataclasses.dataclass
class ECommAlgorithmParams(Params):
    """ECommAlgorithmParams parity (ECommAlgorithm.scala:46-57)."""

    json_aliases = {"lambda": "reg"}

    app_name: str
    unseen_only: bool = False
    seen_events: Tuple[str, ...] = ("buy", "view")
    similar_events: Tuple[str, ...] = ("view",)
    rank: int = 10
    num_iterations: int = 20
    reg: float = 0.01
    alpha: float = 1.0
    seed: int = 3
    #: {"mode": "full"|"subspace", "block_size": N}; None defers to
    #: server.json "train" / PIO_ALS_SOLVER
    solver: Optional[dict] = None


@dataclasses.dataclass
class ECommModel:
    """ECommModel parity: user and item factors, item metadata and the
    popularity counts. ``device`` is where fold-in solves."""

    user_vocab: np.ndarray
    item_vocab: np.ndarray
    U: np.ndarray
    V: np.ndarray
    V_normalized: np.ndarray     # row-normalized V for similarity scoring
    items: Dict[int, Item]
    popular_count: Dict[int, int]
    device: Optional[torch.device] = None

    def user_index(self, user_id: str) -> Optional[int]:
        return vocab_index(self.user_vocab, user_id)

    def item_index(self, item_id: str) -> Optional[int]:
        return vocab_index(self.item_vocab, item_id)


def normalized_rows(V: np.ndarray) -> np.ndarray:
    """V with unit rows (a zero row stays zero)."""
    return V / np.maximum(np.linalg.norm(V, axis=1, keepdims=True), 1e-9)


class ECommAlgorithm(Algorithm):
    params_class = ECommAlgorithmParams

    def __init__(self, params: ECommAlgorithmParams):
        self.params = params
        self._entity_cache: Optional[EntityEventCache] = None

    # -- train ---------------------------------------------------------------
    def train(self, ctx, pd: PreparedData) -> ECommModel:
        """ECommAlgorithm.train:84: view (1x) and buy (BUY_WEIGHT)
        implicit ratings on ``ctx.device``; popularity from buy counts
        (trainDefault:211)."""
        if not pd.items:
            raise ValueError("items cannot be empty (use $set item events)")
        all_users = np.concatenate([pd.views.users, pd.buys.users])
        all_items = np.concatenate([pd.views.items, pd.buys.items])
        weights = np.concatenate([
            np.full(len(pd.views), VIEW_WEIGHT, np.float32),
            np.full(len(pd.buys), BUY_WEIGHT, np.float32)])
        users, items, values = pair_counts(all_users, all_items, weights)
        if not len(values):
            raise ValueError("view/buy events cannot be empty")
        user_vocab, user_codes = assign_indices(users)
        item_vocab, item_codes = assign_indices(items)
        mesh = mesh_of(ctx)
        data = ALSData.build(user_codes, item_codes, values,
                             len(user_vocab), len(item_vocab),
                             n_shards=mesh.size)
        solver, block = resolved_als_solver(self.params, logger)
        device = getattr(ctx, "device", None)
        U, V = train_als(data, ALSParams(
            rank=self.params.rank, num_iterations=self.params.num_iterations,
            reg=self.params.reg, alpha=self.params.alpha,
            implicit_prefs=True, seed=self.params.seed,
            solver=solver, block_size=block), mesh=mesh)
        buy_idx = batch_lookup(item_vocab, pd.buys.items)
        buy_idx = buy_idx[buy_idx >= 0]
        popular = {int(ix): int(c) for ix, c in
                   zip(*np.unique(buy_idx, return_counts=True))}
        return ECommModel(user_vocab=user_vocab, item_vocab=item_vocab,
                          U=U, V=V, V_normalized=normalized_rows(V),
                          items=item_meta_join(item_vocab, pd.items),
                          popular_count=popular, device=device)

    # -- serving-time business rules -----------------------------------------
    def _event_cache(self) -> EntityEventCache:
        """The short-TTL per-entity lookup cache the rules read through
        (``engines/common.EntityEventCache``)."""
        if self._entity_cache is None:
            self._entity_cache = EntityEventCache(self.params.app_name)
        return self._entity_cache

    def _gen_black_list(self, query: Query) -> Set[str]:
        """genBlackList parity (:319-384): seen + unavailable + the
        query's blackList. A misconfigured app name raises: it must not
        silently disable the rules."""
        cache = self._event_cache()
        seen: Set[str] = set()
        if self.params.unseen_only:
            seen = set(cache.targets(
                "user", query.user, self.params.seen_events,
                target_entity_type="item", lookup="seen"))
        unavailable: Set[str] = set()
        props = cache.latest_properties(
            "constraint", "unavailableItems", ["$set"], lookup="constraint")
        if props:
            unavailable = set(props.get("items") or [])
        return seen | unavailable | set(query.black_list or ())

    def _recent_items(self, query: Query) -> Set[str]:
        """getRecentItems parity (:386-427): the user's latest
        similar-events."""
        return set(self._event_cache().targets(
            "user", query.user, self.params.similar_events,
            target_entity_type="item", limit=10, latest=True,
            lookup="recent_items"))

    def _candidate_mask(self, model: ECommModel, query: Query,
                        black: Set[str]) -> np.ndarray:
        """True where the item may be recommended (isCandidateItem:529)."""
        n = len(model.item_vocab)
        ok = np.ones(n, dtype=bool)
        if query.white_list is not None:
            ok[:] = False
            for it in query.white_list:
                idx = model.item_index(it)
                if idx is not None:
                    ok[idx] = True
        for it in black:
            idx = model.item_index(it)
            if idx is not None:
                ok[idx] = False
        if query.categories:
            for idx in range(n):
                if not categories_match(model.items.get(idx),
                                        query.categories):
                    ok[idx] = False
        return ok

    def _top(self, scores: np.ndarray, ok: np.ndarray, model: ECommModel,
             num: int) -> PredictedResult:
        """The top-``num`` candidates with score > 0 (predictKnownUser:453
        / predictSimilar:518 filter parity)."""
        scores = np.where(ok, scores, -np.inf)
        order = np.argsort(-scores)[:num]
        return PredictedResult(item_scores=[
            ItemScore(item=str(model.item_vocab[int(i)]),
                      score=float(scores[int(i)]))
            for i in order if scores[int(i)] > 0])

    def warmup_query(self, model: ECommModel) -> Optional[Query]:
        if model is None or not len(model.user_vocab):
            return None
        return Query(user=str(model.user_vocab[0]), num=10)

    # -- online fold-in (deploy/foldin.py) -----------------------------------
    def foldin_spec(self, model: ECommModel, engine_params):
        """The fold-in contract: view and buy events re-solve the user's
        implicit-ALS row (pair weights summed like the training read's
        ``pair_counts``), and buy events add to the popularity counts.
        Items stay frozen: their metadata and constraints need a
        retrain."""
        from predictionio_tpu_torch.deploy.foldin import FoldinSpec

        if model is None:
            return None
        return FoldinSpec(
            app_name=self.params.app_name,
            als_params=ALSParams(
                rank=self.params.rank, reg=self.params.reg,
                alpha=self.params.alpha, implicit_prefs=True,
                seed=self.params.seed),
            event_names=("view", "buy"),
            event_weights={"view": VIEW_WEIGHT, "buy": BUY_WEIGHT},
            rate_event=None, aggregate="sum", fold_items=False,
            count_events=("buy",))

    def foldin_factors(self, model: ECommModel):
        from predictionio_tpu_torch.deploy.foldin import FoldinFactors

        return FoldinFactors(user_vocab=model.user_vocab,
                             item_vocab=model.item_vocab,
                             U=model.U, V=model.V)

    def foldin_apply(self, model: ECommModel, spec, user_rows, item_rows,
                     counts) -> ECommModel:
        """A new model with the folded user rows and the buy counts
        merged; the item side (V, normalized V, metadata, vocab) is
        shared by reference, so the swap stays cheap."""
        from predictionio_tpu_torch.deploy.foldin import upsert_factor_rows

        user_vocab, U = upsert_factor_rows(model.user_vocab, model.U,
                                           user_rows)
        popular = model.popular_count
        if counts:
            popular = dict(popular)
            for iid, delta in counts.items():
                idx = model.item_index(str(iid))
                if idx is not None:     # brand-new items need a retrain
                    popular[idx] = int(popular.get(idx, 0) + delta)
        return dataclasses.replace(model, user_vocab=user_vocab, U=U,
                                   popular_count=popular)

    def predict(self, model: ECommModel, query: Query) -> PredictedResult:
        black = self._gen_black_list(query)
        ok = self._candidate_mask(model, query, black)
        ui = model.user_index(query.user)
        if ui is not None:
            scores = model.V @ model.U[ui]           # predictKnownUser:429
            return self._top(scores, ok, model, query.num)
        recent_idx = [i for i in (model.item_index(x)
                                  for x in self._recent_items(query))
                      if i is not None]
        if recent_idx:                               # predictSimilar:497
            Vn = model.V_normalized
            scores = Vn @ Vn[recent_idx].sum(axis=0)
            ok[recent_idx] = False
            return self._top(scores, ok, model, query.num)
        scores = np.zeros(len(model.item_vocab))     # predictDefault:463
        for idx, c in model.popular_count.items():
            scores[idx] = c
        return self._top(scores, ok, model, query.num)


class ECommerceServing(FirstServing):
    pass


def engine() -> Engine:
    return Engine(
        data_source_classes=ECommerceDataSource,
        preparator_classes=ECommercePreparator,
        algorithm_classes={"ecomm": ECommAlgorithm},
        serving_classes=ECommerceServing,
    )


def default_engine_params(app_name: str, **overrides) -> EngineParams:
    return EngineParams(
        data_source_params=DataSourceParams(app_name=app_name),
        algorithm_params_list=[("ecomm", ECommAlgorithmParams(
            app_name=app_name, **overrides))],
    )
