"""Session-based recommendation engine (port of the reference's
``engines/sessionrec.py``): next-item prediction over each user's
time-ordered event stream with the causal transformer of
``models/seqrec.py``.

The DataSource reads user -> item ``view``/``buy`` events through the
columnar training read and groups them into per-user sessions ordered
by event time (``data/ingest.sessions_by_entity``); the algorithm
trains the transformer on ``ctx.device`` (None or absent: ``cuda``) and
serves there; a query carries the visitor's recent items and gets the
top-N likely next items back, in the reference's wire shape
``{"itemScores": [{"item", "score"}]}``. The engine has no evaluation
metric (as the reference's); ``read_eval`` gives leave-one-out folds,
k-fold over users. It defines no fold-in hooks, so a deploy with
``PIO_FOLDIN`` serves it without fold-in. Its warm-up query (the
reference has none) builds the model's net on the device before the
first query.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from predictionio_tpu_torch.core.base import (
    Algorithm, DataSource, FirstServing, Preparator,
)
from predictionio_tpu_torch.core.engine import Engine
from predictionio_tpu_torch.core.params import EngineParams, Params
from predictionio_tpu_torch.models.seqrec import (
    SeqRecModel, SeqRecParams, train_seqrec,
)


@dataclasses.dataclass
class TrainingData:
    sessions: List[List[str]]        # per-user time-ordered item ids

    def sanity_check(self):
        if not self.sessions:
            raise ValueError(
                "No sessions found. Check the appName or import data first.")


PreparedData = TrainingData


@dataclasses.dataclass
class Query:
    items: List[str]                 # visitor's recent items, oldest first
    num: int = 10


@dataclasses.dataclass
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass
class PredictedResult:
    item_scores: List[ItemScore]

    def to_dict(self):
        """Reference wire shape: {"itemScores": [{"item","score"}...]}."""
        return {"itemScores": [{"item": s.item, "score": s.score}
                               for s in self.item_scores]}


@dataclasses.dataclass
class ActualResult:
    item: str                        # the item actually chosen next


@dataclasses.dataclass
class DataSourceParams(Params):
    app_name: str
    event_names: Sequence[str] = ("view", "buy")
    eval_params: Optional[dict] = None


class SessionDataSource(DataSource):
    """Per-user sessions ordered by eventTime, read whole (a session is
    never split across readers; the reference's multi-process note
    applies to ROADMAP item A12, part 2)."""

    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.params = params

    def _read_sessions(self) -> List[List[str]]:
        from predictionio_tpu_torch.data.eventstore import EventStoreClient
        from predictionio_tpu_torch.data.ingest import sessions_by_entity

        cols = EventStoreClient.training_columns(
            self.params.app_name, entity_type="user",
            event_names=list(self.params.event_names),
            target_entity_type="item",
            columns=("entity_id", "target_entity_id", "event_time_ms"))
        return sessions_by_entity(cols["entity_id"], cols["target_entity_id"],
                                  cols["event_time_ms"])

    def read_training(self, ctx) -> TrainingData:
        return TrainingData(sessions=self._read_sessions())

    def read_eval(self, ctx):
        """Leave-one-out per session, k-fold over users (the SASRec eval
        protocol mapped onto readEval's fold contract)."""
        from predictionio_tpu_torch.core.cross_validation import split_data

        ep = self.params.eval_params or {}
        k = int(ep.get("kFold", 3))
        sessions = [s for s in self._read_sessions() if len(s) >= 3]
        folds = []
        for fold, (_train_idx, test_idx) in enumerate(
                split_data(k, len(sessions))):
            held_out = set(test_idx.tolist())
            train, qa = [], []
            for i, s in enumerate(sessions):
                if i in held_out:
                    qa.append((Query(items=s[:-1],
                                     num=int(ep.get("queryNum", 10))),
                               ActualResult(item=s[-1])))
                    train.append(s[:-1])
                else:
                    train.append(s)
            folds.append((TrainingData(sessions=train), {"fold": fold}, qa))
        return folds


class SessionPreparator(Preparator):
    def prepare(self, ctx, td: TrainingData) -> PreparedData:
        return TrainingData(
            sessions=[s for s in td.sessions if len(s) >= 2])


@dataclasses.dataclass
class AlgorithmParams(SeqRecParams):
    pass


class SeqRecAlgorithm(Algorithm):
    """The transformer next-item model, trained on the run's device."""

    params_class = AlgorithmParams

    def __init__(self, params: Optional[AlgorithmParams] = None):
        self.params = params or AlgorithmParams()

    def train(self, ctx, pd: PreparedData) -> SeqRecModel:
        from predictionio_tpu_torch.workflow.checkpoint import (
            checkpointer_of,
        )

        return train_seqrec(getattr(ctx, "mesh", None), pd.sessions,
                            self.params, checkpointer=checkpointer_of(ctx),
                            device=getattr(ctx, "device", None))

    def warmup_query(self, model: SeqRecModel) -> Optional[Query]:
        """The deploy's warm-up and verify probe (deploy/warm.py): the
        first item of the vocabulary builds the net on the device and
        runs the serving path before the model takes traffic."""
        if model is None or not len(model.item_vocab):
            return None
        return Query(items=[str(model.item_vocab[0])], num=10)

    def predict(self, model: SeqRecModel, query: Query) -> PredictedResult:
        recs = model.recommend_next(query.items, query.num)
        return PredictedResult(
            item_scores=[ItemScore(item=i, score=s) for i, s in recs])


class SessionServing(FirstServing):
    pass


def engine() -> Engine:
    return Engine(
        data_source_classes=SessionDataSource,
        preparator_classes=SessionPreparator,
        algorithm_classes={"seqrec": SeqRecAlgorithm},
        serving_classes=SessionServing,
    )


def default_engine_params(app_name: str, **algo_overrides) -> EngineParams:
    return EngineParams(
        data_source_params=DataSourceParams(app_name=app_name),
        algorithm_params_list=[("seqrec", AlgorithmParams(**algo_overrides))],
    )
