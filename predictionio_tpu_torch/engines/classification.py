"""Classification engine template (port of the reference's
``engines/classification.py``: NaiveBayes, LogisticRegression and
RandomForest).

Rebuilds examples/scala-parallel-classification/add-algorithm (the third
judged config): ``$set`` user entities with numeric attr0/attr1/attr2 and
a ``plan`` label -> labeled vectors -> multinomial naive Bayes (the MLlib
analog), softmax regression or a random forest; k-fold Accuracy
evaluation.

  * DataSource <- src/main/scala/DataSource.scala:37-129 (the required
    plan/attr0-2 properties through ``data/ingest.aggregate_scan``,
    k-fold readEval by index modulo)
  * NaiveBayesAlgorithm <- NaiveBayesAlgorithm.scala:35-56
  * LogisticRegressionAlgorithm, RandomForestAlgorithm <- the
    add-algorithm variants
  * Accuracy <- Evaluation.scala:26

Every algorithm trains on the workflow mesh (``mesh_of(ctx)``, as the
reference's do): on ``ctx.device`` (None or absent: ``cuda``) when the
mesh has one position, over its positions when it has more (each
model's mesh branch). The naive Bayes and forest models predict on the
device they trained on, logistic regression on the host (the
reference's product).

Query: {"attr0": 2.0, "attr1": 0.0, "attr2": 0.0} -> {"label": 0.0}.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.core.base import (
    Algorithm, DataSource, FirstServing, Preparator,
)
from predictionio_tpu_torch.core.engine import Engine
from predictionio_tpu_torch.core.metrics import AverageMetric
from predictionio_tpu_torch.core.params import EngineParams, Params
from predictionio_tpu_torch.models.forest import (
    ForestModel, ForestParams, train_forest,
)
from predictionio_tpu_torch.models.logreg import (
    LogRegModel, LogRegParams, train_logreg,
)
from predictionio_tpu_torch.models.naive_bayes import (
    MultinomialNBModel, train_multinomial_nb,
)
from predictionio_tpu_torch.workflow.context import mesh_of

ATTRS = ("attr0", "attr1", "attr2")


@dataclasses.dataclass
class LabeledVector:
    label: float
    features: Tuple[float, ...]


@dataclasses.dataclass
class TrainingData:
    points: List[LabeledVector]


PreparedData = TrainingData


@dataclasses.dataclass(frozen=True)
class Query:
    attr0: float
    attr1: float
    attr2: float


@dataclasses.dataclass
class PredictedResult:
    label: float

    def to_dict(self):
        return {"label": self.label}


@dataclasses.dataclass
class ActualResult:
    label: float


@dataclasses.dataclass
class DataSourceParams(Params):
    app_name: str
    eval_k: Optional[int] = None


class ClassificationDataSource(DataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.params = params

    def _points(self) -> List[LabeledVector]:
        """The training read: the columnar ``$set``/``$unset``/``$delete``
        fold behind the scan cache (``data/ingest``); the loop below runs
        over aggregated entities, not events."""
        from predictionio_tpu_torch.data.ingest import aggregate_scan

        props = aggregate_scan(self.params.app_name, "user",
                               required=["plan", *ATTRS])
        return [
            LabeledVector(
                label=float(pm.get("plan")),
                features=tuple(float(pm.get(a)) for a in ATTRS))
            for pm in props.values()]

    def read_training(self, ctx) -> TrainingData:
        return TrainingData(points=self._points())

    def read_eval(self, ctx):
        if not self.params.eval_k:
            raise ValueError("DataSourceParams.eval_k must not be None "
                             "(DataSource.scala:77 require parity)")
        from predictionio_tpu_torch.core.cross_validation import k_fold

        points = self._points()
        folds = []
        for train, test in k_fold(points, self.params.eval_k):
            qa = [(Query(*p.features), ActualResult(label=p.label))
                  for p in test]
            folds.append((TrainingData(points=train), None, qa))
        return folds


class ClassificationPreparator(Preparator):
    def prepare(self, ctx, td: TrainingData) -> PreparedData:
        return td


def _xy(pd: PreparedData):
    X = np.asarray([p.features for p in pd.points], np.float32)
    y = [str(p.label) for p in pd.points]
    return X, y


def _vector_batch_predict(model, queries):
    """The shared vectorized batch predict: one model call a batch."""
    if not queries:
        return []
    idx = [i for i, _ in queries]
    X = np.asarray([[q.attr0, q.attr1, q.attr2] for _, q in queries],
                   np.float32)
    labels = model.predict(X)
    return [(i, PredictedResult(label=float(lab)))
            for i, lab in zip(idx, labels)]


def _predict_one(model, query: Query) -> PredictedResult:
    x = np.asarray([[query.attr0, query.attr1, query.attr2]], np.float32)
    return PredictedResult(label=float(model.predict(x)[0]))


def _require_points(pd: PreparedData) -> None:
    if not pd.points:
        raise ValueError("no labeled points; import training data first")


@dataclasses.dataclass
class NaiveBayesParams(Params):
    """NaiveBayesAlgorithmParams parity: lambda smoothing."""

    reg: float = 1.0


class _WarmableClassifier(Algorithm):
    """The deploy warm-up probe: the attr vector is dense floats, so a
    zero query drives the whole vectorized predict (deploy/warm.py)."""

    def warmup_query(self, model) -> Optional[Query]:
        if model is None:
            return None
        return Query(attr0=0.0, attr1=0.0, attr2=0.0)

    def predict(self, model, query: Query) -> PredictedResult:
        return _predict_one(model, query)

    def batch_predict(self, model, queries):
        return _vector_batch_predict(model, queries)


class NaiveBayesAlgorithm(_WarmableClassifier):
    params_class = NaiveBayesParams

    def __init__(self, params: Optional[NaiveBayesParams] = None):
        self.params = params or NaiveBayesParams()

    def train(self, ctx, pd: PreparedData) -> MultinomialNBModel:
        _require_points(pd)
        X, y = _xy(pd)
        return train_multinomial_nb(X, y, smoothing=self.params.reg,
                                    mesh=mesh_of(ctx),
                                    device=getattr(ctx, "device", None))


@dataclasses.dataclass
class LogisticRegressionParams(Params):
    iterations: int = 200
    learning_rate: float = 0.1
    reg: float = 1e-4
    seed: int = 0


class LogisticRegressionAlgorithm(_WarmableClassifier):
    params_class = LogisticRegressionParams

    def __init__(self, params: Optional[LogisticRegressionParams] = None):
        self.params = params or LogisticRegressionParams()

    def train(self, ctx, pd: PreparedData) -> LogRegModel:
        _require_points(pd)
        X, y = _xy(pd)
        return train_logreg(X, y, LogRegParams(
            iterations=self.params.iterations,
            learning_rate=self.params.learning_rate,
            reg=self.params.reg, seed=self.params.seed),
            mesh=mesh_of(ctx), device=getattr(ctx, "device", None))


#: RandomForestAlgorithmParams parity (add-algorithm/src/main/scala/
#: RandomForestAlgorithm.scala: numClasses, numTrees,
#: featureSubsetStrategy, impurity, maxDepth, maxBins)
RandomForestParams = ForestParams


class RandomForestAlgorithm(_WarmableClassifier):
    """RandomForestAlgorithm.scala parity on the level-wise histogram
    forest (models/forest.py)."""

    params_class = ForestParams

    def __init__(self, params: Optional[ForestParams] = None):
        self.params = params or ForestParams()

    def train(self, ctx, pd: PreparedData) -> ForestModel:
        _require_points(pd)
        X, y = _xy(pd)
        return train_forest(X, y, self.params, mesh=mesh_of(ctx),
                            device=getattr(ctx, "device", None))


class ClassificationServing(FirstServing):
    pass


class Accuracy(AverageMetric):
    """Evaluation.scala:26 — fraction of exact label matches."""

    def calculate_point(self, eval_info, query: Query,
                        prediction: PredictedResult, actual: ActualResult):
        return 1.0 if prediction.label == actual.label else 0.0


def engine() -> Engine:
    return Engine(
        data_source_classes=ClassificationDataSource,
        preparator_classes=ClassificationPreparator,
        algorithm_classes={"naive": NaiveBayesAlgorithm,
                           "logreg": LogisticRegressionAlgorithm,
                           "randomforest": RandomForestAlgorithm},
        serving_classes=ClassificationServing,
    )


def default_engine_params(app_name: str, algorithm: str = "naive",
                          eval_k: Optional[int] = None) -> EngineParams:
    defaults = {"naive": NaiveBayesParams(),
                "logreg": LogisticRegressionParams(),
                "randomforest": ForestParams()}
    return EngineParams(
        data_source_params=DataSourceParams(app_name=app_name, eval_k=eval_k),
        algorithm_params_list=[(algorithm, defaults[algorithm])],
    )
