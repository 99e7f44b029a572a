"""Metric library for evaluation (port of the reference's
``core/metrics.py``, numpy only).

Parity with the reference Metric family (core/.../controller/Metric.scala:39-268):
Metric computes a result R from [(EvalInfo, [(Q, P, A)])]; comparison uses the
result value. Subclasses implement calculate_point (per Q/P/A) and the
aggregation (average / stdev / sum), with Option* variants skipping None
points. The reference's Spark StatCounter aggregation becomes numpy.
"""

from __future__ import annotations

import abc
import math
from typing import Generic, Optional, Sequence, Tuple, TypeVar

import numpy as np

from predictionio_tpu_torch.core.base import A, EI, P, Q

R = TypeVar("R")

EvalDataSet = Sequence[Tuple[EI, Sequence[Tuple[Q, P, A]]]]


class Metric(Generic[EI, Q, P, A, R], abc.ABC):
    """Metric.scala:39. Higher is better by default; set smaller_is_better.

    ``sweep_kind`` opts a metric into the device-batched evaluation sweep
    (``core/evaluation.py``): a metric that names one of the kinds an
    algorithm's ``sweep_eval`` can compute on device ("precision_at_k",
    "topn_mse", "zero") is evaluated in batch over the whole candidate
    grid instead of through per-fold Q/P/A loops. ``None`` (the default)
    keeps the metric on the sequential path.
    """

    smaller_is_better: bool = False
    sweep_kind = None  # type: Optional[str]

    @abc.abstractmethod
    def calculate(self, ctx, eval_data_set: EvalDataSet) -> R: ...

    def compare(self, r0: R, r1: R) -> int:
        sign = -1 if self.smaller_is_better else 1
        if r0 == r1:
            return 0
        return sign if r0 > r1 else -sign

    def header(self) -> str:
        return type(self).__name__


class _PointMetric(Metric):
    """Shared base: flatten the eval matrix to per-(Q,P,A) scores."""

    @abc.abstractmethod
    def calculate_point(self, eval_info, query, prediction, actual
                        ) -> Optional[float]: ...

    def _points(self, eval_data_set: EvalDataSet) -> np.ndarray:
        scores = []
        for eval_info, qpa in eval_data_set:
            for q, p, a in qpa:
                scores.append(self.calculate_point(eval_info, q, p, a))
        return np.asarray([s for s in scores if s is not None], dtype=np.float64)


class AverageMetric(_PointMetric):
    """Metric.scala:99 — mean of per-point scores (None is an error)."""

    def calculate(self, ctx, eval_data_set: EvalDataSet) -> float:
        points = self._points(eval_data_set)
        return float(points.mean()) if points.size else float("nan")


class OptionAverageMetric(AverageMetric):
    """Metric.scala:124 — mean over points where calculate_point is not None.

    (The numeric behavior matches AverageMetric because _points already
    drops None; the distinct class preserves the reference API where
    returning None from a plain AverageMetric is a contract violation.)
    """


class StdevMetric(_PointMetric):
    """Metric.scala:151 — population stdev of scores."""

    def calculate(self, ctx, eval_data_set: EvalDataSet) -> float:
        points = self._points(eval_data_set)
        return float(points.std()) if points.size else float("nan")


class OptionStdevMetric(StdevMetric):
    """Metric.scala:179."""


class SumMetric(_PointMetric):
    """Metric.scala:205 — sum of scores."""

    def calculate(self, ctx, eval_data_set: EvalDataSet) -> float:
        points = self._points(eval_data_set)
        return float(points.sum())


class ZeroMetric(Metric):
    """Metric.scala:234 — always 0; for evaluations without a real metric."""

    sweep_kind = "zero"

    def calculate(self, ctx, eval_data_set: EvalDataSet) -> float:
        return 0.0


class QPAMetric(_PointMetric):
    """Convenience: build a metric from a scoring callable."""

    def __init__(self, fn, aggregation: str = "average",
                 smaller_is_better: bool = False):
        self._fn = fn
        self._agg = aggregation
        self.smaller_is_better = smaller_is_better

    def calculate_point(self, eval_info, query, prediction, actual):
        return self._fn(query, prediction, actual)

    def calculate(self, ctx, eval_data_set: EvalDataSet) -> float:
        points = self._points(eval_data_set)
        if not points.size:
            return float("nan")
        if self._agg == "average":
            return float(points.mean())
        if self._agg == "sum":
            return float(points.sum())
        if self._agg == "stdev":
            return float(points.std())
        raise ValueError(f"unknown aggregation {self._agg}")


def rmse(predicted: float, actual: float) -> float:
    """Squared-error point score; AverageMetric of this is MSE (sqrt for RMSE)."""
    d = predicted - actual
    return d * d


def is_nan(x: float) -> bool:
    return isinstance(x, float) and math.isnan(x)
