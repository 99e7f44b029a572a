"""DASE component protocols (port of the reference's ``core/base.py``):
``DataSource``, ``Preparator``, ``Algorithm``, ``Serving`` and
``FirstServing``, the ``SanityCheck`` hook, and the constructor
conventions the engine uses to build them. ``ctx`` is what the caller passes through ``Engine.train``:
the port's components read its ``device`` (None or absent: ``cuda``),
where the reference's workflow context carries a device mesh."""

from __future__ import annotations

import abc
import dataclasses
import inspect
import typing
from typing import Any, Generic, List, Optional, Sequence, Tuple, TypeVar

from predictionio_tpu_torch.core.params import Params

TD = TypeVar("TD")   # training data
EI = TypeVar("EI")   # evaluation info
PD = TypeVar("PD")   # prepared data
Q = TypeVar("Q")     # query
P = TypeVar("P")     # prediction
A = TypeVar("A")     # actual
M = TypeVar("M")     # model


class SanityCheck(abc.ABC):
    """Data classes may self-validate during training
    (SanityCheck.scala:27)."""

    @abc.abstractmethod
    def sanity_check(self) -> None:
        """Raise if the data is invalid."""


def load_class(path: str) -> Any:
    """Resolve ``module.sub:Name`` or ``module.sub.Name`` to the object
    it names (an evaluation, a params generator, a class)."""
    import importlib

    if ":" in path:
        module_name, qualname = path.split(":", 1)
    else:
        module_name, _, qualname = path.rpartition(".")
    obj = importlib.import_module(module_name)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def instantiate(cls: type, params: Any):
    """Construct with the params object when the constructor accepts
    one, else no-arg; with no params configured (None) a no-arg
    constructor is preferred."""
    try:
        sig = inspect.signature(cls.__init__)
        positional = [
            p for name, p in sig.parameters.items()
            if name not in ("self",) and p.kind in (
                inspect.Parameter.POSITIONAL_ONLY,
                inspect.Parameter.POSITIONAL_OR_KEYWORD)
        ]
    except (TypeError, ValueError):
        positional = []
    no_arg_ok = all(p.default is not inspect.Parameter.empty
                    for p in positional)
    if positional and not (params is None and no_arg_ok):
        return cls(params)
    return cls()


def params_class_of(cls: type) -> Optional[type]:
    """The component's declared params dataclass, if any: an explicit
    `params_class` attribute, else the annotation of the constructor's
    first parameter when it is a dataclass or Params subclass."""
    explicit = getattr(cls, "params_class", None)
    if explicit is not None:
        return explicit
    try:
        hints = typing.get_type_hints(cls.__init__)
        sig = inspect.signature(cls.__init__)
    except (TypeError, ValueError, NameError):
        return None
    for name, _p in sig.parameters.items():
        if name == "self":
            continue
        ann = hints.get(name)
        if isinstance(ann, type) and (dataclasses.is_dataclass(ann)
                                      or issubclass(ann, Params)):
            return ann
        return None
    return None


class DataSource(Generic[TD], abc.ABC):
    """Reads the training data from the event store."""

    @abc.abstractmethod
    def read_training(self, ctx) -> TD:
        """Read training data (DataSource.readTraining)."""


class Preparator(Generic[TD, PD], abc.ABC):
    @abc.abstractmethod
    def prepare(self, ctx, training_data: TD) -> PD:
        """Turn training data into what the algorithms train on."""


class Algorithm(Generic[PD, M, Q, P], abc.ABC):
    """One algorithm: train a model, predict from it."""

    @abc.abstractmethod
    def train(self, ctx, prepared_data: PD) -> M:
        """Train a model from the prepared data."""

    @abc.abstractmethod
    def predict(self, model: M, query: Q) -> P:
        """Single-query predict."""

    def batch_predict(self, model: M, queries: Sequence[Tuple[int, Q]]
                      ) -> List[Tuple[int, P]]:
        """Indexed batch predict. Override with a batched implementation
        where shapes allow (the query server micro-batches only then)."""
        return [(i, self.predict(model, q)) for i, q in queries]

    def warmup_query(self, model: M) -> Optional[Q]:
        """A representative query the deploy warm-up ladder can drive
        through this algorithm's scorers, or None."""
        return None

    def make_persistent_model(self, ctx, model: M) -> Any:
        """What the model store keeps for this algorithm
        (BaseAlgorithm.makePersistentModel:111): the model itself, or
        None to retrain it at deploy."""
        return model


class Serving(Generic[Q, P], abc.ABC):
    def supplement(self, query: Q) -> Q:
        return query

    @abc.abstractmethod
    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        """Combine per-algorithm predictions."""


class FirstServing(Serving):
    """The first algorithm's prediction wins."""

    def serve(self, query, predictions):
        return predictions[0]
