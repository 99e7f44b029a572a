"""The Engine, serving subset (port of the reference's
``core/engine.py``): registries of named algorithm and serving classes,
and the assembly of a :class:`TrainResult` from persisted models — what
a deploy needs. Training and evaluation drivers come with the training
slice."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Union

from predictionio_tpu_torch.core.base import (
    Algorithm, Serving, instantiate, params_class_of,
)
from predictionio_tpu_torch.core.params import (
    EngineParams, engine_params_from_json,
)

ClassMap = Union[type, Dict[str, type]]


def _as_map(classes: ClassMap) -> Dict[str, type]:
    if isinstance(classes, dict):
        return dict(classes)
    return {"": classes}


def _pick(classes: Dict[str, type], name: str, what: str) -> type:
    if name in classes:
        return classes[name]
    if name == "" and len(classes) == 1:
        return next(iter(classes.values()))
    raise KeyError(f"unknown {what} name {name!r}; known: {sorted(classes)}")


@dataclasses.dataclass
class TrainResult:
    """Per-algorithm models plus the instantiated components."""

    models: List[Any]
    algorithms: List[Algorithm]
    serving: Serving
    engine_params: EngineParams


class Engine:
    """Name -> class maps for the serving components."""

    def __init__(self, algorithm_classes: ClassMap,
                 serving_classes: ClassMap):
        self.algorithm_classes = _as_map(algorithm_classes)
        self.serving_classes = _as_map(serving_classes)

    def engine_params_from_json(self, data: dict) -> EngineParams:
        """Parse an engine.json's algorithms and serving sections,
        resolving each component's params class."""
        algo_params_classes = {
            name: params_class_of(cls)
            for name, cls in self.algorithm_classes.items()}
        if "" not in algo_params_classes and len(self.algorithm_classes) == 1:
            algo_params_classes[""] = params_class_of(
                next(iter(self.algorithm_classes.values())))
        serving_name = (data.get("serving") or {}).get("name", "")
        return engine_params_from_json(
            data, algorithm_params_classes=algo_params_classes,
            serving_params_class=params_class_of(
                _pick(self.serving_classes, serving_name, "serving")))

    def prepare_deploy(self, engine_params: EngineParams,
                       models: Sequence[Any]) -> TrainResult:
        """Pair each persisted model with its instantiated algorithm."""
        if not engine_params.algorithm_params_list:
            raise ValueError("EngineParams.algorithm_params_list must not "
                             "be empty")
        if len(models) != len(engine_params.algorithm_params_list):
            raise ValueError(
                f"{len(models)} model(s) for "
                f"{len(engine_params.algorithm_params_list)} algorithm(s)")
        algorithms = [
            instantiate(_pick(self.algorithm_classes, name, "algorithm"),
                        params)
            for name, params in engine_params.algorithm_params_list]
        serving = instantiate(
            _pick(self.serving_classes, engine_params.serving_name,
                  "serving"), engine_params.serving_params)
        return TrainResult(models=list(models), algorithms=algorithms,
                           serving=serving, engine_params=engine_params)
