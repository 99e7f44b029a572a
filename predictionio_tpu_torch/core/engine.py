"""The Engine (port of the reference's ``core/engine.py``): registries of
named DASE component classes, ``train`` (read, prepare, train each
algorithm — object Engine.train, Engine.scala:623) and the assembly of a
:class:`TrainResult` from persisted models for a deploy. The evaluation
driver and the model store's persistence come with later slices."""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Sequence, Tuple, Union

from predictionio_tpu_torch.core.base import (
    Algorithm, DataSource, Preparator, Serving, instantiate,
    params_class_of,
)
from predictionio_tpu_torch.core.params import (
    EngineParams, engine_params_from_json,
)

logger = logging.getLogger("pio.torch.engine")

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
    """Name -> class maps for the DASE components (Engine.scala:82)."""

    def __init__(self, data_source_classes: ClassMap,
                 preparator_classes: ClassMap,
                 algorithm_classes: ClassMap,
                 serving_classes: ClassMap):
        self.data_source_classes = _as_map(data_source_classes)
        self.preparator_classes = _as_map(preparator_classes)
        self.algorithm_classes = _as_map(algorithm_classes)
        self.serving_classes = _as_map(serving_classes)

    def _algorithms(self, ep: EngineParams) -> List[Tuple[str, Algorithm]]:
        if not ep.algorithm_params_list:
            raise ValueError("EngineParams.algorithm_params_list must not "
                             "be empty")
        return [(name, instantiate(
                    _pick(self.algorithm_classes, name, "algorithm"), params))
                for name, params in ep.algorithm_params_list]

    def _serving(self, ep: EngineParams) -> Serving:
        return instantiate(_pick(self.serving_classes, ep.serving_name,
                                 "serving"), ep.serving_params)

    def engine_params_from_json(self, data: dict) -> EngineParams:
        """Parse an engine.json, resolving each component's params
        class."""
        algo_params_classes = {
            name: params_class_of(cls)
            for name, cls in self.algorithm_classes.items()}
        if "" not in algo_params_classes and len(self.algorithm_classes) == 1:
            algo_params_classes[""] = params_class_of(
                next(iter(self.algorithm_classes.values())))

        def section_class(key: str, classes: Dict[str, type], what: str):
            name = (data.get(key) or {}).get("name", "")
            return params_class_of(_pick(classes, name, what))

        return engine_params_from_json(
            data,
            data_source_params_class=section_class(
                "datasource", self.data_source_classes, "data source"),
            preparator_params_class=section_class(
                "preparator", self.preparator_classes, "preparator"),
            algorithm_params_classes=algo_params_classes,
            serving_params_class=section_class(
                "serving", self.serving_classes, "serving"))

    def train(self, ctx, engine_params: EngineParams) -> TrainResult:
        """Read the training data, prepare it, and train every
        algorithm on it (object Engine.train, Engine.scala:623)."""
        data_source: DataSource = instantiate(
            _pick(self.data_source_classes, engine_params.data_source_name,
                  "data source"), engine_params.data_source_params)
        td = data_source.read_training(ctx)
        preparator: Preparator = instantiate(
            _pick(self.preparator_classes, engine_params.preparator_name,
                  "preparator"), engine_params.preparator_params)
        pd = preparator.prepare(ctx, td)
        named_algos = self._algorithms(engine_params)
        models = []
        for name, algo in named_algos:
            logger.info("training algorithm %s (%s)", name or "<default>",
                        type(algo).__name__)
            models.append(algo.train(ctx, pd))
        return TrainResult(models=models,
                           algorithms=[a for _, a in named_algos],
                           serving=self._serving(engine_params),
                           engine_params=engine_params)

    def prepare_deploy(self, engine_params: EngineParams,
                       models: Sequence[Any]) -> TrainResult:
        """Pair each persisted model with its instantiated algorithm."""
        named_algos = self._algorithms(engine_params)
        if len(models) != len(named_algos):
            raise ValueError(
                f"{len(models)} model(s) for {len(named_algos)} "
                "algorithm(s)")
        return TrainResult(models=list(models),
                           algorithms=[a for _, a in named_algos],
                           serving=self._serving(engine_params),
                           engine_params=engine_params)
