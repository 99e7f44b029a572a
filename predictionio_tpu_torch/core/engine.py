"""The Engine (port of the reference's ``core/engine.py``): registries of
named DASE component classes, ``train`` (read, prepare, train each
algorithm — object Engine.train, Engine.scala:623), what the model store
keeps of a train (``persist_models``) and the assembly of a
:class:`TrainResult` from persisted models for a deploy
(``prepare_deploy``), and evaluation (``eval``: train on
each fold and predict its queries, Engine.scala:728-818)."""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Sequence, Tuple, Union

from predictionio_tpu_torch.core.base import (
    Algorithm, DataSource, Preparator, SanityCheck, Serving, instantiate,
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


def _sanity(obj: Any, what: str, skip: bool) -> None:
    """Engine.scala:650-706 — run the object's SanityCheck, if it has
    one."""
    if skip:
        return
    if isinstance(obj, SanityCheck):
        logger.debug("%s: running sanity check on %s", what,
                     type(obj).__name__)
        obj.sanity_check()


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

    def _data_source(self, ep: EngineParams) -> DataSource:
        return instantiate(_pick(self.data_source_classes,
                                 ep.data_source_name, "data source"),
                           ep.data_source_params)

    def _preparator(self, ep: EngineParams) -> Preparator:
        return instantiate(_pick(self.preparator_classes,
                                 ep.preparator_name, "preparator"),
                           ep.preparator_params)

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

    def train(self, ctx, engine_params: EngineParams,
              skip_sanity_check: bool = False,
              stop_after_read: bool = False,
              stop_after_prepare: bool = False) -> TrainResult:
        """Read the training data, prepare it, and train every
        algorithm on it (object Engine.train, Engine.scala:623), running
        each SanityCheck on the way unless ``skip_sanity_check``; the
        ``stop_after_*`` debug stops raise their interruption with the
        data read so far."""
        td = self._data_source(engine_params).read_training(ctx)
        _sanity(td, "training data", skip_sanity_check)
        if stop_after_read:
            raise StopAfterReadInterruption(td)
        pd = self._preparator(engine_params).prepare(ctx, td)
        _sanity(pd, "prepared data", skip_sanity_check)
        if stop_after_prepare:
            raise StopAfterPrepareInterruption(pd)
        named_algos = self._algorithms(engine_params)
        models = []
        shared_ckpt = getattr(ctx, "checkpointer", None)
        for i, (name, algo) in enumerate(named_algos):
            logger.info("training algorithm %s (%s)", name or "<default>",
                        type(algo).__name__)
            if shared_ckpt is not None:
                # one namespace per algorithm: algorithm i never resumes
                # from algorithm j's snapshots
                ctx.checkpointer = shared_ckpt.scoped(
                    f"algo_{i}_{name or type(algo).__name__}")
            try:
                model = algo.train(ctx, pd)
            finally:
                if shared_ckpt is not None:
                    ctx.checkpointer = shared_ckpt
            _sanity(model, f"model of {name or type(algo).__name__}",
                    skip_sanity_check)
            models.append(model)
        return TrainResult(models=models,
                           algorithms=[a for _, a in named_algos],
                           serving=self._serving(engine_params),
                           engine_params=engine_params)

    def persist_models(self, ctx, train_result: TrainResult) -> List[Any]:
        """What the model store keeps per algorithm
        (Engine.scala:284-311): the model, or None to retrain it at
        deploy."""
        return [algo.make_persistent_model(ctx, model)
                for algo, model in zip(train_result.algorithms,
                                       train_result.models)]

    def prepare_deploy(self, engine_params: EngineParams,
                       persisted: Sequence[Any], ctx=None) -> TrainResult:
        """Pair each persisted model with its instantiated algorithm
        (Engine.prepareDeploy:198); a slot persisted as None is retrained
        from the event store on ``ctx`` (read and prepared once)."""
        named_algos = self._algorithms(engine_params)
        if len(persisted) != len(named_algos):
            raise ValueError(
                f"{len(persisted)} model(s) for {len(named_algos)} "
                "algorithm(s)")
        models = list(persisted)
        if any(m is None for m in models):
            logger.info("some models are not persisted; retraining for "
                        "deploy")
            td = self._data_source(engine_params).read_training(ctx)
            pd = self._preparator(engine_params).prepare(ctx, td)
            models = [algo.train(ctx, pd) if m is None else m
                      for (_, algo), m in zip(named_algos, models)]
        return TrainResult(models=models,
                           algorithms=[a for _, a in named_algos],
                           serving=self._serving(engine_params),
                           engine_params=engine_params)

    def eval(self, ctx, engine_params: EngineParams,
             skip_sanity_check: bool = True):
        """``[(EvalInfo, [(Q, P, A)])]`` per fold: train on each fold's
        training data and predict its queries through supplement and
        serve (object Engine.eval, Engine.scala:728)."""
        eval_data = self._data_source(engine_params).read_eval(ctx)
        preparator = self._preparator(engine_params)
        named_algos = self._algorithms(engine_params)
        serving = self._serving(engine_params)
        results = []
        for fold_idx, (td, eval_info, qa_pairs) in enumerate(eval_data):
            _sanity(td, f"fold {fold_idx} training data", skip_sanity_check)
            pd = preparator.prepare(ctx, td)
            models = [algo.train(ctx, pd) for _, algo in named_algos]
            results.append((eval_info, evaluate_fold(
                named_algos, models, serving, qa_pairs)))
        return results

    def batch_eval(self, ctx, engine_params_list: Sequence[EngineParams]):
        """BaseEngine.batchEval:82 — ``eval`` per params."""
        return [(ep, self.eval(ctx, ep)) for ep in engine_params_list]


def evaluate_fold(named_algos, models, serving, qa_pairs):
    """One fold's predict pipeline (Engine.scala:767-812): supplement
    each query, batch-predict per algorithm, align per query, serve."""
    supplemented = [(i, serving.supplement(q))
                    for i, (q, _a) in enumerate(qa_pairs)]
    per_algo = [dict(algo.batch_predict(model, supplemented))
                for (_name, algo), model in zip(named_algos, models)]
    return [(q, serving.serve(q, [preds[i] for preds in per_algo]), a)
            for i, (q, a) in enumerate(qa_pairs)]


class StopAfterReadInterruption(Exception):
    """The ``stop_after_read`` debug stop (CreateWorkflow.scala)."""

    def __init__(self, training_data):
        super().__init__("stopped after read")
        self.training_data = training_data


class StopAfterPrepareInterruption(Exception):
    """The ``stop_after_prepare`` debug stop."""

    def __init__(self, prepared_data):
        super().__init__("stopped after prepare")
        self.prepared_data = prepared_data
