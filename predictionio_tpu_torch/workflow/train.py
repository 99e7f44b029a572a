"""The train workflow: run an engine's pipeline and record it (port of
the reference's ``workflow/train.py``, CoreWorkflow.runTrain,
CoreWorkflow.scala:45-102).

An EngineInstance row is inserted as INIT, the engine trains on the
workflow context's device, the models go into the model store under the
instance's id, the instance is marked COMPLETED and registered as its
variant's next release. A failed train leaves the instance INIT, so it
is never deployed; a completed one clears its checkpoints. The run is one
trace (``obs/tracing.adopt``): it joins the trace ``PIO_TRACE_CONTEXT``
or the calling thread carries.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
from typing import Optional, Tuple

from predictionio_tpu_torch.core.engine import Engine, TrainResult
from predictionio_tpu_torch.core.params import EngineParams, params_to_json
from predictionio_tpu_torch.data.event import UTC
from predictionio_tpu_torch.obs.trace_context import record_event
from predictionio_tpu_torch.obs.tracing import adopt
from predictionio_tpu_torch.storage.base import EngineInstance, Model
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.device import DeviceLike
from predictionio_tpu_torch.workflow.context import (
    WorkflowContext, WorkflowParams,
)
from predictionio_tpu_torch.workflow.instrument import workflow_run_metrics
from predictionio_tpu_torch.workflow.serialization import serialize_models

logger = logging.getLogger("pio.torch.workflow")


def run_train(engine: Engine, engine_params: EngineParams,
              engine_factory: str = "", engine_variant: str = "default",
              workflow_params: Optional[WorkflowParams] = None,
              ctx: Optional[WorkflowContext] = None,
              device: DeviceLike = None
              ) -> Tuple[EngineInstance, TrainResult]:
    """Train and record; returns the COMPLETED instance and the
    TrainResult (raises on failure; ``workflow_params.stop_after_*``
    raise the engine's ``StopAfter*Interruption``, leaving the instance
    INIT). In a multi-process run only process 0 records; the others
    return ``(None, result)``. ``ctx`` defaults to a context on ``device`` (``cuda`` unless
    the caller asks for the CPU) with the checkpointer
    ``workflow_params.runtime_conf`` names."""
    from predictionio_tpu_torch.deploy.releases import record_release
    from predictionio_tpu_torch.parallel.distributed import group_rank_size

    wp = workflow_params or WorkflowParams()
    ctx = ctx or WorkflowContext.create(
        mode="Training", batch=wp.batch, workflow_params=wp, device=device)
    rank, world = group_rank_size()
    if world > 1 and rank != 0:
        # a multi-process train: every process trains (the collectives
        # need all of them), process 0 alone records the instance, the
        # models and the release; the others return no instance
        result = engine.train(ctx, engine_params,
                              skip_sanity_check=wp.skip_sanity_check,
                              stop_after_read=wp.stop_after_read,
                              stop_after_prepare=wp.stop_after_prepare)
        return None, result
    instances = Storage.get_meta_data_engine_instances()
    instance = EngineInstance(
        status="INIT",
        start_time=_dt.datetime.now(tz=UTC),
        engine_id=engine_factory or type(engine).__name__,
        engine_version="1",
        engine_variant=engine_variant,
        engine_factory=engine_factory,
        batch=wp.batch,
        runtime_conf={k: str(v) for k, v in wp.runtime_conf.items()},
        data_source_params=json.dumps(
            params_to_json(engine_params.data_source_params), sort_keys=True),
        preparator_params=json.dumps(
            params_to_json(engine_params.preparator_params), sort_keys=True),
        algorithms_params=json.dumps(
            [{"name": n, "params": params_to_json(p)}
             for n, p in engine_params.algorithm_params_list],
            sort_keys=True),
        serving_params=json.dumps(
            params_to_json(engine_params.serving_params), sort_keys=True),
    )
    instance.id = instances.insert(instance)
    logger.info("EngineInstance %s created (INIT)", instance.id)

    # the whole run is one trace: a parent pipeline (or a multi-process
    # launcher) hands its context via PIO_TRACE_CONTEXT, and an
    # in-process parent (an orchestrator cycle) via the active trace, so
    # this train's record joins the parent's trace id
    with adopt("train", attrs={"instance": instance.id,
                               "variant": engine_variant}):
        with workflow_run_metrics("train", "pio_train"):
            result = engine.train(ctx, engine_params,
                                  skip_sanity_check=wp.skip_sanity_check,
                                  stop_after_read=wp.stop_after_read,
                                  stop_after_prepare=wp.stop_after_prepare)
            blob = None
            if wp.save_model:
                blob = serialize_models(engine.persist_models(ctx, result))
                Storage.get_model_data_models().insert(
                    Model(id=instance.id, models=blob))
                logger.info("models saved (%d bytes) for instance %s",
                            len(blob), instance.id)
            instance.status = "COMPLETED"
            instance.end_time = _dt.datetime.now(tz=UTC)
            instances.update(instance)
        record_event("train_completed", {
            "instance": instance.id, "variant": engine_variant})

    record_release(instance,
                   train_seconds=(instance.end_time - instance.start_time
                                  ).total_seconds(),
                   blob=blob)
    if ctx.checkpointer is not None:
        # resume is for crashed or preempted runs: a completed run clears
        # its snapshots so the next train never resumes stale factors
        ctx.checkpointer.clear()
    logger.info("training completed: instance %s", instance.id)
    return instance, result


def load_for_deploy(engine: Engine, instance: EngineInstance,
                    ctx: Optional[WorkflowContext] = None,
                    device: DeviceLike = None
                    ) -> Tuple[TrainResult, WorkflowContext]:
    """A servable TrainResult from a COMPLETED instance's stored models
    (CreateServer.scala:204-206 + Engine.prepareDeploy:198) on ``ctx``'s
    device. A blob the port cannot read (the reference's pickle among
    them) raises ``DeployError``; without a blob every algorithm is
    retrained from the event store."""
    from predictionio_tpu_torch.deploy.warm import DeployError
    from predictionio_tpu_torch.workflow.serialization import (
        ModelFormatError, deserialize_models,
    )

    ctx = ctx or WorkflowContext.create(mode="Serving", batch=instance.batch,
                                        device=device)
    engine_params = engine_params_of_instance(engine, instance)
    model = Storage.get_model_data_models().get(instance.id)
    if model is None:
        persisted = [None] * len(engine_params.algorithm_params_list)
    else:
        try:
            persisted = deserialize_models(model.models, device=ctx.device)
        except ModelFormatError as e:
            raise DeployError(
                f"engine instance {instance.id}: {e}") from e
    return engine.prepare_deploy(engine_params, persisted, ctx=ctx), ctx


def engine_params_of_instance(engine: Engine,
                              instance: EngineInstance) -> EngineParams:
    """EngineInstance params JSON -> EngineParams
    (Engine.engineInstanceToEngineParams:420 parity)."""
    return engine.engine_params_from_json({
        "datasource": {"params": json.loads(
            instance.data_source_params or "{}")},
        "preparator": {"params": json.loads(
            instance.preparator_params or "{}")},
        "algorithms": json.loads(instance.algorithms_params or "[]"),
        "serving": {"params": json.loads(instance.serving_params or "{}")},
    })
