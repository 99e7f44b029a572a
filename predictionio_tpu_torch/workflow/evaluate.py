"""The evaluation workflow: run a sweep and record it as an
EvaluationInstance (port of the reference's ``workflow/evaluate.py``,
CoreWorkflow.runEvaluation, CoreWorkflow.scala:104-165).

An instance is inserted as INIT, the evaluation runs (MetricEvaluator
over the params list) on the workflow context's device, and the
instance is marked EVALCOMPLETED with the results in their one-liner,
HTML and JSON forms; a failure of any kind (an injected kill included)
marks it EVALFAILED and re-raises. The sweep is one trace
(``obs/tracing.adopt``): it joins the trace ``PIO_TRACE_CONTEXT`` or the
calling thread carries.
"""

from __future__ import annotations

import datetime as _dt
import logging
from typing import Optional, Sequence

from predictionio_tpu_torch.core.evaluation import (
    Evaluation, MetricEvaluatorResult,
)
from predictionio_tpu_torch.core.params import EngineParams
from predictionio_tpu_torch.data.event import UTC
from predictionio_tpu_torch.obs.trace_context import record_event
from predictionio_tpu_torch.obs.tracing import adopt
from predictionio_tpu_torch.storage.base import EvaluationInstance
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.device import DeviceLike
from predictionio_tpu_torch.workflow.context import (
    WorkflowContext, WorkflowParams,
)
from predictionio_tpu_torch.workflow.instrument import workflow_run_metrics

logger = logging.getLogger("pio.torch.workflow")


def run_evaluation(evaluation: Evaluation,
                   engine_params_list: Sequence[EngineParams],
                   evaluation_class: str = "",
                   params_generator_class: str = "",
                   workflow_params: Optional[WorkflowParams] = None,
                   ctx: Optional[WorkflowContext] = None,
                   device: DeviceLike = None) -> MetricEvaluatorResult:
    """Run ``evaluation`` over ``engine_params_list`` and record it;
    returns the evaluator's result (raises on failure, after marking the
    instance EVALFAILED). ``ctx`` defaults to a context on ``device``
    (``cuda`` unless the caller asks for the CPU)."""
    wp = workflow_params or WorkflowParams()
    ctx = ctx or WorkflowContext.create(
        mode="Evaluation", batch=wp.batch, workflow_params=wp, device=device)

    instances = Storage.get_meta_data_evaluation_instances()
    instance = EvaluationInstance(
        status="INIT",
        start_time=_dt.datetime.now(tz=UTC),
        evaluation_class=evaluation_class or type(evaluation).__name__,
        engine_params_generator_class=params_generator_class,
        batch=wp.batch,
        runtime_conf={k: str(v) for k, v in wp.runtime_conf.items()},
    )
    instance.id = instances.insert(instance)
    logger.info("EvaluationInstance %s created (INIT)", instance.id)
    try:
        with adopt("evaluate", attrs={"instance": instance.id}):
            with workflow_run_metrics("evaluate", "pio_eval"):
                result = evaluation.run(ctx, engine_params_list)
            # recorded inside the adopted trace so the completion event
            # carries the sweep's trace id
            record_event("eval_completed", {"instance": instance.id})
    except BaseException as e:
        # a failed sweep must not stay INIT (listed as forever starting);
        # BaseException on purpose, so an interrupt mid-sweep is recorded
        # too. The terminal write is best-effort (the store may be what
        # failed); the original failure always re-raises.
        try:
            instance.status = "EVALFAILED"
            instance.end_time = _dt.datetime.now(tz=UTC)
            instance.evaluator_results = f"{type(e).__name__}: {e}"
            instances.update(instance)
        except Exception:
            logger.exception("could not mark instance %s EVALFAILED",
                             instance.id)
        logger.exception("evaluation failed: instance %s", instance.id)
        raise

    instance.status = "EVALCOMPLETED"
    instance.end_time = _dt.datetime.now(tz=UTC)
    instance.evaluator_results = result.to_one_liner()
    instance.evaluator_results_html = result.to_html()
    instance.evaluator_results_json = result.to_json()
    instances.update(instance)
    logger.info("evaluation completed: instance %s — %s", instance.id,
                result.to_one_liner())
    return result
