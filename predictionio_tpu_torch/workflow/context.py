"""The workflow context (port of the reference's ``workflow/context.py``,
WorkflowContext.scala:28-47): what every DataSource read,
``Algorithm.train`` and deploy of one workflow run receives. Where the
reference builds a device mesh, the port holds one torch device; the
mid-training checkpointer rides with it.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional

from predictionio_tpu_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger("pio.torch.workflow")


@dataclasses.dataclass
class WorkflowParams:
    """WorkflowParams.scala:32 — the workflow-level settings the port
    reads: the batch label, whether the models are saved, the train's
    sanity-check skip and debug stops, and the runtime settings
    (``checkpoint_dir`` / ``checkpoint_interval``; the reference's
    sparkConf)."""

    batch: str = ""
    save_model: bool = True
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False
    runtime_conf: Dict[str, str] = dataclasses.field(default_factory=dict)


class WorkflowContext:
    """The device and the checkpointer of one workflow run."""

    def __init__(self, mode: str = "", batch: str = "",
                 device: DeviceLike = None):
        self.mode = mode
        self.batch = batch
        #: every model of the run lives here; ``cuda`` unless the
        #: caller asked for the CPU
        self.device = resolve_device(device)
        #: mid-training Checkpointer (workflow/checkpoint.py), set from
        #: runtime_conf checkpoint_dir/checkpoint_interval; None = off
        self.checkpointer = None
        logger.info("WorkflowContext: mode=%s batch=%s device=%s", mode,
                    batch, self.device)

    @classmethod
    def create(cls, mode: str = "", batch: str = "",
               workflow_params: Optional[WorkflowParams] = None,
               device: DeviceLike = None) -> "WorkflowContext":
        """WorkflowContext.apply parity: the device first (so a missing
        card fails before anything is written), then the checkpointer."""
        conf = dict(workflow_params.runtime_conf) if workflow_params else {}
        ctx = cls(mode=mode, batch=batch, device=device)
        ckpt_dir = conf.get("checkpoint_dir")
        if ckpt_dir:
            from predictionio_tpu_torch.workflow.checkpoint import (
                Checkpointer,
            )

            ctx.checkpointer = Checkpointer(
                ckpt_dir, interval=int(conf.get("checkpoint_interval", 10)))
        return ctx
