"""The workflow context (port of the reference's ``workflow/context.py``,
WorkflowContext.scala:28-47): what every DataSource read,
``Algorithm.train`` and deploy of one workflow run receives: the torch
device, the mesh of positions built lazily on first use
(``parallel/mesh``; by default one position per process of the
``torch.distributed`` group, this process's on the device; the engine
variant may ask for a shape through runtime_conf ``mesh_shape`` /
``mesh_axes``) and the mid-training checkpointer.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional, Sequence

from predictionio_tpu_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger("pio.torch.workflow")


@dataclasses.dataclass
class WorkflowParams:
    """WorkflowParams.scala:32 — the workflow-level settings the port
    reads: the batch label, whether the models are saved, the train's
    sanity-check skip and debug stops, and the runtime settings
    (``checkpoint_dir`` / ``checkpoint_interval``, ``mesh_shape`` /
    ``mesh_axes``; the reference's sparkConf)."""

    batch: str = ""
    save_model: bool = True
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False
    runtime_conf: Dict[str, str] = dataclasses.field(default_factory=dict)


def mesh_of(ctx):
    """The mesh of a workflow context, or a default mesh on the
    context's device (``device`` attribute; None: ``cuda``) when the
    caller passed a bare context (tests, embedded use). Shared by every
    algorithm that trains on the mesh."""
    mesh = getattr(ctx, "mesh", None)
    if mesh is None:
        from predictionio_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(device=getattr(ctx, "device", None))
    return mesh


class WorkflowContext:
    """The device, the mesh and the checkpointer of one workflow run."""

    def __init__(self, mode: str = "", batch: str = "",
                 device: DeviceLike = None,
                 mesh_shape: Optional[Sequence[int]] = None,
                 mesh_axes: Optional[Sequence[str]] = None):
        self.mode = mode
        self.batch = batch
        #: every model of the run lives here; ``cuda`` unless the
        #: caller asked for the CPU
        self.device = resolve_device(device)
        self._mesh = None
        self._mesh_shape = tuple(mesh_shape) if mesh_shape else None
        self._mesh_axes = tuple(mesh_axes) if mesh_axes else None
        #: mid-training Checkpointer (workflow/checkpoint.py), set from
        #: runtime_conf checkpoint_dir/checkpoint_interval; None = off
        self.checkpointer = None
        logger.info("WorkflowContext: mode=%s batch=%s device=%s", mode,
                    batch, self.device)

    # -- mesh ---------------------------------------------------------------
    @property
    def mesh(self):
        """The mesh, built on first use (WorkflowContext.scala:45)."""
        if self._mesh is None:
            from predictionio_tpu_torch.parallel.mesh import make_mesh

            self._mesh = make_mesh(self._mesh_shape, self._mesh_axes,
                                   device=self.device)
            logger.info("mesh: %s", self._mesh)
        return self._mesh

    @property
    def num_devices(self) -> int:
        """Positions of the mesh."""
        return self.mesh.size

    def local_mesh(self):
        """A mesh of one position on the context's device (the
        reference's L-component path)."""
        from predictionio_tpu_torch.parallel.mesh import make_mesh

        return make_mesh(devices=[self.device])

    @classmethod
    def create(cls, mode: str = "", batch: str = "",
               workflow_params: Optional[WorkflowParams] = None,
               device: DeviceLike = None) -> "WorkflowContext":
        """WorkflowContext.apply parity: the device first (so a missing
        card fails before anything is written), the mesh's shape and
        axes, then the checkpointer."""
        from predictionio_tpu_torch.parallel.mesh import mesh_shape_from_conf

        conf = dict(workflow_params.runtime_conf) if workflow_params else {}
        mesh_shape, mesh_axes = mesh_shape_from_conf(conf)
        ctx = cls(mode=mode, batch=batch, device=device,
                  mesh_shape=mesh_shape, mesh_axes=mesh_axes)
        ckpt_dir = conf.get("checkpoint_dir")
        if ckpt_dir:
            from predictionio_tpu_torch.workflow.checkpoint import (
                Checkpointer,
            )

            ctx.checkpointer = Checkpointer(
                ckpt_dir, interval=int(conf.get("checkpoint_interval", 10)))
        return ctx
