"""Model blob store on the local filesystem (port of the reference's
``storage/localfs_models.py``, LocalFSModels.scala:32-62): the
``localfs`` source type, one file per model id under a base directory,
sharing :class:`FSModels`' implementation as in the reference."""

from __future__ import annotations

from predictionio_tpu_torch.storage.fs_models import FSModels


class LocalFSModels(FSModels):
    pass
