"""Model blob store on a filesystem (port of the reference's
``storage/fs_models.py``): one file per model id,
``<root>/pio_model_<id>.bin``, written to a temporary name in the same
directory and renamed over the final one, so a reader during a deploy
sees the old blob or the new one, never half of one.

The reference reaches any fsspec URL (``s3://``, ``hdfs://``,
``memory://``); the machine with the card has no fsspec, so the port
takes local paths (plain or ``file://``) and refuses other schemes. The
file names are the reference's, so either package reads the other's
blobs.
"""

from __future__ import annotations

import os
import uuid
from typing import Optional

from predictionio_tpu_torch.storage import base
from predictionio_tpu_torch.storage.base import Model


class FSModels(base.Models):
    def __init__(self, url: str):
        scheme, sep, rest = url.partition("://")
        if sep and scheme != "file":
            raise NotImplementedError(
                f"model store {url!r}: only local paths are ported to "
                "PyTorch (the reference reaches fsspec URLs)")
        self.url = url
        self.root = os.path.abspath(rest if sep else url)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, model_id: str) -> str:
        if "/" in model_id or model_id.startswith("."):
            raise ValueError(f"invalid model id {model_id!r}")
        return os.path.join(self.root, f"pio_model_{model_id}.bin")

    def insert(self, model: Model) -> None:
        path = self._path(model.id)
        tmp = f"{path}.tmp-{uuid.uuid4().hex}"
        try:
            with open(tmp, "wb") as f:
                f.write(model.models)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def get(self, model_id: str) -> Optional[Model]:
        try:
            with open(self._path(model_id), "rb") as f:
                return Model(id=model_id, models=f.read())
        except FileNotFoundError:
            return None

    def delete(self, model_id: str) -> None:
        try:
            os.unlink(self._path(model_id))
        except FileNotFoundError:
            pass
