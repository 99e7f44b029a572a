"""Model files and model-store blobs of the port.

The reference persists a pickled blob that needs its JAX classes to load
(``predictionio_tpu/workflow/serialization.py``). The port stores an ALS
model as exactly ``user_vocab``, ``item_vocab``, ``U`` and ``V``: the
vocabularies as fixed-width unicode arrays and the factors as float32,
in an ``.npz``, so loading never unpickles anything.

* :func:`save_model` / :func:`load_model`: one model in an ``.npz``
  file (``train --out``, ``deploy --model``).
* :func:`serialize_models` / :func:`deserialize_models`: an engine
  instance's per-algorithm models as one tagged ``.npz`` blob for the
  model store; a slot persisted as ``None`` (:data:`RETRAIN_ON_DEPLOY`)
  is retrained at deploy. A blob that is not in this format — the
  reference's pickle among them — is refused with
  :class:`ModelFormatError`, never unpickled.
"""

from __future__ import annotations

import io
import zipfile
from typing import Any, List, Optional

import numpy as np

from predictionio_tpu_torch.models.als import ALSModel

_KEYS = ("user_vocab", "item_vocab", "U", "V")
#: the tag of the port's model-store blobs
BLOB_FORMAT = "pio-torch-models/1"


class ModelFormatError(ValueError):
    """A model file or blob is not in the port's format."""


class _RetrainSentinel:
    """Marks an algorithm slot whose model is retrained at deploy (the
    reference's Unit model, PAlgorithm.scala:112)."""

    def __repr__(self):
        return "RETRAIN_ON_DEPLOY"


RETRAIN_ON_DEPLOY = _RetrainSentinel()


def _arrays(model) -> dict:
    return {"user_vocab": np.asarray(model.user_vocab, dtype=str),
            "item_vocab": np.asarray(model.item_vocab, dtype=str),
            "U": np.asarray(model.U, np.float32),
            "V": np.asarray(model.V, np.float32)}


def save_model(path, model) -> None:
    """Write ``model``'s four arrays (any object with the ALS model's
    fields) to ``path`` (an ``.npz``)."""
    np.savez(path, **_arrays(model))


def load_model(path, device=None) -> ALSModel:
    """Load a ``.npz`` written by :func:`save_model` as a model served on
    ``device`` (default ``cuda``)."""
    with np.load(path, allow_pickle=False) as z:
        missing = [k for k in _KEYS if k not in z.files]
        if missing:
            raise ModelFormatError(f"{path}: not an ALS model file, "
                                   f"missing {missing}")
        return ALSModel.from_arrays(z["user_vocab"], z["item_vocab"],
                                    z["U"], z["V"], device=device)


def serialize_models(models: List[Any]) -> bytes:
    """One blob for an instance's models: ``None`` (or
    :data:`RETRAIN_ON_DEPLOY`) slots are retrained at deploy, the others
    must be ALS models."""
    arrays = {"format": np.asarray(BLOB_FORMAT),
              "slots": np.asarray(len(models), np.int64)}
    for i, m in enumerate(models):
        if m is None or m is RETRAIN_ON_DEPLOY:
            arrays[f"{i}/kind"] = np.asarray("retrain")
            continue
        if not isinstance(m, ALSModel):
            raise TypeError(f"slot {i}: the port persists ALS models only, "
                            f"not {type(m).__name__}")
        arrays[f"{i}/kind"] = np.asarray("als")
        arrays.update({f"{i}/{k}": v for k, v in _arrays(m).items()})
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def deserialize_models(blob: bytes, device=None) -> List[Optional[ALSModel]]:
    """The models of a blob written by :func:`serialize_models`, served
    on ``device`` (default ``cuda``); ``None`` for a retrain slot."""
    if not blob.startswith(b"PK"):
        raise ModelFormatError(
            "model blob is not the PyTorch port's format (tagged .npz); a "
            "pickled blob written by the JAX package is not loaded by the "
            "port: retrain the variant with the port")
    try:
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            tagged = "format" in z.files and str(z["format"]) == BLOB_FORMAT
            slots = [] if not tagged else [
                (str(z[f"{i}/kind"]), [z[f"{i}/{k}"] for k in _KEYS]
                 if str(z[f"{i}/kind"]) == "als" else None)
                for i in range(int(z["slots"]))]
    except (ValueError, KeyError, OSError, zipfile.BadZipFile) as e:
        raise ModelFormatError(f"unreadable model blob: {e!r}") from e
    if not tagged:
        raise ModelFormatError(f"model blob carries no {BLOB_FORMAT!r} tag")
    out: List[Optional[ALSModel]] = []
    for i, (kind, arrays) in enumerate(slots):
        if kind == "retrain":
            out.append(None)
        elif kind == "als":
            out.append(ALSModel.from_arrays(*arrays, device=device))
        else:
            raise ModelFormatError(f"slot {i}: unknown kind {kind!r}")
    return out
