"""Model files of the port: an ALS model's four arrays in one ``.npz``.

The reference persists a pickled blob that needs its JAX classes to load
(``predictionio_tpu/workflow/serialization.py``). The port stores exactly
``user_vocab``, ``item_vocab``, ``U`` and ``V`` instead: the vocabularies
as fixed-width unicode arrays and the factors as float32, so loading
never unpickles anything.
"""

from __future__ import annotations

import numpy as np

from predictionio_tpu_torch.models.als import ALSModel

_KEYS = ("user_vocab", "item_vocab", "U", "V")


def save_model(path, model) -> None:
    """Write ``model``'s four arrays (any object with the ALS model's
    fields) to ``path`` (an ``.npz``)."""
    np.savez(path,
             user_vocab=np.asarray(model.user_vocab, dtype=str),
             item_vocab=np.asarray(model.item_vocab, dtype=str),
             U=np.asarray(model.U, np.float32),
             V=np.asarray(model.V, np.float32))


def load_model(path, device=None) -> ALSModel:
    """Load a ``.npz`` written by :func:`save_model` as a model served on
    ``device`` (default ``cuda``)."""
    with np.load(path, allow_pickle=False) as z:
        missing = [k for k in _KEYS if k not in z.files]
        if missing:
            raise ValueError(f"{path}: not an ALS model file, missing "
                             f"{missing}")
        return ALSModel.from_arrays(z["user_vocab"], z["item_vocab"],
                                    z["U"], z["V"], device=device)
