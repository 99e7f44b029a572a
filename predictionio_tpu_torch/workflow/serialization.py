"""Model files and model-store blobs of the port.

The reference persists a pickled blob that needs its JAX classes to load
(``predictionio_tpu/workflow/serialization.py``). The port stores each
model as plain arrays in an ``.npz``, so loading never unpickles
anything: factors as float32, vocabularies as fixed-width unicode, the
item metadata, popularity counts and ``$set`` user fields as JSON text,
and cooccurrence top lists as two ``[n_items, k]`` int32 arrays (ids and
counts, count 0 as padding). Each blob slot carries its model's kind:

  ``als``               the recommendation engine's ``ALSModel``
  ``ecomm``             e-commerce's ``ECommModel``
  ``similarity``        similar-product's ``SimilarityModel`` (als and
                        likealgo)
  ``cooccurrence``      similar-product's ``CooccurrenceEngineModel``
  ``recommended_user``  recommended-user's ``RecommendedUserModel``
  ``nb``                classification's ``MultinomialNBModel``
  ``logreg``            classification's ``LogRegModel``
  ``forest``            classification's ``ForestModel`` (thresholds,
                        node arrays and depth as arrays)
  ``seqrec``            sessionrec's ``SeqRecModel`` (the item
                        vocabulary, every parameter by its flat name
                        under ``param/``, the hyperparameters as JSON)

A classifier's label vocabulary is JSON text (values and dtype), so a
blob is never unpickled.

* :func:`save_model` / :func:`load_model`: one model in an ``.npz``
  file (``train --out``, ``deploy --model``); an ALS model keeps the
  four-array layout, any other kind is a one-slot blob.
* :func:`serialize_models` / :func:`deserialize_models`: an engine
  instance's per-algorithm models as one tagged ``.npz`` blob for the
  model store; a slot persisted as ``None`` (:data:`RETRAIN_ON_DEPLOY`)
  is retrained at deploy. A blob that is not in this format — the
  reference's pickle among them — is refused with
  :class:`ModelFormatError`, never unpickled. Blobs written before the
  other kinds existed (ALS slots only) load unchanged.
"""

from __future__ import annotations

import dataclasses
import io
import json
import zipfile
from typing import Any, Callable, Dict, List, Optional, Tuple

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


def _vocab(v) -> np.ndarray:
    return np.asarray(v, dtype=str)


def _factors(m) -> np.ndarray:
    return np.asarray(m, np.float32)


def _json(obj) -> np.ndarray:
    return np.asarray(json.dumps(obj, sort_keys=True))


def _unjson(a: np.ndarray):
    return json.loads(str(a))


def _labels_json(labels: np.ndarray) -> np.ndarray:
    """A label vocabulary as JSON text: its values and numpy dtype
    (``object`` for the engines' string labels)."""
    return _json({"dtype": str(labels.dtype),
                  "values": np.asarray(labels).tolist()})


def _labels_of(a: np.ndarray) -> np.ndarray:
    doc = _unjson(a)
    return np.asarray(doc["values"], dtype=np.dtype(doc["dtype"]))


def _items_json(items) -> np.ndarray:
    """``{index: Item}`` as ``{"index": categories or null}``."""
    return _json({str(i): it.categories for i, it in items.items()})


def _items_of(a: np.ndarray):
    from predictionio_tpu_torch.engines.common import Item

    return {int(i): Item(categories=c) for i, c in _unjson(a).items()}


def _arrays(model) -> dict:
    return {"user_vocab": _vocab(model.user_vocab),
            "item_vocab": _vocab(model.item_vocab),
            "U": _factors(model.U), "V": _factors(model.V)}


def top_lists(top: Dict[int, List[Tuple[int, int]]], n_items: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Cooccurrence top lists as ``(ids, counts)`` ``[n_items, k]``
    int32, count 0 (id 0) padding a short list."""
    k = max((len(v) for v in top.values()), default=0)
    ids = np.zeros((n_items, k), np.int32)
    counts = np.zeros((n_items, k), np.int32)
    for item, lst in top.items():
        if lst:
            ids[item, :len(lst)], counts[item, :len(lst)] = zip(*lst)
    return ids, counts


def _top_dict(ids: np.ndarray, counts: np.ndarray
              ) -> Dict[int, List[Tuple[int, int]]]:
    out = {}
    for item in np.flatnonzero(counts[:, 0] > 0) if counts.size else ():
        keep = counts[item] > 0
        out[int(item)] = [(int(j), int(c)) for j, c in
                          zip(ids[item][keep], counts[item][keep])]
    return out


# -- one codec per kind: (model class, to arrays, from arrays) ---------------

def _codecs() -> Dict[str, Tuple[type, Callable, Callable]]:
    from predictionio_tpu_torch.engines.ecommerce import (
        ECommModel, normalized_rows,
    )
    from predictionio_tpu_torch.engines.recommended_user import (
        RecommendedUserModel,
    )
    from predictionio_tpu_torch.engines.similarproduct import (
        CooccurrenceEngineModel, SimilarityModel,
    )
    from predictionio_tpu_torch.models.cooccurrence import CooccurrenceModel
    from predictionio_tpu_torch.models.forest import ForestModel
    from predictionio_tpu_torch.models.logreg import LogRegModel
    from predictionio_tpu_torch.models.naive_bayes import MultinomialNBModel
    from predictionio_tpu_torch.models.seqrec import (
        SeqRecModel, SeqRecParams,
    )

    def ecomm_in(z, device):
        V = z["V"]
        return ECommModel(
            user_vocab=z["user_vocab"], item_vocab=z["item_vocab"],
            U=z["U"], V=V, V_normalized=normalized_rows(V),
            items=_items_of(z["items"]),
            popular_count={int(i): int(c) for i, c in
                           _unjson(z["popular_count"]).items()},
            device=device)

    def cooc_out(m):
        ids, counts = top_lists(m.model.top_cooccurrences,
                                len(m.model.item_vocab))
        return {"item_vocab": _vocab(m.model.item_vocab), "top_ids": ids,
                "top_counts": counts, "items": _items_json(m.items)}

    def cooc_in(z, device):
        return CooccurrenceEngineModel(
            model=CooccurrenceModel(
                item_vocab=z["item_vocab"],
                top_cooccurrences=_top_dict(z["top_ids"], z["top_counts"])),
            items=_items_of(z["items"]), device=device)

    def forest_out(m):
        return {"classes": _labels_json(m.classes),
                "thresholds": np.asarray(m.thresholds, np.float32),
                "feat": np.asarray(m.feat, np.int32),
                "thr": np.asarray(m.thr, np.int32),
                "leaf": np.asarray(m.leaf, np.int32),
                "max_depth": np.asarray(int(m.max_depth), np.int64)}

    def forest_in(z, device):
        return ForestModel(classes=_labels_of(z["classes"]),
                           thresholds=z["thresholds"], feat=z["feat"],
                           thr=z["thr"], leaf=z["leaf"],
                           max_depth=int(z["max_depth"]), device=device)

    def seqrec_out(m):
        return {"item_vocab": _vocab(m.item_vocab),
                "hyper": _json(dataclasses.asdict(m.hyper)),
                **{f"param/{k}": np.asarray(v, np.float32)
                   for k, v in m.params.items()}}

    def seqrec_in(z, device):
        return SeqRecModel(
            item_vocab=z["item_vocab"],
            params={k[len("param/"):]: v for k, v in z.items()
                    if k.startswith("param/")},
            hyper=SeqRecParams(**_unjson(z["hyper"])), device=device)

    return {
        "als": (ALSModel, _arrays,
                lambda z, device: ALSModel.from_arrays(
                    *(z[k] for k in _KEYS), device=device)),
        "ecomm": (ECommModel,
                  lambda m: dict(_arrays(m), items=_items_json(m.items),
                                 popular_count=_json(
                                     {str(i): int(c) for i, c in
                                      m.popular_count.items()})),
                  ecomm_in),
        "similarity": (
            SimilarityModel,
            lambda m: {"item_vocab": _vocab(m.item_vocab),
                       "V": _factors(m.V), "items": _items_json(m.items)},
            lambda z, device: SimilarityModel(
                item_vocab=z["item_vocab"], V=z["V"],
                items=_items_of(z["items"]), device=device)),
        "cooccurrence": (CooccurrenceEngineModel, cooc_out, cooc_in),
        "recommended_user": (
            RecommendedUserModel,
            lambda m: {"user_vocab": _vocab(m.user_vocab),
                       "V": _factors(m.V), "users": _json(m.users)},
            lambda z, device: RecommendedUserModel(
                user_vocab=z["user_vocab"], V=z["V"],
                users=_unjson(z["users"]), device=device)),
        "nb": (
            MultinomialNBModel,
            lambda m: {"label_vocab": _labels_json(m.label_vocab),
                       "log_prior": np.asarray(m.log_prior, np.float32),
                       "log_prob": np.asarray(m.log_prob, np.float32)},
            lambda z, device: MultinomialNBModel(
                label_vocab=_labels_of(z["label_vocab"]),
                log_prior=z["log_prior"], log_prob=z["log_prob"],
                device=device)),
        "logreg": (
            LogRegModel,
            lambda m: {"label_vocab": _labels_json(m.label_vocab),
                       "W": np.asarray(m.W, np.float32),
                       "b": np.asarray(m.b, np.float32)},
            lambda z, device: LogRegModel(
                label_vocab=_labels_of(z["label_vocab"]), W=z["W"],
                b=z["b"])),
        "forest": (ForestModel, forest_out, forest_in),
        "seqrec": (SeqRecModel, seqrec_out, seqrec_in),
    }


def _encode(model, codecs) -> Tuple[str, dict]:
    for kind, (cls, out, _in) in codecs.items():
        if type(model) is cls:
            return kind, out(model)
    raise TypeError(
        f"the port persists these model kinds only ({', '.join(codecs)}), "
        f"not "
        f"{type(model).__name__}")


def save_model(path, model) -> None:
    """Write ``model`` to ``path`` (an ``.npz``): an ALS model (any
    object with its four fields) as ``user_vocab``, ``item_vocab``,
    ``U`` and ``V``; a model of another kind as a one-slot blob."""
    if isinstance(model, ALSModel) or not any(
            type(model) is cls for cls, _, _ in _codecs().values()):
        np.savez(path, **_arrays(model))
        return
    with open(path, "wb") as f:
        f.write(serialize_models([model]))


def load_model(path, device=None):
    """Load a ``.npz`` written by :func:`save_model` as a model served on
    ``device`` (default ``cuda``)."""
    with np.load(path, allow_pickle=False) as z:
        if "format" in z.files:
            return _decode(_read(z), device)[0]
        missing = [k for k in _KEYS if k not in z.files]
        if missing:
            raise ModelFormatError(f"{path}: not an ALS model file, "
                                   f"missing {missing}")
        return ALSModel.from_arrays(z["user_vocab"], z["item_vocab"],
                                    z["U"], z["V"], device=device)


def serialize_models(models: List[Any]) -> bytes:
    """One blob for an instance's models: ``None`` (or
    :data:`RETRAIN_ON_DEPLOY`) slots are retrained at deploy, the others
    must be models of a kind in the module docstring."""
    codecs = _codecs()
    arrays = {"format": np.asarray(BLOB_FORMAT),
              "slots": np.asarray(len(models), np.int64)}
    for i, m in enumerate(models):
        if m is None or m is RETRAIN_ON_DEPLOY:
            arrays[f"{i}/kind"] = np.asarray("retrain")
            continue
        try:
            kind, fields = _encode(m, codecs)
        except TypeError as e:
            raise TypeError(f"slot {i}: {e}") from None
        arrays[f"{i}/kind"] = np.asarray(kind)
        arrays.update({f"{i}/{k}": v for k, v in fields.items()})
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _read(z) -> Dict[str, np.ndarray]:
    """Every array of a tagged ``.npz``, read into memory."""
    if "format" not in z.files or str(z["format"]) != BLOB_FORMAT:
        raise ModelFormatError(
            f"model blob carries no {BLOB_FORMAT!r} tag")
    return {k: z[k] for k in z.files}


def _decode(arrays: Dict[str, np.ndarray], device) -> List[Optional[Any]]:
    codecs = _codecs()
    out: List[Optional[Any]] = []
    for i in range(int(arrays["slots"])):
        kind = str(arrays[f"{i}/kind"])
        if kind == "retrain":
            out.append(None)
        elif kind in codecs:
            prefix = f"{i}/"
            slot = {k[len(prefix):]: v for k, v in arrays.items()
                    if k.startswith(prefix)}
            out.append(codecs[kind][2](slot, device))
        else:
            raise ModelFormatError(f"slot {i}: unknown kind {kind!r}")
    return out


def deserialize_models(blob: bytes, device=None) -> List[Optional[Any]]:
    """The models of a blob written by :func:`serialize_models`, served
    on ``device`` (default ``cuda``); ``None`` for a retrain slot."""
    if not blob.startswith(b"PK"):
        raise ModelFormatError(
            "model blob is not the PyTorch port's format (tagged .npz); a "
            "pickled blob written by the JAX package is not loaded by the "
            "port: retrain the variant with the port")
    try:
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            arrays = _read(z)
    except ModelFormatError:
        raise
    except (ValueError, KeyError, OSError, zipfile.BadZipFile) as e:
        raise ModelFormatError(f"unreadable model blob: {e!r}") from e
    return _decode(arrays, device)
