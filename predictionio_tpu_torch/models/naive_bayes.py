"""Naive Bayes classifiers (port of the reference's
``models/naive_bayes.py``).

Two variants:

* ``CategoricalNaiveBayes`` — e2's string-feature NB
  (e2/.../engine/CategoricalNaiveBayes.scala:23-172): per-position
  categorical features, log prior plus per-feature log likelihoods, an
  optional default likelihood for unseen values. Host numpy (np.unique +
  bincount), a copy of the reference's code.
* ``MultinomialNB`` — the MLlib NaiveBayes analog of the classification
  template (NaiveBayesAlgorithm.scala:35-56): count-vector features;
  prediction is one product ``X @ logP^T + prior``.

The multinomial train counts features per label in one of four
branches, by the reference's own size rule:

* ``mesh`` — a ``mesh`` of more than one position, X of at least
  ``DEVICE_MIN_SIZE`` elements and a one-hot within ``ONEHOT_MAX_BYTES``
  times the positions: the rows split into one block a position along
  the mesh's first axis (ceil(N / shards) rows, the last block shorter;
  the reference pads it with code -1 rows, which count nothing), each
  position counts its block ([L, F] = one-hot @ its rows of X, on its
  device) and one ``psum`` over that axis adds the partial counts.
  Every process holds the whole X, as the reference's callers do, and
  uploads it once to each of its devices (``resident_x``): a position
  reads its rows there, and a later predict on the same X finds the
  process's whole X resident (never a copy sharded across processes);
* ``device`` — X of at least ``DEVICE_MIN_SIZE`` elements whose [L, N]
  one-hot fits ``ONEHOT_MAX_BYTES``: X is compacted to uint8/uint16
  (``_compact_for_transfer``), uploaded once (``ops/device_cache``, keyed
  on the caller's array) and widened to f32 on the device, where one
  ``[L, N] @ [N, F]`` f32 product gives the counts;
* ``host_gemm`` — a float X under the same one-hot bound: the same
  product in host BLAS;
* ``scatter`` — anything else: ``np.add.at`` (no extra memory).

The model counts the branches it took (``MultinomialNBModel.branches``),
its train's and its predicts'. ``predict_scores`` runs on the device when
X is resident there (the train just uploaded it) or has at least
``PREDICT_DEVICE_MIN_SIZE`` elements; otherwise the host product wins.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.ops import device_cache
from predictionio_tpu_torch.utils.device import resolve_device, synchronize
from predictionio_tpu_torch.utils.profiling import phase


# ---------------------------------------------------------------------------
# Categorical NB (e2 parity)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LabeledPoint:
    """e2 LabeledPoint: (label, string features per position)."""

    label: str
    features: Tuple[str, ...]


@dataclasses.dataclass
class CategoricalNaiveBayesModel:
    """priors/likelihoods structure parity (CategoricalNaiveBayes.scala:87)."""

    priors: Dict[str, float]                           # label -> log prior
    likelihoods: Dict[str, List[Dict[str, float]]]     # label -> per-position

    def log_score(self, point: LabeledPoint,
                  default_likelihood: Callable[[Sequence[float]], float]
                  = lambda ls: float("-inf")) -> Optional[float]:
        if point.label not in self.priors:
            return None
        return self._log_score(point.label, point.features,
                               default_likelihood)

    def _log_score(self, label: str, features: Sequence[str],
                   default_likelihood) -> float:
        ll = self.likelihoods[label]
        total = self.priors[label]
        for feature, position in zip(features, ll):
            total += position.get(
                feature, default_likelihood(list(position.values())))
        return total

    def predict(self, features: Sequence[str]) -> str:
        scored = [(label, self._log_score(label, features,
                                          lambda ls: float("-inf")))
                  for label in self.priors]
        return max(scored, key=lambda x: x[1])[0]


def train_categorical_nb(points: Sequence[LabeledPoint]
                         ) -> CategoricalNaiveBayesModel:
    """CategoricalNaiveBayes.train parity, vectorized."""
    if not points:
        raise ValueError("no training points")
    n_positions = len(points[0].features)
    labels = np.asarray([p.label for p in points], dtype=object)
    label_vocab, label_codes = np.unique(labels, return_inverse=True)
    label_counts = np.bincount(label_codes, minlength=len(label_vocab))
    total = float(len(points))

    priors = {str(lab): math.log(label_counts[i] / total)
              for i, lab in enumerate(label_vocab)}
    likelihoods: Dict[str, List[Dict[str, float]]] = {
        str(lab): [] for lab in label_vocab}

    for pos in range(n_positions):
        feats = np.asarray([p.features[pos] for p in points], dtype=object)
        feat_vocab, feat_codes = np.unique(feats, return_inverse=True)
        # joint counts [n_labels, n_feat_values] in one bincount
        joint = np.bincount(
            label_codes * len(feat_vocab) + feat_codes,
            minlength=len(label_vocab) * len(feat_vocab),
        ).reshape(len(label_vocab), len(feat_vocab))
        for li, lab in enumerate(label_vocab):
            position_map = {
                str(feat_vocab[fi]): math.log(joint[li, fi] / label_counts[li])
                for fi in range(len(feat_vocab)) if joint[li, fi] > 0}
            likelihoods[str(lab)].append(position_map)

    return CategoricalNaiveBayesModel(priors=priors, likelihoods=likelihoods)


# ---------------------------------------------------------------------------
# Multinomial NB (MLlib analog)
# ---------------------------------------------------------------------------

#: inputs below this element count train on the host (BLAS one-hot
#: product): the device count product cannot repay its upload below it
DEVICE_MIN_SIZE = 1_000_000
#: predict on the device only pays above this element count when X is
#: NOT already resident there (the host product beats the upload)
PREDICT_DEVICE_MIN_SIZE = 50_000_000
#: the byte bound of the [L, N] f32 one-hot of the count product (device
#: and host gemm branches); past it the scatter fold runs
ONEHOT_MAX_BYTES = 1 << 28


def _compact_for_transfer(X: np.ndarray) -> np.ndarray:
    """Count matrices are usually small non-negative integers stored as
    float; ship them as uint8/uint16 (4x/2x fewer bytes to upload) and
    widen to f32 on the device."""
    if X.dtype.kind in "ui":
        return X
    if X.dtype.kind != "f" or X.size == 0:
        return X
    xmax, xmin = X.max(), X.min()
    if xmin < 0 or xmax >= 65536 or np.any(np.mod(X, 1)):
        return X
    return X.astype(np.uint8 if xmax < 256 else np.uint16)


def _upload(Xc: np.ndarray, device: torch.device):
    """A host matrix on ``device`` as ``(tensor, unsigned16)``: uint16 goes
    up as its int16 bits (widened with a mask on the device), other
    unsigned wide types as int64, the rest as they are."""
    Xc = np.ascontiguousarray(Xc)
    unsigned16 = Xc.dtype == np.uint16
    if unsigned16:
        Xc = Xc.view(np.int16)
    elif Xc.dtype.kind == "u" and Xc.dtype != np.uint8:
        Xc = Xc.astype(np.int64)
    xd = torch.from_numpy(Xc).to(device)
    synchronize(device)
    return xd, unsigned16


def _widen(resident) -> torch.Tensor:
    """The resident matrix as f32 on its device."""
    xd, unsigned16 = resident
    if unsigned16:
        return (xd.to(torch.int32) & 0xFFFF).to(torch.float32)
    return xd.to(torch.float32)


def _x_key(device: torch.device) -> tuple:
    return ("nb_x", str(device))


def resident_x(X: np.ndarray, device: torch.device):
    """X on ``device`` as ``(tensor, unsigned16)``, compacted and
    uploaded once per caller's array (``ops/device_cache``)."""
    def put():
        with phase("nb_compact"):
            Xc = _compact_for_transfer(np.atleast_2d(X))
        with phase("nb_transfer"):
            return _upload(Xc, device)

    return device_cache.resident([X], _x_key(device), put)


def count_product(resident, codes: torch.Tensor,
                  n_labels: int) -> torch.Tensor:
    """The device branch's counts: [L, F] f32 = one-hot [L, N] @ X
    widened to f32 (exact for counts below 2^24)."""
    n = codes.shape[0]
    onehot = torch.zeros((n_labels, n), dtype=torch.float32,
                         device=codes.device)
    onehot[codes, torch.arange(n, device=codes.device)] = 1.0
    return onehot @ _widen(resident)


def mesh_counts(X: np.ndarray, label_codes: np.ndarray, n_labels: int,
                mesh) -> np.ndarray:
    """The mesh branch's [L, F] counts: each local position counts its
    block of rows along the mesh's first axis on its device, from the
    process's whole X resident there, and one ``psum`` over that axis
    adds the blocks (exact: integer counts below 2^24 in f32)."""
    from predictionio_tpu_torch.parallel.collectives import psum

    axis = mesh.axis_names[0]
    n = X.shape[0]
    blk = -(-n // mesh.shape[axis])
    parts = []
    for p, dev in zip(mesh.local_positions(), mesh.local_devices()):
        lo = min(n, mesh.axis_index(p, axis) * blk)
        hi = min(n, lo + blk)
        xd, unsigned16 = resident_x(X, dev)
        codes = torch.from_numpy(label_codes[lo:hi].astype(np.int64)).to(dev)
        parts.append(count_product((xd[lo:hi], unsigned16), codes, n_labels))
    return psum(parts, mesh, axis)[0].cpu().numpy().astype(np.float64)


def score_product(resident, log_prob: torch.Tensor,
                  log_prior: torch.Tensor) -> torch.Tensor:
    """[N, L] = X widened to f32 @ log_prob^T + log_prior."""
    return _widen(resident) @ log_prob.T + log_prior[None, :]


@dataclasses.dataclass(eq=False)
class MultinomialNBModel:
    """Label vocab, log priors [L] and log feature probs [L, F]."""

    label_vocab: np.ndarray
    log_prior: np.ndarray
    log_prob: np.ndarray
    #: the device of the count product and of a device predict (None:
    #: ``cuda`` when a predict needs it)
    device: Optional[torch.device] = None
    #: branches taken, by name (``train_mesh``, ``train_device``,
    #: ``train_host_gemm``, ``train_scatter``, ``predict_device``,
    #: ``predict_host``)
    branches: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def __post_init__(self):
        self._params_dev = None         # (log_prob, log_prior) on device
        self._x_ref = None              # weakref to a resident X tensor

    def _note_resident(self, resident) -> None:
        self._x_ref = weakref.ref(resident[0])

    def predict_scores(self, X: np.ndarray) -> np.ndarray:
        """[N, F] -> [N, L] joint log-likelihood (one product).

        Routed by where the data is: the product is tiny next to
        uploading X, so the device only wins when X is already resident
        there (the train just ran on it) or very large. The cache keys
        on the CALLER's array object, so train-then-predict on the same
        X reuses one upload."""
        key = _x_key(self.device)
        if not device_cache.is_resident([X], key) \
                and X.size < PREDICT_DEVICE_MIN_SIZE:
            self.branches["predict_host"] += 1
            xs = np.atleast_2d(X)
            return xs.astype(np.float32, copy=False) @ self.log_prob.T \
                + self.log_prior[None, :]
        dev = resolve_device(self.device)
        resident = resident_x(X, dev)
        self._note_resident(resident)
        self.branches["predict_device"] += 1
        return score_product(resident, *self.params_on(dev)).cpu().numpy()

    def params_on(self, device: torch.device):
        """``(log_prob, log_prior)`` on ``device``, uploaded once."""
        if self._params_dev is None:
            self._params_dev = (
                torch.from_numpy(self.log_prob).to(device),
                torch.from_numpy(self.log_prior).to(device))
        return self._params_dev

    def predict(self, X: np.ndarray) -> np.ndarray:
        scores = self.predict_scores(np.atleast_2d(X))
        return self.label_vocab[np.argmax(scores, axis=1)]

    def device_bytes(self) -> int:
        """Bytes this model holds on its device: the parameters' copy and
        a resident X it trained or predicted on, while it lives."""
        total = 0
        if self._params_dev is not None:
            total += sum(t.numel() * t.element_size()
                         for t in self._params_dev)
        x = self._x_ref() if self._x_ref is not None else None
        if x is not None:
            total += x.numel() * x.element_size()
        return total

    def release_device(self) -> None:
        """Drop the device copy of the parameters (a resident X belongs
        to the caller's array and goes with it)."""
        self._params_dev = None
        self._x_ref = None


def train_multinomial_nb(X: np.ndarray, labels: Sequence[str],
                         smoothing: float = 1.0, mesh=None,
                         device=None) -> MultinomialNBModel:
    """MLlib NaiveBayes.train parity (lambda smoothing). The per-label
    feature counts come from the branch the module docstring names;
    ``device`` is where the device branch runs (``cuda`` unless the
    caller asks for the CPU), a ``mesh`` of more than one position's own
    devices for the mesh branch (the model predicts on the first local
    one)."""
    labels = np.asarray(labels, dtype=object)
    label_vocab, label_codes = np.unique(labels, return_inverse=True)
    label_codes = label_codes.reshape(-1)
    n_labels = len(label_vocab)
    n_features = X.shape[1]
    onehot_bytes = X.shape[0] * n_labels * 4
    onehot_fits = onehot_bytes <= ONEHOT_MAX_BYTES
    branches: collections.Counter = collections.Counter()
    resident = None
    on_mesh = mesh is not None and mesh.size > 1 \
        and X.size >= DEVICE_MIN_SIZE \
        and onehot_bytes <= ONEHOT_MAX_BYTES * mesh.size
    dev = mesh.local_devices()[0] if on_mesh else resolve_device(device)
    if on_mesh:
        counts = mesh_counts(X, label_codes, n_labels, mesh)
        resident = resident_x(X, dev)
        branches["train_mesh"] += 1
    elif X.size >= DEVICE_MIN_SIZE and onehot_fits:
        resident = resident_x(X, dev)
        codes = torch.from_numpy(label_codes.astype(np.int64)).to(dev)
        counts = count_product(resident, codes, n_labels).cpu().numpy(
        ).astype(np.float64)
        branches["train_device"] += 1
    elif X.dtype.kind == "f" and onehot_fits:
        # host BLAS one-hot count: one [L, N] @ [N, F] product, ~20x
        # faster than np.add.at's per-element scatter at spam sizes
        onehot = np.zeros((n_labels, X.shape[0]), np.float32)
        onehot[label_codes, np.arange(X.shape[0])] = 1.0
        counts = (onehot @ X).astype(np.float64)
        branches["train_host_gemm"] += 1
    else:
        counts = np.zeros((n_labels, n_features), np.float64)
        np.add.at(counts, label_codes, X)
        branches["train_scatter"] += 1
    label_counts = np.bincount(label_codes, minlength=n_labels)
    log_prior = np.log(label_counts / label_counts.sum())
    smoothed = counts + smoothing
    log_prob = np.log(smoothed / smoothed.sum(axis=1, keepdims=True))
    model = MultinomialNBModel(
        label_vocab=label_vocab,
        log_prior=log_prior.astype(np.float32),
        log_prob=log_prob.astype(np.float32), device=dev,
        branches=branches)
    if resident is not None:
        model._note_resident(resident)
    return model
