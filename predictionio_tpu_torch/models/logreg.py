"""Softmax (logistic) regression, full-batch Adam on one device or
data-parallel over a mesh (port of the reference's ``models/logreg.py``, the MLlib LogisticRegression
analog of the classification template).

The whole data set lives on the device and each step is one forward
product, softmax cross-entropy and its gradient. The loss is the
reference's: the mean softmax cross-entropy plus ``reg * sum(W * W)``
inside the loss (an L2 term on the gradient, not Adam's decoupled
``weight_decay``). The update is optax's ``adam(lr)`` written out in
its own order of f32 operations (b1 0.9, b2 0.999, eps 1e-8; bias
corrections ``1 - b**t``; ``W -= lr * m_hat / (sqrt(v_hat) + eps)``).

The initial W is ``N(0, 1) * 0.01`` from a ``torch.Generator`` seeded
with ``params.seed``. The reference draws it from ``jax.random.normal``,
which torch cannot reproduce, so ``train_logreg`` takes an ``init_W``
(the parity tests pass the reference's draw). Predict is the
reference's host product.

With a ``mesh`` of more than one position the rows split into one block
a position along its first axis (ceil(N / shards) rows, the last
shorter: the reference pads to a multiple of the device count with
zero-weight rows, which add nothing to either sum below). Each position
holds its block and a copy of W and b on its device; a step takes the
gradient of its block's summed cross-entropy, one ``psum`` over the
axis adds the positions' gradients, and dividing by the global row
count gives the gradient of the reference's loss ``sum(ce * w) /
sum(w)`` over the GLOBAL rows (never a mean of the positions' means).
The L2 term's gradient ``2 * reg * W`` is added once, and every copy
takes the same Adam update.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.utils.device import resolve_device

#: optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class LogRegParams:
    iterations: int = 200
    learning_rate: float = 0.1
    reg: float = 1e-4
    seed: int = 0


@dataclasses.dataclass
class LogRegModel:
    label_vocab: np.ndarray
    W: np.ndarray            # [F, L]
    b: np.ndarray            # [L]

    def predict_scores(self, X: np.ndarray) -> np.ndarray:
        return np.atleast_2d(X) @ self.W + self.b

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.label_vocab[np.argmax(self.predict_scores(X), axis=1)]


def initial_W(n_features: int, n_labels: int, seed: int) -> np.ndarray:
    """The seeded initial weights, ``N(0, 1) * 0.01`` (f32, drawn on the
    CPU so every device starts from the same W)."""
    g = torch.Generator().manual_seed(int(seed))
    return (torch.randn((n_features, n_labels), generator=g,
                        dtype=torch.float32) * 0.01).numpy()


def bias_corrections(iterations: int) -> torch.Tensor:
    """[2, T] f32: ``1 - b1**t`` and ``1 - b2**t`` for t = 1..T (optax's
    f32 power), computed once on the CPU."""
    t = torch.arange(1, int(iterations) + 1, dtype=torch.float32)
    decay = torch.tensor([[ADAM_B1], [ADAM_B2]], dtype=torch.float32)
    return 1.0 - decay ** t[None, :]


def _adam_step(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
               lr: float) -> None:
    """One optax ``adam`` update of ``p`` in place (f32, optax's order),
    with this step's bias corrections ``c1``, ``c2``."""
    m.mul_(ADAM_B1).add_(g * (1.0 - ADAM_B1))
    v.mul_(ADAM_B2).add_(g * g * (1.0 - ADAM_B2))
    p.add_(-lr * ((m / c1) / (torch.sqrt(v / c2) + ADAM_EPS)))


def train_logreg(X: np.ndarray, labels: Sequence[str],
                 params: LogRegParams = LogRegParams(), mesh=None,
                 device=None, init_W: Optional[np.ndarray] = None
                 ) -> LogRegModel:
    """Fit W [F, L] and b [L] by ``params.iterations`` full-batch Adam
    steps on ``device`` (``cuda`` unless the caller asks for the CPU),
    from ``init_W`` (default: :func:`initial_W` of ``params.seed``);
    with a ``mesh`` of more than one position, data-parallel over its
    first axis on its own devices (the module docstring)."""
    labels = np.asarray(labels, dtype=object)
    label_vocab, y = np.unique(labels, return_inverse=True)
    n_features, n_labels = X.shape[1], len(label_vocab)
    W0 = (initial_W(n_features, n_labels, params.seed) if init_W is None
          else np.asarray(init_W, np.float32))
    if mesh is not None and mesh.size > 1:
        W, b = _fit_mesh(X, y.reshape(-1), W0, params, mesh)
        return LogRegModel(label_vocab=label_vocab, W=W, b=b)
    dev = resolve_device(device)
    Xd = torch.from_numpy(np.asarray(X, np.float32)).to(dev)
    yd = torch.from_numpy(y.reshape(-1).astype(np.int64)).to(dev)
    W = torch.from_numpy(np.array(W0, np.float32)).to(dev).requires_grad_()
    b = torch.zeros(n_labels, dtype=torch.float32, device=dev,
                    requires_grad=True)
    moments = [(torch.zeros_like(p), torch.zeros_like(p)) for p in (W, b)]
    reg, lr = float(params.reg), float(params.learning_rate)
    corr = bias_corrections(params.iterations).to(dev)
    for t in range(int(params.iterations)):
        logits = Xd @ W + b
        ce = torch.nn.functional.cross_entropy(logits, yd)
        loss = ce + reg * (W * W).sum()
        gW, gb = torch.autograd.grad(loss, (W, b))
        with torch.no_grad():
            for p, g, (m, v) in zip((W, b), (gW, gb), moments):
                _adam_step(p, g, m, v, corr[0, t], corr[1, t], lr)
    return LogRegModel(label_vocab=label_vocab,
                       W=W.detach().cpu().numpy(),
                       b=b.detach().cpu().numpy())


def _fit_mesh(X: np.ndarray, y: np.ndarray, W0: np.ndarray,
              params: LogRegParams, mesh) -> "tuple[np.ndarray, np.ndarray]":
    """The data-parallel fit of the module docstring: ``(W, b)`` as
    numpy, equal on every position and process."""
    from predictionio_tpu_torch.parallel.collectives import psum

    axis = mesh.axis_names[0]
    n, (n_features, n_labels) = len(y), W0.shape
    blk = -(-n // mesh.shape[axis])
    reg, lr = float(params.reg), float(params.learning_rate)
    corr = bias_corrections(params.iterations)
    shards = []
    for p, dev in zip(mesh.local_positions(), mesh.local_devices()):
        lo = min(n, mesh.axis_index(p, axis) * blk)
        hi = min(n, lo + blk)
        W = torch.from_numpy(np.array(W0, np.float32)).to(dev)
        b = torch.zeros(n_labels, dtype=torch.float32, device=dev)
        shards.append(dict(
            X=torch.from_numpy(np.asarray(X[lo:hi], np.float32)).to(dev),
            y=torch.from_numpy(y[lo:hi].astype(np.int64)).to(dev),
            W=W.requires_grad_(), b=b.requires_grad_(),
            moments=[(torch.zeros_like(t), torch.zeros_like(t))
                     for t in (W, b)], corr=corr.to(dev)))
    for t in range(int(params.iterations)):
        parts = []
        for sh in shards:
            ce = torch.nn.functional.cross_entropy(
                sh["X"] @ sh["W"] + sh["b"], sh["y"], reduction="sum")
            gW, gb = torch.autograd.grad(ce, (sh["W"], sh["b"]))
            parts.append(torch.cat([gW.reshape(-1), gb]))
        for sh, g in zip(shards, psum(parts, mesh, axis)):
            g = g / n
            W, b = sh["W"], sh["b"]
            with torch.no_grad():
                grads = (g[:W.numel()].view_as(W) + 2.0 * reg * W,
                         g[W.numel():])
                for p, gp, (m, v) in zip((W, b), grads, sh["moments"]):
                    _adam_step(p, gp, m, v, sh["corr"][0, t],
                               sh["corr"][1, t], lr)
    first = shards[0]
    return (first["W"].detach().cpu().numpy(),
            first["b"].detach().cpu().numpy())
