"""Session-based next-item recommendation: a causal transformer over each
user's time-ordered item stream (port of the reference's
``models/seqrec.py``, SASRec-style).

* The transformer is an ``nn.Module`` (:class:`SeqRecNet`) whose
  ``state_dict`` names are the reference's pytree paths flattened with
  dots (``emb``, ``pos``, ``ln_f.scale``, ``layers.0.wqkv``, ...), in
  the reference's ``x @ W`` layout (``wqkv`` is ``[d, 3d]``; q, k and v
  are its column thirds, each head a contiguous ``d / h`` slice).
  :func:`from_reference_params` and :func:`to_reference_params` carry
  weights between the two packages.
* The initial weights are the reference's numpy draw
  (:func:`init_params`, ``np.random.default_rng(seed)``), bit for bit.
* A step is the reference's loss (causal blockwise attention with the
  pad keys masked, tanh GELU, the tied item-embedding softmax over all
  ``n_items + 1`` rows, pad targets masked) through autograd, and
  ``torch.optim.AdamW`` with optax ``adamw``'s settings (weight decay
  1e-4 on every parameter, betas (0.9, 0.999), eps 1e-8).
* The padded sessions are uploaded once; each epoch's order is the
  reference's ``default_rng(seed + epoch)`` shuffle, and the ragged last
  batch is dropped.
* Checkpoint snapshots hold the parameters in the reference's nested
  layout and the optimizer state as the reference's optax leaf list
  (the step count, then the first and second moments in pytree order),
  so either package resumes the other's snapshots.

The reference's mesh branches (dp x tp sharding, ring attention over a
``"seq"`` axis) are not ported: a mesh of more than one device raises
``NotImplementedError`` (ROADMAP item A12, part 2).
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from predictionio_tpu_torch.core.params import Params
from predictionio_tpu_torch.ops.attention import blockwise_attention
from predictionio_tpu_torch.utils.device import (
    refuse_multi_device, resolve_device, synchronize,
)

logger = logging.getLogger(__name__)

#: optax.adamw(lr)'s defaults
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4
LN_EPS = 1e-6


@dataclasses.dataclass
class SeqRecParams(Params):
    """Hyperparameters; json keys camelCase per engine.json convention."""

    d_model: int = 64
    n_heads: int = 2
    n_layers: int = 2
    max_len: int = 32
    learning_rate: float = 1e-3
    batch_size: int = 128
    epochs: int = 10
    seed: int = 7
    #: "flash" (the local blockwise attention) or "ring" (sequence
    #: parallelism over a mesh's "seq" axis, not ported: ROADMAP A12, part 2)
    attention_impl: str = "flash"


# -- weights --------------------------------------------------------------------

def init_params(rng: np.random.Generator, n_items: int, p: SeqRecParams,
                vocab_multiple: int = 1) -> Dict:
    """The reference's initial weights as its numpy pytree, drawn in its
    order: per layer ``wqkv``, ``wo``, ``w1``, ``w2`` (the norms draw
    nothing), then ``emb``, then ``pos``; each float64 draw scaled, then
    cast to float32. Row 0 of ``emb`` is the padding item."""
    d, v = p.d_model, n_items + 1
    v = -(-v // vocab_multiple) * vocab_multiple
    scale = d ** -0.5

    def norm():
        return {"scale": np.ones((d,), np.float32),
                "bias": np.zeros((d,), np.float32)}

    def dense(n_in, n_out):
        return (rng.normal(size=(n_in, n_out)) * (n_in ** -0.5)).astype(
            np.float32)

    layers = []
    for _ in range(p.n_layers):
        layer = {"ln1": norm(), "ln2": norm()}
        for name, shape in (("wqkv", (d, 3 * d)), ("wo", (d, d)),
                            ("w1", (d, 4 * d)), ("w2", (4 * d, d))):
            layer[name] = dense(*shape)
        layers.append(layer)
    return {
        "emb": (rng.normal(size=(v, d)) * scale).astype(np.float32),
        "pos": (rng.normal(size=(p.max_len, d)) * scale).astype(np.float32),
        "ln_f": norm(),
        "layers": layers,
    }


def param_names(n_layers: int) -> List[str]:
    """The flat parameter names in the reference's pytree leaf order
    (dict keys sorted, layers by index): the order of the optimizer
    moments in a snapshot."""
    layer = ("ln1.bias", "ln1.scale", "ln2.bias", "ln2.scale", "w1", "w2",
             "wo", "wqkv")
    return (["emb"]
            + [f"layers.{i}.{n}" for i in range(n_layers) for n in layer]
            + ["ln_f.bias", "ln_f.scale", "pos"])


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def from_reference_params(tree: Dict) -> Dict[str, torch.Tensor]:
    """The reference's parameter pytree (numpy or jax leaves) as the
    port's state dict: float32 CPU tensors by flat name."""
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in _flatten(tree).items()}


def to_reference_params(state: Dict) -> Dict:
    """The port's flat parameters (tensors or arrays) as the reference's
    numpy pytree."""
    flat = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v, np.float32)) for k, v in state.items()}
    n_layers = 1 + max((int(k.split(".")[1]) for k in flat
                        if k.startswith("layers.")), default=-1)

    def norm(prefix):
        return {"scale": flat[f"{prefix}.scale"],
                "bias": flat[f"{prefix}.bias"]}

    return {
        "emb": flat["emb"], "pos": flat["pos"], "ln_f": norm("ln_f"),
        "layers": [dict({n: flat[f"layers.{i}.{n}"]
                         for n in ("wqkv", "wo", "w1", "w2")},
                        ln1=norm(f"layers.{i}.ln1"),
                        ln2=norm(f"layers.{i}.ln2"))
                   for i in range(n_layers)],
    }


# -- the transformer ------------------------------------------------------------

class _Norm(nn.Module):
    """Layer norm with the reference's parameter names (``scale``,
    ``bias``) and epsilon inside the root."""

    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.scale, self.bias, LN_EPS)


class _Block(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.ln1 = _Norm(d)
        self.ln2 = _Norm(d)
        self.wqkv = nn.Parameter(torch.empty(d, 3 * d))
        self.wo = nn.Parameter(torch.empty(d, d))
        self.w1 = nn.Parameter(torch.empty(d, 4 * d))
        self.w2 = nn.Parameter(torch.empty(4 * d, d))

    def forward(self, h, key_mask, n_heads: int):
        b, l, d = h.shape
        q, k, v = (self.ln1(h) @ self.wqkv).split(d, dim=-1)
        heads = [t.reshape(b, l, n_heads, d // n_heads) for t in (q, k, v)]
        att = blockwise_attention(*heads, causal=True, key_mask=key_mask)
        h = h + att.reshape(b, l, d) @ self.wo
        x = self.ln2(h)
        return h + F.gelu(x @ self.w1, approximate="tanh") @ self.w2


class SeqRecNet(nn.Module):
    """``[B, L]`` item codes (0 = pad, sessions left-padded) ->
    ``[B, L, D]`` hidden states; ``emb`` doubles as the output layer."""

    def __init__(self, n_vocab: int, d_model: int, max_len: int,
                 n_layers: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.emb = nn.Parameter(torch.empty(n_vocab, d_model))
        self.pos = nn.Parameter(torch.empty(max_len, d_model))
        self.ln_f = _Norm(d_model)
        self.layers = nn.ModuleList(_Block(d_model) for _ in range(n_layers))

    @classmethod
    def from_state(cls, state: Dict, n_heads: int,
                   device=None) -> "SeqRecNet":
        """A net holding ``state`` (flat names -> tensors or arrays)."""
        emb, pos = state["emb"], state["pos"]
        n_layers = sum(1 for k in state if k.endswith(".wqkv"))
        net = cls(emb.shape[0], emb.shape[1], pos.shape[0], n_layers,
                  n_heads)
        net.load_state_dict({k: torch.as_tensor(v)
                             for k, v in state.items()})
        return net.to(device) if device is not None else net

    def forward(self, seqs: torch.Tensor, mesh=None,
                attention_impl: str = "flash") -> torch.Tensor:
        if attention_impl not in ("flash", "ring"):
            raise ValueError(f"unknown attention_impl {attention_impl!r}: "
                             "expected 'flash' or 'ring'")
        if attention_impl == "ring":
            if mesh is not None and "seq" in getattr(mesh, "axis_names", ()):
                raise NotImplementedError(
                    "ring attention over a mesh's \"seq\" axis is not "
                    "ported to PyTorch yet (ROADMAP item A12, part 2)")
            raise ValueError('attention_impl="ring" requires a mesh with a '
                             '"seq" axis')
        l = seqs.shape[1]
        h = F.embedding(seqs, self.emb) + self.pos[None, :l]
        # left-padding sits in the causal past; the key mask keeps it out
        # of the softmax
        key_mask = seqs != 0
        for layer in self.layers:
            h = layer(h, key_mask, self.n_heads)
        return torch.where(key_mask[..., None], self.ln_f(h), 0.0)


def forward(net: SeqRecNet, seqs: torch.Tensor, mesh=None,
            attention_impl: str = "flash") -> torch.Tensor:
    """``[B, L]`` codes -> ``[B, L, D]`` hidden states (pads zeroed)."""
    return net(seqs, mesh, attention_impl)


def _loss_fn(net: SeqRecNet, seqs: torch.Tensor, targets: torch.Tensor,
             mesh=None, attention_impl: str = "flash") -> torch.Tensor:
    """Next-item softmax cross-entropy over the tied output embedding,
    pad targets masked: ``sum(nll * mask) / max(sum(mask), 1)``."""
    hidden = net(seqs, mesh, attention_impl)               # [B, L, D]
    logits = hidden @ net.emb.T                            # [B, L, V]
    mask = (targets > 0).float()
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          targets.reshape(-1), reduction="none")
    return (nll.reshape(targets.shape) * mask).sum() / \
        mask.sum().clamp_min(1.0)


def make_optimizer(net: SeqRecNet, p: SeqRecParams) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` with optax ``adamw(lr)``'s settings."""
    return torch.optim.AdamW(net.parameters(), lr=p.learning_rate,
                             betas=ADAMW_BETAS, eps=ADAMW_EPS,
                             weight_decay=ADAMW_WEIGHT_DECAY)


def make_train_step(net: SeqRecNet, optimizer, p: SeqRecParams, mesh=None):
    """One step: ``step(seqs, targets) -> loss`` (a device scalar,
    detached), the loss's gradients applied by ``optimizer``."""

    def step(seqs, targets):
        loss = _loss_fn(net, seqs, targets, mesh, p.attention_impl)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def pad_sessions(sessions: Sequence[Sequence[int]], max_len: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Sessions of 1-based item ids -> (inputs [N, L], targets [N, L]):
    inputs are the sequence shifted right; targets the sequence itself.
    Keeps the LAST max_len items of each session (recency window)."""
    n = len(sessions)
    inputs = np.zeros((n, max_len), np.int32)
    targets = np.zeros((n, max_len), np.int32)
    for i, s in enumerate(sessions):
        s = list(s)[-(max_len + 1):]
        tgt = s[1:] if len(s) > 1 else []
        inp = s[:-1] if len(s) > 1 else []
        if not inp:
            continue
        inputs[i, -len(inp):] = inp
        targets[i, -len(tgt):] = tgt
    return inputs, targets


# -- the model ------------------------------------------------------------------

@dataclasses.dataclass
class SeqRecModel:
    """Trained weights and the item vocabulary; the net is built on
    ``device`` (None: ``cuda``) at the first query."""

    item_vocab: np.ndarray     # index i -> item id string for code i+1
    params: Dict               # flat names -> float32 arrays (or tensors)
    hyper: SeqRecParams
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.params = {k: np.array(v.detach().cpu() if torch.is_tensor(v)
                                   else v, np.float32)
                       for k, v in self.params.items()}
        self._net: Optional[SeqRecNet] = None

    def net(self) -> SeqRecNet:
        """The transformer on the model's device (built once)."""
        if self._net is None:
            net = SeqRecNet.from_state(self.params, self.hyper.n_heads,
                                       resolve_device(self.device))
            self._net = net.requires_grad_(False).eval()
        return self._net

    def device_bytes(self) -> int:
        """Bytes of the parameters on the device (0 until built)."""
        if self._net is None:
            return 0
        return sum(t.numel() * t.element_size()
                   for t in self._net.parameters())

    def release_device(self) -> None:
        self._net = None

    def item_code(self, item_id: str) -> Optional[int]:
        i = np.searchsorted(self.item_vocab, item_id)
        if i < len(self.item_vocab) and self.item_vocab[i] == item_id:
            return int(i) + 1          # 0 is padding
        return None

    def next_logits(self, codes: Sequence[int]) -> np.ndarray:
        """The ``[V]`` next-item logits after the last ``max_len`` of
        ``codes``: the forward and the product on the device, the row
        downloaded (a writable float32 copy)."""
        net = self.net()
        l = self.hyper.max_len
        tail = list(codes)[-l:]
        seq = torch.zeros((1, l), dtype=torch.int64)
        seq[0, l - len(tail):] = torch.as_tensor(tail, dtype=torch.int64)
        with torch.no_grad():
            hidden = net(seq.to(net.emb.device))
            logits = hidden[0, -1] @ net.emb.T
        return logits.cpu().numpy().copy()

    def recommend_next(self, recent_items: Sequence[str], num: int,
                       exclude_seen: bool = True) -> List[Tuple[str, float]]:
        codes = [c for it in recent_items
                 if (c := self.item_code(it)) is not None]
        if not codes:
            return []
        logits = self.next_logits(codes)
        logits[0] = -np.inf                     # padding id
        logits[len(self.item_vocab) + 1:] = -np.inf   # vocab-padding rows
        if exclude_seen:
            logits[np.asarray(codes)] = -np.inf   # ALL seen, not just tail
        k = min(num, len(self.item_vocab))
        top = np.argpartition(-logits, kth=k - 1)[:k]
        top = top[np.argsort(-logits[top])]
        return [(str(self.item_vocab[i - 1]), float(logits[i]))
                for i in top if np.isfinite(logits[i])]


def seqrec_fingerprint(item_vocab: np.ndarray, p: SeqRecParams,
                       sessions: Sequence[Sequence[str]] = ()) -> str:
    """Identity of a seqrec run for checkpoint-resume safety (the
    reference's string): every hyperparam that shapes the trajectory
    (epochs excluded: training further is the resume use case), the item
    vocabulary and the training sessions."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((p.d_model, p.n_heads, p.n_layers, p.max_len,
                   p.learning_rate, p.batch_size, p.seed)).encode())
    h.update("\x00".join(map(str, item_vocab)).encode())
    for s in sessions:
        h.update("\x00".join(map(str, s)).encode())
        h.update(b"\x01")
    return h.hexdigest()


# -- training -------------------------------------------------------------------

def _opt_leaves(net: SeqRecNet, optimizer, n_layers: int) -> List[np.ndarray]:
    """The optimizer state as optax adamw's leaf list: the step count
    (int32), then every first moment, then every second moment, in
    :func:`param_names` order."""
    params = dict(net.named_parameters())
    states = [optimizer.state[params[n]] for n in param_names(n_layers)]
    count = np.asarray(int(states[0]["step"]), np.int32)
    return ([count] + [s["exp_avg"] for s in states]
            + [s["exp_avg_sq"] for s in states])


def _restore_opt(net: SeqRecNet, optimizer, leaves, n_layers: int,
                 epoch0: int) -> None:
    """Load a snapshot's optax leaves into ``optimizer``; leaves whose
    count, shape or dtype differ from a fresh state's leave the moments
    at zero (a warning, the reference's rule)."""
    names = param_names(n_layers)
    params = dict(net.named_parameters())
    want = ([((), np.dtype(np.int32))]
            + [(tuple(params[n].shape), np.dtype(np.float32))
               for n in names] * 2)
    compatible = len(leaves) == len(want) and all(
        np.asarray(s).shape == shape and np.asarray(s).dtype == dtype
        for s, (shape, dtype) in zip(leaves, want))
    if not compatible:
        logger.warning(
            "seqrec snapshot optimizer state incompatible with the "
            "current optimizer layout (%d leaves saved, %d expected, "
            "or shape/dtype mismatch) — resuming params at epoch %d "
            "with RESET adam moments", len(leaves), len(want), epoch0)
        return
    n = len(names)
    step = torch.tensor(float(np.asarray(leaves[0])), dtype=torch.float32)
    for i, name in enumerate(names):
        prm = params[name]
        optimizer.state[prm] = {
            "step": step.clone(),
            "exp_avg": torch.from_numpy(np.array(leaves[1 + i])).to(
                prm.device),
            "exp_avg_sq": torch.from_numpy(np.array(leaves[1 + n + i])).to(
                prm.device)}


def _restored_params(state: Dict, expect: Dict[str, np.ndarray]
                     ) -> Optional[Dict[str, np.ndarray]]:
    """A snapshot's parameters, flat, when they have ``expect``'s names
    and shapes; else None."""
    try:
        flat = _flatten(state)
    except Exception:  # noqa: BLE001 — a malformed snapshot trains anew
        return None
    if set(flat) != set(expect) or any(
            np.shape(flat[k]) != expect[k].shape for k in expect):
        return None
    return {k: np.asarray(v, np.float32) for k, v in flat.items()}


def encode_sessions(sessions: Sequence[Sequence[str]], max_len: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(item vocabulary, inputs, targets)`` of a training run: the
    sorted distinct item ids (code i + 1 for the i-th, 0 the pad), and
    the sessions of two or more events coded and padded
    (:func:`pad_sessions`)."""
    all_items = np.asarray(sorted({it for s in sessions for it in s}),
                           dtype=object)
    code = {it: i + 1 for i, it in enumerate(all_items)}
    coded = [[code[it] for it in s] for s in sessions if len(s) >= 2]
    if not coded:
        raise ValueError("need at least one session with >= 2 events")
    return (all_items, *pad_sessions(coded, max_len))


def epoch_order(n: int, p: SeqRecParams, epoch: int) -> np.ndarray:
    """The reference's batch order of ``epoch``: a fresh ``arange(n)``
    shuffled by ``default_rng(seed + epoch)``, so a resumed run replays
    the order the uninterrupted run would have used."""
    order = np.arange(n)
    np.random.default_rng(p.seed + epoch).shuffle(order)
    return order


def train_seqrec(mesh, sessions: Sequence[Sequence[str]], p: SeqRecParams,
                 checkpointer=None, device=None,
                 losses: Optional[list] = None,
                 timings: Optional[list] = None) -> SeqRecModel:
    """Id-assign, pad, and train with AdamW on ``device`` (``cuda``
    unless the caller asks for the CPU); the model serves there.
    ``sessions`` are per-user time-ordered item-id lists. With a
    ``workflow.checkpoint.Checkpointer``, (params, optimizer state)
    snapshot every ``interval`` epochs and a preempted run resumes from
    the latest one. ``losses`` receives each step's loss, ``timings``
    each epoch's seconds (the device synchronised)."""
    refuse_multi_device(mesh, "seqrec training")
    dev = resolve_device(device)
    all_items, inputs, targets = encode_sessions(sessions, p.max_len)
    state = _flatten(init_params(np.random.default_rng(p.seed),
                                 len(all_items), p))
    fp = seqrec_fingerprint(all_items, p, sessions)
    epoch0 = 0
    restored_opt_leaves = None
    snap = checkpointer.latest(fingerprint=fp) \
        if checkpointer is not None else None
    if snap is not None and "params" in snap[1]:
        e, saved = snap
        restored = _restored_params(saved["params"], state)
        if restored is not None:
            epoch0, state = e, restored
            restored_opt_leaves = saved.get("opt_leaves")
    net = SeqRecNet.from_state(state, p.n_heads, dev)
    optimizer = make_optimizer(net, p)
    if restored_opt_leaves is not None:
        _restore_opt(net, optimizer, restored_opt_leaves, p.n_layers, epoch0)
    step = make_train_step(net, optimizer, p, mesh)

    # the padded sessions go to the device once; batches index them there
    inputs_d = torch.from_numpy(inputs.astype(np.int64)).to(dev)
    targets_d = torch.from_numpy(targets.astype(np.int64)).to(dev)
    n = len(inputs)
    bs = min(p.batch_size, n)
    for epoch in range(epoch0, p.epochs):
        t0 = time.perf_counter()
        order_d = torch.from_numpy(epoch_order(n, p, epoch)).to(dev)
        epoch_losses = []
        for lo in range(0, n - bs + 1, bs):
            idx = order_d[lo:lo + bs]
            epoch_losses.append(step(inputs_d[idx], targets_d[idx]))
        if losses is not None and epoch_losses:
            losses.extend(torch.stack(epoch_losses).cpu().tolist())
        if timings is not None:
            synchronize(dev)
            timings.append(time.perf_counter() - t0)
        done = epoch + 1
        if checkpointer is not None and checkpointer.due(done) \
                and done < p.epochs:
            checkpointer.save(done, {
                "params": to_reference_params(net.state_dict()),
                "opt_leaves": _opt_leaves(net, optimizer, p.n_layers)},
                fingerprint=fp)
    del optimizer
    model = SeqRecModel(item_vocab=all_items, params=net.state_dict(),
                        hyper=p, device=dev)
    model._net = net.requires_grad_(False).eval()
    return model
