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

Over a mesh of more than one position (``parallel/mesh``) the train is
the reference's partitioned step, run at every local position in turn
with the collectives of ``parallel/collectives`` (:class:`_MeshTrain`):

* dp: the batch shards over ``"data"``; the loss is the masked NLL
  summed over the GLOBAL batch over its global mask count, each
  position contributing its partial sum;
* tp over ``"model"``: the vocabulary pads to a multiple of the axis
  (``init_params(vocab_multiple=tp)``), and each position holds the
  parameters as the reference's ``shard_params`` lays them out (``emb``
  and ``w2`` by rows, ``wqkv`` and ``w1`` by columns, the rest whole),
  AdamW's moments sharded with them. The compute gathers a weight whole
  when it is used (``all_gather`` over ``"model"``) and so reduces its
  gradient back to the shards (the gather's transpose): the math of
  XLA's partitioned product, with the per-token compute repeated at
  the positions of a ``"model"`` group (each weighs its loss by one over
  the repeat, and the gradients add back to one);
* sp: ``attention_impl="ring"`` lays the tokens out ``[data, seq]`` and
  runs ``ops/attention.ring_attention_traced`` over ``"seq"``;
* each parameter's gradient is summed over the axes its copies repeat
  on (``psum``), so every copy takes the same AdamW update;
* at the end the shards are gathered, so every process holds the whole
  model. A mesh inside one process checkpoints and resumes in the
  reference's layout (the moments gathered whole); a checkpointer with
  a mesh that spans processes raises ``NotImplementedError``, because
  the reference cannot write that snapshot either (its
  ``Checkpointer.save`` calls ``np.asarray`` on leaves that span
  processes).
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
from predictionio_tpu_torch.ops.attention import (
    assemble_blocks, blockwise_attention, ring_attention_traced,
    split_blocks,
)
from predictionio_tpu_torch.utils.device import resolve_device, synchronize

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
    #: parallelism: K/V blocks rotate over the mesh's "seq" axis). "ring"
    #: requires training on a mesh with a "seq" axis; serving always
    #: uses the local kernel.
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


def _norm(x, w: Dict, prefix: str):
    return F.layer_norm(x, x.shape[-1:], w[f"{prefix}.scale"],
                        w[f"{prefix}.bias"], LN_EPS)


def _heads(h, w: Dict, prefix: str, n_heads: int):
    """A layer's q, k, v of ``h [B, L, D]``, each ``[B, L, H, D / H]``."""
    b, l, d = h.shape
    q, k, v = (_norm(h, w, f"{prefix}.ln1") @ w[f"{prefix}.wqkv"]).split(
        d, dim=-1)
    return [t.reshape(b, l, n_heads, d // n_heads) for t in (q, k, v)]


def _finish_layer(h, att, w: Dict, prefix: str):
    """The rest of a layer after attention: the output projection, the
    residual and the tanh-GELU feed-forward."""
    h = h + att.reshape(h.shape) @ w[f"{prefix}.wo"]
    x = _norm(h, w, f"{prefix}.ln2")
    return h + F.gelu(x @ w[f"{prefix}.w1"], approximate="tanh") \
        @ w[f"{prefix}.w2"]


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
        w = {f"l.{k}": v for k, v in self.named_parameters()}
        att = blockwise_attention(*_heads(h, w, "l", n_heads), causal=True,
                                  key_mask=key_mask)
        return _finish_layer(h, att, w, "l")


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
        """``attention_impl="ring"`` with a mesh that has a ``"seq"``
        axis runs the attention sequence-parallel over it (the tokens
        split ``[data, seq]`` over the mesh, this net's weights at every
        position, the hidden states assembled whole)."""
        if _uses_ring(mesh, attention_impl):
            spec = _token_spec(mesh, True)
            w = dict(self.named_parameters())
            blocks = split_blocks(seqs, mesh, spec)
            hidden = _forward_blocks(
                [{k: t.to(b.device) for k, t in w.items()} for b in blocks],
                blocks, mesh, self.n_heads, True)
            return assemble_blocks(hidden, mesh, spec + (None,),
                                   tuple(seqs.shape) + (self.emb.shape[1],))
        l = seqs.shape[1]
        h = F.embedding(seqs, self.emb) + self.pos[None, :l]
        # left-padding sits in the causal past; the key mask keeps it out
        # of the softmax
        key_mask = seqs != 0
        for layer in self.layers:
            h = layer(h, key_mask, self.n_heads)
        return torch.where(key_mask[..., None], self.ln_f(h), 0.0)


def _uses_ring(mesh, attention_impl: str) -> bool:
    """Whether the attention runs as the ring over the mesh's ``"seq"``
    axis; the reference's errors for an unknown implementation, and for
    ``"ring"`` without such an axis."""
    if attention_impl not in ("flash", "ring"):
        raise ValueError(f"unknown attention_impl {attention_impl!r}: "
                         "expected 'flash' or 'ring'")
    if attention_impl == "ring" and (
            mesh is None or "seq" not in getattr(mesh, "axis_names", ())):
        raise ValueError('attention_impl="ring" requires a mesh with a '
                         '"seq" axis')
    return attention_impl == "ring"


def _token_spec(mesh, ring: bool) -> Tuple[Optional[str], Optional[str]]:
    """How a ``[B, L]`` batch of tokens lies over the mesh: the batch over
    ``"data"`` when the mesh has it, the sequence over ``"seq"`` under
    the ring."""
    return ("data" if "data" in mesh.axis_names else None,
            "seq" if ring else None)


def _forward_blocks(weights: List[Dict], seqs: List[torch.Tensor], mesh,
                    n_heads: int, ring: bool) -> List[torch.Tensor]:
    """The forward at every local position: ``weights`` each position's
    whole parameters by flat name, ``seqs`` its ``[b, l]`` block of
    tokens (the batch rows and, under the ring, the sequence run of its
    ``"seq"`` index); returns each position's ``[b, l, D]`` hidden
    states, the pads zeroed. Collective under the ring."""
    seq_idx = [mesh.axis_index(p, "seq") if ring else 0
               for p in mesh.local_positions()]
    h = []
    for w, s, si in zip(weights, seqs, seq_idx):
        l = s.shape[1]
        h.append(F.embedding(s, w["emb"])
                 + w["pos"][si * l:(si + 1) * l][None])
    key_mask = [s != 0 for s in seqs]
    n_layers = sum(1 for k in weights[0] if k.endswith(".wqkv"))
    for i in range(n_layers):
        prefix = f"layers.{i}"
        heads = [_heads(hj, w, prefix, n_heads)
                 for hj, w in zip(h, weights)]
        if ring:
            att = ring_attention_traced(
                *([x[j] for x in heads] for j in range(3)), mesh,
                axis="seq", causal=True, key_mask=key_mask)
        else:
            att = [blockwise_attention(*x, causal=True, key_mask=m)
                   for x, m in zip(heads, key_mask)]
        h = [_finish_layer(hj, a, w, prefix)
             for hj, a, w in zip(h, att, weights)]
    return [torch.where(m[..., None], _norm(hj, w, "ln_f"), 0.0)
            for hj, m, w in zip(h, key_mask, weights)]


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

def _opt_leaves(step: int, first: Dict[str, torch.Tensor],
                second: Dict[str, torch.Tensor], n_layers: int
                ) -> List[np.ndarray]:
    """The optimizer state as optax adamw's leaf list: the step count
    (int32), then every first moment, then every second moment (whole),
    in :func:`param_names` order."""
    names = param_names(n_layers)
    return ([np.asarray(int(step), np.int32)]
            + [first[n] for n in names] + [second[n] for n in names])


def _net_opt_leaves(net: SeqRecNet, optimizer, n_layers: int
                    ) -> List[np.ndarray]:
    """:func:`_opt_leaves` of a one-device train."""
    states = {n: optimizer.state[t] for n, t in net.named_parameters()}
    some = next(iter(states.values()))
    return _opt_leaves(some["step"],
                       {n: st["exp_avg"] for n, st in states.items()},
                       {n: st["exp_avg_sq"] for n, st in states.items()},
                       n_layers)


def _snapshot_moments(leaves, shapes: Dict[str, tuple], n_layers: int,
                      epoch0: int):
    """``(step, first moments, second moments)`` of a snapshot's optax
    leaves, whole, by name, when their count, shapes and dtypes are a
    fresh state's for parameters of ``shapes``; else None and a warning
    (the moments restart at zero: the reference's rule)."""
    names = param_names(n_layers)
    want = ([((), np.dtype(np.int32))]
            + [(tuple(shapes[n]), np.dtype(np.float32)) for n in names] * 2)
    compatible = len(leaves) == len(want) and all(
        np.asarray(s).shape == shape and np.asarray(s).dtype == dtype
        for s, (shape, dtype) in zip(leaves, want))
    if not compatible:
        logger.warning(
            "seqrec snapshot optimizer state incompatible with the "
            "current optimizer layout (%d leaves saved, %d expected, "
            "or shape/dtype mismatch) — resuming params at epoch %d "
            "with RESET adam moments", len(leaves), len(want), epoch0)
        return None
    n = len(names)
    step = torch.tensor(float(np.asarray(leaves[0])), dtype=torch.float32)
    first = {name: torch.from_numpy(np.array(leaves[1 + i]))
             for i, name in enumerate(names)}
    second = {name: torch.from_numpy(np.array(leaves[1 + n + i]))
              for i, name in enumerate(names)}
    return step, first, second


def _restore_opt(net: SeqRecNet, optimizer, leaves, n_layers: int,
                 epoch0: int) -> None:
    """Load a snapshot's optax leaves into a one-device train's
    ``optimizer`` (:func:`_snapshot_moments`' rule)."""
    params = dict(net.named_parameters())
    got = _snapshot_moments(leaves, {n: t.shape for n, t in params.items()},
                            n_layers, epoch0)
    if got is None:
        return
    step, first, second = got
    for name, prm in params.items():
        optimizer.state[prm] = {
            "step": step.clone(), "exp_avg": first[name].to(prm.device),
            "exp_avg_sq": second[name].to(prm.device)}


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


class _NetTrain:
    """The one-device train: :class:`SeqRecNet` and AdamW on ``dev``."""

    def __init__(self, state: Dict[str, np.ndarray], p: SeqRecParams, dev):
        self.p, self.dev = p, dev
        self.net = SeqRecNet.from_state(state, p.n_heads, dev)
        self.optimizer = make_optimizer(self.net, p)
        self.step = make_train_step(self.net, self.optimizer, p)

    def restore_opt(self, leaves, epoch0: int) -> None:
        _restore_opt(self.net, self.optimizer, leaves, self.p.n_layers,
                     epoch0)

    def snapshot(self) -> Dict:
        return {"params": to_reference_params(self.net.state_dict()),
                "opt_leaves": _net_opt_leaves(self.net, self.optimizer,
                                              self.p.n_layers)}

    def model(self, all_items: np.ndarray) -> "SeqRecModel":
        model = SeqRecModel(item_vocab=all_items,
                            params=self.net.state_dict(), hyper=self.p,
                            device=self.dev)
        model._net = self.net.requires_grad_(False).eval()
        return model


#: the leaves the reference's ``shard_params`` lays over "model", and
#: the dimension each splits along
_TP_DIM = {"emb": 0, "wqkv": 1, "w1": 1, "w2": 0}


def _tp_dim(name: str) -> Optional[int]:
    return _TP_DIM.get(name.rsplit(".", 1)[-1])


class _MeshTrain:
    """The train over a mesh of positions (the module docstring): each
    local position's parameters (``"model"`` shards or whole copies) on
    its device, one AdamW over all of them, a step run at every local
    position with the collectives of ``parallel/collectives``. Every
    process of a mesh that spans processes runs the same steps."""

    def __init__(self, mesh, state: Dict[str, np.ndarray], p: SeqRecParams):
        self.mesh, self.p = mesh, p
        self.ring = _uses_ring(mesh, p.attention_impl)
        self.spec = _token_spec(mesh, self.ring)
        #: positions that repeat each token's compute (the axes that do
        #: not split the tokens): each weighs its loss by one over it
        self.repeat = int(np.prod([n for a, n in mesh.shape.items()
                                   if a not in self.spec]))
        self.tp = int(mesh.shape.get("model", 1))
        self.names = param_names(p.n_layers)
        self.sharded = [n for n in self.names
                        if self.tp > 1 and _tp_dim(n) is not None]
        self.whole = [n for n in self.names if n not in self.sharded]
        self.devs = mesh.local_devices()
        self.params = [
            {n: nn.Parameter(self._shard(torch.from_numpy(state[n]), n,
                                         pos).to(dev))
             for n in self.names}
            for pos, dev in zip(mesh.local_positions(), self.devs)]
        self.optimizer = torch.optim.AdamW(
            [t for w in self.params for t in w.values()],
            lr=p.learning_rate, betas=ADAMW_BETAS, eps=ADAMW_EPS,
            weight_decay=ADAMW_WEIGHT_DECAY)

    def _shard(self, full: torch.Tensor, name: str, pos: int
               ) -> torch.Tensor:
        """Position ``pos``'s part of the whole parameter ``full``."""
        if name not in self.sharded:
            return full.clone()
        dim = _tp_dim(name)
        size = full.shape[dim] // self.tp
        i = self.mesh.axis_index(pos, "model")
        return full.narrow(dim, i * size, size).clone()

    def _whole(self, tensors: List[Dict[str, torch.Tensor]]
               ) -> List[Dict[str, torch.Tensor]]:
        """Each local position's tensors by name made whole: its copies
        as they are, its ``"model"`` shards gathered (one ``all_gather``
        of every shard flattened; its backward reduces the gradients
        back to the shards)."""
        from predictionio_tpu_torch.parallel.collectives import all_gather

        out = [{n: t[n] for n in self.whole} for t in tensors]
        if not self.sharded:
            return out
        flat = [torch.cat([t[n].reshape(-1) for n in self.sharded])
                for t in tensors]
        for o, t, g in zip(out, tensors,
                           all_gather(flat, self.mesh, "model")):
            parts = g.view(self.tp, -1)
            off = 0
            for n in self.sharded:
                size = t[n].numel()
                o[n] = torch.cat([parts[m, off:off + size].view(t[n].shape)
                                  for m in range(self.tp)], dim=_tp_dim(n))
                off += size
        return out

    def step(self, seqs: torch.Tensor, targets: torch.Tensor
             ) -> torch.Tensor:
        """One AdamW step on the whole batch ``seqs``/``targets`` (every
        process passes the same); returns the global loss (a scalar on
        the first local device, detached)."""
        from predictionio_tpu_torch.parallel.collectives import psum

        mesh = self.mesh
        weights = self._whole(self.params)
        s_blocks = split_blocks(seqs, mesh, self.spec)
        t_blocks = split_blocks(targets, mesh, self.spec)
        hidden = _forward_blocks(weights, s_blocks, mesh, self.p.n_heads,
                                 self.ring)
        # the global mask count: every process holds the whole batch
        den = (targets > 0).sum().clamp_min(1).float() * self.repeat
        parts = []
        for w, hj, tj in zip(weights, hidden, t_blocks):
            logits = hj @ w["emb"].T
            nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                  tj.reshape(-1), reduction="none")
            parts.append((nll.reshape(tj.shape) * (tj > 0).float()).sum()
                         / den.to(hj.device))
        self.optimizer.zero_grad(set_to_none=True)
        sum(x.to(self.devs[0]) for x in parts).backward()
        # each gradient summed over the axes its copies repeat on; the
        # loss rides with the whole parameters' gradients
        loss = None
        for names, axes in (
                (self.whole, mesh.axis_names),
                (self.sharded, [a for a in mesh.axis_names
                                if a != "model"])):
            if not names:
                continue
            vec = [torch.cat([w[n].grad.reshape(-1) for n in names]
                             + ([x.detach().reshape(1)]
                                if names is self.whole else []))
                   for w, x in zip(self.params, parts)]
            for axis in axes:
                vec = psum(vec, mesh, axis)
            for w, v in zip(self.params, vec):
                off = 0
                for n in names:
                    size = w[n].numel()
                    w[n].grad = v[off:off + size].view_as(w[n]).clone()
                    off += size
            if names is self.whole:
                loss = vec[0][-1]
        self.optimizer.step()
        return loss

    def whole_state(self) -> Dict[str, torch.Tensor]:
        """The whole parameters by name (every process gets them)."""
        with torch.no_grad():
            w = self._whole(self.params)[0]
        return {n: t.detach().cpu() for n, t in w.items()}

    def restore_opt(self, leaves, epoch0: int) -> None:
        """Load a snapshot's whole optax leaves, sharded as the
        parameters are (:func:`_snapshot_moments`' rule)."""
        shapes = {n: t.shape for n, t in self.whole_state().items()}
        got = _snapshot_moments(leaves, shapes, self.p.n_layers, epoch0)
        if got is None:
            return
        step, first, second = got
        for pos, w in zip(self.mesh.local_positions(), self.params):
            for n, prm in w.items():
                self.optimizer.state[prm] = {
                    "step": step.clone(),
                    "exp_avg": self._shard(first[n], n, pos).to(prm.device),
                    "exp_avg_sq": self._shard(second[n], n, pos).to(
                        prm.device)}

    def snapshot(self) -> Dict:
        """The reference's snapshot: whole parameters and moments."""
        moments = [[{n: self.optimizer.state[prm][key]
                     for n, prm in w.items()} for w in self.params]
                   for key in ("exp_avg", "exp_avg_sq")]
        first, second = (
            {n: t.cpu().numpy() for n, t in self._whole(m)[0].items()}
            for m in moments)
        step = self.optimizer.state[self.params[0]["emb"]]["step"]
        return {"params": to_reference_params(self.whole_state()),
                "opt_leaves": _opt_leaves(step, first, second,
                                          self.p.n_layers)}

    def model(self, all_items: np.ndarray) -> "SeqRecModel":
        return SeqRecModel(item_vocab=all_items, params=self.whole_state(),
                           hyper=self.p, device=self.devs[0])


def train_seqrec(mesh, sessions: Sequence[Sequence[str]], p: SeqRecParams,
                 checkpointer=None, device=None,
                 losses: Optional[list] = None,
                 timings: Optional[list] = None) -> SeqRecModel:
    """Id-assign, pad, and train with AdamW on ``device`` (``cuda``
    unless the caller asks for the CPU), or over ``mesh`` when it has
    more than one position or the attention is the ring (the module
    docstring; the model serves on the first local device). ``sessions``
    are per-user time-ordered item-id lists, every process passing them
    all. With a ``workflow.checkpoint.Checkpointer``, (params, optimizer
    state) snapshot every ``interval`` epochs and a preempted run
    resumes from the latest one. ``losses`` receives each step's loss,
    ``timings`` each epoch's seconds (the device synchronised). The
    vocabulary pads to a multiple of the mesh's ``"model"`` size (the
    reference's rule)."""
    on_mesh = _uses_ring(mesh, p.attention_impl) or (
        mesh is not None and mesh.size > 1)
    if on_mesh and checkpointer is not None and mesh.spans_processes:
        raise NotImplementedError(
            "a seqrec checkpoint over a mesh that spans processes: the "
            "reference cannot write it either (its Checkpointer.save "
            "calls np.asarray on parameters that span processes)")
    dev = mesh.local_devices()[0] if on_mesh else resolve_device(device)
    all_items, inputs, targets = encode_sessions(sessions, p.max_len)
    tp = int(mesh.shape.get("model", 1)) if on_mesh else 1
    state = _flatten(init_params(np.random.default_rng(p.seed),
                                 len(all_items), p, vocab_multiple=tp))
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
    n = len(inputs)
    bs = min(p.batch_size, n)
    if on_mesh:
        _check_divides(mesh, _token_spec(mesh, p.attention_impl == "ring"),
                       bs, p.max_len)
    trainer = _MeshTrain(mesh, state, p) if on_mesh \
        else _NetTrain(state, p, dev)
    if restored_opt_leaves is not None:
        trainer.restore_opt(restored_opt_leaves, epoch0)

    # the padded sessions go to the device once; batches index them there
    inputs_d = torch.from_numpy(inputs.astype(np.int64)).to(dev)
    targets_d = torch.from_numpy(targets.astype(np.int64)).to(dev)
    for epoch in range(epoch0, p.epochs):
        t0 = time.perf_counter()
        order_d = torch.from_numpy(epoch_order(n, p, epoch)).to(dev)
        epoch_losses = []
        for lo in range(0, n - bs + 1, bs):
            idx = order_d[lo:lo + bs]
            epoch_losses.append(trainer.step(inputs_d[idx], targets_d[idx]))
        if losses is not None and epoch_losses:
            losses.extend(torch.stack(epoch_losses).cpu().tolist())
        if timings is not None:
            for d in {dev, *(trainer.devs if on_mesh else ())}:
                synchronize(d)
            timings.append(time.perf_counter() - t0)
        done = epoch + 1
        if checkpointer is not None and checkpointer.due(done) \
                and done < p.epochs:
            checkpointer.save(done, trainer.snapshot(), fingerprint=fp)
    return trainer.model(all_items)


def _check_divides(mesh, spec, batch: int, max_len: int) -> None:
    """The batch must split evenly over ``"data"`` and, under the ring,
    the sessions' length over ``"seq"``."""
    for size, axis, what in ((batch, spec[0], "batch size"),
                             (max_len, spec[1], "seq len")):
        if axis is not None and size % mesh.shape[axis]:
            raise ValueError(f"{what} {size} not divisible by mesh axis "
                             f"'{axis}' size {mesh.shape[axis]}")
