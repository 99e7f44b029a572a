"""The port's session model (``models/seqrec.py``) against the JAX
package's, on the CPU, on the same seeded numpy inputs.

Tolerances:

* ``init_params``, ``pad_sessions``, ``seqrec_fingerprint``: equal (bit
  for bit: the same numpy draws);
* the forward's hidden states within ``FWD_TOL`` (1e-5 absolute and
  relative); the loss within ``GRAD_TOL`` (1e-5) relative and every
  gradient within a relative Frobenius norm of ``GRAD_TOL`` of
  ``jax.grad``'s (f32 sums in another order);
* training: every step's loss within ``LOSS_TOL`` (1e-4) relative of
  the reference's; the final parameters within ``PARAM_TOL`` (1e-3)
  relative Frobenius norm a leaf, because Adam's ``m / sqrt(v)`` turns
  an entry whose gradient is near zero into about +-lr on either side
  (measured here: at most 6e-6 a leaf, the losses 1.3e-6); the top-10
  answers' scores within ``SCORE_TOL`` (1e-4 absolute; measured 8.3e-6)
  and their ids equal except where two scores lie within that of each
  other;
* a model trained by the JAX package and carried across
  (``from_reference_params``) answers with scores within ``FWD_TOL`` and
  the same ids except among near-ties;
* a resumed run equals the straight run within ``RESUME_TOL`` (1e-6;
  the same CPU math from the same snapshot).
"""

import logging
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import predictionio_tpu.models.seqrec as ref_seqrec
import predictionio_tpu_torch.models.seqrec as port_seqrec
from predictionio_tpu.workflow.checkpoint import (
    Checkpointer as RefCheckpointer,
)
from predictionio_tpu_torch.workflow.checkpoint import Checkpointer

FWD_TOL = 1e-5
GRAD_TOL = 1e-5
LOSS_TOL = 1e-4
PARAM_TOL = 1e-3
SCORE_TOL = 1e-4
RESUME_TOL = 1e-6

SMALL = dict(d_model=16, n_heads=2, n_layers=1, max_len=8, epochs=3,
             batch_size=8)


def cyclic_sessions(n=48, n_items=15, seed=7):
    """Users browsing a cyclic catalog: i(k) -> i(k+1) -> ..."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        start = int(rng.integers(0, n_items))
        out.append([f"i{(start + j) % n_items:02d}"
                    for j in range(int(rng.integers(3, 12)))])
    return out


def params_pair(**kw):
    return ref_seqrec.SeqRecParams(**kw), port_seqrec.SeqRecParams(**kw)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def batch(n_items, max_len, b=6, seed=3):
    """Left-padded [B, L] codes and targets, one session empty."""
    rng = np.random.default_rng(seed)
    sessions = [list(rng.integers(1, n_items + 1,
                                  size=int(rng.integers(2, max_len + 4))))
                for _ in range(b - 1)] + [[]]
    return ref_seqrec.pad_sessions(sessions, max_len)


# -- weights ---------------------------------------------------------------------

@pytest.mark.parametrize("kw,n_items,multiple", [
    (dict(d_model=16, n_heads=2, n_layers=1, max_len=8), 14, 1),
    (dict(d_model=32, n_heads=4, n_layers=2, max_len=16), 30, 4),
])
def test_init_params_bit_equal(kw, n_items, multiple):
    ref_p, port_p = params_pair(**kw)
    ref = ref_seqrec.init_params(np.random.default_rng(11), n_items, ref_p,
                                 vocab_multiple=multiple)
    got = port_seqrec.init_params(np.random.default_rng(11), n_items, port_p,
                                  vocab_multiple=multiple)
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in ref_leaves] == [p for p, _ in got_leaves]
    for (_, r), (_, g) in zip(ref_leaves, got_leaves):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(r))


def test_param_names_are_the_reference_leaf_order():
    _, port_p = params_pair(d_model=8, n_heads=2, n_layers=3, max_len=4)
    tree = port_seqrec.init_params(np.random.default_rng(0), 5, port_p)
    names = [".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path)
             for path, _ in jax.tree_util.tree_leaves_with_path(tree)]
    assert names == port_seqrec.param_names(3)


def test_reference_params_round_trip():
    ref_p, _ = params_pair(d_model=8, n_heads=2, n_layers=2, max_len=4)
    tree = ref_seqrec.init_params(np.random.default_rng(1), 9, ref_p)
    state = port_seqrec.from_reference_params(tree)
    assert sorted(state) == sorted(port_seqrec.param_names(2))
    back = port_seqrec.to_reference_params(state)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, np.asarray(b))
    net = port_seqrec.SeqRecNet.from_state(state, n_heads=2)
    assert set(net.state_dict()) == set(state)
    assert tuple(net.layers[0].wqkv.shape) == (8, 24)


# -- forward, loss, gradients -----------------------------------------------------

@pytest.mark.parametrize("kw,n_items", [
    (dict(d_model=16, n_heads=2, n_layers=1, max_len=8), 20),
    (dict(d_model=32, n_heads=4, n_layers=2, max_len=12), 40),
])
def test_forward_loss_and_gradients_match_reference(kw, n_items):
    ref_p, _ = params_pair(**kw)
    tree = ref_seqrec.init_params(np.random.default_rng(5), n_items, ref_p)
    seqs, targets = batch(n_items, kw["max_len"])
    ref_hidden = np.asarray(ref_seqrec.forward(tree, jnp.asarray(seqs),
                                               kw["n_heads"]))
    ref_loss, ref_grads = jax.value_and_grad(ref_seqrec._loss_fn)(
        tree, jnp.asarray(seqs), jnp.asarray(targets), kw["n_heads"])

    net = port_seqrec.SeqRecNet.from_state(
        port_seqrec.from_reference_params(tree), kw["n_heads"])
    s_t = torch.from_numpy(seqs.astype(np.int64))
    t_t = torch.from_numpy(targets.astype(np.int64))
    with torch.no_grad():
        hidden = port_seqrec.forward(net, s_t).numpy()
    np.testing.assert_allclose(hidden, ref_hidden, rtol=FWD_TOL, atol=FWD_TOL)
    assert (hidden[seqs == 0] == 0).all()        # pads zeroed after ln_f

    loss = port_seqrec._loss_fn(net, s_t, t_t)
    loss.backward()
    assert abs(float(loss.detach()) - float(ref_loss)) <= GRAD_TOL * abs(
        float(ref_loss))
    got = {k: p.grad.numpy() for k, p in net.named_parameters()}
    want = port_seqrec._flatten(jax.tree.map(np.asarray, ref_grads))
    assert set(got) == set(want)
    for k in want:
        assert rel(got[k], want[k]) <= GRAD_TOL, (k, rel(got[k], want[k]))


def test_attention_impl_and_mesh_rules():
    sessions = [["a", "b", "c"] for _ in range(4)]
    p = port_seqrec.SeqRecParams(d_model=8, n_heads=2, n_layers=1,
                                 max_len=8, epochs=1, batch_size=4,
                                 attention_impl="ring")
    with pytest.raises(ValueError, match="seq"):
        port_seqrec.train_seqrec(None, sessions, p, device="cpu")
    p.attention_impl = "dense"
    with pytest.raises(ValueError, match="unknown attention_impl"):
        port_seqrec.train_seqrec(None, sessions, p, device="cpu")
    p.attention_impl = "flash"
    # a mesh of two positions (the CPU repeated) trains the one-device
    # model: the same steps, the batch split over "data"
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    one_losses, two_losses = [], []
    one = port_seqrec.train_seqrec(None, sessions, p, device="cpu",
                                   losses=one_losses)
    two = port_seqrec.train_seqrec(make_mesh(devices=["cpu"] * 2),
                                   sessions, p, losses=two_losses)
    np.testing.assert_allclose(two_losses, one_losses, rtol=LOSS_TOL)
    for k, v in two.params.items():
        assert rel(v, one.params[k]) <= PARAM_TOL, k


# -- host helpers -----------------------------------------------------------------

@pytest.mark.parametrize("max_len", [1, 4, 8])
def test_pad_sessions_equal(max_len):
    rng = np.random.default_rng(2)
    sessions = [list(rng.integers(1, 30, size=int(n)))
                for n in rng.integers(0, 14, size=25)]
    for a, b in zip(port_seqrec.pad_sessions(sessions, max_len),
                    ref_seqrec.pad_sessions(sessions, max_len)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_fingerprint_is_the_reference_string():
    sessions = cyclic_sessions(10)
    vocab = np.asarray(sorted({i for s in sessions for i in s}), object)
    for kw in (SMALL, dict(SMALL, learning_rate=3e-3), dict(SMALL, seed=1)):
        ref_p, port_p = params_pair(**kw)
        assert port_seqrec.seqrec_fingerprint(vocab, port_p, sessions) == \
            ref_seqrec.seqrec_fingerprint(vocab, ref_p, sessions)
    ref_p, port_p = params_pair(**SMALL)
    assert port_seqrec.seqrec_fingerprint(vocab, port_p) == \
        ref_seqrec.seqrec_fingerprint(vocab, ref_p)


# -- training ---------------------------------------------------------------------

def reference_losses(sessions, ref_p):
    """The reference's train loop, step by step: each step's loss and
    the final parameters (its own ``make_train_step``, ``optax.adamw``)."""
    all_items = sorted({it for s in sessions for it in s})
    code = {it: i + 1 for i, it in enumerate(all_items)}
    coded = [[code[it] for it in s] for s in sessions if len(s) >= 2]
    inputs, targets = ref_seqrec.pad_sessions(coded, ref_p.max_len)
    params = ref_seqrec.init_params(np.random.default_rng(ref_p.seed),
                                    len(all_items), ref_p)
    optimizer = optax.adamw(ref_p.learning_rate)
    opt_state = optimizer.init(params)
    step = ref_seqrec.make_train_step(None, ref_p, optimizer)
    n = len(inputs)
    bs = min(ref_p.batch_size, n)
    losses = []
    for epoch in range(ref_p.epochs):
        order = np.arange(n)
        np.random.default_rng(ref_p.seed + epoch).shuffle(order)
        for lo in range(0, n - bs + 1, bs):
            idx = order[lo:lo + bs]
            params, opt_state, loss = step(params, opt_state,
                                           jnp.asarray(inputs[idx]),
                                           jnp.asarray(targets[idx]))
            losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params)


def assert_same_answers(got, want, tol):
    """Scores within ``tol``; ids equal except where the reference's
    scores at the two places lie within ``2 * tol`` (a near-tie), or at
    the cut."""
    assert len(got) == len(want), (got, want)
    gs = np.array([s for _, s in got])
    ws = np.array([s for _, s in want])
    np.testing.assert_allclose(gs, ws, rtol=0, atol=tol)
    want_score = dict(want)
    for (gi, _), (wi, w) in zip(got, want):
        if gi == wi:
            continue
        other = want_score.get(gi, ws[-1])
        assert abs(other - w) <= 2 * tol, (got, want)


QUERIES = [["i03", "i04", "i05"], ["i10"], ["i13", "i14", "i00", "i01"],
           ["i07", "nope", "i08"], [f"i{j:02d}" for j in range(12)]]


def test_train_matches_reference_step_by_step():
    sessions = cyclic_sessions()
    ref_p, port_p = params_pair(**SMALL)
    ref_losses, ref_final = reference_losses(sessions, ref_p)
    ref_model = ref_seqrec.train_seqrec(None, sessions, ref_p)
    losses = []
    model = port_seqrec.train_seqrec(None, sessions, port_p, device="cpu",
                                     losses=losses)
    assert len(losses) == len(ref_losses) == 3 * (48 // 8)
    for a, b in zip(losses, ref_losses):
        assert abs(a - b) <= LOSS_TOL * abs(b), (a, b)
    want = port_seqrec._flatten(ref_final)
    for k, v in model.params.items():
        assert rel(v, want[k]) <= PARAM_TOL, (k, rel(v, want[k]))
    assert list(model.item_vocab) == list(ref_model.item_vocab)
    for q in QUERIES:
        assert_same_answers(model.recommend_next(q, 10),
                            ref_model.recommend_next(q, 10), SCORE_TOL)


def test_recommend_next_on_a_reference_model_carried_across():
    """A model the JAX package trained, served by the port: the same
    answers (both seen-code rules: the last max_len codes feed the
    forward, every seen code is masked)."""
    sessions = cyclic_sessions()
    ref_p, port_p = params_pair(**dict(SMALL, epochs=4))
    ref_model = ref_seqrec.train_seqrec(None, sessions, ref_p)
    model = port_seqrec.SeqRecModel(
        item_vocab=ref_model.item_vocab,
        params=port_seqrec.from_reference_params(ref_model.params),
        hyper=port_p, device="cpu")
    for q in QUERIES + [["nope"], []]:
        for num in (1, 3, 10, 40):
            assert_same_answers(model.recommend_next(q, num),
                                ref_model.recommend_next(q, num), FWD_TOL)
    # seen items never come back, even those before the window
    long_q = [f"i{j:02d}" for j in range(12)]
    assert {i for i, _ in model.recommend_next(long_q, 10)}.isdisjoint(
        long_q)
    assert model.recommend_next(["nope"], 5) == []


def test_device_contract_counts_and_releases():
    sessions = cyclic_sessions(16)
    _, port_p = params_pair(**dict(SMALL, epochs=1))
    model = port_seqrec.train_seqrec(None, sessions, port_p, device="cpu")
    want = sum(v.nbytes for v in model.params.values())
    assert model.device_bytes() == want
    model.release_device()
    assert model.device_bytes() == 0
    assert model.recommend_next(["i01"], 2)
    assert model.device_bytes() == want


# -- checkpoint-resume ------------------------------------------------------------

def test_resume_equals_the_straight_run(tmp_path):
    """The port's twin of tests/test_checkpoint.py::test_seqrec_resume:
    snapshots every 3 epochs, a run "preempted" after 4, the resumed
    6-epoch run equal to the straight one."""
    rng = np.random.default_rng(0)
    sessions = [[f"i{(s + j) % 12:02d}" for j in range(6)]
                for s in rng.integers(0, 12, size=80)]
    kw = dict(d_model=16, n_heads=2, n_layers=1, max_len=8, batch_size=32)
    straight = port_seqrec.train_seqrec(
        None, sessions, port_seqrec.SeqRecParams(epochs=6, **kw),
        device="cpu")
    ck = Checkpointer(str(tmp_path), interval=3)
    port_seqrec.train_seqrec(None, sessions,
                             port_seqrec.SeqRecParams(epochs=4, **kw),
                             checkpointer=ck, device="cpu")
    assert any(f.suffix == ".pkl" for f in tmp_path.iterdir())
    losses = []
    resumed = port_seqrec.train_seqrec(
        None, sessions, port_seqrec.SeqRecParams(epochs=6, **kw),
        checkpointer=ck, device="cpu", losses=losses)
    assert len(losses) == 3 * (80 // 32)        # epochs 3..5 only
    for k, v in resumed.params.items():
        np.testing.assert_allclose(v, straight.params[k], rtol=0,
                                   atol=RESUME_TOL)
    recs = resumed.recommend_next(["i02", "i03"], 3)
    assert any(it == "i04" for it, _ in recs)


def test_resume_across_packages(tmp_path):
    """A snapshot the JAX package wrote resumes in the port (same
    fingerprint, the reference's param pytree and optax leaves): the
    remaining epochs' losses match the reference's straight run's."""
    sessions = cyclic_sessions()
    ref_p6, port_p6 = params_pair(**dict(SMALL, epochs=6))
    ref_losses, _ = reference_losses(sessions, ref_p6)
    ck = RefCheckpointer(str(tmp_path), interval=3)
    ref_seqrec.train_seqrec(None, sessions,
                            ref_seqrec.SeqRecParams(**dict(SMALL, epochs=4)),
                            checkpointer=ck)
    losses = []
    port_seqrec.train_seqrec(None, sessions, port_p6,
                             checkpointer=Checkpointer(str(tmp_path),
                                                       interval=3),
                             device="cpu", losses=losses)
    tail = ref_losses[len(ref_losses) - len(losses):]
    assert len(losses) == len(ref_losses) // 2
    for a, b in zip(losses, tail):
        assert abs(a - b) <= LOSS_TOL * abs(b), (a, b)


def test_resume_rejects_mismatched_opt_state(tmp_path, caplog):
    """The port's twin of tests/test_sessionrec.py::
    test_sessionrec_resume_rejects_mismatched_opt_state: optimizer
    leaves of the right count but the wrong shape and dtype resume the
    params with reset moments and the reference's warning."""
    sessions = [[f"i{(s + j) % 6}" for j in range(4)] for s in range(12)]
    kw = dict(d_model=8, n_heads=2, n_layers=1, max_len=8, batch_size=4)
    ck = Checkpointer(str(tmp_path), interval=1)
    port_seqrec.train_seqrec(None, sessions,
                             port_seqrec.SeqRecParams(epochs=2, **kw),
                             checkpointer=ck, device="cpu")
    snaps = [f for f in tmp_path.iterdir() if f.suffix == ".pkl"]
    assert snaps, "interval=1 must have left a mid-train snapshot"
    for f in snaps:
        snap = pickle.loads(f.read_bytes())
        snap["state"]["opt_leaves"] = [
            np.float16(0) for _ in snap["state"]["opt_leaves"]]
        f.write_bytes(pickle.dumps(snap))
    with caplog.at_level(logging.WARNING):
        model = port_seqrec.train_seqrec(
            None, sessions, port_seqrec.SeqRecParams(epochs=3, **kw),
            checkpointer=ck, device="cpu")
    assert model.recommend_next(["i0", "i1"], 2)
    assert any("RESET adam moments" in r.message for r in caplog.records)
