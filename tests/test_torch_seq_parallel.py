"""The port's sequence parallelism and seqrec over a mesh of positions
(``ops/attention.ring_attention`` / ``ulysses_attention``,
``models/seqrec._MeshTrain``) against the JAX package, on the CPU, on
the same seeded numpy inputs. The reference runs on ``mesh8`` (eight
virtual CPU devices); the port on a mesh repeating the CPU eight times
(``make_mesh(devices=[cpu] * 8)``) of the same shape.

Tolerances:

* ring and Ulysses outputs within ``ATT_TOL`` (1e-5 absolute, the
  reference's own test's) of the reference's and of dense ``mha``;
  bf16 inputs within 0.05 of the f32 dense output (the reference's);
  ring's input gradients within ``GRAD_TOL`` (1e-5) of one-device
  flash's (f32 sums in another order);
* seqrec on a 4 x 2 ``("data", "model")`` mesh: every leaf within
  ``PARAM_TOL`` (1e-3) relative Frobenius norm of the reference's mesh
  train and ``emb`` within ``EMB_TOL`` (1e-5) absolute (measured 1e-6:
  the same f32 steps, the gradients' sums in another order); the
  answers' scores within ``SCORE_TOL`` (1e-4);
* seqrec with ``attention_impl="ring"`` on a 2 x 4 ``("data", "seq")``
  mesh: ``emb`` within 2e-4 absolute of the reference's flash train
  (the reference's own bound, tests/test_sessionrec.py:153-173);
* a mesh checkpoint resumed equals the straight mesh run within
  ``RESUME_TOL`` (1e-6).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh

import predictionio_tpu.models.seqrec as ref_seqrec
import predictionio_tpu.ops.attention as ref_att
import predictionio_tpu_torch.models.seqrec as port_seqrec
import predictionio_tpu_torch.ops.attention as port_att
from predictionio_tpu.workflow.checkpoint import (
    Checkpointer as RefCheckpointer,
)
from predictionio_tpu_torch.parallel.mesh import Mesh, make_mesh
from predictionio_tpu_torch.workflow.checkpoint import Checkpointer

CPU = torch.device("cpu")
ATT_TOL = 1e-5
GRAD_TOL = 1e-5
PARAM_TOL = 1e-3
EMB_TOL = 1e-5
SCORE_TOL = 1e-4
RING_TOL = 2e-4
RESUME_TOL = 1e-6


def port_mesh(shape=(8,), axes=("data",)):
    return make_mesh(shape, axes, devices=[CPU] * int(np.prod(shape)))


def ref_mesh(shape, axes):
    return RefMesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(
        shape), axis_names=axes)


def qkv(seed=0, b=2, l=64, h=8, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, l, h, d)).astype(np.float32)
                 for _ in range(3))


def torch_of(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def jax_of(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def key_mask(b=2, l=64, start=24):
    return np.repeat(np.arange(l)[None, :] >= start, b, axis=0)


# -- ring and Ulysses ---------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["ring_attention", "ulysses_attention"])
def test_sequence_parallel_attention_matches_reference(mesh8, impl, causal):
    q, k, v = qkv(seed=2 if impl == "ring_attention" else 3)
    want = np.asarray(getattr(ref_att, impl)(*jax_of(q, k, v), mesh8,
                                             axis="data", causal=causal))
    got = getattr(port_att, impl)(*torch_of(q, k, v), port_mesh(),
                                  axis="data", causal=causal).numpy()
    dense = port_att.mha(*torch_of(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=ATT_TOL, rtol=0)
    np.testing.assert_allclose(got, dense, atol=ATT_TOL, rtol=0)


def test_ring_and_ulysses_key_mask_match_reference(mesh8):
    q, k, v = qkv(seed=10)
    km = key_mask()
    dense = port_att.mha(*torch_of(q, k, v), causal=True,
                         key_mask=torch.from_numpy(km)).numpy()
    for impl in ("ring_attention", "ulysses_attention"):
        want = np.asarray(getattr(ref_att, impl)(
            *jax_of(q, k, v), mesh8, axis="data", causal=True,
            key_mask=jnp.asarray(km)))
        got = getattr(port_att, impl)(
            *torch_of(q, k, v), port_mesh(), axis="data", causal=True,
            key_mask=torch.from_numpy(km)).numpy()
        np.testing.assert_allclose(got, want, atol=ATT_TOL, rtol=0)
        np.testing.assert_allclose(got, dense, atol=ATT_TOL, rtol=0)


def test_ring_attention_bf16_inputs_like_reference(mesh8):
    q, k, v = qkv(seed=4)
    dense = port_att.mha(*torch_of(q, k, v)).numpy()
    want = ref_att.ring_attention(*jax_of(q, k, v, dtype=jnp.bfloat16),
                                  mesh8, axis="data")
    got = port_att.ring_attention(*torch_of(q, k, v, dtype=torch.bfloat16),
                                  port_mesh(), axis="data")
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), dense, atol=0.05)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=0.05)


def test_ring_on_a_data_by_seq_mesh_matches_reference():
    """dp x sp: the batch over "data", each data row its own ring over
    "seq"."""
    q, k, v = qkv(seed=5, b=4)
    km = key_mask(b=4, start=9)
    want = np.asarray(ref_att.ring_attention(
        *jax_of(q, k, v), ref_mesh((2, 4), ("data", "seq")), causal=True,
        key_mask=jnp.asarray(km)))
    got = port_att.ring_attention(*torch_of(q, k, v),
                                  port_mesh((2, 4), ("data", "seq")),
                                  causal=True,
                                  key_mask=torch.from_numpy(km)).numpy()
    np.testing.assert_allclose(got, want, atol=ATT_TOL, rtol=0)


@pytest.mark.parametrize("impl,shape,match", [
    ("ring_attention", (1, 12, 4, 8), "not divisible"),
    ("ulysses_attention", (1, 64, 4, 8), "heads"),
    ("ulysses_attention", (1, 12, 8, 8), "seq len")])
def test_divisibility_errors_match_reference(mesh8, impl, shape, match):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    with pytest.raises(ValueError, match=match) as want:
        getattr(ref_att, impl)(*jax_of(x, x, x), mesh8, axis="data")
    with pytest.raises(ValueError, match=match) as got:
        getattr(port_att, impl)(*torch_of(x, x, x), port_mesh(),
                                axis="data")
    assert str(got.value) == str(want.value)


def test_ring_input_gradients_match_flash():
    """The gradients flow back through the ring's passes: q, k and v's
    gradients equal one-device flash attention's."""
    q, k, v = qkv(seed=6)
    km = torch.from_numpy(key_mask(start=17))
    ring_in = [t.requires_grad_() for t in torch_of(q, k, v)]
    flash_in = [t.requires_grad_() for t in torch_of(q, k, v)]
    weights = torch.from_numpy(
        np.random.default_rng(7).normal(size=q.shape).astype(np.float32))
    (port_att.ring_attention(*ring_in, port_mesh(), axis="data",
                             causal=True, key_mask=km) * weights).sum(
                             ).backward()
    (port_att.blockwise_attention(*flash_in, block_k=16, causal=True,
                                  key_mask=km) * weights).sum().backward()
    for a, b in zip(ring_in, flash_in):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   atol=GRAD_TOL, rtol=0)


# -- seqrec over a mesh ---------------------------------------------------------------

def cyclic_sessions(n=48, n_items=14, seed=7):
    """Users browsing a cyclic catalog of ``n_items`` (V = 15: padded to
    16 under tp 2)."""
    rng = np.random.default_rng(seed)
    return [[f"i{(int(rng.integers(0, n_items)) + j) % n_items:02d}"
             for j in range(int(rng.integers(3, 12)))] for _ in range(n)]


SMALL = dict(d_model=16, n_heads=2, n_layers=1, max_len=8, epochs=3,
             batch_size=8)
QUERIES = [["i03", "i04", "i05"], ["i10"], ["i12", "i13", "i00"],
           ["i07", "nope", "i08"]]


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_same_answers(got, want, tol):
    """Scores within ``tol``; ids equal except at near-ties."""
    assert len(got) == len(want), (got, want)
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=0, atol=tol)
    want_score = dict(want)
    for (gi, _), (wi, w) in zip(got, want):
        if gi != wi:
            assert abs(want_score.get(gi, want[-1][1]) - w) <= 2 * tol


def test_seqrec_on_a_data_by_model_mesh_matches_reference():
    sessions = cyclic_sessions()
    ref = ref_seqrec.train_seqrec(ref_mesh((4, 2), ("data", "model")),
                                  sessions, ref_seqrec.SeqRecParams(**SMALL))
    got = port_seqrec.train_seqrec(port_mesh((4, 2), ("data", "model")),
                                   sessions,
                                   port_seqrec.SeqRecParams(**SMALL))
    want = port_seqrec._flatten(jax.tree.map(np.asarray, ref.params))
    assert got.params["emb"].shape == want["emb"].shape == (16, 16)
    for k, v in got.params.items():
        assert rel(v, want[k]) <= PARAM_TOL, (k, rel(v, want[k]))
    np.testing.assert_allclose(got.params["emb"], want["emb"], rtol=0,
                               atol=EMB_TOL)
    for q in QUERIES:
        assert_same_answers(got.recommend_next(q, 5),
                            ref.recommend_next(q, 5), SCORE_TOL)


def test_seqrec_data_mesh_steps_equal_the_one_device_steps():
    """dp alone (no padding): an 8-position ``"data"`` mesh's per-step
    losses and final parameters are the one-device train's."""
    sessions = cyclic_sessions()
    p = port_seqrec.SeqRecParams(**SMALL)
    one_losses, mesh_losses = [], []
    one = port_seqrec.train_seqrec(None, sessions, p, device="cpu",
                                   losses=one_losses)
    mesh = port_seqrec.train_seqrec(port_mesh(), sessions, p,
                                    losses=mesh_losses)
    np.testing.assert_allclose(mesh_losses, one_losses, rtol=1e-6, atol=0)
    for k, v in mesh.params.items():
        np.testing.assert_allclose(v, one.params[k], rtol=0, atol=EMB_TOL)


def test_seqrec_ring_on_a_data_by_seq_mesh_matches_flash():
    sessions = [[f"i{(s + j) % 10}" for j in range(8)] for s in range(24)]
    base = dict(d_model=16, n_heads=2, n_layers=1, max_len=8, epochs=2,
                batch_size=8)
    flash = ref_seqrec.train_seqrec(None, sessions,
                                    ref_seqrec.SeqRecParams(**base))
    ref_ring = ref_seqrec.train_seqrec(
        ref_mesh((2, 4), ("data", "seq")), sessions,
        ref_seqrec.SeqRecParams(**base, attention_impl="ring"))
    ring = port_seqrec.train_seqrec(
        port_mesh((2, 4), ("data", "seq")), sessions,
        port_seqrec.SeqRecParams(**base, attention_impl="ring"))
    for want in (flash, ref_ring):
        np.testing.assert_allclose(ring.params["emb"],
                                   np.asarray(want.params["emb"]),
                                   atol=RING_TOL, rtol=0)
    assert ring.recommend_next(["i2", "i3"], 3)


def test_seqrec_ring_forward_matches_flash():
    """The net's forward with ``attention_impl="ring"`` over a mesh with
    a "seq" axis: the flash forward's hidden states."""
    p = port_seqrec.SeqRecParams(**dict(SMALL, n_layers=2))
    tree = ref_seqrec.init_params(np.random.default_rng(3), 20, p)
    net = port_seqrec.SeqRecNet.from_state(
        port_seqrec.from_reference_params(tree), p.n_heads)
    seqs, _ = ref_seqrec.pad_sessions(
        [list(range(1, n)) for n in (3, 9, 12, 1)], p.max_len)
    s = torch.from_numpy(seqs.astype(np.int64))
    with torch.no_grad():
        flash = net(s).numpy()
        ring = net(s, port_mesh((2, 4), ("data", "seq")), "ring").numpy()
    np.testing.assert_allclose(ring, flash, atol=ATT_TOL, rtol=0)


def test_seqrec_mesh_rules():
    sessions = cyclic_sessions(8)
    p = port_seqrec.SeqRecParams(**dict(SMALL, batch_size=6))
    with pytest.raises(ValueError, match="batch size 6 not divisible"):
        port_seqrec.train_seqrec(port_mesh((4, 2), ("data", "model")),
                                 sessions, p)
    p = port_seqrec.SeqRecParams(**dict(SMALL, attention_impl="ring"))
    with pytest.raises(ValueError, match='"seq" axis'):
        port_seqrec.train_seqrec(port_mesh((4, 2), ("data", "model")),
                                 sessions, p)
    with pytest.raises(ValueError, match="seq len 8 not divisible"):
        port_seqrec.train_seqrec(port_mesh((1, 3), ("data", "seq")),
                                 sessions, p)


def test_mesh_checkpoint_resumes_in_the_reference_layout(tmp_path):
    """A mesh inside one process snapshots whole parameters and
    moments (the reference's layout), and the resumed run equals the
    straight one."""
    rng = np.random.default_rng(0)
    sessions = [[f"i{(s + j) % 12:02d}" for j in range(6)]
                for s in rng.integers(0, 12, size=64)]
    kw = dict(d_model=16, n_heads=2, n_layers=1, max_len=8, batch_size=16)
    mesh = port_mesh((4, 2), ("data", "model"))
    straight = port_seqrec.train_seqrec(
        mesh, sessions, port_seqrec.SeqRecParams(epochs=4, **kw))
    ck = Checkpointer(str(tmp_path), interval=2)
    port_seqrec.train_seqrec(mesh, sessions,
                             port_seqrec.SeqRecParams(epochs=3, **kw),
                             checkpointer=ck)
    snap = pickle.loads(next(f for f in tmp_path.iterdir()
                             if f.suffix == ".pkl").read_bytes())
    tree = snap["state"]["params"]
    assert tree["emb"].shape == (14, 16)       # 13 items + pad, whole
    leaves = snap["state"]["opt_leaves"]
    assert leaves[0].dtype == np.int32 and int(leaves[0]) == 2 * 4
    names = port_seqrec.param_names(1)
    assert [np.shape(x) for x in leaves[1:1 + len(names)]] == \
        [np.shape(port_seqrec._flatten(tree)[n]) for n in names]
    losses = []
    resumed = port_seqrec.train_seqrec(
        mesh, sessions, port_seqrec.SeqRecParams(epochs=4, **kw),
        checkpointer=ck, losses=losses)
    assert len(losses) == 2 * (64 // 16)        # epochs 2..3 only
    for k, v in resumed.params.items():
        np.testing.assert_allclose(v, straight.params[k], rtol=0,
                                   atol=RESUME_TOL)


def test_reference_mesh_snapshot_resumes_on_the_port_mesh(tmp_path):
    """A snapshot the reference's 4 x 2 mesh train wrote resumes on the
    port's 4 x 2 mesh, and the answers match the reference's straight
    run."""
    sessions = cyclic_sessions()
    kw = dict(SMALL, epochs=4)
    straight = ref_seqrec.train_seqrec(ref_mesh((4, 2), ("data", "model")),
                                       sessions,
                                       ref_seqrec.SeqRecParams(**kw))
    ref_seqrec.train_seqrec(ref_mesh((4, 2), ("data", "model")), sessions,
                            ref_seqrec.SeqRecParams(**dict(kw, epochs=3)),
                            checkpointer=RefCheckpointer(str(tmp_path),
                                                         interval=2))
    losses = []
    got = port_seqrec.train_seqrec(
        port_mesh((4, 2), ("data", "model")), sessions,
        port_seqrec.SeqRecParams(**kw),
        checkpointer=Checkpointer(str(tmp_path), interval=2), losses=losses)
    assert len(losses) == 2 * (48 // 8)
    want = port_seqrec._flatten(jax.tree.map(np.asarray, straight.params))
    for k, v in got.params.items():
        assert rel(v, want[k]) <= PARAM_TOL, (k, rel(v, want[k]))


def test_checkpoint_across_processes_raises(tmp_path):
    """The reference cannot snapshot parameters that span processes
    (``Checkpointer.save``'s ``np.asarray``); the port says so before
    it trains."""
    devs = np.empty(2, dtype=object)
    devs[:] = [CPU, CPU]
    spanning = Mesh(devs, np.asarray([0, 1]), ("data",), process_index=0)
    with pytest.raises(NotImplementedError, match="reference cannot"):
        port_seqrec.train_seqrec(
            spanning, cyclic_sessions(8), port_seqrec.SeqRecParams(**SMALL),
            checkpointer=Checkpointer(str(tmp_path), interval=1))
