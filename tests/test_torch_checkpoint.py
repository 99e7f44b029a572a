"""The port's checkpoint/resume (``workflow/checkpoint``, ``train_als``
with a ``Checkpointer``) against the reference: the cases of
``tests/test_checkpoint.py`` (seqrec aside), ``als_fingerprint`` equal
to the reference's hex string, and snapshots crossing between the
packages in both directions."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import predictionio_tpu.models.als as ref_als
import predictionio_tpu_torch.models.als as port_als
from predictionio_tpu.workflow.checkpoint import (
    Checkpointer as RefCheckpointer,
)
from predictionio_tpu_torch.models.als import (
    ALSData, ALSParams, als_fingerprint, train_als,
)
from predictionio_tpu_torch.workflow.checkpoint import (
    Checkpointer, checkpointer_of,
)

#: the port against itself (same ops, same inputs): only the order of
#: index_add_ sums may differ
SELF_TOL = 1e-5


def test_checkpointer_save_latest_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), interval=5, keep=2)
    assert ck.latest() is None
    assert not ck.due(3) and ck.due(5) and ck.due(10)
    for step in (5, 10, 15):
        ck.save(step, {"x": np.full((2,), step)})
    step, state = ck.latest()
    assert step == 15 and state["x"][0] == 15
    assert sorted(os.listdir(str(tmp_path))) == ["step_10.pkl",
                                                 "step_15.pkl"]
    ck.clear()
    assert ck.latest() is None


def test_checkpointer_tmp_never_corrupts(tmp_path):
    ck = Checkpointer(str(tmp_path), interval=1)
    ck.save(1, {"x": np.ones(1)})
    with open(os.path.join(str(tmp_path), "step_2.pkl.tmp"), "wb") as f:
        f.write(b"garbage")
    assert ck.latest()[0] == 1


def test_fingerprint_mismatch_ignores_snapshot(tmp_path):
    ck = Checkpointer(str(tmp_path), interval=1)
    ck.save(3, {"x": np.ones(2)}, fingerprint="aaa")
    assert ck.latest() is None
    assert ck.latest(fingerprint="aaa")[0] == 3
    assert ck.latest(fingerprint="bbb") is None
    ck.save(4, {"x": np.ones(2)})
    assert ck.latest(fingerprint="aaa")[0] == 3
    assert ck.latest()[0] == 4


def test_snapshot_unpickler_rejects_code_execution(tmp_path):
    canary = str(tmp_path / "pwned")

    class Evil:
        def __reduce__(self):
            return (os.system, (f"touch {canary}",))

    ck = Checkpointer(str(tmp_path), interval=1)
    ck.save(1, {"x": np.ones(2)}, fingerprint="fp")
    with open(ck._path(2, "fp"), "wb") as f:
        f.write(pickle.dumps({"step": 2, "state": Evil(),
                              "fingerprint": "fp"}))
    step, state = ck.latest(fingerprint="fp")
    assert step == 1 and state["x"][0] == 1.0
    assert not os.path.exists(canary), "snapshot payload was executed!"
    with open(ck._path(3, "fp"), "wb") as f:
        f.write(pickle.dumps(np.ones(1)))
    assert ck.latest(fingerprint="fp")[0] == 1


def test_stale_lineage_not_shadowing_not_starving(tmp_path):
    ck = Checkpointer(str(tmp_path), interval=1, keep=2)
    ck.save(8, {"x": np.full(1, 8.0)}, fingerprint="old-run")
    assert ck.latest(fingerprint="new-run") is None
    for step in (2, 3, 4):
        ck.save(step, {"x": np.full(1, float(step))}, fingerprint="new-run")
    step, state = ck.latest(fingerprint="new-run")
    assert step == 4 and state["x"][0] == 4.0
    step, state = ck.latest(fingerprint="old-run")
    assert step == 8 and state["x"][0] == 8.0
    assert len(os.listdir(str(tmp_path))) == 3


def test_saves_tensors_as_host_arrays_and_scopes(tmp_path):
    import torch

    ck = Checkpointer(str(tmp_path), interval=2)
    scoped = ck.scoped("algo_0_als")
    scoped.save(2, {"V": torch.ones(3, 2), "meta": [torch.zeros(1), 7]})
    step, state = scoped.latest()
    assert step == 2 and isinstance(state["V"], np.ndarray)
    assert state["meta"][1] == 7
    assert ck.latest() is None          # other namespace
    ck.clear()
    assert scoped.latest() is None      # clear walks the scoped dirs
    assert checkpointer_of(type("Ctx", (), {"checkpointer": ck})) is ck
    assert checkpointer_of(object()) is None


def _coo(seed=0, nu=60, ni=40):
    rng = np.random.default_rng(seed)
    mask = rng.random((nu, ni)) < 0.3
    users, items = np.nonzero(mask)
    u_lat = rng.normal(size=(nu, 4)).astype(np.float32)
    v_lat = rng.normal(size=(ni, 4)).astype(np.float32)
    ratings = (u_lat @ v_lat.T)[users, items].astype(np.float32)
    return users.astype(np.int32), items.astype(np.int32), ratings, nu, ni


def _port_data(seed=0):
    return ALSData.build(*_coo(seed))


def _ref_data(seed=0, n_shards=1):
    return ref_als.ALSData.build(*_coo(seed), n_shards=n_shards)


def _mesh1():
    return Mesh(np.asarray(jax.devices()[:1]), axis_names=("data",))


@pytest.mark.parametrize("params", [
    dict(rank=4), dict(rank=6, reg=0.05, seed=9),
    dict(rank=8, implicit_prefs=True, alpha=2.5, weighted_reg=False),
    dict(rank=4, solver="subspace", block_size=2, num_iterations=3)])
def test_als_fingerprint_equals_reference(params):
    port = als_fingerprint(_port_data(), ALSParams(**params))
    for n_shards in (1, 8):
        assert port == ref_als.als_fingerprint(
            _ref_data(n_shards=n_shards), ref_als.ALSParams(**params))
    # ...and other ratings of the same shape differ
    u, i, r, nu, ni = _coo()
    other = ALSData.build(u, i, r + 1.0, nu, ni)
    assert als_fingerprint(other, ALSParams(**params)) != port


def test_als_changed_params_retrain_from_scratch(tmp_path):
    data = _port_data(seed=2)
    ck = Checkpointer(str(tmp_path), interval=2)
    crashed = ALSParams(rank=6, num_iterations=3, reg=0.5, chunk_size=64)
    train_als(data, crashed, device="cpu", checkpointer=ck)   # snap @2
    assert any(f.suffix == ".pkl" for f in tmp_path.iterdir())
    changed = ALSParams(rank=6, num_iterations=6, reg=0.01, chunk_size=64)
    U_ck, V_ck = train_als(data, changed, device="cpu", checkpointer=ck)
    U_st, V_st = train_als(data, changed, device="cpu")
    np.testing.assert_allclose(U_ck, U_st, atol=SELF_TOL)
    np.testing.assert_allclose(V_ck, V_st, atol=SELF_TOL)


@pytest.mark.parametrize("solver", ["full", "subspace"])
def test_als_checkpointed_matches_straight(tmp_path, solver):
    data = _port_data()
    params = ALSParams(rank=6, num_iterations=7, chunk_size=64,
                       solver=solver, block_size=4)
    U1, V1 = train_als(data, params, device="cpu")
    ck = Checkpointer(str(tmp_path), interval=3)
    U2, V2 = train_als(data, params, device="cpu", checkpointer=ck)
    np.testing.assert_allclose(U1, U2, atol=SELF_TOL)
    np.testing.assert_allclose(V1, V2, atol=SELF_TOL)
    # 7 iterations at interval 3: snapshots at steps 3 and 6
    step, state = ck.latest(fingerprint=als_fingerprint(data, params))
    assert step == 6 and state["V"].shape == (data.n_items, 6)
    assert ("U" in state) == (solver == "subspace")


@pytest.mark.parametrize("solver", ["full", "subspace"])
def test_als_resumes_from_snapshot(tmp_path, solver, monkeypatch):
    data = _port_data(seed=1)
    ck = Checkpointer(str(tmp_path), interval=4)
    short = ALSParams(rank=6, num_iterations=5, chunk_size=64,
                      solver=solver, block_size=4)
    train_als(data, short, device="cpu", checkpointer=ck)
    assert ck.latest(fingerprint=als_fingerprint(data, short))[0] == 4
    full = ALSParams(rank=6, num_iterations=12, chunk_size=64,
                     solver=solver, block_size=4)
    sweeps = []
    name = "_half_sweep_subspace" if solver == "subspace" else "_half_sweep"
    real = getattr(port_als, name)
    monkeypatch.setattr(port_als, name,
                        lambda *a, **k: sweeps.append(1) or real(*a, **k))
    U_res, V_res = train_als(data, full, device="cpu", checkpointer=ck)
    assert len(sweeps) == 2 * (12 - 4)       # only the remaining sweeps
    monkeypatch.setattr(port_als, name, real)
    U_st, V_st = train_als(data, full, device="cpu")
    np.testing.assert_allclose(U_res, U_st, atol=1e-4)
    np.testing.assert_allclose(V_res, V_st, atol=1e-4)


def test_snapshot_at_or_past_target_trains_from_scratch(tmp_path):
    data = _port_data()
    params = ALSParams(rank=4, num_iterations=3, chunk_size=64)
    ck = Checkpointer(str(tmp_path), interval=1)
    ck.save(3, {"V": np.zeros((data.n_items, 4), np.float32)},
            fingerprint=als_fingerprint(data, params))
    U, V = train_als(data, params, device="cpu", checkpointer=ck)
    U_st, V_st = train_als(data, params, device="cpu")
    np.testing.assert_allclose(V, V_st, atol=SELF_TOL)


def test_reference_snapshot_resumes_in_the_port(tmp_path):
    """The reference's Checkpointer writes V at step 4 of its own train;
    the port's train_als finds it under the same fingerprint and runs
    the remaining 6 iterations: within 1e-5 of the port's straight run
    from that V. The reference's straight run agrees loosely (two
    frameworks' f32 sweeps)."""
    params = dict(rank=6, chunk_size=64)
    ref_data = _ref_data(seed=3)
    ref_ck = RefCheckpointer(str(tmp_path), interval=4)
    ref_als.train_als(_mesh1(), ref_data,
                      ref_als.ALSParams(num_iterations=5, **params),
                      checkpointer=ref_ck)
    fp = ref_als.als_fingerprint(ref_data,
                                 ref_als.ALSParams(num_iterations=10,
                                                   **params))
    step, state = ref_ck.latest(fingerprint=fp)
    assert step == 4

    data = _port_data(seed=3)
    full = ALSParams(num_iterations=10, **params)
    assert als_fingerprint(data, full) == fp
    U_res, V_res = train_als(data, full, device="cpu",
                             checkpointer=Checkpointer(str(tmp_path)))
    U_st, V_st = train_als(data, ALSParams(num_iterations=6, **params),
                           device="cpu", init_V=state["V"])
    np.testing.assert_allclose(U_res, U_st, atol=1e-5)
    np.testing.assert_allclose(V_res, V_st, atol=1e-5)

    U_ref, V_ref = ref_als.train_als(
        _mesh1(), ref_data, ref_als.ALSParams(num_iterations=10, **params))
    np.testing.assert_allclose(V_res, V_ref, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(U_res, U_ref, atol=1e-3, rtol=1e-3)


def test_port_snapshot_resumes_in_the_reference(tmp_path):
    """The other direction: the port's snapshot (tensors written as host
    arrays) is found and resumed by the reference's train_als."""
    params = dict(rank=6, chunk_size=64)
    data = _port_data(seed=4)
    ck = Checkpointer(str(tmp_path), interval=3)
    init = np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                        (data.n_items, 6), jnp.float32)
                      / jnp.sqrt(jnp.float32(6)))
    train_als(data, ALSParams(num_iterations=4, **params), device="cpu",
              init_V=init, checkpointer=ck)
    ref_data = _ref_data(seed=4)
    full = ref_als.ALSParams(num_iterations=8, **params)
    ref_ck = RefCheckpointer(str(tmp_path), interval=3)
    assert ref_ck.latest(fingerprint=ref_als.als_fingerprint(
        ref_data, full))[0] == 3
    U_res, V_res = ref_als.train_als(_mesh1(), ref_data, full,
                                     checkpointer=ref_ck)
    U_st, V_st = ref_als.train_als(_mesh1(), ref_data, full)
    np.testing.assert_allclose(V_res, V_st, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(U_res, U_st, atol=1e-3, rtol=1e-3)
