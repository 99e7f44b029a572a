"""Mesh-sharded and multi-process ALS of the port (``models/als`` over
``parallel/``), held against the JAX package on the CPU.

* an 8-position single-process train (a mesh repeating the CPU), full
  and subspace, explicit and implicit, from the reference's initial
  factors: equal to the reference's ``mesh8`` train (atol 1e-4) and to
  the port's 1-position train;
* ``build_distributed`` within one process is ``ALSData.build(...,
  n_shards).put(mesh)``;
* the reference two-process test's analog, two real processes in a
  gloo group (``tests/torch_distributed_child.py``): identical U and V
  on both (1e-5), equal to the reference's 2-device train and to the
  port's one-process train (1e-4); a checkpointed train whose resume
  process 0's snapshot decides (process 1 writes nothing); the sharded
  sqlite read (strict subsets summing to the total) into
  ``build_distributed`` (the one-process digest, the same factors); the
  recommendation engine's DataSource and ``ALSAlgorithm.train`` (the
  one-process model's factors and answers), and its replicated
  fallback.
"""

import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh

from predictionio_tpu.models import als as ref_als
from predictionio_tpu_torch.models import als as port_als
from predictionio_tpu_torch.parallel.mesh import make_mesh

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_parallel import run_children  # noqa: E402
from torch_distributed_child import make_toy_ratings  # noqa: E402

sys.path.pop(0)

CPU = torch.device("cpu")
TOL = 1e-4        # against the reference / another shard count
SAME = 1e-5       # across the processes of one run


def _reference_init_V(params, n_items_pad, n_items):
    """The reference train's initial item factors for its padding."""
    key = jax.random.PRNGKey(params.seed)
    V = (jax.random.normal(key, (n_items_pad, params.rank), jnp.float32)
         / jnp.sqrt(jnp.asarray(params.rank, jnp.float32)))
    return np.asarray(V)[:n_items]


def _ratings(implicit: bool, seed=0, n_users=70, n_items=45, nnz=900):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, nnz).astype(np.int32)
    i = rng.integers(0, n_items, nnz).astype(np.int32)
    r = (rng.integers(1, 6, nnz).astype(np.float32) if not implicit
         else rng.integers(-1, 4, nnz).astype(np.float32))
    return u, i, r, n_users, n_items


CASES = {
    "explicit_full": dict(solver="full"),
    "explicit_subspace": dict(solver="subspace", block_size=4),
    "implicit_full": dict(solver="full", implicit_prefs=True, alpha=1.0),
    "implicit_subspace": dict(solver="subspace", block_size=4,
                              implicit_prefs=True, alpha=1.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_eight_position_train_matches_reference_mesh8(mesh8, case):
    kw = CASES[case]
    u, i, r, nu, ni = _ratings(kw.get("implicit_prefs", False))
    params = dict(rank=10, num_iterations=4, reg=0.05, seed=5,
                  chunk_size=64, **kw)
    ref_params = ref_als.ALSParams(**params)
    data_ref = ref_als.ALSData.build(u, i, r, nu, ni, 8)
    U_ref, V_ref = ref_als.train_als(mesh8, data_ref, ref_params)
    init_V = _reference_init_V(ref_params, data_ref.n_items_pad, ni)

    mesh = make_mesh(devices=[CPU] * 8)
    data8 = port_als.ALSData.build(u, i, r, nu, ni, n_shards=8)
    U8, V8 = port_als.train_als(data8, port_als.ALSParams(**params),
                                init_V=init_V, mesh=mesh)
    np.testing.assert_allclose(U8, U_ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(V8, V_ref, atol=TOL, rtol=0)
    data1 = port_als.ALSData.build(u, i, r, nu, ni)
    U1, V1 = port_als.train_als(data1, port_als.ALSParams(**params),
                                device="cpu", init_V=init_V)
    np.testing.assert_allclose(U8, U1, atol=TOL, rtol=0)
    np.testing.assert_allclose(V8, V1, atol=TOL, rtol=0)
    # the layout's shards and digest are the reference's
    assert data8.n_users_pad == data_ref.n_users_pad
    assert data8.n_items_pad == data_ref.n_items_pad
    assert data8.digest == data_ref.digest == data1.digest


def test_mesh_train_defaults_and_refusals():
    u, i, r, nu, ni = _ratings(False)
    data = port_als.ALSData.build(u, i, r, nu, ni, n_shards=3)
    params = port_als.ALSParams(rank=4, num_iterations=2, chunk_size=64)
    # without a mesh: the data's shard count on `device`
    U, V = port_als.train_als(data, params, device="cpu")
    U3, V3 = port_als.train_als(data, params,
                                mesh=make_mesh(devices=[CPU] * 3))
    np.testing.assert_array_equal(U, U3)
    np.testing.assert_array_equal(V, V3)
    with pytest.raises(ValueError, match="n_shards"):
        port_als.train_als(data, params, mesh=make_mesh(devices=[CPU] * 2))


def test_build_distributed_within_one_process_is_build_put():
    u, i, r, nu, ni = _ratings(False, seed=3)
    mesh = make_mesh((2, 2), ("data", "model"), devices=[CPU] * 4)
    got = port_als.build_distributed(mesh, u, i, r, nu, ni)
    want = port_als.ALSData.build(u, i, r, nu, ni, n_shards=4)
    assert got.positions == (0, 4) and got.digest == want.digest
    for side in ("by_user", "by_item"):
        g, w = getattr(got, side), getattr(want, side)
        for name in ("tgt", "val", "w", "seg"):
            for j in range(4):
                assert np.array_equal(getattr(g, name)[j].numpy(),
                                      getattr(w, name)[j])


# ---------------------------------------------------------------------------
# two processes
# ---------------------------------------------------------------------------

PARAMS = dict(rank=4, num_iterations=3, chunk_size=64)


def _make_engine_db(db_path):
    """A sqlite store holding the toy ratings as rate events of app
    DistApp (written through the port's storage)."""
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.storage.base import App
    from predictionio_tpu_torch.storage.registry import Storage

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    try:
        from torch_distributed_child import _configure_store
    finally:
        sys.path.pop(0)
    _configure_store(str(db_path))
    app_id = Storage.get_meta_data_apps().insert(App(id=0, name="DistApp"))
    store = Storage.get_events()
    store.init_channel(app_id)
    users, items, ratings, *_ = make_toy_ratings()
    store.insert_batch(
        [Event(event="rate", entity_type="user", entity_id=f"u{u:03d}",
               target_entity_type="item", target_entity_id=f"i{i:03d}",
               properties={"rating": float(r)})
         for u, i, r in zip(users, items, ratings)], app_id)


@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    work = tmp_path_factory.mktemp("als2")
    users, items, ratings, n_users, n_items = make_toy_ratings()
    ref_params = ref_als.ALSParams(**PARAMS)
    data_ref = ref_als.ALSData.build(users, items, ratings, n_users,
                                     n_items, 2)
    init_V = _reference_init_V(ref_params, data_ref.n_items_pad, n_items)
    np.save(work / "init_V.npy", init_V)
    from predictionio_tpu_torch.storage.registry import Storage

    try:
        _make_engine_db(work / "engine.db")
    finally:
        Storage.reset()
    results = run_children("als", work)
    return {"results": results, "work": work, "init_V": init_V,
            "data_ref": data_ref}


def _a(x):
    return np.asarray(x, np.float32)


def test_two_process_factors_identical_and_equal_to_one_process(
        two_process):
    r0, r1 = (two_process["results"][p] for p in (0, 1))
    np.testing.assert_allclose(_a(r0["U"]), _a(r1["U"]), atol=SAME, rtol=0)
    np.testing.assert_allclose(_a(r0["V"]), _a(r1["V"]), atol=SAME, rtol=0)
    users, items, ratings, n_users, n_items = make_toy_ratings()
    mesh2 = RefMesh(np.asarray(jax.devices()[:2]), axis_names=("data",))
    U_ref, V_ref = ref_als.train_als(mesh2, two_process["data_ref"],
                                     ref_als.ALSParams(**PARAMS))
    np.testing.assert_allclose(_a(r0["U"]), U_ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(_a(r0["V"]), V_ref, atol=TOL, rtol=0)
    data1 = port_als.ALSData.build(users, items, ratings, n_users, n_items)
    U1, V1 = port_als.train_als(data1, port_als.ALSParams(**PARAMS),
                                device="cpu",
                                init_V=two_process["init_V"])
    np.testing.assert_allclose(_a(r0["U"]), U1, atol=TOL, rtol=0)
    np.testing.assert_allclose(_a(r0["V"]), V1, atol=TOL, rtol=0)


def test_two_process_resume_is_process_zeros_decision(two_process):
    r0, r1 = (two_process["results"][p] for p in (0, 1))
    # process 0 alone writes snapshots; both resumed from its step 2 and
    # ran the 3 remaining iterations, equal to a straight 5-iteration run
    assert r0["ck_files"] and not r1["ck_files"]
    assert r0["resumed_half_sweeps"] == r1["resumed_half_sweeps"] == 6
    assert r0["resume_diff"] <= SAME and r1["resume_diff"] <= SAME


def test_two_process_sharded_store_read(two_process):
    r0, r1 = (two_process["results"][p] for p in (0, 1))
    users, items, ratings, *_ = make_toy_ratings()
    assert r0["store_shard"] == [0, 2] and r1["store_shard"] == [1, 2]
    assert 0 < r0["store_local_n"] < r0["store_total_n"]
    assert r0["store_local_n"] + r1["store_local_n"] == len(ratings)
    assert r0["store_total_n"] == len(ratings)
    # rows crossed the processes in the exchange, both ways
    assert r0["exchange"]["rows_out"] > 0 and r1["exchange"]["rows_out"] > 0
    uvocab = np.unique([f"u{u:03d}" for u in users])
    ivocab = np.unique([f"i{i:03d}" for i in items])
    u_idx = np.searchsorted(uvocab, [f"u{u:03d}" for u in users])
    i_idx = np.searchsorted(ivocab, [f"i{i:03d}" for i in items])
    sdata = port_als.ALSData.build(u_idx, i_idx, ratings, len(uvocab),
                                   len(ivocab))
    assert r0["store_digest"] == r1["store_digest"] == sdata.digest
    ref_digest = ref_als.ALSData.build(
        u_idx.astype(np.int32), i_idx.astype(np.int32), ratings,
        len(uvocab), len(ivocab), 2).digest
    assert sdata.digest == ref_digest
    sU, sV = port_als.train_als(sdata, port_als.ALSParams(**PARAMS),
                                device="cpu")
    np.testing.assert_allclose(_a(r0["store_U"]), sU, atol=TOL, rtol=0)
    np.testing.assert_allclose(_a(r0["store_V"]), sV, atol=TOL, rtol=0)
    np.testing.assert_allclose(_a(r0["store_U"]), _a(r1["store_U"]),
                               atol=SAME, rtol=0)


def test_two_process_engine_path(two_process):
    from predictionio_tpu_torch.data.eventstore import clear_cache
    from predictionio_tpu_torch.engines.recommendation import (
        ALSAlgorithm, AlgorithmParams, DataSourceParams,
        RecommendationDataSource, RecommendationPreparator,
    )
    from predictionio_tpu_torch.storage.registry import Storage

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    try:
        from torch_distributed_child import _configure_store
    finally:
        sys.path.pop(0)
    r0, r1 = (two_process["results"][p] for p in (0, 1))
    users, *_ = make_toy_ratings()
    assert 0 < r0["engine_local_rows"] < len(users)
    assert r0["engine_local_rows"] + r1["engine_local_rows"] == len(users)
    _configure_store(str(two_process["work"] / "engine.db"))
    clear_cache()
    try:
        ds = RecommendationDataSource(DataSourceParams(app_name="DistApp"))
        pd = RecommendationPreparator().prepare(None, ds.read_training(None))
        model = ALSAlgorithm(AlgorithmParams(rank=4, num_iterations=3)).train(
            types.SimpleNamespace(device=CPU, checkpointer=None), pd)
    finally:
        Storage.reset()
        clear_cache()
    for r in (r0, r1):
        assert r["engine_users"] == model.user_vocab.tolist()
        assert r["engine_items"] == model.item_vocab.tolist()
        np.testing.assert_allclose(_a(r["engine_U"]), model.U, atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(_a(r["engine_V"]), model.V, atol=TOL,
                                   rtol=0)
    for u, got in zip(model.user_vocab[:10], r0["engine_answers"]):
        want = model.recommend(str(u), 5)
        assert [i for i, _ in got] == [i for i, _ in want]
        np.testing.assert_allclose([s for _, s in got],
                                   [s for _, s in want], atol=TOL)
    # the replicated fallback keeps disjoint strided slices: every
    # rating once, the same model up to f32 reduction order
    assert r0["degrade_rows"] + r1["degrade_rows"] == len(users)
    np.testing.assert_allclose(_a(r0["degrade_U"]), _a(r0["engine_U"]),
                               atol=TOL, rtol=0)


def test_two_process_children_load_no_jax(two_process):
    for r in two_process["results"].values():
        assert r["forbidden_modules"] == []
        assert r["launches"] == {"shortlist": 0, "spd_solve": 0}
