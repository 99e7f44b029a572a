"""ALS serving of the port against the reference: ``ALSModel.from_arrays``
of the reference model's arrays answers ``recommend_batch`` and
``recommend_batch_arrays`` like the reference's ``ALSModel``, in ``exact``
(host-BLAS and device lanes) and ``twostage`` modes, with black/white
lists, unknown users, ``num=0`` and ``num > n_items``.

Ids equal; scores within rtol 1e-5 (products run in another order). The
data is tie-free. Also: the model file round-trips the four arrays.
"""

import numpy as np
import pytest
import torch

import predictionio_tpu.models.als as ref_als
import predictionio_tpu_torch.models.als as port_als
from predictionio_tpu.ops import scoring as ref_scoring
from predictionio_tpu.utils.server_config import ScorerConfig as RefConfig
from predictionio_tpu_torch.ops import scoring as port_scoring
from predictionio_tpu_torch.utils.server_config import ScorerConfig
from predictionio_tpu_torch.workflow.serialization import (
    load_model, save_model,
)

N_ITEMS, N_USERS, RANK = 700, 20, 12


@pytest.fixture(autouse=True)
def _reset_scorer_state():
    def reset():
        for mod, scoring in ((ref_als, ref_scoring),
                             (port_als, port_scoring)):
            scoring.set_process_scorer_config(None)
            mod._DEVICE_ROUNDTRIP_S = None
            mod._DEVICE_ROUNDTRIP_MODE = None
    reset()
    yield
    reset()


def _reference_model(seed=21):
    rng = np.random.default_rng(seed)
    spec = np.power(10.0, -1.2 * np.arange(RANK) / (RANK - 1))
    uv = np.sort(np.asarray([f"u{i:03d}" for i in range(N_USERS)],
                            dtype=object))
    iv = np.sort(np.asarray([f"i{i:05d}" for i in range(N_ITEMS)],
                            dtype=object))
    U = (rng.standard_normal((N_USERS, RANK)) * spec).astype(np.float32)
    V = (rng.standard_normal((N_ITEMS, RANK)) * spec).astype(np.float32)
    return ref_als.ALSModel(user_vocab=uv, item_vocab=iv, U=U, V=V)


REQUESTS = [
    ("u003", 10, (), None),
    ("u007", 5, ("i00001", "i00002", "i00003"), None),
    ("nobody", 10, (), None),
    ("u011", 0, (), None),
    ("u012", 8, (), tuple(f"i{i:05d}" for i in range(100, 160))),
    ("u015", N_ITEMS + 50, (), None),
    ("u019", 10, ("i00009",), tuple(f"i{i:05d}" for i in range(0, 700, 7))),
]


def _set_mode(mode, lane):
    ref_scoring.set_process_scorer_config(
        RefConfig(mode=mode, tile_items=128, shortlist=64))
    port_scoring.set_process_scorer_config(
        ScorerConfig(mode=mode, tile_items=128, shortlist=64))
    # exact mode routes by the measured dispatch crossover: pin the lane
    rt = {"device": 0.0, "host": 1e9}[lane]
    ref_als._DEVICE_ROUNDTRIP_S = rt
    port_als._DEVICE_ROUNDTRIP_S = rt


def _assert_same_recs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [i for i, _ in g] == [i for i, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   rtol=1e-5)


LANES = [("exact", "host"), ("exact", "device"), ("twostage", "device")]


@pytest.mark.parametrize("mode,lane", LANES)
def test_recommend_batch_matches_reference(mode, lane):
    ref_model = _reference_model()
    model = port_als.ALSModel.from_arrays(
        ref_model.user_vocab, ref_model.item_vocab, ref_model.U, ref_model.V,
        device="cpu")
    _set_mode(mode, lane)
    want = ref_model.recommend_batch(REQUESTS)
    got = model.recommend_batch(REQUESTS)
    _assert_same_recs(got, want)
    assert got[2] == [] and got[3] == []
    assert len(got[5]) == N_ITEMS
    assert not {"i00001", "i00002", "i00003"} & {i for i, _ in got[1]}
    if mode == "twostage":
        status = model._scorer_cache[2].status()
        assert status["activeMode"] == "twostage"
        # single-request path too
        _assert_same_recs([model.recommend("u003", 4)],
                          [ref_model.recommend("u003", 4)])


@pytest.mark.parametrize("mode,lane", LANES)
def test_recommend_batch_arrays_matches_reference(mode, lane):
    ref_model = _reference_model(seed=22)
    model = port_als.ALSModel.from_arrays(
        ref_model.user_vocab, ref_model.item_vocab, ref_model.U, ref_model.V,
        device="cpu")
    _set_mode(mode, lane)
    items_r, scores_r, counts_r = ref_model.recommend_batch_arrays(REQUESTS)
    items_p, scores_p, counts_p = model.recommend_batch_arrays(REQUESTS)
    assert np.array_equal(counts_p, counts_r)
    assert items_p.tolist() == items_r.tolist()
    np.testing.assert_allclose(scores_p, scores_r, rtol=1e-5)
    assert scores_p.dtype == np.float64


def test_unknown_users_only_and_negative_num():
    model = port_als.ALSModel.from_arrays(
        *(lambda m: (m.user_vocab, m.item_vocab, m.U, m.V))(
            _reference_model()), device="cpu")
    assert model.recommend_batch([("x", 3, (), None)]) == [[]]
    with pytest.raises(ValueError, match="num must be >= 0"):
        model.recommend_batch([("u001", -1, (), None)])


def test_model_file_round_trip(tmp_path):
    ref_model = _reference_model()
    path = tmp_path / "als.npz"
    save_model(path, ref_model)
    model = load_model(path, device="cpu")
    assert model.user_vocab.tolist() == ref_model.user_vocab.tolist()
    assert model.item_vocab.tolist() == ref_model.item_vocab.tolist()
    assert np.array_equal(model.U, ref_model.U)
    assert np.array_equal(model.V, ref_model.V)
    assert model.device == torch.device("cpu")
    np.savez(tmp_path / "bad.npz", U=ref_model.U)
    with pytest.raises(ValueError, match="missing"):
        load_model(tmp_path / "bad.npz", device="cpu")
