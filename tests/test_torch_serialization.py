"""The port's model blobs for every ALS engine's model kind
(``workflow/serialization.py``): ``als``, ``ecomm``, ``similarity``,
``cooccurrence`` and ``recommended_user`` round-trip through one tagged
``.npz`` blob and through a model file, array for array and field for
field (exact: nothing is recomputed but the normalized V, which is the
same numpy expression); a blob written before the other kinds existed
(ALS slots only, the layout below) still loads; a pickled blob of the
reference's models is refused and never unpickled.
"""

import io
import pickle

import numpy as np
import pytest

import predictionio_tpu.engines.ecommerce as ref_ecom
from predictionio_tpu.workflow.serialization import (
    serialize_models as ref_serialize,
)
from predictionio_tpu_torch.engines.common import Item
from predictionio_tpu_torch.engines.ecommerce import (
    ECommModel, normalized_rows,
)
from predictionio_tpu_torch.engines.recommended_user import (
    RecommendedUserModel,
)
from predictionio_tpu_torch.engines.similarproduct import (
    CooccurrenceEngineModel, SimilarityModel,
)
from predictionio_tpu_torch.models.als import ALSModel
from predictionio_tpu_torch.models.cooccurrence import CooccurrenceModel
from predictionio_tpu_torch.workflow.serialization import (
    BLOB_FORMAT, ModelFormatError, deserialize_models, load_model,
    save_model, serialize_models, top_lists,
)


def _vocab(prefix, n):
    return np.asarray([f"{prefix}{j:02d}" for j in range(n)])


def _models(seed=0):
    rng = np.random.default_rng(seed)
    users, items = _vocab("u", 6), _vocab("i", 9)
    U = rng.standard_normal((6, 4)).astype(np.float32)
    V = rng.standard_normal((9, 4)).astype(np.float32)
    meta = {0: Item(categories=["c0"]), 3: Item(categories=["c1", "c2"]),
            5: Item(categories=None)}
    top = {0: [(3, 7), (1, 2)], 2: [(8, 1)], 8: [(2, 1), (0, 1), (5, 1)]}
    return [
        ALSModel.from_arrays(users, items, U, V, device="cpu"),
        ECommModel(user_vocab=users, item_vocab=items, U=U, V=V,
                   V_normalized=normalized_rows(V), items=meta,
                   popular_count={1: 4, 7: 2}, device="cpu"),
        SimilarityModel(item_vocab=items, V=normalized_rows(V), items=meta,
                        device="cpu"),
        CooccurrenceEngineModel(
            model=CooccurrenceModel(item_vocab=items,
                                    top_cooccurrences=top),
            items=meta, device="cpu"),
        RecommendedUserModel(user_vocab=users, V=normalized_rows(U),
                             users={"u00": {"name": "a"}, "u03": {}},
                             device="cpu"),
    ]


def _assert_same(got, want):
    assert type(got) is type(want)
    if isinstance(want, CooccurrenceEngineModel):
        assert list(got.model.item_vocab) == list(want.model.item_vocab)
        assert got.model.top_cooccurrences == want.model.top_cooccurrences
    for f in ("user_vocab", "item_vocab"):
        if hasattr(want, f):
            assert list(getattr(got, f)) == list(getattr(want, f)), f
    for f in ("U", "V", "V_normalized"):
        if hasattr(want, f):
            assert getattr(got, f).dtype == np.float32
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    if hasattr(want, "items"):
        assert {k: v.categories for k, v in got.items.items()} == \
            {k: v.categories for k, v in want.items.items()}
    for f in ("popular_count", "users"):
        if hasattr(want, f):
            assert getattr(got, f) == getattr(want, f)
    assert str(got.device) == "cpu"


@pytest.mark.parametrize("kind", range(5), ids=[
    "als", "ecomm", "similarity", "cooccurrence", "recommended_user"])
def test_blob_round_trip(kind):
    model = _models()[kind]
    blob = serialize_models([model, None])
    back = deserialize_models(blob, device="cpu")
    assert back[1] is None
    _assert_same(back[0], model)
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        assert str(z["format"]) == BLOB_FORMAT
        vocab_key = "0/item_vocab" if "0/item_vocab" in z.files \
            else "0/user_vocab"
        assert z[vocab_key].dtype.kind == "U"


@pytest.mark.parametrize("kind", range(5), ids=[
    "als", "ecomm", "similarity", "cooccurrence", "recommended_user"])
def test_model_file_round_trip(kind, tmp_path):
    model = _models(1)[kind]
    path = tmp_path / "m.npz"
    save_model(path, model)
    _assert_same(load_model(path, device="cpu"), model)


def test_all_kinds_in_one_blob():
    models = _models(2)
    back = deserialize_models(serialize_models(models), device="cpu")
    for got, want in zip(back, models):
        _assert_same(got, want)


def test_cooccurrence_top_lists_pad_with_zero_counts():
    top = {0: [(3, 7), (1, 2)], 4: [(2, 9)]}
    ids, counts = top_lists(top, 5)
    assert ids.dtype == counts.dtype == np.int32 and ids.shape == (5, 2)
    np.testing.assert_array_equal(counts, [[7, 2], [0, 0], [0, 0], [0, 0],
                                           [9, 0]])
    np.testing.assert_array_equal(ids[0], [3, 1])


def test_blob_of_earlier_slices_still_loads():
    """The layout the port wrote while it persisted ALS models only."""
    rng = np.random.default_rng(3)
    U = rng.standard_normal((2, 3)).astype(np.float32)
    V = rng.standard_normal((4, 3)).astype(np.float32)
    buf = io.BytesIO()
    np.savez(buf, **{"format": np.asarray(BLOB_FORMAT),
                     "slots": np.asarray(2, np.int64),
                     "0/kind": np.asarray("als"),
                     "0/user_vocab": np.asarray(["u0", "u1"]),
                     "0/item_vocab": np.asarray(["a", "b", "c", "d"]),
                     "0/U": U, "0/V": V,
                     "1/kind": np.asarray("retrain")})
    back = deserialize_models(buf.getvalue(), device="cpu")
    assert isinstance(back[0], ALSModel) and back[1] is None
    np.testing.assert_array_equal(back[0].V, V)
    assert list(back[0].item_vocab) == ["a", "b", "c", "d"]


def test_reference_pickle_is_refused_not_unpickled(monkeypatch):
    rng = np.random.default_rng(4)
    V = rng.standard_normal((3, 2)).astype(np.float32)
    blob = ref_serialize([ref_ecom.ECommModel(
        user_vocab=np.asarray(["u"]), item_vocab=np.asarray(["a", "b", "c"]),
        U=rng.standard_normal((1, 2)).astype(np.float32), V=V,
        V_normalized=V, items={}, popular_count={})])

    def no_unpickle(*_a, **_k):
        raise AssertionError("the port unpickled a model blob")

    monkeypatch.setattr(pickle, "load", no_unpickle)
    monkeypatch.setattr(pickle, "loads", no_unpickle)
    with pytest.raises(ModelFormatError, match="JAX package"):
        deserialize_models(blob, device="cpu")
    with pytest.raises(ModelFormatError, match="unknown kind"):
        buf = io.BytesIO()
        np.savez(buf, format=np.asarray(BLOB_FORMAT),
                 slots=np.asarray(1, np.int64),
                 **{"0/kind": np.asarray("pickled")})
        deserialize_models(buf.getvalue(), device="cpu")
    with pytest.raises(TypeError, match="persists these model kinds only"):
        serialize_models([object()])
