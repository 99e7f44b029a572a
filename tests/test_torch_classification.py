"""The port's classification slice (``models/naive_bayes.py``,
``models/logreg.py``, ``models/forest.py``, ``models/vectorizer.py``,
``models/markov_chain.py``, ``ops/device_cache.py``,
``engines/classification.py`` and its three codecs) against the JAX
package, on the CPU, on the same seeded numpy inputs.

Tolerances:

* multinomial NB: ``log_prior``/``log_prob`` within ``NB_TOL`` (1e-6;
  both are float64 logs cast to f32 from exact integer counts), labels
  equal, on each of the three count branches (the device branch of both
  packages forced by their ``DEVICE_MIN_SIZE`` on the CPU);
* categorical NB, the vectorizer and the Markov chain: equal (the same
  numpy code);
* logistic regression from the reference's own initial W: W and b
  within ``LOGREG_TOL * max(1, |W|)`` (1e-4; measured 1.5e-6 at 500 x
  50 and 3e-7 at 4,000 x 400: the same 200 f32 Adam steps, the
  gradients' sums in another order, which Adam's ``m / sqrt(v)`` can
  amplify where an entry's gradient is near zero), labels equal;
* the random forest: node arrays, thresholds and predictions EXACTLY
  equal (integer histograms, the reference's f32 cost formula in its
  order, the first minimum on ties);
* the engine: the same labels from each algorithm on every query of the
  attribute grid, the same k-fold folds and the same Accuracy.
"""

import dataclasses
import gc
import http.client
import json
import os
import pathlib
import socket
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import predictionio_tpu.data.eventstore as ref_eventstore
import predictionio_tpu.engines.classification as ref_cls
import predictionio_tpu.models.forest as ref_forest
import predictionio_tpu.models.logreg as ref_logreg
import predictionio_tpu.models.markov_chain as ref_mc
import predictionio_tpu.models.naive_bayes as ref_nb
import predictionio_tpu.models.vectorizer as ref_vec
import predictionio_tpu.ops.device_cache as ref_cache
import predictionio_tpu_torch.data.eventstore as port_eventstore
import predictionio_tpu_torch.engines.classification as port_cls
import predictionio_tpu_torch.models.forest as port_forest
import predictionio_tpu_torch.models.logreg as port_logreg
import predictionio_tpu_torch.models.markov_chain as port_mc
import predictionio_tpu_torch.models.naive_bayes as port_nb
import predictionio_tpu_torch.models.vectorizer as port_vec
import predictionio_tpu_torch.ops.device_cache as port_cache
from predictionio_tpu.core import Evaluation as RefEvaluation
from predictionio_tpu.core.params import EngineParams as RefEngineParams
from predictionio_tpu.data import DataMap as RefDataMap, Event as RefEvent
from predictionio_tpu.deploy.foldin import resolve_foldin as ref_resolve_foldin
from predictionio_tpu.storage import App as RefApp, Storage as RefStorage
from predictionio_tpu.workflow import run_evaluation as ref_run_evaluation
from predictionio_tpu.workflow.context import WorkflowContext as RefContext
from predictionio_tpu_torch.core.evaluation import Evaluation
from predictionio_tpu_torch.core.params import EngineParams
from predictionio_tpu_torch.deploy.foldin import resolve_foldin
from predictionio_tpu_torch.deploy.warm import EngineInstance
from predictionio_tpu_torch.obs.capacity import model_capacity
from predictionio_tpu_torch.server.query_server import create_query_server
from predictionio_tpu_torch.storage.registry import Storage as PortStorage
from predictionio_tpu_torch.utils.server_config import FoldinConfig
from predictionio_tpu_torch.workflow.evaluate import run_evaluation
from predictionio_tpu_torch.workflow.serialization import (
    deserialize_models, serialize_models,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
NB_TOL = 1e-6
LOGREG_TOL = 1e-4
APP = "TorchClsApp"
ALGOS = ("naive", "logreg", "randomforest")


# -- data -----------------------------------------------------------------------

def spam_data(n_docs, vocab, seed=3, dtype=np.float32):
    """``bench.py``'s naive_bayes_spam law at a small size: Poisson
    counts, 40% spam."""
    rng = np.random.default_rng(seed)
    labels = np.where(rng.random(n_docs) < 0.4, "spam", "ham")
    X = rng.poisson(np.where((labels == "spam")[:, None],
                             rng.random(vocab) * 2.0,
                             rng.random(vocab) * 1.2)).astype(dtype)
    return X, labels


def ref_init_W(n_features, n_labels, seed):
    """The reference's initial W (``jax.random.normal`` * 0.01)."""
    return np.asarray(jax.random.normal(
        jax.random.PRNGKey(seed), (n_features, n_labels), jnp.float32) * 0.01)


# -- multinomial NB ---------------------------------------------------------------

@pytest.mark.parametrize("branch", ["device", "host_gemm", "scatter"])
def test_multinomial_nb_matches_reference(monkeypatch, branch):
    X, labels = spam_data(600, 40)
    if branch == "device":
        monkeypatch.setattr(ref_nb, "DEVICE_MIN_SIZE", 1)
        monkeypatch.setattr(port_nb, "DEVICE_MIN_SIZE", 1)
    if branch == "scatter":
        X = X.astype(np.int32)          # not float: the scatter fold
    ref = ref_nb.train_multinomial_nb(X, labels)
    got = port_nb.train_multinomial_nb(X, labels, device="cpu")
    assert got.branches == {f"train_{branch}": 1}
    assert list(got.label_vocab) == list(ref.label_vocab)
    np.testing.assert_allclose(got.log_prior, ref.log_prior, atol=NB_TOL)
    np.testing.assert_allclose(got.log_prob, ref.log_prob, atol=NB_TOL)
    # train-then-predict on the same X: the device route when the train
    # left X resident, the host product otherwise
    want = ref.predict(X)
    assert list(got.predict(X)) == list(want)
    resident = "predict_device" if branch == "device" else "predict_host"
    assert got.branches[resident] == 1
    np.testing.assert_allclose(got.predict_scores(X), ref.predict_scores(X),
                               rtol=1e-5, atol=1e-4)
    # a fresh array is not resident: the host product
    fresh = X[:50].copy()
    assert list(got.predict(fresh)) == list(ref.predict(fresh))
    assert got.branches["predict_host"] >= 1


def test_multinomial_nb_keeps_the_reference_size_rule(monkeypatch):
    """At the spam bench's shape the device branch is the reference's
    own choice (40M elements >= DEVICE_MIN_SIZE); below it, host gemm."""
    assert port_nb.DEVICE_MIN_SIZE == ref_nb.DEVICE_MIN_SIZE == 1_000_000
    assert port_nb.PREDICT_DEVICE_MIN_SIZE == ref_nb.PREDICT_DEVICE_MIN_SIZE
    X, labels = spam_data(300, 20)
    assert port_nb.train_multinomial_nb(X, labels, device="cpu").branches \
        == {"train_host_gemm": 1}
    # past the one-hot bound: the scatter fold, as the reference's
    monkeypatch.setattr(port_nb, "ONEHOT_MAX_BYTES", 300 * 2 * 4 - 1)
    assert port_nb.train_multinomial_nb(X, labels, device="cpu").branches \
        == {"train_scatter": 1}


@pytest.mark.parametrize("X", [
    np.array([[0.0, 3.0], [255.0, 1.0]], np.float32),
    np.array([[0.0, 256.0], [3.0, 1.0]], np.float32),
    np.array([[70000.0, 1.0]], np.float32),
    np.array([[0.5, 1.0]], np.float32),
    np.array([[-1.0, 1.0]], np.float64),
    np.array([[1, 2]], np.int32),
    np.array([[1, 2]], np.uint16),
    np.zeros((0, 3), np.float32),
], ids=["u8", "u16", "wide", "fraction", "negative", "int", "uint16",
        "empty"])
def test_compact_for_transfer_dtypes(X):
    assert port_nb._compact_for_transfer(X).dtype == \
        ref_nb._compact_for_transfer(X).dtype


def test_device_branch_widens_uint16_on_the_device(monkeypatch):
    """Counts past 255 ship as uint16 (int16 bits) and widen exactly."""
    X, labels = spam_data(200, 10)
    X[0, 0] = 300.0
    monkeypatch.setattr(ref_nb, "DEVICE_MIN_SIZE", 1)
    monkeypatch.setattr(port_nb, "DEVICE_MIN_SIZE", 1)
    assert port_nb._compact_for_transfer(X).dtype == np.uint16
    ref = ref_nb.train_multinomial_nb(X, labels)
    got = port_nb.train_multinomial_nb(X, labels, device="cpu")
    np.testing.assert_allclose(got.log_prob, ref.log_prob, atol=NB_TOL)


@pytest.mark.parametrize("fit", ["nb", "logreg", "forest"])
def test_a_mesh_of_several_positions_fits_like_one_device(monkeypatch,
                                                          fit):
    """Two positions (the CPU repeated) fit the one-device model: the
    naive Bayes counts and the forest's nodes exactly, logistic
    regression within ``LOGREG_TOL``; a one-position mesh is the
    one-device path."""
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(port_nb, "DEVICE_MIN_SIZE", 0)
    X, labels = spam_data(40, 4)
    call = {"nb": lambda **kw: port_nb.train_multinomial_nb(
                X, labels, **kw),
            "logreg": lambda **kw: port_logreg.train_logreg(
                X, labels, **kw),
            "forest": lambda **kw: port_forest.train_forest(
                X, labels, port_forest.ForestParams(num_trees=3), **kw)}[fit]
    one = call(device="cpu")
    two = call(mesh=make_mesh(devices=["cpu", "cpu"]))
    single = call(mesh=make_mesh(devices=["cpu"]), device="cpu")
    fields = {"nb": ("log_prob", "log_prior"), "logreg": ("W", "b"),
              "forest": ("feat", "thr", "leaf")}[fit]
    for k in fields:
        np.testing.assert_allclose(getattr(two, k), getattr(one, k),
                                   atol=LOGREG_TOL if fit == "logreg" else 0,
                                   rtol=0)
        np.testing.assert_array_equal(getattr(single, k), getattr(one, k))
    assert list(two.predict(X)) == list(one.predict(X))
    if fit == "nb":
        assert two.branches["train_mesh"] == 1
        assert single.branches["train_device"] == 1


# -- categorical NB (the e2 fixture of tests/test_models.py) ---------------------

def _nb_points(mod):
    return [mod.LabeledPoint("spam", ("free", "money", "now")),
            mod.LabeledPoint("spam", ("free", "cash", "now")),
            mod.LabeledPoint("ham", ("meeting", "money", "tomorrow")),
            mod.LabeledPoint("ham", ("meeting", "agenda", "tomorrow"))]


def test_categorical_nb_matches_reference():
    ref = ref_nb.train_categorical_nb(_nb_points(ref_nb))
    got = port_nb.train_categorical_nb(_nb_points(port_nb))
    assert got.priors == ref.priors
    assert got.likelihoods == ref.likelihoods
    floor = lambda ls: min(ls) - 1        # noqa: E731
    for label, feats in [("spam", ("free", "money", "now")),
                         ("ham", ("meeting", "money", "tomorrow")),
                         ("spam", ("UNSEEN", "money", "now")),
                         ("eggs", ("free",))]:
        assert got.log_score(port_nb.LabeledPoint(label, feats)) == \
            ref.log_score(ref_nb.LabeledPoint(label, feats))
        assert got.log_score(port_nb.LabeledPoint(label, feats),
                             default_likelihood=floor) == \
            ref.log_score(ref_nb.LabeledPoint(label, feats),
                          default_likelihood=floor)
    for feats in [("free", "money", "now"), ("meeting", "agenda", "tomorrow"),
                  ("free", "agenda", "tomorrow")]:
        assert got.predict(feats) == ref.predict(feats)
    with pytest.raises(ValueError):
        port_nb.train_categorical_nb([])


# -- logistic regression ----------------------------------------------------------

@pytest.mark.parametrize("shape", [(200, 3), (500, 50)])
def test_logreg_from_the_reference_init_matches(shape):
    n, v = shape
    X, labels = spam_data(n, v, seed=7)
    if v == 3:
        labels = np.where(X[:, 0] > X[:, 1], "1.0", "0.0")
    ref = ref_logreg.train_logreg(X, list(labels), ref_logreg.LogRegParams())
    got = port_logreg.train_logreg(
        X, list(labels), port_logreg.LogRegParams(), device="cpu",
        init_W=ref_init_W(v, 2, 0))
    scale = max(1.0, float(np.abs(ref.W).max()))
    np.testing.assert_allclose(got.W, ref.W, atol=LOGREG_TOL * scale)
    np.testing.assert_allclose(got.b, ref.b, atol=LOGREG_TOL * scale)
    assert list(got.label_vocab) == list(ref.label_vocab)
    assert list(got.predict(X)) == list(ref.predict(X))


def test_logreg_seeded_init_is_deterministic():
    X, labels = spam_data(100, 6)
    p = port_logreg.LogRegParams(iterations=20, seed=5)
    a = port_logreg.train_logreg(X, labels, p, device="cpu")
    b = port_logreg.train_logreg(X, labels, p, device="cpu")
    np.testing.assert_array_equal(a.W, b.W)
    assert port_logreg.initial_W(6, 2, 5).dtype == np.float32
    np.testing.assert_array_equal(port_logreg.initial_W(6, 2, 5),
                                  port_logreg.initial_W(6, 2, 5))


# -- random forest ----------------------------------------------------------------

NODE_FIELDS = ("thresholds", "feat", "thr", "leaf")


def _forest_both(X, y, **kw):
    ref = ref_forest.train_forest(X, y, ref_forest.ForestParams(**kw))
    got = port_forest.train_forest(X, y, port_forest.ForestParams(**kw),
                                   device="cpu")
    for k in NODE_FIELDS:
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k),
                                      err_msg=k)
    assert got.max_depth == ref.max_depth
    assert list(got.classes) == list(ref.classes)
    return ref, got


@pytest.mark.parametrize("impurity", ["gini", "entropy"])
@pytest.mark.parametrize("strategy", ["auto", "all", "sqrt", "onethird"])
def test_forest_matches_reference_exactly(impurity, strategy):
    rng = np.random.default_rng(11)
    X = rng.normal(size=(500, 7)).astype(np.float32)
    y = np.where(X[:, 0] + 0.5 * X[:, 3] > 0.2, "a",
                 np.where(X[:, 1] > 0.5, "b", "c"))
    ref, got = _forest_both(X, y, impurity=impurity,
                            feature_subset_strategy=strategy, num_trees=6,
                            max_depth=4, max_bins=16, seed=2)
    Xq = rng.normal(size=(300, 7)).astype(np.float32)
    assert list(got.predict(Xq)) == list(ref.predict(Xq))
    assert list(got.predict(X)) == list(ref.predict(X))


def test_forest_num_classes_above_the_labels():
    rng = np.random.default_rng(4)
    X = rng.poisson(2.0, size=(300, 4)).astype(np.float32)
    y = np.where(X[:, 0] > X[:, 1], 1.0, 0.0)
    ref, got = _forest_both(X, y, num_classes=5, num_trees=4, max_depth=3)
    assert list(got.predict(X)) == list(ref.predict(X))
    with pytest.raises(ValueError, match="numClasses"):
        port_forest.train_forest(X, y, port_forest.ForestParams(
            num_classes=1), device="cpu")


def test_forest_xor_matches_reference():
    """XOR labels (the nonlinear case of tests/test_engines.py)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(3000, 3)).astype(np.float32)
    y = np.where((X[:, 0] > 0) ^ (X[:, 1] > 0), "a", "b")
    ref, got = _forest_both(X[:2000], y[:2000], num_trees=10, max_depth=5)
    pred = got.predict(X[2000:])
    assert list(pred) == list(ref.predict(X[2000:]))
    assert (pred == y[2000:]).mean() > 0.9


def test_forest_vote_tie_goes_to_the_lowest_class_like_reference():
    """Two one-level trees that split the same way but disagree: every
    query ties 1-1, and both packages answer the lowest class code."""
    arrays = dict(classes=np.array(["x", "y", "z"]),
                  thresholds=np.array([[0.0]], np.float32),
                  feat=np.zeros((2, 1), np.int32),
                  thr=np.zeros((2, 1), np.int32),
                  leaf=np.array([[2, 1], [1, 2]], np.int32), max_depth=1)
    X = np.array([[-1.0], [1.0], [0.0]], np.float32)
    got = port_forest.ForestModel(**arrays, device="cpu").predict(X)
    assert list(got) == list(ref_forest.ForestModel(**arrays).predict(X))
    assert list(got) == ["y", "y", "y"]


def test_forest_binning_and_bags_are_the_reference_stream():
    rng = np.random.default_rng(8)
    X = rng.normal(size=(120, 5)).astype(np.float32)
    p = port_forest.ForestParams(num_trees=3, max_depth=3, max_bins=8,
                                 seed=9, feature_subset_strategy="sqrt")
    thresholds, xq = port_forest.bin_features(X, p.max_bins)
    ref_model = ref_forest.train_forest(X, np.arange(120) % 2,
                                        ref_forest.ForestParams(
                                            num_trees=3, max_depth=3,
                                            max_bins=8, seed=9,
                                            feature_subset_strategy="sqrt"))
    np.testing.assert_array_equal(thresholds, ref_model.thresholds)
    np.testing.assert_array_equal(xq, ref_model._binize(X))
    boot, mask = port_forest.draw_bags(120, 5, p)
    assert boot.shape == (3, 120) and mask.shape == (3, 7, 5)
    assert (mask.sum(-1) >= 3).all()        # ceil(sqrt(5)) features a node


def test_forest_histogram_groups_give_the_same_counts(monkeypatch):
    """Trees taken a few at a time through the histogram: the same fit."""
    rng = np.random.default_rng(6)
    X = rng.normal(size=(200, 4)).astype(np.float32)
    y = (X[:, 0] > 0).astype(int)
    p = port_forest.ForestParams(num_trees=5, max_depth=3)
    whole = port_forest.train_forest(X, y, p, device="cpu")
    monkeypatch.setattr(port_forest, "HIST_ELEMENTS", 2 * 200 * 4)
    timings = []
    grouped = port_forest.train_forest(X, y, p, device="cpu",
                                       timings=timings)
    assert len(timings) == 3
    for k in NODE_FIELDS:
        np.testing.assert_array_equal(getattr(grouped, k), getattr(whole, k))


# -- vectorizer, Markov chain -------------------------------------------------------

def test_vectorizer_matches_reference():
    rows = [{"color": "red", "size": "L"}, {"color": "blue", "size": "L"},
            {"color": "red", "size": "S", "extra": "1"}]
    ref = ref_vec.BinaryVectorizer.fit(rows, ["color", "size"])
    got = port_vec.BinaryVectorizer.fit(rows, ["color", "size"])
    assert got.property_map == ref.property_map
    assert got.num_features == ref.num_features
    np.testing.assert_array_equal(got.to_matrix(rows), ref.to_matrix(rows))
    for row in rows + [{"color": "green"}]:
        np.testing.assert_array_equal(got.to_vector(row), ref.to_vector(row))
    assert [(list(a), list(b)) for a, b in port_vec.split_data(3, 10)] == \
        [(list(a), list(b)) for a, b in ref_vec.split_data(3, 10)]


def test_markov_chain_matches_reference():
    rng = np.random.default_rng(2)
    src = rng.integers(0, 6, 80)
    dst = rng.integers(0, 6, 80)
    cnt = rng.integers(1, 4, 80).astype(float)
    for top_n in (1, 2, 6):
        ref = ref_mc.train_markov_chain(src, dst, cnt, 6, top_n)
        got = port_mc.train_markov_chain(src, dst, cnt, 6, top_n)
        assert got.transitions == ref.transitions
        assert [got.predict(s) for s in range(7)] == \
            [ref.predict(s) for s in range(7)]


# -- device cache -------------------------------------------------------------------

def test_device_cache_keys_on_identity_and_evicts_on_gc():
    port_cache.clear()
    calls = []

    def build():
        calls.append(1)
        return torch.zeros(3)

    a = np.ones(4)
    v1 = port_cache.resident([a], ("k",), build)
    assert port_cache.resident([a], ("k",), build) is v1
    assert port_cache.is_resident([a], ("k",))
    assert not port_cache.is_resident([a.copy()], ("k",))
    assert not port_cache.is_resident([a], ("other",))
    port_cache.resident([a], ("other",), build)
    assert len(calls) == 2 and port_cache.size() == 2
    del a
    gc.collect()
    assert port_cache.size() == 0
    b = np.ones(2)
    port_cache.resident([b], ("k",), build)
    port_cache.clear()
    assert port_cache.size() == 0 and not port_cache.is_resident([b], ("k",))
    # the reference's contract, on the same calls
    ref_cache.clear()
    c = np.ones(4)
    ref_cache.resident([c], ("k",), lambda: 1)
    assert ref_cache.is_resident([c], ("k",)) and ref_cache.size() == 1
    del c
    gc.collect()
    assert ref_cache.size() == 0


# -- codecs, capacity ---------------------------------------------------------------

def _trained_models():
    rng = np.random.default_rng(3)
    X = rng.poisson(2.0, size=(150, 3)).astype(np.float32)
    y = [str(v) for v in np.where(X[:, 0] > X[:, 1], 1.0, 0.0)]
    return X, [
        port_nb.train_multinomial_nb(X, y, device="cpu"),
        port_logreg.train_logreg(X, y, port_logreg.LogRegParams(
            iterations=30), device="cpu"),
        port_forest.train_forest(X, y, port_forest.ForestParams(
            num_trees=3, max_depth=3), device="cpu")]


def test_serialization_round_trip_of_each_classifier():
    X, models = _trained_models()
    blob = serialize_models(models)
    loaded = deserialize_models(blob, device="cpu")
    for m, back in zip(models, loaded):
        assert type(back) is type(m)
        for k in ("label_vocab", "log_prior", "log_prob", "W", "b",
                  "classes", *NODE_FIELDS):
            if hasattr(m, k):
                np.testing.assert_array_equal(getattr(back, k),
                                              getattr(m, k))
                assert getattr(back, k).dtype == getattr(m, k).dtype
        assert list(back.predict(X)) == list(m.predict(X))
    assert loaded[2].max_depth == models[2].max_depth
    assert loaded[0].label_vocab.dtype == object
    # the blob is never unpickled
    assert b"pickle" not in blob and blob.startswith(b"PK")


def test_capacity_counts_the_forest_and_the_resident_x(monkeypatch):
    X, (nb, logreg, forest) = _trained_models()
    entry = model_capacity(forest)
    assert entry["residentBytes"] == 0           # nothing uploaded yet
    forest.predict(X[:4])
    entry = model_capacity(forest)
    want = (forest.thresholds.size * 4
            + (forest.feat.size + forest.thr.size + forest.leaf.size) * 8)
    assert entry["modelFactorBytes"] == entry["residentBytes"] == want
    assert entry["scorerFactorBytes"] == 0
    forest.release_device()
    assert model_capacity(forest)["residentBytes"] == 0
    assert model_capacity(logreg)["residentBytes"] == 0
    monkeypatch.setattr(port_nb, "DEVICE_MIN_SIZE", 1)
    Xd, labels = spam_data(100, 8)
    m = port_nb.train_multinomial_nb(Xd, labels, device="cpu")
    assert model_capacity(m)["residentBytes"] == Xd.size  # uint8 X
    m.predict(Xd)
    entry = model_capacity(m)
    assert entry["residentBytes"] == Xd.size + (8 * 2 + 2) * 4
    assert entry["scorerFactorBytes"] == 0


# -- the engine -----------------------------------------------------------------------

def _config(path):
    return {"sources": {"DB": {"TYPE": "sqlite", "PATH": str(path)}},
            "repositories": {r: {"NAME": "pio", "SOURCE": "DB"}
                             for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}}


def classification_rows(n_users, seed=5):
    """The ``classification_app`` law of tests/test_engines.py."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_users):
        attr0 = float(rng.integers(0, 8))
        attr1 = float(rng.integers(0, 8))
        attr2 = float(rng.integers(0, 4))
        rows.append((f"u{i}", {"plan": 1.0 if attr0 > attr1 else 0.0,
                               "attr0": attr0, "attr1": attr1,
                               "attr2": attr2}))
    return rows


@pytest.fixture()
def cls_app(tmp_path):
    """150 users of the law written by the reference into one sqlite
    file that both packages read."""
    def reset():
        RefStorage.reset()
        PortStorage.reset()
        ref_eventstore.clear_cache()
        port_eventstore.clear_cache()

    reset()
    RefStorage.configure(_config(tmp_path / "cls.db"))
    app_id = RefStorage.get_meta_data_apps().insert(RefApp(id=0, name=APP))
    store = RefStorage.get_events()
    store.init_channel(app_id)
    store.insert_batch([
        RefEvent(event="$set", entity_type="user", entity_id=uid,
                 properties=RefDataMap(props))
        for uid, props in classification_rows(150)], app_id)
    PortStorage.configure(_config(tmp_path / "cls.db"))
    yield APP
    reset()


GRID = [(float(a), float(b), float(c)) for a in range(8) for b in range(8)
        for c in (0, 3)]


def _ref_ctx(mode="Training"):
    return RefContext(mode=mode, devices=jax.devices()[:1])


def _patch_logreg_init(monkeypatch):
    monkeypatch.setattr(port_logreg, "initial_W", ref_init_W)


@pytest.mark.parametrize("algo", ALGOS)
def test_engine_answers_like_reference(cls_app, monkeypatch, algo):
    _patch_logreg_init(monkeypatch)
    ref_engine, port_engine = ref_cls.engine(), port_cls.engine()
    ref_result = ref_engine.train(
        _ref_ctx(), ref_cls.default_engine_params(cls_app, algorithm=algo))
    result = port_engine.train(
        types.SimpleNamespace(device="cpu"),
        port_cls.default_engine_params(cls_app, algorithm=algo))
    ref_algo, ref_m = ref_result.algorithms[0], ref_result.models[0]
    algo_obj, m = result.algorithms[0], result.models[0]
    if algo == "randomforest":
        for k in NODE_FIELDS:
            np.testing.assert_array_equal(getattr(m, k), getattr(ref_m, k))
    else:
        assert list(m.label_vocab) == list(ref_m.label_vocab)
    queries = [(i, port_cls.Query(*q)) for i, q in enumerate(GRID)]
    want = [ref_algo.predict(ref_m, ref_cls.Query(*q)).label for q in GRID]
    assert [algo_obj.predict(m, q).label for _, q in queries] == want
    assert [p.label for _, p in sorted(algo_obj.batch_predict(m, queries))] \
        == want
    assert algo_obj.warmup_query(m) == port_cls.Query(0.0, 0.0, 0.0)
    assert algo_obj.warmup_query(None) is None


def test_read_eval_folds_match_reference(cls_app):
    ref_ds = ref_cls.ClassificationDataSource(
        ref_cls.DataSourceParams(app_name=cls_app, eval_k=3))
    ds = port_cls.ClassificationDataSource(
        port_cls.DataSourceParams(app_name=cls_app, eval_k=3))
    ref_folds, folds = ref_ds.read_eval(None), ds.read_eval(None)
    assert len(folds) == len(ref_folds) == 3
    for (td, info, qa), (rtd, rinfo, rqa) in zip(folds, ref_folds):
        assert info is rinfo is None
        assert [dataclasses.astuple(p) for p in td.points] == \
            [dataclasses.astuple(p) for p in rtd.points]
        assert [(dataclasses.astuple(q), a.label) for q, a in qa] == \
            [(dataclasses.astuple(q), a.label) for q, a in rqa]
    for mod in (ref_cls, port_cls):
        with pytest.raises(ValueError, match="eval_k"):
            mod.ClassificationDataSource(
                mod.DataSourceParams(app_name=cls_app)).read_eval(None)


def test_eval_accuracy_matches_reference(cls_app, monkeypatch):
    _patch_logreg_init(monkeypatch)

    def params(mod, ep_cls):
        ds = mod.DataSourceParams(app_name=cls_app, eval_k=3)
        return [ep_cls(data_source_params=ds, algorithm_params_list=[
            (a, mod.default_engine_params(cls_app, a)
             .algorithm_params_list[0][1])]) for a in ALGOS]

    ref = ref_run_evaluation(
        RefEvaluation(engine=ref_cls.engine(), metric=ref_cls.Accuracy(),
                      output_path=None),
        params(ref_cls, RefEngineParams), ctx=_ref_ctx("Evaluation"))
    got = run_evaluation(
        Evaluation(engine=port_cls.engine(), metric=port_cls.Accuracy(),
                   output_path=None),
        params(port_cls, EngineParams), device="cpu")
    assert [s for _, s, _ in got.engine_params_scores] == \
        [s for _, s, _ in ref.engine_params_scores]
    assert got.best_idx == ref.best_idx
    assert got.engine_params_scores[1][1] > 0.85     # logreg fits the rule


def test_foldin_stays_off_for_classification_like_reference(cls_app):
    ref_engine, port_engine = ref_cls.engine(), port_cls.engine()
    ref_result = ref_engine.train(
        _ref_ctx(), ref_cls.default_engine_params(cls_app))
    result = port_engine.train(types.SimpleNamespace(device="cpu"),
                               port_cls.default_engine_params(cls_app))
    assert resolve_foldin(result) is None
    assert ref_resolve_foldin(ref_result) is None
    server = create_query_server(
        port_engine, result, EngineInstance(id="cls-foldin"),
        foldin_config=FoldinConfig(enabled=True))
    server.warm()
    server._start_foldin()
    assert server.foldin_status() == {"enabled": False}
    q = port_cls.Query(7.0, 0.0, 1.0)
    assert server._predict_unit(server._unit, q).label == 1.0


# -- the CLI on the CPU ----------------------------------------------------------------

_EVAL_MODULE = """
from predictionio_tpu_torch.core.evaluation import Evaluation
from predictionio_tpu_torch.core.params import EngineParams
from predictionio_tpu_torch.engines.classification import (
    Accuracy, DataSourceParams, default_engine_params, engine)
evaluation = Evaluation(engine=engine(), metric=Accuracy(), output_path=BEST)
evaluation.engine_params_list = [EngineParams(
    data_source_params=DataSourceParams(app_name=APP, eval_k=3),
    algorithm_params_list=default_engine_params(APP, a).algorithm_params_list)
    for a in ("naive", "logreg", "randomforest")]
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, body, timeout_s=120):
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            c.request("POST", "/queries.json", body=json.dumps(body))
            r = c.getresponse()
            return r.status, json.loads(r.read())
        except (ConnectionRefusedError, ConnectionResetError):
            assert time.monotonic() < deadline, "the deploy never listened"
            time.sleep(0.1)


def test_cli_template_train_deploy_eval_on_cpu(tmp_path):
    """``template get classification`` -> ``train`` -> ``deploy`` ->
    ``POST /queries.json`` -> ``eval`` through ``python -m
    predictionio_tpu_torch.cli.main``, each algorithm, the engine.json
    naming the reference's factory string: every answer is the label the
    stored model predicts, and eval's Accuracy is the in-process one."""
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}",
               PIO_HOME=str(tmp_path / "home"), **{
        "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "cli.db"),
        **{f"PIO_STORAGE_REPOSITORIES_{r}_{k}": v
           for r in ("METADATA", "EVENTDATA", "MODELDATA")
           for k, v in (("NAME", "pio"), ("SOURCE", "DB"))}})
    cli = [sys.executable, "-m", "predictionio_tpu_torch.cli.main"]

    def run(*args):
        out = subprocess.run([*cli, *args], cwd=str(tmp_path), env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
        return out.stdout.strip().splitlines()

    PortStorage.reset()
    port_eventstore.clear_cache()
    PortStorage.configure(_config(tmp_path / "cli.db"))
    try:
        from predictionio_tpu_torch.data.event import Event
        from predictionio_tpu_torch.storage.base import App

        app_id = PortStorage.get_meta_data_apps().insert(App(id=0, name=APP))
        PortStorage.get_events().init_channel(app_id)
        PortStorage.get_events().insert_batch([
            Event(event="$set", entity_type="user", entity_id=uid,
                  properties=props)
            for uid, props in classification_rows(150)], app_id)
        assert run("template", "get", "classification", "tpl")[-1] == \
            "[INFO] Engine template classification written to " \
            + os.path.join("tpl", "engine.json")
        template = json.loads((tmp_path / "tpl" / "engine.json").read_text())
        assert template["algorithms"] == [{"name": "naive",
                                           "params": {"reg": 1.0}}]
        variants = {}
        for algo in ALGOS:
            v = dict(template, id=algo,
                     engineFactory="predictionio_tpu.engines."
                                   "classification:engine",
                     datasource={"params": {"appName": APP}},
                     algorithms=[{"name": algo, "params": {}}])
            variants[algo] = tmp_path / f"{algo}.json"
            variants[algo].write_text(json.dumps(v))
        trains = {a: subprocess.Popen(
            [*cli, "train", "--variant", str(p), "--device", "cpu"],
            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for a, p in variants.items()}
        lines = {}
        for a, proc in trains.items():
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, out[-2000:] + err[-3000:]
            lines[a] = json.loads(out.strip().splitlines()[-1])
        assert lines["naive"]["labels"] == 2
        assert lines["naive"]["features"] == 3
        assert lines["randomforest"]["trees"] == 10
        assert lines["logreg"]["users"] is None

        ports = {a: _free_port() for a in ALGOS}
        deploys = {a: subprocess.Popen(
            [*cli, "deploy", "--variant", str(variants[a]), "--port",
             str(ports[a]), "--device", "cpu"], cwd=str(tmp_path),
            env=dict(env, PIO_HOME=str(tmp_path / f"home-{a}")),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
            for a in ALGOS}
        try:
            rng = np.random.default_rng(1)
            queries = [{"attr0": float(a), "attr1": float(b),
                        "attr2": float(c)} for a, b, c in
                       rng.integers(0, 8, size=(12, 3))]
            for a in ALGOS:
                model = deserialize_models(
                    PortStorage.get_model_data_models().get(
                        lines[a]["instance"]).models, device="cpu")[0]
                for q in queries:
                    status, body = _post(ports[a], q)
                    assert status == 200, body
                    want = float(model.predict(np.asarray(
                        [[q["attr0"], q["attr1"], q["attr2"]]],
                        np.float32))[0])
                    assert body == {"label": want}, (a, q, body)
        finally:
            for p in deploys.values():
                p.terminate()
            for p in deploys.values():
                p.communicate(timeout=60)

        (tmp_path / "cls_eval.py").write_text(
            f"APP = {APP!r}\nBEST = {str(tmp_path / 'best.json')!r}\n"
            + _EVAL_MODULE)
        got = json.loads(run("eval", "cls_eval:evaluation", "--device",
                             "cpu")[-1])
        sys.path.insert(0, str(tmp_path))
        try:
            import cls_eval

            want = run_evaluation(cls_eval.evaluation,
                                  cls_eval.evaluation.engine_params_list,
                                  device="cpu")
        finally:
            sys.path.remove(str(tmp_path))
            sys.modules.pop("cls_eval", None)
        assert [s for s, _ in got["scores"]] == \
            [s for _, s, _ in want.engine_params_scores]
        assert got["mode"] == "sequential"
        assert (tmp_path / "best.json").exists()
    finally:
        PortStorage.reset()
        port_eventstore.clear_cache()
