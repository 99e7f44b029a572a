"""The port's entry module against the repository root's
``__graft_entry__``: the same example arguments, and the same top-10 of
the ALS forward step on them, with the seen mask empty and not."""

import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from predictionio_tpu_torch.entry import dryrun_multichip, entry

#: the forward step is one f32 matvec of rank 64 and a top-k
SCORE_TOL = 1e-5


@pytest.fixture(scope="module")
def both():
    ref_fn, ref_args = ref_entry.entry()
    fn, args = entry("cpu")
    return ref_fn, ref_args, fn, args


def test_example_args_are_the_reference_s(both):
    _, ref_args, _, args = both
    assert len(args) == len(ref_args) == 3
    for ours, theirs in zip(args, ref_args):
        theirs = np.asarray(theirs)
        assert ours.device.type == "cpu"
        assert ours.numpy().dtype == theirs.dtype
        np.testing.assert_array_equal(ours.numpy(), theirs)


def _seen_mask(case: str, n_items: int, top_ids) -> np.ndarray:
    rng = np.random.default_rng(7)
    if case == "empty":
        return np.zeros(n_items, bool)
    mask = rng.random(n_items) < 0.3
    # the unmasked top 10 are seen: every one of them goes to -inf
    mask[np.asarray(top_ids)] = True
    return mask


@pytest.mark.parametrize("case", ["empty", "top_and_random_seen"])
def test_top10_is_the_reference_s(both, case):
    import jax.numpy as jnp

    ref_fn, ref_args, fn, args = both
    n_items = args[1].shape[0]
    _, top_ids = ref_fn(*ref_args)
    mask = _seen_mask(case, n_items, top_ids)
    ref_scores, ref_ids = ref_fn(ref_args[0], ref_args[1],
                                 jnp.asarray(mask))
    scores, ids = fn(args[0], args[1], torch.as_tensor(mask))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores),
                               rtol=0, atol=SCORE_TOL)
    assert not mask[ids.numpy()].any()
    if case != "empty":
        # the masking moved the answer
        assert not np.isin(ids.numpy(), np.asarray(top_ids)).any()


def test_seen_items_past_the_catalogue_come_back_minus_inf(both):
    """All but 4 items seen: the 4 unseen lead with the reference's ids
    and scores, the other 6 slots are -inf in both."""
    import jax.numpy as jnp

    ref_fn, ref_args, fn, args = both
    n_items = args[1].shape[0]
    mask = np.ones(n_items, bool)
    unseen = np.array([3, 500, 1000, 1681])
    mask[unseen] = False
    ref_scores, ref_ids = ref_fn(ref_args[0], ref_args[1],
                                 jnp.asarray(mask))
    scores, ids = fn(args[0], args[1], torch.as_tensor(mask))
    ref_scores, ref_ids = np.asarray(ref_scores), np.asarray(ref_ids)
    np.testing.assert_array_equal(ids.numpy()[:4], ref_ids[:4])
    assert set(ids.numpy()[:4]) == set(unseen)
    np.testing.assert_allclose(scores.numpy()[:4], ref_scores[:4],
                               rtol=0, atol=SCORE_TOL)
    assert np.isneginf(scores.numpy()[4:]).all()
    assert np.isneginf(ref_scores[4:]).all()


def test_dryrun_multichip_over_two_cpu_positions():
    report = dryrun_multichip(2, "cpu")
    assert report["positions"] == 2 and report["device"] == "cpu"
    assert report["als"] == {"U": [64, 8], "V": [48, 8]}
    assert report["seqrec"] == {"mesh": {"data": 1, "model": 2},
                                "recs": 3}
