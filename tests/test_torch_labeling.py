"""The port's labeling functions and majority vote
(``repro_torch.core.labeling``) against the JAX reference on the CPU.

Both packages label the same features: the reference's own features of
seeded windows, and crafted rows at each threshold. Votes, labels,
confidence and vote counts must be equal bit for bit (they are
comparisons, integer counts and one IEEE division), ties included: one
crafted vote row for every tie pattern between two, three and four
classes, and the all-abstain row.
"""
import _torch_threads  # noqa: F401  (one torch thread)
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as ref_features
from repro.core import labeling as ref_labeling
from repro.data import azure_synth as ref_synth
from repro.data import windows as ref_windows
from repro_torch.core import labeling


def _both(feats: np.ndarray):
    """(reference (votes, labels, conf, n), port's) on the same rows."""
    r_votes = ref_labeling.apply_lfs(jnp.asarray(feats))
    r = (r_votes, *ref_labeling.majority_vote(r_votes))
    t_votes = labeling.apply_lfs(torch.tensor(feats))
    t = (t_votes, *labeling.majority_vote(t_votes))
    return [np.asarray(a) for a in r], [a.numpy() for a in t]


def _assert_same(ref, port):
    for name, a, b in zip(("votes", "labels", "confidence", "n_votes"),
                          ref, port):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=name)


def test_lf_names_and_order_match_reference():
    assert [f.__name__ for f in labeling.LABELING_FUNCTIONS] == \
        [f.__name__ for f in ref_labeling.LABELING_FUNCTIONS]
    assert labeling.N_LFS == ref_labeling.N_LFS
    assert labeling.ABSTAIN == ref_labeling.ABSTAIN


@pytest.mark.parametrize("seed,family", [(0, "default"), (1, "spike_heavy"),
                                         (2, "regime_switch")])
def test_labels_of_reference_features_bit_for_bit(seed, family):
    """The reference's features of seeded windows through both packages'
    apply_lfs and majority_vote."""
    traces = ref_synth.generate_traces(n_functions=12, n_days=2, seed=seed,
                                       family=family)
    wins = ref_windows.make_windows(traces).windows
    feats = np.asarray(ref_features.extract_features(jnp.asarray(wins)))
    ref, port = _both(feats)
    _assert_same(ref, port)
    assert len(np.unique(port[1])) >= 2        # more than one label seen


def test_thresholds_compare_in_f32():
    """Rows sitting exactly on, and one f32 ulp either side of, every LF
    threshold (a Python threshold is rounded to f32 in both packages)."""
    rng = np.random.default_rng(3)
    base = rng.uniform(0.0, 1.0, (1, 38)).astype(np.float32)
    names = labeling._F
    thresholds = {"kurtosis": (10.0, 3.0), "max_to_median": (20.0, 5.0),
                  "zero_fraction": (0.5,), "max_to_mean": (10.0,),
                  "spectral_entropy": (0.5, 0.85),
                  "dominant_power_ratio": (0.3,),
                  "trend_r2": (0.6, 0.5, 0.75), "acf_max": (0.6, 0.5),
                  "n_peaks": (2.0 / 60.0,), "trend_slope": (0.02, 0.01,
                                                            -0.02, -0.01),
                  "half_ratio": (1.6, 0.6), "cv": (0.35,)}
    rows = []
    for name, ts in thresholds.items():
        for t in ts:
            t32 = np.float32(t)
            for v in (np.nextafter(t32, np.float32(-np.inf)), t32,
                      np.nextafter(t32, np.float32(np.inf))):
                row = np.tile(base, (1, 1))
                row[0, names[name]] = v
                rows.append(row)
    feats = np.concatenate(rows)
    ref, port = _both(feats)
    _assert_same(ref, port)


def _tie_rows():
    """One vote row per tie pattern: every subset of >= 2 classes tied
    at one, two and (for pairs) three votes each; and no votes at all."""
    rows = []
    for size in (2, 3, 4):
        for classes in itertools.combinations(range(4), size):
            for count in (1, 2) if size > 2 else (1, 2, 3):
                votes = [k for k in classes for _ in range(count)]
                votes += [-1] * (10 - len(votes))
                rows.append(votes)
    rows.append([-1] * 10)
    rows.append([1, -1, 3, -1, 0, -1, 2, -1, -1, -1])    # spread
    return np.asarray(rows, np.int32)


def test_majority_vote_ties_bit_for_bit():
    votes = _tie_rows()
    r = [np.asarray(a) for a in ref_labeling.majority_vote(
        jnp.asarray(votes))]
    t = [a.numpy() for a in labeling.majority_vote(torch.as_tensor(votes))]
    _assert_same([votes, *r], [votes, *t])
    # the priority order decides every tie: SPIKE > RAMP > PERIODIC >
    # STATIONARY, and the all-abstain row is ABSTAIN at confidence 0
    order = [1, 3, 0, 2]
    for row, label in zip(votes[:-2], t[0][:-2]):
        tied = sorted(set(row[row >= 0]), key=order.index)
        assert label == tied[0]
    assert t[0][-2] == -1 and t[1][-2] == 0.0


def test_weak_label_is_apply_then_vote():
    rng = np.random.default_rng(5)
    feats = torch.as_tensor(rng.normal(2.0, 8.0, (64, 38)).astype(
        np.float32))
    labels, conf, n = labeling.weak_label(feats)
    want = labeling.majority_vote(labeling.apply_lfs(feats))
    for a, b in zip((labels, conf, n), want):
        assert torch.equal(a, b)
