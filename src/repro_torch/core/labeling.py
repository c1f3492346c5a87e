"""Weak supervision: 10 programmatic labeling functions + majority vote
(port of ``repro.core.labeling``, paper §III.B.2).

Spike detection (kurtosis > 10, max-to-median ratio > 20), periodicity
(spectral entropy < 0.5, autocorrelation > 0.6), ramp patterns (strong
linear trends), stationary-noisy patterns. LF outputs are aggregated by
majority vote; the agreement level is the confidence score.

Each LF maps a feature row [..., 38] to a class id in {0..3} or ABSTAIN
(-1). Everything is comparisons (PyTorch, like JAX, rounds a Python
threshold to f32 before comparing an f32 tensor with it), integer counts
and one IEEE division of small integers, so votes, labels and confidence
equal the reference's bit for bit on equal features, on any device.
"""
from __future__ import annotations

import torch

from repro_torch.core.archetypes import N_CLASSES, Archetype
from repro_torch.core.features import FEATURE_NAMES

ABSTAIN = -1
_F = {name: i for i, name in enumerate(FEATURE_NAMES)}
# tie-break priority: SPIKE(1) > RAMP(3) > PERIODIC(0) > STATIONARY(2),
# the reference's f32 epsilons (0.2, 0.3, 0.0, 0.25) * 1e-3
_PRIORITY = (0.2, 0.3, 0.0, 0.25)


def _col(feats, name):
    return feats[..., _F[name]]


def _lf(condition, label):
    return torch.where(condition, int(label), ABSTAIN)


def lf_spike_kurtosis(f):
    return _lf(_col(f, "kurtosis") > 10.0, Archetype.SPIKE)


def lf_spike_max_median(f):
    return _lf(_col(f, "max_to_median") > 20.0, Archetype.SPIKE)


def lf_spike_zero_burst(f):
    cond = (_col(f, "zero_fraction") > 0.5) & (_col(f, "max_to_mean") > 10.0)
    return _lf(cond, Archetype.SPIKE)


def lf_periodic_spectral(f):
    # trend guard: a linear ramp concentrates low-frequency power too
    cond = ((_col(f, "spectral_entropy") < 0.5)
            & (_col(f, "dominant_power_ratio") > 0.3)
            & (_col(f, "trend_r2") < 0.6))
    return _lf(cond, Archetype.PERIODIC)


def lf_periodic_autocorr(f):
    # trend guard: trending series have acf ~ 1 at every lag
    cond = ((_col(f, "acf_max") > 0.6) & (_col(f, "max_to_median") < 20.0)
            & (_col(f, "trend_r2") < 0.5))
    return _lf(cond, Archetype.PERIODIC)


def lf_periodic_peaks(f):
    cond = ((_col(f, "n_peaks") >= 2.0 / 60.0)
            & (_col(f, "acf_max") > 0.5)
            & (_col(f, "kurtosis") < 10.0)
            & (_col(f, "trend_r2") < 0.5))
    return _lf(cond, Archetype.PERIODIC)


def lf_ramp_trend(f):
    cond = (_col(f, "trend_r2") > 0.75) & (
        _col(f, "trend_slope").abs() > 0.02)
    return _lf(cond, Archetype.RAMP)


def lf_ramp_halves(f):
    hr = _col(f, "half_ratio")
    cond = ((hr > 1.6) | (hr < 0.6)) & (_col(f, "trend_r2") > 0.5)
    return _lf(cond, Archetype.RAMP)


def lf_stationary_low_var(f):
    cond = ((_col(f, "cv") < 0.35)
            & (_col(f, "trend_slope").abs() < 0.01)
            & (_col(f, "acf_max") < 0.6))
    return _lf(cond, Archetype.STATIONARY_NOISY)


def lf_stationary_no_structure(f):
    cond = ((_col(f, "spectral_entropy") > 0.85)
            & (_col(f, "kurtosis") < 3.0)
            & (_col(f, "max_to_median") < 5.0)
            & (_col(f, "trend_r2") < 0.5))
    return _lf(cond, Archetype.STATIONARY_NOISY)


LABELING_FUNCTIONS = [
    lf_spike_kurtosis, lf_spike_max_median, lf_spike_zero_burst,
    lf_periodic_spectral, lf_periodic_autocorr, lf_periodic_peaks,
    lf_ramp_trend, lf_ramp_halves,
    lf_stationary_low_var, lf_stationary_no_structure,
]
N_LFS = len(LABELING_FUNCTIONS)  # 10


def apply_lfs(features: torch.Tensor) -> torch.Tensor:
    """Run all LFs. features [..., 38] -> votes [..., N_LFS] int32 in
    {-1, 0..3}."""
    return torch.stack([lf(features).to(torch.int32)
                        for lf in LABELING_FUNCTIONS], -1)


def majority_vote(votes: torch.Tensor):
    """Aggregate LF votes (majority vote, agreement = confidence).

    Returns (labels [...] int32, confidence [...] f32, n_votes [...]
    f32). labels = -1 where every LF abstained. Ties break toward the
    rarer/riskier class (SPIKE > RAMP > PERIODIC > STATIONARY) by adding
    a tiny f32 class-priority epsilon before the argmax.
    """
    counts = torch.stack([(votes == k).sum(-1, dtype=torch.int32)
                          for k in range(N_CLASSES)], -1).to(torch.float32)
    n_votes = counts.sum(-1)          # small integers: exact in any order
    prio = (torch.tensor(_PRIORITY, dtype=torch.float32)
            * torch.tensor(1e-3, dtype=torch.float32)).to(votes.device)
    labels = torch.argmax(counts + prio, -1).to(torch.int32)
    labels = torch.where(n_votes > 0, labels, ABSTAIN)
    confidence = counts.amax(-1) / n_votes.clamp_min(1.0)
    confidence = torch.where(n_votes > 0, confidence, 0.0)
    return labels, confidence, n_votes


def weak_label(features: torch.Tensor):
    """features [..., 38] -> (labels, confidence, n_votes)."""
    return majority_vote(apply_lfs(features))
