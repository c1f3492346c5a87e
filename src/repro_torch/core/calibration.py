"""Beta calibration (Kull, Silva Filho & Flach, AISTATS 2017) in PyTorch
(port of ``repro.core.calibration``).

The beta calibration map is q = sigmoid(a·ln p − b·ln(1−p) + c) with
a, b >= 0, one-vs-rest per class, renormalized across classes at
prediction time. Confidence = max_k q_k. exp, log and log1p are
correctly rounded (``_numerics``), so the AAPA episode kernel, which
evaluates the same map per lane, agrees with this module bit for bit.

`fit` maximizes each class's Bernoulli log-likelihood on a held-out set
with 400 full-batch Adam steps, all K classes at once: the gradient
comes from ``torch.autograd`` and the Adam update is the reference's,
written out (``torch.optim.Adam`` puts eps and the bias corrections in
another form). The reference's gradient sums its rows in XLA's order
and XLA contracts Adam's moment updates into fused multiply-adds, so a
fit agrees with the reference's to float noise that Adam's division by
sqrt(v) amplifies near the optimum; it reaches the same likelihood.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import _device
from repro_torch import _numerics as N

EPS = 1e-6


@dataclasses.dataclass
class BetaCalibration:
    """Per-class beta-calibration parameters. a,b stored as softplus
    pre-images."""

    a_raw: torch.Tensor  # [K]
    b_raw: torch.Tensor  # [K]
    c: torch.Tensor      # [K]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): max(x, 0) +
    log1p(exp(-|x|))."""
    return x.clamp_min(0.0) + N.rounded(
        torch.log1p, N.rounded(torch.exp, -x.abs()))


def coefficients(cal: BetaCalibration):
    """(a, b, c) of the map: softplus of the stored pre-images."""
    return softplus(cal.a_raw), softplus(cal.b_raw), cal.c


def _beta_map(a, b, c, p):
    p = p.clamp(EPS, 1.0 - EPS)
    z = a * N.rounded(torch.log, p) - b * N.rounded(torch.log1p, -p) + c
    one = _device.const(1.0, p.device)
    return one / (1.0 + N.rounded(torch.exp, -z))


def calibrate(cal: BetaCalibration, probs: torch.Tensor) -> torch.Tensor:
    """probs [..., K] -> calibrated + renormalized probs [..., K]."""
    q = _beta_map(*coefficients(cal), probs)
    return q / (N.seq_sum(q, 0, q.shape[-1]) + EPS)[..., None]


def confidence(cal: BetaCalibration, probs: torch.Tensor) -> torch.Tensor:
    """Calibrated confidence c in [0,1] = max_k calibrated prob."""
    return calibrate(cal, probs).amax(-1)


def _nll(params, p, y_bin):
    """Per-class mean Bernoulli NLL [K] of the maps `params` ((a_raw,
    b_raw, c), each [K]) on probabilities p [N, K] and 0/1 targets y_bin
    [N, K]."""
    a_raw, b_raw, c = params
    q = _beta_map(softplus(a_raw), softplus(b_raw), c, p)
    q = q.clamp(EPS, 1.0 - EPS)
    ll = (y_bin * N.rounded(torch.log, q)
          + (1.0 - y_bin) * N.rounded(torch.log1p, -q))
    return -(ll.sum(0) * N.recip(p.shape[0]))


def _fit_class(p, y_bin, steps: int = 400, lr: float = 0.1):
    """Full-batch Adam on (a_raw, b_raw, c), one map per column of p
    [N, K] and y_bin [N, K], all columns at once (their losses are
    independent, so the summed loss's gradient is each column's own)."""
    K = p.shape[1]
    params = [torch.full((K,), v, dtype=torch.float32, device=p.device)
              for v in (0.55, 0.55, 0.0)]             # a = b ~ 1, c = 0
    m = [torch.zeros_like(q) for q in params]
    v = [torch.zeros_like(q) for q in params]
    b1, b2, eps = 0.9, 0.999, 1e-8
    b1_t = torch.tensor(b1, dtype=torch.float32, device=p.device)
    b2_t = torch.tensor(b2, dtype=torch.float32, device=p.device)
    for i in range(steps):
        live = [q.requires_grad_() for q in params]
        grads = torch.autograd.grad(_nll(live, p, y_bin).sum(), live)
        t = torch.tensor(i + 1.0, dtype=torch.float32, device=p.device)
        c1 = 1 - N.rounded(torch.pow, b1_t, t)
        c2 = 1 - N.rounded(torch.pow, b2_t, t)
        with torch.no_grad():
            m = [b1 * a + (1 - b1) * g for a, g in zip(m, grads)]
            v = [b2 * a + (1 - b2) * g * g for a, g in zip(v, grads)]
            params = [q - lr * (mm / c1) / (N.sqrt(vv / c2) + eps)
                      for q, mm, vv in zip(params, m, v)]
    return params


def fit(probs, labels, device="cuda") -> BetaCalibration:
    """Fit one-vs-rest beta calibration on `device`. probs [N, K] (array
    or tensor), labels [N] int."""
    dev = _device.resolve(device)
    probs = torch.as_tensor(probs).to(device=dev, dtype=torch.float32)
    labels = np.asarray(labels)
    y_bin = np.stack([labels == k for k in range(probs.shape[1])], 1)
    a_raw, b_raw, c = _fit_class(
        probs, torch.as_tensor(y_bin.astype(np.float32), device=dev))
    return BetaCalibration(a_raw, b_raw, c)


def expected_calibration_error(probs: np.ndarray, labels: np.ndarray,
                               n_bins: int = 15) -> float:
    """Standard ECE on max-prob confidence (NumPy, as the reference)."""
    probs = np.asarray(probs)
    labels = np.asarray(labels)
    conf = probs.max(axis=1)
    pred = probs.argmax(axis=1)
    correct = (pred == labels).astype(np.float64)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    ece = 0.0
    for i in range(n_bins):
        m = (conf > edges[i]) & (conf <= edges[i + 1])
        if m.sum() == 0:
            continue
        ece += m.mean() * abs(correct[m].mean() - conf[m].mean())
    return float(ece)


def from_arrays(a_raw, b_raw, c, device="cuda") -> BetaCalibration:
    dev = _device.resolve(device)
    return BetaCalibration(*(torch.as_tensor(np.array(v)).to(
        device=dev, dtype=torch.float32) for v in (a_raw, b_raw, c)))
