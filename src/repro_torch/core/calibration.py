"""Beta calibration (Kull, Silva Filho & Flach, AISTATS 2017), inference
only (port of ``repro.core.calibration``; fitting stays in the
reference).

The beta calibration map is q = sigmoid(a·ln p − b·ln(1−p) + c) with
a, b >= 0, one-vs-rest per class, renormalized across classes at
prediction time. Confidence = max_k q_k. exp, log and log1p are
correctly rounded (``_numerics``), so the AAPA episode kernel, which
evaluates the same map per lane, agrees with this module bit for bit.
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


def from_arrays(a_raw, b_raw, c, device="cuda") -> BetaCalibration:
    dev = _device.resolve(device)
    return BetaCalibration(*(torch.as_tensor(np.array(v)).to(
        device=dev, dtype=torch.float32) for v in (a_raw, b_raw, c)))
