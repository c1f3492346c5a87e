"""Split-conformal prediction intervals from one-step backtest residuals
(port of ``repro.forecast.conformal``).

`calibrate` runs the forecaster's offline backtest (`forecaster.smooth`,
for Holt-Winters the ``holt_winters`` kernel on the card) over a
calibration split and takes the ceil((n+1)*alpha)-th smallest absolute
residual as the interval half-width; under exchangeable residuals the
interval covers the next observation with probability >= alpha. `wrap`
gives a forecaster whose intervals carry that band, and `confidence` maps
the band's width relative to the trace scale into the c in [0, 1] that
Algorithm 1 consumes.

Entry points run on the card unless `device` says otherwise; the band's
tensors live on the device the calibration ran on.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import _device
from repro_torch.forecast.api import EPSF, Forecaster, FState, Interval

DEFAULT_BURN_IN = 60     # skip the warm-up transient of the backtest


class ConformalBand(NamedTuple):
    q: torch.Tensor      # f32 residual quantile = interval half-width
    alpha: float         # nominal coverage level
    scale: torch.Tensor  # f32 mean |y| of the calibration split


def _series(y, device) -> torch.Tensor:
    return torch.as_tensor(y).to(device=_device.resolve(device),
                                 dtype=torch.float32)


def _residuals(forecaster: Forecaster, y: torch.Tensor,
               burn_in: int) -> torch.Tensor:
    y2 = y[None] if y.dim() == 1 else y
    return (y2 - forecaster.smooth(y2)).abs()[:, burn_in:].reshape(-1)


def calibrate(forecaster: Forecaster, y_calib, *, alpha: float = 0.9,
              burn_in: int = DEFAULT_BURN_IN,
              device="cuda") -> ConformalBand:
    """Fit a band on a calibration split, y_calib [T] or [B, T].

    The order statistic is exact (a sort, as the reference's); `scale`,
    the mean |y| over the whole split, is accumulated in f64 and rounded
    once, within an ulp or so of the reference's f32 sum in XLA's 2-D
    reduction order, which the port does not reproduce."""
    y = _series(y_calib, device)
    resid = _residuals(forecaster, y, burn_in)
    n = resid.numel()
    if n < 1:
        raise ValueError("calibration split shorter than burn_in")
    # split-conformal rank: the ceil((n+1)*alpha)-th order statistic
    k = min(int(math.ceil((n + 1) * alpha)), n)
    # a copy, not a view that would keep every sorted residual alive
    q = torch.sort(resid).values[k - 1].clone()
    scale = y.abs().sum(dtype=torch.float64).div(y.numel()).to(
        torch.float32)
    return ConformalBand(q=q, alpha=float(alpha), scale=scale)


def coverage(forecaster: Forecaster, band: ConformalBand, y_test, *,
             burn_in: int = DEFAULT_BURN_IN, device="cuda") -> float:
    """Empirical rate at which |y - pred| <= q on a held-out split."""
    resid = _residuals(forecaster, _series(y_test, device), burn_in)
    return float((resid <= band.q.to(resid.device)).sum()) / resid.numel()


def wrap(forecaster: Forecaster, band: ConformalBand, *,
         widen_with_horizon: bool = True) -> Forecaster:
    """Forecaster whose intervals carry the conformal band instead of the
    native residual-EWMA one; the band is calibrated at horizon 1 and
    widens by sqrt(h) unless disabled. Its `hyper` names the wrapped
    forecaster (`inner`), the band and `widen_with_horizon`: the episode
    kernel takes the interval's half-width from there."""
    def forecast(state: FState, horizon: int) -> Interval:
        point = forecaster.forecast(state, horizon).point
        half = band.q * (float(np.sqrt(np.float32(horizon)))
                         if widen_with_horizon else 1.0)
        return Interval(point=point, lo=(point - half).clamp_min(0.0),
                        hi=point + half)

    return Forecaster(f"conformal[{forecaster.name}]", forecaster.init,
                      forecaster.update, forecast, forecaster.smooth,
                      dict(forecaster.hyper, inner=forecaster, band=band,
                           widen_with_horizon=widen_with_horizon))


def confidence(band: ConformalBand) -> torch.Tensor:
    """Scalar confidence of a calibrated band: 1 for a zero-width band,
    decreasing in the band's width relative to the trace scale."""
    width = 2.0 * band.q
    return band.scale / (band.scale + width).clamp_min(EPSF)
