"""Holt-Winters (triple exponential smoothing) and linear-trend
forecasts (port of ``repro.core.forecasting``).

``hw_step`` is the online update AAPA's PERIODIC strategy and the
episode kernel run once a minute; state tensors carry any leading lane
shape. ``hw_smooth`` is the offline one-step backtest over whole series,
the plain version of the ``holt_winters`` CUDA kernel
(``kernels/csrc/holt_winters.cu``).

The reference's ``hw_smooth`` takes alpha, beta and gamma as f32 scalars
at run time, so its ``1 - alpha`` is an f32 subtraction; ``hw_step``
inside an episode gets Python floats, so its ``1 - alpha`` is rounded to
f32 from a double. The two agree for the paper's 0.1, 0.01 and 0.3 but
not for every value (0.37: f32(1) - f32(0.37) != f32(0.63)), and each
port function follows its own reference.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import _device
from repro_torch._numerics import recip, xla_sum
from repro_torch.core.features import trend_constants


class HWState(NamedTuple):
    level: torch.Tensor    # [...]
    trend: torch.Tensor    # [...]
    season: torch.Tensor   # [..., period]
    t: torch.Tensor        # [...] int32, current phase


def hw_init(period: int, y0: float = 0.0, *, lanes: tuple[int, ...] = (),
            device="cuda") -> HWState:
    dev = _device.resolve(device)
    full = lambda v, dt=torch.float32: torch.full(  # noqa: E731
        lanes, v, dtype=dt, device=dev)
    return HWState(level=full(float(y0)), trend=full(0.0),
                   season=torch.zeros(lanes + (period,), dtype=torch.float32,
                                      device=dev),
                   t=full(0, torch.int32))


def _at(season: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    return torch.gather(season, -1, phase.long()[..., None])[..., 0]


def hw_step(state: HWState, y: torch.Tensor, *, alpha=0.1, beta=0.01,
            gamma=0.3) -> HWState:
    """Additive-seasonal Holt-Winters online update with observation y."""
    period = state.season.shape[-1]
    phase = state.t % period
    s_t = _at(state.season, phase)
    level_new = alpha * (y - s_t) + (1.0 - alpha) * (state.level
                                                     + state.trend)
    trend_new = beta * (level_new - state.level) + (1.0 - beta) * state.trend
    season_new = state.season.scatter(
        -1, phase.long()[..., None],
        (gamma * (y - level_new) + (1.0 - gamma) * s_t)[..., None])
    return HWState(level_new, trend_new, season_new, state.t + 1)


def hw_forecast(state: HWState, horizon: int) -> torch.Tensor:
    """h-step-ahead point forecast from the current state."""
    period = state.season.shape[-1]
    phase = (state.t + horizon - 1) % period
    return state.level + horizon * state.trend + _at(state.season, phase)


def hw_forecast_max(state: HWState, horizon: int) -> torch.Tensor:
    """Max forecast over the next `horizon` steps (for peak pre-scaling)."""
    period = state.season.shape[-1]
    hs = torch.arange(1, horizon + 1, device=state.level.device)
    phases = (state.t[..., None] + hs - 1) % period
    preds = (state.level[..., None]
             + hs.to(torch.float32) * state.trend[..., None]
             + torch.gather(state.season, -1, phases.long()))
    return preds.amax(-1)


def smooth_coeffs(alpha=0.1, beta=0.01,
                  gamma=0.3) -> tuple[float, float, float, float, float,
                                      float]:
    """(alpha, beta, gamma, 1 - alpha, 1 - beta, 1 - gamma) as `hw_smooth`
    computes them: each rounded to f32, the subtractions in f32."""
    abg = [np.float32(v) for v in (alpha, beta, gamma)]
    return tuple(float(v) for v in abg) + tuple(
        float(np.float32(1.0) - v) for v in abg)


def hw_smooth(y: torch.Tensor, *, period: int = 60, alpha=0.1, beta=0.01,
              gamma=0.3) -> torch.Tensor:
    """One-step-ahead forecasts over whole series: y [..., T] ->
    forecasts [..., T], forecasts[..., t] the prediction of y[..., t]
    made after y[..., :t] (the t = 0 one is y[..., 0], the level it
    starts from). The time loop runs over [...]-vectors in the order of
    the ``holt_winters`` kernel's per-thread loop."""
    x = torch.as_tensor(y).to(torch.float32)
    if x.dim() < 1 or x.shape[-1] < 1 or period < 1:
        raise ValueError(f"hw_smooth: y [..., T >= 1] and period >= 1, got "
                         f"{tuple(x.shape)}, period {period}")
    a, b, g, oa, ob, og = smooth_coeffs(alpha, beta, gamma)
    level, trend = x[..., 0], torch.zeros_like(x[..., 0])
    season = [torch.zeros_like(level)] * period
    preds = []
    for t in range(x.shape[-1]):
        s_t, yt = season[t % period], x[..., t]
        preds.append((level + trend) + s_t)
        new = a * (yt - s_t) + oa * (level + trend)
        trend = b * (new - level) + ob * trend
        season[t % period] = g * (yt - new) + og * s_t
        level = new
    return torch.stack(preds, -1)


def linear_trend_forecast(history: torch.Tensor,
                          horizon: int) -> torch.Tensor:
    """RAMP strategy: OLS trend extrapolation `horizon` steps ahead.

    history [..., T] -> forecast [...], clipped at zero."""
    x = history.to(torch.float32)
    n = x.shape[-1]
    tbar, tvar = trend_constants(n)
    t = torch.arange(n, dtype=torch.float32, device=x.device) - tbar
    mean = xla_sum(x) * recip(n)
    slope = (xla_sum(t * (x - mean[..., None])) * recip(n)
             / _device.const(tvar, x.device))
    return (mean + slope * ((n - 1) - tbar + horizon)).clamp_min(0.0)
