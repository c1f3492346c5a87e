"""Holt-Winters (triple exponential smoothing) and linear-trend
forecasts (port of ``repro.core.forecasting``).

``hw_step`` is the online update AAPA's PERIODIC strategy and the
episode kernel run once a minute; state tensors carry any leading lane
shape. ``hw_smooth``, the offline backtest (and the oracle of the
reference's ``holt_winters`` kernel), is not ported yet (ROADMAP B5).
"""
from __future__ import annotations

from typing import NamedTuple

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
