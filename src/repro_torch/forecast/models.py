"""The built-in forecasters: Holt-Winters, linear trend, seasonal naive
and EWMA (port of ``repro.forecast.models``), each assembled through
``api.make_forecaster``.

Holt-Winters' offline `smooth` is ``kernels.ops.holt_winters``: the
``holt_winters`` CUDA kernel on a CUDA tensor, its plain version
(``core.forecasting.hw_smooth``) on a CPU tensor. The other three
backtest through the shared sequential `smooth`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import forecasting as fc
from repro_torch.forecast.api import Forecaster, make_forecaster


# ---------------------------------------------------------- Holt-Winters ----
def holt_winters_forecaster(*, period: int = 60, alpha: float = 0.1,
                            beta: float = 0.01,
                            gamma: float = 0.3) -> Forecaster:
    """Additive-seasonal triple exponential smoothing (PERIODIC strategy,
    paper Table III; the Generic-Predictive baseline, §IV.C)."""

    def smooth_fn(y):
        from repro_torch.kernels import ops
        flat = y.reshape(-1, y.shape[-1]).contiguous()
        return ops.holt_winters(flat, period=period, alpha=alpha, beta=beta,
                                gamma=gamma).reshape(y.shape)

    return make_forecaster(
        "holt_winters",
        init_inner=lambda lanes, dev: fc.hw_init(period, lanes=lanes,
                                                 device=dev),
        update_inner=lambda st, y: fc.hw_step(st, y, alpha=alpha,
                                              beta=beta, gamma=gamma),
        point_fn=lambda st, h: fc.hw_forecast_max(st, h).clamp_min(0.0),
        smooth_fn=smooth_fn,
        hyper=dict(period=period, alpha=alpha, beta=beta, gamma=gamma))


# ----------------------------------------------------------- linear trend ----
def linear_trend_forecaster(*, window: int = 30) -> Forecaster:
    """OLS trend extrapolation over a sliding window (RAMP strategy).
    State is the [..., window] buffer of the most recent observations."""

    def point(buf: torch.Tensor, h: int):
        # peak over the horizon: a line attains its max at an endpoint
        return torch.maximum(fc.linear_trend_forecast(buf, 1),
                             fc.linear_trend_forecast(buf, h))

    return make_forecaster(
        "linear_trend",
        init_inner=lambda lanes, dev: torch.zeros(
            lanes + (window,), dtype=torch.float32, device=dev),
        update_inner=lambda buf, y: torch.cat([buf[..., 1:], y[..., None]],
                                              -1),
        point_fn=point, hyper=dict(window=window))


# --------------------------------------------------------- seasonal naive ----
class SeasonalState(NamedTuple):
    season: torch.Tensor  # [..., period] last observation at each phase
    t: torch.Tensor       # [...] int32 samples seen


def seasonal_naive_forecaster(*, period: int = 60) -> Forecaster:
    """Repeat the value one period ago (needs one period of warm-up)."""

    def update(st: SeasonalState, y):
        at = (st.t % period).long()[..., None]
        y = torch.broadcast_to(y, st.t.shape)
        return SeasonalState(season=st.season.scatter(-1, at, y[..., None]),
                             t=st.t + 1)

    def point(st: SeasonalState, h: int):
        hs = torch.arange(1, h + 1, device=st.t.device)
        phases = (st.t[..., None] + hs - 1) % period
        return torch.gather(st.season, -1, phases.long()).amax(
            -1).clamp_min(0.0)

    return make_forecaster(
        "seasonal_naive",
        init_inner=lambda lanes, dev: SeasonalState(
            season=torch.zeros(lanes + (period,), dtype=torch.float32,
                               device=dev),
            t=torch.zeros(lanes, dtype=torch.int32, device=dev)),
        update_inner=update, point_fn=point, hyper=dict(period=period))


# ------------------------------------------------------------------- EWMA ----
def ewma_forecaster(*, alpha: float = 0.3) -> Forecaster:
    """Exponentially weighted level; flat forecast at every horizon."""
    return make_forecaster(
        "ewma",
        init_inner=lambda lanes, dev: torch.zeros(
            lanes, dtype=torch.float32, device=dev),
        update_inner=lambda lvl, y: lvl + alpha * (y - lvl),
        point_fn=lambda lvl, h: lvl.clamp_min(0.0),
        hyper=dict(alpha=alpha))
