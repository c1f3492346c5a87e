"""Forecasting protocol for the scaling control plane (port of
``repro.forecast.api``).

A `Forecaster` is a named bundle of functions on lane tensors:

    init(lanes, device)          -> state
    update(state, y)             -> state        # observe one sample
    forecast(state, horizon)     -> Interval(point, lo, hi)
    smooth(y [..., T])           -> [..., T]     # offline one-step backtest

`forecast` returns the peak point forecast over the next `horizon` steps
plus a band from an EWMA of one-step absolute residuals (`FState.resid`)
that widens with sqrt(horizon). `interval_confidence` maps the band's
width to a confidence in [0, 1].
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple

import numpy as np
import torch

from repro_torch import _device

RESID_RHO = 0.05         # EWMA rate for the one-step residual scale
NATIVE_Z = 1.64          # ~90% band under a Gaussian residual model
EPSF = 1e-9
MIN_CONF_SCALE = 1.0     # one request/min: arrival counts resolve no finer


class Interval(NamedTuple):
    """Point forecast with an uncertainty band (lo <= point <= hi)."""
    point: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor


class FState(NamedTuple):
    """Uniform forecaster carry: model state + residual-scale EWMA."""
    inner: Any
    resid: torch.Tensor  # f32 EWMA of |one-step-ahead error|


class Forecaster(NamedTuple):
    """Pluggable forecaster; `hyper` holds the model's hyperparameters
    (the AAPA episode kernel reads Holt-Winters' from it)."""
    name: str
    init: Callable[..., FState]
    update: Callable[[FState, torch.Tensor], FState]
    forecast: Callable[[FState, int], Interval]
    smooth: Callable[[torch.Tensor], torch.Tensor]
    hyper: Mapping[str, Any] = {}


def interval_confidence(iv: Interval, scale: torch.Tensor | None = None, *,
                        floor: float = MIN_CONF_SCALE):
    """Map an interval's relative width to a confidence c in [0, 1]:
    c = s / (s + width), s the point forecast (or `scale`) floored at
    `floor` (one request/min by default)."""
    width = (iv.hi - iv.lo).clamp_min(0.0)
    s = torch.maximum(iv.point if scale is None else scale,
                      torch.full_like(iv.point, max(floor, EPSF)))
    return s / (s + width)


def make_forecaster(name: str, *, init_inner, update_inner, point_fn,
                    smooth_fn=None, z: float = NATIVE_Z,
                    hyper: Mapping[str, Any] | None = None) -> Forecaster:
    """Assemble a Forecaster from model-specific pieces:
    ``init_inner(lanes, device) -> inner``, ``update_inner(inner, y) ->
    inner`` and ``point_fn(inner, horizon) -> peak point forecast``.
    Residual tracking, the native interval and (unless `smooth_fn` is
    given) the sequential offline backtest are shared here."""

    def init(lanes: tuple[int, ...] = (), device="cuda") -> FState:
        dev = _device.resolve(device)
        return FState(inner=init_inner(lanes, dev),
                      resid=torch.zeros(lanes, dtype=torch.float32,
                                        device=dev))

    def update(state: FState, y) -> FState:
        y = torch.as_tensor(y, dtype=torch.float32)
        pred1 = point_fn(state.inner, 1)
        resid = state.resid + RESID_RHO * ((y - pred1).abs() - state.resid)
        return FState(inner=update_inner(state.inner, y), resid=resid)

    def forecast(state: FState, horizon: int) -> Interval:
        point = point_fn(state.inner, horizon)
        half = (float(np.float32(z)) * state.resid
                * float(np.sqrt(np.float32(horizon))))
        return Interval(point=point, lo=(point - half).clamp_min(0.0),
                        hi=point + half)

    def smooth(y: torch.Tensor) -> torch.Tensor:
        """[..., T] -> one-step-ahead point forecasts [..., T]."""
        y = torch.as_tensor(y, dtype=torch.float32)
        if smooth_fn is not None:
            return smooth_fn(y)
        st = init(y.shape[:-1], y.device)
        preds = []
        for t in range(y.shape[-1]):
            preds.append(point_fn(st.inner, 1))
            st = update(st, y[..., t])
        return torch.stack(preds, -1)

    return Forecaster(name, init, update, forecast, smooth,
                      dict(hyper or {}))
