"""Batched offline backtests: forecasters x series (port of
``repro.forecast.backtest``).

`make_batch_backtest` runs every forecaster's one-step-ahead backtest
over the same series in one time loop, lane f of the result exactly
`stream_smooth` of forecaster f alone. These are plain PyTorch loops on
the series' device; the reference has no kernel here either. The
streaming path forecasts with the forecaster's own `forecast`, which
clamps Holt-Winters at 0, so it differs from Holt-Winters' offline
`smooth` (the unclamped ``holt_winters`` kernel) where a forecast is
negative, as in the reference.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import _device
from repro_torch.forecast import registry
from repro_torch.forecast.api import Forecaster


def _resolve(forecasters: Sequence[Forecaster | str]) -> list[Forecaster]:
    return [registry.make(f) for f in forecasters]


def _series(y, device) -> torch.Tensor:
    return torch.as_tensor(y).to(device=_device.resolve(device),
                                 dtype=torch.float32)


def _run(fcs: list[Forecaster], y: torch.Tensor) -> torch.Tensor:
    """y [B, T] -> one-step-ahead predictions [F, B, T]."""
    states = [f.init(y.shape[:-1], y.device) for f in fcs]
    preds = []
    for t in range(y.shape[-1]):
        preds.append(torch.stack([f.forecast(s, 1).point
                                  for f, s in zip(fcs, states)]))
        states = [f.update(s, y[..., t]) for f, s in zip(fcs, states)]
    return torch.stack(preds, -1)


def stream_smooth(forecaster: Forecaster | str, y, *,
                  device="cuda") -> torch.Tensor:
    """Streaming one-step backtest of one forecaster: forecast(., 1) then
    update, step by step. y [B, T] -> preds [B, T]."""
    return _run(_resolve([forecaster]), _series(y, device))[0]


def make_batch_backtest(forecasters: Sequence[Forecaster | str], *,
                        device="cuda"):
    """fn: y [B, T] -> one-step-ahead predictions [F, B, T]."""
    fcs = _resolve(forecasters)
    return lambda y: _run(fcs, _series(y, device))


def batch_smooth(forecasters: Sequence[Forecaster | str], y, *,
                 b_chunk: int | None = None,
                 device="cuda") -> torch.Tensor:
    """y [B, T] -> predictions [F, B, T].

    `b_chunk` runs `b_chunk` series at a time, so a fleet-sized B never
    holds every forecaster's state at once; each series' lane is
    independent, so the chunked predictions equal the unchunked ones bit
    for bit. (The reference pads the tail chunk to reuse its compile;
    eager PyTorch has no compile to reuse.)"""
    fn = make_batch_backtest(forecasters, device=device)
    y = _series(y, device)
    B = y.shape[0]
    if b_chunk is None or b_chunk >= B:
        return fn(y)
    if b_chunk <= 0:
        raise ValueError(f"b_chunk must be positive, got {b_chunk}")
    return torch.cat([fn(y[lo:lo + b_chunk]) for lo in range(0, B, b_chunk)],
                     1)
