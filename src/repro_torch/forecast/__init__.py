"""Forecasting for the scaling control plane (port of ``repro.forecast``):
the `Forecaster` protocol (`api`), the built-in models (`models`), named
factories with per-archetype defaults (`registry`), split-conformal
intervals (`conformal`) and batched offline backtests (`backtest`)."""
from repro_torch.forecast import backtest, conformal, registry  # noqa: F401
from repro_torch.forecast.api import (Forecaster, FState,  # noqa: F401
                                      Interval, interval_confidence,
                                      make_forecaster)

__all__ = ["Forecaster", "FState", "Interval", "interval_confidence",
           "make_forecaster", "backtest", "conformal", "registry"]
