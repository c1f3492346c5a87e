"""Forecasting for the scaling control plane (port of ``repro.forecast``):
the `Forecaster` protocol (`api`), the built-in models (`models`), named
factories with per-archetype defaults (`registry`), split-conformal
intervals (`conformal`) and batched offline backtests (`backtest`)."""
