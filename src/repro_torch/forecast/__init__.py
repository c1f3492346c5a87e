"""Forecasting for the scaling control plane (port of ``repro.forecast``):
the `Forecaster` protocol (`api`), the built-in models (`models`) and
named factories with per-archetype defaults (`registry`). Conformal
intervals and batched backtests are not ported yet (ROADMAP)."""
