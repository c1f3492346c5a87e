"""Named forecaster factories with per-archetype defaults (port of
``repro.forecast.registry``).

    from repro_torch.forecast import registry
    fcst = registry.make("holt_winters", period=1440)
    name = registry.for_archetype(Archetype.RAMP)     # -> "linear_trend"

Policies resolve forecasters here by name.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.core.archetypes import Archetype
from repro_torch.forecast import models as Mo
from repro_torch.forecast.api import Forecaster


@dataclasses.dataclass(frozen=True)
class ForecasterSpec:
    name: str
    factory: Callable[..., Forecaster]   # factory(**hyper) -> Forecaster
    defaults: dict[str, Any]
    description: str = ""


_REGISTRY: dict[str, ForecasterSpec] = {}


def register(name: str, factory: Callable[..., Forecaster], *,
             defaults: dict[str, Any] | None = None,
             description: str = "") -> None:
    if name in _REGISTRY:
        raise ValueError(f"forecaster {name!r} already registered")
    _REGISTRY[name] = ForecasterSpec(name, factory, dict(defaults or {}),
                                     description)


def available() -> list[str]:
    return sorted(_REGISTRY)


def spec(name: str) -> ForecasterSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown forecaster {name!r}; "
                       f"available: {available()}") from None


def make(name: str | Forecaster, **overrides) -> Forecaster:
    """Build a registered forecaster with defaults + overrides applied.
    A `Forecaster` instance passes through unchanged (so every API that
    resolves names also accepts pre-built forecasters)."""
    if isinstance(name, Forecaster):
        if overrides:
            raise TypeError("cannot override hyperparameters of a "
                            "pre-built Forecaster instance")
        return name
    sp = spec(name)
    kw = dict(sp.defaults)
    unknown = set(overrides) - set(kw)
    if unknown:
        raise TypeError(f"forecaster {name!r} has no hyperparameters "
                        f"{sorted(unknown)}; accepts {sorted(kw)}")
    kw.update(overrides)
    return sp.factory(**kw)


# Per-archetype defaults (paper Table III strategy column): PERIODIC
# backtests best under seasonal smoothing, RAMP under trend
# extrapolation, SPIKE/STATIONARY under a conservative level model.
ARCHETYPE_DEFAULT: dict[Archetype, str] = {
    Archetype.PERIODIC: "holt_winters",
    Archetype.SPIKE: "ewma",
    Archetype.STATIONARY_NOISY: "ewma",
    Archetype.RAMP: "linear_trend",
}


def for_archetype(arch: Archetype | int) -> str:
    return ARCHETYPE_DEFAULT[Archetype(int(arch))]


# ------------------------------------------------------ built-in catalog ----
register(
    "holt_winters", Mo.holt_winters_forecaster,
    defaults=dict(period=60, alpha=0.1, beta=0.01, gamma=0.3),
    description="Additive-seasonal triple exponential smoothing; its "
                "offline backtest is the holt_winters kernel.")

register(
    "linear_trend", Mo.linear_trend_forecaster,
    defaults=dict(window=30),
    description="Sliding-window OLS trend extrapolation (RAMP strategy).")

register(
    "seasonal_naive", Mo.seasonal_naive_forecaster,
    defaults=dict(period=60),
    description="Repeat the value one period ago.")

register(
    "ewma", Mo.ewma_forecaster,
    defaults=dict(alpha=0.3),
    description="Exponentially weighted level, flat at every horizon.")
