"""Scenario library: named workload x plant configurations (NumPy copy
of ``repro.scaling.scenarios``; the builders ported so far).

A `Scenario` bundles a rate matrix [workloads, minutes] with the
`SimConfig` it runs under:

    sc = scenarios.get("burst_storm", n_workloads=8, seed=3)

Everything is seeded NumPy and draws the reference's random stream, so
a seed gives bit-identical counts.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from repro_torch.data.azure_synth import generate_traces
from repro_torch.sim.cluster import SimConfig


class Scenario(NamedTuple):
    name: str
    rates: np.ndarray        # [W, M] arrivals per minute
    cfg: SimConfig
    meta: dict


_BUILDERS: dict[str, Callable[..., Scenario]] = {}


def register(name: str):
    def deco(fn):
        _BUILDERS[name] = fn
        return fn
    return deco


def available() -> list[str]:
    return sorted(_BUILDERS)


def get(name: str, **kw) -> Scenario:
    try:
        builder = _BUILDERS[name]
    except KeyError:
        raise KeyError(f"unknown or not yet ported scenario {name!r}; "
                       f"available: {available()}") from None
    return builder(**kw)


@register("archetype_mix")
def archetype_mix(n_workloads: int = 32, minutes: int = 1440,
                  seed: int = 0, cfg: SimConfig = SimConfig()) -> Scenario:
    """Default paper mix (PERIODIC-heavy, §V.A marginals)."""
    n_days = max(-(-minutes // 1440), 1)
    traces = generate_traces(n_functions=n_workloads, n_days=n_days,
                             seed=seed)
    return Scenario("archetype_mix", traces.counts[:, :minutes], cfg,
                    {"pattern": traces.pattern.tolist(), "seed": seed})


@register("burst_storm")
def burst_storm(n_workloads: int = 16, minutes: int = 720, seed: int = 0,
                floor: float = 30.0, height: float = 6000.0,
                n_storms: int = 3,
                cfg: SimConfig = SimConfig()) -> Scenario:
    """Synchronized bursts: every workload spikes in the same windows
    (correlated incident traffic, the hardest case for reactive
    scaling)."""
    rng = np.random.default_rng(seed)
    rates = np.full((n_workloads, minutes), floor, np.float32)
    lo = max(minutes // 6, 1)
    hi = max(minutes - max(minutes // 6, 15), lo + 1)
    starts = rng.integers(lo, hi, size=n_storms)
    for s in starts:
        dur = int(rng.integers(3, 10))
        decay = np.exp(-np.arange(dur) / max(dur / 3.0, 1.0))
        amp = height * rng.uniform(0.5, 1.5, size=(n_workloads, 1))
        end = min(s + dur, minutes)
        rates[:, s:end] += amp * decay[None, :end - s]
    counts = rng.poisson(rates).astype(np.float32)
    return Scenario("burst_storm", counts, cfg,
                    {"storm_starts": sorted(int(s) for s in starts)})
