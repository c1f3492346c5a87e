"""Scenario library: named workload x plant configurations (NumPy copy
of ``repro.scaling.scenarios``): archetype-pure and mixed traces, burst
storms, diurnal ramps, idle-then-wake, and plant-parameter sweeps.

A `Scenario` bundles a rate matrix [workloads, minutes] with the
`SimConfig` it runs under:

    sc = scenarios.get("burst_storm", n_workloads=8, seed=3)

Everything is seeded NumPy and draws the reference's random stream, so
a seed gives bit-identical counts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np

from repro_torch.core.archetypes import Archetype
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
        raise KeyError(f"unknown scenario {name!r}; "
                       f"available: {available()}") from None
    return builder(**kw)


def _pure_counts(kind: Archetype, n: int, minutes: int, seed: int):
    """n archetype-pure traces from the calibrated Azure-like generators."""
    n_days = max(-(-minutes // 1440), 1)
    traces = generate_traces(n_functions=n, n_days=n_days, seed=seed,
                             mix={kind: 1.0})
    return traces.counts[:, :minutes]


@register("archetype_pure")
def archetype_pure(kind: str = "SPIKE", n_workloads: int = 16,
                   minutes: int = 1440, seed: int = 0,
                   cfg: SimConfig = SimConfig()) -> Scenario:
    rates = _pure_counts(Archetype[kind], n_workloads, minutes, seed)
    return Scenario(f"archetype_pure:{kind}", rates, cfg,
                    {"kind": kind, "seed": seed})


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


@register("diurnal_ramp")
def diurnal_ramp(n_workloads: int = 16, minutes: int = 2880,
                 seed: int = 0, base: float = 1200.0,
                 growth: float = 2.0,
                 cfg: SimConfig = SimConfig()) -> Scenario:
    """A diurnal sinusoid composed with a multi-day linear ramp (organic
    growth): PERIODIC and RAMP evidence in the same window."""
    rng = np.random.default_rng(seed)
    t = np.arange(minutes, dtype=np.float64)
    day = 1.0 + 0.6 * np.sin(2 * np.pi * t / 1440.0
                             - 0.5 * np.pi)          # trough at t=0
    ramp = 1.0 + (growth - 1.0) * t / max(minutes - 1, 1)
    phase = rng.uniform(0, 2 * np.pi, size=(n_workloads, 1))
    jitter = 1.0 + 0.1 * np.sin(2 * np.pi * t[None, :] / 360.0 + phase)
    rates = base * day[None, :] * ramp[None, :] * jitter
    counts = rng.poisson(np.maximum(rates, 0.0)).astype(np.float32)
    return Scenario("diurnal_ramp", counts, cfg,
                    {"base": base, "growth": growth})


@register("idle_wake")
def idle_wake(n_workloads: int = 8, minutes: int = 360, seed: int = 0,
              burst: float = 600.0,
              cfg: SimConfig = SimConfig()) -> Scenario:
    """A long idle stretch, then a burst: scale-to-zero, the activator
    path and cold-start accounting."""
    rng = np.random.default_rng(seed)
    rates = np.zeros((n_workloads, minutes), np.float32)
    wake = minutes - minutes // 4
    rates[:, wake:wake + 5] = burst
    counts = rng.poisson(rates).astype(np.float32)
    return Scenario("idle_wake", counts, cfg, {"wake_minute": int(wake)})


def startup_sweep(values=(5, 15, 30, 60, 120), base: str = "burst_storm",
                  **kw) -> list[Scenario]:
    """The same workloads under increasing pod startup latency."""
    out = []
    for v in values:
        sc = get(base, **kw)
        cfg = dataclasses.replace(sc.cfg, startup_sec=int(v))
        out.append(Scenario(f"{sc.name}@startup={v}s", sc.rates, cfg,
                            {**sc.meta, "startup_sec": int(v)}))
    return out


def rps_per_replica_sweep(values=(5.0, 10.0, 20.0, 40.0),
                          base: str = "archetype_mix",
                          **kw) -> list[Scenario]:
    """Replica capacity sweep: a smaller `rps_per_replica` means more
    replicas per unit of load."""
    out = []
    for v in values:
        sc = get(base, **kw)
        cfg = dataclasses.replace(sc.cfg, rps_per_replica=float(v))
        out.append(Scenario(f"{sc.name}@rps={v}", sc.rates, cfg,
                            {**sc.meta, "rps_per_replica": float(v)}))
    return out
