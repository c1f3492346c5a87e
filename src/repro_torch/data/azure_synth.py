"""Synthetic Azure-Functions-like invocation traces (NumPy copy of
``repro.data.azure_synth``, every trace family).

Per-minute invocation counts over days, base rates log-uniform over ~5
decades, four ground-truth pattern families matching the paper's Table I
(SPIKE, PERIODIC, RAMP, STATIONARY), Poisson-sampled from a
pattern-specific rate curve. The generator draws the same NumPy random
stream as the reference, so a seed gives bit-identical traces.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.archetypes import Archetype

MINUTES_PER_DAY = 1440


@dataclasses.dataclass
class TraceSet:
    rates: np.ndarray          # [F, T] expected req/min (the latent rate)
    counts: np.ndarray         # [F, T] Poisson-sampled invocations/min
    pattern: np.ndarray        # [F] ground-truth Archetype id of generator
    base_rate: np.ndarray      # [F] mean req/min scale
    n_days: int

    @property
    def n_functions(self) -> int:
        return self.rates.shape[0]


def _periodic(rng, T, base):
    # minute-scale cron periods; longer ones label as other archetypes
    period = rng.choice([5, 10, 15, 20, 30, 60, 240],
                        p=[0.22, 0.24, 0.2, 0.14, 0.1, 0.05, 0.05])
    amp = rng.uniform(0.4, 0.95)
    phase = rng.uniform(0, 2 * np.pi)
    t = np.arange(T)
    wave = np.sin(2 * np.pi * t / period + phase)
    sharp = rng.uniform(1.0, 3.0)  # >1 sharpens peaks toward square/pulse
    wave = np.sign(wave) * np.abs(wave) ** (1.0 / sharp)
    rate = base * (1.0 + amp * wave)
    return np.maximum(rate, 0.0)


def _spike(rng, T, base):
    # quiet floor with a handful of large bursts per day
    floor = base * rng.uniform(0.02, 0.15)
    rate = np.full(T, floor)
    n_spikes = rng.poisson(6.0 * (T / MINUTES_PER_DAY)) + 1
    starts = rng.integers(0, T, size=n_spikes)
    for s in starts:
        height = base * rng.uniform(20.0, 300.0)
        dur = int(rng.integers(2, 12))
        decay = np.exp(-np.arange(dur) / max(dur / 3.0, 1.0))
        end = min(s + dur, T)
        rate[s:end] += height * decay[: end - s]
    return rate


def _ramp(rng, T, base):
    # piecewise-linear ramps over multi-hour segments (growth/migration)
    rate = np.empty(T)
    t0, level = 0, base * rng.uniform(0.3, 0.8)
    while t0 < T:
        seg = int(rng.integers(90, 360))
        direction = rng.choice([1.0, 1.0, 1.0, -0.7])  # mostly growth
        target = np.clip(level * rng.uniform(3.0, 8.0) ** direction,
                         0.1 * base, 100.0 * base)
        end = min(t0 + seg, T)
        rate[t0:end] = np.linspace(level, target, end - t0)
        level, t0 = target, end
    return rate


def _stationary(rng, T, base):
    cv = rng.uniform(0.05, 0.25)
    ar = rng.uniform(0.3, 0.8)  # mild AR(1) correlation
    noise = np.empty(T)
    noise[0] = 0.0
    eps = rng.normal(0, 1, T)
    for t in range(1, T):
        noise[t] = ar * noise[t - 1] + eps[t]
    noise /= max(noise.std(), 1e-9)
    return np.maximum(base * (1.0 + cv * noise), 0.0)


def _diurnal_burst(rng, T, base):
    # a day-scale sinusoid (office-hours load) with random bursts on top
    phase = rng.uniform(0, 2 * np.pi)
    depth = rng.uniform(0.4, 0.9)
    t = np.arange(T)
    rate = base * (1.0 + depth * np.sin(2 * np.pi * t / MINUTES_PER_DAY
                                        + phase))
    n_bursts = rng.poisson(3.0 * (T / MINUTES_PER_DAY)) + 1
    for s in rng.integers(0, T, size=n_bursts):
        height = base * rng.uniform(10.0, 80.0)
        dur = int(rng.integers(3, 15))
        decay = np.exp(-np.arange(dur) / max(dur / 3.0, 1.0))
        end = min(s + dur, T)
        rate[s:end] += height * decay[: end - s]
    return np.maximum(rate, 0.0)


def _regime_switch(rng, T, base):
    # piecewise-constant demand regimes with abrupt multi-x level switches
    # every few hours (deploys, migrations, feature launches)
    rate = np.empty(T)
    t0, level = 0, base * rng.uniform(0.3, 1.0)
    while t0 < T:
        seg = int(rng.integers(180, 720))
        end = min(t0 + seg, T)
        cv = rng.uniform(0.03, 0.12)
        rate[t0:end] = level * (1.0 + cv * rng.normal(0, 1, end - t0))
        level = float(np.clip(level * rng.uniform(0.2, 5.0),
                              0.05 * base, 50.0 * base))
        t0 = end
    return np.maximum(rate, 0.0)


_GENERATORS = {
    Archetype.PERIODIC: _periodic,
    Archetype.SPIKE: _spike,
    Archetype.RAMP: _ramp,
    Archetype.STATIONARY_NOISY: _stationary,
}

# Function-level pattern mix (PERIODIC-heavy, near the paper's §V.A
# window-label marginals).
DEFAULT_MIX = {
    Archetype.PERIODIC: 0.70,
    Archetype.SPIKE: 0.14,
    Archetype.STATIONARY_NOISY: 0.08,
    Archetype.RAMP: 0.08,
}


# Scenario-diversity families (the AAPAset registry's variants): each
# entry is (generator, ground-truth archetype tag, weight). "default" is
# the mix above.
FAMILY_SPECS: dict[str, list] = {
    "spike_heavy": [
        (_spike, Archetype.SPIKE, 0.50),
        (_diurnal_burst, Archetype.SPIKE, 0.15),
        (_periodic, Archetype.PERIODIC, 0.18),
        (_stationary, Archetype.STATIONARY_NOISY, 0.09),
        (_ramp, Archetype.RAMP, 0.08),
    ],
    "regime_switch": [
        (_regime_switch, Archetype.RAMP, 0.40),
        (_ramp, Archetype.RAMP, 0.10),
        (_stationary, Archetype.STATIONARY_NOISY, 0.15),
        (_periodic, Archetype.PERIODIC, 0.22),
        (_spike, Archetype.SPIKE, 0.13),
    ],
    "diurnal_burst": [
        (_diurnal_burst, Archetype.SPIKE, 0.45),
        (_periodic, Archetype.PERIODIC, 0.30),
        (_stationary, Archetype.STATIONARY_NOISY, 0.13),
        (_ramp, Archetype.RAMP, 0.12),
    ],
}
TRACE_FAMILIES = ("default", *FAMILY_SPECS)


def generate_traces(n_functions: int = 200, n_days: int = 14,
                    seed: int = 0, mix: dict | None = None,
                    family: str = "default") -> TraceSet:
    """A seeded TraceSet. `family` picks a mix from ``FAMILY_SPECS``
    ("default": the paper-calibrated mix, which `mix` reweights)."""
    if family not in TRACE_FAMILIES:
        raise ValueError(f"unknown trace family {family!r}; "
                         f"available: {list(TRACE_FAMILIES)}")
    rng = np.random.default_rng(seed)
    T = n_days * MINUTES_PER_DAY
    if family == "default":
        mix = mix or DEFAULT_MIX
        kinds = rng.choice(list(mix.keys()), size=n_functions,
                           p=np.array(list(mix.values())) / sum(mix.values()))
        base = 10.0 ** rng.uniform(-0.5, 3.2, size=n_functions)
        gens = [_GENERATORS[Archetype(int(k))] for k in kinds]
    else:
        if mix is not None:
            raise ValueError("mix= only applies to the default family")
        spec = FAMILY_SPECS[family]
        w = np.array([s[2] for s in spec])
        pick = rng.choice(len(spec), size=n_functions, p=w / w.sum())
        base = 10.0 ** rng.uniform(-0.5, 3.2, size=n_functions)
        gens = [spec[int(i)][0] for i in pick]
        kinds = np.array([int(spec[int(i)][1]) for i in pick])
    rates = np.empty((n_functions, T), np.float64)
    for i in range(n_functions):
        rates[i] = gens[i](rng, T, base[i])
    counts = rng.poisson(np.minimum(rates, 1e7)).astype(np.float32)
    return TraceSet(rates=rates.astype(np.float32), counts=counts,
                    pattern=np.asarray(kinds, np.int32),
                    base_rate=base.astype(np.float32), n_days=n_days)
