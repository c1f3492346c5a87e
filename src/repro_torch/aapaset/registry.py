"""Named AAPAset configs (port of ``repro.aapaset.registry``).

* ``aapaset_300k`` — the paper-scale artifact (§IV.A: ~300K weakly
  labeled Azure-Functions windows; 150 functions x 14 days x 60-min
  windows at 10-min stride = 301,650 windows).
* ``aapaset_ci`` — ~10K windows, builds in seconds on the CPU.
* ``spike_heavy`` / ``regime_switch`` / ``diurnal_burst`` — scenario-
  diversity variants backed by the trace families in
  ``repro_torch.data.azure_synth.FAMILY_SPECS``.

``get(name, **overrides)`` returns a frozen config; content-field
overrides flow into the content hash, so a tweaked variant never
collides with the named artifact it was derived from. The two execution
knobs (`chunk`, `shard_rows`) cannot change dataset bytes, so overriding
only them resolves to the same address.
"""
from __future__ import annotations

import dataclasses

from repro_torch.aapaset.manifest import DatasetConfig

_REGISTRY: dict[str, DatasetConfig] = {}


def register(cfg: DatasetConfig) -> DatasetConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"dataset {cfg.name!r} already registered")
    _REGISTRY[cfg.name] = cfg
    return cfg


def available() -> list[str]:
    return sorted(_REGISTRY)


def get(name: str, **overrides) -> DatasetConfig:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown dataset {name!r}; available: {available()}")
    cfg = _REGISTRY[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


register(DatasetConfig("aapaset_300k", n_functions=150, n_days=14, seed=0))
register(DatasetConfig("aapaset_ci", n_functions=18, n_days=4, seed=0))
register(DatasetConfig("spike_heavy", n_functions=96, n_days=7, seed=1,
                       family="spike_heavy"))
register(DatasetConfig("regime_switch", n_functions=96, n_days=7, seed=2,
                       family="regime_switch"))
register(DatasetConfig("diurnal_burst", n_functions=96, n_days=7, seed=3,
                       family="diurnal_burst"))
