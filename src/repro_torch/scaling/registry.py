"""Named controller factories with per-policy default hyperparameters
(port of ``repro.scaling.registry``).

    from repro_torch.scaling import registry
    ctrl = registry.make("hpa", SimConfig(), target=0.6)

Only the policies ported so far are registered; asking for any other
name raises a ``KeyError`` that lists them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.scaling import policies as P
from repro_torch.scaling.api import Controller


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    name: str
    factory: Callable[..., Controller]   # factory(cfg, **hyper)
    defaults: dict[str, Any]
    description: str = ""


_REGISTRY: dict[str, PolicySpec] = {}


def register(name: str, factory: Callable[..., Controller], *,
             defaults: dict[str, Any] | None = None,
             description: str = "") -> None:
    if name in _REGISTRY:
        raise ValueError(f"policy {name!r} already registered")
    _REGISTRY[name] = PolicySpec(name, factory, dict(defaults or {}),
                                 description)


def available() -> list[str]:
    return sorted(_REGISTRY)


def spec(name: str) -> PolicySpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown or not yet ported policy {name!r}; "
                       f"ported: {available()}") from None


def get_controller(name: str, cfg, **overrides) -> Controller:
    """Build a registered controller with defaults + overrides applied."""
    sp = spec(name)
    kw = dict(sp.defaults)
    unknown = set(overrides) - set(kw)
    if unknown:
        raise TypeError(f"policy {name!r} has no hyperparameters "
                        f"{sorted(unknown)}; accepts {sorted(kw)}")
    kw.update(overrides)
    return sp.factory(cfg, **kw)


#: Canonical spelling: ``registry.make("hpa", cfg, ...)``.
make = get_controller


register(
    "hpa", P.hpa_controller,
    defaults=dict(target=0.70, stabilization_min=5.0, cooldown_min=5.0,
                  tolerance=0.10),
    description="Kubernetes HPA: reactive CPU-target scaling with "
                "downscale stabilization (paper §IV.C baseline).")
