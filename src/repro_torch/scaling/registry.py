"""Named controller factories with per-policy default hyperparameters
(port of ``repro.scaling.registry``).

    from repro_torch.scaling import registry
    ctrl = registry.make("hpa", SimConfig(), target=0.6)

All five policies of the reference are registered, with its defaults;
asking for any other name raises a ``KeyError`` that lists them. Each
spec also names its *stackable* hyperparameters (those a grid may vary
without changing the episode's structure, ``scaling.batch``) and whether
the policy takes a forecaster by name. ``tuned:<policy>@<hash12>`` names
the winner of a published tuning card (``tuning.artifacts``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.scaling import policies as P
from repro_torch.scaling.api import Controller


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    name: str
    factory: Callable[..., Controller]   # factory(cfg, **hyper)
    defaults: dict[str, Any]
    stackable: tuple[str, ...] = ()      # grid keys that keep the structure
    needs_classifier: bool = False
    takes_forecaster: bool = False       # accepts forecaster= by name
    description: str = ""


_REGISTRY: dict[str, PolicySpec] = {}


def register(name: str, factory: Callable[..., Controller], *,
             defaults: dict[str, Any] | None = None,
             stackable: tuple[str, ...] = (),
             needs_classifier: bool = False,
             takes_forecaster: bool = False,
             description: str = "") -> None:
    if name in _REGISTRY:
        raise ValueError(f"policy {name!r} already registered")
    _REGISTRY[name] = PolicySpec(name, factory, dict(defaults or {}),
                                 stackable, needs_classifier,
                                 takes_forecaster, description)


def available() -> list[str]:
    return sorted(_REGISTRY)


#: ``registry.make("tuned:<policy>@<hash12>", cfg)`` rebuilds the winner
#: of a published ``repro_torch.tuning`` search card exactly.
TUNED_PREFIX = "tuned:"


def _resolve_tuned(name: str) -> tuple[str, dict[str, Any]]:
    from repro_torch.tuning import artifacts as tuning_artifacts
    return tuning_artifacts.resolve(name[len(TUNED_PREFIX):])


def spec(name: str) -> PolicySpec:
    if name.startswith(TUNED_PREFIX):
        return spec(_resolve_tuned(name)[0])
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; "
                       f"available: {available()}") from None


def default_classify(feats: torch.Tensor):
    """Fallback classifier for aapa when no trained model is supplied:
    STATIONARY_NOISY at 0.5 confidence, i.e. Algorithm 1's conservative
    midpoint. Real runs pass `trained.make_classify()`."""
    lanes = feats.shape[:-1]
    return (torch.full(lanes, 2, dtype=torch.int32, device=feats.device),
            torch.full(lanes, 0.5, dtype=torch.float32, device=feats.device))


def get_controller(name: str, cfg, *, classify=None,
                   **overrides) -> Controller:
    """Build a registered controller with defaults + overrides applied;
    a policy that needs a classifier takes `classify` (default
    `default_classify`).

    ``tuned:<policy>@<hash12>`` names resolve through the tuning cards
    (``tuning.artifacts.resolve``, its `DEFAULT_ROOT`): the card's best
    point over the base policy's defaults, then `overrides` on top — the
    controller the search scored."""
    if name.startswith(TUNED_PREFIX):
        base, params = _resolve_tuned(name)
        return get_controller(base, cfg, classify=classify,
                              **{**params, **overrides})
    sp = spec(name)
    kw = dict(sp.defaults)
    unknown = set(overrides) - set(kw)
    if unknown:
        raise TypeError(f"policy {name!r} has no hyperparameters "
                        f"{sorted(unknown)}; accepts {sorted(kw)}")
    kw.update(overrides)
    if sp.needs_classifier:
        return sp.factory(cfg, classify or default_classify, **kw)
    return sp.factory(cfg, **kw)


#: Canonical spelling: ``registry.make("hpa", cfg, ...)``.
make = get_controller


register(
    "hpa", P.hpa_controller,
    defaults=dict(target=0.70, stabilization_min=5.0, cooldown_min=5.0,
                  tolerance=0.10),
    stackable=("target", "cooldown_min", "tolerance"),
    description="Kubernetes HPA: reactive CPU-target scaling with "
                "downscale stabilization (paper §IV.C baseline).")

register(
    "predictive", P.predictive_controller,
    defaults=dict(target=0.70, horizon_min=15, cooldown_min=5.0,
                  forecaster="holt_winters", band=None,
                  conservative=False),
    stackable=("target", "cooldown_min"),
    takes_forecaster=True,
    description="Generic predictive over any registered forecaster "
                "(default Holt-Winters, 15-minute horizon: the paper "
                "§IV.C baseline).")

register(
    "aapa", P.aapa_controller,
    defaults=dict(stride_min=10, horizon_min=15,
                  forecaster="holt_winters", band=None,
                  forecast_confidence=None),
    needs_classifier=True,
    takes_forecaster=True,
    description="Archetype-aware predictive autoscaler with uncertainty "
                "quantification (the paper's system, §III).")

register(
    "kpa", P.kpa_controller,
    defaults=dict(target_concurrency=None, panic_threshold=2.0,
                  stable_window_s=60.0, panic_window_s=6.0,
                  cooldown_min=1.0),
    stackable=("panic_threshold",),
    description="Knative-KPA-style concurrency scaler with stable/panic "
                "windows.")

register(
    "hybrid", P.hybrid_controller,
    defaults=dict(guard_target=0.85, max_down_frac=0.3, stride_min=10,
                  horizon_min=15, forecaster="holt_winters", band=None,
                  forecast_confidence=None),
    stackable=("guard_target", "max_down_frac"),
    needs_classifier=True,
    takes_forecaster=True,
    description="AAPA with a reactive guardrail floor and bounded "
                "scale-down steps.")
