"""Back-compat shim (port of ``repro.core.controllers``): the autoscaling
policies live in ``repro_torch.scaling.policies``; this module re-exports
the original names unchanged."""
from __future__ import annotations

from repro_torch.scaling.api import Controller, Obs  # noqa: F401
from repro_torch.scaling.policies import (  # noqa: F401
    AAPAState, HPAState, KPAState, PredState, aapa_controller,
    hpa_controller, hybrid_controller, kpa_controller,
    predictive_controller)

__all__ = ["Controller", "Obs", "AAPAState", "HPAState", "KPAState",
           "PredState", "aapa_controller", "hpa_controller",
           "hybrid_controller", "kpa_controller", "predictive_controller"]
