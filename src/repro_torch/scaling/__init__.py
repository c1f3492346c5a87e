"""Control plane (port of ``repro.scaling``): the controller protocol and
cooldown semantics (`api`), the five policies (`policies`), named
factories (`registry`: ``get_controller("hpa", cfg, target=0.6)``),
policies x workloads in batch (`batch`) and named scenarios
(`scenarios`)."""
from repro_torch.scaling.api import (Controller, LimiterState,  # noqa: F401
                                     Obs, ScaleAction, apply_decision,
                                     limiter_init)
from repro_torch.scaling.registry import (available,  # noqa: F401
                                          get_controller)
