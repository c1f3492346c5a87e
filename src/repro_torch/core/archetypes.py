"""Workload archetypes and the paper's Table III scaling parameters (port
of ``repro.core.archetypes``).

Class ids follow the paper's Table IV ordering:
    0 = PERIODIC, 1 = SPIKE, 2 = STATIONARY_NOISY, 3 = RAMP
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np

N_CLASSES = 4


class Archetype(enum.IntEnum):
    PERIODIC = 0
    SPIKE = 1
    STATIONARY_NOISY = 2
    RAMP = 3


ARCHETYPE_NAMES = ["PERIODIC", "SPIKE", "STATIONARY_NOISY", "RAMP"]


@dataclasses.dataclass(frozen=True)
class ScalingParams:
    """One column of the paper's Table III."""

    target_cpu: float        # utilization target in [0, 1]
    cooldown_min: float      # scale-down cooldown, minutes
    min_replicas: int
    strategy: str            # 'warm_pool' | 'predictive' | 'trend' | 'conservative'
    warm_pool: int = 0       # extra always-on pods beyond demand (spike only)


# Paper Table III, indexed by Archetype value.
TABLE_III: dict[Archetype, ScalingParams] = {
    Archetype.PERIODIC: ScalingParams(0.75, 3.0, 1, "predictive"),
    Archetype.SPIKE: ScalingParams(0.30, 20.0, 2, "warm_pool", warm_pool=2),
    Archetype.STATIONARY_NOISY: ScalingParams(0.55, 12.0, 1, "conservative"),
    Archetype.RAMP: ScalingParams(0.60, 7.0, 1, "trend"),
}


def table_iii_arrays() -> dict[str, tuple[float, float, float, float]]:
    """Table III by class id, each column as 4 f32 values (Python floats
    exactly representable in f32), the operands of ``policies._select4``
    and the episode kernel's AAPA policy."""
    order = [Archetype.PERIODIC, Archetype.SPIKE,
             Archetype.STATIONARY_NOISY, Archetype.RAMP]

    def col(field):
        return tuple(float(np.float32(getattr(TABLE_III[a], field)))
                     for a in order)

    return {"target_cpu": col("target_cpu"),
            "cooldown_min": col("cooldown_min"),
            "min_replicas": col("min_replicas"),
            "warm_pool": col("warm_pool")}
