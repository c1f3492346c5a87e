"""Workload archetypes (port of ``repro.core.archetypes``; the enum only).

Class ids follow the paper's Table IV ordering:
    0 = PERIODIC, 1 = SPIKE, 2 = STATIONARY_NOISY, 3 = RAMP
"""
from __future__ import annotations

import enum

N_CLASSES = 4


class Archetype(enum.IntEnum):
    PERIODIC = 0
    SPIKE = 1
    STATIONARY_NOISY = 2
    RAMP = 3


ARCHETYPE_NAMES = ["PERIODIC", "SPIKE", "STATIONARY_NOISY", "RAMP"]
