"""Algorithm 1: uncertainty-aware scaling adjustment (port of
``repro.core.uncertainty``, paper §III.C.3).

Given confidence c in [0,1] and base parameters:
    m        = 1 + 0.5 (1 - c)          # margin multiplier
    cpu_adj  = cpu_target (1 - 0.2 (1 - c))
    cool_adj = cool_base * m
    rep_adj  = ceil(rep_base * m)

Lower confidence => more conservative: lower CPU target (more headroom),
longer cooldown, more minimum replicas.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AdjustedParams(NamedTuple):
    target_cpu: torch.Tensor
    cooldown_min: torch.Tensor
    min_replicas: torch.Tensor


def margin_multiplier(confidence):
    return 1.0 + 0.5 * (1.0 - confidence)


def adjust(confidence, target_cpu, cooldown_min, min_replicas) -> AdjustedParams:
    """Algorithm 1 on tensors (the base parameters broadcast)."""
    c = torch.as_tensor(confidence, dtype=torch.float32).clamp(0.0, 1.0)
    m = margin_multiplier(c)
    cpu_adj = target_cpu * (1.0 - 0.2 * (1.0 - c))
    cool_adj = cooldown_min * m
    rep_adj = torch.ceil(min_replicas * m)
    return AdjustedParams(cpu_adj, cool_adj, rep_adj)
