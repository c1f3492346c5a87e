"""Resource Efficiency Index (paper §III.D) — scalar front-end (port of
``repro.core.rei``).

    REI = alpha * S_SLO + beta * S_eff + gamma * S_stab

S_SLO = 1 - violation_rate, S_eff = 1 / normalized pod-minutes, S_stab =
1 / normalized scaling actions, each clipped into [0, 1]. The math lives
in ``repro_torch.evals.rei``; this module keeps the float dataclass API
for scalar callers. Like every entry point of the port it computes on
the card unless `device` says otherwise (``device="cpu"`` runs the same
math in plain PyTorch on the CPU). Defaults minutes=1440, n_workloads=1
are the paper's §V.D one-pod-day constants.
"""
from __future__ import annotations

import dataclasses

from repro_torch import _device
from repro_torch.evals import rei as batched

DEFAULT_WEIGHTS = batched.DEFAULT_WEIGHTS


@dataclasses.dataclass(frozen=True)
class REIBreakdown:
    s_slo: float
    s_eff: float
    s_stab: float
    rei: float


def rei(violation_rate: float, pod_minutes: float, scaling_actions: float,
        *, minutes: float = 1440.0, n_workloads: float = 1.0,
        baseline_pod_minutes: float | None = None,
        baseline_actions: float | None = None,
        weights: tuple[float, float, float] = DEFAULT_WEIGHTS,
        device="cuda") -> REIBreakdown:
    """REI for one cell (baselines default from the episode shape)."""
    b = batched.rei(violation_rate, pod_minutes, scaling_actions,
                    minutes=minutes, n_workloads=n_workloads,
                    baseline_pod_minutes=baseline_pod_minutes,
                    baseline_actions=baseline_actions, weights=weights,
                    device=_device.resolve(device))
    return REIBreakdown(float(b.s_slo), float(b.s_eff), float(b.s_stab),
                        float(b.rei))


def sensitivity(violation_rate, pod_minutes, scaling_actions,
                delta: float = 0.05, *, device="cuda",
                **kw) -> list[REIBreakdown]:
    """REI under weight perturbations of +/- delta (paper §V.D)."""
    out = batched.sensitivity(violation_rate, pod_minutes, scaling_actions,
                              delta=delta, device=_device.resolve(device),
                              **kw)
    return [REIBreakdown(float(out.s_slo[i]), float(out.s_eff[i]),
                         float(out.s_stab[i]), float(out.rei[i]))
            for i in range(len(batched.SENSITIVITY_DELTAS))]
