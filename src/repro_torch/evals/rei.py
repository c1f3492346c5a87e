"""Resource Efficiency Index (paper §III.D), batched over tensors (port of
``repro.evals.rei``).

    REI = alpha * S_SLO + beta * S_eff + gamma * S_stab

Baselines are scenario-aware: S_eff normalizes pod-minutes by one pod per
workload for the episode length, S_stab normalizes actions by the
paper's 10 per workload-day prorated to the episode. minutes=1440,
n_workloads=1 reproduces the paper's §V.D constants (``PAPER_BASELINE_*``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import _device

DEFAULT_WEIGHTS = (0.5, 0.3, 0.2)
PAPER_BASELINE_POD_MINUTES = 1440.0   # one pod for one day (§V.D)
PAPER_BASELINE_ACTIONS = 10.0         # per workload-day
PAPER_DAY_MINUTES = 1440.0
EPS = 1e-9

SENSITIVITY_DELTAS = ((+1, -1, 0), (-1, +1, 0), (0, +1, -1),
                      (0, -1, +1), (+1, 0, -1), (-1, 0, +1))


class REIBreakdown(NamedTuple):
    s_slo: torch.Tensor
    s_eff: torch.Tensor
    s_stab: torch.Tensor
    rei: torch.Tensor


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=torch.float32)


def _infer_device(device, *xs) -> torch.device:
    if device is not None:
        return _device.resolve(device)
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return _device.resolve("cuda")


def scenario_baselines(minutes, n_workloads=1.0, *, device=None):
    """(baseline_pod_minutes, baseline_actions) for an episode of
    `minutes` over `n_workloads` workloads."""
    dev = _infer_device(device, minutes, n_workloads)
    scale = _f32(minutes, dev) / _f32(PAPER_DAY_MINUTES, dev)
    n = _f32(n_workloads, dev)
    return (PAPER_BASELINE_POD_MINUTES * scale * n,
            PAPER_BASELINE_ACTIONS * scale * n)


def rei(violation_rate, pod_minutes, scaling_actions, *,
        minutes=PAPER_DAY_MINUTES, n_workloads=1.0,
        baseline_pod_minutes=None, baseline_actions=None,
        weights=DEFAULT_WEIGHTS, device=None) -> REIBreakdown:
    """Batched REI; all inputs broadcast. `device` defaults to that of the
    first tensor input, and to CUDA (raising without it) when no input is
    a tensor."""
    dev = _infer_device(device, violation_rate, pod_minutes,
                        scaling_actions)
    bpm, bact = scenario_baselines(minutes, n_workloads, device=dev)
    if baseline_pod_minutes is not None:
        bpm = _f32(baseline_pod_minutes, dev)
    if baseline_actions is not None:
        bact = _f32(baseline_actions, dev)
    v = _f32(violation_rate, dev)
    pm = _f32(pod_minutes, dev)
    act = _f32(scaling_actions, dev)
    one = _device.const(1.0, dev)
    s_slo = (1.0 - v).clamp(0.0, 1.0)
    s_eff = (one / (pm / bpm.clamp_min(EPS)).clamp_min(EPS)).clamp(0.0, 1.0)
    s_stab = (one / (act / bact.clamp_min(EPS)).clamp_min(EPS)).clamp(
        0.0, 1.0)
    w = _f32(weights, dev)
    return REIBreakdown(s_slo, s_eff, s_stab,
                        w[..., 0] * s_slo + w[..., 1] * s_eff
                        + w[..., 2] * s_stab)


def sensitivity(violation_rate, pod_minutes, scaling_actions, *,
                delta: float = 0.05, weights=DEFAULT_WEIGHTS,
                **kw) -> REIBreakdown:
    """REI under the paper's 6 weight perturbations of +/- delta (§V.D):
    every field gains a leading [6] axis over `SENSITIVITY_DELTAS`."""
    a, b, g = weights
    base = rei(violation_rate, pod_minutes, scaling_actions,
               weights=(1.0, 0.0, 0.0), **kw)          # scores only
    ws = torch.tensor([[a + da * delta, b + db * delta, g + dg * delta]
                       for da, db, dg in SENSITIVITY_DELTAS],
                      dtype=torch.float32, device=base.s_slo.device)
    expand = (6,) + (1,) * base.s_slo.dim()
    s = REIBreakdown(*(x.expand((6,) + x.shape) for x in base))
    w0, w1, w2 = (ws[:, i].reshape(expand) for i in range(3))
    return REIBreakdown(s.s_slo, s.s_eff, s.s_stab,
                        w0 * s.s_slo + w1 * s.s_eff + w2 * s.s_stab)
