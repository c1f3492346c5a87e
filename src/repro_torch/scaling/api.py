"""Autoscaling control-plane protocol (port of ``repro.scaling.api``).

A controller is three functions on tensors whose leading dimensions are
lanes (one lane = one simulated workload; ``()`` is a single lane):

    init(lanes, device)                          -> ctrl_state
    on_minute(ctrl_state, rate_history, minute_idx) -> ctrl_state
    decide(ctrl_state, obs) -> (ctrl_state, desired_replicas, cooldown_sec)

and an optional telemetry hook, `explain(ctrl_state, obs) ->
repro_torch.obs.trace.ExplainOut`: the forecast, confidence and guard
signals behind the decision `decide` is about to make, read from the
pre-decide state (None: the policy reports no signals).

`hyper` carries the policy's hyperparameters for the fused episode
kernel (``repro_torch.kernels.episode_block``), whose `decide` is a CUDA
device function chosen by the controller's `name`.

`apply_decision` holds the scale-down cooldown semantics every backend
shares: scale-ups apply immediately, scale-downs only once the cooldown
requested by the previous scale-down has expired.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple

import torch


class Obs(NamedTuple):
    """What a controller sees at a control step."""
    ready_total: torch.Tensor   # ready + starting replicas
    ready: torch.Tensor         # ready replicas only
    util_ema: torch.Tensor      # 1-min aggregated CPU utilization
    queue: torch.Tensor         # queued requests
    rate_rps: torch.Tensor      # current arrival rate (req/s)
    rate_history: torch.Tensor  # [..., history_len] per-minute counts
    minute_idx: int             # global minute


class Controller(NamedTuple):
    """Pluggable autoscaling policy."""
    name: str
    init: Callable[..., Any]                 # (lanes, device) -> state
    on_minute: Callable[[Any, torch.Tensor, int], Any]
    decide: Callable[[Any, Obs], tuple[Any, torch.Tensor, torch.Tensor]]
    explain: Callable[[Any, Obs], Any] | None = None
    hyper: Mapping[str, float] = {}


class LimiterState(NamedTuple):
    """Scale-down rate-limiter state shared by every backend."""
    cooldown: torch.Tensor      # seconds until the next scale-down
    last_dir: torch.Tensor      # +1 / -1 / 0 last scaling direction


class ScaleAction(NamedTuple):
    add: torch.Tensor           # replicas to start now
    remove: torch.Tensor        # replicas to remove now
    scale_up: torch.Tensor      # bool
    scale_down: torch.Tensor    # bool
    oscillation: torch.Tensor   # f32 1.0 when direction flipped


def limiter_init(lanes: tuple[int, ...] = (), *,
                 device: str | torch.device = "cuda") -> LimiterState:
    z = torch.zeros(lanes, dtype=torch.float32, device=device)
    return LimiterState(cooldown=z, last_dir=z.clone())


def apply_decision(lim: LimiterState, total: torch.Tensor,
                   desired: torch.Tensor, cooldown_req: torch.Tensor,
                   do_ctrl: torch.Tensor | bool = True,
                   dt: float = 1.0) -> tuple[LimiterState, ScaleAction]:
    """Compare `desired` against the current `total` (ready + starting),
    honor the scale-down cooldown, and track direction flips (the
    oscillation metric). `do_ctrl` masks off-interval ticks; `dt` is the
    wall seconds since the last call."""
    scale_up = desired > total + 0.5
    scale_down = (desired < total - 0.5) & (lim.cooldown <= 0.0)
    if do_ctrl is not True:
        scale_up = scale_up & do_ctrl
        scale_down = scale_down & do_ctrl
    zero = torch.zeros_like(desired)
    add = torch.where(scale_up, desired - total, zero)
    remove = torch.where(scale_down, total - desired, zero)
    dir_now = torch.where(scale_up, 1.0,
                          torch.where(scale_down, -1.0, zero))
    osc = ((dir_now != 0.0) & (lim.last_dir != 0.0)
           & (dir_now != lim.last_dir)).to(torch.float32)
    last_dir = torch.where(dir_now != 0.0, dir_now, lim.last_dir)
    cooldown = torch.where(scale_down, cooldown_req,
                           (lim.cooldown - dt).clamp_min(0.0))
    return (LimiterState(cooldown=cooldown, last_dir=last_dir),
            ScaleAction(add=add, remove=remove, scale_up=scale_up,
                        scale_down=scale_down, oscillation=osc))
