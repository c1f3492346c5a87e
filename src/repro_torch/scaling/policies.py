"""Autoscaling policies (port of ``repro.scaling.policies``).

* ``hpa_controller`` — paper §IV.C baseline: reactive, 70% CPU target,
  5-minute downscale stabilization window, 5-minute scale-down cooldown,
  +-10% tolerance band (Kubernetes semantics), with serverless
  scale-to-zero on sustained idle.

Only HPA is ported so far. Divisions by a hyperparameter are multiplies
by its f32 reciprocal, which is what XLA compiles the reference's
constant divisors to; the episode kernel does the same.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import _device
from repro_torch.scaling.api import Controller, Obs


class HPAState(NamedTuple):
    desired_buf: torch.Tensor  # [..., buf_len] recent desired counts
    last_total: torch.Tensor


def hpa_controller(cfg, *, target: float = 0.70,
                   stabilization_min: float = 5.0,
                   cooldown_min: float = 5.0,
                   tolerance: float = 0.10) -> Controller:
    # the one source of the hyperparameters: `decide` reads them here and
    # the episode kernel's launcher passes the same values to the card
    hyper = dict(
        target=target, tolerance=tolerance,
        inv_target=float(np.float32(1.0) / np.float32(target)),
        cooldown_sec=float(np.float32(cooldown_min * 60.0)),
        buf_len=max(int(stabilization_min * 60 / cfg.control_interval_sec),
                    1))

    def init(lanes: tuple[int, ...] = (), device="cuda"):
        dev = _device.resolve(device)
        init_r = float(cfg.initial_replicas)
        return HPAState(
            desired_buf=torch.full((*lanes, hyper["buf_len"]), init_r,
                                   dtype=torch.float32, device=dev),
            last_total=torch.full(lanes, init_r, dtype=torch.float32,
                                  device=dev))

    def on_minute(state, hist, minute_idx):
        return state

    def decide(state: HPAState, obs: Obs):
        ratio = obs.util_ema * hyper["inv_target"]
        in_band = (ratio - 1.0).abs() <= hyper["tolerance"]
        raw = torch.ceil(obs.ready_total * ratio)
        raw = torch.where(in_band, obs.ready_total, raw)
        # serverless scale-to-zero on sustained idle (Knative-style KPA);
        # the activator path below wakes the endpoint on traffic.
        idle = ((obs.util_ema < 0.02) & (obs.queue <= 0.0)
                & (obs.rate_rps <= 1e-6))
        raw = torch.where(idle, torch.zeros_like(raw), raw.clamp_min(1.0))
        wake = (obs.rate_rps > 0.0) | (obs.queue > 0.0)
        raw = torch.where(wake, raw.clamp_min(1.0), raw)
        buf = torch.cat([state.desired_buf[..., 1:], raw[..., None]], -1)
        # downscale stabilization: never below the window max
        stabilized = torch.maximum(raw, buf.amax(-1))
        desired = torch.where(raw >= obs.ready_total, raw, stabilized)
        return (HPAState(buf, desired), desired,
                torch.full_like(desired, hyper["cooldown_sec"]))

    return Controller("hpa", init, on_minute, decide, hyper=hyper)
