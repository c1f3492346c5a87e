"""Autoscaling policies (port of ``repro.scaling.policies``).

* ``hpa_controller`` — paper §IV.C baseline: reactive, 70% CPU target,
  5-minute downscale stabilization window, 5-minute scale-down cooldown,
  +-10% tolerance band (Kubernetes semantics), with serverless
  scale-to-zero on sustained idle.
* ``aapa_controller`` — the paper's system (§III.C): every 10 minutes,
  extract 38 features from the last 60 minutes, classify the archetype,
  beta-calibrate the confidence, adjust Table III parameters via
  Algorithm 1, and apply the archetype strategy.

``predictive``, ``kpa`` and ``hybrid`` are not ported yet. Divisions by
a constant are multiplies by its f32 reciprocal, which is what XLA
compiles the reference's constant divisors to; the episode kernel does
the same. Each controller's `hyper` dict is the one source of its
hyperparameters: `decide`/`on_minute` read them there and the episode
kernel's launcher passes the same values to the card.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import _device
from repro_torch._numerics import recip, xla_sum
from repro_torch.core import features as F
from repro_torch.core import forecasting as fc
from repro_torch.core import uncertainty
from repro_torch.core.archetypes import table_iii_arrays
from repro_torch.forecast import api as fapi
from repro_torch.forecast import registry as forecast_registry
from repro_torch.scaling.api import Controller, Obs


def _select4(idx, v0, v1, v2, v3):
    """4-way archetype select, ``table[idx]`` as three selects (the form
    the episode kernel's ``select4`` takes)."""
    return torch.where(idx == 0, v0,
                       torch.where(idx == 1, v1,
                                   torch.where(idx == 2, v2, v3)))


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


# ------------------------------------------------------------------ AAPA ----
class AAPAState(NamedTuple):
    fc: fapi.FState             # named forecaster carry (PERIODIC strategy)
    arch: torch.Tensor          # int32 current archetype
    conf: torch.Tensor          # f32 effective confidence fed to Algorithm 1
    cpu_adj: torch.Tensor
    cool_adj_min: torch.Tensor
    minrep_adj: torch.Tensor


def aapa_controller(
        cfg,
        classify: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
        *, stride_min: int = 10, horizon_min: int = 15,
        forecaster="holt_winters", band=None,
        forecast_confidence: bool | None = None) -> Controller:
    """`classify(features [..., 38]) -> (class id int32 [...], confidence
    f32 [...])`, typically GBDT + beta calibration
    (``core.pipeline.TrainedAAPA.make_classify``).

    The predictive strategy runs any registered forecaster (by name or
    instance). With `forecast_confidence` on, Algorithm 1's confidence is
    the classifier's times the forecaster's interval confidence (the
    residual-EWMA native band). The calibrated conformal `band` of the
    reference is not ported yet, so `band` must be None and
    `forecast_confidence=None` means off."""
    if band is not None:
        raise NotImplementedError(
            "the conformal band (repro.forecast.conformal) is not ported yet")
    hyper = dict(stride_min=int(stride_min), horizon_min=int(horizon_min),
                 forecaster=forecast_registry.make(forecaster),
                 forecast_confidence=bool(forecast_confidence),
                 classify=classify, table=table_iii_arrays())

    def init(lanes: tuple[int, ...] = (), device="cuda"):
        dev = _device.resolve(device)
        full = lambda v, dt=torch.float32: torch.full(  # noqa: E731
            lanes, v, dtype=dt, device=dev)
        return AAPAState(fc=hyper["forecaster"].init(lanes, dev),
                         arch=full(2, torch.int32),      # start conservative
                         conf=full(0.5), cpu_adj=full(0.5),
                         cool_adj_min=full(5.0), minrep_adj=full(1.0))

    def on_minute(state: AAPAState, hist, minute_idx):
        fcst, tab = hyper["forecaster"], hyper["table"]
        fst = fcst.update(state.fc, hist[..., -1])
        if int(minute_idx) % hyper["stride_min"]:
            return state._replace(fc=fst)
        arch, conf = hyper["classify"](F.extract_features(hist))
        if hyper["forecast_confidence"]:
            iv = fcst.forecast(fst, hyper["horizon_min"])
            conf = conf * fapi.interval_confidence(iv)
        adj = uncertainty.adjust(conf, _select4(arch, *tab["target_cpu"]),
                                 _select4(arch, *tab["cooldown_min"]),
                                 _select4(arch, *tab["min_replicas"]))
        return AAPAState(fst, arch, conf, adj.target_cpu, adj.cooldown_min,
                         adj.min_replicas)

    def decide(state: AAPAState, obs: Obs):
        fcst, tab = hyper["forecaster"], hyper["table"]
        horizon = hyper["horizon_min"]
        cpu = state.cpu_adj.clamp_min(0.05)
        cap = cfg.rps_per_replica * cpu
        # reactive component (archetype-specific utilization target)
        ratio = obs.util_ema / cpu
        reactive = torch.ceil(obs.ready_total * ratio)
        reactive = torch.where((ratio - 1.0).abs() <= 0.1, obs.ready_total,
                               reactive)

        # strategy components (paper Table III)
        warm = _select4(state.arch, *tab["warm_pool"])
        need_now = torch.ceil(obs.rate_rps / cap)
        spike_d = need_now + warm + state.minrep_adj

        fc_pred = fcst.forecast(state.fc, horizon).point.clamp_min(
            0.0) * recip(60.0)
        periodic_d = torch.ceil(fc_pred / cap)

        trend_pred = fc.linear_trend_forecast(
            obs.rate_history[..., -30:], horizon) * recip(60.0)
        ramp_d = torch.ceil(torch.maximum(trend_pred, obs.rate_rps) / cap)

        mean_rps = xla_sum(obs.rate_history[..., -15:]) * recip(
            15.0) * recip(60.0)
        stat_d = torch.ceil(mean_rps / cap)

        strat = _select4(state.arch, periodic_d, spike_d, stat_d, ramp_d)
        desired = torch.maximum(torch.maximum(reactive, strat),
                                state.minrep_adj.clamp_min(1.0))
        return state, desired, state.cool_adj_min * 60.0

    return Controller("aapa", init, on_minute, decide, hyper=hyper)
