"""Plain PyTorch versions of the port's CUDA kernels.

``kernels.ops`` runs these for CPU tensors; the tests hold them against
the JAX reference, and ``chip_smoke.py`` holds each kernel against its
plain version on the card. Nothing on the card's main path calls them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import features, forecasting, gbdt
from repro_torch.core.pipeline import Classify
from repro_torch.scaling import policies
from repro_torch.sim import cluster


def plant_block_ref(ready, pipeline, queue, wait_sum, util_ema, cooldown,
                    pipe_sum, arrivals, *, n_ticks: int,
                    rps_per_replica: float = 20.0, service_sec: float = 0.1,
                    slo_sec: float = 0.5, resp_cap_sec: float = 600.0,
                    metric_tau_sec: float = 60.0):
    """[B] plant lanes advanced `n_ticks` decision-free seconds:
    ``cluster.plant_block_ref`` with the plant constants as keywords.
    Returns ((ready, pipeline, queue, wait_sum, util_ema, cooldown,
    pipe_sum), 7 per-tick [B, n_ticks] tensors)."""
    cfg = cluster.SimConfig(rps_per_replica=rps_per_replica,
                            service_sec=service_sec, slo_sec=slo_sec,
                            resp_cap_sec=resp_cap_sec,
                            metric_tau_sec=metric_tau_sec)
    return cluster.plant_block_ref(cfg, ready, pipeline, queue, wait_sum,
                                   util_ema, cooldown, pipe_sum, arrivals,
                                   n_ticks=n_ticks)


def episode_block_ref(rates, controller, cfg):
    """rates [B, M] -> MinuteOut of [B, M]: the control-period-blocked
    ``cluster.simulate`` over all lanes at once, plant ticks in plain
    PyTorch, on the rates' own device. The controller's own `decide` and
    `on_minute` run; an AAPA or hybrid controller's GBDT classifier takes
    its logits from `gbdt_logits_ref`, so this launches no kernel on the
    card."""
    return cluster.simulate(rates, _plain_controller(controller, cfg), cfg,
                            device=rates.device, plant_kernel=False,
                            decide_kernel=False)


def _plain_controller(controller, cfg):
    """`controller`, or for an AAPA or hybrid controller with a GBDT
    classifier (``core.pipeline.Classify``) the same controller rebuilt on
    `cfg` (the episode kernel reads `cfg` too) with the classifier's
    logits from `gbdt_logits_ref`; its forecaster and band are the
    controller's own."""
    h = controller.hyper
    if (controller.name not in ("aapa", "hybrid")
            or not isinstance(h["classify"], Classify)):
        return controller
    return policies.rebuild(controller, cfg, classify=dataclasses.replace(
        h["classify"], logits=gbdt_logits_ref))


def holt_winters_ref(y, *, period: int = 60, alpha: float = 0.1,
                     beta: float = 0.01, gamma: float = 0.3):
    """[B, T] -> one-step-ahead forecasts [B, T]:
    ``core.forecasting.hw_smooth``."""
    return forecasting.hw_smooth(y, period=period, alpha=alpha, beta=beta,
                                 gamma=gamma)


def window_features_ref(windows):
    """[N, W] -> [N, 28]: ``core.features.stat_time_features``."""
    return features.stat_time_features(windows)


def extract_features_ref(windows):
    """[N, W] -> [N, 38]: ``core.features.extract_features``."""
    return features.extract_features(windows)


def gbdt_logits_ref(params, X):
    """[N, F] -> logits [N, K]: the plain node-table path
    ``core.gbdt.predict_logits``."""
    return gbdt.predict_logits(params, X)


def aapa_episode_ref(rates, controller, cfg):
    """`episode_block_ref` under an AAPA or hybrid controller, also
    returning the archetype each lane carries after each minute:
    (MinuteOut of [B, M], int32 [B, M]); the same blocked minute step
    `simulate` loops over."""
    controller = _plain_controller(controller, cfg)
    carry = (cluster.initial_state(controller, cfg, lanes=rates.shape[:1],
                                   device=rates.device), 0)
    outs, archs = [], []
    for m in range(rates.shape[1]):
        carry, out = cluster.minute_step(cfg, controller, carry,
                                         rates[:, m], use_kernel=False)
        outs.append(out)
        archs.append(carry[0].ctrl_state.arch)
    return (cluster.MinuteOut(*(torch.stack(f, -1) for f in zip(*outs))),
            torch.stack(archs, -1))
