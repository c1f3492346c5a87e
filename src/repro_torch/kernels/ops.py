"""Kernel dispatch by the tensors' device.

CUDA tensors go to the hand-written kernel (``plant_block``,
``episode_block`` with its pre-pass ``policy_signals``,
``window_features``, ``gbdt_tables``, ``holt_winters``), CPU tensors to
its plain PyTorch version (``kernels.ref``), which is the only CPU path.
Any other device raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import episode_block as _episode
from repro_torch.kernels import gbdt_tables as _gbdt
from repro_torch.kernels import holt_winters as _hw
from repro_torch.kernels import plant_block as _plant
from repro_torch.kernels import policy_signals as _signals
from repro_torch.kernels import ref
from repro_torch.kernels import window_features as _wf

#: every kernel launcher, by kernel name (each counts its own launches)
LAUNCHERS = {"plant_block": _plant.plant_tick_block_cuda,
             "episode_block": _episode.episode_block_cuda,
             "policy_signals": _signals.policy_signals_cuda,
             "window_features": _wf.window_features_cuda,
             "gbdt_tables": _gbdt.gbdt_logits_cuda,
             "holt_winters": _hw.holt_winters_cuda}


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain path for device {t.device}")
    return t.device.type


def plant_tick_block(ready, pipeline, queue, wait_sum, util_ema, cooldown,
                     pipe_sum, arrivals, *, n_ticks: int,
                     rps_per_replica: float = 20.0,
                     service_sec: float = 0.1, slo_sec: float = 0.5,
                     resp_cap_sec: float = 600.0,
                     metric_tau_sec: float = 60.0):
    """Advance [B] plant lanes a whole decision-free control period.
    Contract of ``cluster.plant_block_ref``: (state tuple, [B, T] ticks)."""
    fn = (_plant.plant_tick_block_cuda if _route(ready) == "cuda"
          else ref.plant_block_ref)
    return fn(ready, pipeline, queue, wait_sum, util_ema, cooldown,
              pipe_sum, arrivals, n_ticks=n_ticks,
              rps_per_replica=rps_per_replica, service_sec=service_sec,
              slo_sec=slo_sec, resp_cap_sec=resp_cap_sec,
              metric_tau_sec=metric_tau_sec)


def episode_block(rates, controller, cfg):
    """Whole episodes: rates [B, M] -> MinuteOut of [B, M]; on the card
    the policy's pre-pass (predictive, AAPA, hybrid), then plant ticks and
    `controller.decide` inside one kernel launch."""
    fn = (_episode.episode_block_cuda if _route(rates) == "cuda"
          else ref.episode_block_ref)
    return fn(rates, controller, cfg)


def policy_signals(rates, controller, cfg):
    """What the minute hooks of a predictive, AAPA or hybrid controller
    give decide, from rates [B, M] alone: ``policy_signals.Signals``."""
    fn = (_signals.policy_signals_cuda if _route(rates) == "cuda"
          else ref.policy_signals_ref)
    return fn(rates, controller, cfg)


def window_features(windows: torch.Tensor) -> torch.Tensor:
    """[N, W] -> the 28 stat/time features [N, 28]."""
    fn = (_wf.window_features_cuda if _route(windows) == "cuda"
          else ref.window_features_ref)
    return fn(windows)


def extract_features_fused(windows: torch.Tensor) -> torch.Tensor:
    """All 38 AAPA features [N, 38]: one `window_features` launch that
    also computes the 10 frequency features (the AAPA episode kernel's
    own feature code)."""
    if _route(windows) == "cuda":
        return _wf.window_features_cuda(windows, freq=True)
    return ref.extract_features_ref(windows)


def gbdt_logits(params, X: torch.Tensor) -> torch.Tensor:
    """GBDT logits [N, K] from raw features X [N, F]; `params` is a
    ``core.gbdt.GBDTParams`` on X's device."""
    fn = (_gbdt.gbdt_logits_cuda if _route(X) == "cuda"
          else ref.gbdt_logits_ref)
    return fn(params, X)


def holt_winters(y: torch.Tensor, *, period: int = 60, alpha: float = 0.1,
                 beta: float = 0.01, gamma: float = 0.3) -> torch.Tensor:
    """One-step-ahead Holt-Winters forecasts: y [B, T] -> [B, T]."""
    fn = (_hw.holt_winters_cuda if _route(y) == "cuda"
          else ref.holt_winters_ref)
    return fn(y, period=period, alpha=alpha, beta=beta, gamma=gamma)


def launch_counts() -> dict[str, int]:
    """Launches by kernel since the last reset. The pre-pass's own counts
    (``policy_signals_cuda.by_walk``, ``reclassify_cuda.launches``) are
    read on their wrappers."""
    return {name: fn.launches for name, fn in LAUNCHERS.items()}


def reset_launch_counts() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0
    _signals.policy_signals_cuda.by_walk = {}
    _signals.reclassify_cuda.launches = 0
