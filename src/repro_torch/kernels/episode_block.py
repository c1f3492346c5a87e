"""``episode_block`` CUDA kernel: whole episodes, plant ticks and
``controller.decide`` in one launch (source ``csrc/episode_block.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/episode_block.py``
(``episode_minutes``). The TPU kernel took any controller by hoisting
its closure through a jaxpr; a CUDA kernel cannot, so each policy is a
device function chosen at compile time and the launcher is picked by the
controller's name: HPA, and AAPA with the Holt-Winters forecaster and
either a GBDT + beta-calibration classifier (``core.pipeline.Classify``)
or the registry's constant default. Plain version:
``kernels.ref.episode_block_ref``; ``kernels.ops.episode_block``
dispatches between the two by device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import calibration, features
from repro_torch.core.archetypes import table_iii_arrays
from repro_torch.core.pipeline import Classify
from repro_torch.forecast import api as fapi
from repro_torch.kernels import _build
from repro_torch.kernels.gbdt_tables import table_args
from repro_torch.sim.cluster import MinuteOut, recip

HISTORY = 60      # the AAPA policy's feature window (SimConfig.history_len)
TREND_WINDOW = 30


def _f32(v: float) -> float:
    return float(np.float32(v))


def _launch_hpa(ext, rates, out, cfg, hyper, ci, arch_out):
    del arch_out                      # HPA carries no archetype
    B = rates.shape[0]
    dev = rates.device
    pipe = torch.empty((cfg.startup_sec, B), dtype=torch.float32,
                       device=dev)
    buf = torch.empty((int(hyper["buf_len"]), B), dtype=torch.float32,
                      device=dev)
    ext.episode_block_hpa(
        rates, out, pipe, buf, ci, cfg.rps_per_replica, cfg.service_sec,
        cfg.slo_sec, cfg.resp_cap_sec, recip(cfg.metric_tau_sec),
        cfg.max_replicas, cfg.initial_replicas, hyper["inv_target"],
        hyper["tolerance"], hyper["cooldown_sec"])


def _launch_aapa(ext, rates, out, cfg, hyper, ci, arch_out):
    from repro_torch.scaling.registry import default_classify
    fcst, cls = hyper["forecaster"], hyper["classify"]
    if fcst.name != "holt_winters":
        raise NotImplementedError(
            f"episode_block's AAPA policy runs the holt_winters forecaster, "
            f"not {fcst.name!r}")
    if cfg.history_len != HISTORY:
        raise NotImplementedError(
            f"episode_block's AAPA policy takes history_len {HISTORY}, got "
            f"{cfg.history_len}")
    B = rates.shape[0]
    dev = rates.device
    if isinstance(cls, Classify):
        if cls.params.device != dev:
            raise ValueError(f"classifier on {cls.params.device}, rates on "
                             f"{dev}")
        tables = table_args(cls.params)
        coeffs = calibration.coefficients(cls.cal)
        kind = 1
    elif cls is default_classify:     # the kernel reads no table
        zf = torch.zeros(1, dtype=torch.float32, device=dev)
        zi = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        tables, coeffs = (zf, zi, zi, zf, zf), (zf, zf, zf)
        kind = 0
    else:
        raise NotImplementedError(
            "episode_block's AAPA policy takes core.pipeline.Classify or "
            "the registry's default_classify")
    hw = fcst.hyper
    period, horizon = int(hw["period"]), int(hyper["horizon_min"])
    tab = table_iii_arrays()
    tbar, tvar = features.trend_constants(TREND_WINDOW)
    inv_log_nb, inv_nb = features.freq_constants(HISTORY)
    fh = [*tab["target_cpu"], *tab["cooldown_min"], *tab["min_replicas"],
          *tab["warm_pool"], _f32(cfg.rps_per_replica),
          *(_f32(hw[k]) for k in ("alpha", "beta", "gamma")),
          *(_f32(1.0 - hw[k]) for k in ("alpha", "beta", "gamma")),
          _f32(fapi.RESID_RHO), _f32(fapi.NATIVE_Z),
          float(np.sqrt(np.float32(horizon))), tbar, tvar,
          _f32((TREND_WINDOW - 1) - tbar + horizon), inv_log_nb, inv_nb]
    ih = [int(hyper["stride_min"]), horizon,
          int(hyper["forecast_confidence"]), period, kind]
    pipe = torch.empty((cfg.startup_sec, B), dtype=torch.float32,
                       device=dev)
    scratch = torch.empty((HISTORY + period, B), dtype=torch.float32,
                          device=dev)
    if arch_out is None:
        arch_out = torch.empty(0, dtype=torch.int32, device=dev)
    ext.episode_block_aapa(
        rates, out, pipe, scratch, arch_out, ci, cfg.rps_per_replica,
        cfg.service_sec,
        cfg.slo_sec, cfg.resp_cap_sec, recip(cfg.metric_tau_sec),
        cfg.max_replicas, cfg.initial_replicas, fh, ih,
        features.dft_table(HISTORY, dev), *tables, *coeffs)


#: controller name -> launcher of its compiled policy
_POLICIES = {"hpa": _launch_hpa, "aapa": _launch_aapa}


def _launch(rates, controller, cfg, arch_out=None) -> MinuteOut:
    if rates.device.type != "cuda":
        raise ValueError("episode_block kernel needs a CUDA tensor, got "
                         f"{rates.device}")
    if (rates.dim() != 2 or rates.dtype != torch.float32
            or not rates.is_contiguous() or min(rates.shape) < 1):
        raise ValueError("rates: expected a non-empty contiguous float32 "
                         f"[B, M] tensor, got {tuple(rates.shape)} "
                         f"{rates.dtype}")
    launch = _POLICIES.get(controller.name)
    if launch is None:
        raise NotImplementedError(
            f"episode_block has no compiled policy {controller.name!r}; "
            f"compiled: {sorted(_POLICIES)}")
    B, M = rates.shape
    ci = max(min(int(cfg.control_interval_sec), 60), 1)
    out = torch.empty((12, B, M), dtype=torch.float32, device=rates.device)
    launch(_build.extension(), rates, out, cfg, controller.hyper, ci,
           arch_out)
    episode_block_cuda.launches += 1
    return MinuteOut(*out.unbind(0))


def episode_block_cuda(rates: torch.Tensor, controller, cfg) -> MinuteOut:
    """Launch the kernel: rates [B, M] (contiguous float32 on CUDA) ->
    MinuteOut of [B, M]. Raises on any other input or policy."""
    return _launch(rates, controller, cfg)


def aapa_episode_cuda(rates: torch.Tensor, controller, cfg):
    """The kernel under an AAPA controller, also returning the archetype
    each lane carries after each minute: (MinuteOut of [B, M], int32
    [B, M]). Counts as an episode_block launch."""
    if controller.name != "aapa":
        raise ValueError(f"archetypes need an aapa controller, got "
                         f"{controller.name!r}")
    arch = torch.empty(rates.shape, dtype=torch.int32, device=rates.device)
    return _launch(rates, controller, cfg, arch), arch


episode_block_cuda.launches = 0
