"""``episode_block`` CUDA kernel: whole episodes, plant ticks and
``controller.decide`` in one launch (source ``csrc/episode_block.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/episode_block.py``
(``episode_minutes``). The TPU kernel took any controller by hoisting
its closure through a jaxpr; a CUDA kernel cannot, so each policy is a
device function chosen at compile time and the launcher is picked by the
controller's name: all five registered policies (HPA, predictive, KPA,
AAPA, hybrid). The forecasting policies take the Holt-Winters forecaster,
native or with a conformal band (read from the forecaster's `hyper`);
AAPA and hybrid classify with a GBDT + beta-calibration classifier
(``core.pipeline.Classify``) or the registry's constant default. Plain
version: ``kernels.ref.episode_block_ref``; ``kernels.ops.episode_block``
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


def _plant_args(cfg) -> tuple[float, ...]:
    """SimConfig's plant constants in the order every launcher takes
    them."""
    return (cfg.rps_per_replica, cfg.service_sec, cfg.slo_sec,
            cfg.resp_cap_sec, recip(cfg.metric_tau_sec), cfg.max_replicas,
            cfg.initial_replicas)


def _launch_hpa(ext, rates, out, cfg, hyper, ci, arch_out):
    del arch_out                      # HPA carries no archetype
    B = rates.shape[0]
    dev = rates.device
    pipe = torch.empty((cfg.startup_sec, B), dtype=torch.float32,
                       device=dev)
    buf = torch.empty((int(hyper["buf_len"]), B), dtype=torch.float32,
                      device=dev)
    ext.episode_block_hpa(
        rates, out, pipe, buf, ci, *_plant_args(cfg), hyper["inv_target"],
        hyper["tolerance"], hyper["cooldown_sec"])


def _holt_winters(fcst, horizon: int) -> tuple[dict, int, float, float]:
    """A forecasting policy's forecaster as the kernel takes it: (the
    Holt-Winters hyperparameters, use_band, band_q, sqrt_h). The interval
    half-width is q * sqrt_h with a conformal band (the outermost `wrap`'s,
    the one the forecaster's `forecast` applies; sqrt_h is 1 for a band
    that does not widen), z * resid * sqrt_h without. Raises for any
    forecaster but Holt-Winters."""
    inner = fcst
    while "inner" in inner.hyper:
        inner = inner.hyper["inner"]
    if inner.name != "holt_winters":
        raise NotImplementedError(
            f"episode_block's forecasting policies run the holt_winters "
            f"forecaster, not {fcst.name!r}")
    band = fcst.hyper.get("band")
    sqrt_h = float(np.sqrt(np.float32(horizon)))
    if band is None:
        return inner.hyper, 0, 0.0, sqrt_h
    if not fcst.hyper["widen_with_horizon"]:
        sqrt_h = 1.0
    return inner.hyper, 1, float(band.q), sqrt_h


def _hw_floats(hw) -> list[float]:
    """alpha, beta, gamma and 1 - each as the in-episode forecaster takes
    them: Python floats rounded to f32 (hw_step), and RESID_RHO."""
    return [*(_f32(hw[k]) for k in ("alpha", "beta", "gamma")),
            *(_f32(1.0 - hw[k]) for k in ("alpha", "beta", "gamma")),
            _f32(fapi.RESID_RHO)]


def _launch_aapa(ext, rates, out, cfg, hyper, ci, arch_out, guard=()):
    from repro_torch.scaling.registry import default_classify
    horizon = int(hyper["horizon_min"])
    hw, use_band, band_q, sqrt_h = _holt_winters(hyper["forecaster"],
                                                 horizon)
    scale = hyper["conf_scale"]
    cls = hyper["classify"]
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
    period = int(hw["period"])
    tab = table_iii_arrays()
    tbar, tvar = features.trend_constants(TREND_WINDOW)
    inv_log_nb, inv_nb = features.freq_constants(HISTORY)
    fh = [*tab["target_cpu"], *tab["cooldown_min"], *tab["min_replicas"],
          *tab["warm_pool"], _f32(cfg.rps_per_replica), *_hw_floats(hw),
          _f32(fapi.NATIVE_Z), sqrt_h, tbar, tvar,
          _f32((TREND_WINDOW - 1) - tbar + horizon), inv_log_nb, inv_nb,
          band_q, 0.0 if scale is None else float(scale)]
    ih = [int(hyper["stride_min"]), horizon,
          int(hyper["forecast_confidence"]), period, kind, use_band,
          int(scale is not None)]
    pipe = torch.empty((cfg.startup_sec, B), dtype=torch.float32,
                       device=dev)
    scratch = torch.empty((HISTORY + period, B), dtype=torch.float32,
                          device=dev)
    if arch_out is None:
        arch_out = torch.empty(0, dtype=torch.int32, device=dev)
    ext.episode_block_aapa(
        rates, out, pipe, scratch, arch_out, ci, *_plant_args(cfg), fh, ih,
        list(guard), *features.fft_tables(HISTORY, dev), *tables, *coeffs)


def _launch_hybrid(ext, rates, out, cfg, hyper, ci, arch_out):
    _launch_aapa(ext, rates, out, cfg, hyper, ci, arch_out,
                 guard=(hyper["inv_guard"], hyper["inv_rps_guard"],
                        hyper["down_keep"]))


def _launch_predictive(ext, rates, out, cfg, hyper, ci, arch_out):
    del arch_out                      # predictive carries no archetype
    horizon = int(hyper["horizon_min"])
    hw, use_band, band_q, sqrt_h = _holt_winters(hyper["forecaster"],
                                                 horizon)
    period = int(hw["period"])
    fh = [*_hw_floats(hw), _f32(fapi.NATIVE_Z), sqrt_h, band_q,
          hyper["inv_cap"], hyper["cooldown_sec"]]
    ih = [period, horizon, use_band, int(hyper["conservative"])]
    B, dev = rates.shape[0], rates.device
    pipe = torch.empty((cfg.startup_sec, B), dtype=torch.float32,
                       device=dev)
    season = torch.empty((period, B), dtype=torch.float32, device=dev)
    ext.episode_block_predictive(rates, out, pipe, season, ci,
                                 *_plant_args(cfg), fh, ih)


def _launch_kpa(ext, rates, out, cfg, hyper, ci, arch_out):
    del arch_out                      # kpa carries no archetype
    fh = [hyper[k] for k in ("service_sec", "a_s", "a_p", "inv_tgt")] + [
        _f32(hyper[k]) for k in ("panic_threshold", "stable_window_s",
                                 "dt")] + [hyper["cooldown_sec"]]
    pipe = torch.empty((cfg.startup_sec, rates.shape[0]),
                       dtype=torch.float32, device=rates.device)
    ext.episode_block_kpa(rates, out, pipe, ci, *_plant_args(cfg), fh)


#: controller name -> launcher of its compiled policy
_POLICIES = {"hpa": _launch_hpa, "predictive": _launch_predictive,
             "kpa": _launch_kpa, "aapa": _launch_aapa,
             "hybrid": _launch_hybrid}

#: the policies that carry an archetype
ARCHETYPE_POLICIES = ("aapa", "hybrid")


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
    """The kernel under an AAPA or hybrid controller, also returning the
    archetype each lane carries after each minute: (MinuteOut of [B, M],
    int32 [B, M]). Counts as an episode_block launch."""
    if controller.name not in ARCHETYPE_POLICIES:
        raise ValueError(f"archetypes need an aapa or hybrid controller, "
                         f"got {controller.name!r}")
    arch = torch.empty(rates.shape, dtype=torch.int32, device=rates.device)
    return _launch(rates, controller, cfg, arch), arch


episode_block_cuda.launches = 0
