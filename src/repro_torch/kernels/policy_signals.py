"""``policy_signals`` CUDA kernels: the pre-pass of the predictive, AAPA
and hybrid episodes (source ``csrc/policy_signals.cu``).

A policy's minute hook reads only the input rates (``cluster.
_finish_minute`` hands ``on_minute`` the rate history), so what the hook
gives ``decide`` is a function of the rates and the hyperparameters
alone: the forecaster's peak forecast (predictive: the replicas it
needs), and AAPA's and hybrid's 30-minute trend, 15-minute mean and, at
each reclassification, the archetype and Algorithm 1's parameters. The
pre-pass computes them for every lane and minute, in parallel where the
work is independent (a reclassification is one window,
`reclassify_cuda`), before the episode kernel's plant pass
(``kernels.episode_block``) reads them.
Every registry forecaster (Holt-Winters, linear trend, seasonal naive,
EWMA), band-wrapped or not, runs as a template of the minute walks; its
hyperparameters are run-time arguments (`forecaster_args`).

Plain version: ``kernels.ref.policy_signals_ref``;
``kernels.ops.policy_signals`` dispatches between the two by device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch._numerics import recip
from repro_torch.core import calibration, features
from repro_torch.core.archetypes import table_iii_arrays
from repro_torch.core.pipeline import Classify
from repro_torch.forecast import api as fapi
from repro_torch.kernels import _build
from repro_torch.kernels import window_features as _wf
from repro_torch.kernels.gbdt_tables import (SHARED_TABLE_MAX,
                                             shared_table_bytes, table_args)

TREND_WINDOW = 30
#: the AAPA policy's feature windows (SimConfig.history_len) the pre-pass
#: takes: from the trend's 30 minutes, which the minute walks read from the
#: history's end, to the widest window_features kernel
MIN_HISTORY, MAX_HISTORY = TREND_WINDOW, _wf.MAX_W

#: the policies whose episodes run the pre-pass
POLICIES = ("predictive", "aapa", "hybrid")


class Signals(NamedTuple):
    """What a policy's minute hook gives decide, for B lanes and M
    minutes, laid out [minute or slot, lane] as the plant pass reads it.

    `rps` [K, M, B] float32: what decide reads during minute m, per
    second (AAPA and hybrid: fc_rps, trend_rps, mean_rps of
    ``policies.aapa_rate_signals``; predictive: need_pred of
    ``policies.predictive_need``). AAPA and hybrid only: `arch` [R, B]
    int32 and `adj` [3, R, B] float32 (cpu_adj, cool_adj_min, minrep_adj),
    the archetype and Algorithm 1's parameters in effect from minute
    r * stride_min (slot 0: the initial state), R = `n_slots(M, stride)`;
    and when asked, `minute_arch` [B, M] int32, the archetype each lane
    carries after each minute."""
    rps: torch.Tensor
    arch: torch.Tensor | None = None
    adj: torch.Tensor | None = None
    minute_arch: torch.Tensor | None = None


def n_slots(M: int, stride: int) -> int:
    """Reclassification slots of an M-minute episode: the initial state
    and one every `stride` minutes up to the hook after the last minute."""
    return M // stride + 1


def _f32(v: float) -> float:
    return float(np.float32(v))


#: the forecasters the minute walks run, by registry name: their kind
#: (kernels.h FcKind)
FORECASTERS = {"holt_winters": 0, "linear_trend": 1, "seasonal_naive": 2,
               "ewma": 3}


class ForecasterArgs(NamedTuple):
    """A forecasting policy's forecaster as the pre-pass takes it: its
    kind and scratch rows (`fc_i`), its run-time floats (`fc_f`: the
    residual EWMA rate, Holt-Winters' six coefficients, the EWMA's alpha,
    linear trend's 1/window, tbar, tvar and steps to h = 1 and to the
    horizon), and its interval: half-width band_q * sqrt_h with a
    conformal band (the outermost `wrap`'s, the one the forecaster's
    `forecast` applies; sqrt_h is 1 for a band that does not widen),
    z * resid * sqrt_h without."""
    fc_f: list
    fc_i: list
    use_band: int
    band_q: float
    sqrt_h: float

    @property
    def slots(self) -> int:
        return self.fc_i[1]


def _unwrapped(fcst):
    """The forecaster inside any conformal wraps."""
    while "inner" in fcst.hyper:
        fcst = fcst.hyper["inner"]
    return fcst


def forecaster_args(fcst, horizon: int) -> ForecasterArgs:
    """Any registry forecaster, band-wrapped or not, as the kernels take
    it. Raises for a forecaster that is not one of the registry's."""
    from repro_torch.forecast import registry
    inner = _unwrapped(fcst)
    hyper = dict(inner.hyper)
    if (inner.name not in FORECASTERS
            or inner.name not in registry.available()
            or set(hyper) != set(registry.spec(inner.name).defaults)):
        raise NotImplementedError(
            f"episode_block's forecasting policies run the registry's "
            f"forecasters {sorted(FORECASTERS)}, not {fcst.name!r}")
    kind = FORECASTERS[inner.name]
    hw = [0.0] * 6
    alpha, lt = 0.0, [0.0] * 5
    if inner.name == "holt_winters":
        slots = int(hyper["period"])
        hw = [*(_f32(hyper[k]) for k in ("alpha", "beta", "gamma")),
              *(_f32(1.0 - hyper[k]) for k in ("alpha", "beta", "gamma"))]
    elif inner.name == "seasonal_naive":
        slots = int(hyper["period"])
    elif inner.name == "linear_trend":
        slots = int(hyper["window"])
        tbar, tvar = features.trend_constants(slots)
        lt = [recip(slots), tbar, tvar, _f32((slots - 1) - tbar + 1),
              _f32((slots - 1) - tbar + horizon)]
    else:
        slots = 0
        alpha = _f32(hyper["alpha"])
    if inner.name != "ewma" and slots < 1:
        raise ValueError(f"{inner.name}: {slots} scratch slots")
    fc_f = [_f32(fapi.RESID_RHO), *hw, alpha, *lt]
    band = fcst.hyper.get("band")
    sqrt_h = float(np.sqrt(np.float32(horizon)))
    if band is None:
        return ForecasterArgs(fc_f, [kind, slots], 0, 0.0, sqrt_h)
    if not fcst.hyper["widen_with_horizon"]:
        sqrt_h = 1.0
    return ForecasterArgs(fc_f, [kind, slots], 1, float(band.q), sqrt_h)


def _check_rates(rates: torch.Tensor) -> None:
    if rates.device.type != "cuda":
        raise ValueError("the episode kernels need a CUDA tensor, got "
                         f"{rates.device}")
    if (rates.dim() != 2 or rates.dtype != torch.float32
            or not rates.is_contiguous() or min(rates.shape) < 1):
        raise ValueError("rates: expected a non-empty contiguous float32 "
                         f"[B, M] tensor, got {tuple(rates.shape)} "
                         f"{rates.dtype}")


def reclassify_cuda(rates: torch.Tensor, classify: Classify, stride: int,
                    history_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the AAPA and hybrid reclassifications: for every lane b of
    rates [B, M] (contiguous float32 on CUDA, M >= stride) and slot r in
    [1, R), R = `n_slots(M, stride)`, the window of `history_len` minutes
    before minute r * stride (zeros before minute 0) through `classify`
    -> (archetype int32 [B, R - 1], confidence [B, R - 1]), slot r at
    column r - 1. The window_features kernel chosen by `history_len`
    reads the windows in place from the rates, gbdt_tables' kernel takes
    their 38 features, a third kernel calibrates. Raises on any other
    input."""
    _check_rates(rates)
    if classify.params.device != rates.device:
        raise ValueError(f"classifier on {classify.params.device}, rates on "
                         f"{rates.device}")
    B, M = rates.shape
    R = n_slots(M, stride)
    if R < 2 or not 4 <= history_len <= _wf.MAX_W:
        raise ValueError(f"reclassify: {M} minutes at stride {stride} and "
                         f"windows of {history_len}: expected a slot and "
                         f"4 <= history_len <= {_wf.MAX_W}")
    dev = rates.device
    N = B * (R - 1)
    f32 = dict(dtype=torch.float32, device=dev)
    arch = torch.empty((B, R - 1), dtype=torch.int32, device=dev)
    conf = torch.empty((B, R - 1), **f32)
    params = classify.params
    shared = shared_table_bytes(params.tables.feat.shape[0],
                                params.depth) <= SHARED_TABLE_MAX
    _build.extension().reclassify(
        rates, torch.empty((N, features.N_FEATURES), **f32),
        torch.empty((N, 4), **f32), arch, conf, stride, history_len,
        *features.fft_tables(history_len, dev),
        *features.freq_constants(history_len),
        _wf.VARIANTS.index(_wf.choose_variant(history_len)),
        *table_args(params), shared,
        *calibration.coefficients(classify.cal))
    reclassify_cuda.launches += 1
    reclassify_cuda.last_variant = _wf.choose_variant(history_len)
    return arch, conf


reclassify_cuda.launches = 0
reclassify_cuda.last_variant = None


def _aapa(ext, rates, hyper, cfg, minute_arch: bool) -> Signals:
    from repro_torch.scaling.registry import default_classify
    horizon = int(hyper["horizon_min"])
    fa = forecaster_args(hyper["forecaster"], horizon)
    scale = hyper["conf_scale"]
    cls = hyper["classify"]
    H = int(cfg.history_len)
    if not MIN_HISTORY <= H <= MAX_HISTORY:
        raise NotImplementedError(
            f"episode_block's AAPA policy takes history_len {MIN_HISTORY} "
            f"to {MAX_HISTORY}, got {H}")
    if not (isinstance(cls, Classify) or cls is default_classify):
        raise NotImplementedError(
            "episode_block's AAPA policy takes core.pipeline.Classify or "
            "the registry's default_classify")
    B, M = rates.shape
    dev = rates.device
    stride = int(hyper["stride_min"])
    R = n_slots(M, stride)
    kind = int(isinstance(cls, Classify))
    if kind and R > 1:
        cls_arch, cls_conf = reclassify_cuda(rates, cls, stride, H)
    else:                                # the walk reads no classification
        cls_arch = torch.empty((B, R - 1), dtype=torch.int32, device=dev)
        cls_conf = torch.empty((B, R - 1), dtype=torch.float32, device=dev)
    tab = table_iii_arrays()
    tbar, tvar = features.trend_constants(TREND_WINDOW)
    fh = [*tab["target_cpu"], *tab["cooldown_min"], *tab["min_replicas"],
          _f32(fapi.NATIVE_Z), fa.sqrt_h, tbar, tvar,
          _f32((TREND_WINDOW - 1) - tbar + horizon), fa.band_q,
          0.0 if scale is None else float(scale)]
    ih = [stride, horizon, int(hyper["forecast_confidence"]), kind,
          fa.use_band, int(scale is not None)]
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    sig = Signals(rps=torch.empty((3, M, B), **f32),
                  arch=torch.empty((R, B), **i32),
                  adj=torch.empty((3, R, B), **f32),
                  minute_arch=torch.empty((B, M), **i32) if minute_arch
                  else None)
    ext.policy_signals_aapa(
        rates, sig.rps, sig.arch, sig.adj,
        sig.minute_arch if minute_arch else torch.empty(0, **i32),
        cls_arch, cls_conf, torch.empty((fa.slots, B), **f32), fh, ih,
        fa.fc_f, fa.fc_i)
    return sig


def _predictive(ext, rates, hyper) -> Signals:
    horizon = int(hyper["horizon_min"])
    fa = forecaster_args(hyper["forecaster"], horizon)
    fh = [_f32(fapi.NATIVE_Z), fa.sqrt_h, fa.band_q, hyper["inv_cap"]]
    ih = [horizon, fa.use_band, int(hyper["conservative"])]
    B, M = rates.shape
    need = torch.empty((1, M, B), dtype=torch.float32, device=rates.device)
    ext.policy_signals_predictive(
        rates, need[0], torch.empty((fa.slots, B), dtype=torch.float32,
                                    device=rates.device), fh, ih, fa.fc_f,
        fa.fc_i)
    return Signals(rps=need)


def policy_signals_cuda(rates: torch.Tensor, controller, cfg, *,
                        minute_arch: bool = False) -> Signals:
    """Launch the pre-pass: rates [B, M] (contiguous float32 on CUDA) ->
    `Signals` of a predictive, AAPA or hybrid controller (with
    `minute_arch`, AAPA's and hybrid's archetype after each minute too).
    Raises on any other input or policy."""
    _check_rates(rates)
    if controller.name == "predictive":
        sig = _predictive(_build.extension(), rates, controller.hyper)
    elif controller.name in ("aapa", "hybrid"):
        sig = _aapa(_build.extension(), rates, controller.hyper, cfg,
                    minute_arch)
    else:
        raise ValueError(f"policy {controller.name!r} has no pre-pass; "
                         f"pre-passes: {POLICIES}")
    policy_signals_cuda.launches += 1
    walk = f"{controller.name}:{forecaster_name(controller)}"
    by_walk = policy_signals_cuda.by_walk
    by_walk[walk] = by_walk.get(walk, 0) + 1
    return sig


def forecaster_name(controller) -> str:
    """The registry name of the forecaster a forecasting policy runs
    (inside any conformal wrap)."""
    return _unwrapped(controller.hyper["forecaster"]).name


policy_signals_cuda.launches = 0
#: launches by minute walk, "<policy>:<forecaster>" (reset with the counts)
policy_signals_cuda.by_walk = {}
