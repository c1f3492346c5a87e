"""Autoscaling policies (port of ``repro.scaling.policies``).

* ``hpa_controller`` — paper §IV.C baseline: reactive, 70% CPU target,
  5-minute downscale stabilization window, 5-minute scale-down cooldown,
  +-10% tolerance band (Kubernetes semantics), with serverless
  scale-to-zero on sustained idle.
* ``predictive_controller`` — paper §IV.C baseline: uniform Holt-Winters,
  15-minute prediction horizon, no workload differentiation.
* ``aapa_controller`` — the paper's system (§III.C): every 10 minutes,
  extract 38 features from the last 60 minutes, classify the archetype,
  beta-calibrate the confidence, adjust Table III parameters via
  Algorithm 1, and apply the archetype strategy.
* ``kpa_controller`` — Knative-KPA-style concurrency scaler: stable and
  panic windows over estimated in-flight concurrency.
* ``hybrid_controller`` — AAPA with a reactive guardrail floor and a
  bounded scale-down step.

Divisions by a constant are multiplies by its f32 reciprocal, which is
what XLA compiles the reference's constant divisors to; the episode
kernel does the same, and so do the `explain` hooks of predictive, AAPA
and hybrid (hybrid's guard floor is its `decide`'s). Each controller's
`hyper` dict is the one source of its hyperparameters: `decide`/
`on_minute` read them there and the episode kernel's launcher passes the
same values to the card.
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
from repro_torch.forecast import conformal as fconf
from repro_torch.forecast import registry as forecast_registry
from repro_torch.obs.trace import ExplainOut
from repro_torch.scaling.api import Controller, Obs


def _nan_like(t: torch.Tensor) -> torch.Tensor:
    return torch.full_like(t, float("nan"))


def _per_minute(fn):
    """`fn(*inputs)` remembered for the inputs of its last call, compared
    by identity: the rate signals a decide reads change only with the
    minute hook's forecaster state and the rate history, so the control
    periods of one minute share one evaluation (the episode kernel's
    pre-pass likewise computes them once a minute). The inputs are held,
    so an identity cannot be reused by another object."""
    last: list = []

    def call(*inputs):
        if not (last and all(a is b for a, b in zip(last[0], inputs))):
            last[:] = [inputs, fn(*inputs)]
        return last[1]
    return call


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


# --------------------------------------------------- Generic Predictive ----
class PredState(NamedTuple):
    fc: fapi.FState


def _resolve_forecaster(forecaster, band):
    """Name or Forecaster -> Forecaster, conformal-wrapped when a
    calibrated band is supplied."""
    fcst = forecast_registry.make(forecaster)
    return fcst if band is None else fconf.wrap(fcst, band)


def _f32(v: float) -> float:
    return float(np.float32(v))


def predictive_controller(cfg, *, target: float = 0.70,
                          horizon_min: int = 15,
                          cooldown_min: float = 5.0,
                          forecaster="holt_winters",
                          band: fconf.ConformalBand | None = None,
                          conservative: bool = False) -> Controller:
    """Uniform predictive baseline over any registered forecaster.
    `conservative=True` scales to the interval's upper bound instead of
    the point forecast (pay replicas for forecast uncertainty)."""
    fcst = _resolve_forecaster(forecaster, band)
    hyper = dict(target=target, horizon_min=int(horizon_min),
                 forecaster=fcst, conservative=bool(conservative),
                 inv_cap=recip(cfg.rps_per_replica * target),
                 cooldown_sec=_f32(cooldown_min * 60.0))

    def init(lanes: tuple[int, ...] = (), device="cuda"):
        return PredState(fc=fcst.init(lanes, _device.resolve(device)))

    def on_minute(state: PredState, hist, minute_idx):
        return PredState(fc=fcst.update(state.fc, hist[..., -1]))

    need = _per_minute(lambda fstate: predictive_need(hyper, fstate))

    def decide(state: PredState, obs: Obs):
        return (state, *predictive_decide(hyper, need(state.fc), obs))

    def explain(state: PredState, obs: Obs):
        iv = fcst.forecast(state.fc, hyper["horizon_min"])
        nan = _nan_like(iv.point)
        return ExplainOut(fc_point=iv.point, fc_lo=iv.lo, fc_hi=iv.hi,
                          confidence=nan, archetype=nan, guard_floor=nan)

    return Controller("predictive", init, on_minute, decide, explain,
                      hyper=hyper)


def predictive_need(hyper: dict, fstate: fapi.FState) -> torch.Tensor:
    """The replicas the horizon's forecast needs: what the predictive
    policy's decide reads of its forecaster. The forecaster observes only
    the rates, so this is a function of the rates alone (the episode
    kernel computes it in its pre-pass)."""
    iv = hyper["forecaster"].forecast(fstate, hyper["horizon_min"])
    pred = (iv.hi if hyper["conservative"] else iv.point).clamp_min(0.0)
    return pred * recip(60.0) * hyper["inv_cap"]


def predictive_decide(hyper: dict, need_pred: torch.Tensor, obs: Obs):
    """The predictive policy's decision from its forecast need: (desired,
    cooldown request)."""
    need_now = obs.rate_rps * hyper["inv_cap"]
    desired = torch.ceil(torch.maximum(need_pred, need_now))
    # scale to zero when neither live traffic nor forecast needs pods
    idle = ((desired < 1.0) & (obs.queue <= 0.0)
            & (obs.rate_rps <= 1e-6))
    desired = torch.where(idle, torch.zeros_like(desired),
                          desired.clamp_min(1.0))
    return desired, torch.full_like(desired, hyper["cooldown_sec"])


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
    the classifier's times the forecaster's interval confidence: the
    split-conformal band when a calibrated `band` is supplied (its scale
    the trace's mean), the residual-EWMA native band otherwise.
    `forecast_confidence=None` turns the signal on exactly when a `band`
    is given."""
    if forecast_confidence is None:
        forecast_confidence = band is not None
    return _aapa(cfg, dict(
        stride_min=int(stride_min), horizon_min=int(horizon_min),
        forecaster=_resolve_forecaster(forecaster, band),
        conf_scale=None if band is None else band.scale,
        forecast_confidence=bool(forecast_confidence), classify=classify,
        table=table_iii_arrays()))


def _aapa(cfg, hyper: dict) -> Controller:
    """The AAPA controller of a complete `hyper` dict: the forecaster as
    `decide` runs it (band-wrapped or not) and `conf_scale`, the scale of
    the interval confidence (None: the point forecast's)."""

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
        classify = hyper["classify"]
        windows = getattr(classify, "classify_windows", None)
        arch, conf = (windows(hist) if windows is not None
                      else classify(F.extract_features(hist)))
        if hyper["forecast_confidence"]:
            iv = fcst.forecast(fst, hyper["horizon_min"])
            conf = conf * fapi.interval_confidence(iv, hyper["conf_scale"])
        adj = uncertainty.adjust(conf, _select4(arch, *tab["target_cpu"]),
                                 _select4(arch, *tab["cooldown_min"]),
                                 _select4(arch, *tab["min_replicas"]))
        return AAPAState(fst, arch, conf, adj.target_cpu, adj.cooldown_min,
                         adj.min_replicas)

    rate_signals = _per_minute(
        lambda fstate, hist: aapa_rate_signals(hyper, fstate, hist))

    def decide(state: AAPAState, obs: Obs):
        return (state, *aapa_decide(cfg, hyper, state, obs,
                                    *rate_signals(state.fc,
                                                  obs.rate_history)))

    def explain(state: AAPAState, obs: Obs):
        iv = hyper["forecaster"].forecast(state.fc, hyper["horizon_min"])
        return ExplainOut(fc_point=iv.point, fc_lo=iv.lo, fc_hi=iv.hi,
                          confidence=state.conf,
                          archetype=state.arch.to(torch.float32),
                          guard_floor=_nan_like(iv.point))

    return Controller("aapa", init, on_minute, decide, explain, hyper=hyper)


def aapa_rate_signals(hyper: dict, fstate: fapi.FState, rate_history):
    """(fc_rps, trend_rps, mean_rps): what AAPA's decide reads of its
    forecaster and of the rate history, per second (the horizon's peak
    forecast, the 30-minute trend, the 15-minute mean). The forecaster
    observes only the rates, so these are functions of the rates alone
    (the episode kernel computes them in its pre-pass)."""
    horizon = hyper["horizon_min"]
    fc_rps = hyper["forecaster"].forecast(fstate, horizon).point.clamp_min(
        0.0) * recip(60.0)
    trend_rps = fc.linear_trend_forecast(rate_history[..., -30:],
                                         horizon) * recip(60.0)
    mean_rps = xla_sum(rate_history[..., -15:]) * recip(15.0) * recip(60.0)
    return fc_rps, trend_rps, mean_rps


def aapa_decide(cfg, hyper: dict, state: AAPAState, obs: Obs, fc_rps,
                trend_rps, mean_rps):
    """AAPA's decision from its state's archetype and Algorithm 1
    parameters and the rate signals: (desired, cooldown request)."""
    tab = hyper["table"]
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
    periodic_d = torch.ceil(fc_rps / cap)
    ramp_d = torch.ceil(torch.maximum(trend_rps, obs.rate_rps) / cap)
    stat_d = torch.ceil(mean_rps / cap)

    strat = _select4(state.arch, periodic_d, spike_d, stat_d, ramp_d)
    desired = torch.maximum(torch.maximum(reactive, strat),
                            state.minrep_adj.clamp_min(1.0))
    return desired, state.cool_adj_min * 60.0


# ------------------------------------------------------------------- KPA ----
class KPAState(NamedTuple):
    stable_ema: torch.Tensor    # concurrency, ~stable_window average
    panic_ema: torch.Tensor     # concurrency, ~panic_window average
    panic_left_s: torch.Tensor  # seconds of panic mode remaining
    panic_max: torch.Tensor     # max desired seen during the panic


def kpa_controller(cfg, *, target_concurrency: float | None = None,
                   panic_threshold: float = 2.0,
                   stable_window_s: float = 60.0,
                   panic_window_s: float = 6.0,
                   cooldown_min: float = 1.0) -> Controller:
    """Knative-KPA-style concurrency autoscaler.

    Estimated in-flight concurrency (rate x service time plus the
    standing queue) feeds two EMAs. The stable window drives steady-state
    sizing; when the panic-window estimate needs more than
    `panic_threshold` x the current fleet, the scaler enters panic mode
    for one stable window, pinned to the maximum seen."""
    if target_concurrency is None:
        # one replica's concurrency at full utilization
        target_concurrency = cfg.rps_per_replica * cfg.service_sec
    dt = float(cfg.control_interval_sec)
    hyper = dict(target_concurrency=target_concurrency,
                 panic_threshold=panic_threshold,
                 stable_window_s=stable_window_s,
                 panic_window_s=panic_window_s, dt=dt,
                 service_sec=_f32(cfg.service_sec),
                 a_s=_f32(min(dt / stable_window_s, 1.0)),
                 a_p=_f32(min(dt / panic_window_s, 1.0)),
                 inv_tgt=recip(_f32(target_concurrency)),
                 cooldown_sec=_f32(cooldown_min * 60.0))

    def init(lanes: tuple[int, ...] = (), device="cuda"):
        z = torch.zeros(lanes, dtype=torch.float32,
                        device=_device.resolve(device))
        return KPAState(z, z.clone(), z.clone(), z.clone())

    def on_minute(state, hist, minute_idx):
        return state

    def decide(state: KPAState, obs: Obs):
        h = hyper
        conc = obs.queue + obs.rate_rps * h["service_sec"]
        stable = state.stable_ema + h["a_s"] * (conc - state.stable_ema)
        panic = state.panic_ema + h["a_p"] * (conc - state.panic_ema)
        want_stable = torch.ceil(stable * h["inv_tgt"])
        want_panic = torch.ceil(panic * h["inv_tgt"])

        fleet = obs.ready_total.clamp_min(1.0)
        enter = want_panic >= h["panic_threshold"] * fleet
        panic_left = torch.where(
            enter, torch.full_like(fleet, h["stable_window_s"]),
            (state.panic_left_s - h["dt"]).clamp_min(0.0))
        in_panic = panic_left > 0.0
        zero = torch.zeros_like(fleet)
        panic_max = torch.where(
            in_panic, torch.maximum(
                torch.where(state.panic_left_s > 0.0, state.panic_max,
                            zero),
                torch.maximum(want_panic, fleet)), zero)
        desired = torch.where(in_panic, panic_max, want_stable)

        # scale-to-zero on a truly idle stable window; wake on traffic
        idle = ((stable <= 1e-3) & (obs.queue <= 0.0)
                & (obs.rate_rps <= 1e-6))
        desired = torch.where(idle, zero, desired.clamp_min(1.0))
        return (KPAState(stable, panic, panic_left, panic_max), desired,
                torch.full_like(desired, h["cooldown_sec"]))

    return Controller("kpa", init, on_minute, decide, hyper=hyper)


# ---------------------------------------------------------------- hybrid ----
def hybrid_controller(cfg, classify, *, guard_target: float = 0.85,
                      max_down_frac: float = 0.3,
                      **aapa_kw) -> Controller:
    """AAPA plus a reactive guardrail: desired never drops below what live
    utilization requires at `guard_target`, and one decision removes at
    most `max_down_frac` of the current fleet. State and classification
    cadence are ``aapa_controller``'s; only `decide` is wrapped."""
    base = aapa_controller(cfg, classify, **aapa_kw)
    return _hybrid(cfg, dict(
        base.hyper, guard_target=guard_target, max_down_frac=max_down_frac,
        inv_guard=recip(guard_target),
        inv_rps_guard=recip(cfg.rps_per_replica * guard_target),
        down_keep=_f32(1.0 - max_down_frac)))


def _hybrid(cfg, hyper: dict) -> Controller:
    """The hybrid controller of a complete `hyper` dict (AAPA's and the
    guard's f32 values)."""
    base = _aapa(cfg, hyper)

    def decide(state, obs: Obs):
        state, desired, cool = base.decide(state, obs)
        return state, hybrid_guard(hyper, desired, obs), cool

    def explain(state, obs: Obs):
        return base.explain(state, obs)._replace(
            guard_floor=_guard_floor(hyper, obs))

    return Controller("hybrid", base.init, base.on_minute, decide, explain,
                      hyper=hyper)


def _guard_floor(hyper: dict, obs: Obs):
    """The hybrid guard's reactive floor: the replicas live utilization
    and the live arrival rate need at `guard_target`."""
    return torch.maximum(
        torch.ceil(obs.ready_total * obs.util_ema * hyper["inv_guard"]),
        torch.ceil(obs.rate_rps * hyper["inv_rps_guard"]))


def hybrid_guard(hyper: dict, desired, obs: Obs):
    """The hybrid policy's guard around AAPA's decision: a reactive floor
    from live utilization and a bounded scale-down step."""
    guarded = torch.maximum(desired, _guard_floor(hyper, obs))
    step_floor = torch.ceil(obs.ready_total * hyper["down_keep"])
    return torch.where(guarded < obs.ready_total,
                       torch.maximum(guarded, step_floor), guarded)


def rebuild(controller: Controller, cfg, **changes) -> Controller:
    """An AAPA or hybrid controller made anew from its `hyper` dict with
    `changes` applied, its plant constants taken from `cfg` as the episode
    kernel takes them (the plain episode swaps in the plain classifier)."""
    make = {"aapa": _aapa, "hybrid": _hybrid}[controller.name]
    return make(cfg, dict(controller.hyper, **changes))
