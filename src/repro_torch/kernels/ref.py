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
from repro_torch.kernels.policy_signals import POLICIES, Signals
from repro_torch.scaling import policies
from repro_torch.scaling.api import Controller
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
    logits from `gbdt_logits_ref` and its features from
    `extract_features_ref`; its forecaster and band are the controller's
    own."""
    h = controller.hyper
    if (controller.name not in ("aapa", "hybrid")
            or not isinstance(h["classify"], Classify)):
        return controller
    return policies.rebuild(controller, cfg, classify=dataclasses.replace(
        h["classify"], logits=gbdt_logits_ref,
        features=extract_features_ref))


def policy_signals_ref(rates, controller, cfg, *,
                       minute_arch: bool = False) -> Signals:
    """rates [B, M] -> the `Signals` of a predictive, AAPA or hybrid
    controller: its own `on_minute` over the zero-padded rate history, and
    what its decide reads of the result (``policies.predictive_need``,
    ``policies.aapa_rate_signals``), minute by minute on the rates' device.
    An AAPA or hybrid controller's GBDT classifier takes its logits from
    `gbdt_logits_ref`, so this launches no kernel on the card."""
    if controller.name not in POLICIES:
        raise ValueError(f"policy {controller.name!r} has no pre-pass; "
                         f"pre-passes: {POLICIES}")
    ctrl = _plain_controller(controller, cfg)
    h = ctrl.hyper
    B, M = rates.shape
    state = ctrl.init((B,), rates.device)
    hist = torch.zeros((B, cfg.history_len), dtype=torch.float32,
                       device=rates.device)
    if ctrl.name == "predictive":
        need = [policies.predictive_need(h, state.fc)]
        for m in range(M - 1):
            state = ctrl.on_minute(state, rates[:, m:m + 1], m + 1)
            need.append(policies.predictive_need(h, state.fc))
        return Signals(rps=torch.stack(need)[None])

    def slot(st):
        return st.arch, torch.stack([st.cpu_adj, st.cool_adj_min,
                                     st.minrep_adj])

    stride = h["stride_min"]
    rps, slots = [policies.aapa_rate_signals(h, state.fc, hist)], [slot(state)]
    for m in range(M):
        hist = torch.cat([hist[:, 1:], rates[:, m:m + 1]], -1)
        state = ctrl.on_minute(state, hist, m + 1)
        if (m + 1) % stride == 0:
            slots.append(slot(state))
        if m + 1 < M:
            rps.append(policies.aapa_rate_signals(h, state.fc, hist))
    arch = torch.stack([a for a, _ in slots])
    after = (torch.arange(M, device=rates.device) + 1) // stride
    return Signals(
        rps=torch.stack([torch.stack(f) for f in zip(*rps)]), arch=arch,
        adj=torch.stack([a for _, a in slots], 1),
        minute_arch=arch[after].T.contiguous() if minute_arch else None)


def reclassify_ref(rates, classify: Classify, stride: int,
                   history_len: int):
    """rates [B, M] -> (archetype int32 [B, R - 1], confidence [B, R - 1]),
    R = M // stride + 1: slot r's window, the `history_len` minutes
    before minute r * stride with zeros before minute 0, through
    `classify` with its features from `extract_features_ref` and its
    logits from `gbdt_logits_ref` (what an AAPA or hybrid minute hook
    computes at that slot). The plain version of
    ``policy_signals.reclassify_cuda``; launches no kernel on the card."""
    B, M = rates.shape
    padded = torch.cat([torch.zeros((B, history_len), dtype=torch.float32,
                                    device=rates.device), rates], -1)
    wins = padded.unfold(-1, history_len, stride)[:, 1:M // stride + 1]
    plain = dataclasses.replace(classify, logits=gbdt_logits_ref,
                                features=extract_features_ref)
    return plain.classify_windows(wins)


def plant_pass_ref(rates, controller, cfg, signals: Signals | None):
    """rates [B, M] -> MinuteOut of [B, M]: the episode's plant ticks and
    decide as `episode_block_ref` runs them, with every signal of the
    controller's minute hook read from `signals` (None for HPA and kpa,
    whose hook does nothing). Equal to `episode_block_ref` bit for bit
    when `signals` is `policy_signals_ref`'s."""
    if signals is not None:
        controller = _replay(controller, cfg, signals)
    return cluster.simulate(rates, controller, cfg, device=rates.device,
                            plant_kernel=False, decide_kernel=False)


def _replay(controller, cfg, sig: Signals) -> Controller:
    """`controller` with its decide fed from precomputed signals (the
    minute index of the Obs picks the minute and the reclassification
    slot) and its minute hook a no-op."""
    h = controller.hyper

    if controller.name == "predictive":
        def decide(state, obs):
            return (state, *policies.predictive_decide(
                h, sig.rps[0, obs.minute_idx], obs))
    else:
        stride = h["stride_min"]

        def decide(state, obs):
            m = int(obs.minute_idx)
            r = m // stride
            slot = policies.AAPAState(None, sig.arch[r], None, *sig.adj[:, r])
            desired, cool = policies.aapa_decide(cfg, h, slot, obs,
                                                 *sig.rps[:, m])
            if controller.name == "hybrid":
                desired = policies.hybrid_guard(h, desired, obs)
            return state, desired, cool

    return Controller(controller.name, lambda lanes=(), device=None: (),
                      lambda state, hist, minute_idx: state, decide,
                      hyper=h)


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
