"""``episode_block`` CUDA kernel: the plant pass of whole episodes, plant
ticks and ``controller.decide`` in one launch (source
``csrc/episode_block.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/episode_block.py``
(``episode_minutes``), with the pre-pass ``kernels.policy_signals``: a
policy's minute hook reads only the rates, so the predictive, AAPA and
hybrid episodes first compute what their hooks give decide (forecasts,
AAPA's archetype and Algorithm 1's parameters) for every lane and minute,
and the plant pass reads it. The TPU kernel took any controller by
hoisting its closure through a jaxpr; a CUDA kernel cannot, so each
policy is a device function chosen at compile time and the launcher is
picked by the controller's name: all five registered policies (HPA,
predictive, KPA, AAPA, hybrid). Plain version: ``kernels.ref.
episode_block_ref`` (of the plant pass alone, given the signals:
``kernels.ref.plant_pass_ref``); ``kernels.ops.episode_block`` dispatches
between the two by device.
"""
from __future__ import annotations

import torch

from repro_torch.core.archetypes import table_iii_arrays
from repro_torch.kernels import _build
from repro_torch.kernels import policy_signals as _signals
from repro_torch.sim.cluster import MinuteOut, recip

#: the policies that carry an archetype
ARCHETYPE_POLICIES = ("aapa", "hybrid")


def _plant_args(cfg) -> tuple:
    """SimConfig's pipeline slots and plant constants in the order every
    launcher takes them."""
    return (cfg.startup_sec, max(min(int(cfg.control_interval_sec), 60), 1),
            cfg.rps_per_replica, cfg.service_sec, cfg.slo_sec,
            cfg.resp_cap_sec, recip(cfg.metric_tau_sec), cfg.max_replicas,
            cfg.initial_replicas)


def _hpa(ext, rates, out, cfg, hyper, sig):
    ext.episode_block_hpa(rates, out, *_plant_args(cfg), hyper["inv_target"],
                          hyper["tolerance"], hyper["cooldown_sec"],
                          int(hyper["buf_len"]))


def _kpa(ext, rates, out, cfg, hyper, sig):
    fh = [hyper[k] for k in ("service_sec", "a_s", "a_p", "inv_tgt")] + [
        _signals._f32(hyper[k]) for k in ("panic_threshold",
                                          "stable_window_s", "dt")] + [
        hyper["cooldown_sec"]]
    ext.episode_block_kpa(rates, out, *_plant_args(cfg), fh)


def _predictive(ext, rates, out, cfg, hyper, sig):
    ext.episode_block_predictive(rates, out, sig.rps[0], *_plant_args(cfg),
                                 hyper["inv_cap"], hyper["cooldown_sec"])


def _aapa(ext, rates, out, cfg, hyper, sig, guard=()):
    fh = [*table_iii_arrays()["warm_pool"],
          _signals._f32(cfg.rps_per_replica)]
    ext.episode_block_aapa(rates, out, sig.rps, sig.arch, sig.adj,
                           *_plant_args(cfg), fh, int(hyper["stride_min"]),
                           list(guard))


def _hybrid(ext, rates, out, cfg, hyper, sig):
    _aapa(ext, rates, out, cfg, hyper, sig,
          guard=(hyper["inv_guard"], hyper["inv_rps_guard"],
                 hyper["down_keep"]))


#: controller name -> launcher of its compiled policy
_POLICIES = {"hpa": _hpa, "predictive": _predictive, "kpa": _kpa,
             "aapa": _aapa, "hybrid": _hybrid}


def plant_pass_cuda(rates: torch.Tensor, controller, cfg,
                    signals: _signals.Signals | None) -> MinuteOut:
    """Launch the plant pass alone: rates [B, M] (contiguous float32 on
    CUDA) and the pre-pass's `signals` of a predictive, AAPA or hybrid
    controller (None for HPA and kpa) -> MinuteOut of [B, M]. Counts as an
    episode_block launch."""
    _signals._check_rates(rates)
    launch = _POLICIES.get(controller.name)
    if launch is None:
        raise NotImplementedError(
            f"episode_block has no compiled policy {controller.name!r}; "
            f"compiled: {sorted(_POLICIES)}")
    if (signals is None) != (controller.name not in _signals.POLICIES):
        raise ValueError(f"policy {controller.name!r} takes "
                         + ("the pre-pass's signals"
                            if signals is None else "no signals"))
    ext = _build.extension()
    ring = int(controller.hyper["buf_len"]) if controller.name == "hpa" else 0
    need, limit = ext.episode_smem(cfg.startup_sec, ring, rates.get_device())
    if need > limit:
        raise RuntimeError(
            f"episode_block: {cfg.startup_sec} startup-pipeline slots and a "
            f"policy ring of {ring} slots need {need} bytes of shared memory "
            f"per block of 32 lanes, more than the {limit} a block can have "
            "on this device")
    B, M = rates.shape
    out = torch.empty((12, B, M), dtype=torch.float32, device=rates.device)
    launch(ext, rates, out, cfg, controller.hyper, signals)
    episode_block_cuda.launches += 1
    return MinuteOut(*out.unbind(0))


def _episode(rates, controller, cfg, minute_arch: bool = False):
    sig = (_signals.policy_signals_cuda(rates, controller, cfg,
                                        minute_arch=minute_arch)
           if controller.name in _signals.POLICIES else None)
    return plant_pass_cuda(rates, controller, cfg, sig), sig


def episode_block_cuda(rates: torch.Tensor, controller, cfg) -> MinuteOut:
    """The episode on the card: rates [B, M] (contiguous float32 on CUDA)
    -> MinuteOut of [B, M]; the pre-pass first where the policy has one.
    Raises on any other input or policy."""
    return _episode(rates, controller, cfg)[0]


def aapa_episode_cuda(rates: torch.Tensor, controller, cfg):
    """The episode under an AAPA or hybrid controller, also returning the
    archetype each lane carries after each minute: (MinuteOut of [B, M],
    int32 [B, M]). Counts as a policy_signals and an episode_block
    launch."""
    if controller.name not in ARCHETYPE_POLICIES:
        raise ValueError(f"archetypes need an aapa or hybrid controller, "
                         f"got {controller.name!r}")
    out, sig = _episode(rates, controller, cfg, minute_arch=True)
    return out, sig.minute_arch


episode_block_cuda.launches = 0
