"""``episode_block`` CUDA kernel: whole episodes, plant ticks and
``controller.decide`` in one launch (source ``csrc/episode_block.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/episode_block.py``
(``episode_minutes``). The TPU kernel took any controller by hoisting
its closure through a jaxpr; a CUDA kernel cannot, so each policy is a
device function chosen at compile time and the launcher is picked by the
controller's name. Only HPA is ported. Plain version:
``kernels.ref.episode_block_ref``; ``kernels.ops.episode_block``
dispatches between the two by device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.sim.cluster import MinuteOut, recip


def _launch_hpa(ext, rates, out, cfg, hyper, ci):
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


#: controller name -> launcher of its compiled policy
_POLICIES = {"hpa": _launch_hpa}


def episode_block_cuda(rates: torch.Tensor, controller, cfg) -> MinuteOut:
    """Launch the kernel: rates [B, M] (contiguous float32 on CUDA) ->
    MinuteOut of [B, M]. Raises on any other input or policy."""
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
    launch(_build.extension(), rates, out, cfg, controller.hyper, ci)
    episode_block_cuda.launches += 1
    return MinuteOut(*out.unbind(0))


episode_block_cuda.launches = 0
