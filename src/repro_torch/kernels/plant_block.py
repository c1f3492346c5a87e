"""``plant_block`` CUDA kernel: B plant lanes through the decision-free
ticks of one control period (source ``csrc/plant_block.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/plant_block.py``
(``plant_block_kernel``). Plain version: ``kernels.ref.plant_block_ref``
(``sim.cluster.plant_block_ref``); ``kernels.ops.plant_tick_block``
dispatches between the two by device. The kernel's design and bound are
described in its source.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.sim.cluster import recip


def _check_lane_vector(t: torch.Tensor, name: str, B: int, dev) -> None:
    if (t.device != dev or t.dtype != torch.float32 or t.shape != (B,)
            or not t.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous float32 [{B}] "
                         f"tensor on {dev}, got {tuple(t.shape)} "
                         f"{t.dtype} on {t.device}")


def plant_tick_block_cuda(ready, pipeline, queue, wait_sum, util_ema,
                          cooldown, pipe_sum, arrivals, *, n_ticks: int,
                          rps_per_replica: float = 20.0,
                          service_sec: float = 0.1, slo_sec: float = 0.5,
                          resp_cap_sec: float = 600.0,
                          metric_tau_sec: float = 60.0):
    """Launch the kernel on CUDA tensors (raises on anything else).
    Returns ((ready, pipeline, queue, wait_sum, util_ema, cooldown,
    pipe_sum), 7 per-tick [B, n_ticks] tensors)."""
    dev = pipeline.device
    if dev.type != "cuda":
        raise ValueError(f"plant_block kernel needs CUDA tensors, got {dev}")
    if (pipeline.dim() != 2 or pipeline.dtype != torch.float32
            or not pipeline.is_contiguous()):
        raise ValueError("pipeline: expected a contiguous float32 [B, S] "
                         f"tensor, got {tuple(pipeline.shape)} "
                         f"{pipeline.dtype}")
    B, S = pipeline.shape
    if B < 1 or S < 1 or n_ticks < 1:
        raise ValueError(f"empty plant block: B={B}, S={S}, "
                         f"n_ticks={n_ticks}")
    state = (ready, queue, wait_sum, util_ema, cooldown, pipe_sum, arrivals)
    names = ("ready", "queue", "wait_sum", "util_ema", "cooldown",
             "pipe_sum", "arrivals")
    for t, name in zip(state, names):
        _check_lane_vector(t, name, B, dev)

    state_out = [torch.empty_like(ready) for _ in range(6)]
    pipeline_out = torch.empty_like(pipeline)
    ticks = torch.empty((7, n_ticks, B), dtype=torch.float32, device=dev)
    _build.extension().plant_block(
        list(state), pipeline, state_out, pipeline_out, ticks,
        rps_per_replica, service_sec, slo_sec, resp_cap_sec,
        recip(metric_tau_sec))
    plant_tick_block_cuda.launches += 1
    r, q, w, u, c, ps = state_out
    return (r, pipeline_out, q, w, u, c, ps), tuple(t.T for t in ticks)


plant_tick_block_cuda.launches = 0
