"""``plant_block`` CUDA kernel: B plant lanes through the decision-free
ticks of one control period (source ``csrc/plant_block.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/plant_block.py``
(``plant_block_kernel``). Plain version: ``kernels.ref.plant_block_ref``
(``sim.cluster.plant_block_ref``); ``kernels.ops.plant_tick_block``
dispatches between the two by device. The kernel's design and bound are
described in its source. Two plain functions shape each launch of the
kernel (``"staged"``): ``choose_lanes`` (lanes per block, from B and the
card's SM count) and ``pop_chunk`` (ticks whose popped slots a block
stages at once). ``"per_thread"``, the kernel it replaced, stays as the
variant it is held against bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.sim.cluster import recip

#: the kernel's variants, as the binding numbers them (csrc/kernels.h
#: PlantVariant)
VARIANTS = ("staged", "per_thread", "empty")
#: lanes per block the kernel runs, widest first
LANES = (128, 64, 32)
#: floats of popped slots a block stages at once (csrc/kernels.h
#: kPlantPopFloats)
POP_FLOATS = 8192


def choose_lanes(B: int, n_sm: int) -> int:
    """Lanes per block for B lanes on a card of n_sm SMs: the widest
    block that still gives every SM one, else the narrowest."""
    if B < 1 or n_sm < 1:
        raise ValueError(f"need B >= 1 and n_sm >= 1, got {B}, {n_sm}")
    for lanes in LANES[:-1]:
        if -(-B // lanes) >= n_sm:
            return lanes
    return LANES[-1]


def pop_chunk(lanes: int, S: int, n_ticks: int) -> int:
    """Ticks whose popped slots a block of `lanes` stages at once: all
    min(S, n_ticks) of them where lanes x (chunk | 1) floats fit
    ``POP_FLOATS``, else the most that fit."""
    if lanes not in LANES or S < 1 or n_ticks < 1:
        raise ValueError(f"need lanes in {LANES}, S >= 1 and n_ticks >= 1, "
                         f"got {lanes}, {S}, {n_ticks}")
    cap = POP_FLOATS // lanes
    return min(S, n_ticks, cap if cap % 2 else cap - 1)


def _check_lane_vector(t: torch.Tensor, name: str, B: int, dev) -> None:
    if (t.device != dev or t.dtype != torch.float32 or t.shape != (B,)
            or not t.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous float32 [{B}] "
                         f"tensor on {dev}, got {tuple(t.shape)} "
                         f"{t.dtype} on {t.device}")


def _launch(ready, pipeline, queue, wait_sum, util_ema, cooldown, pipe_sum,
            arrivals, n_ticks, rps_per_replica, service_sec, slo_sec,
            resp_cap_sec, metric_tau_sec, variant):
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

    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: expected one of {VARIANTS}")
    lanes = LANES[0] if variant == "per_thread" else choose_lanes(
        B, torch.cuda.get_device_properties(dev).multi_processor_count)
    chunk = pop_chunk(lanes, S, n_ticks)
    state_out = [torch.empty_like(ready) for _ in range(6)]
    pipeline_out = torch.empty_like(pipeline)
    ticks = torch.empty((7, n_ticks, B), dtype=torch.float32, device=dev)
    _build.extension().plant_block(
        list(state), pipeline, state_out, pipeline_out, ticks,
        rps_per_replica, service_sec, slo_sec, resp_cap_sec,
        recip(metric_tau_sec), VARIANTS.index(variant), lanes, chunk)
    r, q, w, u, c, ps = state_out
    if variant == "staged":
        variant += f"/{lanes} lanes/{-(-min(S, n_ticks) // chunk)} chunks"
    return ((r, pipeline_out, q, w, u, c, ps), tuple(t.T for t in ticks),
            variant)


def plant_tick_block_cuda(ready, pipeline, queue, wait_sum, util_ema,
                          cooldown, pipe_sum, arrivals, *, n_ticks: int,
                          rps_per_replica: float = 20.0,
                          service_sec: float = 0.1, slo_sec: float = 0.5,
                          resp_cap_sec: float = 600.0,
                          metric_tau_sec: float = 60.0,
                          variant: str = "staged"):
    """Launch the kernel on CUDA tensors (raises on anything else).
    Returns ((ready, pipeline, queue, wait_sum, util_ema, cooldown,
    pipe_sum), 7 per-tick [B, n_ticks] tensors). `variant` ``"per_thread"``
    launches the kernel the staged one replaced."""
    if variant == "empty":
        raise ValueError("the empty launch is empty_launch_cuda's")
    state, ticks, variant = _launch(
        ready, pipeline, queue, wait_sum, util_ema, cooldown, pipe_sum,
        arrivals, n_ticks, rps_per_replica, service_sec, slo_sec,
        resp_cap_sec, metric_tau_sec, variant)
    plant_tick_block_cuda.launches += 1
    plant_tick_block_cuda.last_variant = variant
    return state, ticks


plant_tick_block_cuda.launches = 0
plant_tick_block_cuda.last_variant = None


def empty_launch_cuda(*state, n_ticks: int) -> None:
    """The kernel's launch on the same inputs and grid with an empty body:
    what the launch alone costs. Computes nothing and is no kernel of any
    path, so it counts no launch."""
    _launch(*state, n_ticks, 20.0, 0.1, 0.5, 600.0, 60.0, "empty")
