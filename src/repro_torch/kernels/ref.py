"""Plain PyTorch versions of the port's CUDA kernels.

``kernels.ops`` runs these for CPU tensors; the tests hold them against
the JAX reference, and ``chip_smoke.py`` holds each kernel against its
plain version on the card. Nothing on the card's main path calls them.
"""
from __future__ import annotations

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
    PyTorch, on the rates' own device."""
    return cluster.simulate(rates, controller, cfg, device=rates.device,
                            plant_kernel=False, decide_kernel=False)
