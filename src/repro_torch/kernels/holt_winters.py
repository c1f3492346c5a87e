"""``holt_winters`` CUDA kernel: one-step-ahead additive Holt-Winters
forecasts over whole series (source ``csrc/holt_winters.cu``, recurrence
in ``csrc/hw.cuh``).

Replaces the Pallas TPU kernel ``repro/kernels/holt_winters.py``
(``holt_winters_kernel``). Plain version: ``kernels.ref.holt_winters_ref``
(``core.forecasting.hw_smooth``); ``kernels.ops.holt_winters`` dispatches
between the two by device. The kernel's design and bound are described in
its source.
"""
from __future__ import annotations

import torch

from repro_torch.core.forecasting import smooth_coeffs
from repro_torch.kernels import _build


def holt_winters_cuda(y: torch.Tensor, *, period: int = 60,
                      alpha: float = 0.1, beta: float = 0.01,
                      gamma: float = 0.3) -> torch.Tensor:
    """Launch the kernel: y [B, T] (contiguous float32 on CUDA, B, T >= 1)
    -> forecasts [B, T]. Raises on any other input."""
    if y.device.type != "cuda":
        raise ValueError(f"holt_winters kernel needs a CUDA tensor, got "
                         f"{y.device}")
    if (y.dim() != 2 or y.dtype != torch.float32 or not y.is_contiguous()
            or min(y.shape) < 1 or period < 1):
        raise ValueError("y: expected a non-empty contiguous float32 [B, T] "
                         f"tensor and period >= 1, got {tuple(y.shape)} "
                         f"{y.dtype}, period {period}")
    B = y.shape[0]
    out = torch.empty_like(y)
    season = torch.empty((period, B), dtype=torch.float32, device=y.device)
    _build.extension().holt_winters(y, out, season, int(period),
                                    list(smooth_coeffs(alpha, beta, gamma)))
    holt_winters_cuda.launches += 1
    return out


holt_winters_cuda.launches = 0
