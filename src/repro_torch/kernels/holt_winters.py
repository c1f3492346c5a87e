"""``holt_winters`` CUDA kernel: one-step-ahead additive Holt-Winters
forecasts over whole series (source ``csrc/holt_winters.cu``, recurrence
in ``csrc/hw.cuh``).

Replaces the Pallas TPU kernel ``repro/kernels/holt_winters.py``
(``holt_winters_kernel``). Plain version: ``kernels.ref.holt_winters_ref``
(``core.forecasting.hw_smooth``); ``kernels.ops.holt_winters`` dispatches
between the two by device. The kernel's design and bound are described in
its source.

The kernel has two variants, both hand-written and bit for bit with the
plain version: the season in shared memory (``"shared"``, periods up to
``SHARED_PERIOD_MAX``) or in global scratch (``"global"``, any period).
``choose_variant`` picks one from the period alone; each moves y and the
forecasts in 16-B copies where ``T % 4 == 0`` and both tensors are 16-B
aligned, else in 4-B ones.
"""
from __future__ import annotations

import torch

from repro_torch.core.forecasting import smooth_coeffs
from repro_torch.kernels import _build

#: the longest season the shared-memory variant holds (csrc/kernels.h
#: kHWSharedPeriodMax: 96 phases x 64 series beside 32 KB of tiles)
SHARED_PERIOD_MAX = 96
VARIANTS = ("shared", "global")


def choose_variant(period: int) -> str:
    """Where the kernel keeps the season at this period."""
    if period < 1:
        raise ValueError(f"period must be >= 1, got {period}")
    return "shared" if period <= SHARED_PERIOD_MAX else "global"


def vec16(T: int, *tensors: torch.Tensor) -> bool:
    """Whether the kernel moves rows of T samples in 16-B copies."""
    return T % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def holt_winters_cuda(y: torch.Tensor, *, period: int = 60,
                      alpha: float = 0.1, beta: float = 0.01,
                      gamma: float = 0.3,
                      variant: str | None = None) -> torch.Tensor:
    """Launch the kernel: y [B, T] (contiguous float32 on CUDA, B, T >= 1)
    -> forecasts [B, T]. `variant` forces where the season is kept
    (``"shared"`` only up to ``SHARED_PERIOD_MAX``); by default
    ``choose_variant(period)``. Raises on any other input."""
    if y.device.type != "cuda":
        raise ValueError(f"holt_winters kernel needs a CUDA tensor, got "
                         f"{y.device}")
    if (y.dim() != 2 or y.dtype != torch.float32 or not y.is_contiguous()
            or min(y.shape) < 1 or period < 1):
        raise ValueError("y: expected a non-empty contiguous float32 [B, T] "
                         f"tensor and period >= 1, got {tuple(y.shape)} "
                         f"{y.dtype}, period {period}")
    variant = choose_variant(period) if variant is None else variant
    if variant not in VARIANTS or (variant == "shared"
                                   and period > SHARED_PERIOD_MAX):
        raise ValueError(f"variant {variant!r} at period {period}: expected "
                         f"one of {VARIANTS}, 'shared' only up to period "
                         f"{SHARED_PERIOD_MAX}")
    B, T = y.shape
    out = torch.empty_like(y)
    rows = 0 if variant == "shared" else period
    scratch = torch.empty((rows, B), dtype=torch.float32, device=y.device)
    wide = vec16(T, y, out)
    _build.extension().holt_winters(y, out, scratch, int(period),
                                    list(smooth_coeffs(alpha, beta, gamma)),
                                    variant == "shared", wide)
    holt_winters_cuda.launches += 1
    holt_winters_cuda.last_variant = f"{variant}/{16 if wide else 4}B"
    return out


holt_winters_cuda.launches = 0
holt_winters_cuda.last_variant = None
