"""``window_features`` CUDA kernel: the 28 statistical and time-domain
features of each window, or all 38 AAPA features (source
``csrc/window_features.cu``, feature math in ``csrc/features.cuh``, the
AAPA episode kernel's own).

Replaces the Pallas TPU kernel ``repro/kernels/window_features.py``
(``window_features_kernel``). Plain versions:
``kernels.ref.window_features_ref`` (``core.features.stat_time_features``)
and ``kernels.ref.extract_features_ref`` (``core.features.extract_features``);
``kernels.ops.window_features`` and ``kernels.ops.extract_features_fused``
dispatch between kernel and plain version by device.

The kernel has three variants, all hand-written and bit for bit with the
plain versions: ``"w60"``, compiled for 60-sample windows (the
classification path's and AAPAset's width) with the window in registers;
``"generic"``, the routines for any width in [3, 64], scratch in local
arrays; and ``"wide"``, one window a group of 8 lanes (up to 128
samples) or a warp, in shared memory (the sums split across the lanes in
XLA's chunks, a bitonic sort in registers, the FFT's butterflies across
the lanes), for any width up to 1,024
(``_numerics.MAX_TERMS``, where the plain version's XLA-order sums stop
too). ``choose_variant`` picks
one from the width alone. The AAPA pre-pass runs the same kernels on its
windows, read in place from the rates (``policy_signals.reclassify_cuda``).
"""
from __future__ import annotations

import torch

from repro_torch.core import features
from repro_torch.kernels import _build

N_FEATS = 28
MIN_W, MAX_W = 3, 1024
#: the one width the register variant is compiled for (csrc/kernels.h kW60)
W60 = 60
#: the widest window the generic variant's local arrays hold
#: (csrc/kernels.h kMaxWindow; MAX_W is its kMaxWideWindow)
GENERIC_MAX_W = 64
#: the variants in the order of csrc/kernels.h WfVariant
VARIANTS = ("w60", "generic", "wide")


def choose_variant(width: int) -> str:
    """Which kernel takes windows of `width` samples."""
    if width == W60:
        return "w60"
    return "generic" if width <= GENERIC_MAX_W else "wide"


def check_variant(variant: str, width: int) -> int:
    """`variant` at `width` as the binding takes it (its index in
    VARIANTS); raises for a variant that does not take the width."""
    if (variant not in VARIANTS or (variant == "w60" and width != W60)
            or (variant == "generic" and width > GENERIC_MAX_W)):
        raise ValueError(f"variant {variant!r} at W = {width}: expected one "
                         f"of {VARIANTS}, 'w60' only at W = {W60}, "
                         f"'generic' only up to W = {GENERIC_MAX_W}")
    return VARIANTS.index(variant)


def window_features_cuda(windows: torch.Tensor, *, freq: bool = False,
                         variant: str | None = None) -> torch.Tensor:
    """Launch the kernel: windows [N, W] (contiguous float32 on CUDA,
    3 <= W <= 1024) -> features [N, 28]; with `freq` (W >= 4) the 38
    features [N, 38], the 10 frequency features after the 28. `variant`
    forces a kernel (``"w60"`` only at W = 60, ``"generic"`` only up to
    64); by default ``choose_variant(W)``. Raises on any other input."""
    if windows.device.type != "cuda":
        raise ValueError("window_features kernel needs a CUDA tensor, got "
                         f"{windows.device}")
    min_w = MIN_W + int(freq)
    if (windows.dim() != 2 or windows.dtype != torch.float32
            or not windows.is_contiguous() or windows.shape[0] < 1
            or not min_w <= windows.shape[1] <= MAX_W):
        raise ValueError("windows: expected a contiguous float32 [N, W] "
                         f"tensor, N >= 1, {min_w} <= W <= {MAX_W}; got "
                         f"{tuple(windows.shape)} {windows.dtype}")
    N, W = windows.shape
    variant = choose_variant(W) if variant is None else variant
    code = check_variant(variant, W)
    if freq:
        tw, plan = features.fft_tables(W, windows.device)
        inv_log_nb, inv_nb = features.freq_constants(W)
    else:
        tw = torch.empty(0, dtype=torch.float32, device=windows.device)
        plan, inv_log_nb, inv_nb = [], 0.0, 0.0
    out = torch.empty((N, features.N_FEATURES if freq else N_FEATS),
                      dtype=torch.float32, device=windows.device)
    _build.extension().window_features(windows, out, tw, plan, inv_log_nb,
                                       inv_nb, code)
    window_features_cuda.launches += 1
    window_features_cuda.last_variant = variant
    return out


window_features_cuda.launches = 0
window_features_cuda.last_variant = None
