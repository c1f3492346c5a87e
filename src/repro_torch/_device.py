"""Device resolution shared by every tensor-making entry point."""
from __future__ import annotations

import functools

import torch


def resolve(device: str | torch.device) -> torch.device:
    """`device` as a ``torch.device``; raises when CUDA is asked for and
    absent (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def canonical(device: str | torch.device) -> torch.device:
    """`device` with its index: a bare ``"cuda"`` is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=None)
def const(value: float, device: torch.device) -> torch.Tensor:
    """A 0-dim f32 tensor on `device`, cached per (value, device).

    Used as the numerator or divisor of a true division: PyTorch turns
    ``scalar / tensor`` into ``reciprocal(tensor) * scalar`` and, on CUDA,
    ``tensor / cpu_scalar`` into a multiply by the scalar's reciprocal,
    neither of which is the IEEE quotient the kernels compute."""
    return torch.tensor(value, dtype=torch.float32, device=device)

