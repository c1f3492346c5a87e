"""The f32 arithmetic the port shares with the JAX reference and with its
own CUDA kernels.

* `recip`: XLA compiles a division by a compile-time constant
  (``x / 60.0``, ``jnp.mean``'s ``/ n``) into a multiply by the
  constant's f32 reciprocal; the port multiplies by that reciprocal in
  the same places, and divides two tensors IEEE everywhere else.
* `sum_chunks` / `xla_sum`: XLA's CPU reduction order. A sum over up to
  32 terms is sequential; a longer one is padded to a multiple of 32
  (half the padding in front), summed 32 terms at a time, and the
  partial sums are then summed in order. The plain versions sum in this
  order and the CUDA device functions (``kernels/csrc/numerics.cuh``)
  repeat it, so a kernel and its plain version agree bit for bit.
* `fma`: a fused multiply-add rounded once to f32, where XLA contracts
  one and the port must match it (the kernels call ``__fmaf_rn``).
* `rounded`: exp, log, log1p and pow evaluated in f64 and rounded once to
  f32, the correctly rounded f32 result (up to a double-rounding tie,
  about one case in 2^28). PyTorch's vectorized CPU functions are not
  correctly rounded (its f32 sqrt neither), and the kernels evaluate the
  same functions in f64, so every path gets the same f32.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

XLA_WINDOW = 32                        # XLA CPU's tree-reduction window
MAX_TERMS = XLA_WINDOW * XLA_WINDOW    # one level of partial sums


def recip(c: float) -> float:
    """The f32 reciprocal of a constant, as a Python float (exactly
    representable in f32): the multiplier XLA substitutes for a division
    by that constant."""
    return float(np.float32(1.0) / np.float32(c))


def sum_chunks(n: int) -> list[tuple[int, int]]:
    """The [start, stop) chunks XLA's CPU reduction sums sequentially
    before it sums the chunk totals in order."""
    if not 1 <= n <= MAX_TERMS:
        raise ValueError(f"sum over {n} terms: expected 1..{MAX_TERMS}")
    n_win = -(-n // XLA_WINDOW)
    low = (n_win * XLA_WINDOW - n) // 2
    return [(max(i * XLA_WINDOW - low, 0),
             min((i + 1) * XLA_WINDOW - low, n)) for i in range(n_win)]


def seq_sum(v: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """v[..., lo] + v[..., lo + 1] + ... + v[..., hi - 1], left to right
    (zeros for an empty range)."""
    if hi <= lo:
        return torch.zeros_like(v[..., 0])
    s = v[..., lo]
    for j in range(lo + 1, hi):
        s = s + v[..., j]
    return s


def xla_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in XLA CPU's order (see `sum_chunks`;
    zeros for an empty axis)."""
    if v.shape[-1] == 0:
        return v.sum(-1)
    parts = [seq_sum(v, lo, hi) for lo, hi in sum_chunks(v.shape[-1])]
    s = parts[0]
    for p in parts[1:]:
        s = s + p
    return s


def rounded(fn: Callable[..., torch.Tensor], *args) -> torch.Tensor:
    """`fn` on the f32 tensors in `args`, evaluated in f64 and rounded
    once to f32 (other arguments pass through)."""
    up = [a.to(torch.float64) if isinstance(a, torch.Tensor) else a
          for a in args]
    return fn(*up).to(torch.float32)


def sqrt(v: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root."""
    return rounded(torch.sqrt, v)


def fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once (a fused multiply-add).

    The product of two f32 values is exact in f64; the f64 sum is made
    round-to-odd (a TwoSum error term moves an inexact even result one
    f64 ulp towards the exact value), and a round-to-odd value with at
    least two extra bits rounds to the correctly rounded f32."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = torch.as_tensor(c, dtype=torch.float64, device=p.device)
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)
