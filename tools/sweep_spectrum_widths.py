#!/usr/bin/env python3
"""Which window widths give a power spectrum that differs from the
reference's, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/sweep_spectrum_widths.py \
        [--lo 4] [--hi 1024] [--windows 16]

For each width n in [lo, hi], `windows` gamma windows (seed n) go through
the port's ``core.features.power_spectrum`` (ducc0's radix passes, op for
op) and through the reference's ``|jnp.fft.rfft(x - mean)|^2``. Prints one
line per width where the two are not bitwise equal: n, the largest
difference relative to each bin, the largest relative to the window's
largest bin, and n's factors in ducc0's order; then the list of such
widths. Such widths are where ducc0 takes another algorithm than the
radix passes (Bluestein's, for a large prime factor), a standing
difference of the port (ROADMAP.md).
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.core import features


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lo", type=int, default=4)
    ap.add_argument("--hi", type=int, default=1024)
    ap.add_argument("--windows", type=int, default=16)
    args = ap.parse_args()
    torch.set_num_threads(1)
    reference = jax.jit(lambda w: jnp.abs(jnp.fft.rfft(
        w - jnp.mean(w, axis=-1, keepdims=True), axis=-1)) ** 2)
    differ = []
    for n in range(args.lo, args.hi + 1):
        x = np.random.default_rng(n).gamma(
            2.0, 30.0, size=(args.windows, n)).astype(np.float32)
        want = np.asarray(reference(jnp.asarray(x)))[:, 1:]
        got = features.power_spectrum(torch.as_tensor(x)).numpy()
        if np.array_equal(got, want):
            continue
        diff = np.abs(got - want)
        per_bin = float(np.max(diff / np.maximum(np.abs(want), 1e-30)))
        per_window = float(np.max(diff / want.max(-1, keepdims=True)))
        differ.append(n)
        print(n, per_bin, per_window, features._factorize(n), flush=True)
    print("differ:", differ)


if __name__ == "__main__":
    main()
