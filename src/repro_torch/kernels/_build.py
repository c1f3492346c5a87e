"""Build and load the port's CUDA kernels, lazily, at first kernel use.

One ``torch.utils.cpp_extension.load`` call compiles every ``csrc/*.cu``
source for Hopper (``sm_90a``) plus the small binding ``binding.cpp``,
the only file that includes PyTorch's headers. The build goes to
``build/repro_torch_kernels/`` at the root of the checkout. Importing
``repro_torch`` never touches ``nvcc``.

Flags: ``-fmad=false`` keeps every product from fusing into an add, and
no fast-math flag is passed, so divisions stay IEEE; both are what makes
the kernels agree bit for bit with their plain PyTorch versions.
"""
from __future__ import annotations

import functools
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "binding.cpp", CSRC / "plant_block.cu",
           CSRC / "episode_block.cu", CSRC / "policy_signals.cu",
           CSRC / "window_features.cu", CSRC / "gbdt_tables.cu",
           CSRC / "holt_winters.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-fmad=false")


@functools.cache
def extension():
    """The compiled extension module (built on the first call)."""
    from torch.utils.cpp_extension import load
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return load(name="repro_torch_kernels",
                sources=[str(s) for s in SOURCES],
                build_directory=str(BUILD_DIR),
                extra_cflags=["-O3"],
                extra_cuda_cflags=list(CUDA_FLAGS),
                verbose=False)
