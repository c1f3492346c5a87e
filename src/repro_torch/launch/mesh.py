"""Mesh construction (port of ``repro.launch.mesh``; functions, not
module constants: importing this module touches no device).

The reference builds a 16x16 (or 2x16x16) TPU mesh of ("data", "model"),
or a small debug mesh of host devices. The port's mesh shards the fleet
plane's lanes in one process (``dist.sharding``): the production mesh is
a ("data",) mesh over every visible card; the multi-pod mesh spans hosts
and raises.
"""
from __future__ import annotations

import torch

from repro_torch.dist import sharding as shd


def make_production_mesh(*, multi_pod: bool = False) -> shd.Mesh:
    """A ("data",) mesh over every visible card (``cuda:0`` ..
    ``cuda:n-1``); raises without one, and for the reference's 2x16x16
    multi-pod mesh."""
    if multi_pod:
        raise shd.unsupported("make_production_mesh(multi_pod=True) (the "
                              "2x16x16 mesh across hosts)")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("make_production_mesh needs a CUDA device; "
                           "make_debug_mesh(device='cpu') builds a mesh of "
                           "the CPU")
    return shd.Mesh([torch.device("cuda", i) for i in range(n)])


def make_debug_mesh(n_data: int = 2, n_model: int = 2,
                    device="cpu") -> shd.Mesh:
    """The reference's small test mesh: ("data", "model") of n_data x
    n_model entries, every one `device` (the CPU by default, or one card:
    a logical mesh). Lane sharding runs over its data axis; a model
    helper that meets it raises."""
    dev = torch.device(device)
    return shd.Mesh([dev] * (n_data * n_model), ("data", "model"),
                    (n_data, n_model))
