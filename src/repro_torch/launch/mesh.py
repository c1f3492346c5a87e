"""Mesh construction (port of ``repro.launch.mesh``; functions, not
module constants: importing this module touches no device).

The reference builds a 16x16 (or 2x16x16) TPU mesh of ("data", "model"),
or a small debug mesh of host devices. The port builds one of two kinds
(``dist.sharding``): inside an initialized ``torch.distributed`` world, a
world mesh of its ranks, one process per card, that shards models;
outside one, a one-process lane mesh that shards the fleet plane's lanes.
The multi-pod mesh spans hosts and raises.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist import sharding as shd


def _in_world() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_production_mesh(*, multi_pod: bool = False) -> shd.Mesh:
    """Inside a world: its ranks over ("data", "model") = (world size,
    1), every card a data-parallel rank with the model FSDP-sharded over
    all of them (the layout of the least bytes a card for the port's
    configurations; ``make_debug_mesh`` takes other splits). Outside
    one: a ("data",) lane mesh over every visible card (``cuda:0`` ..
    ``cuda:n-1``); raises without one. The reference's 2x16x16 multi-pod
    mesh raises."""
    if multi_pod:
        raise shd.unsupported("make_production_mesh(multi_pod=True) (the "
                              "2x16x16 mesh across hosts)")
    if _in_world():
        return shd.Mesh.over_world(("data", "model"),
                                   (dist.get_world_size(), 1))
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("make_production_mesh needs a CUDA device; "
                           "make_debug_mesh(device='cpu') builds a mesh of "
                           "the CPU")
    return shd.Mesh([torch.device("cuda", i) for i in range(n)])


def make_debug_mesh(n_data: int = 2, n_model: int = 2,
                    device="cpu") -> shd.Mesh:
    """The reference's small test mesh: ("data", "model") of n_data x
    n_model entries. Inside a world of n_data * n_model ranks, its ranks
    (`device` is each rank's own; it must be of that type); outside one,
    a lane mesh whose every entry is `device` (the CPU by default, or one
    card: a logical mesh), whose data axis shards lanes and under which a
    model helper raises."""
    dev = torch.device(device)
    if _in_world():
        mesh = shd.Mesh.over_world(("data", "model"), (n_data, n_model))
        if mesh.device.type != dev.type:
            raise ValueError(f"make_debug_mesh(device={str(device)!r}) in "
                             f"a world whose ranks hold {mesh.device.type}")
        return mesh
    return shd.Mesh([dev] * (n_data * n_model), ("data", "model"),
                    (n_data, n_model))
