"""Production mesh construction (port of ``repro.launch.mesh``).

The reference builds a 16x16 (or 2x16x16) TPU mesh, or a small debug mesh
of host devices. The PyTorch/CUDA port runs on a single device, so both
functions raise ``dist.sharding``'s single-device error. Importing this
module touches no device.
"""
from __future__ import annotations

from repro_torch.dist import sharding as shd


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16x16 single-pod or 2x16x16 multi-pod mesh: no
    single-device counterpart."""
    raise shd.unsupported(
        f"make_production_mesh(multi_pod={multi_pod})")


def make_debug_mesh(n_data: int = 2, n_model: int = 2):
    """The reference's small host-device mesh for integration tests: no
    single-device counterpart."""
    raise shd.unsupported(f"make_debug_mesh({n_data}, {n_model})")
