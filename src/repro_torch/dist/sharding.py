"""Logical-axis sharding, single device (port of ``repro.dist.sharding``).

The model code constrains activations with logical names
(``shd.constrain(h, ("dp", "mp", None))``). With no active mesh the
reference's helpers are the identity, and that is all this port has:
it runs on one card. `set_mesh(None)`, `active()` and `constrain` keep
the reference's no-mesh semantics; activating a mesh and the tree
shardings (`param_shardings`, `batch_shardings`, `cache_shardings`,
`lane_sharding`) raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any

_SINGLE = ("the PyTorch/CUDA port runs on a single device; {what} has no "
           "single-device counterpart")


def set_mesh(mesh) -> None:
    """`None` deactivates (a no-op here); a mesh raises."""
    if mesh is not None:
        raise NotImplementedError(_SINGLE.format(what="set_mesh(mesh)"))
    return None


def active() -> None:
    """The active mesh rules: always None on one device."""
    return None


def constrain(x, logicals):
    """The identity, as the reference's `constrain` without a mesh."""
    del logicals
    return x


def lane_sharding(shape, *, w_axis: int = 1, strict: bool = False):
    raise NotImplementedError(_SINGLE.format(what="lane_sharding"))


def param_shardings(tree: Any):
    raise NotImplementedError(_SINGLE.format(what="param_shardings"))


def batch_shardings(tree: Any):
    raise NotImplementedError(_SINGLE.format(what="batch_shardings"))


def cache_shardings(cache: Any, cfg):
    raise NotImplementedError(_SINGLE.format(what="cache_shardings"))
