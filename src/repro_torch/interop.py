"""Carry state across from the JAX reference and back, as NumPy arrays.

`from_reference` takes a reference ``SimState`` (with its
``LimiterState`` and ``HPAState``), ``MinuteOut`` or ``EpisodeMetrics``
whose leaves are NumPy arrays (``jax.tree.map(np.asarray,
tree)``), or tuples and lists of them, and returns the port's NamedTuple
of the same name with tensors on `device`. `to_numpy` goes the other
way: the same NamedTuple types with NumPy leaves, whose fields line up
with the reference's so ``RefType(*fields)`` rebuilds it. Python numbers
(such as a minute index) pass through unchanged.

HPA has no trained weights: this slice's state is plant and controller
state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import _device
from repro_torch.evals.metrics import EpisodeMetrics
from repro_torch.scaling.api import LimiterState
from repro_torch.scaling.policies import HPAState
from repro_torch.sim.cluster import MinuteOut, SimState

_TYPES = {t.__name__: t for t in (SimState, LimiterState, HPAState,
                                  MinuteOut, EpisodeMetrics)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def from_reference(tree, device="cuda"):
    """Reference tree with NumPy leaves -> the port's tree of tensors."""
    dev = _device.resolve(device)

    def conv(x):
        if _is_namedtuple(x):
            name = type(x).__name__
            if name not in _TYPES:
                raise TypeError(f"no port counterpart for {name}; "
                                f"known: {sorted(_TYPES)}")
            port = _TYPES[name]
            if port._fields != x._fields:
                raise TypeError(f"{name} fields differ: reference "
                                f"{x._fields}, port {port._fields}")
            return port(*(conv(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(conv(v) for v in x)
        if isinstance(x, (int, float)):
            return x
        return torch.as_tensor(np.array(x)).to(dev)

    return conv(tree)


def to_numpy(tree):
    """The port's tree of tensors -> the same structure with NumPy
    leaves."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if _is_namedtuple(tree):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree
