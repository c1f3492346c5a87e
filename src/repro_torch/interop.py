"""Carry state across from the JAX reference and back, as NumPy arrays.

`from_reference` takes a reference ``SimState`` (with its
``LimiterState`` and an ``HPAState``, ``PredState``, ``KPAState`` or
``AAPAState``, whose forecaster carry is an ``FState`` over an
``HWState``), a ``ConformalBand``, ``MinuteOut`` or
``EpisodeMetrics`` whose leaves are NumPy arrays (``jax.tree.map(np.asarray,
tree)``), or tuples and lists of them, and returns the port's NamedTuple
of the same name with tensors on `device`. `to_numpy` goes the other
way: the same NamedTuple types with NumPy leaves, whose fields line up
with the reference's so ``RefType(*fields)`` rebuilds it. Python numbers
(such as a minute index) pass through unchanged.

`trained_from_reference` carries a trained AAPA classifier across: a
reference ``TrainedAAPA`` (its arrays as NumPy, or JAX arrays that NumPy
can read) or the npz its ``save`` writes.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core import calibration, gbdt
from repro_torch.core.forecasting import HWState
from repro_torch.core.pipeline import TrainedAAPA
from repro_torch.evals.metrics import EpisodeMetrics
from repro_torch.forecast.api import FState
from repro_torch.forecast.conformal import ConformalBand
from repro_torch.scaling.api import LimiterState
from repro_torch.scaling.policies import (AAPAState, HPAState, KPAState,
                                          PredState)
from repro_torch.sim.cluster import MinuteOut, SimState

_TYPES = {t.__name__: t for t in (SimState, LimiterState, HPAState,
                                  PredState, KPAState, AAPAState, FState,
                                  HWState, ConformalBand, MinuteOut,
                                  EpisodeMetrics)}


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
            out = port(*(conv(v) for v in x))
            if port is ConformalBand:          # its nominal level is a float
                out = out._replace(alpha=float(np.asarray(x.alpha)))
            return out
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


def trained_from_reference(trained, device="cuda") -> TrainedAAPA:
    """A reference ``TrainedAAPA``, or the path of the npz its ``save``
    writes, -> the port's ``TrainedAAPA`` with tensors on `device`."""
    if isinstance(trained, (str, os.PathLike)):
        return TrainedAAPA.load(trained, device=device)
    p, c = trained.params, trained.cal
    return TrainedAAPA(
        params=gbdt.from_arrays(p.feat, p.thresh, p.leaf, p.bin_edges,
                                p.base, device=device),
        cal=calibration.from_arrays(c.a_raw, c.b_raw, c.c, device=device),
        train_acc=float(trained.train_acc), val_acc=float(trained.val_acc),
        test_acc=float(trained.test_acc),
        label_dist=np.asarray(trained.label_dist),
        n_windows=int(trained.n_windows),
        fit_seconds=float(trained.fit_seconds),
        dataset_id=str(trained.dataset_id))
