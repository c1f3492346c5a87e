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

`params_from_reference` carries a model's parameters across
(``jax.tree.map(np.asarray, repro.models.model.init(key, cfg))``), and
`cache_from_reference` a prefill/decode cache: the reference's
layer-stacked subtrees (its ``lax.scan`` layout) become the port's
per-layer lists, and every array keeps its dtype (bf16 and fp8 included).
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


#: top-level subtrees the reference stacks along a leading layer axis for
#: lax.scan, in a model's parameters and in its cache
_STACKED_PARAMS = ("layers", "enc_layers", "dec_layers")
_STACKED_CACHE = ("layers", "shared", "dec")
_LOW_PRECISION = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


def _model_leaf(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name in _LOW_PRECISION:       # ml_dtypes arrays, exactly
        return torch.tensor(a.astype(np.float32)).to(
            device=dev, dtype=getattr(torch, a.dtype.name))
    return torch.tensor(a).to(dev)


def _unstack(tree: dict) -> list[dict]:
    def n_of(t):
        return n_of(next(iter(t.values()))) if isinstance(t, dict) \
            else np.asarray(t).shape[0]

    def take(t, i):
        return {k: take(v, i) for k, v in t.items()} \
            if isinstance(t, dict) else np.asarray(t)[i]
    return [take(tree, i) for i in range(n_of(tree))]


def _model_tree(tree, dev, stacked: tuple = ()):
    """Leaves to tensors; the top-level `stacked` subtrees to per-layer
    lists."""
    if isinstance(tree, dict):
        return {k: ([_model_tree(x, dev) for x in _unstack(v)]
                    if k in stacked and isinstance(v, dict)
                    else _model_tree(v, dev)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_model_tree(x, dev) for x in tree]
    return _model_leaf(tree, dev)


def _check_layers(tree, cfg) -> None:
    key = "dec_layers" if cfg.family == "encdec" else "layers"
    if key in tree and len(tree[key]) != cfg.n_layers - (
            0 if cfg.family == "encdec" else cfg.first_k_dense):
        raise ValueError(f"{len(tree[key])} {key} for {cfg.name}, whose "
                         f"config has n_layers={cfg.n_layers}")


def params_from_reference(params, cfg, device="cuda") -> dict:
    """The reference's parameter pytree (NumPy leaves) for `cfg` (a
    ``repro_torch.models.common.ModelConfig``) -> the port's parameters,
    tensors on `device`. A block's or layer's own parameters (such as
    ``init_moe``'s) carry across as they are."""
    out = _model_tree(params, _device.resolve(device), _STACKED_PARAMS)
    _check_layers(out, cfg)
    return out


def cache_from_reference(cache, cfg, device="cuda") -> dict:
    """The reference's prefill/decode cache (NumPy leaves) -> the port's
    per-layer cache on `device`, for `models.model.decode_step`."""
    out = _model_tree(cache, _device.resolve(device), _STACKED_CACHE)
    if cfg.family == "encdec" and len(out["dec"]) != cfg.n_layers:
        raise ValueError(f"{len(out['dec'])} decoder caches for {cfg.name}")
    return out
