"""AdamW without ``torch.optim`` (port of ``repro.train.optimizer``), in
the reference's mixed-precision layout:

* model params stored and computed in their own dtype (bf16 at full
  width),
* f32 master weights and f32 first and second moments in the optimizer
  state.

`apply` is the reference's arithmetic in its order, as XLA compiles it:
a division by a constant (``step / warmup_steps``) is a multiply by the
constant's f32 reciprocal, the divisions by tensors stay IEEE quotients,
``b ** t`` and the scalar square root are rounded once from f64, the
squared norm sums the per-leaf sums in leaf order, XLA's rewrite of
``(m / bc1) / d`` into ``m / (bc1 * d)`` is taken, and the three
multiply-adds it contracts (the two moments' decay and the master's
update) are fused (`_fma`).

Trees are the port's parameter trees: dicts, lists, tuples and
NamedTuples of tensors. `leaves` takes a dict's keys in sorted order, as
``jax.tree`` does, so leaf ``i`` of a tree of plain dicts is the same
array in both packages (``train.checkpoint`` numbers its leaves so).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import _device, _numerics
from repro_torch.dist import collectives as coll

F32 = torch.float32
F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


class OptState(NamedTuple):
    step: torch.Tensor   # 0-d int32 on the params' device
    master: Any          # f32 master weights
    m: Any               # f32 first moment
    v: Any               # f32 second moment


def leaves(tree) -> list:
    """The leaves of `tree` in ``jax.tree.leaves`` order (dict keys
    sorted; None holds no leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [] if tree is None else [tree]


def unflatten(like, flat):
    """A tree of `like`'s structure (and key order) whose leaves are
    `flat`, taken in `leaves` order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of `tree` and of the same-shaped `rest`."""
    return unflatten(tree, [fn(*xs) for xs in
                            zip(leaves(tree), *(leaves(r) for r in rest))])


def init(params) -> OptState:
    return OptState(
        step=torch.zeros((), dtype=torch.int32,
                         device=leaves(params)[0].device),
        master=tree_map(lambda p: p.detach().to(F32, copy=True), params),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                         device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                         device=p.device), params))


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.to(F32) * _numerics.recip(max(cfg.warmup_steps,
                                                          1)), max=1.0)
    return cfg.lr * warm


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as XLA's contracted multiply-add, up
    to a double rounding: the f64 product of two f32 values is exact, and
    the f64 sum rounded to f32 is one ulp off about once in 2^29
    (``_numerics.fma`` is exact at about three times the bytes)."""
    return (a.to(F64) * b.to(F64) + c.to(F64)).to(F32)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root: CUDA's ``sqrtf`` is; on the
    CPU PyTorch's vectorized one is not, so it is rounded from f64."""
    return _numerics.sqrt(x) if x.device.type == "cpu" else torch.sqrt(x)


@torch.no_grad()
def apply(grads, params, opt: OptState, cfg: AdamWConfig, *,
          shardings=None):
    """Full AdamW step. Returns (new_params (model dtype), new_opt,
    gnorm); every returned tensor is new.

    With `shardings` (the params' ``dist.sharding.NamedSharding`` tree on
    a world mesh) every tree holds this rank's blocks; the update is
    elementwise, and the norm that clips is the global one: the squared
    sums of the blocks this rank owns (a block held alike by several
    ranks counts once), summed over the world."""
    flat_g = leaves(grads)
    dev = flat_g[0].device
    sums = [torch.sum(torch.square(g.to(F32))) for g in flat_g]
    if shardings is not None:
        shs = leaves(shardings)
        mesh = shs[0].mesh
        owned = [s for s, sh in zip(sums, shs) if sh.owned()]
        total = torch.zeros((), dtype=F32, device=dev)
        for s in owned:
            total = total + s
        total = coll.all_reduce(total, mesh.group(mesh.axis_names))
    else:
        total = sums[0]
        for s in sums[1:]:
            total = total + s
    gnorm = _numerics.sqrt(total)
    scale = torch.clamp(_device.const(cfg.grad_clip, dev) / (gnorm + 1e-9),
                        max=1.0)
    step = opt.step + 1
    lr = _schedule(cfg, step)
    t = step.to(F32)
    b1, b2 = _device.const(cfg.b1, dev), _device.const(cfg.b2, dev)
    bc1 = 1.0 - _numerics.rounded(torch.pow, b1, t)
    bc2 = 1.0 - _numerics.rounded(torch.pow, b2, t)

    new_p, new_ma, new_m, new_v = [], [], [], []
    for g, p, ma, m, v in zip(flat_g, leaves(params), leaves(opt.master),
                              leaves(opt.m), leaves(opt.v)):
        g = g.to(F32) * scale
        m1 = _fma(b1, m, (1 - cfg.b1) * g)
        v1 = _fma(b2, v, (1 - cfg.b2) * g * g)
        ma1 = _fma(-lr, m1 / (bc1 * (_sqrt(v1 / bc2) + cfg.eps))
                   + cfg.weight_decay * ma, ma)
        new_p.append(ma1.to(p.dtype))
        new_ma.append(ma1)
        new_m.append(m1)
        new_v.append(v1)

    return (unflatten(params, new_p),
            OptState(step, unflatten(params, new_ma),
                     unflatten(params, new_m), unflatten(params, new_v)),
            gnorm)
