"""Collectives over a process group, and the autograd forms that turn the
reference's GSPMD and ``shard_map`` into explicit per-rank code.

Every rank of a world mesh runs the same program on its own rows of the
batch and differentiates the same scalar loss, so a value that all
members of a group hold alike (a replicated activation, the loss) gets
the same cotangent on each of them. That fixes each backward pass:

* `gather_params` (ZeRO-3): all-gather a parameter's blocks; each member
  uses the full parameter on its own rows, so the gradient is summed over
  the group and each member keeps its block (reduce-scatter).
* `sum_grads`: a replicated input used on each member's own rows; its
  gradient is summed over the group (all-reduce).
* `gather_replicated`: all-gather results that every member then uses
  alike; each member's cotangent already is the whole one, so it keeps
  its own block of it.
* `own_slice`: each member takes its block of a value it holds alike
  with the others (the expert-parallel column's tokens); the cotangent of
  the whole is the members' blocks joined (all-gather).
* `sum_replicated`: the sum of each member's partial value, which every
  member then uses alike (the loss's token sum, the MoE aux loss); each
  member's cotangent is its own.
* `all_to_all`: blocks along dim 0 exchanged (block i to member i); its
  own transpose.

A group of one member is the identity everywhere. No function here falls
back to another backend or device: a collective that fails raises.

A `ShapeGroup` stands for a group in a shape-only trace on the meta device
(``launch.dryrun``'s records under a mesh): each collective over it
returns a result of the right shape and adds its traffic to the group's
`Tally` by the reference's ring factors (``launch.dryrun
.parse_collectives``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


# the names PyTorch 2.13 gives the flat collectives; older releases have
# only the earlier ones
_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def ring_bytes(kind: str, result_bytes: float, g: int) -> float:
    """The bytes a member moves for one collective of `kind` over `g`
    members whose result is `result_bytes` on it (the reference's ring
    factors, ``parse_collectives``' docstring)."""
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1.0) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1.0)
    if kind in ("all-gather", "all-to-all"):
        return result_bytes * (g - 1.0) / g
    return float(result_bytes)


class Tally:
    """Bytes and counts of collectives by kind (``parse_collectives``'
    record)."""

    def __init__(self):
        self.bytes = {k: 0.0 for k in KINDS}
        self.counts = {k: 0 for k in KINDS}

    def add(self, kind: str, result: torch.Tensor, g: int) -> None:
        self.bytes[kind] += ring_bytes(
            kind, result.numel() * result.element_size(), g)
        self.counts[kind] += 1


class _Process:
    """A ``torch.distributed`` process group: its collectives run."""

    def __init__(self, group):
        self.group = group

    def size(self) -> int:
        return dist.get_world_size(self.group)

    def rank(self) -> int:
        return dist.get_rank(self.group)

    def all_gather(self, out, x) -> None:
        _GATHER(out, x, group=self.group)

    def reduce_scatter(self, out, x) -> None:
        _SCATTER(out, x, op=dist.ReduceOp.SUM, group=self.group)

    def all_reduce(self, out) -> None:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)

    def all_to_all(self, out, x) -> None:
        dist.all_to_all_single(out, x, group=self.group)


class ShapeGroup:
    """A group of `n` members seen from member `rank` in a trace on the
    meta device: its collectives (`_Process`'s methods) move nothing and
    add to `tally`."""

    def __init__(self, n: int, tally: Tally, rank: int = 0):
        self.n, self.tally, self._rank = int(n), tally, int(rank)

    def size(self) -> int:
        return self.n

    def rank(self) -> int:
        return self._rank

    def all_gather(self, out, x) -> None:
        self.tally.add("all-gather", out, self.n)

    def reduce_scatter(self, out, x) -> None:
        self.tally.add("reduce-scatter", out, self.n)

    def all_reduce(self, out) -> None:
        self.tally.add("all-reduce", out, self.n)

    def all_to_all(self, out, x) -> None:
        self.tally.add("all-to-all", out, self.n)


def _on(group):
    """`group`'s collectives: a `ShapeGroup`'s own, or a process
    group's."""
    return group if isinstance(group, ShapeGroup) else _Process(group)


def size(group) -> int:
    return _on(group).size()


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The members' blocks of `x` joined along `dim`, in group-rank
    order."""
    on = _on(group)
    n = on.size()
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    on.all_gather(out, xt)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The members' `x` summed, and this member's block of the sum along
    `dim`."""
    on = _on(group)
    n = on.size()
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    on.reduce_scatter(out, xt)
    return out.movedim(0, dim).contiguous()


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The members' `x` summed (a new tensor)."""
    on = _on(group)
    out = x.clone()
    if on.size() > 1:
        on.all_reduce(out)
    return out


def block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This member's block of `x` along `dim`."""
    on = _on(group)
    k = x.shape[dim] // on.size()
    return x.narrow(dim, on.rank() * k, k)


def exchange(x: torch.Tensor, group) -> torch.Tensor:
    """Block i of `x` along dim 0 to member i; block i of the result came
    from member i."""
    on = _on(group)
    if on.size() == 1:
        return x
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    on.all_to_all(out, x.contiguous())
    return out


class _GatherParams(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return block(g, ctx.dim, ctx.group).contiguous(), None, None


class _OwnSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return block(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return exchange(g, ctx.group), None


def gather_params(x, dim: int, group):
    return x if size(group) == 1 else _GatherParams.apply(x, dim, group)


def sum_grads(x, group):
    return x if size(group) == 1 else _SumGrads.apply(x, group)


def gather_replicated(x, dim: int, group):
    return x if size(group) == 1 else _GatherReplicated.apply(x, dim, group)


def own_slice(x, dim: int, group):
    return x if size(group) == 1 else _OwnSlice.apply(x, dim, group)


def sum_replicated(x, group):
    return x if size(group) == 1 else _SumReplicated.apply(x, group)


def all_to_all(x, group):
    return x if size(group) == 1 else _Exchange.apply(x, group)
