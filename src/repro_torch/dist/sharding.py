"""Logical-axis sharding and the device mesh (port of
``repro.dist.sharding``).

A `Mesh` lays an ordered list of ``torch.device``s over named axes
(``("data",)``, or ``("data", "model")``); its `shape` reads as
``jax.make_mesh``'s (``{"data": 8}``). A mesh may list one device several
times, as XLA's forced host devices do, so a one-card machine and the CPU
run the same split and fold code at several shards.

    rules = shd.set_mesh(launch.mesh.make_production_mesh())

activates it for the fleet plane. `MeshRules` resolves the logical names
as the reference's do ("dp" every data-parallel axis present, "mp" the
"model" axis); a dimension an axis does not divide is replicated, logged
once per (logical, size, dim), or raises with ``strict=True``.

The port shards **lanes**: `lane_sharding(shape, w_axis=...)` splits the
workload axis of the simulator's arrays into contiguous slices, one per
device of the data axes, and `scatter` / `gather` place a tensor by it and
bring it back in shard order (``scaling.batch``, ``evals.matrix``; the
fleet runner and the AAPAset build place whole chunks on `lane_devices()`
round-robin). Lanes are independent, so a sharded run is the unsharded
one. The mesh alone places the lanes: a caller's `device` of another
type than the mesh's raises (`check_device`).

**Model sharding** is not ported: the tree shardings (`param_shardings`,
`batch_shardings`, `cache_shardings`) and `constrain` under an active mesh
raise ``NotImplementedError`` (`unsupported`), so model code never runs
unsharded under a mesh without saying so. Without a mesh `constrain` is
the identity, as the reference's.
"""
from __future__ import annotations

import dataclasses
import itertools
import logging
import math
from typing import Any, Optional, Sequence

import torch

_LOG = logging.getLogger(__name__)
_WARNED: set[tuple] = set()      # (logical, axis_size, dim) already logged

_DATA_AXES = ("pod", "data")   # outer-to-inner data-parallel axes
_MODEL_AXIS = "model"

Logical = Optional[str]        # "dp" | "mp" | physical axis name | None

_MODEL = ("the PyTorch/CUDA port has no model sharding and spans no "
          "hosts: {what} needs parameters, activations, batches or caches "
          "split over a mesh, and the port runs each model on a single "
          "device (its mesh shards only the fleet plane's simulator "
          "lanes, in one process)")


def unsupported(what: str) -> NotImplementedError:
    """The error raised by every part of the reference that shards a model
    or spans hosts (here and in ``launch``, ``models.moe``,
    ``train.checkpoint``)."""
    return NotImplementedError(_MODEL.format(what=what))


class P(tuple):
    """A partition spec: one entry per dimension, an axis name, a tuple
    of axis names, or None (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"



class Mesh:
    """`devices` laid out row-major over `axis_names` of `axis_sizes`
    (default: one axis over all of them)."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str] =
                 ("data",), axis_sizes: Sequence[int] | None = None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        sizes = ((len(self.devices),) if axis_sizes is None
                 else tuple(int(s) for s in axis_sizes))
        if (len(sizes) != len(self.axis_names) or not self.devices
                or math.prod(sizes) != len(self.devices)
                or len(set(self.axis_names)) != len(self.axis_names)):
            raise ValueError(f"a mesh of {len(self.devices)} devices cannot "
                             f"take axes {self.axis_names} of sizes {sizes}")
        self.shape = dict(zip(self.axis_names, sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_devices(self, axes: Sequence[str]) -> tuple[torch.device, ...]:
        """The devices along `axes` (row-major), every other axis at its
        first index."""
        sizes = tuple(self.shape.values())
        out = []
        for coord in itertools.product(*(range(s) for s in sizes)):
            if all(c == 0 for name, c in zip(self.axis_names, coord)
                   if name not in axes):
                flat = 0
                for c, s in zip(coord, sizes):
                    flat = flat * s + c
                out.append(self.devices[flat])
        return tuple(out)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{sorted({str(d) for d in self.devices})})")


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Resolved logical->physical axis mapping for one mesh."""

    mesh: Any                  # Mesh, or anything with its `shape`
    dp: tuple[str, ...]        # physical data axes present in the mesh
    mp: str | None             # physical model axis, if present

    def resolve(self, logical: Logical):
        """Logical name -> PartitionSpec entry (axis name, tuple, or None)."""
        if logical is None:
            return None
        if logical == "dp":
            if not self.dp:
                return None
            return self.dp if len(self.dp) > 1 else self.dp[0]
        if logical == "mp":
            return self.mp
        return logical if logical in self.mesh.shape else None

    def axis_size(self, logical: Logical) -> int:
        if logical is None:
            return 1
        if logical == "dp":
            return math.prod(self.mesh.shape[a] for a in self.dp) \
                if self.dp else 1
        if logical == "mp":
            return self.mesh.shape[self.mp] if self.mp else 1
        return self.mesh.shape.get(logical, 1)

    def spec(self, logicals, shape, *, strict: bool = False) -> P:
        """Build a PartitionSpec, dropping axes that don't divide dims.

        A requested axis that doesn't evenly divide its dimension is
        replicated (and logged once per (logical, size, dim) triple);
        with ``strict=True`` it raises instead, so fleet-scale runs
        can't silently lose their sharding."""
        entries = []
        for i, dim in enumerate(shape):
            logical = logicals[i] if i < len(logicals) else None
            size = self.axis_size(logical)
            phys = self.resolve(logical)
            if phys is None or size <= 1:
                entries.append(None)
            elif dim % size != 0:
                if strict:
                    raise ValueError(
                        f"axis {logical!r} (size {size}) does not divide "
                        f"dim {i} of shape {tuple(shape)}; pad the dim or "
                        f"drop strict= to replicate")
                key = (logical, size, dim)
                if key not in _WARNED:
                    _WARNED.add(key)
                    _LOG.warning(
                        "sharding axis %r (size %d) does not divide dim %d"
                        " — replicating (logged once per shape)",
                        logical, size, dim)
                entries.append(None)
            else:
                entries.append(phys)
        return P(*entries)


_ACTIVE: MeshRules | None = None


def set_mesh(mesh: Mesh | None) -> MeshRules | None:
    """Activate `mesh` for all subsequent helpers; None deactivates."""
    global _ACTIVE
    if mesh is None:
        _ACTIVE = None
        return None
    if not isinstance(mesh, Mesh):
        raise TypeError(f"set_mesh takes a repro_torch.dist.sharding.Mesh "
                        f"(launch.mesh.make_production_mesh, "
                        f"make_debug_mesh), got {type(mesh).__name__}")
    names = mesh.axis_names
    _ACTIVE = MeshRules(
        mesh=mesh,
        dp=tuple(a for a in _DATA_AXES if a in names),
        mp=_MODEL_AXIS if _MODEL_AXIS in names else None)
    return _ACTIVE


def active() -> MeshRules | None:
    return _ACTIVE


def constrain(x: torch.Tensor, logicals) -> torch.Tensor:
    """The identity without a mesh, as the reference's; under an active
    mesh it would split an activation over it, which is model sharding."""
    if _ACTIVE is not None:
        raise unsupported(f"constrain(x, {tuple(logicals)}) under an "
                          f"active mesh")
    return x


# --------------------------------------------------------- lane sharding ----
@dataclasses.dataclass(frozen=True)
class LaneSharding:
    """The workload axis `w_axis` of arrays of `shape` in contiguous
    slices, one per device of the mesh's data axes (`spec` names the
    axis), or whole on the first of them when `spec` replicates it."""

    mesh: Mesh
    spec: P
    shape: tuple[int, ...]
    w_axis: int

    @property
    def devices(self) -> tuple[torch.device, ...]:
        """The device of each shard, in shard order."""
        lanes = self.mesh.axis_devices(_DATA_AXES)
        return lanes if self.spec[self.w_axis] is not None else lanes[:1]

    def bounds(self) -> list[tuple[int, int]]:
        """Each shard's [lo, hi) of the workload axis."""
        n, W = len(self.devices), self.shape[self.w_axis]
        return [(i * W // n, (i + 1) * W // n) for i in range(n)]


def lane_sharding(shape, *, w_axis: int = 1,
                  strict: bool = False) -> LaneSharding | None:
    """The sharding of the simulator's fused lane arrays: the workload
    axis (`w_axis`, default 1 for [P, W, ...] batches; pass 0 for a bare
    [W] / [W, M] tensor, 2 for the matrix runner's [S, Z, W, M]) shards
    over "dp", everything else replicates. Returns None with no active
    mesh so callers can skip the placement."""
    rules = _ACTIVE
    if rules is None:
        return None
    shape = tuple(int(d) for d in shape)
    w_axis = w_axis % max(len(shape), 1)
    logicals = tuple("dp" if i == w_axis else None
                     for i in range(len(shape)))
    return LaneSharding(rules.mesh,
                        rules.spec(logicals, shape, strict=strict),
                        shape, w_axis)


def lane_devices() -> tuple[torch.device, ...] | None:
    """The devices of the active mesh's data axes, in order (None without
    a mesh): where the fleet runner and the AAPAset build place their
    chunks round-robin."""
    rules = _ACTIVE
    return None if rules is None else rules.mesh.axis_devices(_DATA_AXES)


def check_device(device) -> None:
    """Under an active mesh, raise ValueError unless every device of its
    data axes is of `device`'s type: the mesh places the lanes, and a
    caller's `device` of another type (a CPU mesh with ``"cuda"``, a mesh
    of cards with ``"cpu"``) would pick the kernel or the plain path for
    tensors that sit elsewhere."""
    devs = lane_devices()
    kind = torch.device(device).type
    if devs is not None and any(d.type != kind for d in devs):
        raise ValueError(
            f"device {str(device)!r} disagrees with the active mesh's "
            f"devices {sorted({str(d) for d in devs})}: under a mesh the "
            f"mesh places the lanes; pass a device of its type or "
            f"deactivate it (set_mesh(None))")


def placement(device) -> tuple[torch.device, ...]:
    """Where a caller asked for `device` runs its chunks round-robin: the
    active mesh's data-axis devices (`check_device` first), or `device`
    alone."""
    check_device(device)
    return lane_devices() or (torch.device(device),)


def scatter(x, sharding: LaneSharding) -> list[torch.Tensor]:
    """`x` (a tensor or array of `sharding.shape`) as its shards, each
    contiguous on its shard's device."""
    x = torch.as_tensor(x)
    if tuple(x.shape) != sharding.shape:
        raise ValueError(f"a sharding of {sharding.shape} got "
                         f"{tuple(x.shape)}")
    return [x.narrow(sharding.w_axis, lo, hi - lo).contiguous().to(dev)
            for dev, (lo, hi) in zip(sharding.devices, sharding.bounds())]


def gather(parts: Sequence[torch.Tensor], axis: int,
           device: torch.device) -> torch.Tensor:
    """Shards in shard order joined along `axis` on `device`."""
    return torch.cat([p.to(device) for p in parts], axis)


# ------------------------------------------------------- tree shardings ----
def param_shardings(tree: Any):
    raise unsupported("param_shardings")


def batch_shardings(tree: Any):
    raise unsupported("batch_shardings")


def cache_shardings(cache: Any, cfg):
    raise unsupported("cache_shardings")
