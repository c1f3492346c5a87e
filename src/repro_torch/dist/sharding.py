"""Logical-axis sharding and the device mesh (port of
``repro.dist.sharding``).

A `Mesh` lays an ordered list of ``torch.device``s over named axes
(``("data",)``, or ``("data", "model")``); its `shape` reads as
``jax.make_mesh``'s (``{"data": 8}``). `MeshRules` resolves the logical
names as the reference's do ("dp" every data-parallel axis present, "mp"
the "model" axis); a dimension an axis does not divide is replicated,
logged once per (logical, size, dim), or raises with ``strict=True``.

A mesh is one of two kinds:

* **A lane mesh** (``Mesh(devices, ...)``) lives in one process and may
  list one device several times, as XLA's forced host devices do, so a
  one-card machine and the CPU run the same split and fold code at several
  shards. It shards **lanes**: `lane_sharding(shape, w_axis=...)` splits
  the workload axis of the simulator's arrays into contiguous slices, one
  per device of the data axes, and `scatter` / `gather` place a tensor by
  it and bring it back in shard order (``scaling.batch``,
  ``evals.matrix``; the fleet runner and the AAPAset build place whole
  chunks on `lane_devices()` round-robin). Lanes are independent, so a
  sharded run is the unsharded one. The mesh alone places the lanes: a
  caller's `device` of another type than the mesh's raises
  (`check_device`).
* **A world mesh** (`Mesh.over_world`, built by ``launch.mesh`` inside an
  initialized ``torch.distributed`` world) lays the world's ranks, one
  process per card (NCCL) or per CPU worker (gloo), over the axes row-major
  and gives each set of axes its process group. It shards **models**: the
  tree shardings (`param_shardings`, `batch_shardings`, `cache_shardings`)
  pair each leaf's `P` with the mesh in a `NamedSharding`; `device_put`
  keeps this rank's block of each leaf (``jax.device_put``'s counterpart)
  and `gather_tree` brings the full tensors back; `gather_for_use`
  gathers a layer's leaves over their data axes where the model uses them
  (``models.transformer``). Each rank holds only its own shards; the
  reference's GSPMD becomes explicit per-rank code (``dist.collectives``).
  Under a world mesh `constrain` checks that a tensor lies on this rank's
  device and returns it (it is already rank-local); the lane helpers
  raise.

Model code under a lane mesh raises (`unsupported`), so no model runs
unsharded under a mesh that asked for sharding without saying so. Without
a mesh `constrain` is the identity, as the reference's.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import logging
import math
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.dist import collectives as coll

_LOG = logging.getLogger(__name__)
_WARNED: set[tuple] = set()      # (logical, axis_size, dim) already logged

_DATA_AXES = ("pod", "data")   # outer-to-inner data-parallel axes
_MODEL_AXIS = "model"

Logical = Optional[str]        # "dp" | "mp" | physical axis name | None

# every process group of a world mesh waits this long for a collective
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

MULTI_POD = ("the reference's 2x16x16 multi-pod mesh spans 512 ranks "
             "across hosts, which no run of the port holds")
LANE_MESH = ("a one-process lane mesh lists devices, not processes, and "
             "holds no model's shards")
_MODEL = ("{what} is not in the PyTorch/CUDA port: {why}. The port's model "
          "sharding runs over a torch.distributed world, one process per "
          "card (launch.mesh.make_production_mesh or make_debug_mesh after "
          "init_process_group)")


def unsupported(what: str, why: str = MULTI_POD) -> NotImplementedError:
    """The error raised by what the port does not have: the multi-pod
    mesh across hosts (here and in ``launch``), and model code under a
    one-process lane mesh (`why` = `LANE_MESH`)."""
    return NotImplementedError(_MODEL.format(what=what, why=why))


class P(tuple):
    """A partition spec: one entry per dimension, an axis name, a tuple
    of axis names, or None (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"



class Mesh:
    """`devices` laid out row-major over `axis_names` of `axis_sizes`
    (default: one axis over all of them): a one-process lane mesh. A
    world mesh (`over_world`) also knows this process's `rank`, its
    `coords` and each set of axes' process group (`group`)."""

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
        self.rank: int | None = None
        self.coords: dict[str, int] | None = None
        self._groups: dict[tuple[str, ...], Any] = {}

    @classmethod
    def over_world(cls, axis_names: Sequence[str] = ("data", "model"),
                   axis_sizes: Sequence[int] | None = None) -> "Mesh":
        """The initialized ``torch.distributed`` world's ranks laid out
        row-major over `axis_names` (rank r at the mesh's r-th entry, as
        ``jax.make_mesh`` lays out ``jax.devices()``), each listed with its
        device: ``cuda:<current device>`` under NCCL, ``cpu`` otherwise.
        Every non-empty set of axes gets its process groups, each with
        DEFAULT_TIMEOUT (the set of all axes is the world's default group,
        with the timeout it was made with). A collective call: every rank
        builds the same meshes in the same order."""
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("Mesh.over_world needs an initialized "
                               "torch.distributed world "
                               "(init_process_group)")
        n, rank = dist.get_world_size(), dist.get_rank()
        if dist.get_backend() == "nccl":
            dev = torch.device("cuda", torch.cuda.current_device())
        else:
            dev = torch.device("cpu")
        devs: list = [None] * n
        dist.all_gather_object(devs, str(dev))
        mesh = cls(devs, axis_names, (n,) if axis_sizes is None
                   else axis_sizes)
        sizes = tuple(mesh.shape.values())
        coords = list(itertools.product(*(range(s) for s in sizes)))
        mesh.rank = rank
        mesh.coords = dict(zip(mesh.axis_names, coords[rank]))
        names = mesh.axis_names
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                if k == len(names):
                    mesh._groups[axes] = dist.group.WORLD
                    continue
                others = [i for i, a in enumerate(names) if a not in axes]
                by_rest: dict[tuple, list[int]] = {}
                for r, c in enumerate(coords):
                    by_rest.setdefault(tuple(c[i] for i in others),
                                       []).append(r)
                mesh._groups[axes], _ = dist.new_subgroups_by_enumeration(
                    list(by_rest.values()), timeout=DEFAULT_TIMEOUT)
        return mesh

    @classmethod
    def over_shapes(cls, axis_names: Sequence[str], axis_sizes:
                    Sequence[int], tally: coll.Tally) -> "Mesh":
        """A world mesh of `axis_sizes` seen from its rank 0 in one
        process, every entry the meta device and every set of axes a
        ``collectives.ShapeGroup`` adding to `tally`: the model's sharded
        code traced on shapes alone, with no world (``launch.dryrun``)."""
        mesh = cls(["meta"] * math.prod(axis_sizes), axis_names,
                   axis_sizes)
        mesh.rank = 0
        mesh.coords = {a: 0 for a in mesh.axis_names}
        for k in range(1, len(mesh.axis_names) + 1):
            for axes in itertools.combinations(mesh.axis_names, k):
                mesh._groups[axes] = coll.ShapeGroup(mesh.axis_size(axes),
                                                     tally)
        return mesh

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def is_world(self) -> bool:
        """Whether this mesh lays out a world's processes (`over_world`)."""
        return self.rank is not None

    @property
    def device(self) -> torch.device:
        """This rank's device (a world mesh's)."""
        return self.devices[self._world().rank]

    def _world(self) -> "Mesh":
        if not self.is_world:
            raise unsupported("a process group or a rank of this mesh",
                              LANE_MESH)
        return self

    def axes(self, entry) -> tuple[str, ...]:
        """A spec entry's axes (an axis name or a tuple of them), in mesh
        order; unknown axes and axes out of mesh order raise."""
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        pos = [self.axis_names.index(a) if a in self.axis_names else -1
               for a in axes]
        if -1 in pos or pos != sorted(set(pos)):
            raise ValueError(f"spec entry {entry!r} does not name axes "
                             f"of {self.axis_names} in mesh order")
        return axes

    def group(self, entry):
        """The process group over the axes of `entry` that holds this
        rank (its members differ only in those axes; their group ranks
        are their combined coordinate)."""
        return self._world()._groups[self.axes(entry)]

    def axis_size(self, entry) -> int:
        return math.prod(self.shape[a] for a in self.axes(entry))

    def index(self, entry, coords: dict[str, int] | None = None) -> int:
        """The combined row-major coordinate of `coords` (this rank's by
        default) along the axes of `entry`."""
        coords = self._world().coords if coords is None else coords
        i = 0
        for a in self.axes(entry):
            i = i * self.shape[a] + coords[a]
        return i

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
        kind = f", rank {self.rank}" if self.is_world else ""
        return (f"Mesh({self.shape}, "
                f"{sorted({str(d) for d in self.devices})}{kind})")


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


def model_rules() -> MeshRules | None:
    """The active rules when the active mesh is a world mesh (the model
    is sharded over it), else None."""
    rules = _ACTIVE
    return rules if rules is not None and rules.mesh.is_world else None


def constrain(x: torch.Tensor, logicals) -> torch.Tensor:
    """The identity without a mesh, as the reference's. Under a world
    mesh `x` is already this rank's block: it must lie on this rank's
    device and have a dimension for each logical name, and is returned.
    Under a lane mesh model code has no sharding and raises."""
    rules = _ACTIVE
    if rules is None:
        return x
    if not rules.mesh.is_world:
        raise unsupported(f"constrain(x, {tuple(logicals)}) under an "
                          f"active mesh", LANE_MESH)
    check_local(x, rules.mesh)
    if len(tuple(logicals)) > x.dim():
        raise ValueError(f"constrain: {tuple(logicals)} names more "
                         f"dimensions than x's shape {tuple(x.shape)}")
    return x


def check_local(x: torch.Tensor, mesh: Mesh) -> None:
    """Raise ValueError unless `x` lies on `mesh`'s device for this rank
    (a CUDA tensor on a gloo CPU mesh, or the reverse, never runs)."""
    if x.device.type != mesh.device.type or (
            x.device.type == "cuda" and x.device != mesh.device):
        raise ValueError(f"a tensor on {x.device} under a world mesh "
                         f"whose rank {mesh.rank} holds {mesh.device}")


# --------------------------------------------------------- lane sharding ----
def _lane_rules() -> MeshRules | None:
    """The active rules for the lane helpers; a world mesh shards models,
    not the fleet plane's lanes (one process places every lane)."""
    rules = _ACTIVE
    if rules is not None and rules.mesh.is_world:
        raise NotImplementedError(
            "lane sharding under a world mesh: the fleet plane runs in one "
            "process over a lane mesh (shd.Mesh(devices) or "
            "launch.mesh.make_production_mesh() outside a torch.distributed "
            "world)")
    return rules


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
    rules = _lane_rules()
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
    rules = _lane_rules()
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
@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's partition spec on a mesh (``jax.sharding.NamedSharding``):
    dimension i is split over the axes of ``spec[i]`` (contiguous blocks
    in their combined row-major coordinate) or replicated (None)."""

    mesh: Mesh
    spec: P

    def __post_init__(self):
        used = [a for e in self.spec if e is not None
                for a in self.mesh.axes(e)]
        if len(used) != len(set(used)):
            raise ValueError(f"{self.spec} names an axis twice")

    def entries(self, ndim: int) -> tuple:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} for a {ndim}-d leaf")
        return tuple(self.spec) + (None,) * (ndim - len(self.spec))

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The shape of each block of a leaf of `shape`."""
        out = []
        for d, e in zip(shape, self.entries(len(shape))):
            n = 1 if e is None else self.mesh.axis_size(e)
            if d % n:
                raise ValueError(f"{self.spec} does not divide "
                                 f"{tuple(shape)}")
            out.append(d // n)
        return tuple(out)

    def index(self, shape, coords: dict[str, int] | None = None
              ) -> tuple[slice, ...]:
        """The block of a leaf of `shape` held at `coords` (this rank's
        by default)."""
        block = self.shard_shape(shape)
        return tuple(slice(None) if e is None else slice(
            self.mesh.index(e, coords) * b, (self.mesh.index(e, coords) + 1)
            * b) for b, e in zip(block, self.entries(len(shape))))

    def replica_axes(self) -> tuple[str, ...]:
        """The mesh axes the spec does not name: the block is the same at
        every coordinate along them."""
        used = {a for e in self.spec if e is not None
                for a in self.mesh.axes(e)}
        return tuple(a for a in self.mesh.axis_names if a not in used)

    def owned(self) -> bool:
        """Whether this rank is its block's one owner (coordinate 0 on
        every replica axis): a sum over blocks counts each block once."""
        coords = self.mesh._world().coords
        return all(coords[a] == 0 for a in self.replica_axes())


def _path_name(path) -> str:
    return "/".join(str(p) for p in path)


def _map_with_path(fn, tree, path=()):
    """`fn(path, leaf)` over the port's trees (dicts, lists, tuples,
    NamedTuples; None holds no leaf), keeping their structure. A path
    names dict keys and sequence indices; a NamedTuple's fields add
    nothing, as ``jax.tree_util``'s attribute keys add nothing to the
    reference's path names."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(path, tree)


def _fsdp_spec(rules: MeshRules, shape) -> P:
    """ZeRO-3 style: shard the largest dp-divisible dim, replicate rest."""
    dp_size = rules.axis_size("dp")
    best = None
    if dp_size > 1 and len(shape) >= 1:
        divisible = [i for i, d in enumerate(shape)
                     if d % dp_size == 0 and d >= dp_size]
        if divisible:
            best = max(divisible, key=lambda i: shape[i])
    entries = [rules.resolve("dp") if i == best else None
               for i in range(len(shape))]
    return P(*entries)


def _rules(what: str) -> MeshRules:
    rules = _ACTIVE
    if rules is None:
        raise RuntimeError(f"{what} requires set_mesh(...) first")
    return rules


def param_shardings(tree: Any):
    """NamedSharding tree for params (or same-structured trees like the
    optimizer's master/m/v, or a whole train state). Expert weights shard
    E over "mp" and D over "dp" (the layout ``models.moe.moe_block_ep``
    takes); everything else is FSDP-sharded over "dp". Scalars and
    vectors replicate. Leaves need only a `shape` (meta tensors do)."""
    rules = _rules("param_shardings")

    def one(path, leaf):
        name = _path_name(path)
        shape = tuple(leaf.shape)
        if len(shape) <= 1:
            return NamedSharding(rules.mesh, P())
        if name.endswith(("w_gate", "w_up")) and len(shape) == 3:
            return NamedSharding(rules.mesh,
                                 rules.spec(("mp", "dp", None), shape))
        if name.endswith("w_down") and len(shape) == 3:
            return NamedSharding(rules.mesh,
                                 rules.spec(("mp", None, "dp"), shape))
        if name.endswith("router"):
            return NamedSharding(rules.mesh, P())
        return NamedSharding(rules.mesh, _fsdp_spec(rules, shape))

    return _map_with_path(one, tree)


def batch_shardings(tree: Any):
    """Shard the leading (batch) dim of every leaf over "dp"."""
    rules = _rules("batch_shardings")
    return _map_with_path(lambda path, leaf: NamedSharding(
        rules.mesh, rules.spec(("dp",), tuple(leaf.shape))), tree)


def cache_shardings(cache: Any, cfg):
    """Decode-cache shardings: the batch dim over "dp". The reference's
    per-layer subtrees are stacked for ``lax.scan`` (batch at axis 1) but
    for its leading dense layers (axis 0); the port keeps one cache per
    layer in a list, so a leaf under a list index has its batch at axis 0,
    and any other leaf follows the reference's rule."""
    rules = _rules("cache_shardings")

    def one(path, leaf):
        name = _path_name(path)
        per_layer = any(isinstance(p, int) for p in path)
        batch_axis = 0 if per_layer or name.startswith("dense_layers") \
            else 1
        shape = tuple(leaf.shape)
        if len(shape) <= batch_axis:
            return NamedSharding(rules.mesh, P())
        logicals = [None] * len(shape)
        logicals[batch_axis] = "dp"
        return NamedSharding(rules.mesh, rules.spec(tuple(logicals), shape))

    return _map_with_path(one, cache)


# ---------------------------------------------- placement on a world mesh ----
def _pairs(tree, shardings):
    from repro_torch.train.optimizer import leaves
    xs, shs = leaves(tree), leaves(shardings)
    if len(xs) != len(shs):
        raise ValueError(f"a tree of {len(xs)} leaves with {len(shs)} "
                         f"shardings")
    return xs, shs


def device_put(tree, shardings):
    """This rank's block of every leaf of `tree` (full tensors or NumPy
    arrays, on any device) under `shardings`, contiguous on the mesh's
    device for this rank: ``jax.device_put(tree, shardings)`` seen from
    one rank."""
    from repro_torch.train.optimizer import unflatten
    xs, shs = _pairs(tree, shardings)
    out = []
    for x, sh in zip(xs, shs):
        x = torch.as_tensor(x)
        out.append(x[sh.index(tuple(x.shape))].to(sh.mesh.device,
                                                  copy=True).contiguous())
    return unflatten(tree, out)


def gather_leaf(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The full tensor of which `x` is this rank's block, on every rank
    of the mesh (all-gathers over the spec's axes, dimension by
    dimension)."""
    mesh = sharding.mesh
    check_local(x, mesh)
    for dim, e in enumerate(sharding.entries(x.dim())):
        if e is not None:
            x = coll.all_gather(x, dim, mesh.group(e))
    return x


def gather_tree(tree, shardings):
    """Every leaf of `tree` (this rank's blocks) as its full tensor, on
    every rank: the inverse of `device_put`."""
    from repro_torch.train.optimizer import unflatten
    xs, shs = _pairs(tree, shardings)
    return unflatten(tree, [gather_leaf(x, sh) for x, sh in zip(xs, shs)])


def batch_rows(n: int) -> slice:
    """This rank's rows of a batch of `n` under the active world mesh
    (the block `batch_shardings` gives it: all `n` where the data axes do
    not divide it); all of them without one."""
    rules = model_rules()
    if rules is None:
        return slice(0, n)
    rows = range(n)[NamedSharding(rules.mesh, rules.spec(
        ("dp",), (n,))).index((n,))[0]]
    return slice(rows.start, rows.stop)


def check_placed(tree, shardings, full) -> None:
    """Raise ValueError unless every leaf of `tree` is the block that
    `shardings` gives this rank of the same leaf of `full` (a tree of
    full-shaped tensors, meta ones included), on this rank's device."""
    xs, shs = _pairs(tree, shardings)
    for x, sh, f in zip(xs, shs, _pairs(full, shardings)[0]):
        check_local(x, sh.mesh)
        if tuple(x.shape) != sh.shard_shape(tuple(f.shape)):
            raise ValueError(
                f"a leaf of shape {tuple(x.shape)} is not this rank's block "
                f"{sh.shard_shape(tuple(f.shape))} of {tuple(f.shape)} "
                f"under {sh.spec}: place the tree with device_put first")


def gather_for_use(tree, shardings):
    """`tree` (a layer's leaves: this rank's blocks) as the model uses
    them under the active world mesh. A dimension split over data axes is
    all-gathered, its gradient reduce-scattered (ZeRO-3); a dimension split
    over the model axis (the experts of ``moe_block_ep``) stays local. A
    leaf is used on this rank's rows of the batch, so the data axes it is
    not split over sum its gradient. Without a world mesh `tree` is
    returned as it is."""
    rules = model_rules()
    if rules is None:
        return tree
    from repro_torch.train.optimizer import unflatten
    xs, shs = _pairs(tree, shardings)
    dp = set(rules.dp)
    out = []
    for x, sh in zip(xs, shs):
        check_local(x, sh.mesh)
        gathered: set[str] = set()
        for dim, e in enumerate(sh.entries(x.dim())):
            if e is None:
                continue
            axes = set(sh.mesh.axes(e))
            if axes <= dp:
                x = coll.gather_params(x, dim, sh.mesh.group(e))
                gathered |= axes
            elif axes & dp:
                raise ValueError(f"spec entry {e!r} mixes data and model "
                                 f"axes")
        rest = tuple(a for a in sh.mesh.axis_names
                     if a in dp and a not in gathered)
        if rest:
            x = coll.sum_grads(x, sh.mesh.group(rest))
        out.append(x)
    return unflatten(tree, out)
