"""Fault-tolerant checkpoints (port of ``repro.train.checkpoint``).

* **atomic**: writes go to ``step_<N>.tmp/`` and are renamed only after
  fsync; a preemption mid-write never corrupts the latest checkpoint.
* **async**: ``AsyncCheckpointer`` copies the tree to host memory
  synchronously and writes it to disk on a worker thread, overlapping
  the I/O with the next training steps; a write's error is raised by the
  next ``save`` or ``wait``.
* **retention**: keeps the newest ``keep`` checkpoints.

The on-disk format is the reference's: ``shards.npz`` holds ``leaf_i``
(bf16 as its ``uint16`` bits) and ``meta.json`` holds ``n_leaves`` and
``dtype_i``, the leaves numbered in ``jax.tree`` order (dict keys sorted,
``optimizer.leaves``). A tree of plain dicts saved by either package
restores bit for bit in the other. The port's model trees keep one dict
per layer where the reference stacks the layers, so their leaves differ
in number and shape between the packages.

Under a world mesh (``dist.sharding``) a tree of this rank's blocks is
saved with its ``shardings``: the leaves are gathered one at a time and
rank 0 writes each into the reference's format before it gathers the
next (host memory holds one full leaf at a time); the other ranks wait
for it. The checkpoint equals, leaf by leaf, the one written from the
unsharded tree.
``restore(..., shardings=...)`` reads each array and keeps this rank's
block under the given shardings, which may be those of another mesh than
the one that saved: the reference's elastic reshard-on-restore.
"""
from __future__ import annotations

import json
import os
import pathlib
import queue
import shutil
import threading
import zipfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import _device
from repro_torch.dist import sharding as shd
from repro_torch.train.optimizer import leaves, unflatten


def _host(leaf) -> np.ndarray:
    """A leaf as a host NumPy array (bf16 as its uint16 bits), copied."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf)


def _entry(leaf):
    """(host array, dtype name) of one leaf."""
    a = _host(leaf)
    bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
    return a, "bfloat16" if bf16 else str(a.dtype)


def _snapshot(tree):
    """The (host array, dtype name) of each of `tree`'s leaves, in leaf
    order."""
    return [_entry(leaf) for leaf in leaves(tree)]


def _write(path, step: int, entries, treedef: str) -> pathlib.Path:
    """Writes the (host array, dtype name) `entries` (any iterable, each
    written as it comes, as ``np.savez`` writes) and the meta."""
    root = pathlib.Path(path)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    dtypes = []
    with zipfile.ZipFile(tmp / "shards.npz", "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, (a, dt) in enumerate(entries):
            with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(a),
                                          allow_pickle=False)
            dtypes.append(dt)
    meta = {"step": step, "n_leaves": len(dtypes), "treedef": treedef}
    for i, dt in enumerate(dtypes):
        meta[f"dtype_{i}"] = dt
    (tmp / "meta.json").write_text(json.dumps(meta))
    with open(tmp / "meta.json", "rb") as f:
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def _treedef(tree) -> str:
    """The tree's structure, leaves as ``*`` (for the record only)."""
    return repr(unflatten(tree, ["*"] * len(leaves(tree))))


def save(path: str | os.PathLike, step: int, tree, *,
         shardings=None) -> pathlib.Path:
    """Atomic synchronous checkpoint of a tree of tensors (or arrays).
    With `shardings` (a ``dist.sharding.NamedSharding`` tree on a world
    mesh) `tree` holds this rank's blocks; every rank of the mesh calls
    `save`, and it returns once rank 0 has written the full arrays."""
    if shardings is None:
        return _write(path, step, _snapshot(tree), _treedef(tree))
    xs, shs = leaves(tree), leaves(shardings)
    if len(xs) != len(shs):
        raise ValueError(f"{len(xs)} leaves with {len(shs)} shardings")
    mesh = shs[0].mesh
    gathered = (shd.gather_leaf(x, sh) for x, sh in zip(xs, shs))
    final = pathlib.Path(path) / f"step_{step:08d}"
    if mesh.rank == 0:
        final = _write(path, step, map(_entry, gathered), _treedef(tree))
    else:
        for _ in gathered:       # every rank takes part in each gather
            pass
    dist.barrier(group=mesh.group(mesh.axis_names))
    return final


def latest_step(path: str | os.PathLike) -> int | None:
    root = pathlib.Path(path)
    if not root.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in root.glob("step_*")
             if not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def restore(path: str | os.PathLike, target_tree, *, step: int | None = None,
            mesh=None, shardings=None, device=None):
    """Restore into the structure of `target_tree` (a tree of tensors,
    meta tensors included, of the checkpoint's full shapes). Each leaf
    keeps the checkpoint's dtype and goes to `device`, or, when None, to
    its target leaf's device (a meta target: the card). With `shardings`
    (a ``dist.sharding.NamedSharding`` tree, of any world mesh) each leaf
    is this rank's block under its sharding, on this rank's device. `mesh`
    is accepted as the reference's is (a world mesh; a lane mesh holds no
    model's shards and raises). Returns (tree, step)."""
    if mesh is not None and not mesh.is_world:
        raise shd.unsupported("restore(mesh=<a lane mesh>)", shd.LANE_MESH)
    sh_leaves = None if shardings is None else leaves(shardings)
    root = pathlib.Path(path)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = root / f"step_{step:08d}"
    z = np.load(d / "shards.npz")
    meta = json.loads((d / "meta.json").read_text())

    targets = leaves(target_tree)
    if meta["n_leaves"] != len(targets):
        raise AssertionError(f"checkpoint has {meta['n_leaves']} leaves, "
                             f"target {len(targets)}")
    if sh_leaves is not None and len(sh_leaves) != len(targets):
        raise AssertionError(f"{len(sh_leaves)} shardings for "
                             f"{len(targets)} leaves")
    out = []
    for i, tgt in enumerate(targets):
        arr = z[f"leaf_{i}"]
        if arr.shape != tuple(tgt.shape):
            raise AssertionError(f"leaf {i}: ckpt {arr.shape} vs target "
                                 f"{tuple(tgt.shape)}")
        if sh_leaves is not None:
            sh = sh_leaves[i]
            arr = np.array(arr[sh.index(arr.shape)])
        t = torch.from_numpy(arr)
        if meta[f"dtype_{i}"] == "bfloat16":
            t = t.view(torch.int16).view(torch.bfloat16)
        if sh_leaves is not None:
            dev = sh_leaves[i].mesh.device
        elif device is not None:
            dev = _device.resolve(device)
        elif isinstance(tgt, torch.Tensor) and tgt.device.type != "meta":
            dev = tgt.device
        else:
            dev = _device.resolve("cuda")
        out.append(t.to(dev))
    return unflatten(target_tree, out), step


def retain(path: str | os.PathLike, keep: int = 3) -> None:
    root = pathlib.Path(path)
    steps = sorted(int(p.name.split("_")[1]) for p in root.glob("step_*")
                   if not p.name.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(root / f"step_{s:08d}", ignore_errors=True)


class AsyncCheckpointer:
    """Snapshot-to-host synchronously, write-to-disk on a worker thread."""

    def __init__(self, path: str | os.PathLike, keep: int = 3):
        self.path = pathlib.Path(path)
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._err: Exception | None = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                _write(self.path, *item)
                retain(self.path, self.keep)
            except Exception as e:  # surfaced on next save()/wait()
                self._err = e
            finally:
                self._q.task_done()

    def save(self, step: int, tree) -> None:
        if self._err:
            raise self._err
        entries = _snapshot(tree)                       # blocking copy
        self._q.put((step, entries, _treedef(tree)))    # I/O overlapped

    def wait(self) -> None:
        self._q.join()
        if self._err:
            raise self._err

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._worker.join(timeout=10)
