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

The reference's elastic restore (``mesh=``, ``shardings=``: reshard onto
another mesh) has no single-device counterpart and raises.
"""
from __future__ import annotations

import json
import os
import pathlib
import queue
import shutil
import threading

import numpy as np
import torch

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


def _snapshot(tree):
    """(host arrays, dtype names) of `tree`'s leaves, in leaf order."""
    arrays, dtypes = [], []
    for leaf in leaves(tree):
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        arrays.append(_host(leaf))
        dtypes.append("bfloat16" if bf16 else str(arrays[-1].dtype))
    return arrays, dtypes


def _write(path, step: int, arrays, dtypes, treedef: str) -> pathlib.Path:
    root = pathlib.Path(path)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    meta = {"step": step, "n_leaves": len(arrays), "treedef": treedef}
    for i, dt in enumerate(dtypes):
        meta[f"dtype_{i}"] = dt
    np.savez(tmp / "shards.npz",
             **{f"leaf_{i}": a for i, a in enumerate(arrays)})
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


def save(path: str | os.PathLike, step: int, tree) -> pathlib.Path:
    """Atomic synchronous checkpoint of a tree of tensors (or arrays)."""
    arrays, dtypes = _snapshot(tree)
    return _write(path, step, arrays, dtypes, _treedef(tree))


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
    meta tensors included). Each leaf keeps the checkpoint's dtype and goes
    to `device`, or, when None, to its target leaf's device (a meta
    target: the card). Returns (tree, step)."""
    if mesh is not None or shardings is not None:
        raise shd.unsupported("restore(mesh=..., shardings=...)")
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
    out = []
    for i, tgt in enumerate(targets):
        arr = z[f"leaf_{i}"]
        if arr.shape != tuple(tgt.shape):
            raise AssertionError(f"leaf {i}: ckpt {arr.shape} vs target "
                                 f"{tuple(tgt.shape)}")
        t = torch.from_numpy(arr)
        if meta[f"dtype_{i}"] == "bfloat16":
            t = t.view(torch.int16).view(torch.bfloat16)
        if device is not None:
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
        arrays, dtypes = _snapshot(tree)                # blocking copy
        self._q.put((step, arrays, dtypes, _treedef(tree)))  # I/O overlapped

    def wait(self) -> None:
        self._q.join()
        if self._err:
            raise self._err

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._worker.join(timeout=10)
