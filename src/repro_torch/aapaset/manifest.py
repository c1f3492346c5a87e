"""Content-addressed AAPAset artifacts: npz shards + a JSON manifest (port
of ``repro.aapaset.manifest``, same shard format and manifest JSON).

An artifact is addressed by the sha256 of its *content key* — the
(config, seed) fields that determine every byte of the dataset, excluding
execution knobs (chunk size, rows per shard) that cannot change a byte.
Rebuilding the same config is a cache hit; every benchmark and test can
name the exact dataset it ran on by ``name-hash12``. Any change to the
trace generators, feature math or labeling functions that alters dataset
bytes must bump ``SCHEMA_VERSION``.

The port keeps the reference's `config_hash` but writes under its own
root, ``experiments/aapaset_torch``: its plain features differ from the
reference's in the last ulp or two (it never contracts a product into an
add, XLA does) and its "kernel" path is the CUDA kernel, not the Pallas
one, so the same address must not be shared between the two packages.
`load` reads an artifact the reference wrote when given its root.

The manifest carries a dataset card (class balance, LF coverage and
conflict, agreement, split sizes, archetypes present) plus per-shard row
counts and sha256 digests of the raw array bytes (array digests, not npz
file bytes, so the address is independent of zip timestamps).

The content-keying recipe (`hash_json`) and the staged atomic publish
(`stage_dir`, `publish_dir`) are shared with ``evals.artifacts``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import shutil
import time

import numpy as np
import torch

from repro_torch.aapaset.build import (DEFAULT_CHUNK, SPLIT_NAMES,
                                       BuiltDataset, build)
from repro_torch.core.archetypes import ARCHETYPE_NAMES
from repro_torch.core.labeling import LABELING_FUNCTIONS

SCHEMA_VERSION = 1
DEFAULT_ROOT = pathlib.Path("experiments/aapaset_torch")

_SHARD_KEYS = ("windows", "features", "labels", "confidence", "votes",
               "func_id", "start_min", "pattern", "day", "split")


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """One named AAPAset build. Content fields address the artifact;
    `chunk` and `shard_rows` are execution knobs (excluded from the hash —
    they cannot change any output byte).

    `feature_path` selects the feature implementation: "ref" (the plain
    features), "kernel" (the ``window_features`` CUDA kernel) or "auto"
    (the kernel iff the build runs on a CUDA device). The resolved value
    is part of the content key, as in the reference."""

    name: str
    n_functions: int
    n_days: int
    seed: int = 0
    family: str = "default"
    window: int = 60
    stride: int = 10
    min_total_invocations: float = 1000.0
    feature_path: str = "auto"      # "auto" | "kernel" | "ref"
    chunk: int = DEFAULT_CHUNK
    shard_rows: int = 65536

    def resolved_feature_path(self, device="cuda") -> str:
        """"auto" resolved for a build on `device`: "kernel" on CUDA,
        "ref" on the CPU (the reference asks JAX for its backend)."""
        if self.feature_path != "auto":
            return self.feature_path
        return "kernel" if torch.device(device).type == "cuda" else "ref"

    def content_key(self, device="cuda") -> dict:
        return {"schema": SCHEMA_VERSION, "name": self.name,
                "n_functions": self.n_functions, "n_days": self.n_days,
                "seed": self.seed, "family": self.family,
                "window": self.window, "stride": self.stride,
                "min_total_invocations": self.min_total_invocations,
                "feature_path": self.resolved_feature_path(device)}


def hash_json(obj, n: int = 12) -> str:
    """The one content-keying recipe: sha256 of canonical JSON."""
    blob = json.dumps(obj, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:n]


def sweep_stale_tmp(parent: pathlib.Path, pattern: str,
                    max_age_s: float = 3600.0) -> None:
    """Remove `.tmp-*` staging files and directories orphaned by killed
    writers. The age gate spares live concurrent writers, whose staging
    paths are seconds old."""
    cutoff = time.time() - max_age_s
    for stale in parent.glob(pattern):
        try:
            if stale.stat().st_mtime >= cutoff:
                continue
            if stale.is_dir():
                shutil.rmtree(stale, ignore_errors=True)
            else:
                stale.unlink()
        except OSError:
            pass


def stage_dir(out: pathlib.Path) -> pathlib.Path:
    """A per-process staging directory next to `out`, after sweeping
    stale orphans. Pair with `publish_dir`."""
    out.parent.mkdir(parents=True, exist_ok=True)
    sweep_stale_tmp(out.parent, f".tmp-{out.name}-*")
    tmp = out.parent / f".tmp-{out.name}-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    return tmp


def publish_dir(tmp: pathlib.Path, out: pathlib.Path,
                sentinel: str) -> None:
    """Rename `tmp` to `out` atomically. If a concurrent writer published
    first (`sentinel` exists under `out`), drop this copy: both built the
    same bytes. A stale partial directory (no sentinel) is cleared and
    replaced; if a concurrent repairer wins that retry, adopt its copy."""
    try:
        tmp.replace(out)
    except OSError:
        if (out / sentinel).exists():
            shutil.rmtree(tmp, ignore_errors=True)
        else:
            shutil.rmtree(out, ignore_errors=True)
            try:
                tmp.replace(out)
            except OSError:
                shutil.rmtree(tmp, ignore_errors=True)


def config_hash(cfg: DatasetConfig, device="cuda") -> str:
    return hash_json(cfg.content_key(device))


def artifact_dir(cfg: DatasetConfig,
                 root: pathlib.Path | str = DEFAULT_ROOT,
                 device="cuda") -> pathlib.Path:
    return pathlib.Path(root) / f"{cfg.name}-{config_hash(cfg, device)}"


def is_cached(cfg: DatasetConfig, root: pathlib.Path | str = DEFAULT_ROOT,
              device="cuda") -> bool:
    return (artifact_dir(cfg, root, device) / "manifest.json").exists()


def _digest(arrays: dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def dataset_card(built: BuiltDataset) -> dict:
    """Class balance, LF coverage/conflict, agreement, split sizes."""
    y, votes = built.labels, built.votes
    labeled = y >= 0
    n_labeled = int(labeled.sum())
    balance = np.bincount(y[labeled], minlength=4) / max(n_labeled, 1)

    fired = votes >= 0
    coverage = fired.mean(axis=0)
    # conflict: >= 2 LFs fired and disagree (vectorized over all windows)
    vmax = np.where(fired, votes, -1).max(axis=1)
    vmin = np.where(fired, votes, 127).min(axis=1)
    multi = fired.sum(axis=1) >= 2
    conflict = float((multi & (vmax != vmin)).mean())

    return {
        "n_windows": len(built),
        "n_labeled": n_labeled,
        "abstain_rate": float((~labeled).mean()),
        "class_balance": {n: float(b) for n, b in
                          zip(ARCHETYPE_NAMES, balance)},
        "archetypes_present": [n for n, b in
                               zip(ARCHETYPE_NAMES, balance) if b > 0],
        "lf_coverage": {fn.__name__: float(c) for fn, c in
                        zip(LABELING_FUNCTIONS, coverage)},
        "lf_conflict_rate": conflict,
        "mean_agreement": float(built.confidence[labeled].mean())
        if n_labeled else 0.0,
        "split_sizes": {name: int((built.split == code).sum())
                        for code, name in enumerate(SPLIT_NAMES)},
        "n_functions_kept": int(built.series.shape[0]),
    }


def save(built: BuiltDataset, cfg: DatasetConfig,
         root: pathlib.Path | str = DEFAULT_ROOT, device="cuda") -> dict:
    """Write npz shards + series + manifest.json under the address of
    `cfg` built on `device`; returns the manifest.

    Everything is staged into a per-process temp directory and published
    with one atomic rename, so neither a crash mid-save nor a concurrent
    builder of the same address can expose a half-written artifact.
    """
    out = artifact_dir(cfg, root, device)
    tmp = stage_dir(out)

    shards = []
    for i, lo in enumerate(range(0, max(len(built), 1), cfg.shard_rows)):
        hi = min(lo + cfg.shard_rows, len(built))
        arrays = {k: getattr(built, k)[lo:hi] for k in _SHARD_KEYS}
        np.savez_compressed(tmp / f"shard-{i:05d}.npz", **arrays)
        shards.append({"file": f"shard-{i:05d}.npz", "rows": hi - lo,
                       "sha256": _digest(arrays)})

    series = {"series": built.series,
              "series_pattern": built.series_pattern}
    np.savez_compressed(tmp / "series.npz", **series)

    manifest = {
        "schema": SCHEMA_VERSION,
        "config": dataclasses.asdict(cfg),
        "hash": config_hash(cfg, device),
        "card": dataset_card(built),
        "shards": shards,
        "series_sha256": _digest(series),
    }
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=1)

    publish_dir(tmp, out, "manifest.json")
    return manifest


def read_manifest(cfg: DatasetConfig,
                  root: pathlib.Path | str = DEFAULT_ROOT,
                  device="cuda") -> dict:
    with open(artifact_dir(cfg, root, device) / "manifest.json") as f:
        return json.load(f)


def load(cfg: DatasetConfig, root: pathlib.Path | str = DEFAULT_ROOT,
         *, verify: bool = False, manifest: dict | None = None,
         device="cuda") -> BuiltDataset:
    """Reassemble a BuiltDataset from its shards (cache hit). `device`
    resolves the address of an "auto" config, as in `artifact_dir`; the
    arrays are host arrays."""
    out = artifact_dir(cfg, root, device)
    if manifest is None:
        manifest = read_manifest(cfg, root, device)
    parts: dict[str, list] = {k: [] for k in _SHARD_KEYS}
    for sh in manifest["shards"]:
        with np.load(out / sh["file"]) as z:
            arrays = {k: z[k] for k in _SHARD_KEYS}
        if verify and _digest(arrays) != sh["sha256"]:
            raise ValueError(f"corrupt shard {sh['file']} in {out}")
        for k in _SHARD_KEYS:
            parts[k].append(arrays[k])
    with np.load(out / "series.npz") as z:
        series = z["series"]
        series_pattern = z["series_pattern"]
    return BuiltDataset(
        **{k: np.concatenate(parts[k]) for k in _SHARD_KEYS},
        series=series, series_pattern=series_pattern)


def build_or_load(cfg: DatasetConfig,
                  root: pathlib.Path | str = DEFAULT_ROOT,
                  *, verify: bool = False,
                  device="cuda") -> tuple[BuiltDataset, dict]:
    """The engine's front door: content-addressed build with caching."""
    if is_cached(cfg, root, device):
        manifest = read_manifest(cfg, root, device)
        return load(cfg, root, verify=verify, manifest=manifest,
                    device=device), manifest
    built = build(cfg, device=device)
    return built, save(built, cfg, root, device)
