"""Content addressing and atomic publishing of artifact directories
(port of the helpers of ``repro.aapaset.manifest`` that the evaluation
plane uses; the dataset manifest itself is not ported yet).

An artifact is addressed by the sha256 of the canonical JSON of its
content key (`hash_json`), written into a per-process staging directory
(`stage_dir`) and renamed into place (`publish_dir`), so a reader never
sees half an artifact and two writers of one address agree.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import time


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
