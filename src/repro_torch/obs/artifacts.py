"""Content-addressed observability cards (port of ``repro.obs.artifacts``):
traced runs you can point at.

`capture_matrix` re-runs an evaluation matrix with telemetry on and
publishes what the autoscaler *did*, not just how it scored, under
``experiments/obs_torch/<name>-<hash12>/`` with the reference's key and
hash (canonical-JSON sha256, staged atomic publish). The root is the
port's own: its traces differ from the reference's by 1-2 ulp where
forecasts enter, so one address must not name both; `load_capture(...,
root=...)` reads a reference card all the same.

* ``card.json``    — key, axes, per-lane blame table, per-archetype
  blame split, and the per-cause totals (their sum is the traced lanes'
  violation total).
* ``trace.npz``    — every ControlTrace array, decisions keyed
  ``dec.<field>`` ([S, Z, M, H, F, P, K]) and minutes ``min.<field>``
  ([S, Z, M, F, P, K]).
* ``timeline.md``  — the decision timeline of the worst lane (most
  violated requests), blame-annotated.

The traced run is ``evals.matrix.make_runner(..., telemetry=True)``: on
the card the blocked episode with eager `decide` and ``plant_block``.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import time
from typing import NamedTuple

import numpy as np

from repro_torch.aapaset.manifest import hash_json, publish_dir, stage_dir
from repro_torch.evals import matrix
from repro_torch.obs import attribute as AT
from repro_torch.obs.trace import (ControlTrace, DecisionRecord, MinuteTrace,
                                   lane, to_numpy)

__all__ = ["OBS_SCHEMA", "DEFAULT_ROOT", "ObsCapture", "obs_key",
           "capture_dir", "is_cached", "capture_matrix", "load_capture"]

OBS_SCHEMA = 1
DEFAULT_ROOT = pathlib.Path("experiments/obs_torch")


class ObsCapture(NamedTuple):
    spec: matrix.MatrixSpec
    trace: ControlTrace      # numpy leaves
    blames: dict             # lane label -> Blame
    card: dict
    cached: bool
    meta: dict = {}          # host seconds: traced run, blame walk, publish


def obs_key(spec_: matrix.MatrixSpec, classifier_id: str = "",
            trace_lanes: int | None = None) -> dict:
    return dict(spec_.content_key(), obs_schema=OBS_SCHEMA,
                classifier=classifier_id or "default_classify",
                trace_lanes=trace_lanes)


def capture_dir(name: str, key: dict,
                root: pathlib.Path | str = DEFAULT_ROOT) -> pathlib.Path:
    return pathlib.Path(root) / f"{name}-{hash_json(key)}"


def is_cached(name: str, key: dict,
              root: pathlib.Path | str = DEFAULT_ROOT) -> bool:
    return (capture_dir(name, key, root) / "card.json").exists()


def _lane_labels(spec_: matrix.MatrixSpec, K: int):
    """(label, (s, z), (f, p, k)) per traced lane, matrix order."""
    scs = spec_.scenario_names()
    for s, sc in enumerate(scs):
        for z, seed in enumerate(spec_.seeds):
            for f, fc in enumerate(spec_.forecasters):
                for p, pol in enumerate(spec_.policies):
                    for k in range(K):
                        label = f"{sc}/z{seed}/{pol}"
                        if len(spec_.forecasters) > 1:
                            label = f"{sc}/z{seed}/{pol}[{fc}]"
                        yield f"{label}/w{k}", (s, z), (f, p, k)


def _blame_all(spec_: matrix.MatrixSpec, ct: ControlTrace, cfg):
    blames, arch_rows = {}, {}
    K = ct.minutes.rate.shape[-1]
    for label, pre, post in _lane_labels(spec_, K):
        ln = lane(ct, pre, post)
        b = AT.attribute(ln, cfg)
        blames[label] = b
        AT.archetype_counts(ln, b, into=arch_rows)
    return blames, arch_rows


def capture_matrix(spec_: matrix.MatrixSpec, classify=None, *,
                   classifier_id: str = "",
                   trace_lanes: int | None = None,
                   root: pathlib.Path | str = DEFAULT_ROOT,
                   force: bool = False, device="cuda") -> ObsCapture:
    """The obs front door: traced matrix run on `device` -> published obs
    card (or the cached card of an identical key)."""
    if classify is not None and not classifier_id:
        raise ValueError("pass classifier_id= to content-address a "
                         "capture with a custom classifier")
    key = obs_key(spec_, classifier_id, trace_lanes)
    if not force and is_cached(spec_.name, key, root):
        return load_capture(spec_.name, key, root)

    cfg = spec_.sim_config()
    t0 = time.perf_counter()
    run = matrix.make_runner(spec_, classify, telemetry=True,
                             trace_lanes=trace_lanes, device=device)
    _, _, ct = run(matrix.build_rates(spec_))
    ct = to_numpy(ct)
    t1 = time.perf_counter()

    blames, arch_rows = _blame_all(spec_, ct, cfg)
    totals = {c: sum(b.counts[c] for b in blames.values())
              for c in AT.CAUSES}
    worst = max(blames, key=lambda lb: blames[lb].total)
    wl = next((pre, post) for lb, pre, post
              in _lane_labels(spec_, ct.minutes.rate.shape[-1])
              if lb == worst)
    timeline = (f"# Decision timeline: {worst}\n\n"
                + AT.timeline(lane(ct, *wl), blames[worst]))
    t2 = time.perf_counter()

    card = {
        "obs_schema": OBS_SCHEMA, "key": key, "hash": hash_json(key),
        "spec": dataclasses.asdict(spec_),
        "trace_lanes": trace_lanes,
        "blame_totals": totals,
        "violations_total": sum(totals.values()),
        "worst_lane": worst,
        "tables": {"blame": AT.blame_table(blames),
                   "by_archetype": AT.archetype_table(arch_rows)},
    }
    out = capture_dir(spec_.name, key, root)
    tmp = stage_dir(out)
    np.savez_compressed(tmp / "trace.npz", **_trace_arrays(ct))
    with open(tmp / "timeline.md", "w") as f:
        f.write(timeline + "\n")
    with open(tmp / "card.json", "w") as f:
        json.dump(card, f, indent=1, default=float)
    if force:
        shutil.rmtree(out, ignore_errors=True)
    publish_dir(tmp, out, "card.json")
    meta = {"run_s": t1 - t0, "blame_s": t2 - t1,
            "publish_s": time.perf_counter() - t2}
    return ObsCapture(spec_, ct, blames, card, False, meta)


def _trace_arrays(ct: ControlTrace) -> dict[str, np.ndarray]:
    arrays = {}
    for prefix, tree in (("dec", ct.decisions), ("min", ct.minutes)):
        for field, arr in tree._asdict().items():
            arrays[f"{prefix}.{field}"] = np.asarray(arr)
    return arrays


def load_capture(name: str, key: dict,
                 root: pathlib.Path | str = DEFAULT_ROOT) -> ObsCapture:
    """A published card of either package (pass the reference's root to
    read its cards) with its blame walked again from the trace."""
    out = capture_dir(name, key, root)
    with open(out / "card.json") as f:
        card = json.load(f)
    with np.load(out / "trace.npz") as z:
        fields = {k: z[k] for k in z.files}
    ct = ControlTrace(
        decisions=DecisionRecord(**{f: fields[f"dec.{f}"]
                                    for f in DecisionRecord._fields}),
        minutes=MinuteTrace(**{f: fields[f"min.{f}"]
                               for f in MinuteTrace._fields}))
    spec_ = _spec_from_card(card)
    blames, _ = _blame_all(spec_, ct, spec_.sim_config())
    return ObsCapture(spec_, ct, blames, card, True)


def _spec_from_card(card: dict) -> matrix.MatrixSpec:
    d = dict(card["spec"])
    d["policies"] = tuple(d["policies"])
    d["forecasters"] = tuple(d["forecasters"])
    d["seeds"] = tuple(d["seeds"])
    d["scenarios"] = tuple((n, tuple((k, v) for k, v in kw))
                           for n, kw in d["scenarios"])
    d["sim"] = tuple((k, v) for k, v in d["sim"])
    return matrix.MatrixSpec(**d)
