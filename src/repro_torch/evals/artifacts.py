"""Content-addressed evaluation result artifacts and paper-table
renderers (port of ``repro.evals.artifacts``).

A result card is addressed by the sha256 of its content key (the matrix
spec plus the classifier id) with the scheme of ``aapaset.manifest``
(canonical-JSON sha256, atomic staged publish): the reference's key and
hashing, so a spec's card hash is the reference's. Re-running an
identical spec is a cache hit. The port's cards live under their own
root, ``experiments/evals_torch``, so neither package loads the other's
results as its own. Any change to the plant, policies or metric math
that alters result bytes must bump ``evals.matrix.SCHEMA_VERSION``.

Layout under ``experiments/evals_torch/<name>-<hash12>/``:

* ``card.json``  — key, hash, axes, and pre-rendered markdown tables
  (Table IV-style policy comparison, Fig 2-style per-scenario breakdown,
  REI weight sensitivity).
* ``result.npz`` — every EvalResult array ([S, Z, F, P] pooled metrics,
  [S, Z, F, P, W] per-workload metrics, REI fields).

``save_card`` is the schema-light sibling for benches whose payload is a
plain dict (latency numbers, ablation variants) — same addressing, JSON
only.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil

import numpy as np

from repro_torch.aapaset.manifest import hash_json, publish_dir, stage_dir
from repro_torch.evals import metrics as EM
from repro_torch.evals import rei as ER
from repro_torch.evals.matrix import EvalResult, MatrixSpec

DEFAULT_ROOT = pathlib.Path("experiments/evals_torch")


def card_hash(key: dict) -> str:
    return hash_json(key)


def result_dir(name: str, key: dict,
               root: pathlib.Path | str = DEFAULT_ROOT) -> pathlib.Path:
    return pathlib.Path(root) / f"{name}-{card_hash(key)}"


def is_cached(name: str, key: dict,
              root: pathlib.Path | str = DEFAULT_ROOT) -> bool:
    return (result_dir(name, key, root) / "card.json").exists()


def _result_arrays(result: EvalResult) -> dict[str, np.ndarray]:
    arrays = {}
    for prefix, tree in (("pooled", result.pooled),
                         ("perw", result.per_workload),
                         ("rei", result.rei)):
        for field, arr in tree._asdict().items():
            arrays[f"{prefix}.{field}"] = np.asarray(arr)
    return arrays


def save_result(spec: MatrixSpec, key: dict, result: EvalResult,
                root: pathlib.Path | str = DEFAULT_ROOT, *,
                replace: bool = False) -> dict:
    """Write card.json + result.npz; returns the card.

    `replace=True` (a forced re-run) clears any existing artifact at the
    address first — without it, publish_dir's same-address race rule
    would keep the old copy and silently drop the fresh one."""
    out = result_dir(spec.name, key, root)
    tmp = stage_dir(out)
    np.savez_compressed(tmp / "result.npz", **_result_arrays(result))
    card = {
        "schema": key.get("schema"),
        "key": key,
        "hash": card_hash(key),
        "axes": {"scenarios": spec.scenario_names(),
                 "seeds": list(spec.seeds),
                 "forecasters": list(spec.forecasters),
                 "policies": list(spec.policies),
                 "n_workloads": spec.n_workloads,
                 "minutes": spec.minutes},
        "spec": dataclasses.asdict(spec),
        "tables": {"policy_comparison": policy_table(result, spec),
                   "per_scenario": scenario_table(result, spec),
                   "rei_sensitivity": rei_sensitivity_table(result, spec)},
    }
    with open(tmp / "card.json", "w") as f:
        json.dump(card, f, indent=1, default=float)
    if replace:
        shutil.rmtree(out, ignore_errors=True)
    publish_dir(tmp, out, "card.json")
    return card


def load_result(name: str, key: dict,
                root: pathlib.Path | str = DEFAULT_ROOT
                ) -> tuple[EvalResult, dict]:
    out = result_dir(name, key, root)
    with open(out / "card.json") as f:
        card = json.load(f)
    with np.load(out / "result.npz") as z:
        fields = {k: z[k] for k in z.files}
    pick = lambda p, cls: cls(**{f: fields[f"{p}.{f}"]    # noqa: E731
                                 for f in cls._fields})
    return EvalResult(pick("pooled", EM.EpisodeMetrics),
                      pick("perw", EM.EpisodeMetrics),
                      pick("rei", ER.REIBreakdown)), card


def save_card(name: str, key: dict, payload: dict,
              root: pathlib.Path | str = DEFAULT_ROOT) -> dict:
    """Content-address a plain-dict bench payload (no arrays).

    Unlike matrix results, payloads here may carry run-varying numbers
    (wall-clock timings), so an existing card at the same address is
    replaced with the latest run rather than kept."""
    out = result_dir(name, key, root)
    tmp = stage_dir(out)
    card = {"key": key, "hash": card_hash(key), "payload": payload}
    with open(tmp / "card.json", "w") as f:
        json.dump(card, f, indent=1, default=float)
    shutil.rmtree(out, ignore_errors=True)
    publish_dir(tmp, out, "card.json")
    return card


# ------------------------------------------------------ table renderers ----
def _fp_labels(spec: MatrixSpec) -> list[tuple[int, int, str]]:
    """(f, p, label) per lane; forecaster shown only when it matters."""
    out = []
    for f, fc in enumerate(spec.forecasters):
        for p, pol in enumerate(spec.policies):
            label = pol
            if len(spec.forecasters) > 1 and \
                    registry_takes_forecaster(pol):
                label = f"{pol}[{fc}]"
            out.append((f, p, label))
    if len(spec.forecasters) > 1:
        # non-forecaster policies repeat identically per f lane: keep f=0
        seen, dedup = set(), []
        for f, p, label in out:
            if label in seen:
                continue
            seen.add(label)
            dedup.append((f, p, label))
        return dedup
    return out


def registry_takes_forecaster(policy: str) -> bool:
    from repro_torch.scaling import registry
    return registry.spec(policy).takes_forecaster


def policy_table(result: EvalResult, spec: MatrixSpec) -> str:
    """Table IV-style policy comparison, averaged over scenarios x seeds."""
    m, r = result.pooled, result.rei
    lines = ["| policy | viol % | cold % | p95 ms | replica-min | "
             "actions | REI |",
             "|---|---|---|---|---|---|---|"]
    for f, p, label in _fp_labels(spec):
        def cell(a, f=f, p=p):
            return float(np.mean(np.asarray(a)[:, :, f, p]))
        lines.append(
            f"| {label} | {100 * cell(m.slo_violation_rate):.3f} "
            f"| {100 * cell(m.cold_start_rate):.3f} "
            f"| {cell(m.p95_response_ms):.1f} "
            f"| {cell(m.replica_minutes):.0f} "
            f"| {cell(m.scaling_actions):.0f} "
            f"| {cell(r.rei):.3f} |")
    return "\n".join(lines)


def scenario_table(result: EvalResult, spec: MatrixSpec,
                   baseline_policy: str = "hpa") -> str:
    """Fig 2-style breakdown: one row per scenario (use archetype_pure
    scenarios for the paper's per-archetype figure), SLO violations per
    policy plus the replica-minute ratio vs the baseline policy."""
    m = result.pooled
    labels = _fp_labels(spec)
    head = " | ".join(f"{label} viol%" for _, _, label in labels)
    lines = [f"| scenario | {head} | rep-min vs {baseline_policy} |",
             "|---" * (len(labels) + 2) + "|"]
    base = (spec.policies.index(baseline_policy)
            if baseline_policy in spec.policies else None)
    for s, sc_name in enumerate(spec.scenario_names()):
        cells = []
        for f, p, _ in labels:
            v = float(np.mean(np.asarray(m.slo_violation_rate)[s, :, f, p]))
            cells.append(f"{100 * v:.3f}")
        if base is None:
            ratio = "-"
        else:
            bm = float(np.mean(np.asarray(m.replica_minutes)[s, :, 0, base]))
            ratios = [float(np.mean(np.asarray(m.replica_minutes)[s, :, f, p]))
                      / max(bm, 1e-9) for f, p, _ in labels]
            ratio = " / ".join(f"{x:.2f}x" for x in ratios)
        lines.append(f"| {sc_name} | {' | '.join(cells)} | {ratio} |")
    return "\n".join(lines)


def rei_sensitivity_table(result: EvalResult, spec: MatrixSpec,
                          delta: float = 0.05) -> str:
    """REI weight-sensitivity (§V.D): per policy, REI range under the 6
    +/-delta weight perturbations, and whether the ranking ever flips."""
    m = result.pooled
    sens = ER.sensitivity(                       # [6, S, Z, F, P]
        m.slo_violation_rate, m.replica_minutes, m.scaling_actions,
        delta=delta, minutes=spec.minutes, n_workloads=spec.n_workloads,
        device="cpu")
    per = np.asarray(sens.rei).mean(axis=(1, 2))         # [6, F, P]
    labels = _fp_labels(spec)
    base = np.asarray(result.rei.rei).mean(axis=(0, 1))  # [F, P]
    base_rank = [label for _, _, label in
                 sorted(labels, key=lambda t: -base[t[0], t[1]])]
    flips = 0
    for k in range(per.shape[0]):
        rank = [label for _, _, label in
                sorted(labels, key=lambda t: -per[k, t[0], t[1]])]
        flips += rank != base_rank
    lines = [f"| policy | REI | min (+/-{delta}) | max (+/-{delta}) |",
             "|---|---|---|---|"]
    for f, p, label in labels:
        lines.append(f"| {label} | {base[f, p]:.3f} "
                     f"| {per[:, f, p].min():.3f} "
                     f"| {per[:, f, p].max():.3f} |")
    lines.append(f"\nranking: {' > '.join(base_rank)}; "
                 f"flips under perturbation: {flips}/{per.shape[0]}")
    return "\n".join(lines)
