"""Policy auto-tuning at simulator speed (port of
``repro.tuning.search``): search strategies over candidate lanes.

The paper fixes Table III's per-archetype scaling parameters by hand and
reports REI (§III.D) as the score that would let anyone do better. Every
candidate hyperparameter point is one controller lane of
``scaling.batch.make_grid_evaluator``: on the card one episode kernel
call per candidate (``kernels.ops.episode_block``, after the policy's
pre-pass where it has one), its minutes folded at once into pooled
metrics and REI, so no candidate's per-minute output outlives it.

Three strategies, all driving the same evaluator with deterministic
seeded proposals from NumPy's generator (same spec + seed -> the
reference's candidate sequence exactly):

* ``grid``        — the cartesian product over the search space.
* ``grid_refine`` — grid, then shrink the box around the incumbent and
                    re-grid, `rounds` times (constant candidate count
                    per round, so the compiled group body is reused).
* ``population``  — perturb-and-select over `generations`: elites
                    survive, the rest are gaussian perturbations of
                    elites with a decaying step.

A search space maps hyperparameter keys to either a ``(lo, hi)`` range
(policy `stackable` keys) or a discrete choice list (static keys like
`stride_min`, which change the episode's structure):

    import repro_torch.tuning as tuning
    run = tuning.search(tuning.spec(
        "hpa_spike", policy="hpa", scenario="archetype_pure",
        strategy="grid_refine"))
    run.result.best, run.result.best_rei, run.card["hash"]

``search`` is the content-addressed front door (``tuning.artifacts``,
the reference's hash under ``experiments/tuning_torch``): re-running an
identical spec is a cache hit on the tuning card, and the winner is
rebuildable as ``registry.make(f"tuned:{policy}@{run.card['hash']}",
cfg)``. Entry points take ``device="cuda"`` by default.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, NamedTuple, Sequence

import numpy as np

from repro_torch.evals import metrics as EM
from repro_torch.scaling import batch, registry, scenarios
from repro_torch.sim.cluster import SimConfig

SCHEMA_VERSION = 1

#: Sensible default search boxes per policy family, spanning the paper
#: defaults (Table III / §IV.C): ranges for stackable keys, choices for
#: static ones.
DEFAULT_SPACES: dict[str, dict[str, Any]] = {
    "hpa": {"target": (0.4, 0.95), "cooldown_min": (0.5, 10.0),
            "tolerance": (0.02, 0.3)},
    "predictive": {"target": (0.4, 0.95), "cooldown_min": (0.5, 10.0)},
    "kpa": {"panic_threshold": (1.2, 4.0)},
    "hybrid": {"guard_target": (0.6, 0.95), "max_down_frac": (0.1, 0.6)},
    "aapa": {"stride_min": [5, 10, 20], "horizon_min": [5, 15, 30]},
}

STRATEGIES = ("grid", "grid_refine", "population")


@dataclasses.dataclass(frozen=True)
class TuneSpec:
    """One named tuning run. Every field is part of the content key."""
    name: str
    policy: str
    space: tuple[tuple[str, tuple], ...]   # (key, ("range", lo, hi) |
    #                                        (key, ("choice", v, ...)))
    strategy: str = "grid_refine"
    scenario: str = "archetype_pure"
    scenario_kw: tuple[tuple[str, Any], ...] = ()
    n_workloads: int = 4
    minutes: int = 240
    seed: int = 0
    fixed: tuple[tuple[str, Any], ...] = ()
    sim: tuple[tuple[str, Any], ...] = ()
    bins: int = EM.DEFAULT_BINS
    # strategy knobs (all hashed; unused ones are inert for a strategy)
    points: int = 5          # grid points per range dimension
    rounds: int = 4          # grid_refine rounds
    shrink: float = 0.5      # box shrink per refine round / sigma decay
    population: int = 64     # population size
    generations: int = 8
    elite_frac: float = 0.25
    sigma0: float = 0.25     # initial perturbation (fraction of span)

    def sim_config(self) -> SimConfig:
        return SimConfig(**dict(self.sim))

    def content_key(self) -> dict:
        return {"schema": SCHEMA_VERSION, "name": self.name,
                "policy": self.policy,
                "space": [[k, list(v)] for k, v in self.space],
                "strategy": self.strategy, "scenario": self.scenario,
                "scenario_kw": dict(self.scenario_kw),
                "n_workloads": self.n_workloads, "minutes": self.minutes,
                "seed": self.seed, "fixed": dict(self.fixed),
                "sim": dict(self.sim), "bins": self.bins,
                "points": self.points, "rounds": self.rounds,
                "shrink": self.shrink, "population": self.population,
                "generations": self.generations,
                "elite_frac": self.elite_frac, "sigma0": self.sigma0}


def _norm_space(policy: str, space: dict | None) -> tuple:
    """Normalize a {key: (lo, hi) | [choices] | tagged tuple} space:
    stackable keys become ("range", lo, hi), static keys
    ("choice", ...). Keys are validated against the policy's accepted
    hyperparameters up front."""
    sp = registry.spec(policy)
    if space is None:
        space = DEFAULT_SPACES.get(policy)
        if space is None:
            raise KeyError(f"no default search space for {policy!r}; "
                           f"pass space=; defaults exist for "
                           f"{sorted(DEFAULT_SPACES)}")
    bad = set(space) - set(sp.defaults)
    if bad:
        raise TypeError(f"policy {policy!r} has no hyperparameters "
                        f"{sorted(bad)} (search space); "
                        f"accepts {sorted(sp.defaults)}")
    norm = []
    for key in sorted(space):
        val = space[key]
        if isinstance(val, (tuple, list)) and len(val) and \
                val[0] in ("range", "choice"):
            tag, rest = val[0], tuple(val[1:])
        elif key in sp.stackable and isinstance(val, (tuple, list)) \
                and len(val) == 2:
            tag, rest = "range", (float(val[0]), float(val[1]))
        else:
            tag, rest = "choice", tuple(val)
        if tag == "range":
            if key not in sp.stackable:
                raise TypeError(
                    f"{key!r} is not stackable for {policy!r} — a "
                    f"continuous range needs traced lanes; give a "
                    f"discrete choice list instead "
                    f"(stackable: {sorted(sp.stackable)})")
            lo, hi = float(rest[0]), float(rest[1])
            if not lo < hi:
                raise ValueError(f"empty range for {key!r}: ({lo}, {hi})")
            norm.append((key, ("range", lo, hi)))
        else:
            norm.append((key, ("choice",)
                         + tuple(batch._canon_static(v) for v in rest)))
    return tuple(norm)


def spec(name: str, *, policy: str, space: dict | None = None,
         scenario_kw: dict | None = None, fixed: dict | None = None,
         sim: dict | None = None, **kw) -> TuneSpec:
    """Normalizing constructor (mirrors ``evals.matrix.spec``)."""
    if kw.get("strategy", "grid_refine") not in STRATEGIES:
        raise ValueError(f"unknown strategy {kw['strategy']!r}; "
                         f"one of {STRATEGIES}")
    return TuneSpec(
        name=name, policy=policy, space=_norm_space(policy, space),
        scenario_kw=tuple(sorted((scenario_kw or {}).items())),
        fixed=tuple(sorted((fixed or {}).items())),
        sim=tuple(sorted((sim or {}).items())), **kw)


def smoke_spec() -> TuneSpec:
    """The CI tier-1 smoke search: a seconds-scale hpa grid, one static
    group, on a short SPIKE scenario."""
    return spec("ci_tuning_smoke", policy="hpa", strategy="grid",
                space={"target": (0.45, 0.9), "cooldown_min": (1.0, 8.0)},
                points=4, n_workloads=2, minutes=120)


# ----------------------------------------------------------- proposals ----
def _ranges(space) -> list[tuple[str, float, float]]:
    return [(k, v[1], v[2]) for k, v in space if v[0] == "range"]


def _choices(space) -> list[tuple[str, tuple]]:
    return [(k, v[1:]) for k, v in space if v[0] == "choice"]


def grid_candidates(space, points: int,
                    box: dict[str, tuple[float, float]] | None = None
                    ) -> list[dict]:
    """Cartesian product: `points` per range dimension (over `box` when
    refining) x every choice value. Deterministic ordering."""
    axes, keys = [], []
    for k, lo, hi in _ranges(space):
        if box is not None:
            lo, hi = box[k]
        keys.append(k)
        axes.append([float(x) for x in np.linspace(lo, hi, points)])
    for k, vals in _choices(space):
        keys.append(k)
        axes.append(list(vals))
    return [dict(zip(keys, combo)) for combo in itertools.product(*axes)]


def default_candidate(spec_: TuneSpec) -> dict:
    """The paper-default point: registry defaults restricted to the
    searched keys (what the search must beat)."""
    defaults = registry.spec(spec_.policy).defaults
    return {k: batch._canon_static(defaults[k]) for k, _ in spec_.space}


def _sample(space, rng: np.random.Generator) -> dict:
    cand = {k: float(rng.uniform(lo, hi)) for k, lo, hi in _ranges(space)}
    for k, vals in _choices(space):
        cand[k] = vals[int(rng.integers(len(vals)))]
    return cand


def _perturb(parent: dict, space, sigma: float,
             rng: np.random.Generator) -> dict:
    child = dict(parent)
    for k, lo, hi in _ranges(space):
        child[k] = float(np.clip(parent[k]
                                 + rng.normal(0.0, sigma * (hi - lo)),
                                 lo, hi))
    for k, vals in _choices(space):
        if len(vals) > 1 and rng.random() < 0.2:
            child[k] = vals[int(rng.integers(len(vals)))]
    return child


# ------------------------------------------------------------ execution ----
class TuneResult(NamedTuple):
    spec: TuneSpec
    best: dict               # winning hyperparameters
    best_rei: float
    best_metrics: dict       # pooled EpisodeMetrics of the winner
    default: dict            # the paper-default point searched against
    default_rei: float
    table: list[dict]        # every evaluated candidate: {**params, rei}
    trace: list[dict]        # per-round search trajectory
    meta: dict               # throughput + accounting


def build_rates(spec_: TuneSpec) -> np.ndarray:
    sc = scenarios.get(spec_.scenario, n_workloads=spec_.n_workloads,
                       minutes=spec_.minutes, seed=spec_.seed,
                       cfg=spec_.sim_config(), **dict(spec_.scenario_kw))
    return np.asarray(sc.rates, np.float32)


def make_evaluator(spec_: TuneSpec, classify=None, *, device="cuda"):
    """(candidates, rates) -> (EpisodeMetrics [G], rei [G]), NumPy, from
    ``batch.make_grid_evaluator`` on `device`; `_cache_size()` counts the
    static groups (by group size and rates shape) it has run, what the
    reference's compile cache counts."""
    ev = batch.make_grid_evaluator(spec_.policy, spec_.sim_config(),
                                   classify=classify, bins=spec_.bins,
                                   device=device, **dict(spec_.fixed))

    def evaluate(cands: Sequence[dict], rates):
        met, rb = ev(list(cands), rates)
        host = lambda t: t.detach().cpu().numpy()  # noqa: E731
        return type(met)(*(host(a) for a in met)), host(rb.rei)

    evaluate._cache_size = ev._cache_size
    return evaluate


def _round_record(i: int, cands, scores: np.ndarray, extra=None) -> dict:
    k = int(np.argmax(scores))
    rec = {"round": i, "n_candidates": len(cands),
           "best_rei": float(scores[k]), "best": dict(cands[k]),
           "mean_rei": float(scores.mean())}
    if extra:
        rec.update(extra)
    return rec


def run_search(spec_: TuneSpec, classify=None, *,
               device="cuda") -> TuneResult:
    """Execute the search on `device` (no caching — ``search`` is the
    front door)."""
    rates = build_rates(spec_)
    evaluate = make_evaluator(spec_, classify, device=device)
    rng = np.random.default_rng(spec_.seed)
    t0 = time.perf_counter()

    table: list[dict] = []
    trace: list[dict] = []
    best: dict | None = None
    best_rei = -np.inf
    best_idx_metrics = None

    def score_round(i, cands, extra=None):
        nonlocal best, best_rei, best_idx_metrics
        met, scores = evaluate(cands, rates)
        for c, s in zip(cands, scores):
            table.append({**c, "rei": float(s)})
        k = int(np.argmax(scores))
        if float(scores[k]) > best_rei:
            best, best_rei = dict(cands[k]), float(scores[k])
            best_idx_metrics = {f: float(np.asarray(getattr(met, f))[k])
                                for f in EM.EpisodeMetrics._fields}
        trace.append(_round_record(i, cands, scores, extra))
        return scores

    if spec_.strategy == "grid":
        score_round(0, grid_candidates(spec_.space, spec_.points))
    elif spec_.strategy == "grid_refine":
        box = {k: (lo, hi) for k, lo, hi in _ranges(spec_.space)}
        full = {k: (lo, hi) for k, lo, hi in _ranges(spec_.space)}
        for r in range(spec_.rounds):
            cands = grid_candidates(spec_.space, spec_.points, box=box)
            score_round(r, cands,
                        {"box": {k: list(v) for k, v in box.items()}})
            for k, (flo, fhi) in full.items():     # shrink around incumbent
                half = (box[k][1] - box[k][0]) * spec_.shrink / 2.0
                c = float(np.clip(best[k], flo + half, fhi - half)) \
                    if 2 * half <= fhi - flo else (flo + fhi) / 2.0
                box[k] = (c - half, c + half)
    elif spec_.strategy == "population":
        pop = [_sample(spec_.space, rng) for _ in range(spec_.population)]
        n_elite = max(1, int(spec_.elite_frac * spec_.population))
        for g in range(spec_.generations):
            sigma = spec_.sigma0 * (spec_.shrink ** g)
            scores = score_round(g, pop, {"sigma": sigma})
            elite_ix = np.argsort(-scores)[:n_elite]
            elites = [dict(pop[int(i)]) for i in elite_ix]
            pop = elites + [
                _perturb(elites[i % n_elite], spec_.space, sigma, rng)
                for i in range(spec_.population - n_elite)]
    else:                                # pragma: no cover - spec() guards
        raise ValueError(f"unknown strategy {spec_.strategy!r}")

    default = default_candidate(spec_)
    _, dscore = evaluate([default], rates)
    wall = time.perf_counter() - t0
    n = len(table)
    return TuneResult(
        spec=spec_, best=best, best_rei=best_rei,
        best_metrics=best_idx_metrics, default=default,
        default_rei=float(dscore[0]), table=table, trace=trace,
        meta={"wall_s": wall, "n_candidates": n,
              "candidates_per_sec": n / max(wall, 1e-9),
              "compiles": evaluate._cache_size(),
              "workloads": spec_.n_workloads, "minutes": spec_.minutes,
              "rei_delta": best_rei - float(dscore[0])})


class TuneRun(NamedTuple):
    spec: TuneSpec
    result: TuneResult
    card: dict
    cached: bool


def search(spec_: TuneSpec, *, classify=None, classifier_id: str = "",
           root=None, force: bool = False, device="cuda") -> TuneRun:
    """The content-addressed front door: run the search on `device`,
    publish the tuning card, or return the cached one for an identical
    spec.

    `classifier_id` must name the classifier whenever `classify` is
    passed (the callable cannot be hashed)."""
    from repro_torch.tuning import artifacts
    if classify is not None and not classifier_id:
        raise ValueError("pass classifier_id= to content-address a "
                         "search with a custom classifier")
    key = dict(spec_.content_key(),
               classifier=classifier_id or "default_classify")
    root = artifacts.DEFAULT_ROOT if root is None else root
    if not force and artifacts.is_cached(spec_.name, key, root):
        card = artifacts.load_card(spec_.name, key, root)
        return TuneRun(spec_, artifacts.result_from_card(spec_, card),
                       card, True)
    result = run_search(spec_, classify, device=device)
    card = artifacts.save_run(spec_, key, result, root, replace=force)
    return TuneRun(spec_, result, card, False)
