"""Policies x forecasters x scenarios x seeds: the Table IV evaluation
matrix (port of ``repro.evals.matrix``).

``spec(...)`` names an evaluation matrix (which policies, which
forecasters, which scenarios at which seeds, on which plant);
``make_runner(spec)`` runs it and returns EpisodeMetrics per cell; and
``run(spec)`` is the front door, content-addressed against
``experiments/evals_torch`` (``evals.artifacts``), so re-running an
identical spec is a cache hit on the result card.

    from repro_torch.evals import matrix
    run = matrix.run(matrix.spec(
        "sweep", policies=("hpa", "aapa"), forecasters=("holt_winters",),
        scenarios=(("burst_storm", {}), ("idle_wake", {})), seeds=(0, 1)))
    run.result.pooled.slo_violation_rate        # [S, Z, F, P]

Each controller lane (f, p) runs its episodes through
``kernels.ops.episode_block``, `w_chunk` workloads per call: on the card
the policy's pre-pass and the plant pass, on the CPU the plain version.
The episodes of every scenario and seed are independent lanes, so the
runner flattens [S, Z, W] into one lane axis and folds each chunk's
per-minute outputs into metric accumulators at once; with
``per_workload=False`` every chunk lies inside one (scenario, seed) cell
and folds straight into that cell's pooled accumulators
(``evals.metrics.accum_update_pooled``), so no chunk's [W, M] outputs are
kept. Pooled metrics are sums in another order than the reference's
in-scan fold; they agree at its pooling tolerance.

Policies that take no forecaster ignore the forecaster axis: lane (f, p)
repeats the same controller for every f, which keeps the result dense;
the runner runs such a controller once and repeats its cells.

With ``telemetry=True`` each controller lane runs its episodes through
the blocked loop with the decision trace instead
(``sim.cluster.run_traced``: eager `decide` at every control-period head,
``plant_block`` for the decision-free ticks on the card), all [S, Z, W]
lanes in one episode, `trace_lanes` of each cell's W lanes traced. Its
`MinuteOut` is the plain episode's bit for bit on the CPU, and the fused
kernel's at the episode tolerance on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import _device
from repro_torch.evals import metrics as EM
from repro_torch.evals import rei as ER
from repro_torch.obs import trace as obs_trace
from repro_torch.scaling import batch, registry, scenarios
from repro_torch.sim import cluster
from repro_torch.sim.cluster import MinuteOut, SimConfig

SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class MatrixSpec:
    """One named evaluation matrix. Every field is part of the content
    key (including `bins`, which changes the reported quantiles)."""
    name: str
    policies: tuple[str, ...]
    forecasters: tuple[str, ...]
    scenarios: tuple[tuple[str, tuple[tuple[str, Any], ...]], ...]
    seeds: tuple[int, ...]
    n_workloads: int
    minutes: int
    sim: tuple[tuple[str, Any], ...] = ()
    bins: int = EM.DEFAULT_BINS

    def sim_config(self) -> SimConfig:
        return SimConfig(**dict(self.sim))

    def content_key(self) -> dict:
        return {"schema": SCHEMA_VERSION, "name": self.name,
                "policies": list(self.policies),
                "forecasters": list(self.forecasters),
                "scenarios": [[n, dict(kw)] for n, kw in self.scenarios],
                "seeds": list(self.seeds),
                "n_workloads": self.n_workloads, "minutes": self.minutes,
                "sim": dict(self.sim), "bins": self.bins}

    @property
    def shape(self) -> tuple[int, int, int, int]:
        return (len(self.scenarios), len(self.seeds),
                len(self.forecasters), len(self.policies))

    def scenario_names(self) -> list[str]:
        return [n if not kw else f"{n}:{dict(kw)}"
                for n, kw in self.scenarios]


def spec(name: str, *, policies: Sequence[str],
         forecasters: Sequence[str] = ("holt_winters",),
         scenarios: Sequence = (("archetype_mix", {}),),
         seeds: Sequence[int] = (0,), n_workloads: int = 8,
         minutes: int = 720, sim: dict | None = None,
         bins: int = EM.DEFAULT_BINS) -> MatrixSpec:
    """Normalizing constructor: scenario entries may be bare names or
    (name, kwargs) pairs; kwargs and sim dicts become sorted tuples so
    the spec is hashable and its content key canonical."""
    norm = []
    for entry in scenarios:
        if isinstance(entry, str):
            entry = (entry, {})
        sc_name, kw = entry
        norm.append((sc_name, tuple(sorted(dict(kw).items()))))
    return MatrixSpec(name=name, policies=tuple(policies),
                      forecasters=tuple(forecasters),
                      scenarios=tuple(norm), seeds=tuple(seeds),
                      n_workloads=int(n_workloads), minutes=int(minutes),
                      sim=tuple(sorted((sim or {}).items())), bins=bins)


def smoke_spec() -> MatrixSpec:
    """The reference's CI smoke matrix: 2 policies x 2 scenarios x 1
    seed."""
    return spec("ci_smoke", policies=("hpa", "predictive"),
                scenarios=(("burst_storm", {}), ("idle_wake", {})),
                seeds=(0,), n_workloads=2, minutes=120)


class EvalResult(NamedTuple):
    """Result of an evaluation matrix."""
    pooled: EM.EpisodeMetrics        # fields [S, Z, F, P]
    per_workload: EM.EpisodeMetrics  # fields [S, Z, F, P, W]
    rei: ER.REIBreakdown             # fields [S, Z, F, P]


class MatrixRun(NamedTuple):
    spec: MatrixSpec
    result: EvalResult               # numpy arrays
    card: dict
    cached: bool


def controllers(spec_: MatrixSpec, classify=None) -> list:
    """The F*P controller lanes, forecaster-major (lane = f * P + p)."""
    cfg = spec_.sim_config()
    ctrls = []
    for f in spec_.forecasters:
        for p in spec_.policies:
            kw = ({"forecaster": f}
                  if registry.spec(p).takes_forecaster else {})
            ctrls.append(registry.get_controller(p, cfg, classify=classify,
                                                 **kw))
    return ctrls


def build_rates(spec_: MatrixSpec) -> np.ndarray:
    """The scenario x seed workload tensor [S, Z, W, M] (NumPy)."""
    cfg = spec_.sim_config()
    rows = []
    for sc_name, kw in spec_.scenarios:
        per_seed = [scenarios.get(sc_name, n_workloads=spec_.n_workloads,
                                  minutes=spec_.minutes, seed=seed,
                                  cfg=cfg, **dict(kw)).rates
                    for seed in spec_.seeds]
        rows.append(np.stack(per_seed))
    rates = np.stack(rows).astype(np.float32)
    expect = spec_.shape[:2] + (spec_.n_workloads, spec_.minutes)
    if rates.shape != expect:
        raise ValueError(f"scenario tensor is {rates.shape}, expected "
                         f"{expect}; every scenario must honor "
                         "n_workloads/minutes")
    return rates


def _stack(accs: list[EM.MetricAccum]) -> EM.MetricAccum:
    return EM.MetricAccum(*(torch.stack(f) for f in zip(*accs)))


def _lane_runner(ctrls, cfg, edges, *, per_workload: bool = True,
                 w_chunk: int | None = None, telemetry: bool = False,
                 trace_lanes: int | None = None):
    """rates [G, W, M] (G independent cells of W workloads) ->
    MetricAccum of [L, G, W] leaves (hist [L, G, W, bins]), or with
    ``per_workload=False`` of [L, G] leaves pooled over W. Each of the L
    controllers runs `w_chunk` workloads per episode call
    (``kernels.ops.episode_block``); each chunk's outputs fold into the
    accumulators before the next chunk runs. The shared core of the
    matrix runner and the controller evaluator.

    ``telemetry=True`` runs each controller's G * W lanes in one traced
    blocked episode (`w_chunk` must be None) and returns ``(accums,
    ControlTrace)`` with decisions leaves [G, M, H, L, K] and minutes
    [G, M, L, K], K = `trace_lanes` sampled lanes of each cell. Pooled,
    each minute folds into the cells' accumulators as it ends, and only
    the K lanes' minutes are kept."""
    from repro_torch.kernels import ops
    bins = edges.shape[0]

    def fold_pooled(acc, m):
        return EM.accum_update_pooled(
            acc, MinuteOut(*(f.reshape(-1) for f in m)), edges)

    def lanes(rates: torch.Tensor) -> EM.MetricAccum:
        G, W, M = rates.shape
        if per_workload:
            flat = rates.reshape(G * W, M)
            out = []
            for ctrl in ctrls:
                parts = [EM._accum(ops.episode_block(
                    flat[sl].contiguous(), ctrl, cfg), bins, edges)
                    for sl in batch.chunks(G * W, w_chunk)]
                out.append(EM.MetricAccum(*(
                    torch.cat(f).reshape((G, W) + f[0].shape[1:])
                    for f in zip(*parts))))
            return _stack(out)
        out = []
        for ctrl in ctrls:
            cells = []
            for g in range(G):
                acc = EM.accum_init(bins, device=rates.device)
                for sl in batch.chunks(W, w_chunk):
                    m = ops.episode_block(rates[g, sl].contiguous(), ctrl,
                                          cfg)
                    acc = fold_pooled(acc, m)
                    del m
                cells.append(acc)
            out.append(_stack(cells))
        return _stack(out)

    def traced(rates: torch.Tensor):
        G, W, M = rates.shape
        dev = rates.device
        idx = batch.trace_index(W, trace_lanes, dev)
        K = W if idx is None else len(idx)
        flat_idx = None if idx is None else (
            torch.arange(G, device=dev)[:, None] * W + idx).reshape(-1)
        accs, cts = [], []
        for ctrl in ctrls:
            if per_workload:
                m, ct = cluster.run_traced(rates.reshape(G * W, M), ctrl,
                                           cfg, dev.type == "cuda", flat_idx)
                accs.append(EM.MetricAccum(*(
                    f.reshape((G, W) + f.shape[1:])
                    for f in EM._accum(m, bins, edges))))
                del m
            else:
                # each minute folds into its cell's pooled accumulator as
                # it ends (the reference's in-scan order), in f64 and
                # rounded to f32 once at the end: f32 running sums over
                # 1,440 minutes drift ~1e-5 from a whole chunk's sum
                acc = [EM.MetricAccum(*(a.double() for a in EM.accum_init(
                    bins, (G,), device=dev)))]

                def fold(out):
                    acc[0] = EM.accum_update_pooled(acc[0], MinuteOut(*(
                        f.reshape(G, W) for f in out)), edges)
                _, ct = cluster.run_traced(rates.reshape(G * W, M), ctrl,
                                           cfg, dev.type == "cuda", flat_idx,
                                           fold=fold)
                accs.append(EM.MetricAccum(*(a.float() for a in acc[0])))
            cts.append(obs_trace.ControlTrace(
                decisions=type(ct.decisions)(*(
                    a.reshape(a.shape[:2] + (G, K)).movedim(2, 0)
                    for a in ct.decisions)),
                minutes=type(ct.minutes)(*(
                    a.reshape((M, G, K)).movedim(1, 0)
                    for a in ct.minutes))))
        return _stack(accs), batch.stack_traces(cts, 3)

    if not telemetry:
        return lanes
    if w_chunk is not None:
        raise ValueError("telemetry runs each cell's workloads in one "
                         "traced episode; it does not compose with "
                         "w_chunk")
    return traced


def make_runner(spec_: MatrixSpec, classify=None, *,
                per_workload: bool = True, shard: bool = True,
                donate: bool = False, telemetry: bool = False,
                trace_lanes: int | None = None, device="cuda",
                w_chunk: int | None = None):
    """rates [S, Z, W, M] -> (pooled EpisodeMetrics [S, Z, F, P],
    per-workload EpisodeMetrics [S, Z, F, P, W]), tensors on `device`.

    ``per_workload=False`` pools the workload axis chunk by chunk
    (accumulators O(bins) per cell, independent of W) and returns
    ``(pooled, None)``: the fleet-scale mode. `w_chunk` workloads run per
    episode call (per-workload mode: of the flattened S * Z * W lanes;
    pooled mode: of each cell's W, which it must divide). `shard` and
    `donate` are the reference's and do nothing on one card.

    ``telemetry=True`` runs the traced blocked episodes (see the module
    docstring; `w_chunk` must be None) and returns a 3-tuple ``(pooled,
    per_workload, ControlTrace)`` with decisions leaves [S, Z, M, H, F,
    P, K] and minutes leaves [S, Z, M, F, P, K] (K = `trace_lanes`
    sampled workloads, all when None)."""
    del shard, donate
    dev = _device.resolve(device)
    cfg = spec_.sim_config()
    S, Z, F, P = spec_.shape
    ctrls = controllers(spec_, classify)
    # a policy without a forecaster is the same controller for every f:
    # it runs once, and its lane is repeated
    runs = [lane for lane in range(F * P) if lane < P or registry.spec(
        spec_.policies[lane % P]).takes_forecaster]
    source = [lane if lane in runs else lane % P for lane in range(F * P)]
    edges = EM.response_edges(spec_.bins, cfg.resp_cap_sec, device=dev)
    lanes = _lane_runner([ctrls[lane] for lane in runs], cfg, edges,
                         per_workload=per_workload, w_chunk=w_chunk,
                         telemetry=telemetry, trace_lanes=trace_lanes)
    pick = torch.tensor([runs.index(lane) for lane in source], device=dev)

    def cells(a: torch.Tensor) -> torch.Tensor:
        """[runs, S * Z, ...] -> [S, Z, F, P, ...]"""
        a = a[pick].reshape((F, P, S, Z) + a.shape[2:])
        return a.permute(2, 3, 0, 1, *range(4, a.dim()))

    def trace_cells(a: torch.Tensor, axis: int) -> torch.Tensor:
        """[S * Z, ..., runs (at `axis`), K] -> [S, Z, ..., F, P, K]"""
        a = a.index_select(axis, pick)
        return a.reshape((S, Z) + a.shape[1:axis] + (F, P)
                         + a.shape[axis + 1:])

    def run_fn(rates):
        rates = torch.as_tensor(rates).to(device=dev, dtype=torch.float32)
        if tuple(rates.shape[:2]) != (S, Z):
            raise ValueError(f"rates {tuple(rates.shape)}: expected "
                             f"[{S}, {Z}, W, M]")
        out = lanes(rates.reshape((S * Z,) + rates.shape[2:]))
        accs, ct = out if telemetry else (out, None)
        accs = EM.MetricAccum(*(cells(a) for a in accs))
        if telemetry:
            ct = obs_trace.ControlTrace(
                decisions=type(ct.decisions)(*(
                    trace_cells(a, 3) for a in ct.decisions)),
                minutes=type(ct.minutes)(*(
                    trace_cells(a, 2) for a in ct.minutes)))
        if not per_workload:
            pool, per_w = EM.finalize(accs, edges), None
        else:
            per_w = EM.finalize(accs, edges)
            pool = EM.finalize(EM.MetricAccum(*(
                a.sum(4) for a in accs)), edges)
        return (pool, per_w, ct) if telemetry else (pool, per_w)

    return run_fn


def make_controller_evaluator(ctrls: Sequence,
                              cfg: SimConfig = SimConfig(), *,
                              bins: int = EM.DEFAULT_BINS,
                              per_workload: bool = True,
                              shard: bool = True, telemetry: bool = False,
                              trace_lanes: int | None = None,
                              device="cuda", w_chunk: int | None = None):
    """A single-scenario evaluator for ad-hoc controllers (ablation
    variants, custom bands): rates [W, M] -> (pooled EpisodeMetrics [P],
    per-workload [P, W]); with ``per_workload=False`` the workload axis
    pools chunk by chunk and the result is ``(pooled [P], None)``.
    ``telemetry=True`` appends the ControlTrace (decisions leaves
    [M, H, P, K], minutes [M, P, K]) as a third element."""
    del shard
    dev = _device.resolve(device)
    edges = EM.response_edges(bins, cfg.resp_cap_sec, device=dev)
    lanes = _lane_runner(list(ctrls), cfg, edges,
                         per_workload=per_workload, w_chunk=w_chunk,
                         telemetry=telemetry, trace_lanes=trace_lanes)

    def run_fn(rates_w):
        rates_w = torch.as_tensor(rates_w).to(device=dev,
                                              dtype=torch.float32)
        out = lanes(rates_w[None])
        accs, ct = out if telemetry else (out, None)
        accs = EM.MetricAccum(*(a[:, 0] for a in accs))
        if not per_workload:
            pool, per_w = EM.finalize(accs, edges), None
        else:
            pool = EM.finalize(EM.MetricAccum(*(a.sum(1) for a in accs)),
                               edges)
            per_w = EM.finalize(accs, edges)
        if not telemetry:
            return pool, per_w
        return pool, per_w, obs_trace.ControlTrace(
            decisions=type(ct.decisions)(*(a[0] for a in ct.decisions)),
            minutes=type(ct.minutes)(*(a[0] for a in ct.minutes)))

    return run_fn


def evaluate_controllers(ctrls: Sequence, rates,
                         cfg: SimConfig = SimConfig(), *,
                         bins: int = EM.DEFAULT_BINS,
                         per_workload: bool = True, device="cuda"):
    """One-shot convenience wrapper over `make_controller_evaluator`."""
    return make_controller_evaluator(ctrls, cfg, bins=bins,
                                     per_workload=per_workload,
                                     device=device)(rates)


def _to_numpy(tree):
    return type(tree)(*(np.asarray(a.detach().cpu()) for a in tree))


def _execute(spec_: MatrixSpec, classify, device) -> EvalResult:
    pool, per_w = make_runner(spec_, classify, device=device)(
        build_rates(spec_))
    rei_b = ER.rei(pool.slo_violation_rate, pool.replica_minutes,
                   pool.scaling_actions, minutes=spec_.minutes,
                   n_workloads=spec_.n_workloads)
    return EvalResult(_to_numpy(pool), _to_numpy(per_w), _to_numpy(rei_b))


def run(spec_: MatrixSpec, *, classify=None, classifier_id: str = "",
        root=None, force: bool = False, device="cuda") -> MatrixRun:
    """The front door: evaluate the matrix, content-addressed.

    `classifier_id` must name the classifier whenever `classify` is
    passed (the callable itself cannot be hashed, so the id keys the
    artifact)."""
    from repro_torch.evals import artifacts
    if classify is not None and not classifier_id:
        raise ValueError("pass classifier_id= to content-address a run "
                         "with a custom classifier")
    key = dict(spec_.content_key(),
               classifier=classifier_id or "default_classify")
    root = artifacts.DEFAULT_ROOT if root is None else root
    if not force and artifacts.is_cached(spec_.name, key, root):
        result, card = artifacts.load_result(spec_.name, key, root)
        return MatrixRun(spec_, result, card, True)
    result = _execute(spec_, classify, device)
    card = artifacts.save_result(spec_, key, result, root, replace=force)
    return MatrixRun(spec_, result, card, False)
