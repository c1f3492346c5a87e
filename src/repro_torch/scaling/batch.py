"""Policies x workloads in one call (port of ``repro.scaling.batch``).

The reference folds the policy axis into one compiled scan over fused
P x W plant lanes, or, with its `decide_kernel`, runs one fused-decide
episode kernel per controller over the W lanes. The port takes that
kernel route: on the card each controller lane is one
``kernels.ops.episode_block`` call per chunk of `w_chunk` workloads (the
policy's pre-pass, then the plant pass); on the CPU the same call runs
the plain version. Lane (p, w) is ``simulate(rates[w], controllers[p])``.

* `make_batch_simulator(controllers, cfg)` — rates [W, M] -> MinuteOut
  [P, W, M].
* `make_forecast_batch_simulator(policies, forecasters, cfg)` —
  forecasters x policies -> MinuteOut [F, P, W, M].
* `make_grid_simulator(name, grid, cfg)` / `make_grid_evaluator(name,
  cfg)` — one policy family over a grid of hyperparameter points, as
  MinuteOut [G, W, M] or as pooled metrics and REI per point. Each point
  is the registry's controller of that point; the grid is validated and
  split into stackable and static keys as the reference does
  (`grid_split`).

Under an active device mesh (``dist.sharding.set_mesh``) and with
`shard` (the default), the workload axis splits into contiguous slices
over the mesh's data axes (``dist.sharding.lane_sharding``): each device
runs its slice's episodes, an AAPA or hybrid controller with a copy of
its classifier there (``policies.on_device``), and the per-lane outputs
come back to the mesh's first device in lane order. Lanes are
independent, so the result is the unsharded one bit for bit. `donate=`
is the reference's and does nothing. `telemetry=True` runs each
controller lane's episodes through the blocked loop with its decision
trace (``sim.cluster.run_traced``), `trace_lanes` of the W lanes traced;
under an active mesh each device traces the sampled lanes of its slice,
and the traces join in lane order, bit for bit the unsharded trace.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import _device
from repro_torch.dist import sharding as shd
from repro_torch.obs import trace as obs_trace
from repro_torch.scaling import policies, registry
from repro_torch.scaling.api import Controller
from repro_torch.sim import cluster
from repro_torch.sim.cluster import MinuteOut, SimConfig, simulate


def chunks(W: int, w_chunk: int | None) -> list[slice]:
    """The workload chunks of W lanes: all at once, or `w_chunk` at a
    time (which must divide W, as in the reference)."""
    if w_chunk is None or w_chunk >= W:
        return [slice(0, W)]
    if W % w_chunk:
        raise ValueError(f"w_chunk {w_chunk} must divide W {W}")
    return [slice(i, i + w_chunk) for i in range(0, W, w_chunk)]


def stack_traces(traces: list[obs_trace.ControlTrace], lane_axis: int
                 ) -> obs_trace.ControlTrace:
    """Per-controller time-major traces (decisions [M, H, ...],
    minutes [M, ...]) stacked on a new controller axis: decisions at
    `lane_axis`, minutes one axis earlier (they have no H axis)."""
    def stack(parts, axis):
        return type(parts[0])(*(torch.stack(f, axis) for f in zip(*parts)))
    return obs_trace.ControlTrace(
        decisions=stack([t.decisions for t in traces], lane_axis),
        minutes=stack([t.minutes for t in traces], lane_axis - 1))


def trace_index(W: int, trace_lanes: int | None, dev):
    """The traced lanes of W as a LongTensor on `dev` (None: all)."""
    idx = obs_trace.sample_lanes(W, trace_lanes)
    return None if idx is None else torch.as_tensor(idx, device=dev)


def lanes_sharding(shape, w_axis: int, shard: bool,
                   device=None) -> shd.LaneSharding | None:
    """The lane sharding of arrays of `shape` (workload axis `w_axis`)
    under the active mesh, or None (no mesh, or `shard` off). The
    caller's `device`, when given, must be of the mesh's type
    (``dist.sharding.check_device``). The traced path shards as the
    untraced one (`shard_index`, `join_traces`)."""
    sh = shd.lane_sharding(shape, w_axis=w_axis) if shard else None
    if sh is not None and device is not None:
        shd.check_device(device)
    return sh


def shard_index(idx, lo: int, hi: int, dev):
    """The traced lanes of the shard [lo, hi) of the workload axis, in its
    own numbering, on `dev` (None, all lanes, stays None)."""
    if idx is None:
        return None
    return (idx[(idx >= lo) & (idx < hi)] - lo).to(dev)


def join_traces(traces: list[obs_trace.ControlTrace],
                device) -> obs_trace.ControlTrace:
    """The shards' traces, in shard order, as the unsharded run's: every
    leaf's traced lanes are its last axis."""
    def join(parts):
        return type(parts[0])(*(torch.cat([a.to(device) for a in f], -1)
                                for f in zip(*parts)))
    return obs_trace.ControlTrace(
        decisions=join([t.decisions for t in traces]),
        minutes=join([t.minutes for t in traces]))


def make_batch_simulator(controllers: Sequence[Controller],
                         cfg: SimConfig = SimConfig(), *, device="cuda",
                         plant_kernel: bool | None = None,
                         decide_kernel: bool | None = None,
                         shard: bool = True, w_chunk: int | None = None,
                         donate: bool = False, telemetry: bool = False,
                         trace_lanes: int | None = None):
    """rates [W, M] -> MinuteOut [P, W, M]: every controller's episodes
    over the W lanes, `w_chunk` lanes per episode call (one episode
    kernel launch each on the card, after the policy's pre-pass).
    `plant_kernel` and `decide_kernel` are ``cluster.simulate``'s.

    `telemetry` returns ``(MinuteOut [P, W, M], ControlTrace)`` with the
    trace time-major: decisions leaves [M, H, P, K], minutes [M, P, K]
    (K = `trace_lanes` sampled lanes, ``obs.trace.sample_lanes``; all W
    when None). It runs the blocked loop, so on the card it needs
    ``decide_kernel=False`` (else ValueError, as in the reference), and
    it refuses `w_chunk`: chunked capture is ``evals.fleet``'s
    (``FleetSpec.trace_lanes``).

    Under an active mesh with `shard`, each device runs its slice of the
    W lanes (`w_chunk` lanes per call within it; with `telemetry`, the
    sampled lanes of its slice traced) and the result lands on the
    mesh's first device."""
    del donate
    ctrls = list(controllers)
    dev = _device.resolve(device)
    if telemetry and w_chunk is not None:
        raise ValueError(
            "telemetry does not compose with w_chunk here; for chunked "
            "capture use repro_torch.evals.fleet with trace_lanes "
            "(FleetSpec(..., trace_lanes=K) samples K lanes per chunk)")
    if telemetry and cluster._use_decide_kernel(dev, decide_kernel):
        cluster._reject_decide_kernel_telemetry()
    use_kernel = dev.type == "cuda" if plant_kernel is None else plant_kernel

    def traced(rates, idx):
        """rates [W, M] on one device, its traced lanes `idx` (None: all)
        -> (MinuteOut [P, W, M], ControlTrace) there."""
        outs, cts = zip(*(cluster.run_traced(
            rates, policies.on_device(ctrl, cfg, rates.device), cfg,
            use_kernel, idx) for ctrl in ctrls))
        return (MinuteOut(*(torch.stack(f) for f in zip(*outs))),
                stack_traces(list(cts), 2))

    def lanes(rates) -> MinuteOut:
        """rates [W, M] on one device -> MinuteOut [P, W, M] there."""
        per_ctrl = []
        for ctrl in ctrls:
            ctrl = policies.on_device(ctrl, cfg, rates.device)
            parts = [simulate(rates[sl].contiguous(), ctrl, cfg,
                              device=rates.device, plant_kernel=plant_kernel,
                              decide_kernel=decide_kernel)
                     for sl in chunks(rates.shape[0], w_chunk)]
            per_ctrl.append([torch.cat(f, 0) for f in zip(*parts)])
        return MinuteOut(*(torch.stack(f) for f in zip(*per_ctrl)))

    def run(rates) -> MinuteOut:
        rates = torch.as_tensor(rates, dtype=torch.float32)
        sh = lanes_sharding(rates.shape, 0, shard, dev)
        idx = trace_index(rates.shape[0], trace_lanes, dev) if telemetry \
            else None
        if sh is None:
            rates = rates.to(dev)
            return traced(rates, idx) if telemetry else lanes(rates)
        xs, first = shd.scatter(rates, sh), sh.devices[0]

        def join(outs) -> MinuteOut:
            return MinuteOut(*(shd.gather(f, 1, first) for f in zip(*outs)))
        if telemetry:
            parts = [traced(x, shard_index(idx, lo, hi, x.device))
                     for x, (lo, hi) in zip(xs, sh.bounds())]
            return (join([o for o, _ in parts]),
                    join_traces([c for _, c in parts], first))
        return join([lanes(x) for x in xs])

    return run


def batch_simulate(controllers: Sequence[Controller], rates,
                   cfg: SimConfig = SimConfig(), *,
                   device="cuda") -> MinuteOut:
    """Convenience wrapper: rates [W, M] -> MinuteOut of [P, W, M]."""
    return make_batch_simulator(controllers, cfg, device=device)(rates)


def make_forecast_batch_simulator(policies: Sequence[str],
                                  forecasters: Sequence,
                                  cfg: SimConfig = SimConfig(), *,
                                  classify=None, device="cuda",
                                  **overrides):
    """Forecasters x policies x workloads: rates [W, M] -> MinuteOut
    [F, P, W, M]; lane (f, p) is policy p on forecaster f. Every policy
    must take a forecaster (`predictive`, `aapa`, `hybrid`)."""
    aware = [n for n in registry.available()
             if registry.spec(n).takes_forecaster]
    for p in policies:
        if not registry.spec(p).takes_forecaster:
            raise TypeError(f"policy {p!r} takes no forecaster; "
                            f"forecaster-aware policies: {aware}")
    ctrls = [registry.get_controller(p, cfg, classify=classify,
                                     forecaster=f, **overrides)
             for f in forecasters for p in policies]
    sim = make_batch_simulator(ctrls, cfg, device=device)
    shape = (len(forecasters), len(policies))

    def run(rates) -> MinuteOut:
        out = sim(rates)                              # [F*P, W, M]
        return MinuteOut(*(a.reshape(shape + a.shape[1:]) for a in out))

    return run


def _canon_static(v):
    """Canonical hashable form of a static hyperparameter value (the
    reference's: ints stay ints, floats become Python floats)."""
    if isinstance(v, (bool, str)):
        return v
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    return v


def _validate_hyper(sp, keys, what: str) -> None:
    bad = set(keys) - set(sp.defaults)
    if bad:
        raise TypeError(f"policy {sp.name!r} has no hyperparameters "
                        f"{sorted(bad)} ({what}); "
                        f"accepts {sorted(sp.defaults)}")


def grid_split(name: str, grid: Sequence[dict], fixed: dict):
    """Validate a hyperparameter grid and split its keys into stackable
    (`traced` in the reference) and static ones.

    Every point must set the same keys, all accepted by the policy, none
    also in `fixed`. Returns (spec, stackable keys, groups): groups lists
    (static items, grid indices) in first-appearance order."""
    sp = registry.spec(name)
    if not grid:
        raise ValueError("empty hyperparameter grid")
    _validate_hyper(sp, fixed, "fixed kwargs")
    keys = sorted(grid[0])
    _validate_hyper(sp, keys, "grid keys")
    overlap = set(keys) & set(fixed)
    if overlap:
        raise TypeError(f"grid key(s) {sorted(overlap)} for policy "
                        f"{name!r} are also passed as fixed kwargs")
    for g in grid:
        if sorted(g) != keys:
            raise ValueError("every grid point must set the same keys")
    traced = tuple(k for k in keys if k in sp.stackable)
    static = tuple(k for k in keys if k not in sp.stackable)
    groups: dict[tuple, list[int]] = {}
    for i, g in enumerate(grid):
        groups.setdefault(tuple((k, _canon_static(g[k])) for k in static),
                          []).append(i)
    return sp, traced, [(skey, tuple(idx)) for skey, idx in groups.items()]


def _grid_controllers(name: str, grid: Sequence[dict], cfg, classify,
                      fixed: dict) -> tuple[list[Controller], list]:
    """The registry's controller of each grid point (defaults, then
    `fixed`, then the point), in grid order, and the grid's static
    groups (`grid_split`)."""
    _, _, groups = grid_split(name, grid, fixed)
    return [registry.get_controller(name, cfg, classify=classify,
                                    **fixed, **g) for g in grid], groups


def make_grid_simulator(name: str, grid: Sequence[dict],
                        cfg: SimConfig = SimConfig(), *, classify=None,
                        device="cuda", **fixed):
    """One policy family over a grid of hyperparameter points: rates
    [W, M] -> MinuteOut [len(grid), W, M] in grid order."""
    return make_batch_simulator(
        _grid_controllers(name, [dict(g) for g in grid], cfg, classify,
                          fixed)[0], cfg, device=device)


def make_grid_evaluator(name: str, cfg: SimConfig = SimConfig(), *,
                        classify=None, bins: int | None = None,
                        rei_kw: dict | None = None, device="cuda",
                        **fixed):
    """Candidate scoring: ``evaluate(grid, rates [W, M]) ->
    (EpisodeMetrics [G], REIBreakdown [G])``, each candidate's metrics
    pooled over the workloads chunk by chunk (no [G, W, M] output is
    kept). REI baselines default from the episode shape; `rei_kw`
    overrides them."""
    from repro_torch.evals import matrix
    from repro_torch.evals import metrics as EM
    from repro_torch.evals import rei as ER
    _validate_hyper(registry.spec(name), fixed, "fixed kwargs")
    bins = EM.DEFAULT_BINS if bins is None else bins
    rei_kw = dict(rei_kw or {})
    structures: set[tuple] = set()

    def evaluate(grid, rates):
        ctrls, groups = _grid_controllers(name, [dict(g) for g in grid],
                                          cfg, classify, fixed)
        rates = torch.as_tensor(rates)
        W, M = rates.shape
        structures.update((skey, len(idx), (W, M)) for skey, idx in groups)
        met, _ = matrix.make_controller_evaluator(
            ctrls, cfg, bins=bins, per_workload=False, device=device)(rates)
        rb = ER.rei(met.slo_violation_rate, met.replica_minutes,
                    met.scaling_actions,
                    **{"minutes": M, "n_workloads": W, **rei_kw})
        return met, rb

    # what the reference's compile cache counts: one entry per static
    # group, group size and rates shape the evaluator has seen
    evaluate._cache_size = lambda: len(structures)
    return evaluate
