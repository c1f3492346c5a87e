"""Fleet-scale evaluation: 10^5-10^6 workload lanes per run (port of
``repro.evals.fleet``).

The matrix runner keeps per-workload accumulators ([..., W, bins]
histograms) — fine for a grid cell, fatal for a region. This module is
the fleet front door over the same core (``matrix._lane_runner`` with
``per_workload=False``): each chunk of `w_chunk` lanes runs one episode
call per policy (on the card the policy's pre-pass and the
``episode_block`` plant pass), and the chunk's [w_chunk, M] outputs fold
at once into pooled O(P * bins) accumulators on the device
(``evals.metrics.accum_update_pooled``). No chunk's outputs outlive it,
so peak device memory does not grow with the fleet.

Two execution modes, one chunk body:

* ``make_fleet_runner`` — one dispatch: rates [C, Wc, M] materialized
  on the host, a loop over the chunks (each copied to the device as it
  runs) summing their accumulators.
* ``make_chunk_folder`` — streaming: an (accum, chunk) -> accum fold,
  driven by a host generator (``rate_chunks`` here or
  ``aapaset.AAPAsetLoader.rate_chunks``). Rates never exist beyond one
  chunk — the 10^6-lane mode.

Both fold the same chunk accumulators in the same order.

Under an active device mesh (``dist.sharding.set_mesh``) chunk c runs on
device c mod n of the mesh's data axes (``dist.sharding.lane_devices``),
whole: every launch keeps its unsharded shape, and AAPA and hybrid lanes
classify with a copy of the classifier on their device. In both modes
the host feeds the chunks in order, each copied to its device from
pinned memory on a side stream so that the copy overlaps the chunks
running there and on the other devices; a device holds only its own
chunks' rates, one or two at a time. Each chunk's [P] accumulator is
copied to the mesh's first device and they sum there in chunk order, so
the pooled metrics and REI are the unsharded run's bit for bit.
``FleetSpec.trace_lanes > 0`` captures the decision trace of that many
sampled lanes per chunk in the one-dispatch mode: the chunks then run the
traced blocked episode (``matrix._lane_runner(telemetry=True)``: eager
`decide` per control-period head, ``plant_block`` for the other ticks on
the card) in place of the fused kernel, whose MinuteOut agrees with the
fused kernel's at the episode tolerance. That path costs eager launches
per control period whatever the lane count, so it advances all C chunks
as the cells of one episode per policy (C times fewer launches) and keeps
the whole fleet's per-minute outputs on the device, C times a chunk's;
each chunk's accumulators still fold from its own lanes and sum in chunk
order, so the pooled metrics are those of a chunk-by-chunk run (under
a mesh each device advances its chunks as the cells of its episode). The
stream refuses the trace, as in the reference. ``run_fleet`` wraps
either mode with throughput, host-generation time, peak host and device
memory and the pooled REI.
"""
from __future__ import annotations

import dataclasses
import functools
import resource
import time
from typing import Any, Iterator, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import _device
from repro_torch.dist import sharding as shd
from repro_torch.evals import metrics as EM
from repro_torch.evals import rei as ER
from repro_torch.evals.matrix import _lane_runner
from repro_torch.obs import trace as obs_trace
from repro_torch.scaling import policies, registry, scenarios
from repro_torch.sim.cluster import SimConfig


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """One fleet run: P policies x W workloads of one scenario family.

    `n_workloads` is the fleet size W; `w_chunk` lanes are live at a
    time (must divide W). Chunk c's workloads are drawn with a seed
    derived from (seed, c), so the fleet is deterministic and any chunk
    can be regenerated independently — the streaming mode depends on
    exactly that."""
    name: str
    policies: tuple[str, ...]
    forecaster: str = "holt_winters"
    scenario: str = "burst_storm"
    scenario_kw: tuple[tuple[str, Any], ...] = ()
    n_workloads: int = 1024
    w_chunk: int = 256
    minutes: int = 60
    seed: int = 0
    sim: tuple[tuple[str, Any], ...] = ()
    bins: int = EM.DEFAULT_BINS
    #: capture the decision trace for this many deterministically
    #: sampled lanes PER CHUNK (0 = telemetry off); one-dispatch mode only
    trace_lanes: int = 0

    def __post_init__(self):
        if self.n_workloads % self.w_chunk:
            raise ValueError(f"w_chunk {self.w_chunk} must divide "
                             f"n_workloads {self.n_workloads}")

    @property
    def n_chunks(self) -> int:
        return self.n_workloads // self.w_chunk

    def sim_config(self) -> SimConfig:
        return SimConfig(**dict(self.sim))


def spec(name: str, *, policies: Sequence[str], **kw) -> FleetSpec:
    """Normalizing constructor (dict kwargs become sorted tuples)."""
    for key in ("scenario_kw", "sim"):
        if isinstance(kw.get(key), dict):
            kw[key] = tuple(sorted(kw[key].items()))
    return FleetSpec(name=name, policies=tuple(policies), **kw)


def controllers(spec_: FleetSpec, classify=None) -> list:
    cfg = spec_.sim_config()
    out = []
    for p in spec_.policies:
        fkw = ({"forecaster": spec_.forecaster}
               if registry.spec(p).takes_forecaster else {})
        out.append(registry.get_controller(p, cfg, classify=classify,
                                           **fkw))
    return out


def chunk_seed(seed: int, chunk: int) -> int:
    """Derived per-chunk scenario seed, stable across runs/processes."""
    return int(np.random.SeedSequence([seed, chunk]).generate_state(1)[0])


def chunk_rates(spec_: FleetSpec, chunk: int) -> np.ndarray:
    """Chunk `chunk`'s workloads: [w_chunk, minutes] float32."""
    sc = scenarios.get(spec_.scenario, n_workloads=spec_.w_chunk,
                       minutes=spec_.minutes,
                       seed=chunk_seed(spec_.seed, chunk),
                       cfg=spec_.sim_config(), **dict(spec_.scenario_kw))
    return np.asarray(sc.rates, np.float32)


def rate_chunks(spec_: FleetSpec) -> Iterator[np.ndarray]:
    """All C chunks in order — the streaming mode's default feed."""
    for c in range(spec_.n_chunks):
        yield chunk_rates(spec_, c)


def build_rates(spec_: FleetSpec) -> np.ndarray:
    """Materialize the whole fleet [C, w_chunk, minutes] for the
    one-dispatch mode (the rates are the only thing that grows with W)."""
    return np.stack([chunk_rates(spec_, c) for c in range(spec_.n_chunks)])


def _controllers_on(spec_: FleetSpec, classify, dev) -> list:
    """`controllers`, each as lanes on `dev` run it (an AAPA or hybrid
    classifier copied there once, ``policies.on_device``)."""
    cfg = spec_.sim_config()
    return [policies.on_device(c, cfg, dev)
            for c in controllers(spec_, classify)]


def _chunk_body(spec_: FleetSpec, classify, dev):
    """rates [Wc, M] on `dev` -> the chunk's pooled MetricAccum [P]."""
    cfg = spec_.sim_config()
    edges = EM.response_edges(spec_.bins, cfg.resp_cap_sec, device=dev)
    lanes = _lane_runner(_controllers_on(spec_, classify, dev), cfg, edges,
                         per_workload=False)
    return lambda chunk: EM.MetricAccum(*(a[:, 0]
                                          for a in lanes(chunk[None])))


def _add(acc: EM.MetricAccum, part: EM.MetricAccum) -> EM.MetricAccum:
    return EM.MetricAccum(*(a + b.to(a.device) for a, b in zip(acc, part)))


def _acc0(spec_: FleetSpec, dev) -> EM.MetricAccum:
    return EM.accum_init(spec_.bins, (len(spec_.policies),), device=dev)


def _chunk_devices(dev) -> tuple[torch.device, ...]:
    """Where the chunks run, round-robin: the active mesh's data-axis
    devices, or `dev` alone (``dist.sharding.placement``)."""
    return tuple(_device.canonical(d) for d in shd.placement(dev))


def _per_device(make, devices):
    """`make(device)` once per distinct device, in a list by position."""
    made = {}
    for d in devices:
        if d not in made:
            made[d] = make(d)
    return [made[d] for d in devices]


def _bodies_by_mesh(make):
    """devices -> ``_per_device(make, devices)``, made once per tuple of
    devices: a runner built before a mesh is set (or changed) makes the
    chunk bodies for it at its first call under it, not at every call."""
    return functools.cache(lambda devices: _per_device(make, devices))


def make_fleet_runner(spec_: FleetSpec, classify=None, *,
                      donate: bool = True, device="cuda"):
    """rates [C, Wc, M] -> pooled MetricAccum of [P] leaves on `device`
    (under a mesh: its first device), one call: the chunks run in order,
    round-robin over the mesh's devices, and their accumulators sum in
    chunk order. `donate` is the reference's (it donates the rates buffer
    to XLA) and does nothing here.

    With ``spec_.trace_lanes > 0`` the runner returns ``(accum,
    ControlTrace)``: K sampled lanes per chunk, decisions leaves
    [C, M, H, P, K], minutes [C, M, P, K]."""
    del donate
    dev = _device.resolve(device)
    if spec_.trace_lanes > 0:
        return _traced_runner(spec_, classify, dev)

    bodies_on = _bodies_by_mesh(lambda d: _chunk_body(spec_, classify, d))
    bodies_on(_chunk_devices(dev))           # now, for the active mesh

    def run(rates) -> EM.MetricAccum:
        devs = _chunk_devices(dev)
        bodies = bodies_on(devs)
        rates = torch.as_tensor(rates, dtype=torch.float32)
        acc = _acc0(spec_, devs[0])
        for c in range(rates.shape[0]):
            k = c % len(devs)
            acc = _add(acc, bodies[k](_upload(rates[c], devs[k])))
        return acc

    return run


def _traced_runner(spec_: FleetSpec, classify, dev):
    """rates [C, Wc, M] -> (pooled MetricAccum [P], ControlTrace with
    decisions [C, M, H, P, K]): the chunks as the cells of one traced
    episode per policy (see the module docstring), on each device of a
    mesh those of its chunks; their pooled accumulators summed in chunk
    order on the first device, the trace in chunk order there."""
    cfg = spec_.sim_config()

    def make(d):
        edges = EM.response_edges(spec_.bins, cfg.resp_cap_sec, device=d)
        return _lane_runner(_controllers_on(spec_, classify, d), cfg,
                            edges, per_workload=False, telemetry=True,
                            trace_lanes=spec_.trace_lanes)

    lanes_on = _bodies_by_mesh(make)
    lanes_on(_chunk_devices(dev))

    def run(rates):
        devs = _chunk_devices(dev)
        n = len(devs)
        rates = torch.as_tensor(rates, dtype=torch.float32)
        outs = [lanes(rates[s::n].to(d)) for s, (d, lanes) in enumerate(
            zip(devs, lanes_on(devs))) if s < rates.shape[0]]
        acc = _acc0(spec_, devs[0])
        for c in range(rates.shape[0]):              # accums [P, C_s]
            acc = _add(acc, EM.MetricAccum(*(
                a[:, c // n] for a in outs[c % n][0])))

        def chunk_order(leaves):
            return type(leaves[0])(*(
                torch.stack([parts[c % n][c // n].to(devs[0])
                             for c in range(rates.shape[0])])
                for parts in zip(*leaves)))
        cts = [out[1] for out in outs]
        return acc, obs_trace.ControlTrace(
            decisions=chunk_order([ct.decisions for ct in cts]),
            minutes=chunk_order([ct.minutes for ct in cts]))

    return run


@functools.cache
def _copy_stream(dev: torch.device) -> torch.cuda.Stream:
    """The side stream that chunks are copied to `dev` on, one a card for
    the process: the caching allocator keeps a freed block for the stream
    it was allocated on, so one stream reuses the chunks' blocks from call
    to call where a new stream a call would hold on to them."""
    return torch.cuda.Stream(dev)


def _upload(chunk, dev: torch.device) -> torch.Tensor:
    """A host chunk on `dev`. On a card the copy runs from pinned memory
    on a side stream, so that it overlaps the kernels already queued there;
    the card's stream waits for it before using it."""
    x = torch.as_tensor(chunk, dtype=torch.float32)
    if dev.type != "cuda" or x.device.type != "cpu":
        return x.to(dev)
    side = _copy_stream(dev)
    host = x.pin_memory()
    with torch.cuda.stream(side):
        y = host.to(dev, non_blocking=True)
    main = torch.cuda.current_stream(dev)
    main.wait_stream(side)
    y.record_stream(main)
    return y


def make_chunk_folder(spec_: FleetSpec, classify=None, *, device="cuda"):
    """(MetricAccum [P], rates [Wc, M]) -> MetricAccum [P]: the streaming
    fold for generator-fed fleets. Memory is one chunk of rates (two
    while the next is copied) plus one O(P * bins) accumulator, so W is
    bounded by wall clock. Under a mesh the k-th call's chunk runs on
    device k mod n of its data axes and the accumulator stays on the
    first."""
    devs = _chunk_devices(_device.resolve(device))
    bodies = _per_device(lambda d: _chunk_body(spec_, classify, d), devs)
    calls = [0]

    def fold(acc: EM.MetricAccum, chunk) -> EM.MetricAccum:
        k = calls[0] % len(devs)
        calls[0] += 1
        return _add(acc, bodies[k](_upload(chunk, devs[k])))

    return fold


class FleetResult(NamedTuple):
    spec: FleetSpec
    pooled: EM.EpisodeMetrics    # [P] numpy, pooled over the whole fleet
    rei: ER.REIBreakdown         # [P] numpy
    meta: dict                   # wall_s, lane_minutes_per_sec, memory ...
    trace: Any = None            # ControlTrace (numpy) if trace_lanes > 0


def _peak_rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def _timed(chunks: Iterator[np.ndarray]):
    """(a generator over `chunks`, a one-element list that accumulates the
    seconds spent producing its items)."""
    spent = [0.0]

    def gen():
        it = iter(chunks)
        while True:
            t0 = time.perf_counter()
            item = next(it, None)
            spent[0] += time.perf_counter() - t0
            if item is None:
                return
            yield item

    return gen(), spent


def run_fleet(spec_: FleetSpec, *, classify=None, stream: bool = False,
              chunks: Iterator[np.ndarray] | None = None,
              warmup: bool = False, device="cuda") -> FleetResult:
    """Evaluate the fleet on `device`; returns pooled metrics + REI +
    throughput.

    `stream=False`: one call over the materialized [C, Wc, M] rates
    (`build_rates(spec_)`, or `chunks` stacked: an array of that shape,
    or the spec's C chunks of [Wc, M]).
    `stream=True`: a loop over `chunks` (default `rate_chunks(spec_)`)
    through the fold — pass a loader-backed generator
    (`AAPAsetLoader.rate_chunks`) to run real traces instead of synthetic
    scenarios. `warmup=True` (one-dispatch mode) runs the call once
    before timing. `meta` adds to the reference's keys `gen_s` (host
    seconds spent generating rates: `build_rates` before a one-dispatch
    call, the generator inside a stream), `gen_share` (that over the
    run's elapsed time) and `peak_device_bytes` (the run's
    ``torch.cuda.max_memory_allocated``, the largest of the cards' under
    a mesh; None on the CPU). `mesh` is the active mesh's shape (None
    without one) and `n_devices` the number of distinct devices the chunks
    ran on. With ``spec_.trace_lanes > 0`` the result's `trace` is the
    sampled lanes' ControlTrace (numpy; decisions [C, M, H, P, K]); the
    stream refuses it."""
    telemetry = spec_.trace_lanes > 0
    if telemetry and stream:
        raise ValueError("trace_lanes requires the one-dispatch mode; "
                         "the streaming fold keeps only the accumulator "
                         "(set stream=False)")
    dev = _device.resolve(device)
    devs = _chunk_devices(dev)
    cards = sorted({d for d in devs if d.type == "cuda"}, key=str)
    cfg = spec_.sim_config()
    edges = EM.response_edges(spec_.bins, cfg.resp_cap_sec, device=devs[0])
    P = len(spec_.policies)
    rules = shd.active()

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    def reset_peaks():
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)

    t_build = time.perf_counter()
    ct = None
    if stream:
        fold = make_chunk_folder(spec_, classify, device=dev)
        feed, spent = _timed(rate_chunks(spec_) if chunks is None
                             else chunks)
        acc = _acc0(spec_, devs[0])
        reset_peaks()
        sync()
        t0 = time.perf_counter()
        n_chunks = 0
        for chunk in feed:
            acc = fold(acc, chunk)
            n_chunks += 1
        sync()
        W = n_chunks * spec_.w_chunk
        dispatches = n_chunks
        gen_s = spent[0]
    else:
        if chunks is None:
            rates = build_rates(spec_)
        else:
            rates = np.asarray(chunks if isinstance(chunks, np.ndarray)
                               else np.stack(list(chunks)), np.float32)
            want = (spec_.n_chunks, spec_.w_chunk, spec_.minutes)
            if rates.shape != want:
                raise ValueError(f"chunks stack to {rates.shape}; the "
                                 f"one-dispatch run takes {want}")
        gen_s = time.perf_counter() - t_build
        run = make_fleet_runner(spec_, classify, device=dev)
        if warmup:
            run(rates)
        reset_peaks()
        sync()
        t0 = time.perf_counter()
        out = run(rates)
        sync()
        acc, ct = out if telemetry else (out, None)
        W, dispatches = spec_.n_workloads, 1
        n_chunks = spec_.n_chunks
    wall = time.perf_counter() - t0
    pooled = EM.finalize(acc, edges)
    rei_b = ER.rei(pooled.slo_violation_rate, pooled.replica_minutes,
                   pooled.scaling_actions, minutes=spec_.minutes,
                   n_workloads=W)
    elapsed = wall if stream else wall + gen_s
    meta = {
        "workloads": W, "minutes": spec_.minutes, "policies": P,
        "w_chunk": spec_.w_chunk, "dispatches": dispatches,
        "stream": stream, "wall_s": wall, "warm": bool(warmup),
        "build_s": t0 - t_build,
        "lane_minutes_per_sec": P * W * spec_.minutes / max(wall, 1e-9),
        "minutes_per_sec": W * spec_.minutes / max(wall, 1e-9),
        "gen_s": gen_s, "gen_share": gen_s / max(elapsed, 1e-9),
        "peak_rss_mb": _peak_rss_mb(),
        "peak_device_bytes": (max(torch.cuda.max_memory_allocated(d)
                                  for d in cards) if cards else None),
        "n_devices": len(set(devs[:max(n_chunks, 1)])),
        "mesh": None if rules is None else dict(rules.mesh.shape)}

    def host(tree):
        return type(tree)(*(a.cpu().numpy() for a in tree))

    return FleetResult(spec_, host(pooled), host(rei_b), meta,
                       None if ct is None else obs_trace.to_numpy(ct))
