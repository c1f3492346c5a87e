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

* ``make_fleet_runner`` — one dispatch: rates [C, Wc, M] on the device,
  a loop over the chunks summing their accumulators.
* ``make_chunk_folder`` — streaming: an (accum, chunk) -> accum fold,
  driven by a host generator (``rate_chunks`` here or
  ``aapaset.AAPAsetLoader.rate_chunks``). Rates never exist beyond one
  chunk — the 10^6-lane mode.

Both fold the same chunk accumulators in the same order. There is no
device mesh: one card runs every lane (``meta["n_devices"]`` is 1). The
decision trace (``FleetSpec.trace_lanes``) is not ported yet and raises.
``run_fleet`` wraps either mode with throughput, host-generation time,
peak host and device memory and the pooled REI.
"""
from __future__ import annotations

import dataclasses
import resource
import time
from typing import Any, Iterator, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import _device
from repro_torch.evals import metrics as EM
from repro_torch.evals import rei as ER
from repro_torch.evals.matrix import _lane_runner
from repro_torch.scaling import batch, registry, scenarios
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
    #: the reference's decision-trace sample per chunk (0 = off); not
    #: ported yet, so a run with trace_lanes > 0 raises
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


def _chunk_body(spec_: FleetSpec, classify, dev):
    """rates [Wc, M] on `dev` -> the chunk's pooled MetricAccum [P]."""
    batch._no_telemetry(spec_.trace_lanes > 0)
    cfg = spec_.sim_config()
    edges = EM.response_edges(spec_.bins, cfg.resp_cap_sec, device=dev)
    lanes = _lane_runner(controllers(spec_, classify), cfg, edges,
                         per_workload=False)
    return lambda chunk: EM.MetricAccum(*(a[:, 0]
                                          for a in lanes(chunk[None])))


def _add(acc: EM.MetricAccum, part: EM.MetricAccum) -> EM.MetricAccum:
    return EM.MetricAccum(*(a + b for a, b in zip(acc, part)))


def _acc0(spec_: FleetSpec, dev) -> EM.MetricAccum:
    return EM.accum_init(spec_.bins, (len(spec_.policies),), device=dev)


def make_fleet_runner(spec_: FleetSpec, classify=None, *,
                      donate: bool = True, device="cuda"):
    """rates [C, Wc, M] -> pooled MetricAccum of [P] leaves on `device`,
    one call: the chunks run in order and their accumulators sum.
    `donate` is the reference's (it donates the rates buffer to XLA) and
    does nothing here."""
    del donate
    dev = _device.resolve(device)
    body = _chunk_body(spec_, classify, dev)

    def run(rates) -> EM.MetricAccum:
        rates = torch.as_tensor(rates).to(device=dev, dtype=torch.float32)
        acc = _acc0(spec_, dev)
        for chunk in rates:
            acc = _add(acc, body(chunk))
        return acc

    return run


def make_chunk_folder(spec_: FleetSpec, classify=None, *, device="cuda"):
    """(MetricAccum [P], rates [Wc, M]) -> MetricAccum [P]: the streaming
    fold for generator-fed fleets. Memory is one chunk of rates plus one
    O(P * bins) accumulator, so W is bounded by wall clock."""
    dev = _device.resolve(device)
    body = _chunk_body(spec_, classify, dev)

    def fold(acc: EM.MetricAccum, chunk) -> EM.MetricAccum:
        return _add(acc, body(torch.as_tensor(chunk).to(
            device=dev, dtype=torch.float32)))

    return fold


class FleetResult(NamedTuple):
    spec: FleetSpec
    pooled: EM.EpisodeMetrics    # [P] numpy, pooled over the whole fleet
    rei: ER.REIBreakdown         # [P] numpy
    meta: dict                   # wall_s, lane_minutes_per_sec, memory ...
    trace: Any = None            # the reference's ControlTrace; always None


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

    `stream=False`: one call over the materialized [C, Wc, M] rates.
    `stream=True`: a loop over `chunks` (default `rate_chunks(spec_)`)
    through the fold — pass a loader-backed generator
    (`AAPAsetLoader.rate_chunks`) to run real traces instead of synthetic
    scenarios. `warmup=True` (one-dispatch mode) runs the call once
    before timing. `meta` adds to the reference's keys `gen_s` (host
    seconds spent generating rates: `build_rates` before a one-dispatch
    call, the generator inside a stream), `gen_share` (that over the
    run's elapsed time) and `peak_device_bytes` (the run's
    ``torch.cuda.max_memory_allocated``; None on the CPU)."""
    batch._no_telemetry(spec_.trace_lanes > 0)
    dev = _device.resolve(device)
    cfg = spec_.sim_config()
    edges = EM.response_edges(spec_.bins, cfg.resp_cap_sec, device=dev)
    P = len(spec_.policies)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t_build = time.perf_counter()
    if stream:
        fold = make_chunk_folder(spec_, classify, device=dev)
        feed, spent = _timed(rate_chunks(spec_) if chunks is None
                             else chunks)
        acc = _acc0(spec_, dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
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
        rates = build_rates(spec_)
        gen_s = time.perf_counter() - t_build
        run = make_fleet_runner(spec_, classify, device=dev)
        if warmup:
            run(rates)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        sync()
        t0 = time.perf_counter()
        acc = run(rates)
        sync()
        W, dispatches = spec_.n_workloads, 1
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
        "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                              if cuda else None),
        "n_devices": 1, "mesh": None}

    def host(tree):
        return type(tree)(*(a.cpu().numpy() for a in tree))

    return FleetResult(spec_, host(pooled), host(rei_b), meta, None)
