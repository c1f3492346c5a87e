"""Evaluation metrics on tensors (port of ``repro.evals.metrics``):
EpisodeMetrics over any leading batch shape, with P95/P99 from fixed
log-spaced response histograms, pinned to the NumPy oracle
(``repro_torch.sim.metrics.aggregate``) by the tests.

* ``compute(out)`` / ``pooled(out)`` — post-hoc over MinuteOut arrays of
  shape [..., M] (or [..., W, M] pooled across workloads); one
  ``index_add_`` builds every lane's histogram.
* ``make_metrics_simulator`` — rates [W, M] through the simulator, then
  per-workload and pooled metrics.

Quantiles: per-minute mean responses land in log-spaced bins spanning
[resp_cap * 1e-5, resp_cap]; a quantile is the geometric midpoint of the
bin where the cumulative served weight first reaches q * total, within
``quantile_rel_bound(bins)`` (~0.6% at 1024 bins) of the binned values.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import _device
from repro_torch.sim.cluster import (MinuteOut, SimConfig, make_simulator,
                                     recip)

DEFAULT_BINS = 1024
_EDGE_LO_FRAC = 1e-5     # lowest histogram edge = resp_cap * this
EPS = 1e-9
F32 = torch.float32


class EpisodeMetrics(NamedTuple):
    """Field-for-field mirror of ``sim.metrics.EpisodeMetrics`` as
    tensors of any batch shape."""
    slo_violation_rate: torch.Tensor
    cold_start_rate: torch.Tensor
    mean_response_ms: torch.Tensor
    p95_response_ms: torch.Tensor
    p99_response_ms: torch.Tensor
    replica_minutes: torch.Tensor
    avg_cpu_util: torch.Tensor
    overprovision_rate: torch.Tensor
    scaling_actions: torch.Tensor
    oscillations: torch.Tensor
    mean_action_interval_min: torch.Tensor
    total_requests: torch.Tensor

    def as_dict(self):
        return self._asdict()


class MetricAccum(NamedTuple):
    """Additive accumulator: pooling any batch axis is a sum over it
    before `finalize`."""
    served: torch.Tensor
    violated: torch.Tensor
    cold: torch.Tensor
    replica_sec: torch.Tensor
    resp_sum: torch.Tensor
    util_sum: torch.Tensor
    over_cnt: torch.Tensor      # minutes with util_mean < 0.5
    ups: torch.Tensor
    downs: torch.Tensor
    osc: torch.Tensor
    minutes: torch.Tensor
    hist: torch.Tensor          # [..., bins] served-weighted histogram


def response_edges(bins: int = DEFAULT_BINS,
                   resp_cap: float = SimConfig().resp_cap_sec, *,
                   device="cuda") -> torch.Tensor:
    """Log-spaced bin edges (seconds): bin 0 is [0, edges[0]], bin k>=1 is
    (edges[k-1], edges[k]]. Computed in f64 and rounded once to f32."""
    edges = np.geomspace(resp_cap * _EDGE_LO_FRAC, resp_cap, bins)
    return torch.as_tensor(edges.astype(np.float32),
                           device=_device.resolve(device))


def quantile_rel_bound(bins: int = DEFAULT_BINS) -> float:
    """Relative error bound of the histogram quantile vs the exact
    weighted quantile of the binned values: half a log-bin."""
    ratio = (1.0 / _EDGE_LO_FRAC) ** (1.0 / (bins - 1))
    return math.sqrt(ratio) - 1.0


def _representatives(edges: torch.Tensor) -> torch.Tensor:
    mids = torch.sqrt(edges[:-1] * edges[1:])
    return torch.cat([edges[:1], mids])


def _bin_index(resp: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    idx = torch.searchsorted(edges, resp.contiguous(), right=False)
    return idx.clamp(0, edges.shape[0] - 1)


def _resp_mean(out: MinuteOut) -> torch.Tensor:
    served = out.served
    return torch.where(served > 0, out.resp_sum / served.clamp_min(EPS),
                       torch.zeros_like(served))


def accum_init(bins: int = DEFAULT_BINS, lanes: tuple[int, ...] = (), *,
               device="cuda") -> MetricAccum:
    dev = _device.resolve(device)
    z = torch.zeros(lanes, dtype=F32, device=dev)
    return MetricAccum(*(z.clone() for _ in range(11)),
                       hist=torch.zeros(lanes + (bins,), dtype=F32,
                                        device=dev))


def _scatter_hist(hist: torch.Tensor, idx: torch.Tensor,
                  weight: torch.Tensor) -> torch.Tensor:
    """hist [L, bins] += weight [L, N] at bins idx [L, N], per lane (the
    weights in the histogram's dtype)."""
    L, bins = hist.shape
    flat = (torch.arange(L, device=hist.device)[:, None] * bins
            + idx).reshape(-1)
    return hist.reshape(-1).index_add_(
        0, flat, weight.reshape(-1).to(hist.dtype)).reshape(L, bins)


def accum_update(acc: MetricAccum, m: MinuteOut,
                 edges: torch.Tensor) -> MetricAccum:
    """Fold one minute of [...] plant output into a [...] accumulator."""
    lead = m.served.shape
    idx = _bin_index(_resp_mean(m), edges).reshape(-1, 1)
    hist = _scatter_hist(acc.hist.reshape(-1, edges.shape[0]).clone(), idx,
                         m.served.reshape(-1, 1)).reshape(acc.hist.shape)
    return MetricAccum(
        served=acc.served + m.served, violated=acc.violated + m.violated,
        cold=acc.cold + m.cold_starts,
        replica_sec=acc.replica_sec + m.replica_seconds,
        resp_sum=acc.resp_sum + m.resp_sum,
        util_sum=acc.util_sum + m.util_mean,
        over_cnt=acc.over_cnt + (m.util_mean < 0.5).to(F32),
        ups=acc.ups + m.ups, downs=acc.downs + m.downs,
        osc=acc.osc + m.oscillations,
        minutes=acc.minutes + torch.ones(lead, dtype=F32,
                                         device=acc.minutes.device),
        hist=hist)


def accum_update_pooled(acc: MetricAccum, m: MinuteOut,
                        edges: torch.Tensor) -> MetricAccum:
    """Fold one minute of [..., W] plant output into a pooled [...]
    accumulator (the workload axis reduces as it folds)."""
    idx = _bin_index(_resp_mean(m), edges)                 # [..., W]
    W = idx.shape[-1]
    hist = _scatter_hist(acc.hist.reshape(-1, edges.shape[0]).clone(),
                         idx.reshape(-1, W), m.served.reshape(-1, W))
    return MetricAccum(
        served=acc.served + m.served.sum(-1),
        violated=acc.violated + m.violated.sum(-1),
        cold=acc.cold + m.cold_starts.sum(-1),
        replica_sec=acc.replica_sec + m.replica_seconds.sum(-1),
        resp_sum=acc.resp_sum + m.resp_sum.sum(-1),
        util_sum=acc.util_sum + m.util_mean.sum(-1),
        over_cnt=acc.over_cnt + (m.util_mean < 0.5).to(F32).sum(-1),
        ups=acc.ups + m.ups.sum(-1), downs=acc.downs + m.downs.sum(-1),
        osc=acc.osc + m.oscillations.sum(-1),
        minutes=acc.minutes + float(W),
        hist=hist.reshape(acc.hist.shape))


def _hist_quantile(hist: torch.Tensor, rep: torch.Tensor,
                   q: float) -> torch.Tensor:
    """hist [..., bins] -> the representative of the first bin where the
    weighted CDF reaches q (inverted CDF, as the host oracle)."""
    cum = torch.cumsum(hist, -1)
    total = cum[..., -1]
    target = (q * total).clamp_min(EPS)
    idx = (cum < target[..., None]).sum(-1).clamp(0, hist.shape[-1] - 1)
    return torch.where(total > 0, rep[idx], torch.zeros_like(total))


def finalize(acc: MetricAccum, edges: torch.Tensor) -> EpisodeMetrics:
    """Accumulator -> EpisodeMetrics, any batch shape (bins axis last)."""
    rep = _representatives(edges)
    arrived = acc.served.clamp_min(1.0)
    actions = acc.ups + acc.downs
    minutes = acc.minutes.clamp_min(1.0)
    return EpisodeMetrics(
        slo_violation_rate=acc.violated / arrived,
        cold_start_rate=acc.cold / arrived,
        mean_response_ms=1e3 * acc.resp_sum / arrived,
        p95_response_ms=1e3 * _hist_quantile(acc.hist, rep, 0.95),
        p99_response_ms=1e3 * _hist_quantile(acc.hist, rep, 0.99),
        replica_minutes=acc.replica_sec * recip(60.0),
        avg_cpu_util=acc.util_sum / minutes,
        overprovision_rate=acc.over_cnt / minutes,
        scaling_actions=actions,
        oscillations=acc.osc,
        mean_action_interval_min=acc.minutes / actions.clamp_min(1.0),
        total_requests=acc.served)


def _as_minute_out(out, dev) -> MinuteOut:
    return MinuteOut(*(torch.as_tensor(v).to(device=dev, dtype=F32)
                       for v in out))


def _accum(out: MinuteOut, bins: int, edges: torch.Tensor) -> MetricAccum:
    """MinuteOut [..., M] -> per-trajectory MetricAccum [...]."""
    served = out.served
    lead, m = served.shape[:-1], served.shape[-1]
    idx = _bin_index(_resp_mean(out), edges).reshape(-1, m)
    hist = _scatter_hist(
        torch.zeros((idx.shape[0], bins), dtype=F32, device=served.device),
        idx, served.reshape(-1, m)).reshape(lead + (bins,))
    return MetricAccum(
        served=served.sum(-1), violated=out.violated.sum(-1),
        cold=out.cold_starts.sum(-1),
        replica_sec=out.replica_seconds.sum(-1),
        resp_sum=out.resp_sum.sum(-1), util_sum=out.util_mean.sum(-1),
        over_cnt=(out.util_mean < 0.5).to(F32).sum(-1),
        ups=out.ups.sum(-1), downs=out.downs.sum(-1),
        osc=out.oscillations.sum(-1),
        minutes=torch.full(lead, float(m), dtype=F32, device=served.device),
        hist=hist)


def compute(out: MinuteOut, *, bins: int = DEFAULT_BINS,
            resp_cap: float = SimConfig().resp_cap_sec,
            device="cuda") -> EpisodeMetrics:
    """MinuteOut of [..., M] arrays -> EpisodeMetrics of [...] tensors,
    each trailing-[M] trajectory aggregated on its own."""
    dev = _device.resolve(device)
    edges = response_edges(bins, resp_cap, device=dev)
    return finalize(_accum(_as_minute_out(out, dev), bins, edges), edges)


def pooled(out: MinuteOut, **kw) -> EpisodeMetrics:
    """MinuteOut of [..., W, M] arrays pooled across workloads -> [...]."""
    flat = MinuteOut(*(torch.as_tensor(a).reshape(
        tuple(a.shape[:-2]) + (-1,)) for a in out))
    return compute(flat, **kw)


#: compute() on [W, M] arrays IS the per-workload breakdown.
per_workload = compute


def make_metrics_simulator(controller, cfg: SimConfig = SimConfig(), *,
                           bins: int = DEFAULT_BINS, device="cuda"):
    """rates [W, M] -> (pooled EpisodeMetrics scalars, per-workload
    EpisodeMetrics of [W] tensors); pooled = per-workload accumulators
    summed over W, as in the reference."""
    dev = _device.resolve(device)
    edges = response_edges(bins, cfg.resp_cap_sec, device=dev)
    sim = make_simulator(controller, cfg, device=dev)

    def run(rates):
        accs = _accum(sim(rates), bins, edges)
        pool = MetricAccum(*(a.sum(0) for a in accs))
        return finalize(pool, edges), finalize(accs, edges)

    return run
