"""Aggregation of simulator outputs into the paper's evaluation metrics
(§IV.D) in NumPy: the host-side oracle (port of ``repro.sim.metrics``)
that the tensor metrics in ``repro_torch.evals.metrics`` are pinned to.
Takes MinuteOut fields as NumPy arrays or CPU tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sim.cluster import MinuteOut


@dataclasses.dataclass(frozen=True)
class EpisodeMetrics:
    # performance
    slo_violation_rate: float
    cold_start_rate: float
    mean_response_ms: float
    p95_response_ms: float
    p99_response_ms: float
    # efficiency
    replica_minutes: float
    avg_cpu_util: float
    overprovision_rate: float   # fraction of time with util < 50%
    # stability
    scaling_actions: float
    oscillations: float
    mean_action_interval_min: float
    total_requests: float

    def as_dict(self):
        return dataclasses.asdict(self)


def _weighted_quantile(values: np.ndarray, weights: np.ndarray,
                       q: float) -> float:
    """Inverted-CDF weighted quantile: the smallest value whose cumulative
    weight reaches q * total. Degenerate inputs (empty, non-finite or
    non-positive total weight) return 0.0; q is clipped to [0, 1]; the
    target stays strictly positive so zero-weight values at either end
    are never selected."""
    values = np.asarray(values, np.float64).reshape(-1)
    weights = np.asarray(weights, np.float64).reshape(-1)
    if values.size == 0:
        return 0.0
    total = weights.sum()
    if not np.isfinite(total) or total <= 0:
        return 0.0
    q = float(np.clip(q, 0.0, 1.0))
    order = np.argsort(values, kind="stable")
    v, w = values[order], weights[order]
    cw = np.cumsum(w)
    target = min(max(q * total, np.finfo(np.float64).tiny), total)
    idx = int(np.searchsorted(cw, target, side="left"))
    return float(v[min(idx, len(v) - 1)])


def aggregate(out: MinuteOut, workload_axis: bool = False) -> EpisodeMetrics:
    """Aggregate a MinuteOut of [M] arrays (or [W, M], pooled across
    workloads; the flattening is the same) into EpisodeMetrics."""
    o = {k: np.asarray(v, np.float64).reshape(-1)
         for k, v in out._asdict().items()}
    served = o["served"]
    total = served.sum()
    arrived = max(total, 1.0)
    resp_mean_min = np.where(served > 0,
                             o["resp_sum"] / np.maximum(served, 1e-9), 0.0)
    minutes = len(served)
    actions = o["ups"].sum() + o["downs"].sum()
    return EpisodeMetrics(
        slo_violation_rate=float(o["violated"].sum() / arrived),
        cold_start_rate=float(o["cold_starts"].sum() / arrived),
        mean_response_ms=float(1e3 * o["resp_sum"].sum() / arrived),
        p95_response_ms=1e3 * _weighted_quantile(resp_mean_min, served,
                                                 0.95),
        p99_response_ms=1e3 * _weighted_quantile(resp_mean_min, served,
                                                 0.99),
        replica_minutes=float(o["replica_seconds"].sum() / 60.0),
        avg_cpu_util=float(o["util_mean"].mean()),
        overprovision_rate=float((o["util_mean"] < 0.5).mean()),
        scaling_actions=float(actions),
        oscillations=float(o["oscillations"].sum()),
        mean_action_interval_min=float(minutes / max(actions, 1.0)),
        total_requests=float(total),
    )


def per_workload(out: MinuteOut) -> list[EpisodeMetrics]:
    """out of [W, M] arrays -> one EpisodeMetrics per workload."""
    W = np.asarray(out.served).shape[0]
    return [aggregate(MinuteOut(*[np.asarray(v)[w] for v in out]))
            for w in range(W)]
