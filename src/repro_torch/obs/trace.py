"""Decision-telemetry schema (port of ``repro.obs.trace``): what a control
decision looked like.

One `DecisionRecord` per control-period head, captured by the unfused
episode (``sim.cluster.simulate(..., decide_kernel=False,
telemetry=True)``) and by the runners built on it (``scaling.batch``,
``evals.matrix``, ``evals.fleet``). The schema is flat f32: NaN marks
"this policy has no such signal" (hpa has no forecast, only hybrid has a
guard floor), so the host-side consumers (``obs.attribute``, the obs
cards) never need a sidecar naming the policy of a lane.

`ControlTrace` bundles the per-head decisions with the per-minute plant
outcomes (arrivals, served, violated) of the same lanes: everything the
blame walk in ``obs.attribute`` needs. Leaves are tensors until
`to_numpy`; the NumPy helpers (`stack_records`, `lane`) take either.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

F32 = torch.float32


class ExplainOut(NamedTuple):
    """A controller's self-report of the signals behind one decision,
    from `Controller.explain` (the same (state, obs) inputs as `decide`,
    on the pre-decide state); NaN where a policy has no such signal."""
    fc_point: torch.Tensor     # forecast point (arrivals/min, horizon peak)
    fc_lo: torch.Tensor        # forecast interval bounds
    fc_hi: torch.Tensor
    confidence: torch.Tensor   # effective confidence fed to Algorithm 1
    archetype: torch.Tensor    # f32 archetype id (0..3), NaN when untyped
    guard_floor: torch.Tensor  # hybrid's reactive floor, NaN otherwise


class DecisionRecord(NamedTuple):
    """One control decision, fully accounted: observation -> controller
    signals -> raw desired -> clip/cooldown outcome. All fields f32 and
    broadcast to a common lane shape."""
    minute: torch.Tensor          # global minute index of the decision
    sec: torch.Tensor             # second-of-minute of the block head
    ready: torch.Tensor           # ready replicas at the decision
    total: torch.Tensor           # ready + starting (what desired compares to)
    queue: torch.Tensor
    util_ema: torch.Tensor
    rate_rps: torch.Tensor        # arrival rate the controller saw
    fc_point: torch.Tensor        # ExplainOut passthrough (NaN when absent)
    fc_lo: torch.Tensor
    fc_hi: torch.Tensor
    confidence: torch.Tensor
    archetype: torch.Tensor
    guard_floor: torch.Tensor
    desired_raw: torch.Tensor     # decide() output before the max clip
    desired: torch.Tensor         # after the clip (what apply_decision saw)
    target: torch.Tensor          # total + add - remove (what the plant got)
    cooldown_req: torch.Tensor    # cooldown the controller requested (s)
    cooldown_before: torch.Tensor  # limiter cooldown remaining at the decision
    scale_up: torch.Tensor        # 1.0 when the action fired
    scale_down: torch.Tensor
    cooldown_blocked: torch.Tensor  # wanted a scale-down, cooldown held it
    capacity_capped: torch.Tensor   # desired_raw exceeded max_replicas


class MinuteTrace(NamedTuple):
    """Per-minute plant outcomes of the traced lanes (the blame walk's
    ground truth about what actually happened)."""
    rate: torch.Tensor            # arrivals that minute
    served: torch.Tensor
    violated: torch.Tensor
    queue_end: torch.Tensor
    ready_mean: torch.Tensor


class ControlTrace(NamedTuple):
    """decisions: DecisionRecord leaves [..., M, H, ...lane axes];
    minutes: MinuteTrace leaves [..., M, ...lane axes]. The axis layout
    depends on the producer (see each simulate/runner docstring); `lane()`
    slices out one lane either way."""
    decisions: DecisionRecord
    minutes: MinuteTrace


def explain_nan(shape: tuple = (), device="cpu") -> ExplainOut:
    """The no-signal ExplainOut for policies without an explain hook."""
    nan = torch.full(shape, float("nan"), dtype=F32, device=device)
    return ExplainOut(nan, nan, nan, nan, nan, nan)


def record(cfg, *, minute_idx, sec, ready, total, queue, util_ema,
           rate_rps, exp: ExplainOut, desired_raw, desired, cooldown_req,
           cooldown_before, act) -> DecisionRecord:
    """Assemble DecisionRecords from the decision-site values; every field
    is cast to f32 and broadcast to `desired`'s shape. Elementwise, so one
    call over a stack of decisions equals a call per decision."""
    shape, dev = desired.shape, desired.device

    def f(x):
        if not isinstance(x, torch.Tensor):     # a minute or second index
            return torch.full(shape, float(x), dtype=F32, device=dev)
        x = x if x.dtype == F32 else x.to(F32)
        return x if x.shape == shape else torch.broadcast_to(x, shape)

    return DecisionRecord(
        minute=f(minute_idx), sec=f(sec), ready=f(ready), total=f(total),
        queue=f(queue), util_ema=f(util_ema), rate_rps=f(rate_rps),
        fc_point=f(exp.fc_point), fc_lo=f(exp.fc_lo), fc_hi=f(exp.fc_hi),
        confidence=f(exp.confidence), archetype=f(exp.archetype),
        guard_floor=f(exp.guard_floor),
        desired_raw=f(desired_raw), desired=f(desired),
        target=f(total + act.add - act.remove),
        cooldown_req=f(cooldown_req), cooldown_before=f(cooldown_before),
        scale_up=f(act.scale_up), scale_down=f(act.scale_down),
        cooldown_blocked=f((desired < total - 0.5)
                           & (cooldown_before > 0.0)),
        capacity_capped=f(desired_raw > cfg.max_replicas))


def head_schedule(cfg) -> list[int]:
    """Seconds-of-minute of the control-period block heads: the H axis of
    every trace, matching the blocked episode's schedule
    (`sec % control_interval_sec == 0`)."""
    ci = max(min(int(cfg.control_interval_sec), 60), 1)
    n_full = 60 // ci
    heads = [k * ci for k in range(n_full)]
    if 60 - n_full * ci:
        heads.append(n_full * ci)
    return heads


def sample_lanes(W: int, k: int | None) -> np.ndarray | None:
    """Deterministic evenly spaced lane sample: the index set that bounds
    fleet-scale capture to k of W lanes. None/k >= W keeps all."""
    if k is None or k >= W:
        return None
    if k <= 0:
        raise ValueError(f"trace_lanes must be positive, got {k}")
    return np.unique(np.linspace(0, W - 1, k).round().astype(np.int64))


def stack_records(records: list[DecisionRecord]) -> DecisionRecord:
    """Host-side: a list of scalar DecisionRecords -> one DecisionRecord
    of [N] numpy arrays."""
    if not records:
        return DecisionRecord(*(np.zeros((0,), np.float32)
                                for _ in DecisionRecord._fields))
    return DecisionRecord(*(
        np.asarray([np.float32(getattr(r, f)) for r in records])
        for f in DecisionRecord._fields))


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def to_numpy(ct: ControlTrace) -> ControlTrace:
    return ControlTrace(
        decisions=DecisionRecord(*(_host(a) for a in ct.decisions)),
        minutes=MinuteTrace(*(_host(a) for a in ct.minutes)))


def lane(ct: ControlTrace, pre: tuple = (), post: tuple = ()
         ) -> ControlTrace:
    """Slice one lane out of a batched ControlTrace: `pre` indexes the
    axes BEFORE the time axes ([M, H] / [M]), `post` the lane axes after
    them. E.g. matrix traces [S, Z, M, H, F, P, K] -> lane(ct, (s, z),
    (f, p, k)); single-lane simulate traces need no indices at all."""
    dec = DecisionRecord(*(
        _host(a)[pre + (slice(None), slice(None)) + post]
        for a in ct.decisions))
    mnt = MinuteTrace(*(_host(a)[pre + (slice(None),) + post]
                        for a in ct.minutes))
    return ControlTrace(decisions=dec, minutes=mnt)
