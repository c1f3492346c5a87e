"""Discrete-time Kubernetes cluster simulator (port of
``repro.sim.cluster``).

Same dynamics as the reference: 30-second pod startup pipeline, CPU
scaling on a 1-minute utilization EMA, a fluid FIFO queue with queue-age
tracking, an M/D/1-style response time capped at `resp_cap_sec`, a 500 ms
SLO, and cold starts counted while no pod is ready.

Every function works on lanes: state tensors carry any leading lane
shape (``()`` is one workload, ``[W]`` a fleet), so the reference's
``vmap`` is the lane dimension written out. A minute is ceil(60/ci)
control-period blocks: `decide` at the block head, then decision-free
plant ticks (`advance_plant`), all folded strictly left to right into the
minute accumulator, as in the reference's blocked scan.

Float semantics follow the reference op for op: the same div-fed adds,
the select-routed `_resp_weight` product, and the same fold order. A
division by a configuration constant (`/ 60`, `/ metric_tau_sec`) is a
multiply by the constant's f32 reciprocal, which is what XLA compiles the
reference's constant divisors to; every other division is an IEEE
quotient of two tensors. Nothing here fuses a product into an add, so
the plain path and the CUDA kernels agree bit for bit on the card.

Paths on the card (``device="cuda"``, the default): `simulate` runs
whole episodes through the fused ``episode_block`` kernel; with
``decide_kernel=False`` the blocked loop below runs and its plant ticks
go through the ``plant_block`` kernel. With ``device="cpu"`` both run
their plain PyTorch versions (``repro_torch.kernels.ref``).

Telemetry (``telemetry=True``) rides the blocked loop only: each block
head also yields a ``obs.trace.DecisionRecord`` of the decision, built
from values the step computes anyway and fed back into nothing, so the
traced `MinuteOut` equals the untraced one bit for bit. The fused kernel
keeps its decisions on the card, so asking it for a trace raises, as in
the reference; run with ``decide_kernel=False``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import _device
from repro_torch._numerics import recip
from repro_torch.obs import trace as obs_trace
from repro_torch.scaling.api import (Controller, LimiterState, Obs,
                                     ScaleAction, apply_decision,
                                     limiter_init)

__all__ = ["Controller", "Obs", "SimConfig", "SimState", "MinuteOut",
           "advance_plant", "initial_state", "minute_step",
           "minute_step_reference", "plant_block_ref", "run_traced",
           "simulate", "simulate_reference", "make_simulator"]

EPSF = 1e-9
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class SimConfig:
    startup_sec: int = 30          # pod startup time (paper §IV.B)
    control_interval_sec: int = 15 # controller sync period (K8s default)
    rps_per_replica: float = 20.0  # 1000 mCPU/replica, ~100 ms/request
    service_sec: float = 0.1       # per-request service time
    slo_sec: float = 0.5           # SLO threshold (paper: 500 ms)
    max_replicas: float = 100.0
    initial_replicas: float = 2.0
    metric_tau_sec: float = 60.0   # 1-minute metric aggregation
    history_len: int = 60          # minutes of rate history kept for ctrl
    resp_cap_sec: float = 600.0    # cap reported response times (metrics)


class SimState(NamedTuple):
    ready: torch.Tensor         # f32 ready replicas
    pipeline: torch.Tensor      # [..., startup_sec] replicas starting
    pipe_sum: torch.Tensor      # running total of `pipeline`, clamped >= 0
    queue: torch.Tensor         # queued requests
    wait_sum: torch.Tensor      # request-seconds waited by the queue
    util_ema: torch.Tensor
    lim: LimiterState           # scale-down cooldown / direction tracking
    rate_history: torch.Tensor  # [..., history_len] per-minute arrivals
    ctrl_state: Any


class MinuteOut(NamedTuple):
    served: torch.Tensor
    violated: torch.Tensor
    cold_starts: torch.Tensor
    replica_seconds: torch.Tensor
    queue_end: torch.Tensor
    resp_sum: torch.Tensor      # served-weighted response-time sum
    resp_max: torch.Tensor
    ups: torch.Tensor
    downs: torch.Tensor
    oscillations: torch.Tensor
    util_mean: torch.Tensor
    ready_mean: torch.Tensor


def _ci_blocks(cfg: SimConfig) -> tuple[int, int, int]:
    """(ci, full blocks per minute, remainder-block ticks)."""
    ci = max(min(int(cfg.control_interval_sec), 60), 1)
    n_full = 60 // ci
    return ci, n_full, 60 - n_full * ci


def _flow_tick(cfg: SimConfig, ready, queue, wait_sum, util_ema, arrivals):
    """Queue/response/EMA dynamics of one 1-second tick, after the
    startup-pipeline pop (``cluster._flow_tick`` op for op)."""
    dev = ready.device
    throughput = ready * cfg.rps_per_replica
    work = queue + arrivals
    served = torch.minimum(work, throughput)
    new_queue = work - served
    # the standing queue ages 1 s; fresh arrivals have ~0 accumulated wait
    wait_aged = wait_sum + queue
    work_c = work.clamp_min(EPSF)
    mean_age = wait_aged / work_c
    wait_sum = wait_aged * new_queue / work_c
    thr_c = throughput.clamp_min(EPSF)
    util = served / thr_c
    # every resp term is a quotient (div-fed adds), as in the reference
    resp = (_device.const(cfg.service_sec, dev) / (1.0 - util).clamp_min(0.05)
            + mean_age + (0.5 * new_queue) / thr_c)
    resp = resp.clamp_max(cfg.resp_cap_sec)
    zero = torch.zeros_like(resp)
    resp = torch.where(served > 0, resp, zero)
    violated = torch.where(resp > cfg.slo_sec, served, zero)
    cold = torch.where(ready < 0.5, arrivals, zero)
    util_ema = util_ema + (util - util_ema) * recip(cfg.metric_tau_sec)
    return new_queue, wait_sum, util_ema, served, violated, cold, resp, util


def _pop_pipeline(ready, pipeline, pipe_sum):
    """Pods finishing startup: pop slot 0, shift, keep the incremental
    pipeline total non-negative."""
    popped = pipeline[..., 0]
    ready = ready + popped
    pipeline = torch.cat([pipeline[..., 1:],
                          torch.zeros_like(pipeline[..., :1])], -1)
    pipe_sum = (pipe_sum - popped).clamp_min(0.0)
    return ready, pipeline, pipe_sum


def _apply_scaling(ready, pipeline, pipe_sum, act):
    """Starts enter the pipeline tail; removals cancel starting pods first
    (proportional rescale), then ready pods."""
    pipeline = torch.cat([pipeline[..., :-1],
                          (pipeline[..., -1] + act.add)[..., None]], -1)
    pipe_sum = pipe_sum + act.add
    n_start = pipe_sum
    from_pipe = torch.minimum(act.remove, n_start)
    factor = 1.0 - from_pipe / n_start.clamp_min(EPSF)
    pipeline = pipeline * factor[..., None]
    pipe_sum = pipe_sum * factor
    ready = (ready - (act.remove - from_pipe)).clamp_min(0.0)
    return ready, pipeline, pipe_sum


def _tree_where(mask, new, old):
    if isinstance(new, torch.Tensor):
        m = mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim()))
        return torch.where(m, new, old)
    return type(new)(*(_tree_where(mask, n, o) for n, o in zip(new, old)))


def _tree_index(tree, idx):
    """Every tensor leaf of a (nested) NamedTuple indexed by `idx` along
    its first (lane) axis."""
    if isinstance(tree, torch.Tensor):
        return tree[idx]
    return type(tree)(*(_tree_index(t, idx) for t in tree))


def _ctrl_tick(cfg: SimConfig, controller: Controller, state: SimState,
               arrivals, minute_idx, do_ctrl=True, telemetry: bool = False,
               head_sec: float = 0.0, trace_idx=None):
    """One 1-second step with a controller decision. `do_ctrl` is True on
    block heads (the blocked path) or a bool mask (the reference path,
    which evaluates `decide` on every tick and discards off-interval
    results). `telemetry` also returns the DecisionRecord of this
    decision (of the lanes `trace_idx` picks along the first lane axis,
    all when None); it only reads the step's values."""
    ready, pipeline, pipe_sum = _pop_pipeline(
        state.ready, state.pipeline, state.pipe_sum)
    (queue, wait_sum, util_ema, served, violated, cold, resp,
     util) = _flow_tick(cfg, ready, state.queue, state.wait_sum,
                        state.util_ema, arrivals)
    total = ready + pipe_sum
    obs = Obs(ready_total=total, ready=ready, util_ema=util_ema,
              queue=queue, rate_rps=arrivals,
              rate_history=state.rate_history, minute_idx=minute_idx)
    ctrl_state, desired, cool_req = controller.decide(state.ctrl_state, obs)
    if do_ctrl is not True:
        ctrl_state = _tree_where(do_ctrl, ctrl_state, state.ctrl_state)
    desired_raw = desired
    desired = desired.clamp(0.0, cfg.max_replicas)
    lim, act = apply_decision(state.lim, total, desired, cool_req,
                              do_ctrl, dt=1.0)
    ready_at_decision = ready
    ready, pipeline, pipe_sum = _apply_scaling(ready, pipeline, pipe_sum,
                                               act)
    new_state = SimState(ready=ready, pipeline=pipeline, pipe_sum=pipe_sum,
                         queue=queue, wait_sum=wait_sum, util_ema=util_ema,
                         lim=lim, rate_history=state.rate_history,
                         ctrl_state=ctrl_state)
    out = (served, violated, cold, ready + pipe_sum, resp, util,
           act.scale_up.to(F32), act.scale_down.to(F32), act.oscillation,
           ready)
    if not telemetry:
        return new_state, out
    # the decision site's lane values, stacked and picked once (the
    # trace's cost is the traced lanes', not the fleet's)
    site = torch.stack([x if x.shape == desired.shape
                        else torch.broadcast_to(x, desired.shape) for x in (
        ready_at_decision, total, queue, util_ema, arrivals, desired_raw,
        desired, cool_req, state.lim.cooldown, act.add, act.remove,
        act.scale_up.to(F32), act.scale_down.to(F32))])
    ctrl_before, hist = state.ctrl_state, state.rate_history
    if trace_idx is not None:
        site = site[:, trace_idx]
        ctrl_before = _tree_index(ctrl_before, trace_idx)
        hist = hist[trace_idx]
    (r, tot, q, u, a, d_raw, d, c_req, c_before, add, remove, up,
     down) = site.unbind(0)
    exp = (controller.explain(ctrl_before, Obs(
        ready_total=tot, ready=r, util_ema=u, queue=q, rate_rps=a,
        rate_history=hist, minute_idx=minute_idx))
        if controller.explain is not None
        else obs_trace.explain_nan(d.shape, d.device))
    rec = obs_trace.record(
        cfg, minute_idx=minute_idx, sec=head_sec, ready=r, total=tot,
        queue=q, util_ema=u, rate_rps=a, exp=exp, desired_raw=d_raw,
        desired=d, cooldown_req=c_req, cooldown_before=c_before,
        act=ScaleAction(add=add, remove=remove, scale_up=up,
                        scale_down=down, oscillation=None))
    return new_state, out, rec


# ------------------------------------------------- minute accumulation ----
def _resp_weight(resp, served):
    """`resp * served` behind a select (the reference's contraction guard);
    bit-identical to the bare product since resp is 0 where served is."""
    return torch.where(served > 0, resp * served, torch.zeros_like(resp))


def _acc_init(like: torch.Tensor):
    z = torch.zeros_like(like)
    return (z,) * 11


def _acc_fold(acc, out):
    """Fold a control tick's 10-tuple (ups/downs/osc included)."""
    (served, violated, cold, total, resp, util, ups, downs, osc,
     ready) = out
    return (acc[0] + served, acc[1] + violated, acc[2] + cold,
            acc[3] + total, acc[4] + _resp_weight(resp, served),
            torch.maximum(acc[5], resp), acc[6] + ups, acc[7] + downs,
            acc[8] + osc, acc[9] + util, acc[10] + ready)


def _acc_fold_plant(acc, served, violated, cold, total, resp, util, ready):
    """Fold a plant-only tick (ups/downs/oscillations are exactly 0)."""
    return (acc[0] + served, acc[1] + violated, acc[2] + cold,
            acc[3] + total, acc[4] + _resp_weight(resp, served),
            torch.maximum(acc[5], resp), acc[6], acc[7], acc[8],
            acc[9] + util, acc[10] + ready)


def _minute_out(acc, state: SimState) -> MinuteOut:
    r60 = recip(60.0)
    return MinuteOut(
        served=acc[0], violated=acc[1], cold_starts=acc[2],
        replica_seconds=acc[3], queue_end=state.queue, resp_sum=acc[4],
        resp_max=acc[5], ups=acc[6], downs=acc[7], oscillations=acc[8],
        util_mean=acc[9] * r60, ready_mean=acc[10] * r60)


# --------------------------------------------------- plant-block advance ----
def plant_block_ref(cfg: SimConfig, ready, pipeline, queue, wait_sum,
                    util_ema, cooldown, pipe_sum, arrivals, *,
                    n_ticks: int):
    """Advance plant lanes `n_ticks` seconds with no control decisions:
    the plain version of the ``plant_block`` kernel. State args are [B]
    (pipeline [B, S]); `arrivals` is the per-lane per-second rate.

    Returns ``(state, ticks)``: `state` = (ready, pipeline, queue,
    wait_sum, util_ema, cooldown, pipe_sum) after the block, `ticks` =
    (served, violated, cold, total_replicas, resp, util, ready), each
    [B, n_ticks]."""
    r, p, q, w, u, c, ps, a = (torch.as_tensor(x).to(F32) for x in (
        ready, pipeline, queue, wait_sum, util_ema, cooldown, pipe_sum,
        arrivals))
    ticks = []
    for _ in range(n_ticks):
        r, p, ps = _pop_pipeline(r, p, ps)
        q, w, u, served, violated, cold, resp, util = _flow_tick(
            cfg, r, q, w, u, a)
        c = (c - 1.0).clamp_min(0.0)
        ticks.append((served, violated, cold, r + ps, resp, util, r))
    state = (r, p, q, w, u, c, ps)
    return state, tuple(torch.stack(t, -1) for t in zip(*ticks))


def advance_plant(cfg: SimConfig, ready, pipeline, pipe_sum, queue,
                  wait_sum, util_ema, cooldown, acc, arrivals,
                  n_ticks: int):
    """`n_ticks` decision-free plant ticks with the minute accumulator
    folded along. Pops read ``pipeline[..., k]`` by index and the shifted
    pipeline is built once at block end (the same floats as per-tick
    shifting); the per-tick cooldown decays collapse to one exact step,
    as in the reference. Returns (updated 7-field tuple, acc)."""
    S = pipeline.shape[-1]
    for k in range(n_ticks):
        if k < S:                      # drained after S pops: pops are 0.0
            popped = pipeline[..., k]
            ready = ready + popped
            pipe_sum = (pipe_sum - popped).clamp_min(0.0)
        (queue, wait_sum, util_ema, served, violated, cold, resp,
         util) = _flow_tick(cfg, ready, queue, wait_sum, util_ema, arrivals)
        acc = _acc_fold_plant(acc, served, violated, cold,
                              ready + pipe_sum, resp, util, ready)
    if n_ticks < S:
        pipeline = torch.cat([pipeline[..., n_ticks:],
                              torch.zeros_like(pipeline[..., :n_ticks])], -1)
    else:
        pipeline = torch.zeros_like(pipeline)
    cooldown = (cooldown - float(n_ticks)).clamp_min(0.0)
    return (ready, pipeline, pipe_sum, queue, wait_sum, util_ema,
            cooldown), acc


def _plant_block(cfg: SimConfig, state: SimState, acc, arrivals,
                 n_ticks: int, use_kernel: bool):
    """`n_ticks` plant-only ticks folded into the minute accumulator:
    `advance_plant`, or one ``plant_block`` kernel launch whose per-tick
    outputs are summed into the accumulator (the reference's kernel
    path)."""
    if not use_kernel:
        (ready, pipeline, pipe_sum, queue, wait_sum, util_ema,
         cool), acc = advance_plant(
            cfg, state.ready, state.pipeline, state.pipe_sum, state.queue,
            state.wait_sum, state.util_ema, state.lim.cooldown, acc,
            arrivals, n_ticks)
        return state._replace(
            ready=ready, pipeline=pipeline, pipe_sum=pipe_sum, queue=queue,
            wait_sum=wait_sum, util_ema=util_ema,
            lim=LimiterState(cooldown=cool,
                             last_dir=state.lim.last_dir)), acc

    from repro_torch.kernels import ops
    lanes = state.ready.shape
    # [B] lanes (a fleet) pass as they are: each view is one more eager
    # dispatch a control period
    flat, shaped = ((lambda x: x, lambda x, shape: x) if len(lanes) == 1
                    else (lambda x: x.reshape(-1),
                          lambda x, shape: x.reshape(shape)))
    (r, p, q, w, u, c, ps), ticks = ops.plant_tick_block(
        flat(state.ready), shaped(state.pipeline, (-1, cfg.startup_sec)),
        flat(state.queue), flat(state.wait_sum), flat(state.util_ema),
        flat(state.lim.cooldown), flat(state.pipe_sum),
        flat(arrivals),
        n_ticks=n_ticks, rps_per_replica=cfg.rps_per_replica,
        service_sec=cfg.service_sec, slo_sec=cfg.slo_sec,
        resp_cap_sec=cfg.resp_cap_sec, metric_tau_sec=cfg.metric_tau_sec)
    state = state._replace(
        ready=shaped(r, lanes), pipeline=shaped(p, state.pipeline.shape),
        queue=shaped(q, lanes), wait_sum=shaped(w, lanes),
        util_ema=shaped(u, lanes), pipe_sum=shaped(ps, lanes),
        lim=LimiterState(cooldown=shaped(c, lanes),
                         last_dir=state.lim.last_dir))
    served, violated, cold, total, resp, util, ready = (
        shaped(t, lanes + (n_ticks,)) for t in ticks)
    acc = (acc[0] + served.sum(-1), acc[1] + violated.sum(-1),
           acc[2] + cold.sum(-1), acc[3] + total.sum(-1),
           acc[4] + (resp * served).sum(-1),
           torch.maximum(acc[5], resp.amax(-1)), acc[6], acc[7], acc[8],
           acc[9] + util.sum(-1), acc[10] + ready.sum(-1))
    return state, acc


def _block(cfg, controller, state, acc, arrivals, minute_idx, n_ticks,
           use_kernel, telemetry: bool = False, head_sec: float = 0.0,
           trace_idx=None):
    """One control period: decide at the head tick, then `n_ticks - 1`
    plant-only ticks, all folded into the minute accumulator. With
    `telemetry` also returns the head's DecisionRecord."""
    state, head, *rec = _ctrl_tick(cfg, controller, state, arrivals,
                                   minute_idx, telemetry=telemetry,
                                   head_sec=head_sec, trace_idx=trace_idx)
    acc = _acc_fold(acc, head)
    if n_ticks > 1:
        state, acc = _plant_block(cfg, state, acc, arrivals, n_ticks - 1,
                                  use_kernel)
    return (state, acc, *rec)


def _minute_blocked(cfg: SimConfig, controller: Controller, carry,
                    rate_this_min: torch.Tensor, use_kernel: bool = False,
                    telemetry: bool = False, trace_idx=None):
    """One minute = ceil(60/ci) control-period blocks (the last one runs
    the `60 % ci` remainder ticks) + the minute-boundary hook. With
    `telemetry` the per-minute output is ``(MinuteOut, records)``, the
    minute's H head DecisionRecords in head order
    (``obs.trace.head_schedule``)."""
    state, minute_idx = carry
    arrivals = rate_this_min * recip(60.0)
    ci, n_full, tail = _ci_blocks(cfg)
    acc = _acc_init(state.ready)
    recs = []
    for k, n_ticks in enumerate([ci] * n_full + ([tail] if tail else [])):
        state, acc, *rec = _block(cfg, controller, state, acc, arrivals,
                                  minute_idx, n_ticks, use_kernel,
                                  telemetry, float(k * ci), trace_idx)
        recs += rec
    carry, m = _finish_minute(cfg, controller, state, minute_idx,
                              rate_this_min, acc)
    return (carry, (m, recs)) if telemetry else (carry, m)


def _finish_minute(cfg, controller, state, minute_idx, rate_this_min, acc):
    """MinuteOut + history push + minute hook (shared by both paths)."""
    m = _minute_out(acc, state)
    hist = torch.cat([state.rate_history[..., 1:],
                      rate_this_min[..., None]], -1)
    ctrl_state = controller.on_minute(state.ctrl_state, hist,
                                      minute_idx + 1)
    state = state._replace(rate_history=hist, ctrl_state=ctrl_state)
    return (state, minute_idx + 1), m


def _minute_reference(cfg: SimConfig, controller: Controller, carry,
                      rate_this_min: torch.Tensor):
    """One minute = 60 ticks, `decide` evaluated on every tick and masked
    off-interval (the seed semantics the blocked path reproduces)."""
    state, minute_idx = carry
    arrivals = rate_this_min * recip(60.0)
    acc = _acc_init(state.ready)
    for sec in range(60):
        do_ctrl = torch.full_like(state.ready, float(
            sec % cfg.control_interval_sec == 0)).bool()
        state, out = _ctrl_tick(cfg, controller, state, arrivals,
                                minute_idx, do_ctrl)
        acc = _acc_fold(acc, out)
    return _finish_minute(cfg, controller, state, minute_idx,
                          rate_this_min, acc)


minute_step = _minute_blocked
minute_step_reference = _minute_reference


def initial_state(controller: Controller, cfg: SimConfig = SimConfig(), *,
                  lanes: tuple[int, ...] = (),
                  device="cuda") -> SimState:
    """The t=0 plant state of `lanes` workloads."""
    dev = _device.resolve(device)
    full = lambda v: torch.full(lanes, v, dtype=F32, device=dev)  # noqa: E731
    return SimState(
        ready=full(float(cfg.initial_replicas)),
        pipeline=torch.zeros(lanes + (cfg.startup_sec,), dtype=F32,
                             device=dev),
        pipe_sum=full(0.0), queue=full(0.0), wait_sum=full(0.0),
        util_ema=full(0.5),
        lim=limiter_init(lanes, device=dev),
        rate_history=torch.zeros(lanes + (cfg.history_len,), dtype=F32,
                                 device=dev),
        ctrl_state=controller.init(lanes, dev))


def _stack_minutes(outs) -> MinuteOut:
    return MinuteOut(*(torch.stack(f, -1) for f in zip(*outs)))


def _run_minutes(step, rates, controller, cfg, dev):
    carry = (initial_state(controller, cfg, lanes=rates.shape[:-1],
                           device=dev), 0)
    outs = []
    for m in range(rates.shape[-1]):
        carry, out = step(carry, rates[..., m])
        outs.append(out)
    return _stack_minutes(outs)


def _use_decide_kernel(dev: torch.device, explicit: bool | None) -> bool:
    """The fused episode kernel on the card, the blocked loop (its plain
    version) elsewhere, unless the caller says otherwise."""
    return dev.type == "cuda" if explicit is None else explicit


def _reject_decide_kernel_telemetry():
    raise ValueError(
        "telemetry does not compose with decide_kernel: the fused "
        "episode kernel keeps decisions on the card and never "
        "materializes DecisionRecords; run with decide_kernel=False, or "
        "capture sampled lanes via repro_torch.evals.fleet "
        "(FleetSpec.trace_lanes)")


def run_traced(rates: torch.Tensor, controller: Controller,
               cfg: SimConfig, use_kernel: bool, trace_idx=None):
    """The blocked episode with its decision trace: rates [..., M] ->
    (MinuteOut of [..., M], ControlTrace time-major: decisions [M, H,
    *lanes], minutes [M, *lanes]), where the traced lanes are those
    `trace_idx` (a LongTensor) picks along the first lane axis, all when
    None. The runners of ``scaling.batch``, ``evals.matrix`` and
    ``evals.fleet`` stack these per controller."""
    carry = (initial_state(controller, cfg, lanes=rates.shape[:-1],
                           device=rates.device), 0)
    outs, recs = [], []
    M = rates.shape[-1]
    for m in range(M):
        carry, (out, rec) = _minute_blocked(
            cfg, controller, carry, rates[..., m], use_kernel=use_kernel,
            telemetry=True, trace_idx=trace_idx)
        outs.append(out)
        recs += rec
    mo = _stack_minutes(outs)
    H = len(obs_trace.head_schedule(cfg))
    dec = obs_trace.DecisionRecord(*(
        torch.stack(f).reshape((M, H) + f[0].shape) for f in zip(*recs)))
    pick = (lambda a: a) if trace_idx is None else (lambda a: a[trace_idx])
    minutes = obs_trace.MinuteTrace(*(
        pick(a).movedim(-1, 0) for a in (rates, mo.served, mo.violated,
                                         mo.queue_end, mo.ready_mean)))
    return mo, obs_trace.ControlTrace(decisions=dec, minutes=minutes)


def simulate(rates_per_min, controller: Controller,
             cfg: SimConfig = SimConfig(), *, device="cuda",
             plant_kernel: bool | None = None,
             decide_kernel: bool | None = None, telemetry: bool = False):
    """Simulate workloads: rates [..., M] -> MinuteOut of [..., M].

    `decide_kernel` (default: on for CUDA) runs whole episodes through
    ``kernels.ops.episode_block``; otherwise the control-period-blocked
    loop runs here, its plant ticks through ``kernels.ops.plant_tick_block``
    when `plant_kernel` (default: on for CUDA).

    `telemetry=True` returns ``(MinuteOut, ControlTrace)`` with decisions
    leaves [..., M, H] (H block heads a minute) and minutes leaves
    [..., M]; the MinuteOut is the untraced run's bit for bit. It needs
    the blocked loop: with the fused kernel (the card's default) it
    raises ValueError."""
    dev = _device.resolve(device)
    rates = torch.as_tensor(rates_per_min).to(device=dev, dtype=F32)
    on_card = dev.type == "cuda"
    if _use_decide_kernel(dev, decide_kernel):
        if telemetry:
            _reject_decide_kernel_telemetry()
        from repro_torch.kernels import ops
        lanes = rates.reshape(-1, rates.shape[-1]).contiguous()
        out = ops.episode_block(lanes, controller, cfg)
        return MinuteOut(*(o.reshape(rates.shape) for o in out))
    use_kernel = on_card if plant_kernel is None else plant_kernel
    if telemetry:
        out, ct = run_traced(rates, controller, cfg, use_kernel)
        return out, obs_trace.ControlTrace(
            decisions=obs_trace.DecisionRecord(*(
                a.movedim((0, 1), (-2, -1)) for a in ct.decisions)),
            minutes=obs_trace.MinuteTrace(*(
                a.movedim(0, -1) for a in ct.minutes)))

    def step(carry, rate):
        return _minute_blocked(cfg, controller, carry, rate,
                               use_kernel=use_kernel)
    return _run_minutes(step, rates, controller, cfg, dev)


def simulate_reference(rates_per_min, controller: Controller,
                       cfg: SimConfig = SimConfig(), *,
                       device="cuda") -> MinuteOut:
    """The decide-every-tick-and-mask semantics (slow; the parity oracle
    for `simulate`)."""
    dev = _device.resolve(device)
    rates = torch.as_tensor(rates_per_min).to(device=dev, dtype=F32)

    def step(carry, rate):
        return _minute_reference(cfg, controller, carry, rate)
    return _run_minutes(step, rates, controller, cfg, dev)


def make_simulator(controller: Controller, cfg: SimConfig = SimConfig(), *,
                   device="cuda", plant_kernel: bool | None = None,
                   decide_kernel: bool | None = None,
                   w_chunk: int | None = None, telemetry: bool = False):
    """rates [W, M] -> MinuteOut of [W, M] arrays.

    `w_chunk` runs the workload axis in independent chunks of that many
    lanes (one episode-kernel launch each on the card), so scratch state
    is [w_chunk] however large W grows; it must divide W. `telemetry`
    returns ``(MinuteOut [W, M], ControlTrace)`` with decisions leaves
    [W, M, H] and minutes leaves [W, M]; it needs the blocked loop
    (``decide_kernel=False`` on the card, else ValueError)."""
    dev = _device.resolve(device)
    if telemetry and _use_decide_kernel(dev, decide_kernel):
        _reject_decide_kernel_telemetry()

    def run(rates):
        rates = torch.as_tensor(rates).to(device=dev, dtype=F32)
        W = rates.shape[0]
        sim = lambda r: simulate(r, controller, cfg, device=dev,  # noqa: E731
                                 plant_kernel=plant_kernel,
                                 decide_kernel=decide_kernel,
                                 telemetry=telemetry)
        if w_chunk is None or w_chunk >= W:
            return sim(rates)
        if W % w_chunk:
            raise ValueError(f"w_chunk {w_chunk} must divide W {W}")
        outs = [sim(rates[i:i + w_chunk]) for i in range(0, W, w_chunk)]
        if not telemetry:
            return MinuteOut(*(torch.cat(f, 0) for f in zip(*outs)))
        cat = lambda parts: type(parts[0])(*(  # noqa: E731
            torch.cat(f, 0) for f in zip(*parts)))
        return (cat([o for o, _ in outs]), obs_trace.ControlTrace(
            decisions=cat([c.decisions for _, c in outs]),
            minutes=cat([c.minutes for _, c in outs])))

    return run
