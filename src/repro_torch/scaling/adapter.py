"""Drive a Python-loop `ServingEngine` with any `scaling.api` Controller
(port of ``repro.scaling.adapter``).

The engine is just another plant: the adapter builds an `Obs` from live
engine state (ready/starting replicas, active decode slots, queue depth,
a sliding-window arrival rate), runs the controller's functions eagerly
on one lane, applies the shared cooldown semantics
(`api.apply_decision`, the code the simulator runs), and calls
`engine.scale_to`.

Time mapping: serving demos compress time ("one logical minute" of trace
= `minute_s` engine-seconds). The adapter works in logical units
throughout; `sim_config_for_engine` derives a `SimConfig` whose capacity
and latency fields describe the engine in those units, so one policy +
one hyperparameter set behaves consistently across both backends.

The controller's state, the `Obs` and the rate history are tensors on
the adapter's device (the engine's, by default). Scalars are written
there with fill kernels, and the host reads the decision back once a
control step (`_control`), so a step on the card synchronises once.
"""
from __future__ import annotations

import torch

from repro_torch import _device
from repro_torch.obs import trace as obs_trace
from repro_torch.scaling.api import (Controller, Obs, apply_decision,
                                     limiter_init)
from repro_torch.sim.cluster import SimConfig

F32 = torch.float32


def sim_config_for_engine(engine, *, minute_s: float = 60.0,
                          service_s: float | None = None,
                          control_interval_sec: int = 15) -> SimConfig:
    """SimConfig describing `engine` in logical units (1 logical minute =
    `minute_s` engine-seconds). `service_s` is the per-request engine-time
    estimate (defaults to mean gen_len x step_time unavailable up front,
    so a 0.4 s serving default)."""
    service_engine = 0.4 if service_s is None else float(service_s)
    to_logical = 60.0 / minute_s              # engine-sec -> logical-sec
    return SimConfig(
        startup_sec=max(int(round(engine.startup_s * to_logical)), 1),
        control_interval_sec=control_interval_sec,
        rps_per_replica=engine.lanes / (service_engine * to_logical),
        service_sec=service_engine * to_logical,
        slo_sec=engine.slo_s * to_logical,
        max_replicas=float(engine.max_replicas),
        initial_replicas=float(engine.ready_replicas))


class EngineAutoscaler:
    """Feeds `engine.scale_to` from a Controller once per control
    interval; call `on_tick()` after every `engine.step()`. `device`
    (default: the engine's ``device``, else ``"cuda"``) holds the
    controller's tensors."""

    def __init__(self, engine, controller: Controller,
                 cfg: SimConfig | None = None, *,
                 minute_s: float = 60.0, device=None):
        self.engine = engine
        self.controller = controller
        self.cfg = cfg or sim_config_for_engine(engine, minute_s=minute_s)
        self.minute_s = float(minute_s)
        self._sec_per_logical = self.minute_s / 60.0
        self.device = _device.resolve(
            device if device is not None
            else getattr(engine, "device", "cuda"))

        self.ctrl_state = controller.init((), self.device)
        self.lim = limiter_init((), device=self.device)
        self.history = torch.zeros(self.cfg.history_len, dtype=F32,
                                   device=self.device)
        self.util_ema = 0.5
        self.minute_idx = 0
        self._arrivals_seen = 0
        self._ctrl_every = (self.cfg.control_interval_sec
                            * self._sec_per_logical)
        self._next_ctrl = 0.0
        self._last_ctrl_t = 0.0
        self.last_desired = float(engine.ready_replicas)
        self.last_cooldown_s = 0.0     # logical seconds, last decide()
        # one DecisionRecord per _control, same schema as the simulator's
        # trace (repro_torch.obs.trace), so engine runs are diffable
        # against simulation runs of the same policy
        self.decisions: list[obs_trace.DecisionRecord] = []

    @classmethod
    def from_policy(cls, engine, policy: str, *, classify=None,
                    forecaster=None, minute_s: float = 60.0,
                    cfg: SimConfig | None = None, device=None,
                    **overrides) -> "EngineAutoscaler":
        """Resolve `policy` (and optionally a ``repro_torch.forecast``
        registry `forecaster` name) through ``repro_torch.scaling.registry``
        against a SimConfig derived from the engine — the one-liner the
        serving demos use."""
        from repro_torch.scaling import registry
        cfg = cfg or sim_config_for_engine(engine, minute_s=minute_s)
        if forecaster is not None:
            overrides["forecaster"] = forecaster
        ctrl = registry.get_controller(policy, cfg, classify=classify,
                                       **overrides)
        return cls(engine, ctrl, cfg, minute_s=minute_s, device=device)

    def _scalar(self, v: float) -> torch.Tensor:
        return torch.full((), v, dtype=F32, device=self.device)

    # ------------------------------------------------------------ sensing
    def _observe(self) -> Obs:
        eng = self.engine
        total = eng.ready_replicas + len(eng.starting)
        lanes = eng.ready_replicas * eng.lanes
        # clamp: draining slots on just-removed replicas would otherwise
        # read as >100% — a value the simulator's util can never produce
        util_inst = min(len(eng.active) / max(lanes, 1), 1.0)
        # 1-logical-minute aggregation, updated per control step
        alpha = min(self.cfg.control_interval_sec
                    / self.cfg.metric_tau_sec, 1.0)
        self.util_ema += alpha * (util_inst - self.util_ema)
        rate_engine = eng.observed_rate(window_s=self.minute_s)
        rate_logical = rate_engine * self._sec_per_logical
        return Obs(ready_total=self._scalar(total),
                   ready=self._scalar(eng.ready_replicas),
                   util_ema=self._scalar(self.util_ema),
                   queue=self._scalar(len(eng.queue)),
                   rate_rps=self._scalar(rate_logical),
                   rate_history=self.history,
                   minute_idx=self.minute_idx)

    # ------------------------------------------------------------ control
    def on_tick(self) -> None:
        t = self.engine.t
        while t >= (self.minute_idx + 1) * self.minute_s:
            self._on_minute()
        if t >= self._next_ctrl:
            # anchored schedule: engine steps that overshoot the control
            # time don't stretch the interval (and so the cooldown clock)
            self._next_ctrl += self._ctrl_every
            if self._next_ctrl <= t:
                self._next_ctrl = t + self._ctrl_every
            self._control(t)

    def _on_minute(self) -> None:
        arrived = self.engine.arrivals_total - self._arrivals_seen
        self._arrivals_seen = self.engine.arrivals_total
        hist = torch.roll(self.history, -1)
        hist[-1] = float(arrived)
        self.history = hist
        self.minute_idx += 1
        self.ctrl_state = self.controller.on_minute(
            self.ctrl_state, self.history, self.minute_idx)

    def _control(self, now: float) -> None:
        eng = self.engine
        obs = self._observe()
        pre_state = self.ctrl_state
        self.ctrl_state, desired_raw, cool = self.controller.decide(
            pre_state, obs)
        desired_raw = torch.as_tensor(desired_raw, dtype=F32,
                                      device=self.device)
        cool = torch.as_tensor(cool, dtype=F32, device=self.device)
        desired = desired_raw.clamp(0.0, self.cfg.max_replicas)
        total = self._scalar(eng.ready_replicas + len(eng.starting))
        # cooldown decays by real elapsed time, in logical seconds
        dt_logical = (now - self._last_ctrl_t) / self._sec_per_logical
        self._last_ctrl_t = now
        cooldown_before = self.lim.cooldown
        self.lim, act = apply_decision(
            self.lim, total, desired, cool, True, dt=float(dt_logical))
        exp = (self.controller.explain(pre_state, obs)
               if getattr(self.controller, "explain", None) is not None
               else obs_trace.explain_nan((), self.device))
        self.decisions.append(obs_trace.record(
            self.cfg, minute_idx=self.minute_idx,
            sec=now / self._sec_per_logical - 60.0 * self.minute_idx,
            ready=obs.ready, total=total, queue=obs.queue,
            util_ema=obs.util_ema, rate_rps=obs.rate_rps, exp=exp,
            desired_raw=desired_raw, desired=desired, cooldown_req=cool,
            cooldown_before=cooldown_before, act=act))
        # the control step's one read back to the host
        add, remove, want, cool_s = torch.stack(
            [act.add, act.remove, desired, cool]).tolist()
        target = float(eng.ready_replicas + len(eng.starting)) + add - remove
        self.last_desired = want
        self.last_cooldown_s = cool_s
        eng.scale_to(int(round(target)))

    def decision_trace(self) -> obs_trace.DecisionRecord:
        """The decision log as one DecisionRecord of [N] numpy arrays."""
        if not self.decisions:
            return obs_trace.stack_records([])
        return obs_trace.DecisionRecord(*(
            torch.stack(f).cpu().numpy() for f in zip(*self.decisions)))


def run_autoscaled(engine, controller: Controller, *, submit_fn,
                   n_steps: int, cfg: SimConfig | None = None,
                   minute_s: float = 60.0, device=None
                   ) -> tuple[dict, "obs_trace.DecisionRecord"]:
    """Convenience loop: `submit_fn(step_idx, engine)` enqueues arrivals,
    then the engine steps and the autoscaler reacts. Returns
    `(engine.summary(), decision trace)` — the trace is the stacked
    [N]-array DecisionRecord log, so demos can print why they scaled."""
    auto = EngineAutoscaler(engine, controller, cfg, minute_s=minute_s,
                            device=device)
    for i in range(n_steps):
        submit_fn(i, engine)
        engine.step()
        auto.on_tick()
    return engine.summary(), auto.decision_trace()
