"""Serving engine: continuous-batching decode over replica lanes (port of
``repro.serve.engine``).

A *replica* is one model instance with `lanes` concurrent decode slots
(continuous batching). The engine keeps a FIFO of requests; each engine
step admits requests to free slots across all ready replicas, runs one
batched decode step, and retires finished sequences. The engine is a pure
plant: replica counts come from `engine.scale_to`, normally driven by a
``repro_torch.scaling`` Controller through
``repro_torch.scaling.adapter.EngineAutoscaler`` — the same policies (and
the same cooldown semantics) that run inside the cluster simulator.

Idle semantics match the simulator: `scale_to(0)` is honored (scale to
zero), and a request arriving with zero ready replicas counts as a cold
start and wakes the endpoint through the activator (one replica starts if
none is already starting).

Pod startup latency is modelled (a replica added at t serves from
t + startup). The decode step runs eagerly on `device` (``"cuda"`` by
default; it raises when CUDA is absent rather than running on the CPU).
The scheduler never reads the logits: a slot's next token is
``1 + tokens_done % 7``, so the schedule is the same on every device.

Under a world mesh (``dist.sharding``, one process a card) every rank
runs the whole host schedule (the queue, admissions, retirements and
billing), so `summary()` is the same on each. `params` is then this
rank's blocks (``dist.sharding.device_put`` under
``models.model.param_shardings``); the rank holds the cache of its block
of the slots (``dist.sharding.batch_rows``), decodes their tokens in the
sharded decode step, and `last_logits` holds their rows.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch import _device
from repro_torch.dist import sharding as shd
from repro_torch.models import model as M


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float            # seconds
    prompt_len: int
    gen_len: int
    start: float = -1.0
    finish: float = -1.0
    tokens_done: int = 0
    slot: int = -1


@dataclasses.dataclass
class EngineStats:
    served: int = 0
    slo_violations: int = 0
    cold_starts: int = 0
    latencies_ms: list = dataclasses.field(default_factory=list)
    replica_seconds: float = 0.0
    steps: int = 0


def _tree_device(tree):
    """The device of the first tensor in a params pytree."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    items = tree.values() if isinstance(tree, dict) else tree
    for v in items:
        dev = _tree_device(v)
        if dev is not None:
            return dev
    return None


class ServingEngine:
    """Discrete-time engine: step() advances one decode tick. `params`
    must lie on `device`."""

    def __init__(self, cfg, params, *, lanes_per_replica: int = 4,
                 max_replicas: int = 8, max_len: int = 64,
                 step_time_s: float = 0.05, startup_s: float = 2.0,
                 slo_s: float = 1.0, activator: bool = True,
                 device="cuda"):
        self.device = _device.resolve(device)
        where = _tree_device(params)
        if where is not None and where.type != self.device.type:
            raise ValueError(f"params lie on {where}, the engine runs on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.lanes = lanes_per_replica
        self.max_replicas = max_replicas
        self.max_len = max_len
        self.step_time = step_time_s
        self.startup_s = startup_s
        self.slo_s = slo_s
        self.activator = activator

        self.t = 0.0
        self.ready_replicas = 1
        self.starting: list[float] = []     # ready-at times
        self.queue: deque[Request] = deque()
        self.arrivals_total = 0             # monotonic arrival counter
        self._arrival_times: deque[float] = deque()  # for observed_rate
        self.shardings = None
        if shd.model_rules() is not None:
            self.shardings = M.param_shardings(cfg)
            shd.check_placed(params, self.shardings,
                             M.init(0, cfg, device="meta"))
        # this rank's slots under a world mesh, else every slot
        self.rows = shd.batch_rows(max_replicas * lanes_per_replica)
        self.cache = M.init_cache(cfg, self.rows.stop - self.rows.start,
                                  max_len, device=self.device)
        self.active: dict[int, Request] = {}   # slot -> request
        self.stats = EngineStats()
        self.decode_steps = 0                  # batched decode steps run
        self.last_logits = None

    def _decode(self, toks: np.ndarray, pos: int) -> torch.Tensor:
        """One eager decode step of every slot (this rank's under a world
        mesh); `toks` [slots, 1] goes to the card through pinned memory
        without waiting on it."""
        t = torch.from_numpy(np.ascontiguousarray(toks[self.rows]))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        logits, self.cache = M.decode_step(self.params, self.cache,
                                           t, pos, self.cfg,
                                           shardings=self.shardings)
        self.decode_steps += 1
        return logits

    # ------------------------------------------------------------- control
    def scale_to(self, desired: int) -> None:
        """Honors 0 (scale-to-zero): starting pods cancel first, then
        ready pods drain — matching the simulator's idle semantics."""
        desired = int(np.clip(desired, 0, self.max_replicas))
        total = self.ready_replicas + len(self.starting)
        if desired > total:
            for _ in range(desired - total):
                self.starting.append(self.t + self.startup_s)
        elif desired < total:
            drop = total - desired
            while drop and self.starting:
                self.starting.pop()
                drop -= 1
            self.ready_replicas = max(self.ready_replicas - drop, 0)

    # --------------------------------------------------------------- step
    def submit(self, req: Request) -> None:
        # every arrival with zero ready pods experiences a cold start
        # (same accounting as the simulator); the activator wakes the
        # endpoint if nothing is already starting.
        if self.ready_replicas == 0:
            self.stats.cold_starts += 1
            if self.activator and not self.starting:
                self.starting.append(self.t + self.startup_s)
        self.arrivals_total += 1
        # record the submission time, not the caller-supplied arrival
        # field: observed_rate's windowing needs monotonic timestamps
        self._arrival_times.append(self.t)
        self.queue.append(req)

    def step(self) -> None:
        # pods finishing startup
        still = []
        for ready_at in self.starting:
            if ready_at <= self.t:
                self.ready_replicas += 1
            else:
                still.append(ready_at)
        self.starting = still

        n_slots = self.ready_replicas * self.lanes
        # admit queued requests to free slots
        free = [s for s in range(n_slots) if s not in self.active]
        while self.queue and free:
            req = self.queue.popleft()
            req.slot = free.pop(0)
            req.start = self.t
            self.active[req.slot] = req

        if self.active:
            # one decode step for every active slot (continuous batching)
            total_slots = self.max_replicas * self.lanes
            toks = np.zeros((total_slots, 1), np.int64)
            for s, req in self.active.items():
                toks[s, 0] = 1 + (req.tokens_done % 7)
            # one shared position for all slots, as in the reference
            pos = int(min(self.t / self.step_time,
                          self.max_len - 1)) % self.max_len
            self.last_logits = self._decode(toks, pos)
            done = []
            for s, req in self.active.items():
                req.tokens_done += 1
                if req.tokens_done >= req.gen_len:
                    req.finish = self.t + self.step_time
                    lat = req.finish - req.arrival
                    self.stats.latencies_ms.append(lat * 1e3)
                    self.stats.served += 1
                    if lat > self.slo_s:
                        self.stats.slo_violations += 1
                    done.append(s)
            for s in done:
                del self.active[s]

        # bill ready + starting pods, plus draining capacity: replicas
        # removed by scale_to keep finishing their in-flight requests
        # (graceful drain) and that time is still paid for
        draining = max(-(-len(self.active) // self.lanes)
                       - self.ready_replicas, 0)
        self.stats.replica_seconds += (self.ready_replicas + draining
                                       + len(self.starting)) \
            * self.step_time
        self.stats.steps += 1
        self.t += self.step_time

    # ------------------------------------------------------------ metrics
    RATE_RETENTION_S = 600.0   # longest window observed_rate supports

    def observed_rate(self, window_s: float = 60.0) -> float:
        """True sliding-window arrival rate (req/s over the trailing
        `window_s`, or over the elapsed time when younger than that).
        Non-destructive for any window up to RATE_RETENTION_S, so mixed
        window sizes may be queried in any order; larger windows clamp
        to the retention horizon."""
        window_s = min(window_s, self.RATE_RETENTION_S)
        keep_cutoff = self.t - self.RATE_RETENTION_S
        while self._arrival_times and self._arrival_times[0] < keep_cutoff:
            self._arrival_times.popleft()
        cutoff = self.t - window_s
        count = 0
        for a in reversed(self._arrival_times):
            if a < cutoff:
                break
            count += 1
        horizon = min(window_s, max(self.t, self.step_time))
        return count / horizon

    def summary(self) -> dict:
        lat = np.asarray(self.stats.latencies_ms)
        return {
            "served": self.stats.served,
            "slo_violation_rate": (self.stats.slo_violations
                                   / max(self.stats.served, 1)),
            "cold_starts": self.stats.cold_starts,
            "p50_ms": float(np.percentile(lat, 50)) if len(lat) else 0.0,
            "p95_ms": float(np.percentile(lat, 95)) if len(lat) else 0.0,
            "replica_seconds": self.stats.replica_seconds,
            "queue_len": len(self.queue),
        }
