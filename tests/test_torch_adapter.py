"""The port's engine adapter (``repro_torch.scaling.adapter``) against the
JAX reference's (``repro.scaling.adapter``) on the CPU.

The same duck-typed `FakeEngine` scripts as the reference's tests
(``tests/test_scaling.py``, ``tests/test_obs.py``) drive both adapters,
each with its own package's controller. Held:

* `sim_config_for_engine` gives the same SimConfig fields;
* the engine sees the same `scale_to` calls (decisions, cooldown timing
  in logical time, scale to zero);
* `decision_trace` against the reference's: discrete fields exact, NaN
  where NaN, forecast fields (fc_*, confidence, guard_floor) at the
  forecast tolerance rtol 1e-4 / atol 1e-3 (the port does not contract
  products into adds where XLA does), the other fields at rtol 1e-5 /
  atol 1e-5;
* the port's own simulator and adapter records agree at the reference
  test's rtol/atol 1e-5.
"""
import _torch_threads  # noqa: F401  (one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import trace as ref_T
from repro.scaling import adapter as ref_adapter
from repro.scaling import api as ref_api
from repro.scaling import registry as ref_registry
from repro.sim import cluster as ref_cluster
from repro_torch.obs import trace as T
from repro_torch.scaling import adapter, api, registry
from repro_torch.sim import cluster

POLICIES = ("hpa", "kpa", "predictive", "aapa", "hybrid")
DISCRETE = ("minute", "sec", "scale_up", "scale_down", "cooldown_blocked",
            "capacity_capped", "archetype")
FORECAST = ("fc_point", "fc_lo", "fc_hi", "confidence", "guard_floor")
FORECAST_TOL = dict(rtol=1e-4, atol=1e-3)
FIELD_TOL = dict(rtol=1e-5, atol=1e-5)


class FakeEngine:
    """Duck-typed stand-in for ServingEngine: just the attributes the
    adapter senses and the `scale_to` actuator, with manual time."""

    def __init__(self, *, ready=2, lanes=2, startup_s=6.0, slo_s=1.0,
                 max_replicas=10):
        self.ready_replicas = ready
        self.lanes = lanes
        self.startup_s = startup_s
        self.slo_s = slo_s
        self.max_replicas = max_replicas
        self.starting, self.active, self.queue = [], [], []
        self.t = 0.0
        self.arrivals_total = 0
        self.rate = 0.0
        self.scale_calls = []

    def observed_rate(self, window_s):
        return self.rate

    def scale_to(self, n):
        self.scale_calls.append(n)
        self.ready_replicas = n


def _assert_trace(got, want, where=""):
    assert isinstance(got, T.DecisionRecord)
    for field in T.DecisionRecord._fields:
        a = np.asarray(getattr(got, field))
        e = np.asarray(getattr(want, field))
        assert a.dtype == np.float32 and a.shape == e.shape, (where, field)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(e),
                                      err_msg=f"{where} {field} NaN")
        if field in DISCRETE:
            np.testing.assert_array_equal(a, e, err_msg=f"{where} {field}")
        else:
            tol = FORECAST_TOL if field in FORECAST else FIELD_TOL
            np.testing.assert_allclose(a, e, equal_nan=True,
                                       err_msg=f"{where} {field}", **tol)


def _ctrl(reg, policy, cfg, **kw):
    if reg.spec(policy).takes_forecaster:
        kw.setdefault("forecaster", "holt_winters")
    return reg.get_controller(policy, cfg, **kw)


def test_sim_config_for_engine_matches_reference():
    eng = FakeEngine(ready=3, lanes=4, startup_s=6.0, slo_s=1.0)
    for minute_s, service_s, ci in ((2.0, 0.4, 15), (60.0, 0.4, 15),
                                    (1.0, None, 7)):
        got = adapter.sim_config_for_engine(
            eng, minute_s=minute_s, service_s=service_s,
            control_interval_sec=ci)
        want = ref_adapter.sim_config_for_engine(
            eng, minute_s=minute_s, service_s=service_s,
            control_interval_sec=ci)
        assert isinstance(got, cluster.SimConfig)
        for field in ("startup_sec", "control_interval_sec",
                      "rps_per_replica", "service_sec", "slo_sec",
                      "max_replicas", "initial_replicas"):
            assert getattr(got, field) == getattr(want, field), field
    cfg = adapter.sim_config_for_engine(eng, minute_s=2.0, service_s=0.4)
    assert cfg.startup_sec == 180 and cfg.initial_replicas == 3.0


def _shrinker_ref():
    def init():
        return jnp.float32(0.0)

    def on_minute(state, hist, minute_idx):
        return state

    def decide(state, obs):
        return state, obs.ready_total - 1.0, jnp.float32(120.0)
    return ref_api.Controller("shrinker", init, on_minute, decide)


def _shrinker():
    def init(lanes=(), device="cpu"):
        return torch.zeros(lanes, device=device)

    def on_minute(state, hist, minute_idx):
        return state

    def decide(state, obs):
        return state, obs.ready_total - 1.0, torch.full_like(state, 120.0)
    return api.Controller("shrinker", init, on_minute, decide)


def test_cooldown_blocks_scale_down_in_logical_time():
    """The reference's cooldown script: with minute_s=2 a 120-logical-s
    cooldown holds the second scale-down for 4 engine-seconds; the port
    makes the same scale_to calls and the same decision log."""
    calls, traces = [], []
    for make, mod in ((_shrinker_ref, ref_adapter), (_shrinker, adapter)):
        eng = FakeEngine(ready=8)
        cfg = mod.sim_config_for_engine(eng, minute_s=2.0,
                                        control_interval_sec=15)
        kw = {} if mod is ref_adapter else dict(device="cpu")
        auto = mod.EngineAutoscaler(eng, make(), cfg, minute_s=2.0, **kw)
        for step in range(1, 9):
            eng.t = step * 0.25
            auto.on_tick()
        assert eng.scale_calls[0] == 7
        assert all(c == 7 for c in eng.scale_calls), eng.scale_calls
        assert auto.last_cooldown_s == pytest.approx(120.0)
        eng.t = 4.0 + 0.5
        auto.on_tick()
        eng.t = 5.0
        auto.on_tick()
        assert eng.scale_calls[-1] == 6
        calls.append(eng.scale_calls)
        traces.append(auto.decision_trace())
    assert calls[0] == calls[1]
    _assert_trace(traces[1], traces[0], "shrinker")


def test_scales_to_zero_on_idle_engine_like_reference():
    calls = []
    for mod, kw in ((ref_adapter, {}), (adapter, dict(device="cpu"))):
        eng = FakeEngine(ready=2)
        auto = mod.EngineAutoscaler.from_policy(
            eng, "hpa", minute_s=1.0, cooldown_min=0.0, **kw)
        for step in range(1, 80):
            eng.t = step * 0.25
            auto.on_tick()
        assert eng.scale_calls[-1] == 0 and eng.ready_replicas == 0
        calls.append((eng.scale_calls, auto.decision_trace()))
    assert calls[0][0] == calls[1][0]
    _assert_trace(calls[1][1], calls[0][1], "idle hpa")


def test_from_policy_resolves_forecaster():
    got = []
    for mod, kw in ((ref_adapter, {}), (adapter, dict(device="cpu"))):
        eng = FakeEngine(ready=2)
        auto = mod.EngineAutoscaler.from_policy(
            eng, "predictive", forecaster="ewma", minute_s=1.0, **kw)
        eng.rate = 5.0
        eng.t = 0.25
        auto.on_tick()
        assert auto.last_desired >= 1.0
        got.append(auto.last_desired)
    assert got[1] == pytest.approx(got[0], rel=1e-5)
    assert auto.controller.name == "predictive"


def _script(mod, ctrl, cfg, rates, **kw):
    """The reference's sim-vs-engine script: the FakeEngine's rate and
    arrivals follow `rates`, one on_tick per control-period head."""
    eng = FakeEngine(ready=int(cfg.initial_replicas), lanes=20,
                     startup_s=30.0, slo_s=0.5, max_replicas=100)
    auto = mod.EngineAutoscaler(eng, ctrl, cfg, minute_s=60.0, **kw)
    heads = T.head_schedule(cfg)
    for m, r in enumerate(rates):
        eng.rate = float(r) / 60.0
        eng.queue = [0] * int(r // 200)
        for sec in heads:
            eng.t = m * 60.0 + sec
            auto.on_tick()
        eng.arrivals_total += float(r)
        eng.t = (m + 1) * 60.0 - 1e-9
    return eng, auto


@pytest.mark.parametrize("policy,ci", [(p, 15) for p in POLICIES] + [
    (p, 7) for p in ("hpa", "kpa", "predictive")])
def test_adapter_decisions_match_reference(policy, ci):
    """Every policy through the same FakeEngine script in both packages:
    the same scale_to calls, and the decision logs against each other.
    (AAPA and hybrid run at ci 15 only: the reference's eager AAPA takes
    ~0.35 s a minute here.)"""
    rng = np.random.default_rng(5)
    rates = np.round(rng.gamma(2.0, 400.0, 24)).astype(np.float32)
    rates[14:] = 0.0                    # scale-downs and scale to zero
    rcfg = ref_cluster.SimConfig(control_interval_sec=ci)
    cfg = cluster.SimConfig(control_interval_sec=ci)
    reng, rauto = _script(ref_adapter, _ctrl(ref_registry, policy, rcfg),
                          rcfg, rates)
    eng, auto = _script(adapter, _ctrl(registry, policy, cfg), cfg, rates,
                        device="cpu")
    assert eng.ready_replicas == reng.ready_replicas
    assert len(auto.decisions) == len(rauto.decisions) > 0
    _assert_trace(auto.decision_trace(), rauto.decision_trace(),
                  f"{policy} ci={ci}")
    assert auto.minute_idx == rauto.minute_idx == 23


def test_sim_vs_engine_decision_records_agree():
    """The reference's claim on the port: the same rate trace through the
    port's blocked simulator and its adapter gives DecisionRecord streams
    that agree on predictive's desired/cooldown/forecast fields."""
    cfg = cluster.SimConfig()
    minutes = 40
    rng = np.random.default_rng(5)
    rates = np.round(rng.gamma(2.0, 400.0, minutes)).astype(np.float32)
    ctrl = _ctrl(registry, "predictive", cfg)
    _, ct = cluster.simulate(torch.as_tensor(rates), ctrl, cfg,
                             device="cpu", telemetry=True)
    sim_d = T.to_numpy(ct).decisions                      # [M, H]

    class Eng(FakeEngine):
        def scale_to(self, n):
            self.ready_replicas = n

    eng = Eng(ready=int(cfg.initial_replicas), lanes=20, startup_s=30.0,
              slo_s=0.5, max_replicas=100)
    auto = adapter.EngineAutoscaler(eng, _ctrl(registry, "predictive", cfg),
                                    cfg, minute_s=60.0, device="cpu")
    heads = T.head_schedule(cfg)
    for m in range(minutes):
        eng.rate = float(rates[m]) / 60.0
        for sec in heads:
            eng.t = m * 60.0 + sec
            auto.on_tick()
        eng.arrivals_total += float(rates[m])
        eng.t = (m + 1) * 60.0 - 1e-9
    eng_d = auto.decision_trace()                         # [N]
    n = min(minutes * len(heads), len(eng_d.desired))
    for field in ("desired_raw", "desired", "cooldown_req", "fc_point"):
        a = np.asarray(getattr(sim_d, field)).reshape(-1)[:n]
        b = np.asarray(getattr(eng_d, field))[:n]
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                   equal_nan=True, err_msg=field)
    np.testing.assert_array_equal(
        np.asarray(sim_d.minute).reshape(-1)[:n], eng_d.minute[:n])
    np.testing.assert_array_equal(
        np.asarray(sim_d.sec).reshape(-1)[:n], eng_d.sec[:n])


def test_run_autoscaled_returns_decision_trace():
    summary_calls = {}

    class SummaryEngine(FakeEngine):
        def step(self):
            self.t += 15.0

        def summary(self):
            summary_calls["hit"] = True
            return {"served": 0}

    eng = SummaryEngine(ready=2, lanes=20, startup_s=30.0, slo_s=0.5,
                        max_replicas=100)
    summary, trace = adapter.run_autoscaled(
        eng, _ctrl(registry, "hpa", cluster.SimConfig()),
        submit_fn=lambda i, e: None, n_steps=8, cfg=cluster.SimConfig(),
        minute_s=60.0, device="cpu")
    assert summary_calls["hit"] and summary == {"served": 0}
    assert isinstance(trace, T.DecisionRecord)
    assert len(trace.desired) > 0
    assert np.all(np.isnan(trace.fc_point))     # hpa has no forecast
    empty = adapter.EngineAutoscaler(eng, _ctrl(registry, "hpa",
                                                cluster.SimConfig()),
                                     device="cpu").decision_trace()
    assert all(len(a) == 0 for a in empty)
    assert ref_T.DecisionRecord._fields == T.DecisionRecord._fields


def test_adapter_refuses_a_missing_card():
    """The adapter's tensors go where it is told: asking for CUDA without
    a card raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        adapter.EngineAutoscaler(FakeEngine(), _shrinker(),
                                 cluster.SimConfig(), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        adapter.EngineAutoscaler(FakeEngine(), _shrinker(),
                                 cluster.SimConfig())
