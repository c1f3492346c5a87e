"""The port's serving engine and launcher (``repro_torch.serve.engine``,
``repro_torch.launch.serve``) on the CPU.

Held: the six claims of the reference's ``tests/test_serve_engine.py``
(continuous batching, startup delay, cancelling starting pods first, the
sliding-window rate, scale to zero with the activator's cold start, more
replicas more throughput); the reference's
``test_adapter_matches_sim_steady_state`` with the port's engine, adapter
and simulator; and one run of the launcher's bursty script under AAPA
(the reference's classifier carried across) whose ``summary()`` equals
the reference's exactly, with its decision log against the reference's
(discrete fields exact, forecast fields at rtol 1e-4 / atol 1e-3). The
scheduler never reads the logits, so the model's numbers do not enter
the comparison; the schedule, the adapter and the controller do.
"""
import importlib.util
import io
import contextlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve as launcher
from repro_torch.models import model as M
from repro_torch.scaling import adapter, registry
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.sim import cluster

REPO = Path(__file__).resolve().parents[1]
DISCRETE = ("minute", "sec", "scale_up", "scale_down", "cooldown_blocked",
            "capacity_capped", "archetype")
FORECAST = ("fc_point", "fc_lo", "fc_hi", "confidence", "guard_floor")


@pytest.fixture(scope="module")
def engine_parts():
    cfg = smoke_config(get_config("internlm2_1_8b"))
    return cfg, M.init(0, cfg, device="cpu")


def _mk(cfg, params, **kw):
    defaults = dict(lanes_per_replica=2, max_replicas=4,
                    step_time_s=0.05, startup_s=0.2, slo_s=1.0,
                    device="cpu")
    defaults.update(kw)
    return ServingEngine(cfg, params, **defaults)


def test_requests_complete(engine_parts):
    cfg, params = engine_parts
    eng = _mk(cfg, params)
    for i in range(6):
        eng.submit(Request(i, 0.0, prompt_len=2, gen_len=3))
    for _ in range(40):
        eng.step()
    s = eng.summary()
    assert s["served"] == 6
    assert s["queue_len"] == 0
    assert s["p95_ms"] > 0
    assert eng.last_logits.shape == (8, 1, cfg.vocab)
    assert torch.isfinite(eng.last_logits.float()).all()


def test_scale_up_respects_startup_delay(engine_parts):
    cfg, params = engine_parts
    eng = _mk(cfg, params, startup_s=0.5)
    eng.scale_to(3)
    assert eng.ready_replicas == 1 and len(eng.starting) == 2
    for _ in range(4):       # 0.2 s < startup
        eng.step()
    assert eng.ready_replicas == 1
    for _ in range(10):      # past startup
        eng.step()
    assert eng.ready_replicas == 3


def test_scale_down_cancels_starting_first(engine_parts):
    cfg, params = engine_parts
    eng = _mk(cfg, params, startup_s=10.0)
    eng.scale_to(4)
    assert len(eng.starting) == 3
    eng.scale_to(2)
    assert len(eng.starting) == 1 and eng.ready_replicas == 1


def test_observed_rate_uses_sliding_window(engine_parts):
    cfg, params = engine_parts
    eng = _mk(cfg, params)
    for i in range(8):
        eng.submit(Request(i, eng.t, prompt_len=2, gen_len=2))
    for _ in range(20):               # advance to t = 1.0 s
        eng.step()
    assert eng.observed_rate(window_s=0.5) == 0.0
    assert eng.observed_rate(window_s=2.0) == pytest.approx(8.0)


def test_scale_to_zero_and_activator_cold_start(engine_parts):
    cfg, params = engine_parts
    eng = _mk(cfg, params, startup_s=0.1)
    eng.scale_to(0)
    assert eng.ready_replicas == 0 and not eng.starting
    for i in range(3):
        eng.submit(Request(i, eng.t, prompt_len=2, gen_len=2))
    assert eng.stats.cold_starts == 3
    assert len(eng.starting) == 1
    for _ in range(20):
        eng.step()
    assert eng.ready_replicas == 1
    assert eng.summary()["served"] == 3


def test_more_replicas_more_throughput(engine_parts):
    cfg, params = engine_parts
    done = {}
    for n in (1, 4):
        eng = _mk(cfg, params, startup_s=0.0)
        eng.scale_to(n)
        eng.step()
        for i in range(16):
            eng.submit(Request(i, 0.0, prompt_len=2, gen_len=4))
        for _ in range(10):
            eng.step()
        done[n] = eng.summary()["served"]
    assert done[4] > done[1]


def test_engine_refuses_a_missing_card_and_mixed_devices(engine_parts):
    cfg, params = engine_parts
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ServingEngine(cfg, params)
    meta = {"embed": torch.zeros(2, device="meta")}
    with pytest.raises(ValueError, match="lie on"):
        ServingEngine(cfg, meta, device="cpu")


def test_adapter_matches_sim_steady_state(engine_parts):
    """Constant-rate trace: the port's engine driven through its adapter
    and its cluster simulator driven by the same hpa controller +
    SimConfig converge to the same replica count (within one)."""
    model_cfg, params = engine_parts
    minute_s, steps_per_min = 1.0, 20
    eng = ServingEngine(model_cfg, params, lanes_per_replica=2,
                        max_replicas=8, step_time_s=minute_s / steps_per_min,
                        startup_s=0.1, slo_s=5.0, device="cpu")
    sim_cfg = adapter.sim_config_for_engine(eng, minute_s=minute_s,
                                            service_s=0.2)
    ctrl = registry.get_controller("hpa", sim_cfg, stabilization_min=2.0,
                                   cooldown_min=2.0)
    auto = adapter.EngineAutoscaler(eng, ctrl, sim_cfg, minute_s=minute_s)
    assert auto.device.type == "cpu"         # the engine's device
    per_min, minutes, rid = 30, 20, 0
    rng = np.random.default_rng(0)
    for _ in range(minutes):
        for _ in range(steps_per_min):
            for _ in range(per_min // steps_per_min
                           + (rng.random() < (per_min % steps_per_min)
                              / steps_per_min)):
                eng.submit(Request(rid, eng.t, prompt_len=2, gen_len=4))
                rid += 1
            eng.step()
            auto.on_tick()
    out = cluster.simulate(torch.full((minutes,), float(per_min)), ctrl,
                           sim_cfg, device="cpu")
    sim_final = float(out.ready_mean[-1])
    assert abs(sim_final - eng.ready_replicas) <= 1.0 + 1e-3, \
        (sim_final, eng.ready_replicas)
    assert eng.stats.served > 0


def _assert_log(got, want):
    """A port decision log against the reference's: discrete fields
    exact, forecast fields at rtol 1e-4 / atol 1e-3, the rest at 1e-5."""
    for field in got._fields:
        a, e = np.asarray(getattr(got, field)), np.asarray(getattr(want,
                                                                   field))
        assert a.shape == e.shape, field
        if field in DISCRETE:
            np.testing.assert_array_equal(a, e, err_msg=field)
        else:
            tol = (dict(rtol=1e-4, atol=1e-3) if field in FORECAST
                   else dict(rtol=1e-5, atol=1e-5))
            np.testing.assert_allclose(a, e, equal_nan=True, err_msg=field,
                                       **tol)


def _reference_demo():
    spec = importlib.util.spec_from_file_location(
        "serve_autoscale_reference", REPO / "examples" / "serve_autoscale.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_launcher_script_matches_reference(tmp_path):
    """The launcher's 10-minute bursty script under AAPA: the same
    arrivals (rng seed 0), the reference's trained classifier on both
    sides; summaries equal exactly, decision logs within tolerance."""
    from repro.configs import get_config as ref_get_config
    from repro.configs import smoke_config as ref_smoke_config
    from repro.core import gbdt as ref_gbdt
    from repro.core import pipeline as ref_pipeline
    from repro.models import model as RM
    rtrained = ref_pipeline.train_classifier(
        "aapaset_ci", ref_gbdt.GBDTConfig(n_rounds=10, depth=3),
        root=tmp_path, cache=False)
    rcfg = ref_smoke_config(ref_get_config("stablelm_1_6b"))
    rparams = RM.init(jax.random.PRNGKey(0), rcfg)
    demo = _reference_demo()
    traces = []
    demo.print_why_scaled = traces.append       # capture the decision log
    rates = launcher.bursty_rates(10)
    with contextlib.redirect_stdout(io.StringIO()):
        want = demo.run(10, "aapa", rtrained, rparams, rcfg, rates,
                        np.random.default_rng(0))

    trained = interop.trained_from_reference(rtrained, device="cpu")
    cfg = smoke_config(get_config("stablelm_1_6b"))
    params = M.init(0, cfg, device="cpu")
    logged = []
    eng, auto = launcher.serve(10, "aapa", trained, params, cfg, rates,
                               np.random.default_rng(0), device="cpu",
                               log=logged.append)
    assert eng.summary() == want
    assert want["served"] > 0 and len(logged) == 2
    assert auto.minute_idx == 10        # one reclassification (minute 10)
    got = auto.decision_trace()
    assert len(got.desired) == 41
    assert np.isfinite(got.fc_point).all()
    _assert_log(got, traces[0])
    # the same run through the launcher's `run` prints its digest
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        s = launcher.run(10, "aapa", trained, params, cfg, rates,
                         np.random.default_rng(0), device="cpu")
    assert s == want and "why scaled" in out.getvalue()


def test_launcher_decisions_match_reference_adapter(tmp_path):
    """The launcher's script driven through both adapters with the same
    engine schedule: decision logs against each other (discrete fields
    exact, forecast fields at rtol 1e-4 / atol 1e-3)."""
    from repro.scaling import adapter as ref_adapter
    from repro.scaling import registry as ref_registry
    cfg = smoke_config(get_config("stablelm_1_6b"))
    params = M.init(0, cfg, device="cpu")
    logs = []
    for mod, reg in ((ref_adapter, ref_registry), (adapter, registry)):
        eng = ServingEngine(cfg, params, lanes_per_replica=4,
                            max_replicas=8, step_time_s=0.05, startup_s=2.0,
                            slo_s=1.5, device="cpu")
        kw = {} if mod is ref_adapter else dict(device="cpu")
        sim_cfg = mod.sim_config_for_engine(eng, minute_s=1.0)
        auto = mod.EngineAutoscaler(
            eng, reg.get_controller("predictive", sim_cfg), sim_cfg,
            minute_s=1.0, **kw)
        rng = np.random.default_rng(0)
        rid = 0
        for rate in launcher.bursty_rates(10):
            n_req = int(rng.poisson(rate / 60.0))
            for _ in range(20):
                burst = n_req // 20 + (rng.random() < (n_req % 20) / 20)
                for _ in range(int(burst)):
                    eng.submit(Request(rid, eng.t, prompt_len=4,
                                       gen_len=int(rng.integers(2, 6))))
                    rid += 1
                eng.step()
                auto.on_tick()
        logs.append((eng.summary(), auto.decision_trace()))
    assert logs[0][0] == logs[1][0]
    _assert_log(logs[1][1], logs[0][1])


def test_launcher_flags():
    """Unknown policies exit with the list; ``--multi-pod`` (the
    reference's 2x16x16 mesh across hosts) is not in the port and exits
    with an error; ``--dry-run`` runs the dry run of the ``decode_32k``
    cell on the meta device and exits 0."""
    with pytest.raises(SystemExit, match="available"):
        launcher.main(["--arch", "stablelm_1_6b", "--policy", "nope",
                       "--device", "cpu"])
    with pytest.raises(SystemExit, match="multi-pod"):
        launcher.main(["--arch", "stablelm_1_6b", "--multi-pod"])
    with pytest.raises(SystemExit) as done:
        launcher.main(["--arch", "stablelm_1_6b", "--dry-run"])
    assert done.value.code == 0
    rates = launcher.bursty_rates(10)
    assert rates[5] == 2000.0 and (np.delete(rates, 5) == 120.0).all()
