"""Parity of the PyTorch port's cluster simulator (``repro_torch.sim``)
with the JAX reference (``repro.sim.cluster``) for HPA, on the CPU.

The same numpy-seeded rates go through both packages; MinuteOut fields
are held at the reference's episode tolerance (rtol 3e-6 / atol 1e-4,
tests/test_kernel_smoke.py)."""
import _torch_threads  # noqa: F401  (one torch thread)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.scaling import api as ref_api
from repro.scaling import registry as ref_registry
from repro.sim import cluster as ref_cluster
from repro_torch import interop
from repro_torch.evals import metrics as t_metrics
from repro_torch.evals import rei as t_rei
from repro_torch.scaling import api as t_api
from repro_torch.scaling import registry as t_registry
from repro_torch.sim import cluster as t_cluster

EPISODE_TOL = dict(rtol=3e-6, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rates(seed: int, w: int = 5, m: int = 8) -> np.ndarray:
    """Busy, idle and bursty lanes: scale-ups, scale-downs after the
    cooldown, scale-to-zero and wake-ups all happen within 8 minutes."""
    rng = np.random.default_rng(seed)
    rates = rng.uniform(0.0, 3000.0, (w, m)).astype(np.float32)
    rates[0, 2:] = 0.0
    rates[1, :4] = 20.0
    rates[2, 5] = 12000.0
    return rates


@functools.lru_cache(maxsize=None)
def _reference(ci: int, seed: int = 0):
    cfg = ref_cluster.SimConfig(control_interval_sec=ci)
    ctrl = ref_registry.make("hpa", cfg)
    out = ref_cluster.make_simulator(ctrl, cfg, decide_kernel=False,
                                     plant_kernel=False)(
        jnp.asarray(_rates(seed)))
    return tuple(np.asarray(f) for f in out)


def _port(ci: int):
    cfg = t_cluster.SimConfig(control_interval_sec=ci)
    return cfg, t_registry.make("hpa", cfg)


def _assert_minute_out(got, want, **tol):
    for name, a, e in zip(t_cluster.MinuteOut._fields, got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(e),
                                   err_msg=name, **(tol or EPISODE_TOL))


@pytest.mark.parametrize("ci", [15, 30, 7])
def test_simulate_matches_reference(ci):
    """All 12 MinuteOut fields, ci=7 exercising the remainder block."""
    cfg, ctrl = _port(ci)
    got = t_cluster.make_simulator(ctrl, cfg, device="cpu")(_rates(0))
    _assert_minute_out(got, _reference(ci))


@pytest.mark.parametrize("path", ["plant_kernel", "decide_kernel",
                                  "reference"])
def test_simulate_paths_match_reference(path):
    """The unfused plant-kernel path, the fused-episode path and the
    decide-every-tick reference path, each on its CPU plain version."""
    cfg, ctrl = _port(15)
    rates = torch.as_tensor(_rates(0))
    if path == "reference":
        got = t_cluster.simulate_reference(rates, ctrl, cfg, device="cpu")
    else:
        got = t_cluster.simulate(rates, ctrl, cfg, device="cpu",
                                 **{path: True})
    _assert_minute_out(got, _reference(15))


def test_make_simulator_w_chunk_is_bitwise():
    cfg, ctrl = _port(15)
    rates = np.concatenate([_rates(1), _rates(2)[:1]])        # W = 6
    whole = t_cluster.make_simulator(ctrl, cfg, device="cpu")(rates)
    chunked = t_cluster.make_simulator(ctrl, cfg, device="cpu",
                                       w_chunk=2)(rates)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="must divide"):
        t_cluster.make_simulator(ctrl, cfg, device="cpu", w_chunk=4)(rates)


def test_state_handoff_from_reference():
    """The reference runs k minutes, `interop.from_reference` carries its
    SimState across, and both packages continue to the same MinuteOut."""
    k, rates = 3, _rates(3)[2]
    cfg = ref_cluster.SimConfig()
    ref_ctrl = ref_registry.make("hpa", cfg)

    def run(carry, rs):
        return jax.lax.scan(
            lambda c, r: ref_cluster.minute_step(cfg, ref_ctrl, c, r),
            carry, jnp.asarray(rs))

    carry0 = (ref_cluster.initial_state(ref_ctrl, cfg), jnp.int32(0))
    carry_k, _ = run(carry0, rates[:k])
    _, want = run(carry_k, rates[k:])

    state, minute = interop.from_reference(
        jax.tree.map(np.asarray, carry_k), device="cpu")
    assert isinstance(state, t_cluster.SimState)
    assert interop.to_numpy(state).ctrl_state.desired_buf.shape == (20,)
    t_cfg, t_ctrl = _port(15)
    carry, outs = (state, minute), []
    for r in torch.as_tensor(rates[k:]):
        carry, out = t_cluster.minute_step(t_cfg, t_ctrl, carry, r)
        outs.append(out)
    got = t_cluster.MinuteOut(*(torch.stack(f) for f in zip(*outs)))
    _assert_minute_out(got, want)
    assert int(carry[1]) == len(rates)


def test_interop_round_trip_and_unknown_type():
    out = ref_cluster.MinuteOut(*(np.full((2, 3), i, np.float32)
                                  for i in range(12)))
    port = interop.from_reference(out, device="cpu")
    assert isinstance(port, t_cluster.MinuteOut)
    back = interop.to_numpy(port)
    for a, b in zip(back, out):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(TypeError, match="no port counterpart"):
        interop.from_reference(ref_api.ScaleAction(*(np.zeros(1),) * 5),
                               device="cpu")


def test_apply_decision_matches_reference_exactly():
    rng = np.random.default_rng(7)
    n = 4096
    total = rng.uniform(0.0, 50.0, n).astype(np.float32)
    desired = np.round(total + rng.normal(0.0, 3.0, n)).astype(np.float32)
    desired[::7] = total[::7] + 0.5                  # on the band edges
    desired[1::7] = total[1::7] - 0.5
    cooldown = np.where(rng.random(n) < 0.5, 0.0,
                        rng.uniform(0.0, 300.0, n)).astype(np.float32)
    last_dir = rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)
    req = rng.uniform(0.0, 600.0, n).astype(np.float32)
    do_ctrl = rng.random(n) < 0.8

    ref_lim, ref_act = ref_api.apply_decision(
        ref_api.LimiterState(jnp.asarray(cooldown), jnp.asarray(last_dir)),
        jnp.asarray(total), jnp.asarray(desired), jnp.asarray(req),
        jnp.asarray(do_ctrl))
    t = torch.as_tensor
    lim, act = t_api.apply_decision(
        t_api.LimiterState(t(cooldown), t(last_dir)), t(total), t(desired),
        t(req), t(do_ctrl))
    for a, e in zip((*lim, *act), (*ref_lim, *ref_act)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(e))


def test_registry_lists_ported_policies():
    """All five of the reference's policies are ported."""
    assert t_registry.available() == ["aapa", "hpa", "hybrid", "kpa",
                                      "predictive"]
    assert t_registry.available() == ref_registry.available()
    with pytest.raises(KeyError, match="available: \\['aapa', 'hpa', "):
        t_registry.make("no_such_policy", t_cluster.SimConfig())
    with pytest.raises(TypeError, match="no hyperparameters"):
        t_registry.make("hpa", t_cluster.SimConfig(), horizon_min=5)


def test_cuda_entry_points_raise_without_cuda():
    """No silent CPU fallback: asking for CUDA where there is none
    raises, from every tensor-making entry point."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    cfg, ctrl = _port(15)
    rates = _rates(0)
    calls = [lambda: t_cluster.simulate(rates, ctrl, cfg),
             lambda: t_cluster.make_simulator(ctrl, cfg),
             lambda: t_cluster.initial_state(ctrl, cfg),
             lambda: ctrl.init((2,), "cuda"),
             lambda: t_metrics.make_metrics_simulator(ctrl, cfg),
             lambda: t_metrics.compute(t_cluster.MinuteOut(
                 *(np.ones((2, 3), np.float32),) * 12)),
             lambda: t_rei.rei(0.05, 2000.0, 30.0),
             lambda: t_rei.sensitivity(0.05, 2000.0, 30.0),
             lambda: t_rei.scenario_baselines(1440, 8)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_hpa_hyper_is_the_single_source():
    """`decide` reads the hyperparameters the episode kernel is launched
    with, so the two paths cannot drift apart."""
    cfg, ctrl = _port(15)
    assert ctrl.hyper["inv_target"] == float(np.float32(1.0)
                                            / np.float32(0.70))
    obs = t_api.Obs(*(torch.tensor([4.0, 4.0]),) * 2,
                    util_ema=torch.tensor([0.9, 0.2]),
                    queue=torch.zeros(2), rate_rps=torch.ones(2),
                    rate_history=torch.zeros(2, 60), minute_idx=0)
    state = ctrl.init((2,), "cpu")
    _, desired, cool = ctrl.decide(state, obs)
    np.testing.assert_array_equal(desired.numpy(), [6.0, 2.0])
    ctrl.hyper.update(tolerance=10.0, cooldown_sec=7.0)
    _, desired, cool = ctrl.decide(state, obs)
    np.testing.assert_array_equal(desired.numpy(), [4.0, 4.0])
    np.testing.assert_array_equal(cool.numpy(), [7.0, 7.0])
