"""The predictive and kpa policies in the port (``repro_torch.scaling``)
against the JAX reference on the CPU, and the registry of all five
policies (hybrid and AAPA with a band: tests/test_torch_hybrid.py).

The same ``archetype_mix`` rates (W=6, M=90) go through the port's
``cluster.simulate`` (the episode kernel's plain version) and the
reference's blocked simulate at control intervals 15, 30 and 7 (the
remainder block). All 12 MinuteOut fields are held at the episode
tolerance (rtol 3e-6 / atol 1e-4, tests/test_kernel_smoke.py). The
conformal band is the reference's, calibrated on a ``burst_storm`` split
and carried across through ``interop``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.forecast import conformal as ref_conformal
from repro.forecast import registry as ref_fregistry
from repro.scaling import registry as ref_registry
from repro.sim import cluster as ref_cluster
from repro_torch import interop
from repro_torch.forecast import conformal as t_conformal
from repro_torch.forecast import registry as t_fregistry
from repro_torch.kernels import episode_block, policy_signals
from repro_torch.scaling import policies as t_policies
from repro_torch.scaling import registry as t_registry
from repro_torch.scaling import scenarios as t_scenarios
from repro_torch.sim import cluster as t_cluster

EPISODE_TOL = dict(rtol=3e-6, atol=1e-4)
W, M = 6, 90
CIS = [15, 30, 7]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _rates():
    return t_scenarios.archetype_mix(n_workloads=W, minutes=M, seed=0).rates


@pytest.fixture(scope="module")
def bands():
    """(reference ConformalBand, the port's) of Holt-Winters at 0.9."""
    split = t_scenarios.burst_storm(n_workloads=16, minutes=240,
                                    seed=1).rates
    rband = ref_conformal.calibrate(ref_fregistry.make("holt_winters"),
                                    jnp.asarray(split), alpha=0.9)
    return rband, interop.from_reference(jax.tree.map(np.asarray, rband),
                                         device="cpu")


#: case -> (policy, hyperparameters; "band" stands for the band,
#: "wrapped" / "unwidened" for Holt-Winters wrapped in it)
CASES = {
    "predictive": ("predictive", {}),
    "predictive_band": ("predictive", dict(band="band")),
    "predictive_conservative": ("predictive", dict(band="band",
                                                   conservative=True)),
    "predictive_conservative_native": ("predictive",
                                       dict(conservative=True)),
    "predictive_conservative_wrapped": ("predictive", dict(
        forecaster="wrapped", conservative=True)),
    "predictive_conservative_unwidened": ("predictive", dict(
        forecaster="unwidened", conservative=True)),
    "kpa": ("kpa", {}),
    "kpa_panicky": ("kpa", dict(panic_threshold=1.2, stable_window_s=120.0,
                                cooldown_min=0.5)),
}


def _hyper(kw, band, wrap, forecaster):
    wrapped = {"wrapped": True, "unwidened": False}
    return {k: (band if v == "band" else
                wrap(forecaster("holt_winters"), band,
                     widen_with_horizon=wrapped[v]) if v in wrapped else v)
            for k, v in kw.items()}


def _ref_hyper(kw, bands):
    return _hyper(kw, bands[0], ref_conformal.wrap, ref_fregistry.make)


def _port_hyper(kw, bands):
    return _hyper(kw, bands[1], t_conformal.wrap, t_fregistry.make)


def _assert_minute_out(got, want):
    for name, a, e in zip(t_cluster.MinuteOut._fields, got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(e),
                                   err_msg=name, **EPISODE_TOL)


@pytest.mark.parametrize("ci", CIS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_policy_episode_matches_reference(bands, case, ci):
    policy, kw = CASES[case]
    rcfg = ref_cluster.SimConfig(control_interval_sec=ci)
    tcfg = t_cluster.SimConfig(control_interval_sec=ci)
    rc = ref_registry.make(policy, rcfg, **_ref_hyper(kw, bands))
    tc = t_registry.make(policy, tcfg, **_port_hyper(kw, bands))
    want = ref_cluster.make_simulator(rc, rcfg, decide_kernel=False,
                                      plant_kernel=False)(
        jnp.asarray(_rates()))
    got = t_cluster.simulate(_rates(), tc, tcfg, device="cpu")
    _assert_minute_out(got, want)
    assert float(got.ups.sum()) > 0 and float(got.downs.sum()) > 0


def test_registry_lists_all_five_with_reference_defaults():
    assert t_registry.available() == ["aapa", "hpa", "hybrid", "kpa",
                                      "predictive"]
    for name in t_registry.available():
        assert (t_registry.spec(name).defaults
                == ref_registry.spec(name).defaults), name
        assert (t_registry.spec(name).needs_classifier
                == ref_registry.spec(name).needs_classifier), name


def test_hyperparameters_are_the_kernel_arguments(bands):
    """Each controller's hyper dict holds the f32 values its episode
    kernel takes: reciprocals of the constant divisors, f32 EMA rates."""
    cfg = t_cluster.SimConfig(control_interval_sec=7)
    p = t_registry.make("predictive", cfg, band=bands[1], target=0.6)
    assert p.hyper["inv_cap"] == float(np.float32(1) / np.float32(12.0))
    assert p.hyper["forecaster"].name == "conformal[holt_winters]"
    assert p.hyper["forecaster"].hyper["band"] is bands[1]
    assert "band" not in p.hyper
    k = t_registry.make("kpa", cfg)
    assert k.hyper["a_s"] == float(np.float32(7 / 60))
    assert k.hyper["a_p"] == 1.0
    assert k.hyper["inv_tgt"] == 0.5
    h = t_registry.make("hybrid", cfg, max_down_frac=0.25)
    assert h.hyper["down_keep"] == 0.75
    assert h.hyper["inv_guard"] == float(np.float32(1) / np.float32(0.85))
    assert h.hyper["stride_min"] == 10


def test_policy_state_handoff_from_reference(bands):
    """The reference runs k minutes under predictive with the band and
    under kpa; its SimState (PredState / KPAState, FState, HWState)
    crosses over, and both packages continue alike."""
    rates, k = _rates()[2], M // 2
    for name, kw in (("predictive", dict(band="band", conservative=True)),
                     ("kpa", {})):
        rcfg, tcfg = ref_cluster.SimConfig(), t_cluster.SimConfig()
        rc = ref_registry.make(name, rcfg, **_ref_hyper(kw, bands))
        tc = t_registry.make(name, tcfg, **_port_hyper(kw, bands))

        def run(carry, rs):
            return jax.lax.scan(
                lambda c, r: ref_cluster.minute_step(rcfg, rc, c, r), carry,
                jnp.asarray(rs))

        carry_k, _ = run((ref_cluster.initial_state(rc, rcfg),
                          jnp.int32(0)), rates[:k])
        _, want = run(carry_k, rates[k:])
        state, minute = interop.from_reference(
            jax.tree.map(np.asarray, carry_k), device="cpu")
        assert isinstance(state.ctrl_state, (t_policies.PredState,
                                             t_policies.KPAState))
        carry, outs = (state, minute), []
        for r in torch.as_tensor(rates[k:]):
            carry, out = t_cluster.minute_step(tcfg, tc, carry, r)
            outs.append(out)
        _assert_minute_out(
            t_cluster.MinuteOut(*(torch.stack(f) for f in zip(*outs))), want)


def test_episode_kernel_launchers_cover_every_policy():
    """Every registered policy has a compiled episode-kernel policy and
    every registry forecaster a minute walk; a forecaster outside the
    registry stays outside the kernel (the launcher raises before it
    builds or launches anything)."""
    cfg = t_cluster.SimConfig()
    assert set(episode_block._POLICIES) == set(t_registry.available())
    assert set(policy_signals.FORECASTERS) == set(t_fregistry.available())
    rates = torch.ones(2, 3)
    for name in ("predictive", "aapa", "hybrid"):
        for fname in t_fregistry.available():
            ctrl = t_registry.make(name, cfg, forecaster=fname)
            fa = policy_signals.forecaster_args(ctrl.hyper["forecaster"], 15)
            assert fa.fc_i[0] == policy_signals.FORECASTERS[fname]
        own = t_fregistry.make("ewma")._replace(name="my_ewma")
        ctrl = t_registry.make(name, cfg, forecaster=own)
        with pytest.raises(NotImplementedError, match="registry"):
            policy_signals.forecaster_args(ctrl.hyper["forecaster"], 15)
    with pytest.raises(ValueError, match="CUDA"):
        episode_block.aapa_episode_cuda(rates, t_registry.make("hybrid",
                                                               cfg), cfg)
    with pytest.raises(ValueError, match="aapa or hybrid"):
        episode_block.aapa_episode_cuda(rates, t_registry.make("kpa", cfg),
                                        cfg)


def test_episode_kernel_takes_the_band_of_the_forecaster():
    """The kernel's interval half-width comes from the forecaster the
    plain episode runs, and its confidence scale from the `band=`
    argument: a wrapped forecaster without `band=` gives the same
    q * sqrt(h) as `band=band` and the point's scale; an unwidened band
    q * 1; the outermost of two wraps wins."""
    cfg = t_cluster.SimConfig()
    band = t_conformal.ConformalBand(torch.tensor(2.5), 0.9,
                                     torch.tensor(9.0))
    hw = t_fregistry.make("holt_winters")
    sqrt15 = float(np.sqrt(np.float32(15)))
    native = policy_signals.forecaster_args(hw, 15)

    def args(fcst):
        fa = policy_signals.forecaster_args(fcst, 15)
        assert (fa.fc_f, fa.fc_i) == (native.fc_f, native.fc_i)
        return fa.use_band, fa.band_q, fa.sqrt_h

    for name in ("predictive", "aapa"):
        by_arg = t_registry.make(name, cfg, band=band)
        wrapped = t_registry.make(name, cfg,
                                  forecaster=t_conformal.wrap(hw, band))
        want = (1, 2.5, sqrt15)
        assert args(by_arg.hyper["forecaster"]) == want
        assert args(wrapped.hyper["forecaster"]) == want
    assert t_registry.make("aapa", cfg, band=band).hyper[
        "conf_scale"] is band.scale
    assert t_registry.make("aapa", cfg, forecaster=t_conformal.wrap(
        hw, band)).hyper["conf_scale"] is None
    flat = t_conformal.wrap(hw, band, widen_with_horizon=False)
    assert args(flat) == (1, 2.5, 1.0)
    outer = t_conformal.ConformalBand(torch.tensor(4.0), 0.8,
                                      torch.tensor(3.0))
    assert args(t_conformal.wrap(flat, outer)) == (1, 4.0, sqrt15)
    assert args(hw) == (0, 0.0, sqrt15)
