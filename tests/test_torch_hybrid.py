"""The hybrid policy, and AAPA with a conformal band, in the port
(``repro_torch.scaling``) against the JAX reference on the CPU.

The same ``archetype_mix`` rates (W=6, M=90) go through the port's plain
episode and the reference's blocked simulate at control intervals 15, 30
and 7 (the remainder block). All 12 MinuteOut fields are held at the
episode tolerance (rtol 3e-6 / atol 1e-4, tests/test_kernel_smoke.py) and
the archetype every lane carries after every minute exactly. The
conformal band is the reference's, calibrated on a ``burst_storm`` split
and carried across through ``interop``; the GBDT classifier is trained by
the reference and crosses over through its npz.
"""
import _torch_threads  # noqa: F401  (one torch thread)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as ref_cal
from repro.core import gbdt as ref_gbdt
from repro.core import pipeline as ref_pipeline
from repro.forecast import conformal as ref_conformal
from repro.forecast import registry as ref_fregistry
from repro.scaling import registry as ref_registry
from repro.sim import cluster as ref_cluster
from repro_torch import interop
from repro_torch.forecast import conformal as t_conformal
from repro_torch.forecast import registry as t_fregistry
from repro_torch.kernels import ref
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


@pytest.fixture(scope="module")
def classifier(tmp_path_factory):
    """(reference classify, the port's), a tiny GBDT + beta calibration
    trained by the reference and loaded by the port from its npz."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(96, 38)).astype(np.float32)
    y = rng.integers(0, 4, 96).astype(np.int32)
    params = ref_gbdt.fit(X, y, ref_gbdt.GBDTConfig(n_rounds=4, depth=3))
    cal = ref_cal.fit(np.asarray(ref_gbdt.predict_proba(
        params, jnp.asarray(X))), y)
    tr = ref_pipeline.TrainedAAPA(params, cal, 0.0, 0.0, 0.0,
                                  np.zeros(4), 96, 0.0)
    path = tmp_path_factory.mktemp("policies") / "classifier.npz"
    tr.save(path)
    return (tr.make_classify(),
            interop.trained_from_reference(path, device="cpu")
            .make_classify())


def _hyper(kw, band, wrap, forecaster):
    """`kw` with "band" standing for the band and "wrapped" /
    "unwidened" for Holt-Winters wrapped in it, widening with sqrt(h) or
    not (no `band=` argument: the confidence scale is the point's)."""
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


def _reference_minutes(cfg, ctrl, rates):
    """The reference's blocked minute step scanned over the episode:
    (MinuteOut [W, M], archetype after each minute [W, M])."""
    def lane(r):
        def body(carry, rate):
            carry, out = ref_cluster.minute_step(cfg, ctrl, carry, rate)
            return carry, (out, carry[0].ctrl_state.arch)
        carry0 = (ref_cluster.initial_state(ctrl, cfg), jnp.int32(0))
        return jax.lax.scan(body, carry0, r)[1]
    out, arch = jax.jit(jax.vmap(lane))(jnp.asarray(rates))
    return [np.asarray(f) for f in out], np.asarray(arch)


@pytest.mark.parametrize("ci", CIS)
@pytest.mark.parametrize("policy,kw", [
    ("hybrid", {}), ("hybrid", dict(band="band", max_down_frac=0.5)),
    ("aapa", dict(band="band")),
    ("aapa", dict(forecaster="wrapped", forecast_confidence=True)),
    ("hybrid", dict(forecaster="unwidened", forecast_confidence=True))],
    ids=["hybrid", "hybrid_band", "aapa_band", "aapa_wrapped",
         "hybrid_unwidened"])
def test_archetype_policy_episode_matches_reference(bands, classifier,
                                                    policy, kw, ci):
    """hybrid with the seeded GBDT (native band, and with the conformal
    band), AAPA with the band, and both with a band-wrapped forecaster
    and no `band=` (the half-width the band's, the confidence scale the
    point's): MinuteOut and the archetype sequence of every lane; the
    GBDT moves lanes between archetypes."""
    rcfg = ref_cluster.SimConfig(control_interval_sec=ci)
    tcfg = t_cluster.SimConfig(control_interval_sec=ci)
    rc = ref_registry.make(policy, rcfg, classify=classifier[0],
                           **_ref_hyper(kw, bands))
    tc = t_registry.make(policy, tcfg, classify=classifier[1],
                         **_port_hyper(kw, bands))
    want_out, want_arch = _reference_minutes(rcfg, rc, _rates())
    got_out, got_arch = ref.aapa_episode_ref(torch.as_tensor(_rates()), tc,
                                             tcfg)
    _assert_minute_out(got_out, want_out)
    np.testing.assert_array_equal(got_arch.numpy(), want_arch)
    assert len(np.unique(want_arch)) >= 3


@pytest.mark.parametrize("ci", [15, 7])
@pytest.mark.parametrize("policy", ["aapa", "hybrid"])
def test_own_band_episode_matches_reference(classifier, policy, ci):
    """The whole uncertainty path in each package: the port calibrates its
    own band (its `calibrate` on the CPU) and runs its AAPA or hybrid with
    it, the reference does the same with its own; the band's scale (a
    mean over the split, summed in another order) feeds Algorithm 1's
    ceil decisions, and the episodes and archetypes agree."""
    split = t_scenarios.burst_storm(n_workloads=16, minutes=240,
                                    seed=2).rates
    rband = ref_conformal.calibrate(ref_fregistry.make("holt_winters"),
                                    jnp.asarray(split), alpha=0.9)
    tband = t_conformal.calibrate(t_fregistry.make("holt_winters"), split,
                                  alpha=0.9, device="cpu")
    np.testing.assert_allclose(float(tband.scale), float(rband.scale),
                               rtol=1e-5)
    rcfg = ref_cluster.SimConfig(control_interval_sec=ci)
    tcfg = t_cluster.SimConfig(control_interval_sec=ci)
    rc = ref_registry.make(policy, rcfg, classify=classifier[0], band=rband)
    tc = t_registry.make(policy, tcfg, classify=classifier[1], band=tband)
    want_out, want_arch = _reference_minutes(rcfg, rc, _rates())
    got_out, got_arch = ref.aapa_episode_ref(torch.as_tensor(_rates()), tc,
                                             tcfg)
    _assert_minute_out(got_out, want_out)
    np.testing.assert_array_equal(got_arch.numpy(), want_arch)


@pytest.mark.parametrize("ci", [15, 7])
def test_hybrid_default_classifier_matches_reference(ci):
    rcfg = ref_cluster.SimConfig(control_interval_sec=ci)
    tcfg = t_cluster.SimConfig(control_interval_sec=ci)
    want = ref_cluster.make_simulator(
        ref_registry.make("hybrid", rcfg), rcfg, decide_kernel=False,
        plant_kernel=False)(jnp.asarray(_rates()))
    ctrl = t_registry.make("hybrid", tcfg)
    assert ctrl.hyper["classify"] is t_registry.default_classify
    _assert_minute_out(ref.episode_block_ref(torch.as_tensor(_rates()),
                                             ctrl, tcfg), want)


def test_plain_hybrid_classifies_through_plain_logits(classifier):
    """The plain hybrid episode rebuilds its GBDT classifier on the plain
    logits, so on the card it launches no kernel."""
    cfg = t_cluster.SimConfig()
    ctrl = t_registry.make("hybrid", cfg, classify=classifier[1],
                           max_down_frac=0.4)
    plain = ref._plain_controller(ctrl, cfg)
    assert plain.name == "hybrid" and plain is not ctrl
    assert plain.hyper["classify"].logits is ref.gbdt_logits_ref
    assert plain.hyper["max_down_frac"] == 0.4
