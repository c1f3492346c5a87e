"""AAPA episodes in the port (``repro_torch`` ``aapa`` controller through
``sim.cluster.simulate``) against the JAX reference on the CPU.

A tiny GBDT + beta calibration is trained in-process by the reference
and crosses over through its npz (``TrainedAAPA.save``). The same
``archetype_mix`` rates go through both packages; all 12 MinuteOut
fields are held at the episode tolerance (rtol 3e-6 / atol 1e-4,
tests/test_kernel_smoke.py), and the archetype every lane carries after
every minute is held exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as ref_cal
from repro.core import gbdt as ref_gbdt
from repro.core import pipeline as ref_pipeline
from repro.scaling import registry as ref_registry
from repro.sim import cluster as ref_cluster
from repro_torch import interop
from repro_torch.forecast import conformal as t_conformal
from repro_torch.kernels import ref as t_ref
from repro_torch.scaling import policies as t_policies
from repro_torch.scaling import registry as t_registry
from repro_torch.scaling import scenarios as t_scenarios
from repro_torch.sim import cluster as t_cluster

EPISODE_TOL = dict(rtol=3e-6, atol=1e-4)
W, M = 6, 90


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def classifier(tmp_path_factory):
    """(reference TrainedAAPA, the port's, loaded from its npz)."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(96, 38)).astype(np.float32)
    y = rng.integers(0, 4, 96).astype(np.int32)
    params = ref_gbdt.fit(X, y, ref_gbdt.GBDTConfig(n_rounds=4, depth=3))
    cal = ref_cal.fit(np.asarray(ref_gbdt.predict_proba(
        params, jnp.asarray(X))), y)
    tr = ref_pipeline.TrainedAAPA(params, cal, 0.0, 0.0, 0.0,
                                  np.zeros(4), 96, 0.0)
    path = tmp_path_factory.mktemp("aapa") / "classifier.npz"
    tr.save(path)
    return tr, interop.trained_from_reference(path, device="cpu")


@functools.lru_cache(maxsize=None)
def _rates():
    return t_scenarios.archetype_mix(n_workloads=W, minutes=M, seed=0).rates


def _controllers(classifier, ci, policy="aapa", history_len=60, **hyper):
    ref_tr, port_tr = classifier
    rcfg = ref_cluster.SimConfig(control_interval_sec=ci,
                                 history_len=history_len)
    tcfg = t_cluster.SimConfig(control_interval_sec=ci,
                               history_len=history_len)
    rc = ref_registry.make(policy, rcfg, classify=ref_tr.make_classify(),
                           **hyper)
    tc = t_registry.make(policy, tcfg, classify=port_tr.make_classify(),
                         **hyper)
    return (rcfg, rc), (tcfg, tc)


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


def _assert_minute_out(got, want):
    for name, a, e in zip(t_cluster.MinuteOut._fields, got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(e),
                                   err_msg=name, **EPISODE_TOL)


@pytest.fixture(scope="module")
def reference_run(classifier):
    """(ci, stride) -> `_reference_minutes` of that AAPA episode, once."""
    @functools.lru_cache(maxsize=None)
    def run(ci, stride):
        return _reference_minutes(*_controllers(
            classifier, ci, stride_min=stride)[0], _rates())
    return run


@pytest.mark.parametrize("ci,stride", [(15, 10), (30, 10), (7, 2)])
def test_episode_matches_reference(classifier, reference_run, ci, stride):
    """All 12 MinuteOut fields and every lane's archetype after every
    minute; ci 7 runs the remainder block, stride 2 reclassifies every
    other minute."""
    want_out, want_arch = reference_run(ci, stride)
    _, (tcfg, tc) = _controllers(classifier, ci, stride_min=stride)
    got_out, got_arch = t_ref.aapa_episode_ref(torch.as_tensor(_rates()),
                                               tc, tcfg)
    _assert_minute_out(got_out, want_out)
    np.testing.assert_array_equal(got_arch.numpy(), want_arch)
    # the classifier does move lanes between archetypes here
    assert len(np.unique(want_arch)) >= 3


@pytest.mark.parametrize("history_len", [45, 90])
@pytest.mark.parametrize("policy", ["aapa", "hybrid"])
def test_episode_matches_reference_at_history_len(classifier, policy,
                                                  history_len):
    """AAPA and hybrid on a rate history of other than 60 minutes: each
    reclassification's 38 features come from a window of `history_len`
    (45: shorter than the default; 90: longer than the 64 samples one
    window_features kernel block holds, and longer than the 90-minute
    episode's history, so every window starts in the zero history). All
    12 MinuteOut fields at the episode tolerance, every lane's archetype
    after every minute exactly."""
    (rcfg, rc), (tcfg, tc) = _controllers(classifier, 15, policy=policy,
                                          history_len=history_len,
                                          stride_min=5)
    want_out, want_arch = _reference_minutes(rcfg, rc, _rates())
    got_out, got_arch = t_ref.aapa_episode_ref(torch.as_tensor(_rates()),
                                               tc, tcfg)
    _assert_minute_out(got_out, want_out)
    np.testing.assert_array_equal(got_arch.numpy(), want_arch)
    assert len(np.unique(want_arch)) >= 3


def test_make_simulator_matches_reference(classifier, reference_run):
    want_out, _ = reference_run(15, 10)
    _, (tcfg, tc) = _controllers(classifier, 15, stride_min=10)
    got = t_cluster.make_simulator(tc, tcfg, device="cpu",
                                   w_chunk=3)(_rates())
    assert got.served.shape == (W, M)
    _assert_minute_out(got, want_out)


def test_hyperparameters_match_reference(classifier):
    hyper = dict(forecast_confidence=True, horizon_min=5)
    (rcfg, rc), (tcfg, tc) = _controllers(classifier, 15, stride_min=5,
                                          **hyper)
    want = ref_cluster.make_simulator(rc, rcfg, decide_kernel=False,
                                      plant_kernel=False)(
        jnp.asarray(_rates()))
    _assert_minute_out(t_cluster.simulate(_rates(), tc, tcfg, device="cpu"),
                       want)


def test_default_classifier_matches_reference():
    rcfg, tcfg = ref_cluster.SimConfig(), t_cluster.SimConfig()
    rates = _rates()
    want = ref_cluster.make_simulator(
        ref_registry.make("aapa", rcfg), rcfg, decide_kernel=False,
        plant_kernel=False)(jnp.asarray(rates))
    ctrl = t_registry.make("aapa", tcfg)
    assert ctrl.hyper["classify"] is t_registry.default_classify
    # the episode kernel's plain version is the same simulate
    _assert_minute_out(t_ref.episode_block_ref(torch.as_tensor(rates), ctrl,
                                               tcfg), want)


def test_state_handoff_from_reference(classifier):
    """The reference runs k minutes, its SimState (AAPAState, FState,
    HWState) crosses over, and both packages continue alike."""
    (rcfg, rc), (tcfg, tc) = _controllers(classifier, 15, stride_min=2)
    rates, k = _rates()[4], M // 2

    def run(carry, rs):
        return jax.lax.scan(
            lambda c, r: ref_cluster.minute_step(rcfg, rc, c, r), carry,
            jnp.asarray(rs))

    carry0 = (ref_cluster.initial_state(rc, rcfg), jnp.int32(0))
    carry_k, _ = run(carry0, rates[:k])
    _, want = run(carry_k, rates[k:])
    state, minute = interop.from_reference(
        jax.tree.map(np.asarray, carry_k), device="cpu")
    assert isinstance(state.ctrl_state, t_policies.AAPAState)
    carry, outs = (state, minute), []
    for r in torch.as_tensor(rates[k:]):
        carry, out = t_cluster.minute_step(tcfg, tc, carry, r)
        outs.append(out)
    _assert_minute_out(
        t_cluster.MinuteOut(*(torch.stack(f) for f in zip(*outs))), want)


def test_registry_entry_and_unported_options():
    """The registry entry matches the reference's; a conformal band (once
    refused) wraps the forecaster and turns the forecast-confidence
    signal on, as in the reference."""
    cfg = t_cluster.SimConfig()
    spec = t_registry.spec("aapa")
    assert spec.needs_classifier
    assert spec.defaults == ref_registry.spec("aapa").defaults
    assert "aapa" in t_registry.available()
    band = t_conformal.ConformalBand(torch.tensor(3.0), 0.9,
                                     torch.tensor(50.0))
    ctrl = t_registry.make("aapa", cfg, band=band)
    assert ctrl.hyper["forecaster"].name == "conformal[holt_winters]"
    assert ctrl.hyper["forecast_confidence"] is True
    assert t_registry.make("aapa", cfg).hyper["forecast_confidence"] is False
    with pytest.raises(TypeError, match="no hyperparameters"):
        t_registry.make("aapa", cfg, target=0.5)
