"""The episode's pre-pass (``kernels.ref.policy_signals_ref``, the plain
version of the ``policy_signals`` kernels) against the JAX reference's
minute hooks on the CPU, and the split of an episode into that pre-pass
and a plant pass (``kernels.ref.plant_pass_ref``) against the whole plain
episode.

The reference controller's ``on_minute`` runs over the same zero-padded
60-minute history windows the simulator hands it, minute by minute; what
its decide then reads of the hook's state (the forecast peak through
``explain``, the 30-minute trend, the 15-minute mean, the predictive
policy's forecast need) and its archetype and Algorithm 1 parameters are
the signals. Archetypes are held exactly, the floats at the episode
tolerance (rtol 3e-6 / atol 1e-4, tests/test_kernel_smoke.py). The GBDT is
trained by the reference and crosses over through its npz; the conformal
band is the reference's, carried across through ``interop``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as ref_cal
from repro.core import forecasting as ref_forecasting
from repro.core import gbdt as ref_gbdt
from repro.core import pipeline as ref_pipeline
from repro.forecast import conformal as ref_conformal
from repro.forecast import registry as ref_fregistry
from repro.scaling import registry as ref_registry
from repro.sim import cluster as ref_cluster
from repro_torch import interop
from repro_torch.kernels import ops, policy_signals, ref
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


@functools.lru_cache(maxsize=None)
def _rates():
    return t_scenarios.archetype_mix(n_workloads=W, minutes=M, seed=0).rates


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
    path = tmp_path_factory.mktemp("signals") / "classifier.npz"
    tr.save(path)
    return (tr.make_classify(),
            interop.trained_from_reference(path, device="cpu")
            .make_classify())


@pytest.fixture(scope="module")
def bands():
    """(reference ConformalBand, the port's) of Holt-Winters at 0.9."""
    split = t_scenarios.burst_storm(n_workloads=16, minutes=240,
                                    seed=1).rates
    rband = ref_conformal.calibrate(ref_fregistry.make("holt_winters"),
                                    jnp.asarray(split), alpha=0.9)
    return rband, interop.from_reference(jax.tree.map(np.asarray, rband),
                                         device="cpu")


def _controllers(policy, kw, classifier, bands, ci=15, history_len=60):
    """(reference cfg and controller, port cfg and controller); in `kw`,
    classify=True stands for the GBDT and band=True for the band. The
    reference side of hybrid is AAPA: hybrid's minute hook is AAPA's."""
    def hyper(side):
        out = dict(kw)
        if out.get("classify"):
            out["classify"] = classifier[side]
        if out.get("band"):
            out["band"] = bands[side]
        return out
    rcfg = ref_cluster.SimConfig(control_interval_sec=ci,
                                 history_len=history_len)
    tcfg = t_cluster.SimConfig(control_interval_sec=ci,
                               history_len=history_len)
    rname = "aapa" if policy == "hybrid" else policy
    return ((rcfg, ref_registry.make(rname, rcfg, **hyper(0))),
            (tcfg, t_registry.make(policy, tcfg, **hyper(1))))


def _reference_signals(ctrl, rates, kind, inv_cap=None, history_len=60):
    """The reference controller's minute hook over each lane's zero-padded
    `history_len`-minute windows: per minute m (0: the initial state, m: after the
    hook at minute m), the signals decide reads and, for AAPA, the
    archetype and Algorithm 1's parameters. Returns numpy arrays [W, M + 1]
    (floats [W, M + 1, K])."""
    horizon = 15

    def signals(st, hist):
        ex = ctrl.explain(st, None)
        if kind == "predictive":
            need = jnp.maximum(ex.fc_hi if inv_cap[1] else ex.fc_point,
                               0.0) / 60.0 * inv_cap[0]
            return jnp.stack([need]), jnp.int32(0), jnp.zeros(3)
        fc = jnp.maximum(ex.fc_point, 0.0) / 60.0
        trend = ref_forecasting.linear_trend_forecast(hist[-30:],
                                                      horizon) / 60.0
        mean = jnp.mean(hist[-15:]) / 60.0
        return (jnp.stack([fc, trend, mean]), st.arch,
                jnp.stack([st.cpu_adj, st.cool_adj_min, st.minrep_adj]))

    def lane(r):
        def body(carry, rate):
            st, hist, m = carry
            hist = jnp.concatenate([hist[1:], rate[None]])
            st = ctrl.on_minute(st, hist, m + 1)
            return (st, hist, m + 1), signals(st, hist)
        st0, hist0 = ctrl.init(), jnp.zeros(history_len, jnp.float32)
        first = signals(st0, hist0)
        rest = jax.lax.scan(body, (st0, hist0, jnp.int32(0)), r)[1]
        return tuple(jnp.concatenate([f[None], g]) for f, g in
                     zip(first, rest))
    return [np.asarray(x) for x in jax.jit(jax.vmap(lane))(
        jnp.asarray(rates))]


def _assert_close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **EPISODE_TOL)


@pytest.mark.parametrize("policy,kw", [
    ("aapa", dict(classify=True, stride_min=10)),
    ("aapa", dict(classify=True, stride_min=2)),
    ("aapa", dict(classify=True, stride_min=10, forecast_confidence=True)),
    ("aapa", dict(classify=True, stride_min=2, forecast_confidence=True)),
    ("aapa", {}),
    ("aapa", dict(classify=True, band=True)),
    ("hybrid", dict(classify=True, band=True, stride_min=5))],
    ids=["gbdt_s10", "gbdt_s2", "gbdt_s10_conf", "gbdt_s2_conf", "default",
         "band", "hybrid_band"])
def test_archetype_signals_match_reference(classifier, bands, policy, kw):
    """AAPA's and hybrid's signals: per minute fc_rps, trend_rps and
    mean_rps, per reclassification slot the archetype (exact) and
    Algorithm 1's parameters, and the archetype after every minute
    (exact)."""
    (_, rc), (tcfg, tc) = _controllers(policy, kw, classifier, bands)
    rps, arch, adj = _reference_signals(rc, _rates(), "aapa")
    sig = ref.policy_signals_ref(torch.as_tensor(_rates()), tc, tcfg,
                                 minute_arch=True)
    stride = tc.hyper["stride_min"]
    R = policy_signals.n_slots(M, stride)
    assert sig.rps.shape == (3, M, W) and sig.arch.shape == (R, W)
    assert sig.adj.shape == (3, R, W) and sig.minute_arch.shape == (W, M)
    # minute m's signals are those after the hook at minute m
    _assert_close(sig.rps.permute(2, 1, 0), rps[:, :M], "rps")
    at = np.arange(R) * stride               # the hook of each slot
    np.testing.assert_array_equal(sig.arch.T.numpy(), arch[:, at])
    _assert_close(sig.adj.permute(2, 1, 0), adj[:, at], "adj")
    np.testing.assert_array_equal(sig.minute_arch.numpy(), arch[:, 1:])
    if kw.get("classify"):
        assert len(np.unique(arch)) >= 3


@pytest.mark.parametrize("policy", ["aapa", "hybrid"])
def test_archetype_signals_match_reference_at_history_len_90(
        classifier, bands, policy):
    """The pre-pass's plain version on a 90-minute rate history (the
    reclassification windows the wide window_features kernel takes on the
    card): every signal, slot and per-minute archetype, as above."""
    kw = dict(classify=True, stride_min=5, forecast_confidence=True)
    if policy == "hybrid":
        kw["band"] = True
    (_, rc), (tcfg, tc) = _controllers(policy, kw, classifier, bands,
                                       history_len=90)
    rps, arch, adj = _reference_signals(rc, _rates(), "aapa",
                                        history_len=90)
    sig = ref.policy_signals_ref(torch.as_tensor(_rates()), tc, tcfg,
                                 minute_arch=True)
    at = np.arange(policy_signals.n_slots(M, 5)) * 5
    _assert_close(sig.rps.permute(2, 1, 0), rps[:, :M], "rps")
    np.testing.assert_array_equal(sig.arch.T.numpy(), arch[:, at])
    _assert_close(sig.adj.permute(2, 1, 0), adj[:, at], "adj")
    np.testing.assert_array_equal(sig.minute_arch.numpy(), arch[:, 1:])
    assert len(np.unique(arch)) >= 3


@pytest.mark.parametrize("conservative", [False, True],
                         ids=["native", "conservative_band"])
def test_predictive_signals_match_reference(bands, conservative):
    """The predictive policy's forecast need, minute 0 from the
    forecaster's init: native, and conservative with the band."""
    kw = dict(band=True, conservative=True) if conservative else {}
    (_, rc), (tcfg, tc) = _controllers("predictive", kw, None, bands)
    inv_cap = (1.0 / (tcfg.rps_per_replica * 0.70), conservative)
    need, _, _ = _reference_signals(rc, _rates(), "predictive", inv_cap)
    sig = ref.policy_signals_ref(torch.as_tensor(_rates()), tc, tcfg)
    assert sig.rps.shape == (1, M, W) and sig.arch is None
    _assert_close(sig.rps[0].T, need[:, :M, 0], "need_pred")


@pytest.mark.parametrize("ci", [15, 30, 7])
@pytest.mark.parametrize("policy,kw", [
    ("aapa", dict(classify=True, stride_min=2, forecast_confidence=True)),
    ("hybrid", dict(classify=True, band=True)),
    ("predictive", dict(band=True, conservative=True)),
    ("hpa", {})], ids=["aapa", "hybrid_band", "predictive_band", "hpa"])
def test_plant_pass_replays_the_episode(classifier, bands, policy, kw, ci):
    """The plain plant loop fed the precomputed signals is the plain
    episode bit for bit (HPA: no signals at all); this is the split the
    CUDA episode runs, pre-pass then plant pass."""
    _, (tcfg, tc) = _controllers(policy, kw, classifier, bands, ci)
    rates = torch.as_tensor(_rates())
    sig = (ref.policy_signals_ref(rates, tc, tcfg)
           if policy in policy_signals.POLICIES else None)
    got = ref.plant_pass_ref(rates, tc, tcfg, sig)
    want = ref.episode_block_ref(rates, tc, tcfg)
    for name, a, e in zip(t_cluster.MinuteOut._fields, got, want):
        assert torch.equal(a, e), name


def test_policy_signals_dispatch_and_refusals(classifier, bands):
    """`ops.policy_signals` runs the plain version for CPU tensors and
    launches no kernel; the kernel wrappers refuse CPU tensors and the
    policies without a pre-pass."""
    _, (tcfg, tc) = _controllers("hybrid", dict(classify=True, band=True),
                                 classifier, bands)
    rates = torch.as_tensor(_rates()[:, :30])
    ops.reset_launch_counts()
    got = ops.policy_signals(rates, tc, tcfg)
    want = ref.policy_signals_ref(rates, tc, tcfg)
    for a, e in zip(got, want):
        assert (a is None and e is None) or torch.equal(a, e)
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCHERS, 0)
    with pytest.raises(ValueError, match="CUDA"):
        policy_signals.policy_signals_cuda(rates, tc, tcfg)
    hpa = t_registry.make("hpa", tcfg)
    with pytest.raises(ValueError, match="no pre-pass"):
        ref.policy_signals_ref(rates, hpa, tcfg)
    from repro_torch.kernels import episode_block
    with pytest.raises(ValueError, match="CUDA"):
        episode_block.plant_pass_cuda(rates, hpa, tcfg, None)
