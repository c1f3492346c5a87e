"""Every registry forecaster in the episode's pre-pass, on the CPU.

The predictive, AAPA and hybrid policies run Holt-Winters, linear trend,
seasonal naive or EWMA; the pre-pass's minute walks
(``kernels/csrc/policy_signals.cu``) take each as a template, and their
plain version is ``kernels.ref.policy_signals_ref``, which runs the
controllers' own minute hooks. Two things are held here for each policy
and forecaster:

* the split: the plain plant loop fed the precomputed signals
  (``ref.plant_pass_ref``) is the whole plain episode
  (``ref.episode_block_ref``) bit for bit, archetypes included;
* the plain episode against the JAX reference's ``simulate`` at the
  episode tolerance (rtol 3e-6 / atol 1e-4, tests/test_kernel_smoke.py).

The GBDT is trained by the reference and crosses over through its npz;
the conformal band is the reference's, carried across through
``interop``. The card's walks are held against the same plain version in
``tests/test_torch_cuda.py``.
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
from repro_torch.forecast import registry as t_fregistry
from repro_torch.kernels import policy_signals, ref
from repro_torch.scaling import registry as t_registry
from repro_torch.scaling import scenarios as t_scenarios
from repro_torch.sim import cluster as t_cluster

EPISODE_TOL = dict(rtol=3e-6, atol=1e-4)
W, M = 6, 60
NEW_FORECASTERS = ["linear_trend", "seasonal_naive", "ewma"]


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
    """(reference classify, the port's): a tiny GBDT + beta calibration
    trained by the reference, loaded by the port from its npz."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(96, 38)).astype(np.float32)
    y = rng.integers(0, 4, 96).astype(np.int32)
    params = ref_gbdt.fit(X, y, ref_gbdt.GBDTConfig(n_rounds=4, depth=3))
    cal = ref_cal.fit(np.asarray(ref_gbdt.predict_proba(
        params, jnp.asarray(X))), y)
    tr = ref_pipeline.TrainedAAPA(params, cal, 0.0, 0.0, 0.0,
                                  np.zeros(4), 96, 0.0)
    path = tmp_path_factory.mktemp("forecasters") / "classifier.npz"
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


#: case -> (policy, hyperparameters): "classify" stands for the GBDT,
#: "band" for the conformal band
CASES = {
    "predictive": ("predictive", {}),
    "predictive_conservative_band": ("predictive", dict(band=True,
                                                        conservative=True)),
    "aapa_conf": ("aapa", dict(classify=True, stride_min=5,
                               forecast_confidence=True)),
    "hybrid_band": ("hybrid", dict(classify=True, band=True)),
}


def _controllers(case, fname, fkw, classifier, bands, ci=15):
    """(reference cfg and controller, port cfg and controller) of `case`
    on the forecaster `fname` with hyperparameters `fkw`."""
    policy, kw = CASES[case]

    def hyper(side, fmake):
        out = dict(kw, forecaster=fmake(fname, **fkw))
        if out.get("classify"):
            out["classify"] = classifier[side]
        if out.get("band"):
            out["band"] = bands[side]
        return out
    rcfg = ref_cluster.SimConfig(control_interval_sec=ci)
    tcfg = t_cluster.SimConfig(control_interval_sec=ci)
    return ((rcfg, ref_registry.make(policy, rcfg,
                                     **hyper(0, ref_fregistry.make))),
            (tcfg, t_registry.make(policy, tcfg,
                                   **hyper(1, t_fregistry.make))))


REPLAYS = [(case, fname, {}, 15) for case in sorted(CASES)
           for fname in NEW_FORECASTERS] + [
    (case, fname, fkw, 7) for case in ("aapa_conf",
                                       "predictive_conservative_band")
    for fname, fkw in (("linear_trend", dict(window=45)),
                       ("seasonal_naive", dict(period=7)),
                       ("ewma", dict(alpha=0.37)))]


@pytest.mark.parametrize("case,fname,fkw,ci", REPLAYS,
                         ids=[f"{c}-{f}{'-' + str(next(iter(k.values())))
                                        if k else ''}-ci{ci}"
                              for c, f, k, ci in REPLAYS])
def test_plant_pass_replays_the_episode(classifier, bands, case, fname, fkw,
                                        ci):
    """The plant pass from `policy_signals_ref`'s signals equals the
    whole plain episode bit for bit, and so do the archetype sequences:
    the split the CUDA episode runs, pre-pass then plant pass, holds for
    every forecaster (defaults at ci 15; a window over 32, a period
    shorter than the horizon and another alpha at ci 7, the remainder
    block)."""
    _, (tcfg, tc) = _controllers(case, fname, fkw, classifier, bands, ci)
    rates = torch.as_tensor(_rates())
    sig = ref.policy_signals_ref(rates, tc, tcfg, minute_arch=True)
    got = ref.plant_pass_ref(rates, tc, tcfg, sig)
    if tc.name == "predictive":
        want = ref.episode_block_ref(rates, tc, tcfg)
    else:
        want, arch = ref.aapa_episode_ref(rates, tc, tcfg)
        assert torch.equal(sig.minute_arch, arch)
    for name, a, e in zip(t_cluster.MinuteOut._fields, got, want):
        assert torch.equal(a, e), name
    assert float(want.ups.sum()) > 0


@pytest.mark.parametrize("fname", NEW_FORECASTERS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_episode_matches_reference(classifier, bands, case, fname):
    """The plain episode under each new forecaster against the JAX
    reference's `simulate`, all 12 MinuteOut fields at the episode
    tolerance."""
    (rcfg, rc), (tcfg, tc) = _controllers(case, fname, {}, classifier,
                                          bands)
    want = ref_cluster.make_simulator(rc, rcfg, decide_kernel=False,
                                      plant_kernel=False)(
        jnp.asarray(_rates()))
    got = ref.episode_block_ref(torch.as_tensor(_rates()), tc, tcfg)
    for name, a, e in zip(t_cluster.MinuteOut._fields, got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(e),
                                   err_msg=name, **EPISODE_TOL)


@pytest.mark.parametrize("fname", t_fregistry.available())
def test_every_registry_forecaster_has_a_walk(fname):
    """`forecaster_args` turns each registry forecaster into its kernel
    kind and run-time arguments: the scratch rows its state needs, the
    f32 hyperparameters, and the band of a conformal wrap."""
    spec = t_fregistry.spec(fname)
    fa = policy_signals.forecaster_args(t_fregistry.make(fname), 15)
    assert fa.fc_i[0] == policy_signals.FORECASTERS[fname]
    slots = {"holt_winters": spec.defaults.get("period"),
             "seasonal_naive": spec.defaults.get("period"),
             "linear_trend": spec.defaults.get("window"), "ewma": 0}[fname]
    assert fa.slots == slots and len(fa.fc_f) == 13
    assert all(v == float(np.float32(v)) for v in fa.fc_f)
    assert (fa.use_band, fa.band_q) == (0, 0.0)
