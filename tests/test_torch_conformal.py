"""The port's offline forecasting path (``repro_torch.core.forecasting.
hw_smooth``, the plain version of the ``holt_winters`` kernel, and
``repro_torch.forecast.conformal`` / ``backtest``) against the JAX
reference on the CPU.

The same numpy-seeded series go through both packages. Tolerances:
Holt-Winters forecasts at the reference's kernel tolerance, rtol 1e-4 /
atol 1e-3 (tests/test_kernel_properties.py; XLA contracts some of the
recurrences' products into their adds, the port does not); the conformal
quantile at the same tolerance (an order statistic moves by at most the
largest residual difference); the calibration split's mean |y| at rtol
1e-5 (the port sums it in f64); coverage within 2/n.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import forecasting as ref_fc
from repro.data import azure_synth as ref_synth
from repro.forecast import backtest as ref_backtest
from repro.forecast import conformal as ref_conformal
from repro.forecast import registry as ref_registry
from repro.kernels import ops as ref_ops
from repro_torch import interop
from repro_torch.core import forecasting as t_fc
from repro_torch.core.archetypes import Archetype
from repro_torch.data import azure_synth as t_synth
from repro_torch.forecast import backtest as t_backtest
from repro_torch.forecast import conformal as t_conformal
from repro_torch.forecast import registry as t_registry
from repro_torch.kernels import ops, ref

HW_TOL = dict(rtol=1e-4, atol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seasonal(rng, b, t, period):
    x = np.arange(t)
    y = (200 + 150 * np.sin(2 * np.pi * x / period)[None, :]
         + rng.gamma(2.0, 20.0, (b, t)))
    y[0, t // 2:] += 400.0                          # a level shift
    return y.astype(np.float32)


@pytest.mark.parametrize("b,t,period,alpha", [
    (1, 40, 3, 0.1), (5, 300, 60, 0.1), (13, 97, 7, 0.37),
    (8, 150, 24, 0.33), (3, 61, 60, 0.37), (4, 200, 12, 0.33)])
def test_hw_smooth_matches_reference_and_its_kernel(b, t, period, alpha):
    """The plain version against the reference's oracle and its Pallas
    kernel in interpret mode, at the paper's alpha and at 0.37 and 0.33;
    at 0.33 f32(1) - f32(alpha) (hw_smooth's) and f32(1 - alpha)
    (hw_step's, and the Pallas kernel's) differ."""
    y = _seasonal(np.random.default_rng(b * 100 + t), b, t, period)
    got = t_fc.hw_smooth(torch.as_tensor(y), period=period,
                         alpha=alpha).numpy()
    want = np.asarray(ref_fc.hw_smooth(jnp.asarray(y), period=period,
                                       alpha=alpha))
    np.testing.assert_allclose(got, want, **HW_TOL)
    pallas = np.asarray(ref_ops.holt_winters(
        jnp.asarray(y), period=period, alpha=alpha, interpret=True))
    np.testing.assert_allclose(got, pallas, **HW_TOL)
    assert got.shape == (b, t)


def test_hw_smooth_takes_its_coefficients_as_f32():
    """hw_smooth's 1 - alpha is an f32 subtraction, not f32(1 - alpha)."""
    a, b, g, oa, ob, og = t_fc.smooth_coeffs(0.33, 0.01, 0.3)
    assert oa == float(np.float32(1) - np.float32(0.33))
    assert oa != float(np.float32(1 - 0.33))
    assert (a, b, g) == tuple(float(np.float32(v)) for v in (0.33, 0.01,
                                                              0.3))


def test_holt_winters_cpu_dispatch_is_the_plain_version():
    y = torch.as_tensor(_seasonal(np.random.default_rng(1), 4, 90, 24))
    ops.reset_launch_counts()
    got = ops.holt_winters(y, period=24)
    assert torch.equal(got, ref.holt_winters_ref(y, period=24))
    assert torch.equal(
        t_registry.make("holt_winters", period=24).smooth(y), got)
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCHERS, 0)


@pytest.fixture(scope="module")
def split():
    """(calibration split [12, 360], held-out split [12, 360]) of seeded
    periodic Azure-like counts."""
    tr = t_synth.generate_traces(n_functions=12, n_days=1, seed=3)
    y = tr.counts.astype(np.float32)
    return y[:, :360], y[:, 360:720]


@pytest.mark.parametrize("name", ["holt_winters", "ewma"])
@pytest.mark.parametrize("alpha", [0.5, 0.9])
def test_calibrate_coverage_wrap_confidence_match_reference(split, name,
                                                            alpha):
    calib, test = split
    rf, tf = ref_registry.make(name), t_registry.make(name)
    rband = ref_conformal.calibrate(rf, jnp.asarray(calib), alpha=alpha)
    tband = t_conformal.calibrate(tf, calib, alpha=alpha, device="cpu")
    np.testing.assert_allclose(float(tband.q), float(rband.q), **HW_TOL)
    assert tband.q.untyped_storage().nbytes() == 4    # not a view of all
    np.testing.assert_allclose(float(tband.scale), float(rband.scale),
                               rtol=1e-5)
    assert tband.alpha == rband.alpha
    n = test.shape[0] * (test.shape[1] - t_conformal.DEFAULT_BURN_IN)
    got = t_conformal.coverage(tf, tband, test, device="cpu")
    want = ref_conformal.coverage(rf, rband, jnp.asarray(test))
    assert abs(got - want) <= 2.0 / n
    np.testing.assert_allclose(float(t_conformal.confidence(tband)),
                               float(ref_conformal.confidence(rband)),
                               rtol=1e-4)
    # the wrapped forecaster: same point, band half-width q * sqrt(h)
    rw, tw = ref_conformal.wrap(rf, rband), t_conformal.wrap(tf, tband)
    assert tw.name == rw.name == f"conformal[{name}]"
    assert tw.hyper["inner"] is tf and tw.hyper["band"] is tband

    def ref_run(series):
        def body(st, v):
            st = rw.update(st, v)
            return st, jnp.stack(rw.forecast(st, 9))
        return jax.lax.scan(body, rw.init(), series)[1]

    want = np.asarray(jax.jit(jax.vmap(ref_run))(jnp.asarray(test[:, :90])))
    st, got = tw.init((test.shape[0],), "cpu"), []
    for k in range(90):
        st = tw.update(st, torch.as_tensor(test[:, k]))
        got.append(torch.stack(tw.forecast(st, 9), -1))
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), want, **HW_TOL)


def test_reference_band_carries_across(split):
    calib, _ = split
    rband = ref_conformal.calibrate(ref_registry.make("holt_winters"),
                                    jnp.asarray(calib), alpha=0.9)
    band = interop.from_reference(jax.tree.map(np.asarray, rband),
                                  device="cpu")
    assert isinstance(band, t_conformal.ConformalBand)
    assert band.alpha == 0.9 and isinstance(band.alpha, float)
    assert float(band.q) == float(rband.q)
    assert float(band.scale) == float(rband.scale)


def test_calibrate_rejects_a_split_shorter_than_burn_in():
    with pytest.raises(ValueError, match="burn_in"):
        t_conformal.calibrate(t_registry.make("ewma"), np.ones((2, 50)),
                              device="cpu")


@pytest.fixture(scope="module")
def stationary_traces():
    traces = t_synth.generate_traces(
        n_functions=12, n_days=1, seed=99,
        mix={Archetype.STATIONARY_NOISY: 1.0})
    want = ref_synth.generate_traces(
        n_functions=12, n_days=1, seed=99,
        mix={ref_synth.Archetype.STATIONARY_NOISY: 1.0})
    np.testing.assert_array_equal(traces.counts, want.counts)
    return traces.counts          # [12, 1440]


@pytest.mark.parametrize("alpha", [0.8, 0.9, 0.95])
def test_conformal_coverage_near_nominal(stationary_traces, alpha):
    """Port of the reference's coverage test: split-conformal bands hit
    their nominal coverage within +-5 points on held-out halves of
    stationary Azure-like traces."""
    f = t_registry.make("ewma")
    band = t_conformal.calibrate(f, stationary_traces[:, :720],
                                 alpha=alpha, device="cpu")
    cov = t_conformal.coverage(f, band, stationary_traces[:, 720:],
                               device="cpu")
    assert abs(cov - alpha) <= 0.05, (cov, alpha)


FORECASTERS = ["holt_winters", "linear_trend", "seasonal_naive", "ewma"]


@pytest.fixture(scope="module")
def series():
    rng = np.random.default_rng(9)
    y = _seasonal(rng, 5, 150, 60)
    y[1] = rng.poisson(2.0, 150)                    # sparse counts
    y[2] = np.maximum(300.0 - 4.0 * np.arange(150), 0.0)   # ramp to 0
    return y


def test_batch_and_stream_smooth_match_reference(series):
    """Every forecaster's streaming backtest against the reference's
    batched one, and lane f of the port's batch equal to its stream bit
    for bit; Holt-Winters' stream clamps at 0 where its `smooth` (the
    kernel path) does not, as in the reference."""
    want = np.asarray(ref_backtest.batch_smooth(FORECASTERS,
                                                jnp.asarray(series)))
    got = t_backtest.batch_smooth(FORECASTERS, series, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, **HW_TOL)
    for f, name in enumerate(FORECASTERS):
        stream = t_backtest.stream_smooth(name, series, device="cpu")
        assert torch.equal(stream, got[f])
        np.testing.assert_allclose(
            stream.numpy(), np.asarray(ref_backtest.stream_smooth(
                name, jnp.asarray(series))), **HW_TOL)
    smooth = t_registry.make("holt_winters").smooth(torch.as_tensor(series))
    assert (got[0] >= 0).all() and (smooth < 0).any()


@pytest.mark.parametrize("b_chunk", [2, 3, 5, 8])
def test_chunked_batch_smooth_is_bitwise_the_whole(series, b_chunk):
    whole = t_backtest.batch_smooth(FORECASTERS, series, device="cpu")
    chunked = t_backtest.batch_smooth(FORECASTERS, series, b_chunk=b_chunk,
                                      device="cpu")
    assert torch.equal(chunked, whole)
    with pytest.raises(ValueError, match="positive"):
        t_backtest.batch_smooth(FORECASTERS, series, b_chunk=0,
                                device="cpu")
