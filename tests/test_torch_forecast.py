"""The port's forecasters, Table III and Algorithm 1 (``repro_torch.core``
``forecasting``, ``archetypes``, ``uncertainty`` and
``repro_torch.forecast``) against the JAX reference on the CPU.

The same numpy-seeded series go through both packages, one lane per
series in the port and ``vmap`` in the reference. Tolerance: the
reference's own for Holt-Winters recurrences, rtol 1e-4 / atol 1e-3
(tests/test_kernel_properties.py); XLA contracts some of the
recurrences' products into their adds, so the two are not bitwise equal
everywhere (ROADMAP §C), and the band's lower edge `point - half`
cancels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import archetypes as ref_arch
from repro.core import forecasting as ref_fc
from repro.core import uncertainty as ref_unc
from repro.forecast import api as ref_api
from repro.forecast import registry as ref_registry
from repro_torch import interop
from repro_torch.core import archetypes as t_arch
from repro_torch.core import forecasting as t_fc
from repro_torch.core import uncertainty as t_unc
from repro_torch.forecast import api as t_api
from repro_torch.forecast import registry as t_registry

TOL = dict(rtol=1e-4, atol=1e-3)
LANES, STEPS = 6, 100


@pytest.fixture(scope="module")
def series():
    rng = np.random.default_rng(5)
    t = np.arange(STEPS)
    y = (200 + 150 * np.sin(2 * np.pi * t / 60)[None, :]
         + rng.gamma(2.0, 20.0, (LANES, STEPS)))
    y[1] = rng.poisson(3.0, STEPS)                  # sparse counts
    y[2, 40:] += np.arange(STEPS - 40) * 5.0         # ramp
    y[3] = 0.0
    return y.astype(np.float32)


def _ref_scan(update, out_fn, init, ys):
    def one(series):
        def body(st, y):
            st = update(st, y)
            return st, out_fn(st)
        return jax.lax.scan(body, init, series)[1]
    return np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(ys)))


def test_hw_step_and_forecasts(series):
    def outs(st):
        return jnp.stack([st.level, st.trend, ref_fc.hw_forecast(st, 7),
                          ref_fc.hw_forecast_max(st, 15)])
    want = _ref_scan(lambda st, y: ref_fc.hw_step(st, y), outs,
                     ref_fc.hw_init(60), series)
    st = t_fc.hw_init(60, lanes=(LANES,), device="cpu")
    got = []
    for k in range(STEPS):
        st = t_fc.hw_step(st, torch.as_tensor(series[:, k]))
        got.append(torch.stack([st.level, st.trend, t_fc.hw_forecast(st, 7),
                                t_fc.hw_forecast_max(st, 15)], -1))
    got = torch.stack(got, 1).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert st.t.dtype == torch.int32 and int(st.t[0]) == STEPS


@pytest.mark.parametrize("n", [30, 15])
def test_linear_trend_forecast(series, n):
    hist = np.stack([series[:, k:k + n] for k in range(0, STEPS - n, 7)], 1)
    want = np.asarray(jax.jit(lambda h: ref_fc.linear_trend_forecast(
        h, 15))(jnp.asarray(hist)))
    got = t_fc.linear_trend_forecast(torch.as_tensor(hist), 15).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["holt_winters", "linear_trend",
                                  "seasonal_naive", "ewma"])
def test_forecaster_update_and_forecast(series, name):
    ref, port = ref_registry.make(name), t_registry.make(name)

    def outs(st):
        iv = ref.forecast(st, 15)
        return jnp.stack([iv.point, iv.lo, iv.hi, st.resid,
                          ref_api.interval_confidence(iv)])
    want = _ref_scan(ref.update, outs, ref.init(), series)
    st = port.init((LANES,), device="cpu")
    got = []
    for k in range(STEPS):
        st = port.update(st, torch.as_tensor(series[:, k]))
        iv = port.forecast(st, 15)
        got.append(torch.stack([iv.point, iv.lo, iv.hi, st.resid,
                                t_api.interval_confidence(iv)], -1))
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), want, **TOL)


@pytest.mark.parametrize("name", ["linear_trend", "ewma"])
def test_smooth_matches_reference(series, name):
    want = np.asarray(ref_registry.make(name).smooth(jnp.asarray(series)))
    got = t_registry.make(name).smooth(torch.as_tensor(series)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_holt_winters_smooth_waits_for_its_kernel(series):
    """Once a NotImplementedError, now the holt_winters kernel's path: on a
    CPU tensor the plain `hw_smooth`, against the reference's smooth."""
    want = np.asarray(ref_registry.make("holt_winters").smooth(
        jnp.asarray(series)))
    got = t_registry.make("holt_winters").smooth(torch.as_tensor(series))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_registry_defaults_and_archetype_map():
    assert t_registry.available() == ref_registry.available()
    for name in t_registry.available():
        assert t_registry.spec(name).defaults == ref_registry.spec(
            name).defaults
    for a in t_arch.Archetype:
        assert t_registry.for_archetype(a) == ref_registry.for_archetype(
            int(a))
    fc = t_registry.make("holt_winters", period=24)
    assert fc.hyper == dict(period=24, alpha=0.1, beta=0.01, gamma=0.3)
    with pytest.raises(TypeError, match="no hyperparameters"):
        t_registry.make("ewma", period=3)


def test_table_iii_and_adjust():
    want = ref_arch.table_iii_arrays()
    got = t_arch.table_iii_arrays()
    for k in want:
        np.testing.assert_array_equal(np.float32(got[k]),
                                      np.asarray(want[k]))
    conf = np.linspace(-0.1, 1.1, 25).astype(np.float32)
    for a in range(4):
        args = [want[k][a] for k in ("target_cpu", "cooldown_min",
                                     "min_replicas")]
        ref = ref_unc.adjust(jnp.asarray(conf), *args)
        port = t_unc.adjust(torch.as_tensor(conf), *(float(v) for v in args))
        for g, e in zip(port, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-7)
    np.testing.assert_allclose(
        t_unc.margin_multiplier(torch.as_tensor(conf)).numpy(),
        np.asarray(ref_unc.margin_multiplier(jnp.asarray(conf))), rtol=0)


def test_forecaster_state_from_reference(series):
    """A reference FState over an HWState crosses over and both packages
    go on to the same forecasts."""
    ref, port = ref_registry.make("holt_winters"), t_registry.make(
        "holt_winters")
    st = jax.vmap(lambda s: jax.lax.scan(
        lambda c, y: (ref.update(c, y), None), ref.init(), s)[0])(
        jnp.asarray(series[:, :70]))
    ported = interop.from_reference(jax.tree.map(np.asarray, st),
                                    device="cpu")
    assert isinstance(ported, t_api.FState)
    assert isinstance(ported.inner, t_fc.HWState)
    for k in range(70, 90):
        st = jax.vmap(ref.update)(st, jnp.asarray(series[:, k]))
        ported = port.update(ported, torch.as_tensor(series[:, k]))
    np.testing.assert_allclose(port.forecast(ported, 15).point.numpy(),
                               np.asarray(jax.vmap(
                                   lambda s: ref.forecast(s, 15).point)(st)),
                               **TOL)
