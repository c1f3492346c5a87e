"""The port's window features (``repro_torch.core.features``, the plain
version of the ``window_features`` kernel) against the JAX reference
(``repro.core.features``) on the CPU.

Tolerances: the 28 stat/time features at the reference's kernel
tolerance, rtol/atol 5e-4 (tests/test_kernel_smoke.py); the 10 frequency
features at rtol 1e-4 / atol 1e-5 (XLA contracts some of their products
into adds, the port does not). The power spectrum itself is the
reference's bit for bit: the port runs the real FFT that ``jnp.fft.rfft``
runs on the CPU (ducc0's radix passes) and XLA's complex abs, op for op.
So the quantized features (multiples of 1/60 or 1/30) are bitwise equal
everywhere, `dominant_freq` included where the exact spectrum is flat
(one spike on a constant background) or zero up to the mean's rounding
(a constant window whose f32 mean is not exact): there both packages
pick the argmax of the same rounding noise. One standing difference: at
widths with a large prime factor (211, 223, ...), ducc0 runs Bluestein's
algorithm, which the port's radix passes do not repeat; there the
spectrum is bounded, not bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as ref_features
from repro.data import azure_synth as ref_synth
from repro.data import windows as ref_windows
from repro.kernels import window_features as ref_wf_kernel
from repro_torch import _numerics
from repro_torch.core import features as t_features
from repro_torch.data import azure_synth as t_synth
from repro_torch.data import windows as t_windows
from repro_torch.kernels import ops

STAT_TOL = dict(rtol=5e-4, atol=5e-4)
FREQ_TOL = dict(rtol=1e-4, atol=1e-5)
QUANTIZED = [t_features.FEATURE_NAMES.index(n) for n in t_features.QUANTIZED]
DOMINANT = t_features.FEATURE_NAMES.index("dominant_freq")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _special_windows():
    """zero, constant (exact and inexact f32 mean), ramp, a spike on a
    noisy background, and single spikes on a flat one."""
    rng = np.random.default_rng(42)
    x = rng.gamma(2.0, 10.0, size=(9, 60)).astype(np.float32)
    x[0] = 0.0                       # all-zero window
    x[1] = 1.0                       # constant, mean exact in f32
    x[2] = 5.0                       # constant, f32 mean 5 + 1 ulp
    x[3] = np.arange(60)             # ramp
    x[4, 30] = 1e5                   # spike outlier on gamma noise
    x[5] = 0.0
    x[5, 30] = 100.0                 # one spike on zeros
    x[6] = 0.0
    x[6, 7] = 3.0
    x[7] = 20.0
    x[7, 50] = 90.0                  # one spike on a constant
    return x


#: windows of `_special_windows` whose spectrum ties in exact arithmetic
TIED = (2, 5, 6, 7)


@pytest.fixture(scope="module")
def windows():
    ds = t_windows.make_windows(t_synth.generate_traces(n_functions=12,
                                                        n_days=2, seed=0))
    rng = np.random.default_rng(7)
    noise = rng.gamma(2.0, 10.0, size=(200, 60)).astype(np.float32)
    return np.concatenate([_special_windows(), noise, ds.windows[:600]])


@pytest.fixture(scope="module")
def reference(windows):
    return np.asarray(jax.jit(ref_features.extract_features)(
        jnp.asarray(windows)))


@pytest.fixture(scope="module")
def port(windows):
    return t_features.extract_features(torch.as_tensor(windows)).numpy()


def test_make_windows_matches_reference():
    t = t_windows.make_windows(t_synth.generate_traces(n_functions=12,
                                                       n_days=2, seed=0))
    r = ref_windows.make_windows(ref_synth.generate_traces(n_functions=12,
                                                           n_days=2, seed=0))
    for field in ("windows", "func_id", "start_min", "pattern"):
        np.testing.assert_array_equal(getattr(t, field), getattr(r, field))
    np.testing.assert_array_equal(t.day(), r.day())
    for name, mask in t_windows.default_day_split(t, 2).items():
        np.testing.assert_array_equal(
            mask, ref_windows.default_day_split(r, 2)[name], err_msg=name)


def test_stat_time_features_match_reference(reference, port):
    got, want = port[:, :28], reference[:, :28]
    for k, name in enumerate(t_features.STAT_TIME_NAMES):
        np.testing.assert_allclose(got[:, k], want[:, k], err_msg=name,
                                   **STAT_TOL)


def test_freq_features_match_reference(reference, port):
    got, want = port[:, 28:], reference[:, 28:]
    for k, name in enumerate(t_features.FREQ_NAMES):
        if 28 + k in QUANTIZED:
            continue
        np.testing.assert_allclose(got[:, k], want[:, k], err_msg=name,
                                   **FREQ_TOL)


def test_quantized_features_bitwise(reference, port):
    for k in QUANTIZED:
        np.testing.assert_array_equal(
            port[:, k], reference[:, k],
            err_msg=t_features.FEATURE_NAMES[k])


def test_tied_spectra_dominant_freq_differs(windows, reference, port):
    """Once a documented difference (ROADMAP §C), now an equality: on a
    flat or rounding-only spectrum both packages pick the dominant bin
    from rounding noise, and since the port's spectrum is the
    reference's bit for bit, they pick the same bin."""
    tied = list(TIED)
    power = t_features.power_spectrum(torch.as_tensor(windows[tied]))
    assert float(power[0].amax()) < 1e-18          # constant 5: noise only
    flat = power[1:]
    spread = (flat.amax(-1) - flat.amin(-1)) / flat.amax(-1)
    assert float(spread.max()) < 1e-5
    np.testing.assert_array_equal(
        reference[tied, DOMINANT],
        np.float32([0, 4, 3, 0]) * np.float32(_numerics.recip(30)))
    np.testing.assert_array_equal(port[tied, DOMINANT],
                                  reference[tied, DOMINANT])


def test_extract_features_leading_dims_and_ops(windows, port):
    x = torch.as_tensor(windows[:12]).reshape(2, 6, 60)
    got = t_features.extract_features(x)
    assert got.shape == (2, 6, 38)
    assert torch.equal(got.reshape(12, 38), torch.as_tensor(port[:12]))
    fused = ops.extract_features_fused(torch.as_tensor(windows[:12]))
    assert torch.equal(fused, torch.as_tensor(port[:12]))
    assert torch.equal(ops.window_features(torch.as_tensor(windows[:12])),
                       torch.as_tensor(port[:12, :28]))


@pytest.mark.parametrize("n", [1, 7, 30, 32, 33, 45, 58, 59, 60, 64, 100,
                               120, 240, 1000, 1024])
def test_xla_sum_is_xla_order(n):
    """The port's summation order is XLA CPU's, bit for bit."""
    rng = np.random.default_rng(n)
    v = rng.gamma(2.0, 10.0, size=(500, n)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=-1))(
        jnp.asarray(v)))
    got = _numerics.xla_sum(torch.as_tensor(v)).numpy()
    np.testing.assert_array_equal(got, want)


def _reference_power(x):
    return np.asarray(jax.jit(lambda w: jnp.abs(jnp.fft.rfft(
        w - jnp.mean(w, axis=-1, keepdims=True), axis=-1)) ** 2)(
            jnp.asarray(x)))[:, 1:]


def _spectrum_windows(n):
    """Random gamma windows of n, the tied windows of TIED at n, all-zero
    and constant ones."""
    rng = np.random.default_rng(n)
    x = rng.gamma(2.0, 30.0, size=(300, n)).astype(np.float32)
    x[:6] = [[0.0], [5.0], [0.0], [0.0], [20.0], [7.0]]
    x[2, n // 2] = 100.0                 # the tied windows of TIED, at n
    x[3, min(7, n - 1)] = 3.0
    x[4, n - 3] = 90.0
    return x


@pytest.mark.parametrize(
    "n", [60, 45, 64, 50, 32, 27, 12, 5, 4, 7, 14, 21, 28, 49, 61, 63,
          65, 72, 90, 120, 127, 240, 360, 720, 1024])
def test_power_spectrum_is_the_reference_bitwise(n):
    """The port's |rfft|^2 against the reference's on random gamma
    windows, the tied windows, all-zero and constant ones; the
    radix-2, 3, 4 and 5 passes and the generic odd-factor pass (7, 49 =
    7 x 7 with twiddles, the primes 61 and 127), alone and after the
    others, up to the widest window the port takes (1,024: five radix-4
    passes)."""
    x = _spectrum_windows(n)
    got = t_features.power_spectrum(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, _reference_power(x))


@pytest.mark.parametrize("n", [211, 223])
def test_bluestein_widths_are_bounded(n):
    """A standing difference: at a width with a large prime factor ducc0
    takes Bluestein's algorithm, not the radix passes the port repeats
    (its generic pass over the prime), so the spectra differ in the last
    bits: by about 1e-6 of the window's largest bin here. The 38 features
    stay at the reference's kernel tolerance, 5e-4, and every quantized
    feature is exact."""
    x = _spectrum_windows(n)[6:]           # no tied spectra: see TIED
    got = t_features.power_spectrum(torch.as_tensor(x)).numpy()
    want = _reference_power(x)
    assert not np.array_equal(got, want)
    scale = want.max(-1, keepdims=True)
    assert float((np.abs(got - want) / scale).max()) < 4e-6
    feats = t_features.extract_features(torch.as_tensor(x)).numpy()
    ref = np.asarray(jax.jit(ref_features.extract_features)(jnp.asarray(x)))
    np.testing.assert_allclose(feats, ref, **STAT_TOL)
    np.testing.assert_array_equal(feats[:, QUANTIZED], ref[:, QUANTIZED])


@pytest.mark.parametrize("w", range(65, 97))
def test_window_features_match_reference_kernel_past_64(w):
    """The plain version of the ``window_features`` kernel against the
    reference's Pallas kernel (interpret mode), whose windows are padded
    to the next multiple of 64 lanes: the 28 features at every width from
    65 to 96, on gamma windows, all-zero and constant ones and a spike;
    quantized features exact, the rest at the reference's 5e-4."""
    rng = np.random.default_rng(w)
    x = rng.gamma(2.0, 10.0, size=(40, w)).astype(np.float32)
    x[0] = 0.0
    x[1] = 5.0
    x[2, w // 2] = 1e5
    want = np.asarray(ref_wf_kernel.window_features_kernel(
        jnp.asarray(x), tile_n=40, interpret=True))
    got = ops.window_features(torch.as_tensor(x)).numpy()
    quant = [k for k in QUANTIZED if k < 28]
    np.testing.assert_array_equal(got[:, quant], want[:, quant])
    np.testing.assert_allclose(got, want, **STAT_TOL)


def test_fft_twiddles_are_rounded_f64():
    """Each pass's twiddles are cos/sin of 2*pi*j*l1*i/n from f64, rounded
    once, in ducc0's layout; a factor above 5 appends csarr, cos/sin of
    2*pi*m/ip with the upper half mirrored."""
    plan = t_features.rfft_plan(60)
    assert [p[:3] for p in plan] == [(5, 12, 1), (3, 4, 5), (4, 1, 15)]
    for ip, l1, ido, wa in plan:
        wa = np.asarray(wa, np.float32).reshape(ip - 1, ido - 1)
        for j in range(1, ip):
            i = np.arange(1, (ido - 1) // 2 + 1)
            ang = 2 * np.pi * j * l1 * i / 60
            np.testing.assert_array_equal(wa[j - 1, 0::2],
                                          np.cos(ang).astype(np.float32))
            np.testing.assert_array_equal(wa[j - 1, 1::2],
                                          np.sin(ang).astype(np.float32))
    plan = t_features.rfft_plan(14)
    assert [p[:3] for p in plan] == [(7, 2, 1), (2, 1, 7)]
    cs = np.asarray(plan[0][3], np.float32).reshape(7, 2)
    m = np.arange(1, 4)
    want = np.stack([np.cos(2 * np.pi * m / 7), np.sin(2 * np.pi * m / 7)],
                    -1).astype(np.float32)
    np.testing.assert_array_equal(cs[0], [1.0, 0.0])
    np.testing.assert_array_equal(cs[m], want)
    np.testing.assert_array_equal(cs[7 - m], want * [1, -1])
