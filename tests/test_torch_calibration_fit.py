"""The port's beta-calibration fit (``repro_torch.core.calibration.fit``,
`_nll`, `_fit_class`) and ECE against the JAX reference on the CPU.

Adam divides by sqrt(v), so near the optimum it amplifies ulp-level
differences in the gradient (XLA sums the rows in another order and
contracts the moment updates into fused multiply-adds). The fit is held
by what it is for, on seeded probabilities:
* the calibrated argmax is equal on every row;
* the calibrated confidences agree to rtol 2e-6 (measured: at most
  6.4e-7 relative on these inputs);
* each class's fitted NLL, evaluated in f64 for both fits, is within
  1e-5 relative of the reference's (measured: at most 4.1e-9);
* the parameters agree to rtol 5e-6, atol 1e-6 (measured: at most
  8.2e-7 relative).
ECE is NumPy in both packages and must be equal exactly on equal
probabilities.
"""
import _torch_threads  # noqa: F401  (one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as ref_cal
from repro_torch.core import calibration

CONF_TOL = dict(rtol=2e-6, atol=0.0)


def _probs(seed, n=3000, k=4, sharp=1.5):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n)
    logit = rng.normal(size=(n, k)) * sharp
    logit[np.arange(n), y] += 1.2
    p = np.exp(logit)
    return (p / p.sum(1, keepdims=True)).astype(np.float32), y


def _nll64(cal, p, y):
    """Per-class NLL of a fitted map in f64 (one evaluator for both)."""
    a_raw, b_raw, c = (np.asarray(v, np.float64) for v in cal)
    a, b = np.logaddexp(a_raw, 0.0), np.logaddexp(b_raw, 0.0)
    pp = np.clip(p.astype(np.float64), 1e-6, 1 - 1e-6)
    q = 1.0 / (1.0 + np.exp(-(a * np.log(pp) - b * np.log1p(-pp) + c)))
    q = np.clip(q, 1e-6, 1 - 1e-6)
    yb = (y[:, None] == np.arange(p.shape[1])).astype(np.float64)
    return -(yb * np.log(q) + (1 - yb) * np.log1p(-q)).mean(0)


@pytest.fixture(scope="module", params=[(1, 1.5), (2, 0.4), (3, 3.0)],
                ids=["moderate", "flat", "sharp"])
def fits(request):
    seed, sharp = request.param
    p, y = _probs(seed, sharp=sharp)
    ref = ref_cal.fit(p, y)
    port = calibration.fit(p, y, device="cpu")
    return p, y, ref, port


def _params(cal):
    return [np.asarray(v) if not isinstance(v, torch.Tensor) else v.numpy()
            for v in (cal.a_raw, cal.b_raw, cal.c)]


def test_fit_reaches_the_reference_likelihood(fits):
    p, y, ref, port = fits
    want = _nll64(_params(ref), p, y)
    got = _nll64(_params(port), p, y)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.0)
    for a, b in zip(_params(port), _params(ref)):
        np.testing.assert_allclose(a, b, rtol=5e-6, atol=1e-6)


def test_calibrated_argmax_and_confidence(fits):
    p, y, ref, port = fits
    want = np.asarray(ref_cal.calibrate(ref, jnp.asarray(p)))
    got = calibration.calibrate(port, torch.as_tensor(p)).numpy()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_allclose(got.max(1), want.max(1), **CONF_TOL)


def test_port_nll_is_the_reference_nll():
    """`_nll` of the port (per class, [K]) against the reference's
    `_nll` of each class at the same parameters: rtol 1e-6."""
    p, y = _probs(4)
    params = [torch.tensor([0.3, 0.55, 1.2, -0.4]),
              torch.tensor([0.1, 0.55, -0.8, 0.9]),
              torch.tensor([0.0, -0.2, 0.4, 0.1])]
    yb = (y[:, None] == np.arange(4)).astype(np.float32)
    got = calibration._nll(params, torch.as_tensor(p),
                           torch.as_tensor(yb)).numpy()
    for k in range(4):
        want = float(ref_cal._nll(tuple(jnp.float32(v[k].item())
                                        for v in params),
                                  jnp.asarray(p[:, k]), jnp.asarray(yb[:, k])))
        np.testing.assert_allclose(got[k], want, rtol=1e-6)


@pytest.mark.parametrize("n_bins", [5, 15])
def test_ece_is_exact(fits, n_bins):
    p, y, ref, _ = fits
    q = np.asarray(ref_cal.calibrate(ref, jnp.asarray(p)))
    assert calibration.expected_calibration_error(q, y, n_bins) == \
        ref_cal.expected_calibration_error(q, y, n_bins)
    assert calibration.expected_calibration_error(p, y) == \
        ref_cal.expected_calibration_error(p, y)
