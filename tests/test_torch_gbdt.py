"""The port's GBDT inference, beta calibration and classifier
(``repro_torch.core.gbdt``, ``calibration``, ``pipeline``) against the
JAX reference on the CPU.

A tiny GBDT is trained in-process by the reference (as
tests/test_kernel_smoke.py does) and crosses over through the
reference's own npz (``TrainedAAPA.save``). Bins and argmax are held
exactly; logits to 4 ulp of the largest logit (not bitwise: XLA sums
the per-class leaves in an order that depends on the compile, ROADMAP
§C); calibrated probabilities and confidences to rtol
4e-6, since the port's exp/log are correctly rounded and XLA's are not.
"""
import _torch_threads  # noqa: F401  (one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as ref_cal
from repro.core import gbdt as ref_gbdt
from repro.core import pipeline as ref_pipeline
from repro_torch import interop
from repro_torch.core import calibration as t_cal
from repro_torch.core import gbdt as t_gbdt
from repro_torch.core import pipeline as t_pipeline
from repro_torch.kernels import ops

PROB_TOL = dict(rtol=4e-6, atol=1e-7)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(reference TrainedAAPA, its npz path, validation features)."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(96, 38)).astype(np.float32)
    y = rng.integers(0, 4, 96).astype(np.int32)
    params = ref_gbdt.fit(X, y, ref_gbdt.GBDTConfig(n_rounds=4, depth=3))
    cal = ref_cal.fit(np.asarray(ref_gbdt.predict_proba(
        params, jnp.asarray(X))), y)
    tr = ref_pipeline.TrainedAAPA(params, cal, 0.5, 0.4, 0.3,
                                  np.full(4, 0.25), 96, 1.0, "tiny")
    path = tmp_path_factory.mktemp("gbdt") / "classifier.npz"
    tr.save(path)
    Xv = rng.normal(size=(300, 38)).astype(np.float32)
    return tr, path, Xv


def _paper_size_ensemble(seed=3, F=38, K=4, rounds=60, depth=4, bins=64):
    """Random reference GBDTParams at the paper's classifier size, with
    quantile edges (many equal to sample values) from `X`."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2000, F)).astype(np.float32)
    X[:, 5] = rng.integers(0, 60, 2000) / np.float32(60)   # quantized
    edges = ref_gbdt.compute_bin_edges(X, bins)
    params = ref_gbdt.GBDTParams(
        feat=jnp.asarray(rng.integers(0, F, (rounds, K, 2**depth - 1)),
                         jnp.int32),
        thresh=jnp.asarray(rng.integers(0, bins - 1,
                                        (rounds, K, 2**depth - 1)),
                           jnp.int32),
        leaf=jnp.asarray(rng.normal(0.0, 0.1, (rounds, K, 2**depth)),
                         jnp.float32),
        bin_edges=jnp.asarray(edges), base=jnp.asarray(
            np.log(np.float32([0.4, 0.2, 0.3, 0.1]))))
    return params, X


def _port_params(ref_params):
    return t_gbdt.from_arrays(*(np.asarray(a) for a in (
        ref_params.feat, ref_params.thresh, ref_params.leaf,
        ref_params.bin_edges, ref_params.base)), device="cpu")


def test_bins_match_reference_exactly(trained):
    tr, _, Xv = trained
    X = np.concatenate([Xv, np.asarray(tr.params.bin_edges).T[:5]])
    X[0, :3] = (np.nan, np.inf, -np.inf)
    want = np.asarray(ref_gbdt.bin_features(jnp.asarray(X),
                                            tr.params.bin_edges))
    got = t_gbdt.bin_features(torch.as_tensor(X), torch.as_tensor(
        np.array(tr.params.bin_edges)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("size", ["tiny", "paper"])
def test_logits_match_reference(trained, size):
    if size == "tiny":
        ref_params, X = trained[0].params, trained[2]
    else:
        ref_params, X = _paper_size_ensemble()
    params = _port_params(ref_params)
    want = np.asarray(ref_gbdt.predict_logits(ref_params, jnp.asarray(X)))
    got = t_gbdt.predict_logits(params, torch.as_tensor(X)).numpy()
    # 4 ulp of the largest logit: a sum that reassociates moves a logit
    # near zero by many of its own ulp but by few of its terms'
    ulp = np.spacing(np.abs(want).max().astype(np.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * ulp)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_array_equal(
        t_gbdt.predict(params, torch.as_tensor(X)).numpy(),
        np.asarray(ref_gbdt.predict(ref_params, jnp.asarray(X))))
    # the kernel dispatch's CPU route is the plain version
    assert torch.equal(ops.gbdt_logits(params, torch.as_tensor(X)),
                       torch.as_tensor(got))


def test_softmax_calibrate_confidence(trained):
    tr, path, Xv = trained
    port = interop.trained_from_reference(path, device="cpu")
    want_p = np.array(ref_gbdt.predict_proba(tr.params, jnp.asarray(Xv)))
    got_p = t_gbdt.predict_proba(port.params, torch.as_tensor(Xv))
    np.testing.assert_allclose(got_p.numpy(), want_p, **PROB_TOL)
    want = np.asarray(ref_cal.calibrate(tr.cal, jnp.asarray(want_p)))
    got = t_cal.calibrate(port.cal, torch.as_tensor(want_p))
    np.testing.assert_allclose(got.numpy(), want, **PROB_TOL)
    np.testing.assert_allclose(
        t_cal.confidence(port.cal, torch.as_tensor(want_p)).numpy(),
        np.asarray(ref_cal.confidence(tr.cal, jnp.asarray(want_p))),
        **PROB_TOL)
    a, b, _ = t_cal.coefficients(port.cal)
    np.testing.assert_allclose(a.numpy(), np.asarray(
        jax.nn.softplus(tr.cal.a_raw)), rtol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(
        jax.nn.softplus(tr.cal.b_raw)), rtol=1e-6)


def test_make_classify_matches_reference(trained):
    tr, path, Xv = trained
    port = t_pipeline.TrainedAAPA.load(path, device="cpu")
    ref_classify = tr.make_classify()
    want = [ref_classify(jnp.asarray(x)) for x in Xv[:64]]
    arch, conf = port.make_classify()(torch.as_tensor(Xv[:64]))
    assert arch.dtype == torch.int32 and arch.shape == (64,)
    np.testing.assert_array_equal(arch.numpy(),
                                  [int(a) for a, _ in want])
    np.testing.assert_allclose(conf.numpy(),
                               np.float32([c for _, c in want]), **PROB_TOL)
    # lanes of any shape
    a2, c2 = port.make_classify()(torch.as_tensor(Xv[:64]).reshape(8, 8, 38))
    assert torch.equal(a2.reshape(64), arch) and torch.equal(
        c2.reshape(64), conf)


def test_trained_from_reference_object_and_npz(trained):
    tr, path, _ = trained
    from_npz = interop.trained_from_reference(path, device="cpu")
    from_obj = interop.trained_from_reference(
        tr, device="cpu")
    for port in (from_npz, from_obj):
        assert port.dataset_id == "tiny" and port.n_windows == 96
        assert (port.train_acc, port.val_acc, port.test_acc) == (0.5, 0.4,
                                                                 0.3)
        np.testing.assert_array_equal(port.params.tables.feat.numpy(),
                                      np.asarray(tr.params.tables.feat))
        np.testing.assert_array_equal(port.params.tables.leaf.numpy(),
                                      np.asarray(tr.params.tables.leaf))
        np.testing.assert_array_equal(port.cal.c.numpy(),
                                      np.asarray(tr.cal.c))
    assert from_npz.params.depth == 3
    with pytest.raises(ValueError, match="split features"):
        t_gbdt.from_arrays(np.full((1, 4, 7), 38), np.zeros((1, 4, 7)),
                           np.zeros((1, 4, 8)), np.zeros((38, 63)),
                           np.zeros(4), device="cpu")
