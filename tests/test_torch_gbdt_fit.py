"""The port's GBDT training (``repro_torch.core.gbdt``: `_build_tree`,
`_boost_round`, `fit`, `predict_logits_scan`, `traverse_tables_chunked`,
`save`) against the JAX reference on the CPU.

Tolerances:
* Split features and thresholds are exact, on inputs whose best split
  gains are well separated (a near-tie may go either way, see the
  module's docstring).
* Leaf values within 4 f32 ulp (rtol 5e-7): the histograms are the
  reference's row-order sums and the cumulative sums its block order,
  bit for bit, but XLA compiles the leaves' `-G / (H + lambda)` in a way
  that moves some by one ulp depending on the surrounding program
  (measured: at most 1 ulp).
* After 4 rounds the leaves carry the softmax's exp (correctly rounded
  here, XLA's is not) through three rounds of gradients. A leaf is a
  sum of gradients that can cancel, so its error is absolute: rtol 2e-6
  or atol 1e-7, under 2 ulp of the largest leaf (measured: 2.2e-8).
* Logits within 4 ulp of the largest logit, argmax equal (the rule the
  port's inference is held to; C3a in ROADMAP).
"""
import _torch_threads  # noqa: F401  (one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gbdt as ref_gbdt
from repro_torch.core import gbdt

LEAF_TOL = dict(rtol=5e-7, atol=0.0)
FIT_LEAF_TOL = dict(rtol=2e-6, atol=1e-7)


def _tree_inputs(seed, n=3000, f=38, bins=16, k=1):
    """Bins, and gradients that depend on a few features so that the
    best splits stand well clear of the runners-up."""
    rng = np.random.default_rng(seed)
    xb = rng.integers(0, bins, (n, f)).astype(np.int32)
    g = (0.6 * (xb[:, 3] > bins // 2) - 0.4 * (xb[:, 11] < bins // 4)
         + 0.2 * rng.normal(size=(k, n))).astype(np.float32)
    h = rng.uniform(0.1, 1.0, (k, n)).astype(np.float32)
    return xb, g, h


def _ref_tree(xb, g, h, **kw):
    out = jax.jit(lambda a, b, c: ref_gbdt._build_tree(a, b, c, **kw))(
        xb, g, h)
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("seed,depth,bins", [(0, 3, 16), (1, 4, 64),
                                             (2, 2, 40)])
def test_build_tree_matches_reference(seed, depth, bins):
    xb, g, h = _tree_inputs(seed, bins=bins)
    kw = dict(depth=depth, n_bins=bins, reg_lambda=1.0,
              min_child_weight=1e-3)
    want = _ref_tree(xb, g[0], h[0], **kw)
    got = [a.numpy() for a in gbdt._build_tree(
        torch.as_tensor(xb), torch.as_tensor(g[0]), torch.as_tensor(h[0]),
        **kw)]
    np.testing.assert_array_equal(got[0], want[0])        # feat
    np.testing.assert_array_equal(got[1], want[1])        # thresh
    np.testing.assert_allclose(got[2], want[2], **LEAF_TOL)
    np.testing.assert_array_equal(got[3], want[3])        # leaf ids


def test_build_tree_batches_classes():
    """K trees built at once equal K single builds bit for bit."""
    xb, g, h = _tree_inputs(3, k=4)
    kw = dict(depth=3, n_bins=16, reg_lambda=1.0, min_child_weight=1e-3)
    xb_t = torch.as_tensor(xb)
    batched = gbdt._build_tree(xb_t, torch.as_tensor(g), torch.as_tensor(h),
                               **kw)
    for k in range(4):
        one = gbdt._build_tree(xb_t, torch.as_tensor(g[k]),
                               torch.as_tensor(h[k]), **kw)
        for a, b in zip(batched, one):
            assert torch.equal(a[k], b)


def test_build_tree_without_a_valid_split():
    """A node with no valid split takes the degenerate split (feature 0,
    bin B-1: everything left), as the reference's."""
    xb = np.zeros((50, 5), np.int32)                # one bin: no split
    g = np.linspace(-1, 1, 50).astype(np.float32)
    h = np.ones(50, np.float32)
    kw = dict(depth=2, n_bins=8, reg_lambda=1.0, min_child_weight=1e-3)
    want = _ref_tree(xb, g, h, **kw)
    got = [a.numpy() for a in gbdt._build_tree(
        torch.as_tensor(xb), torch.as_tensor(g), torch.as_tensor(h), **kw)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (got[0] == 0).all() and (got[1] == 7).all()


@pytest.mark.parametrize("m,n", [(1, 1), (5000, 7), (60_000, 9728)])
def test_sorted_segment_sum_is_row_order(m, n):
    """The card's histogram sum (a stable sort, then segment_reduce) gives
    the CPU's row-order index_add_ bit for bit, empty segments 0."""
    rng = np.random.default_rng(m)
    values = torch.as_tensor((rng.normal(size=(m, 2)) * np.exp(
        3 * rng.normal(size=(m, 2)))).astype(np.float32))
    index = torch.as_tensor(rng.integers(0, max(n - 2, 1), m))
    got = gbdt._sorted_segment_sum(values, index, n)
    assert torch.equal(got, gbdt._segment_sum(values, index, n))
    assert got.shape == (n, 2)


@pytest.mark.parametrize("n", [1, 8, 16, 17, 40, 64, 100, 300])
def test_xla_cumsum_is_jnp_cumsum(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(50, n)) * np.exp(3 * rng.normal(size=(50, n)))
         ).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(x))
    np.testing.assert_array_equal(gbdt.xla_cumsum(torch.as_tensor(x)).numpy(),
                                  want)


@pytest.fixture(scope="module")
def fitted():
    """(reference params, port params, X) after 4 rounds, depth 3, 16
    bins on 3,000 rows."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(3000, 38)).astype(np.float32)
    X[:, 9] = rng.integers(0, 60, 3000) / np.float32(60)    # quantized
    y = np.argmax(X[:, :4] + 0.6 * rng.normal(size=(3000, 4)), 1) \
        .astype(np.int32)
    kw = dict(n_rounds=4, depth=3, n_bins=16)
    ref = ref_gbdt.fit(X, y, ref_gbdt.GBDTConfig(**kw))
    port = gbdt.fit(X, y, gbdt.GBDTConfig(**kw), device="cpu")
    return ref, port, X


def test_fit_gives_the_reference_trees(fitted):
    ref, port, _ = fitted
    for name in ("feat", "thresh", "bin_edges", "base"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_allclose(port.leaf.numpy(), np.asarray(ref.leaf),
                               **FIT_LEAF_TOL)
    assert port.feat.dtype == torch.int32 and port.leaf.shape == (4, 4, 8)
    assert port.bin_edges.is_contiguous()      # the kernels read it flat


def test_fit_logits_within_4_ulp(fitted):
    ref, port, X = fitted
    want = np.asarray(ref_gbdt.predict_logits(ref, jnp.asarray(X)))
    got = gbdt.predict_logits(port, torch.as_tensor(X)).numpy()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    ulp4 = 4 * np.spacing(np.abs(want).max())
    assert np.abs(got - want).max() <= ulp4


def test_scan_oracle_agrees_with_tables(fitted):
    """`predict_logits_scan` (rounds summed in order) against the table
    path (XLA's order): argmax equal, logits within 4 ulp; and against
    the reference's scan at the same rule."""
    ref, port, X = fitted
    Xt = torch.as_tensor(X)
    scan = gbdt.predict_logits_scan(port, Xt).numpy()
    table = gbdt.predict_logits(port, Xt).numpy()
    np.testing.assert_array_equal(scan.argmax(-1), table.argmax(-1))
    assert np.abs(scan - table).max() <= 4 * np.spacing(np.abs(table).max())
    want = np.asarray(ref_gbdt.predict_logits_scan(ref, jnp.asarray(X)))
    np.testing.assert_array_equal(scan.argmax(-1), want.argmax(-1))
    assert np.abs(scan - want).max() <= 4 * np.spacing(np.abs(want).max())


@pytest.mark.parametrize("tree_chunk", [None, 1, 3, 8, 16])
def test_traverse_tables_chunked_is_bit_identical(fitted, tree_chunk):
    _, port, X = fitted
    xb = gbdt.bin_features(torch.as_tensor(X), port.bin_edges)
    assert torch.equal(
        gbdt.traverse_tables_chunked(port.tables, xb, tree_chunk),
        gbdt.traverse_tables(port.tables, xb))


def test_save_loads_in_both_packages(fitted, tmp_path):
    ref, port, _ = fitted
    gbdt.save(port, tmp_path / "port.npz")
    back = ref_gbdt.load(tmp_path / "port.npz")
    ref_gbdt.save(ref, tmp_path / "ref.npz")
    back_t = gbdt.load(tmp_path / "ref.npz", device="cpu")
    for name in ("feat", "thresh", "leaf", "bin_edges", "base"):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      getattr(port, name).numpy())
        np.testing.assert_array_equal(getattr(back_t, name).numpy(),
                                      np.asarray(getattr(ref, name)))
        assert np.asarray(getattr(back, name)).dtype == \
            np.asarray(getattr(ref, name)).dtype


def test_boost_round_matches_reference(fitted):
    """One round from the base logits: the same trees, leaves within 4
    ulp, new logits within 4 ulp of the largest."""
    ref, port, X = fitted
    cfg = gbdt.GBDTConfig(n_rounds=1, depth=3, n_bins=16)
    xb = gbdt.bin_features(torch.as_tensor(X), port.bin_edges)
    y = np.arange(X.shape[0]) % 4
    w = torch.ones(X.shape[0])
    onehot = torch.nn.functional.one_hot(torch.as_tensor(y), 4).float()
    logits = port.base.expand(X.shape[0], 4)
    got, (f, t, lv) = gbdt._boost_round(xb, onehot, w, logits, cfg)
    want, (rf, rt, rl) = ref_gbdt._boost_round(
        jnp.asarray(xb.numpy()), jnp.asarray(onehot.numpy()),
        jnp.asarray(w.numpy()), jnp.asarray(logits.numpy()),
        ref_gbdt.GBDTConfig(n_rounds=1, depth=3, n_bins=16))
    np.testing.assert_array_equal(f.numpy(), np.asarray(rf))
    np.testing.assert_array_equal(t.numpy(), np.asarray(rt))
    np.testing.assert_allclose(lv.numpy(), np.asarray(rl), **LEAF_TOL)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= \
        4 * np.spacing(np.abs(want).max())
