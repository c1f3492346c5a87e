"""The port's AAPAset engine (``repro_torch.aapaset``: build, manifest,
registry, loader) against the JAX reference on the CPU.

A small config (``aapaset_ci`` cut to 6 functions x 3 days) is built by
both packages. Windows, ids, days, splits and series are NumPy and equal
exactly. Features are held at the reference's feature tolerance (rtol /
atol 5e-4) with the quantized features exact: the port never contracts
a product into an add, XLA does, so some continuous features differ in
the last ulp or two (ROADMAP, "Standing differences"). Labels, votes and
confidence are equal except on windows where some LF's input lies within
that tolerance of the LF's threshold; the test finds those windows and
requires every disagreement to be one of them. Hashes, the manifest
format and the loaders' batches and fleet chunks are equal exactly.
"""
import _torch_threads  # noqa: F401  (one torch thread)
import dataclasses

import numpy as np
import pytest
import torch

from repro.aapaset import build as ref_build
from repro.aapaset import loader as ref_loader
from repro.aapaset import manifest as ref_manifest
from repro.aapaset import registry as ref_registry
from repro_torch.aapaset import build, loader, manifest, registry
from repro_torch.core import features, labeling

FEATURE_TOL = dict(rtol=5e-4, atol=5e-4)
SMALL = dict(n_functions=6, n_days=3, chunk=1024)
EXACT = ("windows", "func_id", "start_min", "pattern", "day", "split",
         "series", "series_pattern")

# every LF's (feature, threshold) pairs, from core/labeling.py
LF_INPUTS = {
    "lf_spike_kurtosis": [("kurtosis", 10.0)],
    "lf_spike_max_median": [("max_to_median", 20.0)],
    "lf_spike_zero_burst": [("zero_fraction", 0.5), ("max_to_mean", 10.0)],
    "lf_periodic_spectral": [("spectral_entropy", 0.5),
                             ("dominant_power_ratio", 0.3),
                             ("trend_r2", 0.6)],
    "lf_periodic_autocorr": [("acf_max", 0.6), ("max_to_median", 20.0),
                             ("trend_r2", 0.5)],
    "lf_periodic_peaks": [("n_peaks", 2.0 / 60.0), ("acf_max", 0.5),
                          ("kurtosis", 10.0), ("trend_r2", 0.5)],
    "lf_ramp_trend": [("trend_r2", 0.75), ("trend_slope", 0.02),
                      ("trend_slope", -0.02)],
    "lf_ramp_halves": [("half_ratio", 1.6), ("half_ratio", 0.6),
                       ("trend_r2", 0.5)],
    "lf_stationary_low_var": [("cv", 0.35), ("trend_slope", 0.01),
                              ("trend_slope", -0.01), ("acf_max", 0.6)],
    "lf_stationary_no_structure": [("spectral_entropy", 0.85),
                                   ("kurtosis", 3.0),
                                   ("max_to_median", 5.0),
                                   ("trend_r2", 0.5)],
}


@pytest.fixture(scope="module")
def built():
    """(reference BuiltDataset, port BuiltDataset) of the small config."""
    ref = ref_build.build(ref_registry.get("aapaset_ci", **SMALL))
    port = build.build(registry.get("aapaset_ci", **SMALL), device="cpu")
    return ref, port


def _as_port(ref_built) -> build.BuiltDataset:
    return build.BuiltDataset(**dataclasses.asdict(ref_built))


def test_build_matches_reference(built):
    ref, port = built
    assert len(port) == len(ref) > 2000
    for name in EXACT:
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_allclose(port.features, ref.features, **FEATURE_TOL)
    quant = [features.FEATURE_NAMES.index(n) for n in features.QUANTIZED]
    np.testing.assert_array_equal(port.features[:, quant],
                                  ref.features[:, quant])
    for name in ("labels", "confidence", "votes"):
        assert getattr(port, name).dtype == getattr(ref, name).dtype


def _near_threshold(feats: np.ndarray) -> np.ndarray:
    """[N, N_LFS] bool: some input of that LF lies within the feature
    tolerance of one of its thresholds."""
    idx = labeling._F
    near = np.zeros((feats.shape[0], labeling.N_LFS), bool)
    for j, lf in enumerate(labeling.LABELING_FUNCTIONS):
        for name, t in LF_INPUTS[lf.__name__]:
            f = feats[:, idx[name]].astype(np.float64)
            near[:, j] |= np.abs(f - t) <= (FEATURE_TOL["atol"]
                                            + FEATURE_TOL["rtol"] * abs(t))
    return near


def test_labels_match_except_near_thresholds(built):
    ref, port = built
    near = _near_threshold(ref.features)
    vote_diff = ref.votes != port.votes
    assert not (vote_diff & ~near).any(), \
        "an LF vote differs on a window far from its thresholds"
    row_near = near.any(axis=1)
    for name in ("labels", "confidence"):
        diff = getattr(ref, name) != getattr(port, name)
        assert not (diff & ~row_near).any(), name
    assert (ref.labels == port.labels).mean() > 0.99


def test_labels_equal_on_reference_features(built):
    """The port's labeling of the reference's own features is the
    reference's, bit for bit (isolates labeling from the feature ulps)."""
    ref, _ = built
    votes = labeling.apply_lfs(torch.as_tensor(ref.features))
    labels, conf, _ = labeling.majority_vote(votes)
    np.testing.assert_array_equal(votes.numpy().astype(np.int8), ref.votes)
    np.testing.assert_array_equal(labels.numpy(), ref.labels)
    np.testing.assert_array_equal(conf.numpy().view(np.uint32),
                                  ref.confidence.view(np.uint32))


@pytest.mark.parametrize("name", ref_registry.available())
def test_config_hash_matches_reference(name):
    """The reference's content address for every registry config: "auto"
    resolves to "ref" on the CPU in both packages, and "kernel" names
    the same key."""
    assert manifest.config_hash(registry.get(name), device="cpu") == \
        ref_manifest.config_hash(ref_registry.get(name))
    assert manifest.config_hash(registry.get(name), device="cuda") == \
        ref_manifest.config_hash(ref_registry.get(name,
                                                  feature_path="kernel"))
    for f in ("ref", "kernel"):
        assert manifest.config_hash(registry.get(name, feature_path=f)) == \
            ref_manifest.config_hash(ref_registry.get(name, feature_path=f))
    # execution knobs do not move the address
    assert manifest.config_hash(registry.get(name, chunk=7)) == \
        manifest.config_hash(registry.get(name))


def test_port_root_is_not_the_reference_root():
    assert manifest.DEFAULT_ROOT != ref_manifest.DEFAULT_ROOT
    assert str(manifest.DEFAULT_ROOT) == "experiments/aapaset_torch"
    assert manifest.SCHEMA_VERSION == ref_manifest.SCHEMA_VERSION
    assert registry.available() == ref_registry.available()


def test_reference_artifact_loads_in_port(built, tmp_path):
    """An artifact the reference saved loads in the port with the same
    arrays, and one the port saved loads in the reference: one format."""
    ref, _ = built
    cfg_r = ref_registry.get("aapaset_ci", **SMALL)
    cfg_t = registry.get("aapaset_ci", **SMALL)
    man_r = ref_manifest.save(ref, cfg_r, tmp_path / "ref")
    assert manifest.is_cached(cfg_t, tmp_path / "ref", device="cpu")
    assert manifest.read_manifest(cfg_t, tmp_path / "ref",
                                  device="cpu") == man_r
    back = manifest.load(cfg_t, tmp_path / "ref", verify=True, device="cpu")
    for name in manifest._SHARD_KEYS + ("series", "series_pattern"):
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(ref, name), err_msg=name)
    man_t = manifest.save(_as_port(ref), cfg_t, tmp_path / "port",
                          device="cpu")
    assert man_t == man_r                      # same card, shards, digests
    again = ref_manifest.load(cfg_r, tmp_path / "port", verify=True)
    for name in manifest._SHARD_KEYS:
        np.testing.assert_array_equal(getattr(again, name),
                                      getattr(ref, name), err_msg=name)


def test_dataset_card_matches_reference(built):
    ref, _ = built
    assert manifest.dataset_card(_as_port(ref)) == \
        ref_manifest.dataset_card(ref)


def test_build_or_load_caches(tmp_path, monkeypatch):
    cfg = registry.get("aapaset_ci", n_functions=3, n_days=3, chunk=512)
    first, man = manifest.build_or_load(cfg, tmp_path, device="cpu")
    assert manifest.is_cached(cfg, tmp_path, device="cpu")
    monkeypatch.setattr(manifest, "build", None)   # a hit builds nothing
    second, man2 = manifest.build_or_load(cfg, tmp_path, device="cpu")
    assert man2 == man
    np.testing.assert_array_equal(first.features, second.features)
    assert man["hash"] == manifest.config_hash(cfg, device="cpu")


def test_kernel_path_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        build.featurize_windows(np.zeros((4, 60), np.float32),
                                use_kernel=True, device="cpu")


def _loaders(built):
    ref, _ = built
    man = {"config": {"name": "aapaset_ci"}, "hash": "0" * 12}
    return (ref_loader.AAPAsetLoader(ref, man),
            loader.AAPAsetLoader(_as_port(ref), man, device="cpu"))


@pytest.mark.parametrize("kw", [
    dict(split="train", batch_size=64, seed=0),
    dict(split="val", batch_size=100, seed=3, shard_index=1, num_shards=3),
    dict(split="test", batch_size=77, seed=1, shard_index=0, num_shards=2,
         drop_remainder=False, labeled_only=False)])
def test_batches_match_reference(built, kw):
    r, t = _loaders(built)
    got = list(t.batches(**kw))
    want = list(r.batches(**kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kw", [
    dict(n_workloads=12, w_chunk=4, minutes=90, seed=2),
    dict(n_workloads=12, w_chunk=3, seed=5, shard_index=1, num_shards=2)])
def test_rate_chunks_match_reference(built, kw):
    r, t = _loaders(built)
    got = list(t.rate_chunks(**kw))
    want = list(r.rate_chunks(**kw))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for bad in (dict(kw, w_chunk=5), dict(kw, shard_index=2, num_shards=2)):
        with pytest.raises(ValueError):
            next(t.rate_chunks(**bad))


def test_from_name_and_arrays(tmp_path, built):
    """`from_name` builds under the given root and names the artifact by
    the reference's hash; `arrays` and `split_indices` are the
    reference's selections."""
    t = loader.AAPAsetLoader.from_name("aapaset_ci", tmp_path, device="cpu",
                                       **SMALL)
    cfg_r = ref_registry.get("aapaset_ci", **SMALL)
    assert t.dataset_id == \
        f"aapaset_ci-{ref_manifest.config_hash(cfg_r)}"
    assert (tmp_path / t.dataset_id / "manifest.json").exists()
    r, tr = _loaders(built)
    for split in ("train", "val", "test", None):
        np.testing.assert_array_equal(tr.split_indices(split),
                                      r.split_indices(split))
        for a, b in zip(tr.arrays(split), r.arrays(split)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tr.series(max_functions=2),
                                  r.series(max_functions=2))
