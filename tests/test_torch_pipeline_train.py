"""The port's classifier training (``repro_torch.core.pipeline``:
`featurize_and_label`, `train_aapa`, `train_from_loader`,
`train_classifier`, `TrainedAAPA.save`) against the JAX reference on the
CPU.

Both packages train on the same tiny TraceSet (10 functions x 4 days)
with a small GBDT (4 rounds, depth 3, 16 bins). The features differ from
the reference's in the last ulp or two, which moves quantile bin edges,
so the trees need not be the same: the accuracies are held within 0.02
of the reference's (measured: at most 0.00075 apart), the weak-label
distribution and window count exactly. Each package's npz loads in the
other with equal arrays.
"""
import _torch_threads  # noqa: F401  (one torch thread)
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import gbdt as ref_gbdt
from repro.core import pipeline as ref_pipeline
from repro.data import azure_synth as ref_synth
from repro_torch.aapaset import loader, manifest
from repro_torch.core import gbdt, pipeline
from repro_torch.data import azure_synth

ACC_MARGIN = 0.02
SMALL = dict(n_rounds=4, depth=3, n_bins=16)


@pytest.fixture(scope="module")
def trained():
    ref = ref_pipeline.train_aapa(
        ref_synth.generate_traces(n_functions=10, n_days=4, seed=0),
        ref_gbdt.GBDTConfig(**SMALL))
    port = pipeline.train_aapa(
        azure_synth.generate_traces(n_functions=10, n_days=4, seed=0),
        gbdt.GBDTConfig(**SMALL), device="cpu")
    return ref, port


def test_train_aapa_matches_reference(trained):
    ref, port = trained
    for name in ("train_acc", "val_acc", "test_acc"):
        assert abs(getattr(port, name) - getattr(ref, name)) <= ACC_MARGIN
    assert port.n_windows == ref.n_windows
    np.testing.assert_array_equal(port.label_dist, ref.label_dist)
    assert port.params.feat.shape == tuple(ref.params.feat.shape)
    assert port.fit_seconds > 0 and port.dataset_id == ""


def test_npz_crosses_between_packages(trained, tmp_path):
    ref, port = trained
    port.save(tmp_path / "port.npz")
    ref.save(tmp_path / "ref.npz")
    in_ref = ref_pipeline.TrainedAAPA.load(tmp_path / "port.npz")
    in_port = pipeline.TrainedAAPA.load(tmp_path / "ref.npz", device="cpu")
    for src, dst in ((port, in_ref), (in_port, ref)):
        for name in ("feat", "thresh", "leaf", "bin_edges", "base"):
            np.testing.assert_array_equal(
                np.asarray(getattr(dst.params, name)),
                np.asarray(getattr(src.params, name)), err_msg=name)
        for name in ("a_raw", "b_raw", "c"):
            np.testing.assert_array_equal(np.asarray(getattr(dst.cal, name)),
                                          np.asarray(getattr(src.cal, name)))
        for name in ("train_acc", "val_acc", "test_acc", "n_windows",
                     "fit_seconds", "dataset_id"):
            assert getattr(dst, name) == getattr(src, name)
        np.testing.assert_array_equal(dst.label_dist, src.label_dist)
    # the loaded classifier classifies as the trained one
    X = torch.as_tensor(np.random.default_rng(0).normal(
        size=(50, 38)).astype(np.float32))
    for a, b in zip(port.make_classify()(X), pipeline.TrainedAAPA.load(
            tmp_path / "port.npz", device="cpu").make_classify()(X)):
        assert torch.equal(a, b)


def test_featurize_and_label_matches_reference():
    from repro.core import pipeline as rp
    from repro.data import windows as ref_windows
    from repro_torch.data import windows
    ds_r = ref_windows.make_windows(ref_synth.generate_traces(
        n_functions=4, n_days=1, seed=3))
    ds_t = windows.make_windows(azure_synth.generate_traces(
        n_functions=4, n_days=1, seed=3))
    want = rp.featurize_and_label(ds_r, batch=512)
    got = pipeline.featurize_and_label(ds_t, batch=512, device="cpu")
    np.testing.assert_allclose(got[0], want[0], rtol=5e-4, atol=5e-4)
    assert (got[1] == want[1]).mean() > 0.99
    assert got[1].dtype == want[1].dtype and got[2].dtype == want[2].dtype


def test_train_classifier_caches_under_the_port_root(tmp_path):
    """`train_classifier` builds the dataset, trains, and caches the npz
    inside the artifact directory; a second call is a cache hit that
    touches no shard; `train_from_loader` names the dataset."""
    overrides = dict(n_functions=6, n_days=3)
    ld = loader.AAPAsetLoader.from_name("aapaset_ci", tmp_path,
                                        device="cpu", **overrides)
    cfg = gbdt.GBDTConfig(**SMALL)
    first = pipeline.train_classifier(
        "aapaset_ci", cfg, root=tmp_path, device="cpu",
        loader_factory=lambda: ld)
    assert first.dataset_id == ld.dataset_id
    assert first.n_windows == len(ld.split_indices(None))
    # the npz sits under the registry config's address in the port's
    # layout: <root>/<name>-<hash>/classifier-<key>.npz
    key = manifest.hash_json({"v": pipeline.CLASSIFIER_VERSION,
                              "gbdt": dataclasses.asdict(cfg)}, n=8)
    from repro_torch.aapaset import registry
    path = manifest.artifact_dir(registry.get("aapaset_ci"), tmp_path,
                                 device="cpu") / f"classifier-{key}.npz"
    assert path.exists()
    again = pipeline.train_classifier(
        "aapaset_ci", cfg, root=tmp_path, device="cpu",
        loader_factory=lambda: pytest.fail("cache miss"))
    assert again.test_acc == first.test_acc
    np.testing.assert_array_equal(again.params.leaf.numpy(),
                                  first.params.leaf.numpy())
