"""The port's sharded train step of the dense configs (``internlm2_1_8b``
and the encoder-decoder ``whisper_large_v3``, whose batch also holds the
stub frontend's frame embeddings, at smoke size, f32) in a world of four
gloo ranks, on world meshes 2 x 2 and 4 x 1, against the reference's
sharded step on the same meshes of forced host devices
(``tests/_dist_train.py``): loss, grad_norm and every new param and
optimizer leaf at the train-step tolerances of
``tests/test_torch_train.py``. Each layer's leaves are gathered where the
layer runs; the dense math is the single-device step's, so the loss also
holds the port's unsharded step at rtol 1e-5.
"""
import math

import pytest

import _dist_train as dt

ARCH = "internlm2_1_8b"
ENCDEC = "whisper_large_v3"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return dt.runs(ARCH, tmp_path_factory.mktemp("dist_train"))


@pytest.fixture(scope="module")
def encdec_runs(tmp_path_factory):
    return dt.runs(ENCDEC, tmp_path_factory.mktemp("dist_train_encdec"))


def test_sharded_step_matches_reference(runs):
    ref, got = runs
    dt.check_against_reference(ref, got, ARCH, dict(rtol=1e-5))


def test_encdec_sharded_step_matches_reference(encdec_runs):
    ref, got = encdec_runs
    dt.check_against_reference(ref, got, ENCDEC, dict(rtol=1e-5))


def _holds_blocks(arch, got, mesh):
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt_lib
    import _torch_dist_ranks as ranks
    full = opt_lib.leaves(M.init(0, ranks.f32_smoke(arch), device="meta"))
    n = {"2x2": 2, "4x1": 4}[mesh]
    for f, shape in zip(full, got[mesh][0]["local_shapes"]):
        if f.dim() <= 1:
            assert shape == tuple(f.shape)
        else:
            assert f.numel() == n * math.prod(shape)
    for r in got[mesh]:
        assert r["local_shapes"] == got[mesh][0]["local_shapes"]


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_each_rank_holds_its_blocks(runs, mesh):
    """Over 2 x 2 every matrix splits one dim in two, over 4 x 1 in four
    (FSDP over the data axis); norms and scalars stay whole; every rank
    holds blocks of the same shapes."""
    _holds_blocks(ARCH, runs[1], mesh)


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_encdec_each_rank_holds_its_blocks(encdec_runs, mesh):
    """The same of both stacks of the encoder-decoder."""
    _holds_blocks(ENCDEC, encdec_runs[1], mesh)
