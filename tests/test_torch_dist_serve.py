"""The port's serving engine and launcher in a world of four gloo ranks
(``launch.serve.serve`` under a world mesh 4 x 1): the launcher's 10-minute
bursty script under AAPA at smoke width (f32), the classifier trained on
``aapaset_ci`` on the CPU. Every rank runs the whole host schedule and
decodes its block of the 32 slots; its ``summary()`` and decision log equal
the unsharded engine's exactly (the scheduler never reads the logits), its
``last_logits`` rows hold the unsharded engine's at rtol 1e-4 / atol 1e-5
of the largest entry, and only rank 0 logs.
"""
import _torch_threads  # noqa: F401  (one torch thread)
import numpy as np
import pytest
import torch

from repro_torch.core import gbdt, pipeline
from repro_torch.dist import world

import _torch_dist_ranks as ranks

DEADLINE_S = 150
SHAPE = (4, 1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_serve")
    trained = pipeline.train_classifier(
        "aapaset_ci", gbdt.GBDTConfig(n_rounds=10, depth=3), root=tmp,
        cache=False, device="cpu")
    torch.save({"arch": "stablelm_1_6b", "minutes": 10, "trained": trained},
               tmp / "inputs.pt")
    return world.spawn(ranks.serve_rank, 4, backend="gloo", root=tmp,
                       deadline_s=DEADLINE_S, threads=1,
                       args=(str(tmp / "inputs.pt"), SHAPE))


def test_every_rank_schedules_as_one_engine(runs):
    """Each rank's summary and decision log equal the unsharded engine's;
    one reclassification at minute 10; each rank holds 8 of the 32
    slots."""
    single = runs[0]["single"]
    assert single["summary"]["served"] > 0
    assert single["decode_steps"] > 0
    for r in runs:
        got = r["sharded"]
        assert got["summary"] == single["summary"]
        assert got["decode_steps"] == single["decode_steps"]
        for field in single["trace"]._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(got["trace"], field)),
                np.asarray(getattr(single["trace"], field)), err_msg=field)
        assert got["rows"].stop - got["rows"].start == 8
    assert sorted(r["sharded"]["rows"].start for r in runs) == [0, 8, 16, 24]


def test_last_logits_rows_match_unsharded(runs):
    want = runs[0]["single"]["last_logits"].numpy()
    tol = 1e-5 * np.abs(want).max()
    for r in runs:
        got = r["sharded"]
        assert got["last_logits"].shape == (8, 1, want.shape[-1])
        np.testing.assert_allclose(got["last_logits"].numpy(),
                                   want[got["rows"]], rtol=1e-4, atol=tol)


def test_only_rank_zero_logs(runs):
    assert runs[0]["sharded"]["logged"] == runs[0]["single"]["logged"]
    assert len(runs[0]["sharded"]["logged"]) == 2
    assert all(r["sharded"]["logged"] == [] for r in runs[1:])
