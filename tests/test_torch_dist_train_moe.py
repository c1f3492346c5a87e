"""The port's sharded train step of an MoE config
(``deepseek_v2_lite_16b`` at smoke size, f32: MLA attention, a leading
dense layer, 4 routed experts top-2 and a shared one) in a world of four
gloo ranks, on world meshes 2 x 2 (the experts split over two model
columns) and 4 x 1 (one column), against the reference's sharded step on
the same meshes of forced host devices (``tests/_dist_train.py``): loss,
grad_norm and every new param and optimizer leaf at the train-step
tolerances of ``tests/test_torch_train.py``. Against the port's
unsharded step the loss holds the reference's own 0.05
(tests/test_distributed.py): the expert-parallel path routes each
column's tokens at a local capacity and averages per-column aux losses.
"""
import _torch_threads  # noqa: F401  (one torch thread)
import pytest

import _dist_train as dt

ARCH = "deepseek_v2_lite_16b"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return dt.runs(ARCH, tmp_path_factory.mktemp("dist_train_moe"))


def test_sharded_step_matches_reference(runs):
    ref, got = runs
    dt.check_against_reference(ref, got, ARCH, dict(rtol=0, atol=0.05))


def test_experts_split_over_the_model_axis(runs):
    """Over 2 x 2 each rank holds E/2 experts of D/2 (w_down: Fe x D/2);
    over 4 x 1 all E experts of D/4."""
    from repro_torch.models import model as M
    import _torch_dist_ranks as ranks
    _, got = runs
    cfg = ranks.f32_smoke(ARCH)
    paths = ranks._paths(M.init(0, cfg, device="meta"))
    E, D, Fe = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    for mesh, (e, d) in {"2x2": (2, 2), "4x1": (1, 4)}.items():
        shapes = dict(zip(paths, got[mesh][0]["local_shapes"]))
        assert shapes["layers/0/moe/w_gate"] == (E // e, D // d, Fe)
        assert shapes["layers/0/moe/w_down"] == (E // e, Fe, D // d)
        assert shapes["layers/0/moe/router"] == (D, E)
