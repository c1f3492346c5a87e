"""The port's kernels (``repro_torch.kernels``) on the CPU: plain PyTorch
versions against the JAX reference's oracles and its Pallas kernels in
interpret mode, device dispatch, and wrapper validation. The CUDA
kernels themselves are checked in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.scaling import registry as ref_registry
from repro.sim import cluster as ref_cluster
from repro_torch.kernels import episode_block, ops, plant_block, ref
from repro_torch.scaling import registry as t_registry
from repro_torch.sim import cluster as t_cluster

PLANT_TOL = dict(rtol=1e-5, atol=1e-5)     # test_kernel_properties.py
EPISODE_TOL = dict(rtol=3e-6, atol=1e-4)   # test_kernel_smoke.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plant_state(rng, b, s):
    pipeline = rng.gamma(1.0, 0.6, (b, s)).astype(np.float32)
    return [np.asarray(c, np.float32) for c in (
        rng.gamma(2.0, 2.0, b), pipeline, rng.gamma(1.0, 25.0, b),
        rng.gamma(1.0, 5.0, b), rng.random(b), rng.uniform(0.0, 20.0, b),
        pipeline.sum(axis=1), rng.gamma(2.0, 30.0, b))]


def _close(got, want, tol, what):
    for i, (a, e) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(e), **tol,
                                   err_msg=f"{what}[{i}]")


@pytest.mark.parametrize("b,s,n_ticks", [(5, 30, 15), (4, 12, 29),
                                         (3, 30, 3)])
def test_plant_block_ref_matches_reference(b, s, n_ticks):
    """Torch plain version vs the reference oracle and vs the reference
    Pallas kernel in interpret mode (tile 4; b=5 pads a tile)."""
    state = _plant_state(np.random.default_rng(b * 31 + n_ticks), b, s)
    got = ref.plant_block_ref(*map(torch.as_tensor, state),
                              n_ticks=n_ticks)
    jx = [jnp.asarray(x) for x in state]
    for want, what in (
            (ref_ref.plant_block_ref(*jx, n_ticks=n_ticks), "oracle"),
            (ref_ops.plant_tick_block(*jx, n_ticks=n_ticks, tile_b=4,
                                      interpret=True), "pallas")):
        _close(got[0], want[0], PLANT_TOL, f"{what} state")
        _close(got[1], want[1], PLANT_TOL, f"{what} ticks")


def test_episode_block_ref_matches_reference_kernel():
    """Torch plain episode vs the reference Pallas episode kernel in
    interpret mode: HPA, ci=30 (compiles in seconds), 5 lanes, tile 4."""
    rng = np.random.default_rng(5)
    rates = rng.uniform(0.0, 200.0, size=(5, 6)).astype(np.float32)
    rcfg = ref_cluster.SimConfig(control_interval_sec=30)
    want = ref_ops.episode_block(jnp.asarray(rates),
                                 ref_registry.make("hpa", rcfg), rcfg,
                                 tile_b=4, interpret=True)
    cfg = t_cluster.SimConfig(control_interval_sec=30)
    got = ref.episode_block_ref(torch.as_tensor(rates),
                                t_registry.make("hpa", cfg), cfg)
    _close(got, want, EPISODE_TOL, "MinuteOut")


def test_cpu_dispatch_runs_plain_versions_only():
    """CPU tensors go to the plain version and launch nothing."""
    ops.reset_launch_counts()
    state = [torch.as_tensor(x) for x in
             _plant_state(np.random.default_rng(1), 6, 30)]
    got = ops.plant_tick_block(*state, n_ticks=14)
    want = ref.plant_block_ref(*state, n_ticks=14)
    for a, e in zip((*got[0], *got[1]), (*want[0], *want[1])):
        assert torch.equal(a, e)
    cfg = t_cluster.SimConfig()
    ctrl = t_registry.make("hpa", cfg)
    rates = torch.as_tensor(
        np.random.default_rng(2).uniform(0, 900, (3, 4)).astype(np.float32))
    for a, e in zip(ops.episode_block(rates, ctrl, cfg),
                    ref.episode_block_ref(rates, ctrl, cfg)):
        assert torch.equal(a, e)
    assert ops.launch_counts() == {"plant_block": 0, "episode_block": 0}


def test_kernel_wrappers_reject_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes the
    plain version itself."""
    state = [torch.as_tensor(x) for x in
             _plant_state(np.random.default_rng(3), 2, 30)]
    with pytest.raises(ValueError, match="CUDA"):
        plant_block.plant_tick_block_cuda(*state, n_ticks=3)
    cfg = t_cluster.SimConfig()
    with pytest.raises(ValueError, match="CUDA"):
        episode_block.episode_block_cuda(torch.ones(2, 3),
                                         t_registry.make("hpa", cfg), cfg)
