"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test carries the ``requires_cuda`` marker and skips inside
the ``cuda`` fixture when there is no card (the kernels have no CPU
mode). This file imports neither JAX nor the JAX package, so it runs on
the GPU machine as it is:

    python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import episode_block, ops, plant_block, ref
from repro_torch.scaling import registry
from repro_torch.sim import cluster

PLANT_TOL = dict(rtol=1e-5, atol=1e-5)
EPISODE_TOL = dict(rtol=3e-6, atol=1e-4)

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    """Decided per test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _plant_state(rng, b, s, dev):
    pipeline = rng.gamma(1.0, 0.6, (b, s)).astype(np.float32)
    return [torch.as_tensor(np.asarray(c, np.float32), device=dev)
            for c in (rng.gamma(2.0, 2.0, b), pipeline,
                      rng.gamma(1.0, 25.0, b), rng.gamma(1.0, 5.0, b),
                      rng.random(b), rng.uniform(0.0, 20.0, b),
                      pipeline.sum(axis=1), rng.gamma(2.0, 30.0, b))]


def _rates(seed, dev, w=257, m=12):
    rng = np.random.default_rng(seed)
    rates = rng.uniform(0.0, 3000.0, (w, m)).astype(np.float32)
    rates[::3, 4:] = 0.0                   # scale-downs and scale-to-zero
    return torch.as_tensor(rates, device=dev)


@pytest.mark.parametrize("n_ticks", [14, 29, 3])
def test_plant_block_kernel_matches_plain(cuda, n_ticks):
    state = _plant_state(np.random.default_rng(n_ticks), 1003, 30, cuda)
    before = plant_block.plant_tick_block_cuda.launches
    got = plant_block.plant_tick_block_cuda(*state, n_ticks=n_ticks)
    want = ref.plant_block_ref(*state, n_ticks=n_ticks)
    torch.cuda.synchronize()
    assert plant_block.plant_tick_block_cuda.launches == before + 1
    for a, e in zip((*got[0], *got[1]), (*want[0], *want[1])):
        torch.testing.assert_close(a, e, **PLANT_TOL)


@pytest.mark.parametrize("ci", [15, 7])
def test_episode_block_kernel_matches_plain(cuda, ci):
    cfg = cluster.SimConfig(control_interval_sec=ci)
    ctrl = registry.make("hpa", cfg)
    rates = _rates(ci, cuda)
    got = episode_block.episode_block_cuda(rates, ctrl, cfg)
    want = ref.episode_block_ref(rates, ctrl, cfg)
    torch.cuda.synchronize()
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, **EPISODE_TOL)


def test_default_path_is_the_episode_kernel(cuda):
    """`make_simulator` on its default device launches one episode kernel
    per chunk, and chunking changes no bit."""
    cfg = cluster.SimConfig()
    ctrl = registry.make("hpa", cfg)
    rates = _rates(1, cuda, w=256)
    ops.reset_launch_counts()
    chunked = cluster.make_simulator(ctrl, cfg, w_chunk=64)(rates)
    assert ops.launch_counts() == {"plant_block": 0, "episode_block": 4}
    whole = cluster.make_simulator(ctrl, cfg)(rates)
    for a, b in zip(chunked, whole):
        assert torch.equal(a, b)


def test_unfused_path_launches_plant_block(cuda):
    cfg = cluster.SimConfig()
    ctrl = registry.make("hpa", cfg)
    rates = _rates(2, cuda, w=64, m=5)
    ops.reset_launch_counts()
    unfused = cluster.simulate(rates, ctrl, cfg, decide_kernel=False)
    assert ops.launch_counts() == {"plant_block": 5 * 4, "episode_block": 0}
    fused = cluster.simulate(rates, ctrl, cfg)
    for a, e in zip(unfused, fused):
        torch.testing.assert_close(a, e, **EPISODE_TOL)


def test_unknown_policy_raises(cuda):
    cfg = cluster.SimConfig()
    ctrl = registry.make("hpa", cfg)._replace(name="kpa")
    with pytest.raises(NotImplementedError, match="compiled"):
        episode_block.episode_block_cuda(_rates(3, cuda), ctrl, cfg)
