"""The port's SSD (Mamba2) and MoE layers against the JAX reference's on
the CPU, and the reference's own claims held on the port
(``tests/test_ssd_moe.py``): SSD chunked against the recurrence for chunk
4/8/32, Mamba prefill against stepwise decode, MoE against its per-token
dense reference, capacity drops and the capacity formula. Inputs are
NumPy-seeded; parameters are the reference's, carried across. Tolerance
rtol 1e-4 / atol 1e-4 (the reference's SSD tolerance; its MoE claim holds
at 2e-4)."""
import _torch_threads  # noqa: F401  (one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

from repro.models import common as ref_common
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro_torch import interop
from repro_torch.dist import sharding as shd
from repro_torch.models.common import ModelConfig
from repro_torch.models.moe import (init_moe, moe_block, moe_block_ep,
                                    moe_block_scatter, moe_capacity)
from repro_torch.models.ssm import (init_mamba2, init_ssm_cache,
                                    mamba2_block, ssd_chunked,
                                    ssd_decode_step)

TOL = dict(rtol=1e-4, atol=1e-4)


def _ssd_inputs(seed=0, B=2, L=32, H=3, P=5, N=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, L, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.5, (B, L, H)).astype(np.float32),
            (-rng.uniform(0.5, 2.0, (H,))).astype(np.float32),
            rng.normal(size=(B, L, N)).astype(np.float32),
            rng.normal(size=(B, L, N)).astype(np.float32))


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_ssd_chunked_matches_recurrence_and_reference(chunk):
    arrays = _ssd_inputs()
    x, dt, A, Bm, Cm = (torch.as_tensor(a) for a in arrays)
    state = torch.zeros((2, 3, 7, 5))
    ys = []
    for t in range(32):
        state, y = ssd_decode_step(state, x[:, t], dt[:, t], A,
                                   Bm[:, t], Cm[:, t])
        ys.append(y)
    rec = torch.stack(ys, dim=1)
    got, fs = ssd_chunked(x, dt, A, Bm, Cm, chunk, return_state=True)
    np.testing.assert_allclose(got.numpy(), rec.numpy(), **TOL)
    np.testing.assert_allclose(fs.numpy(), state.numpy(), **TOL)
    ry, rfs = ref_ssm.ssd_chunked(*(jnp.asarray(a) for a in arrays), chunk,
                                  return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(fs.numpy(), np.asarray(rfs), **TOL)


def _ssm_cfgs():
    kw = dict(name="t", family="ssm", n_layers=1, d_model=16, n_heads=0,
              d_ff=0, vocab=8, d_state=8, ssm_head_dim=8, ssm_chunk=8,
              dtype="float32")
    return ref_common.ModelConfig(**kw), ModelConfig(**kw)


def test_mamba_block_prefill_equals_stepwise():
    rcfg, cfg = _ssm_cfgs()
    rp = ref_ssm.init_mamba2(jax.random.PRNGKey(1), rcfg)
    p = interop.params_from_reference(jax.tree.map(np.asarray, rp), cfg,
                                      device="cpu")
    xa = np.random.default_rng(0).normal(size=(2, 16, 16)).astype(np.float32)
    x = torch.as_tensor(xa)
    out_pf, cache_pf = mamba2_block(p, x, cfg,
                                    cache=init_ssm_cache(cfg, 2, "cpu"),
                                    pos=0)
    cache = init_ssm_cache(cfg, 2, "cpu")
    outs = []
    for t in range(16):
        o, cache = mamba2_block(p, x[:, t:t + 1], cfg, cache=cache, pos=t)
        outs.append(o)
    np.testing.assert_allclose(out_pf.numpy(), torch.cat(outs, 1).numpy(),
                               **TOL)
    np.testing.assert_allclose(cache_pf["ssm"].numpy(),
                               cache["ssm"].numpy(), **TOL)
    rout, rcache = ref_ssm.mamba2_block(
        rp, jnp.asarray(xa), rcfg, cache=ref_ssm.init_ssm_cache(rcfg, 2),
        pos=0)
    np.testing.assert_allclose(out_pf.numpy(), np.asarray(rout), **TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(cache_pf[k].numpy(),
                                   np.asarray(rcache[k]), **TOL)


def _moe_cfgs(**kw):
    base = dict(name="t", family="moe_gqa", n_layers=1, d_model=16,
                n_heads=4, d_ff=32, vocab=8, n_experts=4, top_k=2,
                d_ff_expert=32, capacity_factor=8.0, dtype="float32")
    base.update(kw)
    return ref_common.ModelConfig(**base), ModelConfig(**base)


def _moe_params(rcfg, cfg, seed=0):
    rp = ref_moe.init_moe(jax.random.PRNGKey(seed), rcfg)
    return rp, interop.params_from_reference(jax.tree.map(np.asarray, rp),
                                             cfg, device="cpu")


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_matches_per_token_dense_reference(shared):
    """With huge capacity (no drops), scatter MoE == explicit per-token
    top-k mixture; and == the reference's scatter MoE."""
    rcfg, cfg = _moe_cfgs(n_shared_experts=shared)
    rp, p = _moe_params(rcfg, cfg)
    xa = np.random.default_rng(1).normal(size=(2, 8, 16)).astype(np.float32)
    x = torch.as_tensor(xa)
    out, aux = moe_block_scatter(p, x, cfg)
    out2, aux2 = moe_block(p, x, cfg)
    assert torch.equal(out, out2) and torch.equal(aux, aux2)

    xf = x.reshape(-1, 16)
    probs = torch.softmax(xf @ p["router"], -1)
    gate, idx = torch.topk(probs, 2)
    gate = gate / gate.sum(-1, keepdim=True)
    ref = torch.zeros_like(xf)
    for e in range(4):
        h = Fn.silu(xf @ p["w_gate"][e]) * (xf @ p["w_up"][e])
        ye = h @ p["w_down"][e]
        for j in range(2):
            m = idx[:, j] == e
            ref[m] += gate[:, j][m, None] * ye[m]
    if shared:
        sp = p["shared"]
        ref += (Fn.silu(xf @ sp["w_gate"]) * (xf @ sp["w_up"])) \
            @ sp["w_down"]
    np.testing.assert_allclose(out.reshape(-1, 16).numpy(), ref.numpy(),
                               rtol=2e-4, atol=2e-4)
    assert float(aux) > 0
    rout, raux = ref_moe.moe_block_scatter(rp, jnp.asarray(xa), rcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **TOL)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)


@pytest.mark.parametrize("factor", [0.01, 0.3])
def test_moe_capacity_drops_overflow(factor):
    """Overflow tokens drop (finite outputs; the same drops as the
    reference: its outputs equal the port's)."""
    rcfg, cfg = _moe_cfgs(capacity_factor=factor)
    rp, p = _moe_params(rcfg, cfg)
    xa = np.random.default_rng(2).normal(size=(4, 16, 16)).astype(np.float32)
    out, _ = moe_block_scatter(p, torch.as_tensor(xa), cfg)
    assert torch.isfinite(out).all()
    rout, _ = ref_moe.moe_block_scatter(rp, jnp.asarray(xa), rcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **TOL)
    ones, _ = moe_block_scatter(p, torch.ones((4, 16, 16)), cfg)
    assert torch.isfinite(ones).all()
    assert moe_capacity(cfg, 64) >= 8  # floor
    # capacity 8 of 64 tokens x 2 choices over 4 experts: some rows drop
    # to zero output (no shared expert), as the reference's
    if factor == 0.01:
        dropped = (out.reshape(-1, 16).abs().sum(-1) == 0).sum()
        assert int(dropped) > 0
        assert int(dropped) == int((np.abs(np.asarray(rout)).reshape(
            -1, 16).sum(-1) == 0).sum())


def test_moe_capacity_formula():
    rcfg, cfg = _moe_cfgs(capacity_factor=1.25)
    assert moe_capacity(cfg, 1024) == int(np.ceil(1024 * 2 / 4 * 1.25))
    for n in (1, 7, 64, 1000):
        assert moe_capacity(cfg, n) == ref_moe.moe_capacity(rcfg, n)


def test_single_device_sharding():
    """No mesh: `constrain` is the identity and `active` None, as the
    reference's without a mesh; the tree shardings and expert parallelism
    raise as the reference's do without one (RuntimeError, "set_mesh").
    Under a one-process lane mesh the tree shardings give the
    reference's specs by shape (its data axis splits the largest
    divisible dim), while model code raises, naming model sharding:
    expert parallelism and `constrain`. `set_mesh` takes only the port's
    own Mesh. (Model sharding over a world mesh:
    tests/test_torch_dist_*.py.)"""
    x = torch.arange(6.0).reshape(2, 3)
    assert shd.constrain(x, ("dp", None)) is x
    assert shd.set_mesh(None) is None and shd.active() is None
    with pytest.raises(TypeError, match="Mesh"):
        shd.set_mesh(object())
    _, cfg = _moe_cfgs()
    for fn, args in ((shd.param_shardings, ({},)),
                     (shd.batch_shardings, ({},)),
                     (shd.cache_shardings, ({}, None))):
        with pytest.raises(RuntimeError, match="set_mesh"):
            fn(*args)
    with pytest.raises(RuntimeError, match="set_mesh"):
        moe_block_ep({}, torch.zeros((1, 2, 16)), cfg)
    shd.set_mesh(shd.Mesh(["cpu"] * 2))
    try:
        assert shd.active().mesh.shape == {"data": 2}
        specs = shd.param_shardings({"w": torch.empty((3, 8), device="meta"),
                                     "b": torch.empty((8,), device="meta")})
        assert specs["w"].spec == shd.P(None, "data")
        assert specs["b"].spec == shd.P()
        assert shd.batch_shardings(x).spec == shd.P("data", None)
        with pytest.raises(NotImplementedError, match="model sharding"):
            moe_block_ep({}, torch.zeros((1, 2, 16)), cfg)
        with pytest.raises(NotImplementedError, match="model sharding"):
            shd.constrain(x, ("dp", None))
    finally:
        shd.set_mesh(None)
    assert shd.constrain(x, ("dp", None)) is x


def test_init_shapes_match_reference():
    """The port's own init draws the reference's shapes and dtypes."""
    rcfg, cfg = _moe_cfgs(n_shared_experts=1, dtype="bfloat16")
    rp = jax.tree.map(np.asarray, ref_moe.init_moe(jax.random.PRNGKey(0),
                                                   rcfg))
    p = init_moe(torch.Generator().manual_seed(0), cfg)
    for k in ("router", "w_gate", "w_up", "w_down"):
        assert tuple(p[k].shape) == rp[k].shape
        assert str(p[k].dtype).split(".")[1] == rp[k].dtype.name
    rcfg, cfg = _ssm_cfgs()
    rp = jax.tree.map(np.asarray, ref_ssm.init_mamba2(jax.random.PRNGKey(0),
                                                      rcfg))
    p = init_mamba2(torch.Generator().manual_seed(0), cfg)
    for k in rp:
        if k != "norm":
            assert tuple(p[k].shape) == rp[k].shape, k
