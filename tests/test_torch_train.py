"""The port's training substrate (``repro_torch.train``) against the JAX
reference's (``repro.train``) on the CPU, and the reference's own claims
(``tests/test_checkpoint_train.py``) held on the port.

Inputs are NumPy-seeded; model parameters and optimizer state are the
reference's, carried across (``interop.params_from_reference``,
``opt_from_reference``). The reference runs jitted, as its launcher runs
it (XLA then turns a division by a constant into a multiply by its f32
reciprocal, which the port repeats). Tolerances:

* ``optimizer.apply`` on the same trees: new master, m and v within 2 f32
  ulp of the reference's (XLA may contract a multiply-add), the gradient
  norm at rtol 1e-6, bf16 params equal or one bf16 ulp apart where the
  master lies within 2 f32 ulp of a bf16 rounding boundary. The norm is
  a sum over leaves in a different order, so the clipping case uses
  gradients whose squares sum exactly in any order.
* Train steps (smoke config, f32): the first loss at rtol 1e-4 (the
  forward's tolerance); one step's new ``m`` (the clipped gradient, so
  the microbatch accumulation) at rtol 1e-4 / atol 1e-5 of each leaf's
  largest entry, and with ``compress_grads`` at rtol 2^-7 / atol 2^-8 of
  the leaf's largest entry (each microbatch's gradient is rounded to
  bf16: a gradient a few f32 ulp from a bf16 rounding boundary rounds one
  bf16 ulp apart, and where two microbatches' gradients nearly cancel
  that ulp is the whole difference). The second
  and third losses at rtol 1e-3: AdamW's first update is lr * sign(g)
  for every entry, so an entry whose gradient is within rounding of 0 can
  move by 2 lr the other way in one package.
* Checkpoints of a tree of plain dicts (f32, bf16, an int32 scalar)
  interchange bit for bit in both directions.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.models import model as RM
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch import interop
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.train_step import make_train_step

ARCH = "internlm2_1_8b"


def _bf16(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)


def _ordered(a: np.ndarray) -> np.ndarray:
    """f32 values as integers whose differences count ulps."""
    i = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(2 ** 31) - i, i)


def _ulps(got, want) -> int:
    return int(np.abs(_ordered(got) - _ordered(want)).max())


def _to_port(tree):
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return _bf16(a.astype(np.float32))
    return torch.tensor(a)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------ optimizer ----
def _opt_case(seed, clip: bool, step: int):
    rng = np.random.default_rng(seed)
    shapes = {"a": (17, 33), "b": {"c": (64,), "d": (5, 7, 9)}}

    def tree(fn):
        return {"a": fn(shapes["a"]),
                "b": {"c": fn(shapes["b"]["c"]), "d": fn(shapes["b"]["d"])}}
    if clip:   # dyadic gradients: their squares sum exactly in any order
        grads = tree(lambda s: rng.choice([-2.0, -0.5, 0.25, 1.0], s)
                     .astype(np.float32))
    else:
        grads = tree(lambda s: (rng.normal(size=s) * 1e-3).astype(np.float32))
    master = tree(lambda s: rng.normal(size=s).astype(np.float32))
    params = {"a": master["a"].astype(jnp.bfloat16),
              "b": {"c": master["b"]["c"], "d": master["b"]["d"]
                    .astype(jnp.bfloat16)}}
    m = tree(lambda s: (rng.normal(size=s) * 1e-3).astype(np.float32))
    v = tree(lambda s: (rng.uniform(0.0, 1e-5, s)).astype(np.float32))
    if step == 0:
        m = jax.tree.map(np.zeros_like, m)
        v = jax.tree.map(np.zeros_like, v)
    return grads, params, ref_opt.OptState(np.int32(step), master, m, v)


@pytest.mark.parametrize("clip,step", [(False, 0), (False, 7), (True, 0),
                                       (True, 150)])
def test_adamw_apply_matches_reference(clip, step):
    grads, params, opt = _opt_case(step + clip, clip, step)
    cfg = ref_opt.AdamWConfig()
    rp, ro, rn = jax.jit(lambda g, p, o: ref_opt.apply(g, p, o, cfg))(
        grads, params, opt)
    port_opt = opt_lib.OptState(torch.tensor(step, dtype=torch.int32),
                                _to_port(opt.master), _to_port(opt.m),
                                _to_port(opt.v))
    pp, po, pn = opt_lib.apply(_to_port(grads), _to_port(params), port_opt,
                               opt_lib.AdamWConfig())
    assert (float(rn) > cfg.grad_clip) == clip
    np.testing.assert_allclose(float(pn), float(rn), rtol=1e-6)
    assert po.step.dtype == torch.int32 and int(po.step) == step + 1
    for name in ("master", "m", "v"):
        for got, want in zip(opt_lib.leaves(getattr(po, name)),
                             jax.tree.leaves(getattr(ro, name))):
            assert got.dtype == torch.float32
            assert _ulps(got.numpy(), np.asarray(want)) <= 2, name
    for got, want, ma in zip(opt_lib.leaves(pp), jax.tree.leaves(rp),
                             jax.tree.leaves(ro.master)):
        want = np.asarray(want).astype(np.float32)
        got = got.float().numpy()
        assert str(got.dtype) == "float32"
        off = got != want
        if off.any():     # master within 2 ulp of a bf16 rounding boundary
            ma = np.asarray(ma)[off]
            lo = np.nextafter(np.nextafter(ma, -np.inf), -np.inf)
            hi = np.nextafter(np.nextafter(ma, np.inf), np.inf)
            assert (_bf16(lo) != _bf16(hi)).all()
            assert (np.abs(got[off] - want[off])
                    <= np.abs(want[off]) * 2.0 ** -7).all()


def test_optimizer_state_layout():
    """`init` keeps f32 master, m and v beside the params' dtype and a 0-d
    int32 step on the params' device; `leaves` takes sorted keys."""
    params = {"w": torch.ones(3, 2, dtype=torch.bfloat16),
              "a": [{"z": torch.zeros(4), "b": torch.ones(1)}]}
    opt = opt_lib.init(params)
    assert opt.step.shape == () and opt.step.dtype == torch.int32
    assert [t.dtype for t in opt_lib.leaves(opt.master)] == [torch.float32] * 3
    assert [tuple(t.shape) for t in opt_lib.leaves(params)] == \
        [(1,), (4,), (3, 2)]
    assert opt.master["w"] is not params["w"]
    assert list(opt_lib.unflatten(params, [1, 2, 3])) == ["w", "a"]


# ----------------------------------------------------------- train step ----
def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32", cache_dtype="float32")


def _pair(arch=ARCH, seed=0):
    rcfg = _f32(ref_smoke_config(ref_get_config(arch)))
    cfg = _f32(smoke_config(get_config(arch)))
    rparams = RM.init(jax.random.PRNGKey(seed), rcfg)
    ropt = ref_opt.init(rparams)
    params = interop.params_from_reference(_np(rparams), cfg, device="cpu")
    opt = interop.opt_from_reference(_np(ropt), cfg, device="cpu")
    return rcfg, cfg, rparams, ropt, params, opt


def _batches(cfg, n, B=4, S=32, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        out.append(({"tokens": jnp.asarray(t), "labels": jnp.asarray(t)},
                    {"tokens": torch.as_tensor(t), "labels":
                     torch.as_tensor(t)}))
    return out


def _close_leaves(got_tree, want_tree, cfg, rtol, atol):
    """Leaf by leaf, atol relative to each leaf's largest entry."""
    want = interop.params_from_reference(_np(want_tree), cfg, device="cpu")
    for got, exp in zip(opt_lib.leaves(got_tree), opt_lib.leaves(want)):
        exp = exp.numpy()
        np.testing.assert_allclose(got.numpy(), exp, rtol=rtol,
                                   atol=atol * max(np.abs(exp).max(), 1e-30))


def test_opt_from_reference_layout():
    rcfg, cfg, rparams, ropt, params, opt = _pair()
    assert opt.step.dtype == torch.int32 and int(opt.step) == 0
    assert len(opt.master["layers"]) == cfg.n_layers
    for a, b in zip(opt_lib.leaves(opt.master), opt_lib.leaves(params)):
        assert a.shape == b.shape and a.dtype == torch.float32


@pytest.mark.parametrize("microbatches,compress", [(1, False), (2, False),
                                                   (2, True)])
def test_train_steps_match_reference(microbatches, compress):
    """Three steps from the same params and state: losses, and after one
    step the moments (the accumulated gradient)."""
    rcfg, cfg, rparams, ropt, params, opt = _pair()
    ocfg = ref_opt.AdamWConfig(lr=1e-2, warmup_steps=1)
    rts = jax.jit(ref_make_train_step(rcfg, ocfg, microbatches=microbatches,
                                      compress_grads=compress))
    ts = make_train_step(cfg, opt_lib.AdamWConfig(lr=1e-2, warmup_steps=1),
                         microbatches=microbatches, compress_grads=compress)
    for i, (rb, pb) in enumerate(_batches(cfg, 3)):
        rparams, ropt, rm = rts(rparams, ropt, rb)
        params, opt, m = ts(params, opt, pb)
        assert set(m) == {"loss", "grad_norm", "ce", "aux"}
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=1e-4 if i == 0 else 1e-3)
        if i == 0:
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(rm["grad_norm"]), rtol=1e-4)
            if microbatches > 1:
                assert float(m["aux"]) == 0.0 == float(rm["aux"])
            _close_leaves(opt.m, ropt.m, cfg,
                          *((2.0 ** -7, 2.0 ** -8) if compress
                            else (1e-4, 1e-5)))
    assert int(opt.step) == 3


def _tiny_train(arch=ARCH, steps=8, microbatches=1):
    """The reference's `_tiny_train` on the port (its own random init)."""
    cfg = smoke_config(get_config(arch))
    params = M.init(0, cfg, device="cpu")
    opt_state = opt_lib.init(params)
    ts = make_train_step(cfg, opt_lib.AdamWConfig(lr=1e-2, warmup_steps=1),
                         microbatches=microbatches, remat=False)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 32)),
                           dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    losses = []
    for _ in range(steps):
        params, opt_state, metrics = ts(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
    return losses


def test_adamw_decreases_loss():
    losses = _tiny_train()
    assert losses[-1] < losses[0] - 0.3


def test_grad_accumulation_equivalent():
    l1 = _tiny_train(steps=3, microbatches=1)
    l2 = _tiny_train(steps=3, microbatches=2)
    np.testing.assert_allclose(l1, l2, rtol=2e-2, atol=2e-2)


def test_train_step_leaves_its_inputs_alone():
    cfg = smoke_config(get_config(ARCH))
    params = M.init(0, cfg, device="cpu")
    opt = opt_lib.init(params)
    before = [t.clone() for t in opt_lib.leaves((params, opt))]
    toks = torch.ones((2, 16), dtype=torch.int32)
    new_p, new_o, _ = make_train_step(cfg, microbatches=2)(
        params, opt, {"tokens": toks, "labels": toks})
    for a, b in zip(opt_lib.leaves((params, opt)), before):
        assert torch.equal(a, b)
    assert all(not t.requires_grad for t in opt_lib.leaves((new_p, new_o)))


# ----------------------------------------------------------- checkpoint ----
def _tree(seed=0):
    """The reference's `_tree`, as NumPy (f32, bf16, an int32 scalar)."""
    k = jax.random.PRNGKey(seed)
    return _np({"a": jax.random.normal(k, (4, 8)),
                "b": {"c": jnp.ones((3,), jnp.bfloat16),
                      "d": jnp.int32(7)}})


def _port_tree(seed=0):
    return _to_port(_tree(seed))


def _assert_same(port_tree, ref_tree):
    for a, b in zip(opt_lib.leaves(port_tree), jax.tree.leaves(ref_tree)):
        b = np.asarray(b)
        if b.dtype.name == "bfloat16":
            assert a.dtype == torch.bfloat16
            assert np.array_equal(a.view(torch.int16).numpy(),
                                  b.view(np.int16))
        else:
            assert str(a.numpy().dtype) == str(b.dtype)
            np.testing.assert_array_equal(a.numpy(), b)


def test_save_restore_roundtrip(tmp_path):
    t = _port_tree()
    ckpt.save(tmp_path, 5, t)
    restored, step = ckpt.restore(tmp_path, t)
    assert step == 5
    _assert_same(restored, _tree())


def test_checkpoints_interchange_with_the_reference(tmp_path):
    """A tree saved by either package restores bit for bit in the other."""
    ref_ckpt.save(tmp_path / "ref", 3, _tree(1))
    restored, step = ckpt.restore(tmp_path / "ref", _port_tree(),
                                  device="cpu")
    assert step == 3
    _assert_same(restored, _tree(1))
    ckpt.save(tmp_path / "port", 4, _port_tree(2))
    back, step = ref_ckpt.restore(tmp_path / "port", jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), _tree(2)))
    assert step == 4
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_tree(2))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def test_latest_step_and_retention(tmp_path):
    for s in [1, 2, 3, 4]:
        ckpt.save(tmp_path, s, _port_tree())
    assert ckpt.latest_step(tmp_path) == 4
    ckpt.retain(tmp_path, keep=2)
    assert ckpt.latest_step(tmp_path) == 4
    with pytest.raises((AssertionError, FileNotFoundError)):
        ckpt.restore(tmp_path, _port_tree(), step=1)


def test_tmp_dirs_ignored(tmp_path):
    ckpt.save(tmp_path, 1, _port_tree())
    os.makedirs(tmp_path / "step_00000009.tmp")   # simulated dead write
    assert ckpt.latest_step(tmp_path) == 1


def test_async_checkpointer(tmp_path):
    ac = ckpt.AsyncCheckpointer(tmp_path, keep=2)
    for s in range(3):
        ac.save(s, _port_tree(s))
    ac.close()
    assert ckpt.latest_step(tmp_path) == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000001", "step_00000002"]
    restored, _ = ckpt.restore(tmp_path, _port_tree())
    _assert_same(restored, _tree(2))


def test_async_checkpointer_raises_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    ac = ckpt.AsyncCheckpointer(blocker / "sub")   # cannot be a directory
    ac.save(1, _port_tree())
    with pytest.raises(OSError):
        ac.wait()


def test_restore_shape_mismatch_raises(tmp_path):
    ckpt.save(tmp_path, 1, {"a": torch.ones((4,))})
    with pytest.raises(AssertionError):
        ckpt.restore(tmp_path, {"a": torch.empty((5,), device="meta")},
                     device="cpu")


def test_restore_onto_a_mesh_raises(tmp_path):
    """A one-process lane mesh holds no model's shards: restoring onto it,
    or with shardings on it, raises; so does the multi-pod mesh, which
    the port cannot build (the elastic restore onto a world mesh:
    tests/test_torch_dist_sharding.py)."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import mesh as launch_mesh
    ckpt.save(tmp_path, 1, {"a": torch.ones((4,))})
    lane = launch_mesh.make_debug_mesh(2, 2)
    for kw in ({"mesh": lane},
               {"shardings": {"a": shd.NamedSharding(lane, shd.P("data"))}}):
        with pytest.raises(NotImplementedError, match="lane mesh"):
            ckpt.restore(tmp_path, {"a": torch.ones((4,))}, **kw)
    with pytest.raises(NotImplementedError, match="multi-pod"):
        ckpt.restore(tmp_path, {"a": torch.ones((4,))},
                     mesh=launch_mesh.make_production_mesh(multi_pod=True))


def test_train_resume_from_checkpoint(tmp_path):
    cfg = smoke_config(get_config(ARCH))
    params = M.init(0, cfg, device="cpu")
    opt_state = opt_lib.init(params)
    ckpt.save(tmp_path, 0, {"params": params, "opt": opt_state})
    target = {"params": params, "opt": opt_state}
    restored, step = ckpt.restore(tmp_path, target)
    for a, b in zip(opt_lib.leaves(restored), opt_lib.leaves(target)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    ts = make_train_step(cfg, remat=False)
    toks = torch.ones((2, 16), dtype=torch.int32)
    p2, o2, m = ts(restored["params"], restored["opt"],
                   {"tokens": toks, "labels": toks})
    assert np.isfinite(float(m["loss"]))


def test_resume_continues_bit_for_bit(tmp_path):
    """Steps 1-2, a checkpoint, steps 3-4; restored into fresh tensors,
    steps 3-4 again give the same params, moments and losses."""
    cfg = smoke_config(get_config(ARCH))
    ts = make_train_step(cfg, microbatches=2)
    params = M.init(0, cfg, device="cpu")
    opt = opt_lib.init(params)
    batches = [b for _, b in _batches(cfg, 4, B=4, S=16, seed=3)]
    for b in batches[:2]:
        params, opt, _ = ts(params, opt, b)
    ac = ckpt.AsyncCheckpointer(tmp_path, keep=1)
    ac.save(2, {"params": params, "opt": opt})
    runs = []
    for b in batches[2:]:
        params, opt, m = ts(params, opt, b)
        runs.append(float(m["loss"]))
    ac.close()
    fresh = M.init(1, cfg, device="cpu")
    state, step = ckpt.restore(tmp_path, {"params": fresh,
                                          "opt": opt_lib.init(fresh)})
    assert step == 2
    p2, o2 = state["params"], state["opt"]
    again = []
    for b in batches[2:]:
        p2, o2, m = ts(p2, o2, b)
        again.append(float(m["loss"]))
    assert again == runs
    for a, b in zip(opt_lib.leaves((p2, o2)), opt_lib.leaves((params, opt))):
        assert torch.equal(a, b)


def test_launcher_trains_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train as launcher
    argv = ["--arch", ARCH, "--local-smoke", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    seen = []
    launcher.main(argv + ["--steps", "4"],
                  on_step=lambda s, m: seen.append(float(m["loss"])))
    assert len(seen) == 4 and np.isfinite(seen).all()
    assert ckpt.latest_step(tmp_path) == 4
    launcher.main(argv + ["--steps", "5"])
    assert "[train] resumed at step 4" in capsys.readouterr().out


def test_launcher_refusals():
    """``--multi-pod`` (the reference's 2x16x16 mesh across hosts) is not
    in the port and raises (``--coordinator`` joins a world:
    tests/test_torch_dist_sharding.py); without CUDA the default device
    raises."""
    from repro_torch.launch import train as launcher
    with pytest.raises(NotImplementedError, match="multi-pod"):
        launcher.main(["--arch", ARCH, "--multi-pod"])
    if not torch.cuda.is_available():       # the card is the default
        with pytest.raises(RuntimeError, match="CUDA"):
            launcher.main(["--arch", ARCH, "--local-smoke", "--steps", "1"])
