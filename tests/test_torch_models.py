"""The port's model substrate (``repro_torch.models``, ``repro_torch.configs``)
against the JAX reference's on the CPU, at ``smoke_config`` sizes with
``dtype``/``cache_dtype`` "float32".

For every arch, the reference's initialized parameters are carried across
(``interop.params_from_reference``; ``jax.random`` cannot be replicated)
and the same NumPy-seeded tokens (and stub-frontend embeddings) go through
both packages: prefill logits, and decode logits from the reference's
carried cache and from the port's own prefill cache, at rtol 1e-4 /
atol 1e-4 (the SSD tests' tolerance). The reference's own model claims
are held on the port: shapes and finite values of forward, loss, prefill
and decode; decode token by token against the full forward; parameter
counts of the full configs.
"""
import _torch_threads  # noqa: F401  (one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.models import model as RM
from repro_torch import interop
from repro_torch.configs import (ARCH_IDS, SHAPES, cells, get_config,
                                 smoke_config)
from repro_torch.models import model as M

TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 8


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32", cache_dtype="float32")


def _inputs(cfg, seed=0, n_text=S):
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab, (B, n_text))
              .astype(np.int32)}
    if cfg.n_img_tokens:
        arrays["img_embeds"] = rng.normal(
            size=(B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        arrays["enc_embeds"] = rng.normal(
            size=(B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    ref = {k: jnp.asarray(v) for k, v in arrays.items()}
    port = {k: torch.as_tensor(v).long() if k == "tokens"
            else torch.as_tensor(v) for k, v in arrays.items()}
    return ref, port


def test_configs_match_reference():
    from repro.configs import ARCH_IDS as REF_IDS
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import cells as ref_cells
    assert ARCH_IDS == REF_IDS
    assert {k: tuple(dataclasses.astuple(v)) for k, v in SHAPES.items()} \
        == {k: tuple(dataclasses.astuple(v)) for k, v in REF_SHAPES.items()}
    assert cells() == ref_cells()
    for arch in ARCH_IDS:
        for cfg, ref in ((get_config(arch), ref_get_config(arch)),
                         (smoke_config(get_config(arch)),
                          ref_smoke_config(ref_get_config(arch)))):
            assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
            assert cfg.param_count() == ref.param_count()
            assert cfg.active_param_count() == ref.active_param_count()
            assert (cfg.kv_heads, cfg.d_inner, cfg.ssm_heads) \
                == (ref.kv_heads, ref.d_inner, ref.ssm_heads)
            if cfg.n_heads:
                assert cfg.hdim == ref.hdim
        assert str(get_config(arch).jdtype) == "torch.bfloat16"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_match_reference(arch):
    rcfg = _f32(ref_smoke_config(ref_get_config(arch)))
    cfg = _f32(smoke_config(get_config(arch)))
    rparams = RM.init(jax.random.PRNGKey(0), rcfg)
    params = interop.params_from_reference(
        jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    rb, pb = _inputs(cfg)
    rlg, rcache = RM.prefill(rparams, rb, rcfg, max_len=16)
    lg, cache = M.prefill(params, pb, cfg, 16)
    np.testing.assert_allclose(lg.numpy(), np.asarray(rlg), **TOL)

    pos = S + (cfg.n_img_tokens or 0)
    nxt = np.random.default_rng(1).integers(0, cfg.vocab, (B, 1))
    rlg2, _ = RM.decode_step(rparams, rcache, jnp.asarray(nxt, jnp.int32),
                             jnp.int32(pos), rcfg)
    carried = interop.cache_from_reference(
        jax.tree.map(np.asarray, rcache), cfg, device="cpu")
    for c in (carried, cache):
        lg2, _ = M.decode_step(params, c, torch.as_tensor(nxt), pos, cfg)
        assert lg2.shape == (B, 1, cfg.vocab)
        np.testing.assert_allclose(lg2.numpy(), np.asarray(rlg2), **TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_forward_and_decode(arch):
    """The reference's smoke claims on the port (its own random init):
    shapes, finite logits, finite loss."""
    cfg = smoke_config(get_config(arch))
    params = M.init(0, cfg, device="cpu")
    n_text = 32 - (cfg.n_img_tokens or 0)
    batch = {"tokens": torch.ones((B, n_text), dtype=torch.long),
             "labels": torch.ones((B, n_text), dtype=torch.long)}
    if cfg.n_img_tokens:
        batch["img_embeds"] = torch.zeros((B, cfg.n_img_tokens,
                                           cfg.d_model), dtype=cfg.jdtype)
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.zeros((B, cfg.enc_len, cfg.d_model),
                                          dtype=cfg.jdtype)
    loss, parts = M.loss_fn(params, batch, cfg)
    assert np.isfinite(float(loss)) and set(parts) == {"ce", "aux"}
    logits, _ = M.forward(params, batch, cfg)
    assert logits.shape == (B, n_text, cfg.vocab)
    assert torch.isfinite(logits.float()).all()
    nolab = {k: v for k, v in batch.items() if k != "labels"}
    lg, cache = M.prefill(params, nolab, cfg, max_len=64)
    assert lg.shape == (B, 1, cfg.vocab)
    lg2, _ = M.decode_step(params, cache, torch.ones((B, 1),
                                                     dtype=torch.long),
                           n_text + (cfg.n_img_tokens or 0), cfg)
    assert lg2.shape == (B, 1, cfg.vocab)
    assert torch.isfinite(lg2.float()).all()


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "mamba2_2_7b",
                                  "zamba2_2_7b"])
def test_prefill_decode_consistency(arch):
    """Decoding token by token equals prefill at the same positions, at
    the reference's bf16 tolerance."""
    cfg = smoke_config(get_config(arch))
    params = M.init(1, cfg, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, 8)))
    atol = 0.1 if arch == "zamba2_2_7b" else 0.05
    full, _ = M.forward(params, {"tokens": toks}, cfg, remat=False)
    lg, cache = M.prefill(params, {"tokens": toks[:, :4]}, cfg, max_len=16)
    np.testing.assert_allclose(lg[:, 0].float().numpy(),
                               full[:, 3].float().numpy(), rtol=0.05,
                               atol=atol)
    for t in range(4, 8):
        lg, cache = M.decode_step(params, cache, toks[:, t:t + 1], t, cfg)
        np.testing.assert_allclose(lg[:, 0].float().numpy(),
                                   full[:, t].float().numpy(), rtol=0.05,
                                   atol=atol)


def test_param_counts_match_configs():
    """Full configs' parameter counts are near their nominal sizes."""
    expect = {"stablelm_1_6b": 1.6e9, "deepseek_67b": 67e9,
              "mistral_nemo_12b": 12e9, "internlm2_1_8b": 1.8e9,
              "mamba2_2_7b": 2.7e9, "deepseek_v2_lite_16b": 16e9,
              "qwen3_moe_30b_a3b": 30e9}
    for arch, nominal in expect.items():
        n = get_config(arch).param_count()
        assert 0.55 * nominal < n < 1.55 * nominal, (arch, n, nominal)
    cfg = get_config("qwen3_moe_30b_a3b")
    assert cfg.active_param_count() < 0.25 * cfg.param_count()


def test_init_counts_and_generator():
    """`init` draws every parameter from the generator it is given (the
    same seed gives the same weights) and holds `param_count`'s
    parameters for a dense arch."""
    cfg = smoke_config(get_config("stablelm_1_6b"))
    a = M.init(3, cfg, device="cpu")
    gen = torch.Generator().manual_seed(3)
    b = M.init(gen, cfg)
    flat = []

    def walk(x, y):
        if isinstance(x, dict):
            for k in x:
                walk(x[k], y[k])
        elif isinstance(x, list):
            for u, v in zip(x, y):
                walk(u, v)
        else:
            assert torch.equal(x, y)
            flat.append(x)
    walk(a, b)
    n_norm = (2 * cfg.n_layers + 1) * cfg.d_model
    assert sum(t.numel() for t in flat) - n_norm == cfg.param_count()
    assert a["embed"].dtype == torch.bfloat16


def test_cache_from_reference_layout():
    """The reference's layer-stacked cache becomes per-layer lists with
    its dtypes, bf16 included."""
    rcfg = ref_smoke_config(ref_get_config("zamba2_2_7b"))
    cfg = smoke_config(get_config("zamba2_2_7b"))
    rcache = jax.tree.map(np.asarray, RM.init_cache(rcfg, 2, 16))
    cache = interop.cache_from_reference(rcache, cfg, device="cpu")
    want = M.init_cache(cfg, 2, 16, device="cpu")
    assert len(cache["layers"]) == len(want["layers"]) == cfg.n_layers
    assert len(cache["shared"]) == len(want["shared"]) == 2
    for got, ref in ((cache["layers"][0], want["layers"][0]),
                     (cache["shared"][1], want["shared"][1])):
        for k in ref:
            assert got[k].dtype == ref[k].dtype and \
                got[k].shape == ref[k].shape, k
