"""The port's launch tools (``repro_torch.launch.{specs,dryrun,roofline,
mesh}``) against the JAX reference's on the CPU, on the meta device.

* ``param_specs`` holds as many elements as the reference's
  ``jax.eval_shape(M.init)`` for every arch's full config, and the
  optimizer and cache specs mirror the reference's dtypes and sizes;
  ``input_specs`` has the reference's shapes and dtypes and
  ``train_microbatches`` its values, for all 32 cells (``dp_size`` 1 and
  16). ``parse_collectives`` equals the reference's on an HLO snippet.
* ``dryrun.run_cell`` is ok for all 32 cells, with exact argument bytes.
* The counted FLOPs of a dense smoke train step equal the analytic count
  from the shapes: the forward's products (projections, attention, MLP,
  head) times 3 (forward and backward), plus one forward of the attention
  products (each flash query chunk is rematerialized, as in the
  reference), plus with remat one forward of each layer but its last
  product (the down projection, whose output no backward needs:
  ``torch.utils.checkpoint`` stops recomputing there). The counter equals
  ``FlopCounterMode``'s count, and the probes' extrapolation equals a
  trace at the full depth.
* The dry run records the multi-pod mesh; the mesh itself and
  ``launch.train --multi-pod`` raise; the production mesh needs a card,
  the debug mesh builds on the CPU.
"""
import _torch_threads  # noqa: F401  (one torch thread)
import dataclasses
import os

import jax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as ref_get_config
from repro.launch import specs as ref_specs
from repro_torch.configs import ARCH_IDS, SHAPES, cells, get_config
from repro_torch.configs import smoke_config
from repro_torch.configs.registry import ShapeSpec
from repro_torch.launch import dryrun, mesh, roofline
from repro_torch.launch import specs as sp
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.train_step import make_train_step

CELLS = cells()


def _ref_dryrun():
    """The reference's dryrun module, whose import sets ``XLA_FLAGS`` for
    512 host devices: the backend is initialized first (it keeps one
    device) and the variable is restored."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


def _numel(tree) -> int:
    return sum(t.numel() for t in opt_lib.leaves(tree))


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    params = sp.param_specs(cfg)
    ref = ref_specs.param_specs(rcfg)
    assert all(t.device.type == "meta" for t in opt_lib.leaves(params))
    assert _numel(params) == sum(x.size for x in jax.tree.leaves(ref))
    assert sorted({_dtype(t) for t in opt_lib.leaves(params)}) == \
        sorted({str(x.dtype) for x in jax.tree.leaves(ref)})
    opt = sp.opt_specs(cfg)
    assert opt.step.shape == () and opt.step.dtype == torch.int32
    assert _numel(opt.m) == _numel(params)
    assert {t.dtype for t in opt_lib.leaves(opt.master)} == {torch.float32}


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}"
                                                   for a, s in CELLS])
def test_input_specs_and_microbatches_match_reference(arch, shape):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    sh = SHAPES[shape]
    got = sp.input_specs(cfg, sh)
    want = ref_specs.input_specs(rcfg, sh)
    assert list(got) == list(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape, k
        assert _dtype(got[k]) == str(want[k].dtype), k
        assert got[k].device.type == "meta"
    for dp in (1, 16):
        assert sp.train_microbatches(cfg, sh, dp) == \
            ref_specs.train_microbatches(rcfg, sh, dp)
    if sh.kind == "decode":
        cache = sp.cache_specs(cfg, sh)
        rcache = ref_specs.cache_specs(rcfg, sh)
        assert _numel(cache) == sum(x.size for x in jax.tree.leaves(rcache))
        assert sum(t.numel() * t.element_size()
                   for t in opt_lib.leaves(cache)) == \
            sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(rcache))


def test_parse_collectives_matches_reference():
    hlo = "\n".join([
        "  %ar = f32[1024,256]{1,0} all-reduce(f32[1024,256]{1,0} %x), "
        "replica_groups=[16,16]<=[256], to_apply=%sum",
        "  %ag-start = (bf16[64]{0}, bf16[1024]{0}) all-gather-start("
        "bf16[64]{0} %y), replica_groups=[16,16]<=[256], dimensions={0}",
        "  %ag-done = bf16[1024]{0} all-gather-done(%ag-start)",
        "  %rs = f32[32,8]{1,0} reduce-scatter(f32[512,8]{1,0} %z), "
        "replica_groups=[2,16]<=[32], dimensions={0}, to_apply=%sum",
        "  %a2a = bf16[8,128]{1,0} all-to-all(bf16[8,128]{1,0} %w), "
        "replica_groups=[32,8]<=[256], dimensions={0}",
        "  %cp = s32[4]{0} collective-permute(s32[4]{0} %v), "
        "source_target_pairs={{0,1},{1,0}}",
        "  %add = f32[4]{0} add(f32[4]{0} %a, f32[4]{0} %b)"])
    got = dryrun.parse_collectives(hlo)
    assert got == _ref_dryrun().parse_collectives(hlo)
    assert all(got["counts"][k] == 1 for k in got["counts"])


def test_run_cell_all_cells():
    """Every cell traces on the meta device; argument bytes are exact."""
    recs = {(a, s): dryrun.run_cell(a, s) for a, s in CELLS}
    assert len(recs) == 32
    for (arch, shape), rec in recs.items():
        assert rec["ok"], rec
        assert rec["kind"] == SHAPES[shape].kind
        assert rec["flops_per_device"] > 0
        assert rec["bytes_accessed_per_device"] > 0
        mem = rec["memory"]
        assert mem["total_bytes"] == mem["argument_bytes"] \
            + mem["activation_bytes"]
        assert rec["fits_one_card"] == (mem["total_bytes"] <= 80e9)
        cfg = get_config(arch)
        assert rec["param_count"] == cfg.param_count()
    cfg = get_config("internlm2_1_8b")
    params = sp.param_specs(cfg)
    n = _numel(params)
    param_bytes = sum(t.numel() * t.element_size()
                      for t in opt_lib.leaves(params))
    train = recs[("internlm2_1_8b", "train_4k")]
    tokens = 2 * 4 * 256 * 4096           # tokens and labels, int32
    assert train["memory"]["argument_bytes"] == param_bytes + 3 * 4 * n \
        + 4 + tokens
    assert train["microbatches"] == sp.train_microbatches(
        cfg, SHAPES["train_4k"], 1)
    assert recs[("mamba2_2_7b", "long_500k")]["fits_one_card"]
    assert not recs[("deepseek_67b", "train_4k")]["fits_one_card"]


def test_multi_pod_and_mesh_raise(monkeypatch):
    """The dry run records the multi-pod mesh (2x16x16) as one rank of
    it; the mesh itself spans hosts, so it and the launchers'
    ``--multi-pod`` raise, naming model sharding; the production mesh
    needs a card (here there is none); the debug mesh builds on the
    CPU."""
    from repro_torch.launch import train as launch_train
    rec = dryrun.run_cell("stablelm_1_6b", "decode_32k", multi_pod=True)
    assert rec["ok"] and rec["mesh"] == "2x16x16" and rec["n_devices"] == 512
    assert rec["local_batch"] == 128 // 32
    with pytest.raises(NotImplementedError, match="model sharding"):
        mesh.make_production_mesh(multi_pod=True)
    with pytest.raises(NotImplementedError, match="model sharding"):
        launch_train.main(["--arch", "stablelm_1_6b", "--multi-pod",
                           "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        mesh.make_production_mesh()
    m = mesh.make_debug_mesh()
    assert m.shape == {"data": 2, "model": 2} and m.size == 4
    assert set(m.devices) == {torch.device("cpu")}
    assert mesh.make_debug_mesh(8, 1).shape == {"data": 8, "model": 1}


def _step_args(cfg, shape):
    params = sp.param_specs(cfg)
    return (params, opt_lib.init(params), sp.input_specs(cfg, shape))


@pytest.mark.parametrize("remat", [True, False])
def test_train_step_flops_match_the_shapes(remat):
    cfg = smoke_config(get_config("stablelm_1_6b"))
    B, S = 2, 32
    shape = ShapeSpec("t", S, B, "train")
    ts = make_train_step(cfg, microbatches=1, remat=remat)
    args = _step_args(cfg, shape)
    with roofline._Counter() as cnt:
        ts(*args)
    with FlopCounterMode(display=False) as fc:
        ts(*args)
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hdim
    T, L = B * S, cfg.n_layers
    proj = 2 * T * D * H * hd + 2 * 2 * T * D * KV * hd + 2 * T * H * hd * D
    attn = 2 * 2 * B * H * S * S * hd
    gate_up = 2 * 2 * T * D * cfg.d_ff
    down = 2 * T * cfg.d_ff * D
    head = 2 * T * D * cfg.vocab
    want = 3 * (L * (proj + attn + gate_up + down) + head) + L * attn
    if remat:
        want += L * (proj + attn + gate_up)
    assert cnt.flops == fc.get_total_flops() == want


def test_probes_extrapolate_to_the_full_depth():
    """Probes at 2 and 4 layers extrapolate to a 6-layer trace's FLOPs and
    bytes exactly (train and prefill, a dense and an MoE arch)."""
    for arch, kind in (("stablelm_1_6b", "train"),
                       ("deepseek_v2_lite_16b", "prefill")):
        cfg = dataclasses.replace(smoke_config(get_config(arch)), n_layers=6)
        shape = ShapeSpec("t", 64, 2, kind)
        full = roofline.probe_counts(cfg, shape)
        direct = roofline._lower_probe(cfg, shape)
        for k in ("flops", "flops_f32", "bytes"):
            assert full[k] == pytest.approx(direct[k], rel=1e-12), (arch, k)


def test_probe_cell_terms():
    rec = roofline.probe_cell("internlm2_1_8b", "train_4k")
    assert rec["collective_s"] == 0.0 and rec["chips"] == 1
    assert rec["step_time_bound_s"] == max(rec["compute_s"],
                                           rec["memory_s"])
    f32 = rec["flops_f32_per_device"]
    assert 0 < f32 < rec["flops_per_device"]
    assert rec["compute_s"] == pytest.approx(
        (rec["flops_per_device"] - f32) / roofline.PEAK_FLOPS
        + f32 / roofline.PEAK_FLOPS_F32)
    assert rec["memory_s"] == pytest.approx(
        rec["bytes_per_device"] / roofline.HBM_BW)
    assert 0.3 < rec["useful_flop_ratio"] < 1.0


def test_roofline_reuses_the_dry_run_trace():
    """A cell's roofline record takes its counts from the dry run's trace
    of the same cell (one memo entry, however the call is written): it
    traces nothing again."""
    dryrun.run_cell("internlm2_1_8b", "decode_32k")
    misses = roofline._probe_counts.cache_info().misses
    roofline.probe_cell("internlm2_1_8b", "decode_32k")
    assert roofline._probe_counts.cache_info().misses == misses
    cfg, shape = get_config("internlm2_1_8b"), SHAPES["decode_32k"]
    assert roofline.probe_counts(cfg, shape) is roofline.probe_counts(
        cfg, shape, None, 1)
