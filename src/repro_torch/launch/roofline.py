"""Roofline probes on one H100 (port of ``repro.launch.roofline``).

    compute term    = matmul FLOPs / peak (989 TFLOP/s for bf16 products,
                      67 TFLOP/s for f32 ones; TF32 stays off)
    memory term     = bytes / 3.35 TB/s HBM
    collective term = 0

Every cell's step is traced on the meta device (``launch.specs``), so no
memory is allocated, at two layer counts (three for encoder-decoder
models, as the reference probes); the per-layer delta and the fixed cost
extrapolate exactly to the full depth. A trace takes ~0.1-0.3 ms of host
time an op, so a full-depth trace of a 32k-token prefill would take
minutes; the probes take seconds. In probe mode (``layers.set_unroll``)
flash attention takes the reference's 2048-wide probe tiles.

FLOPs are the products (``mm``, ``bmm``, ...; elementwise work is not
counted) by ``torch.utils.flop_counter.FlopCounterMode``'s formulas, and
the
share whose operands are f32 (the attention and SSD products the port
upcasts where the reference asks XLA for f32 products) is timed at the
f32 peak. Bytes are what an unfused eager step moves: `_Counter` sums
each dispatched op's tensor operands and results (views move nothing),
so a gather counts its whole table. The collective term is 0: the port
runs on one device, so its step has no collectives (the reference parses
them from sharded HLO, which the port does not produce).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import pathlib
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.registry import SHAPES, cells, get_config
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.launch import specs as sp
from repro_torch.models import layers as Lyr

PEAK_FLOPS = 989e12       # bf16 products, tensor cores, dense (H100 SXM)
PEAK_FLOPS_F32 = 67e12    # f32 products on the CUDA cores (TF32 off)
HBM_BW = 3.35e12          # bytes/s

_aten = torch.ops.aten
# ops that allocate or relabel memory without moving bytes
_NO_MOVE = {_aten.empty.memory_format, _aten.empty_strided.default,
            _aten._unsafe_view.default, _aten.detach.default,
            _aten.lift_fresh.default, _aten.as_strided.default}
_SIMPLE = (int, float, bool, str, type(None), torch.dtype, torch.device,
           torch.layout, torch.memory_format, torch.Size)


def _tensors(x, out: list) -> list:
    """The tensors in an op's (nested) arguments or results, in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _key(x):
    """What a meta kernel's output can depend on: shapes, strides and
    dtypes of the tensors, the other arguments' values."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in x.items())
    return x if isinstance(x, _SIMPLE) else ("?", id(x))


def _spec(o: torch.Tensor):
    return (o.shape, o.stride(), o.dtype)


def _from_spec(m) -> torch.Tensor:
    return torch.empty_strided(m[0], m[1], dtype=m[2], device="meta")


class _Counter(TorchDispatchMode):
    """Counts what each op dispatched on meta tensors would do on the card:
    its product FLOPs by ``FlopCounterMode``'s formulas
    (``flop_registry``), the f32 share of them, and the bytes of its
    tensor operands and results (views and allocations move nothing).

    A meta kernel costs ~0.1-0.25 ms of host time, and a probe repeats the
    same tiles thousands of times, so the outputs of functional ops
    returning tensors are memoized by their operands' shapes, strides and
    dtypes (views and in-place ops always run)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_f32 = 0
        self.bytes = 0
        self._outs: dict = {}

    def _run(self, func, args, kwargs):
        if func._schema.is_mutable:
            return func(*args, **kwargs)
        key = (func, _key(args), _key(kwargs))
        spec = self._outs.get(key)
        if spec is not None:
            return _from_spec(spec) if not isinstance(spec, list) \
                else spec[0]([_from_spec(m) for m in spec[1]])
        out = func(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            self._outs[key] = _spec(out)
        elif isinstance(out, (tuple, list)) and all(
                isinstance(o, torch.Tensor) for o in out):
            self._outs[key] = [type(out), [_spec(o) for o in out]]
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.is_view:                       # moves nothing, no products
            return func(*args, **kwargs)
        out = self._run(func, args, kwargs)
        ins = _tensors((args, kwargs), [])
        if func not in _NO_MOVE:
            self.bytes += _nbytes(ins) + _nbytes(_tensors(out, []))
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            n = count(*args, **kwargs, out_val=out)
            self.flops += n
            if any(t.dtype == torch.float32 for t in ins):
                self.flops_f32 += n
        return out


def _probe_cfg(cfg, n_scan, n_enc=None):
    kw = {"n_layers": cfg.first_k_dense + n_scan}
    if n_enc is not None:
        kw["n_enc_layers"] = n_enc
    return dataclasses.replace(cfg, **kw)


def mesh_axes(layout: str) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """A layout's mesh axes and sizes: "DxM" is ("data", "model") of D x M
    (the reference's 16x16, a host of four cards' 4x1), "PxDxM" ("pod",
    "data", "model") (the reference's multi-pod 2x16x16)."""
    sizes = tuple(int(x) for x in layout.split("x"))
    return {2: ("data", "model"),
            3: ("pod", "data", "model")}[len(sizes)], sizes


def _lower_probe(cfg, shape, layout=None, microbatches=1) -> dict:
    """Trace one probe's step on the meta device; its flops, flops_f32 and
    bytes, and under `layout` (`mesh_axes`) one rank's: its blocks
    and rows in a ``dist.sharding.Mesh.over_shapes`` world, with the
    collectives' bytes and counts by kind (``coll_bytes/<kind>``,
    ``coll_count/<kind>``)."""
    tally = coll.Tally()
    prev = shd.active()
    Lyr.set_unroll(True)
    try:
        dp = 1
        if layout is not None:
            rules = shd.set_mesh(shd.Mesh.over_shapes(*mesh_axes(layout),
                                                      tally))
            dp = rules.axis_size("dp")
        fn, args = sp.step_fn(cfg, shape, dp_size=dp,
                              microbatches=microbatches)
        with _Counter() as cnt:
            fn(*args)
    finally:
        Lyr.set_unroll(False)
        shd.set_mesh(None if prev is None else prev.mesh)
    out = {"flops": float(cnt.flops), "flops_f32": float(cnt.flops_f32),
           "bytes": float(cnt.bytes)}
    if layout is not None:
        for k in coll.KINDS:
            out[f"coll_bytes/{k}"] = tally.bytes[k]
            out[f"coll_count/{k}"] = float(tally.counts[k])
    return out


def _extrapolate(lo, hi, l_lo, l_hi, l_full):
    out = {}
    for k in lo:
        per = (hi[k] - lo[k]) / (l_hi - l_lo)
        fixed = lo[k] - l_lo * per
        out[k] = max(fixed + l_full * per, 0.0)
        out[k + "_per_layer"] = per
        out[k + "_fixed"] = fixed
    return out


def probe_counts(cfg, shape, layout=None, microbatches=1) -> dict:
    """FLOPs, f32 FLOPs and bytes of `cfg`'s step at `shape` (one rank's
    under `layout`, with its collectives), extrapolated from the probes to
    the full depth (one microbatch by default: the products of an
    accumulated step are the same, its collectives are not). Memoized on
    the four values, however they are passed: the dry run and the
    roofline of a cell share one trace."""
    return _probe_counts(cfg, shape, layout, microbatches)


@functools.lru_cache(maxsize=None)
def _probe_counts(cfg, shape, layout, microbatches) -> dict:
    def probe(c):
        return _lower_probe(c, shape, layout, microbatches)

    if cfg.family == "encdec":
        rb = probe(_probe_cfg(cfg, 2, n_enc=2))
        re = probe(_probe_cfg(cfg, 2, n_enc=4))
        rd = probe(_probe_cfg(cfg, 4, n_enc=2))
        full = {}
        for k in rb:
            enc_per = (re[k] - rb[k]) / 2.0
            dec_per = (rd[k] - rb[k]) / 2.0
            fixed = rb[k] - 2 * enc_per - 2 * dec_per
            full[k] = max(fixed + cfg.n_enc_layers * enc_per
                          + cfg.n_layers * dec_per, 0.0)
            full[k + "_per_layer"] = dec_per
            full[k + "_fixed"] = fixed
        return full
    l_lo = cfg.attn_every if cfg.family == "hybrid" else 2
    l_hi = 2 * l_lo
    lo = probe(_probe_cfg(cfg, l_lo))
    hi = probe(_probe_cfg(cfg, l_hi))
    return _extrapolate(lo, hi, l_lo, l_hi, cfg.n_layers - cfg.first_k_dense)


def probe_cell(arch: str, shape_name: str, *,
               cfg_overrides: dict | None = None) -> dict:
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    t0 = time.time()
    full = probe_counts(cfg, shape)

    flops_bf16 = full["flops"] - full["flops_f32"]
    compute_t = (flops_bf16 / PEAK_FLOPS if cfg.jdtype == torch.bfloat16
                 else flops_bf16 / PEAK_FLOPS_F32) \
        + full["flops_f32"] / PEAK_FLOPS_F32
    memory_t = full["bytes"] / HBM_BW
    terms = {"compute_s": compute_t, "memory_s": memory_t,
             "collective_s": 0.0}
    dominant = max(terms, key=terms.get)

    # MODEL_FLOPS: 6*N*D train, 2*N*D forward (prefill/decode); MoE: active
    n_active = cfg.active_param_count()
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind in ("train", "prefill")
              else shape.global_batch)
    mult = 6.0 if shape.kind == "train" else 2.0
    model_flops = mult * n_active * tokens
    bound = max(terms.values())
    return {
        "arch": arch, "shape": shape_name, "chips": 1,
        "flops_per_device": full["flops"],
        "flops_f32_per_device": full["flops_f32"],
        "bytes_per_device": full["bytes"],
        "coll_bytes_per_device": 0.0,
        "compute_s": compute_t, "memory_s": memory_t,
        "collective_s": 0.0,
        "dominant": dominant.replace("_s", ""),
        "model_flops": model_flops,
        "hlo_flops_global": full["flops"],
        "useful_flop_ratio": (model_flops / full["flops"]
                              if full["flops"] else 0.0),
        "roofline_fraction": (compute_t / bound if bound else 0.0),
        "step_time_bound_s": bound,
        "probe_s": round(time.time() - t0, 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default="experiments/roofline_torch")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    results_path = out_dir / "results.json"
    results = {}
    if results_path.exists():
        results = json.loads(results_path.read_text())

    todo = cells()
    if args.arch != "all":
        todo = [(a, s) for a, s in todo if a == args.arch]
    if args.shape != "all":
        todo = [(a, s) for a, s in todo if s == args.shape]

    for arch, shape in todo:
        key = f"{arch}|{shape}"
        if key in results and "error" not in results[key]:
            print(f"[roofline] skip cached {key}")
            continue
        try:
            rec = probe_cell(arch, shape)
            print(f"[roofline] {key}: dom={rec['dominant']} "
                  f"comp={rec['compute_s']:.2e}s mem={rec['memory_s']:.2e}s "
                  f"coll={rec['collective_s']:.2e}s "
                  f"useful={rec['useful_flop_ratio']:.2f} "
                  f"({rec['probe_s']}s)")
        except Exception as e:
            import traceback
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape,
                   "error": f"{type(e).__name__}: {e}"}
        results[key] = rec
        results_path.write_text(json.dumps(results, indent=1))

    print(f"[roofline] -> {results_path}")


if __name__ == "__main__":
    main()
