"""Dry run of every (architecture x input-shape) cell, on one H100 or one
card of a mesh (port of ``repro.launch.dryrun``), without allocating
device memory.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh 16x16

The reference lowers and compiles each cell on a 512-device TPU mesh and
reads XLA's memory and cost analyses. The port has no compiler in the
loop, so a cell here is the step (``launch.specs``) on meta tensors, which
carry shapes and dtypes only, either on one card (``--mesh single``, the
default; records keyed ``arch|shape|single``) or as one rank of a layout
(``--mesh``: the reference's 16x16 and 2x16x16 meshes, whose ("pod",
"data") axes are data-parallel, and a host of four cards, 4x1; keyed
``arch|shape|<layout>``; ``device_record`` takes any ``roofline.mesh_axes``
layout), traced as that rank in a
``dist.sharding.Mesh.over_shapes`` world: its blocks of the parameters
and optimizer state, its rows of the batch and the cache, the port's
sharded step (ZeRO-3 gathers where a layer runs, expert-parallel MoE on
the model axis) and its collectives, which move nothing there and are
tallied:

* ``memory.argument_bytes``: the params, optimizer state, batch and
  cache the step takes (one rank's blocks under the reference's
  in-shardings: ``param_shardings``, ``batch_shardings`` and
  ``cache_shardings``), exact from the meta tensors at full depth;
  ``memory.donated_bytes`` those the reference donates (train: params
  and optimizer state; decode: the cache);
* ``memory.activation_bytes``: an estimate, from the shapes, of what the
  step adds at its peak (gradients, the f32 accumulator, the new
  optimizer state, the remat stash and one block's working set; a
  decode's new SSM states and upcast KV cache; under a mesh, at the local
  batch, plus the largest gathered layer), and ``fits_one_card``:
  arguments plus activations within 80 GB;
* ``flops_per_device`` and ``bytes_accessed_per_device``: the step traced
  under ``torch.utils.flop_counter.FlopCounterMode`` at the roofline's
  probe depths and extrapolated to the full depth
  (``roofline.probe_counts``; a full-depth trace of a 32k prefill would
  take minutes of host time);
* under a mesh, ``collectives``: the bytes a rank moves and the calls it
  makes by kind through ``dist.collectives`` in the step (the ZeRO-3
  all-gathers at use and again in remat, the gradients' reduce-scatters,
  the all-reduces of replicated leaves' gradients, the loss and the
  gradient norm, the expert-parallel all-to-alls), at the reference's
  ring factors (`parse_collectives`), extrapolated as the FLOPs are.

The port produces no HLO: `parse_collectives` is the reference's parser,
kept for HLO text from elsewhere; a one-card record has no collective
term. The reference's layers are stacked for ``lax.scan`` and the port's
are one dict each, so the reference's rules give the port's per-layer
leaves (vectors replicate) their specs by path name.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import re
import time
import traceback

import torch

from repro_torch.configs.registry import SHAPES, cells, get_config
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.launch import roofline
from repro_torch.launch import specs as sp
from repro_torch.train import optimizer as opt_lib

CARD_BYTES = 80e9        # H100 SXM, 80 GB of HBM3

# collective-op byte accounting (per-device module; see EXPERIMENTS.md).
_COLL_RE = re.compile(
    r"^\s*\S+ = \(?([a-z0-9]+\[[0-9,]*\])"
    r".*?\b(all-reduce|all-gather|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start)?\(", re.M)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_GROUP_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s32": 4,
                "u32": 4, "s64": 8, "u64": 8, "s16": 2, "u16": 2,
                "s8": 1, "u8": 1, "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1}


def _shape_bytes(tok: str) -> int:
    m = _SHAPE_RE.match(tok)
    if not m:
        return 0
    dt, dims = m.group(1), m.group(2)
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dt, 4)


def parse_collectives(hlo_text: str) -> dict:
    """Sum per-device collective bytes by op kind from compiled HLO.

    Uses result shapes with op-specific traffic factors (ring algorithms):
    all-reduce 2(g-1)/g * R, all-gather (g-1)/g * R, reduce-scatter
    (g-1) * R (operand ~ g*R), all-to-all (g-1)/g * R, permute R.
    """
    out = {k: 0.0 for k in ("all-reduce", "all-gather", "reduce-scatter",
                            "all-to-all", "collective-permute")}
    counts = {k: 0 for k in out}
    for line in hlo_text.splitlines():
        if "-done(" in line:
            continue
        m = _COLL_RE.match(line)
        if not m:
            continue
        op = m.group(2)
        # sum every result-tuple component on the line (variadic collectives)
        lhs = line.split("=", 1)[1].split("(", 1)[0]
        bytes_ = sum(_shape_bytes(t.group(0))
                     for t in _SHAPE_RE.finditer(lhs))
        g = 2.0
        gm = _GROUP_RE.search(line)
        if gm:
            g = max(float(gm.group(2)), 2.0)
        if op == "all-reduce":
            traffic = 2.0 * bytes_ * (g - 1.0) / g
        elif op == "all-gather":
            traffic = bytes_ * (g - 1.0) / g
        elif op == "reduce-scatter":
            traffic = bytes_ * (g - 1.0)
        elif op == "all-to-all":
            traffic = bytes_ * (g - 1.0) / g
        else:
            traffic = bytes_
        out[op] += traffic
        counts[op] += 1
    return {"bytes": out, "counts": counts,
            "total_bytes": sum(out.values())}


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in opt_lib.leaves(tree)
               if isinstance(t, torch.Tensor))


def _dicts(tree):
    """Every dict in `tree` (a cache: its layers' and attentions')."""
    if isinstance(tree, dict):
        yield tree
        for v in tree.values():
            yield from _dicts(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _dicts(v)


def _widest(cfg) -> int:
    """The widest per-token activation of one block, in elements."""
    w = [cfg.d_model, cfg.d_ff]
    if cfg.n_heads:
        w.append(cfg.n_heads * max(cfg.hdim, cfg.qk_nope_dim
                                   + cfg.qk_rope_dim))
    if cfg.n_experts:     # the dispatch buffer at the capacity factor
        w.append(int(cfg.capacity_factor * cfg.top_k
                     * max(cfg.d_model, cfg.d_ff_expert)) + 1)
    if cfg.family in ("ssm", "hybrid"):
        w.append(2 * cfg.d_inner + 2 * cfg.n_groups * cfg.d_state
                 + cfg.ssm_heads)
    return max(w)


def _activation_bytes(cfg, shape, *, microbatches: int, params, opt=None,
                     cache=None, gathered: int | None = None) -> int:
    """Estimate of the device bytes a cell's step holds at its peak beyond
    its arguments (`params`, `opt`, `cache`: the cell's meta trees; under
    a mesh one rank's, at its local batch `shape`, with `gathered` the
    bytes of the largest layer as its gathers leave it)."""
    mesh = gathered is not None
    gathered = gathered or 0
    f32 = 4
    it = cfg.jdtype.itemsize
    b = shape.global_batch // microbatches
    S = shape.seq_len
    width = cfg.d_model * (cfg.expand if cfg.family in ("ssm", "hybrid")
                           else 1)
    # one block's working set, f32 at worst, and one query chunk's tiles
    block = 16 * b * S * _widest(cfg) * f32
    if cfg.n_heads:
        block = max(block, 3 * b * cfg.n_heads * min(512, S)
                    * min(1024, S) * f32)
    if shape.kind == "decode":
        # SSM layers return new states (a layer's update holds two more
        # temporaries of its state); attention caches are written in
        # place, and decode attention upcasts k, then v (MLA: c_kv and
        # k_pe together) to f32, which an einsum may copy once more
        ssm = cache["layers"] if cfg.family in ("ssm", "hybrid") else []
        upd = 2 * max([_bytes(c) for c in ssm] + [0])
        attn = max([max(c.get("k", c.get("c_kv")).numel(),
                        c.get("v", c.get("k_pe")).numel()
                        + (c["c_kv"].numel() if "c_kv" in c else 0))
                    for c in _dicts(cache) if "k" in c or "c_kv" in c]
                   + [0])
        logits = b * cfg.vocab * (it + f32)
        return _bytes(ssm) + upd + 2 * attn * f32 + logits \
            + 16 * b * _widest(cfg) * f32 + gathered
    if shape.kind == "prefill":
        made_cache = _bytes(sp.cache_specs(cfg, shape))
        return made_cache + 2 * b * S * cfg.d_model * it + block + gathered
    n_params = sum(t.numel() for t in opt_lib.leaves(params))
    param_bytes = _bytes(params)
    largest = max(t.numel() for t in opt_lib.leaves(params))
    acc = f32 * n_params if microbatches > 1 else 0
    stash = (cfg.n_layers * b * S + cfg.n_enc_layers * b * cfg.enc_len) \
        * width * it
    ce = 3 * b * (512 if S % 512 == 0 else S) * cfg.vocab * f32
    # a gathered layer and its full gradient before the reduce-scatter
    backward = acc + param_bytes + stash + max(block, ce) + 2 * gathered
    # AdamW returns a new state beside the old; per leaf its f64
    # multiply-adds hold ~4 f64 and ~3 f32 copies of the leaf on one card;
    # on a mesh's cards the larger of ~4 f64 copies and a gathered layer
    # with its gradient (held within 1.6% of four cards' peaks, PR 26)
    temps = max(4 * 8 * largest, 2 * gathered) if mesh \
        else (4 * 8 + 3 * f32) * largest
    apply = (acc or param_bytes) + param_bytes + _bytes(opt) + temps
    return max(backward, apply)


_DONATED = {"train": (0, 1), "decode": (1,), "prefill": ()}


def _gathered_bytes(full, shardings, rules) -> int:
    """The bytes of the largest unit the model gathers where it runs (a
    layer, the shared attention, the embedding, the head), as its gathers
    leave it (split over the model axis only)."""
    dp = set(rules.dp)
    best = 0

    def unit(tree, sh):
        nonlocal best
        total = 0
        for t, s in zip(opt_lib.leaves(tree), opt_lib.leaves(sh)):
            entries = [e for e in s.entries(t.dim()) if e is not None]
            if not any(set(s.mesh.axes(e)) <= dp for e in entries):
                continue                      # used as it is held
            n = t.numel()
            for e in entries:
                if not set(s.mesh.axes(e)) <= dp:
                    n //= s.mesh.axis_size(e)
            total += n * t.element_size()
        best = max(best, total)

    for k, v in full.items():
        if isinstance(v, list):
            for lv, ls in zip(v, shardings[k]):
                unit(lv, ls)
        else:
            unit(v, shardings[k])
    return best


def device_memory(cfg, shape, layout: str | None = None) -> dict:
    """The memory of `device_record`: one card's arguments and activation
    estimate (`layout` None), or one rank's of `layout`, with the parts
    of the total."""
    prev = shd.active()
    if layout is not None:
        shd.set_mesh(shd.Mesh.over_shapes(*roofline.mesh_axes(layout),
                                          coll.Tally()))
    try:
        rules = shd.model_rules()
        dp = 1 if rules is None else rules.axis_size("dp")
        mb = (sp.train_microbatches(cfg, shape, dp_size=dp)
              if shape.kind == "train" else 1)
        _, args = sp.step_fn(cfg, shape, dp_size=dp, microbatches=mb)
        rows = shd.batch_rows(shape.global_batch)
        local = dataclasses.replace(shape,
                                    global_batch=rows.stop - rows.start)
        gathered = None
        if rules is not None:
            full = sp.param_specs(cfg)
            gathered = _gathered_bytes(full, shd.param_shardings(full),
                                       rules)
        act = _activation_bytes(
            cfg, local, microbatches=mb, params=args[0],
            opt=args[1] if shape.kind == "train" else None,
            cache=args[1] if shape.kind == "decode" else None,
            gathered=gathered)
        parts = {"params": _bytes(args[0]), "gathered_layer": gathered or 0,
                 "inputs": _bytes(args[-1])}
        if shape.kind == "train":
            parts["opt"] = _bytes(args[1])
            parts["f64_temps"] = 4 * 8 * max(
                t.numel() for t in opt_lib.leaves(args[0]))
        if shape.kind == "decode":
            parts["cache"] = _bytes(args[1])
        return dict(
            microbatches=mb, dp=dp, local_batch=local.global_batch,
            params_per_device=sum(t.numel()
                                  for t in opt_lib.leaves(args[0])),
            argument_bytes=_bytes(args), activation_bytes=act,
            donated_bytes=_bytes([args[i]
                                  for i in _DONATED[shape.kind]]),
            parts=parts)
    finally:
        shd.set_mesh(None if prev is None else prev.mesh)


def device_record(cfg, shape, layout: str | None = None) -> dict:
    """The per-device record of `cfg`'s step at `shape` (a
    ``configs.registry.ShapeSpec``) on one card (`layout` None) or one
    rank of `layout` (``roofline.mesh_axes``: "16x16", "4x1", ...): every
    field of `run_cell`'s but the cell's names (see the module
    docstring)."""
    t0 = time.time()
    mem = device_memory(cfg, shape, layout)
    # one card's probes take one microbatch: the products are the same
    counts = roofline.probe_counts(cfg, shape, layout,
                                   mem["microbatches"] if layout else 1)
    total = mem["argument_bytes"] + mem["activation_bytes"]
    rec = {
        "mesh": layout or "single",
        "n_devices": math.prod(roofline.mesh_axes(layout)[1])
        if layout else 1,
        "kind": shape.kind, "ok": True,
        "trace_s": round(time.time() - t0, 1),
        "microbatches": mem["microbatches"],
        "flops_per_device": counts["flops"],
        "bytes_accessed_per_device": counts["bytes"],
        "memory": {"argument_bytes": mem["argument_bytes"],
                   "activation_bytes": mem["activation_bytes"],
                   "total_bytes": total},
        "fits_one_card": total <= CARD_BYTES,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
    }
    if layout is not None:
        coll_rec = {"bytes": {k: counts[f"coll_bytes/{k}"]
                              for k in coll.KINDS},
                    "counts": {k: int(round(counts[f"coll_count/{k}"]))
                               for k in coll.KINDS}}
        coll_rec["total_bytes"] = sum(coll_rec["bytes"].values())
        rec["memory"].update(donated_bytes=mem["donated_bytes"],
                             parts=mem["parts"])
        rec.update(dp=mem["dp"], local_batch=mem["local_batch"],
                   params_per_device=mem["params_per_device"],
                   collectives=coll_rec)
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, *,
             layout: str | None = None) -> dict:
    """The cell's record (see the module docstring) on one card, or on
    one rank of `layout` (``"16x16"``, ``"2x16x16"``, ``"4x1"``;
    `multi_pod` is ``"2x16x16"``, the reference's multi-pod mesh); ``ok``
    False with the error if the step does not trace."""
    if multi_pod:
        layout = "2x16x16"
    tag = layout or "single"
    try:
        rec = {"arch": arch, "shape": shape_name,
               **device_record(get_config(arch), SHAPES[shape_name],
                               layout)}
        mem = rec["memory"]
        coll_s = ("" if layout is None else
                  f" coll={rec['collectives']['total_bytes']:.3e}B")
        print(f"[dryrun] {arch} {shape_name} {tag}: OK "
              f"trace={rec['trace_s']:.0f}s "
              f"flops/dev={rec['flops_per_device']:.3e} "
              f"args={mem['argument_bytes']:.3e}B "
              f"act~{mem['activation_bytes']:.3e}B{coll_s} "
              f"fits={rec['fits_one_card']}")
        return rec
    except Exception as e:  # a failing cell is a bug — record it loudly
        traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "mesh": tag,
                "ok": False, "error": f"{type(e).__name__}: {e}"}


MESHES = ("single", "16x16", "2x16x16", "4x1")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=[*MESHES, "all"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = cells()
    if args.arch != "all":
        todo = [(a, s) for a, s in todo if a == args.arch]
    if args.shape != "all":
        todo = [(a, s) for a, s in todo if s == args.shape]
    meshes = MESHES if args.mesh == "all" else (args.mesh,)

    results_path = out_dir / "results.json"
    results = {}
    if results_path.exists():
        results = json.loads(results_path.read_text())

    for arch, shape in todo:
        for m in meshes:
            key = f"{arch}|{shape}|{m}"
            if results.get(key, {}).get("ok"):
                print(f"[dryrun] skip cached {key}")
                continue
            results[key] = run_cell(arch, shape,
                                    layout=None if m == "single" else m)
            results_path.write_text(json.dumps(results, indent=1))

    n_ok = sum(1 for r in results.values() if r.get("ok"))
    print(f"[dryrun] {n_ok}/{len(results)} cells OK -> {results_path}")


if __name__ == "__main__":
    main()
