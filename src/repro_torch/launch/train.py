"""Training launcher (port of ``repro.launch.train``): --arch on one card.

    python -m repro_torch.launch.train --arch internlm2_1_8b --local-smoke \
        --device cpu

On several processes (one a card) each runs, as the reference's hosts do:

    python -m repro_torch.launch.train --arch internlm2_1_8b \
        --coordinator $HOST:$PORT --num-hosts $N --host-id $ID

``--local-smoke`` trains the reduced (``configs.smoke_config``) model,
without it the arch's full config, on the card unless ``--device cpu``
is given: random weights from seed 0, the launcher's (8, 64) token batch
drawn from ``default_rng(0)`` each step, two microbatches, AdamW with its
defaults. The run resumes from the newest checkpoint under ``--ckpt-dir``
and saves one every ``--ckpt-every`` steps on a writer thread, keeping
three. ``--dry-run`` runs ``launch.dryrun.run_cell`` for ``--shape``
instead and exits 0 or 1 on its ``ok``. ``--coordinator`` joins a
``torch.distributed`` world of ``--num-hosts`` processes as rank
``--host-id`` (``init_process_group(init_method="tcp://<coordinator>")``
with the mesh's timeout; NCCL on the card ``host_id`` modulo the visible
cards, gloo on the CPU), as the reference's ``jax.distributed.initialize``
does, and then runs what the reference's launcher runs: its step is not
sharded (``train.train_step`` shards under a world mesh). ``--multi-pod``
raises.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None, *, on_step=None):
    """Run the launcher with `argv` (``sys.argv[1:]`` when None); returns
    the final (params, opt_state). `on_step(step, metrics)` is called after
    each step, before the step's checkpoint."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--local-smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default="experiments/ckpt_torch")
    ap.add_argument("--ckpt-every", type=int, default=25)
    # multi-host bring-up (the reference's jax.distributed)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.dist import sharding as shd
    if args.multi_pod:
        raise shd.unsupported("--multi-pod (the 2x16x16 mesh)")
    if args.coordinator:
        import torch
        import torch.distributed as dist

        from repro_torch import _device
        cuda = _device.resolve(args.device).type == "cuda"
        if cuda:
            torch.cuda.set_device(args.host_id % torch.cuda.device_count())
        dist.init_process_group(
            "nccl" if cuda else "gloo",
            init_method=f"tcp://{args.coordinator}",
            world_size=args.num_hosts, rank=args.host_id,
            timeout=shd.DEFAULT_TIMEOUT)
        print(f"[train] process {dist.get_rank()} of "
              f"{dist.get_world_size()} ({dist.get_backend()}, coordinator "
              f"{args.coordinator})")
        try:
            return _run(args, on_step)
        finally:
            dist.destroy_process_group()
    return _run(args, on_step)


def _run(args, on_step):
    if args.dry_run:
        from repro_torch.launch.dryrun import run_cell
        rec = run_cell(args.arch, args.shape)
        raise SystemExit(0 if rec.get("ok") else 1)

    import numpy as np
    import torch

    from repro_torch import _device
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import model as M
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    dev = _device.canonical(_device.resolve(args.device))
    cfg = smoke_config(get_config(args.arch)) if args.local_smoke \
        else get_config(args.arch)
    params = M.init(0, cfg, device=dev)
    opt_state = opt_lib.init(params)
    latest = ckpt.latest_step(args.ckpt_dir)
    step0 = 0
    if latest is not None:
        state, step0 = ckpt.restore(args.ckpt_dir,
                                    {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        print(f"[train] resumed at step {step0}")

    ts = make_train_step(cfg, microbatches=2)
    writer = ckpt.AsyncCheckpointer(args.ckpt_dir, keep=3)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for step in range(step0, args.steps):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (8, 64)),
                               dtype=torch.int32, device=dev)
        params, opt_state, m = ts(params, opt_state,
                                  {"tokens": toks, "labels": toks})
        if step % 10 == 0:
            print(f"[train] step {step} loss={float(m['loss']):.4f} "
                  f"({time.time()-t0:.0f}s)")
        if on_step is not None:
            on_step(step, m)
        if (step + 1) % args.ckpt_every == 0:
            writer.save(step + 1, {"params": params, "opt": opt_state})
    writer.close()
    return params, opt_state


if __name__ == "__main__":
    main()
