"""Spawn a ``torch.distributed`` world of one process per rank, with a
deadline.

    results = world.spawn(fn, 4, backend="gloo", root=tmp_dir,
                          deadline_s=120, args=(...))

Each rank is a fresh process (the ``spawn`` start method) that joins the
world through a ``file://`` store under `root` (no TCP port to race for),
with `deadline_s` as the timeout of its default group's collectives, runs
``fn(rank, *args)`` and writes its result under `root` (removed once
read). Under NCCL rank r
takes card r. The parent waits at most `deadline_s`: if a rank fails, or
the deadline passes (a hung collective), every rank is killed and
`spawn` raises with the failed ranks' tracebacks. `fn` and its
arguments must pickle (a module-level function).
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import pathlib
import shutil
import time
import traceback
import uuid

import torch
import torch.distributed as dist


def _rank_main(rank: int, n: int, backend: str, store: str, out: str,
               timeout_s: float, threads: int | None, fn, args) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=timeout_s))
        result = fn(rank, *args)
        torch.save(result, os.path.join(out, f"result_{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)          # no exit handler may wait on a dead peer


def spawn(fn, n: int, *, backend: str, root, deadline_s: float,
          threads: int | None = None, args: tuple = ()) -> list:
    """Run ``fn(rank, *args)`` on each rank of a new world of `n`
    processes; returns their results in rank order (see the module
    docstring). `deadline_s` also bounds each collective of the default
    group; `threads` sets each rank's ``torch.set_num_threads``."""
    root = pathlib.Path(root)
    out = root / f"world_{uuid.uuid4().hex}"
    out.mkdir(parents=True)
    store = str(out / "store")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        r, n, backend, store, str(out), deadline_s, threads, fn, args))
        for r in range(n)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    try:
        while True:
            codes = [p.exitcode for p in procs]
            if all(c == 0 for c in codes):
                break
            failed = any(c not in (None, 0) for c in codes)
            if failed or time.monotonic() > end:
                errors = {r: (out / f"error_{r}.txt").read_text()[-4000:]
                          for r in range(n)
                          if (out / f"error_{r}.txt").exists()}
                what = (f"exit codes {codes}" if failed else
                        f"no end within {deadline_s} s (exit codes {codes})")
                raise RuntimeError(f"world of {n} {backend} ranks: {what}; "
                                   f"{errors or 'no traceback written'}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10)
    results = [torch.load(out / f"result_{r}.pt", weights_only=False)
               for r in range(n)]
    shutil.rmtree(out, ignore_errors=True)
    return results
