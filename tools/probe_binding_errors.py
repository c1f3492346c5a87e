#!/usr/bin/env python3
"""Call the port's CUDA binding directly with inputs its checks refuse,
each call in its own subprocess, and report how the process ended: a
Python RuntimeError, or a signal.

    python3 tools/probe_binding_errors.py [TREE ...]

TREE is the root of a checkout (default: this one); each tree's kernels
are built from its own sources into its own ``build/``. Cases: a tensor of
the wrong rank (a check whose message is one C string), a tensor of the
wrong shape (a check that composes its message), a size out of range,
and a plant pass whose shared memory the card refuses (in a tree without
the binding's own check the launch itself fails). With two or more
cards, also a tensor on another card than the entry's first one (an
output, the GBDT tables, the pre-pass's signals, the first tensor
itself), which every entry refuses before it launches. Needs a CUDA
device.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

CASES = {
    "bad_rank": "ext.holt_winters(torch.zeros(8, device=dev), "
                "torch.zeros(8, device=dev), torch.zeros(60, 8, device=dev),"
                " 60, [0.1] * 6, False, False)",
    "bad_shape": "ext.holt_winters(torch.zeros(8, 10, device=dev), "
                 "torch.zeros(8, 11, device=dev), "
                 "torch.zeros(60, 8, device=dev), 60, [0.1] * 6, False, "
                 "False)",
    "bad_size": "ext.episode_smem(1 << 21, 0, 0)",
    "oversize_shared_memory": (
        "ext.episode_block_hpa(torch.zeros(40, 3, device=dev), "
        "torch.zeros(12, 40, 3, device=dev), 4000, 15, 20.0, 0.1, 0.5, "
        "600.0, 1 / 60, 100.0, 2.0, 1 / 0.7, 0.1, 300.0, 20); "
        "torch.cuda.synchronize()"),
}

# a tensor on the second card (dev1) beside the first card's (dev)
MISMATCH_CASES = {
    "other_card_output": (
        "ext.holt_winters(torch.zeros(8, 64, device=dev), "
        "torch.zeros(8, 64, device=dev1), torch.zeros(60, 8, device=dev), "
        "60, [0.1] * 6, False, False); torch.cuda.synchronize()"),
    "other_card_tables": (
        "ext.gbdt_logits(torch.zeros(10, 38, device=dev), "
        "torch.zeros(10, 4, device=dev), torch.zeros(38, 63, device=dev1), "
        "torch.zeros(4, 15, dtype=torch.int32, device=dev1), "
        "torch.zeros(4, 15, dtype=torch.int32, device=dev1), "
        "torch.zeros(4, 16, device=dev1), torch.zeros(4, device=dev1), "
        "False); torch.cuda.synchronize()"),
    "other_card_signals": (
        "ext.episode_block_predictive(torch.zeros(40, 30, device=dev), "
        "torch.zeros(12, 40, 30, device=dev), "
        "torch.zeros(30, 40, device=dev1), 20, 15, 20.0, 0.1, 0.5, 600.0, "
        "1 / 60, 100.0, 2.0, 1 / 0.7, 300.0); torch.cuda.synchronize()"),
    "other_card_first": (
        "ext.window_features(torch.zeros(16, 60, device=dev1), "
        "torch.zeros(16, 28, device=dev), torch.zeros(0, device=dev1), "
        "[], 0.0, 0.0, 0); torch.cuda.synchronize()"),
}

CODE = """
import sys, torch
sys.path.insert(0, {src!r})
from repro_torch.kernels import _build
ext = _build.extension()
dev = torch.device("cuda", 0)
dev1 = torch.device("cuda", min(1, torch.cuda.device_count() - 1))
try:
    {call}
except Exception as e:
    print(type(e).__name__, "(a RuntimeError)" if isinstance(
        e, RuntimeError) else "(not a RuntimeError)", str(e).splitlines()[0])
    sys.exit(0)
print("no error")
"""


def probe(tree: Path, call: str) -> subprocess.CompletedProcess:
    """`call` in a fresh process on `tree`'s kernels (faulthandler on)."""
    return subprocess.run([sys.executable, "-X", "faulthandler", "-c",
                           CODE.format(src=str(tree / "src"), call=call)],
                          capture_output=True, text=True, timeout=900)


def main() -> int:
    trees = [Path(t).resolve() for t in sys.argv[1:]] or [
        Path(__file__).resolve().parents[1]]
    import torch
    cases = dict(CASES, **(MISMATCH_CASES if torch.cuda.device_count() > 1
                           else {}))
    for tree in trees:
        probe(tree, "pass").check_returncode()        # build once
        for name, call in cases.items():
            proc = probe(tree, call)
            err = [ln for ln in proc.stderr.splitlines() if ln.strip()]
            print(f"[probe] {tree.name} {name}: rc {proc.returncode}, "
                  f"stdout {proc.stdout.strip()!r}, stderr "
                  f"{' | '.join(err[:6])[:600]!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
