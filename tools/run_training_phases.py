#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases 30-33 (the LM trainer at full width,
checkpoint and resume, the card against the CPU, the launch tools) on one
H100 without the rest of the script.

    python3 tools/run_training_phases.py

The phases build no kernel (the training path runs none of the five),
so nothing is compiled; each phase keeps its gates and is timed on the
host clock, and the last line is a JSON object of their numbers. Run
from the repository root.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("run_training_phases: CUDA is not available", file=sys.stderr)
        return 1
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    out = cs.training_phases(torch.device("cuda"), smi)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
