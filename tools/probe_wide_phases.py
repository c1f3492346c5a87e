#!/usr/bin/env python3
"""Where the wide ``window_features`` kernel spends its time: the cycles
each phase of a window takes, on the card, at the widths phase 8 of
``chip_smoke.py`` runs.

    python3 tools/probe_wide_phases.py [--widths 65,120,1024]

The script copies ``src/repro_torch/kernels/csrc`` into
``build/probe_wide_phases/``, inserts a ``clock64()`` mark after each
phase of ``features.cuh::stat_time_features_warp`` and
``freq_features_warp`` (lane 0 of every window's group adds the cycles
since the previous mark to a per-phase counter), builds that copy with
``nvcc`` into a library with a plain C entry and loads it with ctypes.
Input: the windows of ``generate_traces(n_functions=150, n_days=14,
seed=0)`` at stride 140 (~21,000 a width), 38 features. For each width
it checks that the instrumented kernel still equals the extension's wide
kernel bit for bit, then prints each phase's mean cycles a window (a
group's own time, stalls on its neighbours included; the sum is a
window's latency, not the kernel's time) over all the windows and over
the first 132 (a few warps on each of a few SMs: the phase's latency
without contention), the kernel's time with CUDA events (the
instrumented and the shipped kernel, a warm-up launch then the mean of
5), and the card's ``nvidia-smi`` name and power limit. Needs a CUDA
device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
BUILD = ROOT / "build" / "probe_wide_phases"

# (the statement a mark follows, the phase it closes), in order
MARKS = (
    ("g.shfl(total, 3) *\n                        (1.0f / static_cast<float>"
     "(n - 1));", "mean, lo, hi, mean_ad"),
    ("const Extremes ext = warp_extremes(x, n, g);", "extremes, zeros"),
    ("xc[skew(j)] = x[skew(j)] - mean;", "centre"),
    ("g.sync();  // xc is written and the slots are read", "quartiles"),
    ("const float cov = g.shfl(total, 3) * rn;", "var, m3, m4, cov"),
    ("g.sync();  // x is read: its row takes the centred window, plain",
     "peaks"),
    ("const float a = acf_at(lag);\n    if (a > acf_max) {\n      acf_max = a;"
     "\n      acf_arg = lag - kAcfLo;\n    }\n  }", "autocorrelations"),
    (": k == 24 ? v * (1.0f / static_cast<float>(kAcfHi)) : v;\n  });",
     "28 features out"),
    ("f.tw + off, p1, p2);\n    float* t = p1;\n    p1 = p2;\n    p2 = t;\n"
     "  }", "fft"),
    ("if (isnan(p0)) dom = 0;", "bins, logs, top"),
    ("g.shfl(s, 4);\n  const float total = psum + kFeatEps;", "five chains"),
    ("aux[nb + k] = p;\n  }\n  g.sync();", "p terms"),
    ("roll = k0 + __ffs(hit) - 1;\n      break;\n    }\n  }", "three chains"),
    ("k == 1 || k == 7 || k == 9 ? v * f.inv_nb : v;\n  });",
     "10 features out"),
)
N_MARKS = len(MARKS) + 1  # and the window's load

PROLOGUE = r"""
__device__ unsigned long long g_probe[32];
#define PROBE_START long long probe_t0 = clock64()
#define PROBE_MARK(k)                                                   \
  do {                                                                  \
    const long long probe_t = clock64();                                \
    if (g.lane() == 0)                                                  \
      atomicAdd(&g_probe[k],                                            \
                static_cast<unsigned long long>(probe_t - probe_t0));   \
    probe_t0 = probe_t;                                                 \
  } while (0)
"""

ENTRY = r"""
#include "window_features.cu"

extern "C" int probe_wide(const float* x, float* out, int N, int W,
                          const float* tw, const int* plan, int n_pass,
                          float inv_log_nb, float inv_nb,
                          unsigned long long* counters) {
  using namespace repro_torch;
  FreqTables f{};
  f.tw = tw;
  f.n_pass = n_pass;
  for (int q = 0; q < n_pass; ++q) {
    f.ip[q] = plan[4 * q];
    f.l1[q] = plan[4 * q + 1];
    f.ido[q] = plan[4 * q + 2];
    f.off[q] = plan[4 * q + 3];
  }
  f.inv_log_nb = inv_log_nb;
  f.inv_nb = inv_nb;
  unsigned long long zero[32] = {};
  cudaMemcpyToSymbol(g_probe, zero, sizeof zero);
  window_features_launch(x, out, N, W, &f, kWfWide, 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(counters, g_probe, sizeof zero);
  return static_cast<int>(cudaGetLastError());
}
"""


def instrument(build: Path) -> None:
    """The csrc copy in `build` with the marks in features.cuh."""
    if build.exists():
        shutil.rmtree(build)
    shutil.copytree(CSRC, build)
    feats = (build / "features.cuh").read_text()
    feats = feats.replace("namespace repro_torch {\n",
                          PROLOGUE + "namespace repro_torch {\n", 1)
    for k, (anchor, _) in enumerate(MARKS, start=1):
        if feats.count(anchor) != 1:
            raise RuntimeError(f"probe anchor not found once: {anchor!r}")
        feats = feats.replace(anchor, f"{anchor}\n  PROBE_MARK({k});")
    for head in ("Group<G>& g,\n" + " " * 56
                 + "float* out) {\n  const float rn",
                 "float* out) {\n  float* p1 = a;"):
        if feats.count(head) != 1:
            raise RuntimeError(f"probe anchor not found once: {head!r}")
        feats = feats.replace(head, head.replace(
            "{\n", "{\n  PROBE_START;\n", 1))
    (build / "features.cuh").write_text(feats)
    wf = (build / "window_features.cu").read_text()
    anchor = "  load_window(x, src, n, g);\n"
    if wf.count(anchor) != 1:
        raise RuntimeError("probe anchor not found once: load_window")
    wf = wf.replace(anchor, "  long long probe_t0 = clock64();\n" + anchor
                    + "  PROBE_MARK(0);\n")
    (build / "window_features.cu").write_text(wf)
    (build / "probe_entry.cu").write_text(ENTRY)


def build() -> ctypes.CDLL:
    instrument(BUILD)
    lib = BUILD / "libprobe_wide.so"
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(lib), str(BUILD / "probe_entry.cu")],
                   check=True, cwd=BUILD, timeout=900)
    so = ctypes.CDLL(str(lib))
    so.probe_wide.restype = ctypes.c_int
    so.probe_wide.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int, ctypes.c_float, ctypes.c_float,
                              ctypes.c_void_p]
    return so


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--widths", default="65,90,120,211,360,1024")
    args = p.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_wide_phases: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import features
    from repro_torch.data import azure_synth, windows
    from repro_torch.kernels import window_features as wf
    so = build()
    dev = torch.device("cuda")
    traces = azure_synth.generate_traces(n_functions=150, n_days=14, seed=0)
    names = ["load", *(name for _, name in MARKS)]

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 5

    for width in (int(w) for w in args.widths.split(",")):
        x_all = torch.as_tensor(windows.make_windows(
            traces, window=width, stride=140).windows, device=dev)
        tw, plan = features.fft_tables(width, dev)
        plan_t = torch.tensor(plan, dtype=torch.int32)
        inv_log_nb, inv_nb = features.freq_constants(width)
        runs = {}
        # every window (the card full), then 132 (a few warps on each of a
        # few SMs)
        for label, x in (("full", x_all), ("lone", x_all[:132])):
            n = x.shape[0]
            out = torch.empty((n, features.N_FEATURES), device=dev)
            counters = np.zeros(32, np.uint64)

            def call():
                rc = so.probe_wide(x.data_ptr(), out.data_ptr(), n, width,
                                   tw.data_ptr(), plan_t.data_ptr(),
                                   len(plan) // 4, inv_log_nb, inv_nb,
                                   counters.ctypes.data)
                if rc:
                    raise RuntimeError(f"probe_wide at W = {width}: CUDA "
                                       f"error {rc}")
            call()
            want = wf.window_features_cuda(x, freq=True, variant="wide")
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"the instrumented kernel differs at W "
                                   f"= {width}")
            runs[label] = (counters[:N_MARKS].astype(np.float64) / n,
                           ms(call))
        shipped = ms(lambda: wf.window_features_cuda(x_all, freq=True,
                                                     variant="wide"))
        full, lone = runs["full"][0], runs["lone"][0]
        print(f"[W={width}] {x_all.shape[0]} windows; shipped kernel "
              f"{shipped} ms, instrumented {runs['full'][1]} ms; cycles a "
              f"window by phase (lane 0, mean), all windows / 132 windows: "
              f"total {full.sum():.0f} / {lone.sum():.0f}", flush=True)
        for name, c, c1 in zip(names, full, lone):
            print(f"  {name:22s} {c:9.0f} {c / full.sum():6.1%}  {c1:9.0f} "
                  f"{c1 / lone.sum():6.1%}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
