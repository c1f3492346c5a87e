#!/usr/bin/env python3
"""Measure the two designs that keep every window-feature sum in XLA's
order, on their common core: the mean, the variance, the third and
fourth moments and the 30 autocorrelations of each 60-sample window.

    python3 tools/probe_window_designs.py

(i)  ``per_warp``: a warp per window. The window sits in shared memory;
     every lane computes the mean and the variance (the same sums), then
     lane l < 30 takes the autocorrelation at lag l + 1 and lanes 30 and
     31 the third and fourth moments, each one left-to-right sum in XLA's
     chunk order in the lane that owns it.
(ii) ``per_thread``: a thread per window, the window in registers, every
     loop unrolled at compile time (the window_features kernel's W = 60
     design).

Both kernels come from one small CUDA source in this file, built with
``nvcc`` into ``build/probe_window_designs/`` and loaded with ctypes.
Input: the 301,650 AAPAset windows (``generate_traces(n_functions=150,
n_days=14, seed=0)``, 60-minute windows at stride 10). The script checks
that the two designs give the same 32 values per window bit for bit,
then times each with CUDA events (a warm-up launch, then the mean of 20),
and prints the card's ``nvidia-smi`` name and power limit. Needs a CUDA
device and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "probe_window_designs"

SOURCE = r"""
#include <cuda_runtime.h>

namespace {
constexpr int W = 60, kOut = 32, kLags = 30;

// XLA CPU's order (numerics.cuh::xla_sum): chunks of 32, half the padding
// in front, each chunk left to right, then the chunk totals
template <class Term>
__device__ __forceinline__ float xla_sum(int n, Term term) {
  const int n_win = (n + 31) / 32, low = (n_win * 32 - n) / 2;
  float total = 0.0f;
  for (int w = 0; w < n_win; ++w) {
    const int lo = max(w * 32 - low, 0), hi = min((w + 1) * 32 - low, n);
    float s = term(lo);
    for (int j = lo + 1; j < hi; ++j) s = s + term(j);
    total = w == 0 ? s : total + s;
  }
  return total;
}

template <int Lo, int Hi, class Term>
__device__ __forceinline__ float seq_c(Term term) {
  float s = term(Lo);
#pragma unroll
  for (int j = Lo + 1; j < Hi; ++j) s = s + term(j);
  return s;
}

template <int N, class Term>
__device__ __forceinline__ float xla_sum_c(Term term) {
  constexpr int n_win = (N + 31) / 32, low = (n_win * 32 - N) / 2;
  if constexpr (n_win == 1) return seq_c<0, N>(term);
  else return seq_c<0, 32 - low>(term) + seq_c<32 - low, N>(term);
}

constexpr float kEps = 1e-6f;

// (i) a warp per window; 8 warps a block
__global__ void __launch_bounds__(256) per_warp(const float* __restrict__ x,
                                                float* __restrict__ out,
                                                int N) {
  __shared__ float win[8][W];
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int n = blockIdx.x * 8 + wi;
  if (n >= N) return;
  const float* src = x + static_cast<size_t>(n) * W;
  win[wi][lane] = src[lane];
  if (lane + 32 < W) win[wi][lane + 32] = src[lane + 32];
  __syncwarp();
  const float* v = win[wi];
  const float mean = xla_sum(W, [&](int j) { return v[j]; }) * (1.0f / W);
  const float var = xla_sum(W, [&](int j) {
    const float d = v[j] - mean;
    return d * d;
  }) * (1.0f / W);
  float r;
  if (lane < kLags) {
    const int lag = lane + 1;
    r = xla_sum(W - lag, [&](int j) {
      return (v[j] - mean) * (v[j + lag] - mean);
    }) / (static_cast<float>(W) * var + kEps);
  } else if (lane == kLags) {
    r = xla_sum(W, [&](int j) {
      const float d = v[j] - mean;
      return d * (d * d);
    }) * (1.0f / W);
  } else {
    r = xla_sum(W, [&](int j) {
      const float d = v[j] - mean;
      const float d2 = d * d;
      return d2 * d2;
    }) * (1.0f / W);
  }
  out[static_cast<size_t>(n) * kOut + lane] = r;
}

template <int Lag>
struct AcfAt {
  template <class X>
  static __device__ __forceinline__ float of(const X& xc, float den) {
    return xla_sum_c<W - Lag>([&](int j) { return xc[j] * xc[j + Lag]; }) /
           den;
  }
};

template <int Lag>
__device__ __forceinline__ void acfs(const float (&xc)[W], float den,
                                     float (&r)[kOut]) {
  if constexpr (Lag <= kLags) {
    r[Lag - 1] = AcfAt<Lag>::of(xc, den);
    acfs<Lag + 1>(xc, den, r);
  }
}

// (ii) a thread per window, the window in registers
__global__ void __launch_bounds__(64) per_thread(const float* __restrict__ x,
                                                 float* __restrict__ out,
                                                 int N) {
  const int n = blockIdx.x * 64 + threadIdx.x;
  if (n >= N) return;
  const float4* src = reinterpret_cast<const float4*>(x) + n * (W / 4);
  float v[W];
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const float4 c = src[q];
    v[4 * q] = c.x;
    v[4 * q + 1] = c.y;
    v[4 * q + 2] = c.z;
    v[4 * q + 3] = c.w;
  }
  const float mean = xla_sum_c<W>([&](int j) { return v[j]; }) * (1.0f / W);
  float xc[W];
#pragma unroll
  for (int j = 0; j < W; ++j) xc[j] = v[j] - mean;
  const float var = xla_sum_c<W>([&](int j) { return xc[j] * xc[j]; }) *
                    (1.0f / W);
  float r[kOut];
  acfs<1>(xc, static_cast<float>(W) * var + kEps, r);
  r[kLags] = xla_sum_c<W>([&](int j) { return xc[j] * (xc[j] * xc[j]); }) *
             (1.0f / W);
  r[kLags + 1] = xla_sum_c<W>([&](int j) {
    const float d2 = xc[j] * xc[j];
    return d2 * d2;
  }) * (1.0f / W);
#pragma unroll
  for (int k = 0; k < kOut; ++k) out[static_cast<size_t>(n) * kOut + k] = r[k];
}
}  // namespace

extern "C" int launch(int design, const float* x, float* out, int N,
                      cudaStream_t stream) {
  if (design == 0)
    per_warp<<<(N + 7) / 8, 256, 0, stream>>>(x, out, N);
  else
    per_thread<<<(N + 63) / 64, 64, 0, stream>>>(x, out, N);
  return static_cast<int>(cudaGetLastError());
}
"""


def build() -> ctypes.CDLL:
    BUILD.mkdir(parents=True, exist_ok=True)
    src, lib = BUILD / "designs.cu", BUILD / "libdesigns.so"
    src.write_text(SOURCE)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
                    "-fPIC", "-o", str(lib), str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    so.launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_void_p]
    so.launch.restype = ctypes.c_int
    return so


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_window_designs: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data import azure_synth, windows
    so = build()
    dev = torch.device("cuda")
    x = torch.as_tensor(windows.make_windows(azure_synth.generate_traces(
        n_functions=150, n_days=14, seed=0)).windows, device=dev)
    N = x.shape[0]
    outs = {}
    for design, name in enumerate(("per_warp", "per_thread")):
        out = torch.empty((N, 32), device=dev)

        def call():
            rc = so.launch(design, x.data_ptr(), out.data_ptr(), N,
                           torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: launch failed ({rc})")
        call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call()
        end.record()
        end.synchronize()
        outs[name] = out
        print(f"[design] {name}: {start.elapsed_time(end) / 20} ms for "
              f"{N} windows (mean, variance, 2 moments, 30 lags)",
              flush=True)
    same = torch.equal(outs["per_warp"], outs["per_thread"])
    print(f"[design] both designs equal bit for bit: {same}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
