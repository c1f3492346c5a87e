#!/usr/bin/env python3
"""Measure the two traversal designs of the ``gbdt_tables`` kernel's
shared variant, and its tile and group sizes, on the classification
path's launch.

    python3 tools/probe_gbdt_designs.py

Both designs stage the node tables (one 8-B word a node: the feature and
the value it tests against) and tiles of rows in shared memory as
``csrc/gbdt_tables.cu`` does, and add the leaves in XLA's order:

(i)  ``descent``: each thread walks G trees of its row at once, one level
     per step, reading only the nodes on its path (depth loads a tree,
     each a node load then a feature load that depends on it).
(ii) ``level``: each thread tests every internal node of G trees (15 at
     depth 4) into a bit mask, then walks the mask. Every node load is a
     broadcast across the warp and every feature load is free of bank
     conflicts, at 2^depth - 1 tests a tree instead of depth.

Each design runs at tiles of 256 to 512 rows and G of 2 to 16, with the
depth a run-time value or compiled as 4. The CUDA source is in this file,
built with ``nvcc`` into ``build/probe_gbdt_designs/`` and loaded with
ctypes. Input: the 301,650 AAPAset windows' 38 features
(``generate_traces(n_functions=150, n_days=14, seed=0)``, 60-minute
windows at stride 10) and ``chip_smoke.seeded_classifier``'s ensemble (60
rounds x 4 classes, depth 4, 64 bins). Every configuration must equal
``kernels.ops.gbdt_logits`` bit for bit; each is timed with CUDA events (a
warm-up launch, then the mean of 20) beside the shipped kernel's two
variants, and the script prints the card's ``nvidia-smi`` name and power
limit. Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "probe_gbdt_designs"

SOURCE = r"""
#include <cmath>
#include <cuda_runtime.h>

namespace {
struct Node { int feat; float split; };

template <int kDesign, int kG, int kDepth>
__device__ __forceinline__ void leaves_of(const Node* nodes,
                                          const float* leaves,
                                          const float* x, int depth_rt,
                                          int r, int last, int K, int k,
                                          float (&leaf)[kG]) {
  const int depth = kDepth ? kDepth : depth_rt;
  const int n_int = (1 << depth) - 1;
  int tree[kG], at[kG];
#pragma unroll
  for (int j = 0; j < kG; ++j) tree[j] = (r + min(j, last)) * K + k;
  if (kDesign == 0) {
#pragma unroll
    for (int j = 0; j < kG; ++j) at[j] = 0;
#pragma unroll
    for (int d = 0; d < depth; ++d) {
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        const Node n = nodes[tree[j] * n_int + at[j]];
        at[j] = 2 * at[j] + (x[n.feat] < n.split ? 1 : 2);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      const Node* t = nodes + tree[j] * n_int;
      unsigned mask = 0;
#pragma unroll
      for (int i = 0; i < n_int; ++i) {
        const Node n = t[i];
        mask |= (x[n.feat] < n.split ? 0u : 1u) << i;
      }
      int a = 0;
#pragma unroll
      for (int d = 0; d < depth; ++d) a = 2 * a + 1 + ((mask >> a) & 1);
      at[j] = a;
    }
  }
#pragma unroll
  for (int j = 0; j < kG; ++j)
    leaf[j] = leaves[(tree[j] << depth) + at[j] - n_int];
}

template <int kDesign, int kRows, int kG, int kDepth>
__global__ void __launch_bounds__(kRows) probe(
    const float* __restrict__ X, float* __restrict__ out, int N,
    const float* __restrict__ edges, const int* __restrict__ feat,
    const int* __restrict__ thresh, const float* __restrict__ leaf,
    const float* __restrict__ base, int F, int E, int n_trees, int K,
    int depth) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_nodes = n_trees * ((1 << depth) - 1);
  const int n_leaves = n_trees << depth;
  const int xstride = (F + 1) | 1, ostride = K | 1;
  Node* nodes = reinterpret_cast<Node*>(smem);
  float* leaves = reinterpret_cast<float*>(nodes + n_nodes);
  float* xs = leaves + n_leaves;
  float* os = xs + kRows * xstride;
  const int tid = threadIdx.x;
  for (int i = tid; i < n_nodes; i += kRows) {
    const int f = feat[i], t = thresh[i];
    nodes[i] = t < 0 ? Node{F, -INFINITY}
             : t >= E ? Node{F, INFINITY} : Node{f, edges[f * E + t]};
  }
  for (int i = tid; i < n_leaves; i += kRows) leaves[i] = leaf[i];
  xs[tid * xstride + F] = -INFINITY;
  const int rounds = n_trees / K, n_tiles = (N + kRows - 1) / kRows;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * kRows, rows = min(kRows, N - r0), n = rows * F;
    const float* src = X + static_cast<size_t>(r0) * F;
    __syncthreads();
    for (int q = tid; q < n / 4; q += kRows) {
      const float4 v = reinterpret_cast<const float4*>(src)[q];
      int r = 4 * q / F, c = 4 * q - r * F;
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xs[r * xstride + c] = e[j];
        if (++c == F) c = 0, ++r;
      }
    }
    for (int e = n / 4 * 4 + tid; e < n; e += kRows)
      xs[e / F * xstride + e % F] = src[e];
    __syncthreads();
    if (tid < rows) {
      const float* x = xs + tid * xstride;
      for (int k = 0; k < K; ++k) {
        const int n_win = (rounds + 31) / 32, low = (n_win * 32 - rounds) / 2;
        float total = 0.0f;
        for (int w = 0; w < n_win; ++w) {
          const int lo = max(w * 32 - low, 0);
          const int hi = min((w + 1) * 32 - low, rounds);
          float s = 0.0f;
          for (int r = lo; r < hi; r += kG) {
            const int last = min(kG, hi - r) - 1;
            float v[kG];
            leaves_of<kDesign, kG, kDepth>(nodes, leaves, x, depth, r, last,
                                           K, k, v);
#pragma unroll
            for (int j = 0; j < kG; ++j)
              if (j <= last) s = r + j == lo ? v[j] : s + v[j];
          }
          total = w == 0 ? s : total + s;
        }
        os[tid * ostride + k] = base[k] + total;
      }
    }
    __syncthreads();
    for (int e = tid; e < rows * K; e += kRows)
      out[static_cast<size_t>(r0) * K + e] = os[e / K * ostride + e % K];
  }
}

template <int kDesign, int kRows, int kG, int kDepth>
int run(const float* X, float* out, int N, const float* edges,
        const int* feat, const int* thresh, const float* leaf,
        const float* base, int F, int E, int n_trees, int K, int depth,
        cudaStream_t stream) {
  auto kernel = probe<kDesign, kRows, kG, kDepth>;
  const size_t smem = n_trees * (8 * ((1 << depth) - 1) + 4 * (1 << depth))
                      + 4 * kRows * (((F + 1) | 1) + (K | 1));
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRows, smem);
  const int tiles = (N + kRows - 1) / kRows;
  const int grid = min(tiles, max(per_sm, 1) * sms);
  kernel<<<grid, kRows, smem, stream>>>(X, out, N, edges, feat, thresh, leaf,
                                        base, F, E, n_trees, K, depth);
  return static_cast<int>(cudaGetLastError());
}

#define CONFIGS(X) \
  X(0, 384, 2, 0) X(0, 384, 4, 0) X(0, 384, 8, 0) X(0, 384, 2, 4) \
  X(0, 384, 4, 4) X(0, 384, 8, 4) X(0, 384, 16, 4) X(0, 256, 8, 4) \
  X(0, 512, 8, 4) X(0, 256, 8, 0) X(1, 384, 2, 4) X(1, 384, 4, 4)
}  // namespace

extern "C" int n_configs() {
  int n = 0;
#define COUNT(d, r, g, dp) ++n;
  CONFIGS(COUNT)
  return n;
}

extern "C" void config(int i, int* desc) {
  int n = 0;
#define DESC(d, r, g, dp) \
  if (n++ == i) desc[0] = d, desc[1] = r, desc[2] = g, desc[3] = dp;
  CONFIGS(DESC)
}

extern "C" int launch(int i, const float* X, float* out, int N,
                      const float* edges, const int* feat, const int* thresh,
                      const float* leaf, const float* base, int F, int E,
                      int n_trees, int K, int depth, cudaStream_t stream) {
  int n = 0;
#define LAUNCH(d, r, g, dp) \
  if (n++ == i) return run<d, r, g, dp>(X, out, N, edges, feat, thresh, \
                                        leaf, base, F, E, n_trees, K, depth, \
                                        stream);
  CONFIGS(LAUNCH)
  return -1;
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
    so.launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                          + [ctypes.c_int] + [ctypes.c_void_p] * 5
                          + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    so.launch.restype = ctypes.c_int
    so.n_configs.argtypes = []
    so.n_configs.restype = ctypes.c_int
    so.config.argtypes = [ctypes.c_int, ctypes.c_void_p]
    so.config.restype = None
    return so


def cuda_ms(fn, iters: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_gbdt_designs: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import seeded_classifier
    from repro_torch.data import azure_synth, windows
    from repro_torch.kernels import gbdt_tables, ops
    so = build()
    dev = torch.device("cuda")
    wins = torch.as_tensor(windows.make_windows(azure_synth.generate_traces(
        n_functions=150, n_days=14, seed=0)).windows, device=dev)
    X = ops.extract_features_fused(wins)
    params = seeded_classifier(X.cpu().numpy(), dev).params
    N, F = X.shape
    edges, feat, thresh, leaf, base = gbdt_tables.table_args(params)
    E, (n_trees, K) = edges.shape[1], (feat.shape[0], base.shape[0])
    want = ops.gbdt_logits(params, X)
    for variant in gbdt_tables.VARIANTS:
        ms = cuda_ms(lambda: gbdt_tables.gbdt_logits_cuda(params, X,
                                                          variant=variant))
        print(f"[shipped] {variant}: {ms} ms", flush=True)
    same = True
    for i in range(so.n_configs()):
        desc = (ctypes.c_int * 4)()
        so.config(i, desc)
        design, rows, group, depth = desc
        name = (f"{('descent', 'level')[design]} rows {rows} G {group} "
                f"depth {'4 compiled' if depth else 'at run time'}")
        out = torch.empty_like(want)

        def call():
            rc = so.launch(i, X.data_ptr(), out.data_ptr(), N,
                           edges.data_ptr(), feat.data_ptr(),
                           thresh.data_ptr(), leaf.data_ptr(),
                           base.data_ptr(), F, E, n_trees, K, params.depth,
                           torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: launch failed ({rc})")
        ms = cuda_ms(call)
        equal = torch.equal(out, want)
        same &= equal
        print(f"[design] {name}: {ms} ms for {N} rows, equal to the "
              f"shipped kernel: {equal}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
