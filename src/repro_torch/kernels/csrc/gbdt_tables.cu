// gbdt_tables: GBDT logits of each row from its raw features, through the
// flattened node tables (core/gbdt.py::predict_logits, its plain version).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gbdt_tables.py
// (gbdt_logits_kernel, body _kernel). The TPU kernel binned a tile of
// rows by comparison counts and descended every (row, tree) pair in
// lockstep with vector selects. Here one thread owns a row, in one of two
// variants, both bit for bit with the plain version:
//
// * "shared" (gbdt_shared_kernel), for ensembles whose node tables fit
//   kGBDTSharedTableMax bytes (the paper's 240 trees of depth 4: 44 KB).
//   A persistent grid (as many blocks as fit on the card at once: 2 a SM
//   at the paper's size, 111,744 B each) stages the tables in shared memory
//   once per block, then loops over tiles of kRows (384) rows:
//   - Each node is one 8-B word (the feature a row tests, the value it
//     tests against), built while staging from feat, thresh and the bin
//     edges. No bins are computed: a node sends a row right when bin(x) >
//     t, bin(x) being the number of edges <= x, and for non-decreasing
//     edges and 0 <= t < E that is exactly !(x < edges[f][t]): both hold
//     iff edges[0..t] are all <= x. A NaN x goes right in both forms (its
//     bin is E > t); -0 and +0 compare equal in both, +-inf as any value.
//     A threshold t < 0 sends every row right and t >= E every row left;
//     such a node tests column F of the tile, which holds -inf, against
//     -inf (-inf < -inf is false: right) or +inf (true: left).
//   - A tile's [rows, F] span of X is contiguous: the block loads it with
//     coalesced 16-B loads (4-B where the span is not 16-B aligned) into
//     rows of (F + 1) | 1 floats, an odd stride, so threads reading the
//     same feature of different rows hit distinct banks.
//   - Each thread descends kGroup (8) trees of one class at a time, level
//     by level (the independent descents interleave; each level is a node
//     load and a feature load from shared memory that depends on it), and
//     adds their leaves to its class sum in XLA's order
//     (numerics.cuh::xla_sum: the leaves are computed in groups, added one
//     by one in that order, onto the base logit), as gbdt.cuh::gbdt_logits
//     does. The paper's depth (4) is compiled in, so the level loop
//     unrolls; other depths take the instance with the depth at run time.
//     Descending only the path beats testing every node of a tree into a
//     bit mask (broadcast node loads, conflict-free feature loads, but 15
//     tests a tree instead of 4): 0.168 against 0.398 ms at 301,650 rows
//     (tools/probe_gbdt_designs.py on an H100 80GB HBM3 at 700 W, which
//     also picked 384-row tiles and groups of 8).
//   - The logits go through shared memory (rows of K | 1 floats) and out
//     in one coalesced [rows, K] span.
//   No array is indexed at run time outside shared memory, so the kernel
//   holds no stack.
// * "generic" (gbdt_tables_kernel), any ensemble the binding admits: the
//   per-thread kernel of gbdt.cuh (binary-search binning, tables through
//   the read-only cache).
// The AAPA pre-pass's reclassification (policy_signals.cu) runs the same
// launcher on its windows' features, in the variant the tables' size
// picks.
//
// Bound on the H100: bytes. Per row the kernel reads 4 * n_features bytes
// and writes 4 * n_classes; the work is 960 node tests (240 trees x depth
// 4) and 240 f32 adds a row at the paper's size, ~2,200 shared-memory
// loads, which each of the 132 SMs serves at one warp-wide load a cycle.
#include <algorithm>
#include <cmath>
#include <cstdint>

#include "gbdt.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;  // generic: rows per block
constexpr int kRows = 384;     // shared: rows (threads) per block and tile
constexpr int kGroup = 8;      // shared: trees a thread descends at once
constexpr int kPaperDepth = 4;  // shared: the depth compiled in (else run time)

__global__ void gbdt_tables_kernel(const float* __restrict__ X,
                                   float* __restrict__ out, int N,
                                   GBDTTables g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  int bins[kMaxGBDTFeatures];
  float logits[kMaxClasses];
  gbdt_logits(g, X + static_cast<size_t>(i) * g.n_features, bins, logits);
  float* o = out + static_cast<size_t>(i) * g.n_classes;
  for (int k = 0; k < g.n_classes; ++k) o[k] = logits[k];
}

// A node test as the shared variant stages it: go right unless
// x[feat] < split.
struct Node {
  int feat;
  float split;
};

__device__ __forceinline__ Node make_node(const GBDTTables& g, int i) {
  const int f = __ldg(g.feat + i), t = __ldg(g.thresh + i);
  if (t < 0) return Node{g.n_features, -INFINITY};
  if (t >= g.n_edges) return Node{g.n_features, INFINITY};
  return Node{f, __ldg(g.edges + static_cast<size_t>(f) * g.n_edges + t)};
}

// The leaves of class k's trees in rounds r .. r + last (last < kGroup)
// for the row x, descended together one level per step of the depth loop
// (the slots past `last` repeat round r + last). kDepth: the depth, 0 for
// the run-time depth_rt.
template <int kDepth>
__device__ __forceinline__ void descend(const Node* nodes,
                                        const float* leaves, const float* x,
                                        int depth_rt, int r, int last, int K,
                                        int k, float (&leaf)[kGroup]) {
  const int depth = kDepth ? kDepth : depth_rt;
  const int n_int = (1 << depth) - 1;
  int tree[kGroup], at[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    tree[j] = (r + min(j, last)) * K + k;
    at[j] = 0;
  }
#pragma unroll
  for (int d = 0; d < depth; ++d) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const Node n = nodes[tree[j] * n_int + at[j]];
      at[j] = 2 * at[j] + (x[n.feat] < n.split ? 1 : 2);
    }
  }
#pragma unroll
  for (int j = 0; j < kGroup; ++j)
    leaf[j] = leaves[(tree[j] << depth) + at[j] - n_int];
}

// Class k's leaves over `rounds` rounds (tree r * K + k), added in XLA's
// order (numerics.cuh::xla_sum), kGroup rounds descended at a time.
template <int kDepth>
__device__ __forceinline__ float class_sum(const Node* nodes,
                                           const float* leaves,
                                           const float* x, int depth,
                                           int rounds, int K, int k) {
  const int n_win = (rounds + kXlaWindow - 1) / kXlaWindow;
  const int low = (n_win * kXlaWindow - rounds) / 2;
  float total = 0.0f;
  for (int w = 0; w < n_win; ++w) {
    const int lo = max(w * kXlaWindow - low, 0);
    const int hi = min((w + 1) * kXlaWindow - low, rounds);
    float s = 0.0f;
    for (int r = lo; r < hi; r += kGroup) {
      const int last = min(kGroup, hi - r) - 1;
      float leaf[kGroup];
      descend<kDepth>(nodes, leaves, x, depth, r, last, K, k, leaf);
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (j <= last) s = r + j == lo ? leaf[j] : s + leaf[j];
    }
    total = w == 0 ? s : total + s;
  }
  return total;
}

template <int kDepth>
__global__ void __launch_bounds__(kRows, 2)
    gbdt_shared_kernel(const float* __restrict__ X, float* __restrict__ out,
                       int N, GBDTTables g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = g.n_features, K = g.n_classes, depth = g.depth;
  const int n_nodes = g.n_trees * ((1 << depth) - 1);
  const int n_leaves = g.n_trees << depth;
  const int xstride = (F + 1) | 1, ostride = K | 1;
  Node* nodes = reinterpret_cast<Node*>(smem);
  float* leaves = reinterpret_cast<float*>(nodes + n_nodes);
  float* xs = leaves + n_leaves;
  float* os = xs + kRows * xstride;
  const int tid = threadIdx.x;

  for (int i = tid; i < n_nodes; i += kRows) nodes[i] = make_node(g, i);
  for (int i = tid; i < n_leaves; i += kRows) leaves[i] = __ldg(g.leaf + i);
  xs[tid * xstride + F] = -INFINITY;  // the column of t < 0 and t >= E

  const int rounds = g.n_trees / K;
  const int n_tiles = (N + kRows - 1) / kRows;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * kRows, rows = min(kRows, N - r0);
    const int n = rows * F;
    const float* src = X + static_cast<size_t>(r0) * F;
    __syncthreads();  // the tables are staged; the last tile is stored
    int done = 0;
    if (reinterpret_cast<std::uintptr_t>(src) % 16 == 0) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      for (int q = tid; q < n / 4; q += kRows) {
        const float4 v = __ldg(src4 + q);
        int r = 4 * q / F, c = 4 * q - r * F;
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          xs[r * xstride + c] = e[j];
          if (++c == F) c = 0, ++r;
        }
      }
      done = n / 4 * 4;
    }
    for (int e = done + tid; e < n; e += kRows)
      xs[e / F * xstride + e % F] = __ldg(src + e);
    __syncthreads();

    if (tid < rows) {
      const float* x = xs + tid * xstride;
      for (int k = 0; k < K; ++k)
        os[tid * ostride + k] =
            __ldg(g.base + k) +
            class_sum<kDepth>(nodes, leaves, x, depth, rounds, K, k);
    }
    __syncthreads();
    float* dst = out + static_cast<size_t>(r0) * K;
    for (int e = tid; e < rows * K; e += kRows)
      dst[e] = os[e / K * ostride + e % K];
  }
}

size_t shared_bytes(const GBDTTables& g) {
  const int xstride = (g.n_features + 1) | 1, ostride = g.n_classes | 1;
  return gbdt_shared_table_bytes(g.n_trees, g.depth) +
         sizeof(float) * kRows * (xstride + ostride);
}

}  // namespace

size_t gbdt_shared_table_bytes(int n_trees, int depth) {
  return static_cast<size_t>(n_trees) *
         (sizeof(Node) * ((size_t{1} << depth) - 1) +
          sizeof(float) * (size_t{1} << depth));
}

void gbdt_tables_launch(const float* X, float* out, int N, GBDTTables g,
                        bool shared, cudaStream_t stream) {
  if (!shared) {
    const int grid = (N + kThreads - 1) / kThreads;
    gbdt_tables_kernel<<<grid, kThreads, 0, stream>>>(X, out, N, g);
    return;
  }
  auto kernel = g.depth == kPaperDepth ? gbdt_shared_kernel<kPaperDepth>
                                       : gbdt_shared_kernel<0>;
  const size_t smem = shared_bytes(g);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRows, smem);
  const int tiles = (N + kRows - 1) / kRows;
  const int grid = std::min(tiles, std::max(per_sm, 1) * sms);
  kernel<<<grid, kRows, smem, stream>>>(X, out, N, g);
}

}  // namespace repro_torch
