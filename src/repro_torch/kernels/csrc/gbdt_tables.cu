// gbdt_tables: GBDT logits of each row from its raw features, through the
// flattened node tables (core/gbdt.py::predict_logits, its plain version).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gbdt_tables.py
// (gbdt_logits_kernel, body _kernel). The TPU kernel binned a tile of
// rows by comparison counts and descended every (row, tree) pair in
// lockstep with vector selects; here one thread owns a row: it bins its
// features by binary search (the same integer as the count on
// non-decreasing edges), walks each tree's heap-indexed levels and sums
// each class's leaves over rounds in XLA's order (device function
// gbdt_logits in gbdt.cuh, which the AAPA episode kernel calls too).
//
// Bound on the H100: bytes. Per row the kernel reads 4 * n_features bytes
// and writes 4 * n_classes; the work is integer compares and table loads
// (240 trees x depth 4 at the paper's size, ~6 per feature to bin), with
// one f32 add per tree. The node tables are read through the read-only
// cache, where they stay resident (see gbdt.cuh).
#include "gbdt.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;

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

}  // namespace

void gbdt_tables_launch(const float* X, float* out, int N, GBDTTables g,
                        cudaStream_t stream) {
  const int grid = (N + kThreads - 1) / kThreads;
  gbdt_tables_kernel<<<grid, kThreads, 0, stream>>>(X, out, N, g);
}

}  // namespace repro_torch
