// GBDT inference over flattened node tables, one row per thread
// (core/gbdt.py: bin_features, traverse_tables, table_logits): the
// gbdt_tables kernel's "generic" variant, for ensembles whose tables do
// not fit its shared-memory variant.
//
// The tables are read through the read-only path (__ldg): every thread of
// the card reads the same tables, which stay resident in each SM's L1 (up
// to 256 KB with shared memory) as far as they fit.
#pragma once

#include "kernels.h"
#include "numerics.cuh"

namespace repro_torch {

constexpr int kMaxGBDTFeatures = 64;
constexpr int kMaxClasses = 16;

// The bin of x among non-decreasing edges: the number of edges <= x (an
// upper-bound binary search), n_edges for a NaN (searchsorted(side=right)
// of the reference's host path).
__device__ __forceinline__ int bin_of(const float* edges, int n_edges,
                                      float x) {
  if (x != x) return n_edges;
  int lo = 0, hi = n_edges;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(edges + mid) <= x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Leaf value of tree t for the binned row.
__device__ __forceinline__ float tree_leaf(const GBDTTables& g,
                                           const int* bins, int t) {
  const int n_internal = (1 << g.depth) - 1;
  const int* feat = g.feat + static_cast<size_t>(t) * n_internal;
  const int* thresh = g.thresh + static_cast<size_t>(t) * n_internal;
  int node = 0;
  for (int d = 0; d < g.depth; ++d) {
    const int at = (1 << d) - 1 + node;
    node = node * 2 + (bins[__ldg(feat + at)] > __ldg(thresh + at) ? 1 : 0);
  }
  return __ldg(g.leaf + (static_cast<size_t>(t) << g.depth) + node);
}

// x [n_features] -> logits [n_classes]; bins is scratch [n_features].
// Each class sums its trees over rounds in XLA's order, onto its base.
__device__ inline void gbdt_logits(const GBDTTables& g, const float* x, int* bins,
                            float* logits) {
  for (int f = 0; f < g.n_features; ++f)
    bins[f] = bin_of(g.edges + static_cast<size_t>(f) * g.n_edges,
                     g.n_edges, x[f]);
  const int K = g.n_classes;
  const int rounds = g.n_trees / K;
  for (int k = 0; k < K; ++k)
    logits[k] = __ldg(g.base + k) +
                xla_sum(rounds, [&](int r) { return tree_leaf(g, bins, r * K + k); });
}

}  // namespace repro_torch
