// window_features: the 28 statistical and time-domain features of each
// window (core/features.py::stat_time_features, its plain version), and
// on the classification path all 38: those 28 and the 10 frequency
// features (core/features.py::extract_features).
//
// Replaces the Pallas TPU kernel src/repro/kernels/window_features.py
// (window_features_kernel, body _kernel). The TPU kernel found ranks by
// O(W^2) lane rotations because the VPU has no sort. The reference
// computes the 10 frequency features with an XLA rFFT outside its kernel;
// here they are the same real FFT as jnp.fft.rfft on the CPU (ducc0's
// radix passes), in the same launch.
//
// Bound on the H100: operations. Per 60-sample window the kernel reads
// 240 bytes and writes 112 (152 with the frequency features), against
// ~7,500 f32 operations for the 30 autocorrelations, the moments, the
// order statistics and the trend (and ~900 more for the FFT), far above
// the card's operations-per-byte ridge. Every sum is one left-to-right sum
// in XLA's order, so the parallelism is across windows: one window a
// thread, 64 windows a block.
//
// Loads and stores are coalesced: a block's windows are one contiguous
// span of [N, W], which the block copies into shared memory in 16-B loads
// (4-B where the span is not 16-B aligned). Its features, a contiguous
// span of [N, 28 or 38], go out the same way through the same buffer.
//
// Two kernels, chosen by width in the launcher (window_features.py):
// * W = 60, the classification path's and AAPAset's width:
//   features.cuh::stat_time_features_w60 / freq_features_w60. The window sits
//   in 60 registers (each thread reads its row with 15 conflict-free 16-B
//   shared loads), every loop is unrolled at compile time, the order
//   statistics come from a 506-comparator sorting network, and nothing is
//   indexed at run time, so the kernel keeps no array on the stack.
// * Any other W in [3, 64]: features.cuh::stat_time_features /
//   freq_features, the AAPA episode's own routines, one window per thread
//   read from shared memory, with their scratch (the insertion sort's copy,
//   the FFT's buffers) in local memory.
// Both compute the same features bit for bit.
#include <cstdint>

#include "features.cuh"

namespace repro_torch {
namespace {

constexpr int kWindows = 64;  // windows (threads) per block

__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// dst [n] = src [n] by the whole block, in 16-B pieces where both are
// 16-B aligned
__device__ __forceinline__ void block_copy(float* dst, const float* src,
                                           int n) {
  int done = 0;
  if (aligned16(dst) && aligned16(src)) {
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < n4; i += kWindows)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(src)[i];
    done = 4 * n4;
  }
  for (int i = done + threadIdx.x; i < n; i += kWindows) dst[i] = src[i];
}

// windows [N, W] -> out [N, 28], or with kFreq out [N, 38]. kFixed60: the
// window in registers at W = 60; else the routines for any W.
template <bool kFixed60, bool kFreq>
__global__ void __launch_bounds__(kWindows)
    window_features_kernel(const float* __restrict__ windows, FreqTables freq,
                           float* __restrict__ out, int N, int W) {
  constexpr int kOut = kFreq ? kFeatures : kStatFeatures;
  __shared__ __align__(16) float buf[kWindows * kMaxWindow];
  const int n0 = blockIdx.x * kWindows;
  const int rows = min(kWindows, N - n0);
  block_copy(buf, windows + static_cast<size_t>(n0) * W, rows * W);
  __syncthreads();

  float feats[kOut];
  const int t = threadIdx.x;
  if (t < rows) {
    if constexpr (kFixed60) {
      const float* row = buf + t * kW60;
      float x[kW60];
#pragma unroll
      for (int q = 0; q < kW60 / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(row)[q];
        x[4 * q] = v.x;
        x[4 * q + 1] = v.y;
        x[4 * q + 2] = v.z;
        x[4 * q + 3] = v.w;
      }
      stat_time_features_w60(x, row, feats);
      if constexpr (kFreq) freq_features_w60(x, freq, feats + kStatFeatures);
    } else {
      const float* row = buf + t * W;
      float xs[kMaxWindow];
      stat_time_features(row, xs, W, feats);
      if constexpr (kFreq) freq_features(row, W, freq, feats + kStatFeatures);
    }
  }
  __syncthreads();  // every window is read: the buffer takes the features
  if (t < rows) {
#pragma unroll
    for (int k = 0; k < kOut; ++k) buf[t * kOut + k] = feats[k];
  }
  __syncthreads();
  block_copy(out + static_cast<size_t>(n0) * kOut, buf, rows * kOut);
}

template <bool kFixed60>
void launch(const float* windows, float* out, int N, int W,
            const FreqTables* freq, cudaStream_t stream) {
  const int grid = (N + kWindows - 1) / kWindows;
  if (freq == nullptr) {
    window_features_kernel<kFixed60, false><<<grid, kWindows, 0, stream>>>(
        windows, FreqTables{}, out, N, W);
  } else {
    window_features_kernel<kFixed60, true><<<grid, kWindows, 0, stream>>>(
        windows, *freq, out, N, W);
  }
}

}  // namespace

void window_features_launch(const float* windows, float* out, int N, int W,
                            const FreqTables* freq, bool w60,
                            cudaStream_t stream) {
  if (w60)
    launch<true>(windows, out, N, W, freq, stream);
  else
    launch<false>(windows, out, N, W, freq, stream);
}

}  // namespace repro_torch
