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
// Three variants, chosen by width in the launcher (window_features.py):
// * "w60", W = 60, the classification path's and AAPAset's width:
//   features.cuh::stat_time_features_w60 / freq_features_w60. The window sits
//   in 60 registers (each thread reads its row with 15 conflict-free 16-B
//   shared loads), every loop is unrolled at compile time, the order
//   statistics come from a 506-comparator sorting network, and nothing is
//   indexed at run time, so the kernel keeps no array on the stack.
// * "generic", any other W in [3, 64]: features.cuh::stat_time_features /
//   freq_features, one window per thread read from shared memory, with
//   their scratch (the insertion sort's copy, the FFT's buffers) in local
//   arrays of 64.
// * "wide", W in [3, 1,024] (chosen above 64): the same routines, each
//   thread's window and scratch in rows of dynamic shared memory (the
//   window, the sort's copy that the FFT then reuses, the FFT's second
//   buffer), of W | 1 floats so that threads reading the same sample hit
//   distinct banks. A block takes as many windows as its 227 KB hold, at
//   most 64: 18 at W = 1,024. The insertion sort is O(W^2): the variant is
//   simple and right, not fast.
// All three compute the same features bit for bit.
//
// The AAPA pre-pass (policy_signals.cu) runs the same kernels on windows
// read in place from the rates: window n = b * (R - 1) + r - 1 is the W
// minutes of lane b before minute r * stride, zero before minute 0
// (SlotWindows). A block gathers its windows into the same staging buffer,
// so no [windows, W] copy exists in device memory.
#include <algorithm>
#include <cstdint>

#include "features.cuh"

namespace repro_torch {
namespace {

constexpr int kWindows = 64;  // windows (threads) per block, at most

__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// dst [n] = src [n] by the block's `threads` threads, in 16-B pieces where
// both are 16-B aligned. The 64-window kernels pass their block size as a
// constant: with blockDim.x as the stride the W = 60 kernels ran
// 0.026-0.039 ms slower per 301,650 windows (tools/time_kernel_trees.py
// on an H100 80GB HBM3 at 700 W).
__device__ __forceinline__ void block_copy(float* dst, const float* src,
                                           int n, int threads) {
  int done = 0;
  if (aligned16(dst) && aligned16(src)) {
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < n4; i += threads)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(src)[i];
    done = 4 * n4;
  }
  for (int i = done + threadIdx.x; i < n; i += threads) dst[i] = src[i];
}

// Windows [N, W], row n at x + n * W.
struct MatrixWindows {
  const float* x;
  int W;
};

// The windows of the AAPA pre-pass's reclassifications, read from rates
// [B, M]: window n = b * per_lane + r - 1 (per_lane = R - 1 slots a lane)
// is rates[b, r * stride - W .. r * stride), zero before minute 0.
struct SlotWindows {
  const float* rates;
  int M, per_lane, stride, W;
};

// Rows i < rows of dst (ld floats apart) = windows n0 + i, by the block's
// `threads` threads: coalesced loads, 16-B where the rows are packed and
// aligned.
__device__ __forceinline__ void stage(float* dst, int ld,
                                      const MatrixWindows& s, int n0,
                                      int rows, int threads) {
  const float* src = s.x + static_cast<size_t>(n0) * s.W;
  if (ld == s.W) {
    block_copy(dst, src, rows * s.W, threads);
    return;
  }
  for (int e = threadIdx.x; e < rows * s.W; e += threads) {
    const int i = e / s.W;
    dst[i * ld + e - i * s.W] = src[e];
  }
}

__device__ __forceinline__ void stage(float* dst, int ld,
                                      const SlotWindows& s, int n0,
                                      int rows, int threads) {
  for (int e = threadIdx.x; e < rows * s.W; e += threads) {
    const int i = e / s.W, j = e - i * s.W;
    const int n = n0 + i;
    const int b = n / s.per_lane;
    const int m = (n - b * s.per_lane + 1) * s.stride - s.W + j;
    dst[i * ld + j] =
        m >= 0 ? __ldg(s.rates + static_cast<size_t>(b) * s.M + m) : 0.0f;
  }
}

// "w60" (kFixed60) and "generic": windows from src -> out [N, 28], or with
// kFreq out [N, 38]; 64 windows a block.
template <bool kFixed60, bool kFreq, class Src>
__global__ void __launch_bounds__(kWindows)
    window_features_kernel(Src src, FreqTables freq, float* __restrict__ out,
                           int N, int W) {
  constexpr int kOut = kFreq ? kFeatures : kStatFeatures;
  __shared__ __align__(16) float buf[kWindows * kMaxWindow];
  const int n0 = blockIdx.x * kWindows;
  const int rows = min(kWindows, N - n0);
  stage(buf, W, src, n0, rows, kWindows);
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
      float xs[kMaxWindow], b[kMaxWindow];  // xs is the FFT's first buffer
      stat_time_features(row, xs, W, feats);
      if constexpr (kFreq)
        freq_features(row, W, freq, xs, b, feats + kStatFeatures);
    }
  }
  __syncthreads();  // every window is read: the buffer takes the features
  if (t < rows) {
#pragma unroll
    for (int k = 0; k < kOut; ++k) buf[t * kOut + k] = feats[k];
  }
  __syncthreads();
  block_copy(out + static_cast<size_t>(n0) * kOut, buf, rows * kOut,
             kWindows);
}

// Floats of shared memory a "wide" thread holds at width W: rows of W | 1
// for the window, the sort's copy (the FFT's first buffer) and, with the
// frequency features, the FFT's second buffer; at least its features,
// which leave the block through the same memory.
int wide_floats(int W, bool freq) {
  return std::max((freq ? 3 : 2) * (W | 1),
                  freq ? kFeatures : kStatFeatures);
}

// "wide": windows from src -> out [N, 28 or 38], blockDim.x windows a
// block, each thread's window and scratch in rows of W | 1 floats of
// dynamic shared memory (wide_floats of it a thread, see wide_block).
template <bool kFreq, class Src>
__global__ void __launch_bounds__(kWindows)
    window_features_wide_kernel(Src src, FreqTables freq,
                                float* __restrict__ out, int N, int W) {
  constexpr int kOut = kFreq ? kFeatures : kStatFeatures;
  extern __shared__ __align__(16) float rows_smem[];
  const int T = blockDim.x, t = threadIdx.x, ld = W | 1;
  const int n0 = blockIdx.x * T;
  const int rows = min(T, N - n0);
  stage(rows_smem, ld, src, n0, rows, T);
  __syncthreads();

  float feats[kOut];
  if (t < rows) {
    const float* x = rows_smem + t * ld;
    float* s1 = rows_smem + (T + t) * ld;
    stat_time_features(x, s1, W, feats);
    if constexpr (kFreq)
      freq_features(x, W, freq, s1, rows_smem + (2 * T + t) * ld,
                    feats + kStatFeatures);
  }
  __syncthreads();  // every window is read: the rows take the features
  if (t < rows) {
#pragma unroll
    for (int k = 0; k < kOut; ++k) rows_smem[t * kOut + k] = feats[k];
  }
  __syncthreads();
  block_copy(out + static_cast<size_t>(n0) * kOut, rows_smem, rows * kOut,
             T);
}

// The wide variant's block at width W: as many threads as the device's
// largest block of shared memory holds rows for, at most kWindows; its
// dynamic shared memory in *smem.
int wide_block(int W, bool freq, size_t* smem) {
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  const size_t per_thread = sizeof(float) * wide_floats(W, freq);
  const int T = std::max(
      1, std::min(kWindows, static_cast<int>(optin / per_thread)));
  *smem = T * per_thread;
  return T;
}

template <bool kFreq, class Src>
void launch(Src src, float* out, int N, int W, const FreqTables& freq,
            WfVariant variant, cudaStream_t stream) {
  if (variant == kWfWide) {
    size_t smem = 0;
    const int T = wide_block(W, kFreq, &smem);
    const auto kernel = window_features_wide_kernel<kFreq, Src>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    kernel<<<(N + T - 1) / T, T, smem, stream>>>(src, freq, out, N, W);
    return;
  }
  const int grid = (N + kWindows - 1) / kWindows;
  if (variant == kWfW60)
    window_features_kernel<true, kFreq, Src><<<grid, kWindows, 0, stream>>>(
        src, freq, out, N, W);
  else
    window_features_kernel<false, kFreq, Src><<<grid, kWindows, 0, stream>>>(
        src, freq, out, N, W);
}

}  // namespace

void window_features_launch(const float* windows, float* out, int N, int W,
                            const FreqTables* freq, WfVariant variant,
                            cudaStream_t stream) {
  const MatrixWindows src{windows, W};
  if (freq == nullptr)
    launch<false>(src, out, N, W, FreqTables{}, variant, stream);
  else
    launch<true>(src, out, N, W, *freq, variant, stream);
}

void window_features_slots_launch(const float* rates, float* out, int B,
                                  int M, int R, int stride, int W,
                                  const FreqTables& freq, WfVariant variant,
                                  cudaStream_t stream) {
  launch<true>(SlotWindows{rates, M, R - 1, stride, W}, out, B * (R - 1), W,
               freq, variant, stream);
}

}  // namespace repro_torch
