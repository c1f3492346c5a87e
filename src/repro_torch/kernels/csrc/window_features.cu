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
// the card's operations-per-byte ridge; at 1,024 samples 4 KB against
// ~200,000 operations. Every sum is a left-to-right sum in XLA's order.
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
//   Both run one window a thread, 64 windows a block: a block's windows
//   are one contiguous span of [N, W], copied into shared memory in 16-B
//   loads (4-B where the span is not 16-B aligned), and its features go
//   out the same way through the same buffer.
// * "wide", W in [3, 1,024] (chosen above 64): one window a group of G
//   lanes, G = 8 up to 128 samples (four windows a warp) and 32 above
//   (features.cuh::stat_time_features_warp / freq_features_warp). One
//   thread's chain of W-term sums and an O(W^2) sort would leave the card
//   a few windows an SM, each a long serial chain. So each group loads its
//   window (coalesced, 16-B where aligned) into a row of shared memory with
//   one pad float every 32 samples, and splits the work across its lanes
//   without changing a bit: XLA sums 32-term chunks left to right and
//   then the chunk totals left to right, and every sum here has at most
//   32 chunks (at most G), so each (sum, chunk) pair is one lane's chain
//   (the 30 autocorrelation lags x their chunks fill the lanes) and one
//   lane a sum adds the totals. The order statistics come from a bitonic
//   sort of the window in registers, G R values (R a template parameter,
//   so no array is indexed at run time); a window holding NaN instead
//   counts each sample's place in the insertion sort's result across the
//   lanes. The FFT's radix passes run each pass's butterflies across the
//   lanes, every output op for op, and ping-pong between the two rows. The
//   spectrum's sums stay chains, five and then three side by side on
//   their own lanes, over terms the lanes computed first. Below 129
//   samples most of these steps use a few lanes (a window has at most four
//   chunks), so a group of 8 lanes takes a window and a warp four. A
//   window's shared memory: 2 rows + max(4 ceil(W / 32), 64) floats, 1,312
//   B at W = 120, 8,992 B at W = 1,024.
// All three compute the same features bit for bit (for a window that
// mixes -0 and +0, only the sign of a zero order statistic may differ).
//
// The AAPA pre-pass (policy_signals.cu) runs the same kernels on windows
// read in place from the rates: window n = b * (R - 1) + r - 1 is the W
// minutes of lane b before minute r * stride, zero before minute 0
// (SlotWindows). A block (in the wide kernel, a group) gathers its windows
// into shared memory, so no [windows, W] copy exists in device memory.
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

// Rows i < rows of dst (W floats apart) = windows n0 + i, by the block's
// `threads` threads: coalesced loads, 16-B where aligned.
__device__ __forceinline__ void stage(float* dst, const MatrixWindows& s,
                                      int n0, int rows, int threads) {
  block_copy(dst, s.x + static_cast<size_t>(n0) * s.W, rows * s.W, threads);
}

__device__ __forceinline__ void stage(float* dst, const SlotWindows& s,
                                      int n0, int rows, int threads) {
  for (int e = threadIdx.x; e < rows * s.W; e += threads) {
    const int i = e / s.W, j = e - i * s.W;
    const int n = n0 + i;
    const int b = n / s.per_lane;
    const int m = (n - b * s.per_lane + 1) * s.stride - s.W + j;
    dst[e] = m >= 0 ? __ldg(s.rates + static_cast<size_t>(b) * s.M + m)
                    : 0.0f;
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
  stage(buf, src, n0, rows, kWindows);
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

// "wide": one window a group of G lanes (8 up to 128 samples, else 32),
// blocks of kWideWarps warps. Each window's dynamic shared memory holds two
// rows of wide_row(W) floats (the window skewed, then the centred window)
// and warp_part_floats(W) of scratch (wide_window_floats); its lanes write
// its features out.
constexpr int kWideWarps = 4;

// Floats of one row at width W: the skewed window (one pad float every
// 32 samples), which also takes the 30 autocorrelations' chunk totals and
// the FFT's buffers; a multiple of 4
__host__ __device__ constexpr int wide_row(int W) {
  const int skewed = W + (W + kWarp - 1) / kWarp;
  const int acf_chunks = kAcfHi * ((W + kWarp - 2) / kWarp);
  return ((skewed > acf_chunks ? skewed : acf_chunks) + 3) / 4 * 4;
}
// ... and of one window: its two rows and scratch, padded to 8 floats
// past a multiple of 32, so that the four windows of a warp's groups of
// 8 lanes start 8 banks apart
__host__ __device__ constexpr int wide_window_floats(int W) {
  return (2 * wide_row(W) + warp_part_floats(W) + 23) / 32 * 32 + 8;
}

// Window n into the group's row x (skewed), lane by lane: coalesced
// loads, 16-B where the window is 16-B aligned
template <int G>
__device__ __forceinline__ void load_window(float* x, const MatrixWindows& s,
                                            int n, const Group<G>& g) {
  const float* src = s.x + static_cast<size_t>(n) * s.W;
  int done = 0;
  if (aligned16(src)) {
    const int n4 = s.W / 4;
    for (int q = g.l; q < n4; q += G) {
      const float4 v = reinterpret_cast<const float4*>(src)[q];
      const int j = 4 * q;  // j .. j + 3 share one 32-sample stretch
      x[skew(j)] = v.x;
      x[skew(j) + 1] = v.y;
      x[skew(j) + 2] = v.z;
      x[skew(j) + 3] = v.w;
    }
    done = 4 * n4;
  }
  for (int j = done + g.l; j < s.W; j += G) x[skew(j)] = src[j];
}

template <int G>
__device__ __forceinline__ void load_window(float* x, const SlotWindows& s,
                                            int n, const Group<G>& g) {
  const int b = n / s.per_lane;
  const int m0 = (n - b * s.per_lane + 1) * s.stride - s.W;
  const float* lane_rates = s.rates + static_cast<size_t>(b) * s.M;
  for (int j = g.l; j < s.W; j += G)
    x[skew(j)] = m0 + j >= 0 ? __ldg(lane_rates + m0 + j) : 0.0f;
}

// "wide": windows from src -> out [N, 28 or 38], W <= G R.
template <int G, int R, bool kFreq, class Src>
__global__ void __launch_bounds__(kWideWarps * kWarp)
    window_features_wide_kernel(Src src, FreqTables freq,
                                float* __restrict__ out, int N, int W) {
  constexpr int kOut = kFreq ? kFeatures : kStatFeatures;
  constexpr int kPerBlock = kWideWarps * kWarp / G;
  extern __shared__ __align__(16) float window_smem[];
  const int group = threadIdx.x / G;
  const int base = threadIdx.x % kWarp / G * G;
  const Group<G> g{static_cast<int>(threadIdx.x % G), base,
                   G == kWarp ? 0xffffffffu : ((1u << G) - 1) << base};
  const int n = blockIdx.x * kPerBlock + group;
  if (n >= N) return;  // a whole group; nothing below syncs another
  const int ld = wide_row(W);
  float* x = window_smem + group * wide_window_floats(W);
  float* xc = x + ld;
  float* part = xc + ld;
  float* feats = out + static_cast<size_t>(n) * kOut;
  load_window(x, src, n, g);
  g.sync();
  stat_time_features_warp<G, R>(x, xc, part, W, g, feats);
  if constexpr (kFreq)
    freq_features_warp(x, xc, part, W, freq, g, feats + kStatFeatures);
}

template <int G, int R, bool kFreq, class Src>
void launch_wide(Src src, float* out, int N, int W, const FreqTables& freq,
                 cudaStream_t stream) {
  constexpr int kPerBlock = kWideWarps * kWarp / G;
  const size_t smem = sizeof(float) * kPerBlock * wide_window_floats(W);
  const auto kernel = window_features_wide_kernel<G, R, kFreq, Src>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  kernel<<<(N + kPerBlock - 1) / kPerBlock, kWideWarps * kWarp, smem,
           stream>>>(src, freq, out, N, W);
}

template <bool kFreq, class Src>
void launch(Src src, float* out, int N, int W, const FreqTables& freq,
            WfVariant variant, cudaStream_t stream) {
  if (variant == kWfWide) {  // G lanes a window, R sort registers a lane
    if (W <= 128)
      launch_wide<8, 16, kFreq>(src, out, N, W, freq, stream);
    else if (W <= 256)
      launch_wide<kWarp, 8, kFreq>(src, out, N, W, freq, stream);
    else if (W <= 512)
      launch_wide<kWarp, 16, kFreq>(src, out, N, W, freq, stream);
    else
      launch_wide<kWarp, 32, kFreq>(src, out, N, W, freq, stream);
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
