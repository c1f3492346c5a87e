// window_features: the 28 statistical and time-domain features of each
// window (core/features.py::stat_time_features, its plain version), and
// on the classification path all 38: those 28 and the 10 frequency
// features (core/features.py::extract_features).
//
// Replaces the Pallas TPU kernel src/repro/kernels/window_features.py
// (window_features_kernel, body _kernel). The TPU kernel found ranks by
// O(W^2) lane rotations because the VPU has no sort; here each thread
// owns one window, copies it to local memory and insertion-sorts a second
// copy, which gives the same order statistics. The feature math is the
// device functions stat_time_features and freq_features (features.cuh),
// which the AAPA episode kernel calls too, so the classification path and
// the episode's reclassification compute the same features. The reference
// computes the 10 frequency features with an XLA rFFT outside its kernel;
// here they are the same real FFT as jnp.fft.rfft on the CPU (ducc0's
// radix passes, twiddles through the read-only cache), which the episode
// kernel runs too.
//
// Bound on the H100: operations. Per 60-sample window the kernel reads
// 240 bytes and writes 112 (152 with the frequency features), against
// ~7,500 f32 operations for the 30 autocorrelations, the moments, the
// sort and the trend (and ~900 more for the FFT), so it sits far above
// the card's operations-per-byte ridge. One thread per window keeps every
// sum in XLA's order without any cross-thread reduction; the loads of a
// warp are strided by the window length.
#include "features.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;

// windows [N, W] -> out [N, 28], or with kFreq out [N, 38]
template <bool kFreq>
__global__ void window_features_kernel(const float* __restrict__ windows,
                                       FreqTables freq,
                                       float* __restrict__ out, int N,
                                       int W) {
  constexpr int kOut = kFreq ? kFeatures : kStatFeatures;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float x[kMaxWindow], xs[kMaxWindow], feats[kOut];
  const float* row = windows + static_cast<size_t>(i) * W;
  for (int j = 0; j < W; ++j) x[j] = row[j];
  stat_time_features(x, xs, W, feats);
  if constexpr (kFreq) freq_features(x, W, freq, feats + kStatFeatures);
  float* o = out + static_cast<size_t>(i) * kOut;
  for (int k = 0; k < kOut; ++k) o[k] = feats[k];
}

}  // namespace

void window_features_launch(const float* windows, float* out, int N, int W,
                            const FreqTables* freq, cudaStream_t stream) {
  const int grid = (N + kThreads - 1) / kThreads;
  if (freq == nullptr) {
    window_features_kernel<false><<<grid, kThreads, 0, stream>>>(
        windows, FreqTables{}, out, N, W);
  } else {
    window_features_kernel<true><<<grid, kThreads, 0, stream>>>(
        windows, *freq, out, N, W);
  }
}

}  // namespace repro_torch
