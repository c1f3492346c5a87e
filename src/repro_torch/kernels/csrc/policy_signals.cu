// policy_signals: the pre-pass of the predictive, AAPA and hybrid
// episodes. Everything a policy's minute hook gives decide, for every lane
// and minute, from the rates and the hyperparameters alone.
//
// Part of the port of the Pallas TPU kernel src/repro/kernels/episode_block.py
// (episode_minutes), whose minute body ran the hook inline; this file holds
// the hook, episode_block.cu the plant. Plain version:
// repro_torch/kernels/ref.py::policy_signals_ref.
//
// Why a pre-pass. cluster._finish_minute hands on_minute the last
// history_len input rates; nothing of the plant reaches the hook. So the
// forecaster's update and peak forecast, AAPA's 30-minute trend and
// 15-minute mean, its reclassification (38 features, the GBDT, the
// calibration), the interval confidence and Algorithm 1 are functions of
// the rates, and need not run on the plant's sequential chain, one thread
// per lane, with their registers and local arrays held through every
// tick. Here:
//   * reclassify_launch runs every reclassification as an independent
//     window of history_len (W) minutes, on the kernels of the
//     classification path: window_features' kernel chosen by W (the
//     register routines at 60, the generic ones up to 64, the wide ones in
//     shared memory above) reading each window in place from `rates`
//     with the zero history before minute 0 that cluster.initial_state
//     gives, 3.6 M windows a 25,000-lane day; gbdt_tables' kernel on their
//     38 features (the node tables in shared memory where they fit); and
//     calibrate_kernel, the softmax, beta calibration and argmax, one
//     window a thread. The features and logits pass through device memory
//     (152 + 16 B a window): each step is a kernel redesigned for the
//     card, and the trees' tables and a feature tile cannot share a
//     block's shared memory with a window's scratch.
//   * aapa_minutes_kernel and predictive_minutes_kernel walk each lane's
//     minutes, one thread per lane: the forecaster is a recurrence
//     (forecasters.cuh: Holt-Winters, linear trend, seasonal naive or
//     EWMA, a template parameter of the walk; state indexed at run time in
//     [slot, B] scratch, as holt_winters.cu keeps its season), the trend
//     and mean read the last 30 rates from a register window (history_len
//     >= 30, so they do not depend on it). AAPA's walk turns each
//     classification into the Algorithm 1 parameters with the forecast's
//     interval confidence.
//   * minute_arch_kernel spreads the slots' archetypes over minutes for
//     the archetype output, one thread per (lane, minute), coalesced.
// The outputs are laid out [minute or slot, lane]: the minute walks and
// the plant pass read and write one minute of a warp's lanes at a time.
//
// The arithmetic is the device functions the episode kernel ran inline
// before (features.cuh, gbdt_tables.cu, forecasters.cuh,
// numerics.cuh::xla_sum), in the same order, under the same -fmad=false
// build: the signals are bit for bit those the plain minute hooks compute.
//
// Bound on the H100: operations. Per reclassification ~11,000 operations
// of features, trees and calibration against 240 bytes of window; per
// lane-minute ~250 operations of forecaster, trend and mean against 4
// bytes in and 12 out. The classification is parallel over 3.6 M windows a
// 25,000-lane day; the minute walks are latency-bound at one thread per
// lane, as the plant pass is.
#include "features.cuh"
#include "forecasters.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kTrendWindow = 30, kMeanWindow = 15;
constexpr float kOneMinusEps = 0.999999f;  // calibration's 1 - EPS clip

__device__ __forceinline__ float select4(int idx, const float* v) {
  return idx == 0 ? v[0] : (idx == 1 ? v[1] : (idx == 2 ? v[2] : v[3]));
}

// core/gbdt.py::softmax, core/calibration.py::calibrate and the argmax
// of core/pipeline.py::Classify on logits [N, 4] -> the archetype and its
// confidence, cls_arch, cls_conf [N], one window a thread.
__global__ void calibrate_kernel(const float* __restrict__ logits,
                                 int* __restrict__ cls_arch,
                                 float* __restrict__ cls_conf, int N,
                                 CalCoeffs cal) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float* lg = logits + static_cast<size_t>(n) * 4;
  const float l[4] = {lg[0], lg[1], lg[2], lg[3]};
  const float lmax = fmaxf(fmaxf(l[0], l[1]), fmaxf(l[2], l[3]));
  float u[4], q[4];
  for (int k = 0; k < 4; ++k) u[k] = rexp(l[k] - lmax);
  const float usum = ((u[0] + u[1]) + u[2]) + u[3];
  for (int k = 0; k < 4; ++k) {
    const float p = fminf(fmaxf(u[k] / usum, kFeatEps), kOneMinusEps);
    const float z = __ldg(cal.a + k) * rlog(p) -
                    __ldg(cal.b + k) * rlog1p(-p) + __ldg(cal.c + k);
    q[k] = 1.0f / (1.0f + rexp(-z));
  }
  const float qsum = ((q[0] + q[1]) + q[2]) + q[3] + kFeatEps;
  int arch = 0;
  float conf = q[0] / qsum;
  for (int k = 1; k < 4; ++k) {
    const float ck = q[k] / qsum;
    if (ck > conf) {
      conf = ck;
      arch = k;
    }
  }
  cls_arch[n] = arch;
  cls_conf[n] = conf;
}

// scaling/policies.py::aapa_controller's on_minute and aapa_rate_signals,
// minute by minute for one lane per thread, with forecaster Fc.
template <class Fc>
__global__ void aapa_minutes_kernel(const float* __restrict__ rates,
                                    const int* __restrict__ cls_arch,
                                    const float* __restrict__ cls_conf,
                                    float* __restrict__ rps,
                                    int* __restrict__ slot_arch,
                                    float* __restrict__ adj,
                                    float* __restrict__ scratch, int B, int M,
                                    int R, AAPAHyper h) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  const size_t plane = sB * M, rplane = sB * R;
  Fc fc;
  fc.init(scratch + b, h.fc, B);
  float win[kTrendWindow];  // the last 30 rates, oldest first
#pragma unroll
  for (int j = 0; j < kTrendWindow; ++j) win[j] = 0.0f;

  // minute 0 reads the initial state: an all-zero history, STATIONARY at
  // confidence 0.5 with Table III's defaults
  rps[b] = rps[plane + b] = rps[2 * plane + b] = 0.0f;
  slot_arch[b] = 2;
  adj[b] = 0.5f;
  adj[rplane + b] = 5.0f;
  adj[2 * rplane + b] = 1.0f;

  const float* row = rates + static_cast<size_t>(b) * M;
  for (int m = 0; m < M; ++m) {
    // cluster._finish_minute: the minute's rate enters the history
    const float rate = row[m];
#pragma unroll
    for (int j = 0; j < kTrendWindow - 1; ++j) win[j] = win[j + 1];
    win[kTrendWindow - 1] = rate;

    // the forecaster observes the newest history entry
    fc.update(h.fc, rate, B);
    const float point = fmaxf(fc.point(h.fc, h.horizon_min, B), 0.0f);

    const int minute_idx = m + 1;
    if (minute_idx % h.stride_min == 0) {
      const size_t r = static_cast<size_t>(minute_idx / h.stride_min);
      int arch = 2;  // scaling/registry.py::default_classify
      float conf = 0.5f;
      if (h.classify) {
        const size_t at = b * static_cast<size_t>(R - 1) + r - 1;
        arch = cls_arch[at];
        conf = cls_conf[at];
      }
      if (h.forecast_confidence) {  // forecast/api.py interval_confidence
        const float half = h.use_band ? h.band_q * h.sqrt_h
                                      : (h.z * fc.resid) * h.sqrt_h;
        const float lo = fmaxf(point - half, 0.0f);
        const float hi = point + half;
        const float width = fmaxf(hi - lo, 0.0f);
        const float sc = fmaxf(h.use_scale ? h.band_scale : point, 1.0f);
        conf = conf * (sc / (sc + width));
      }
      // core/uncertainty.py::adjust on the Table III row
      const float c = fminf(fmaxf(conf, 0.0f), 1.0f);
      const float mult = 1.0f + 0.5f * (1.0f - c);
      const size_t at = r * sB + b;
      slot_arch[at] = arch;
      adj[at] = select4(arch, h.target_cpu) * (1.0f - 0.2f * (1.0f - c));
      adj[rplane + at] = select4(arch, h.cooldown_min) * mult;
      adj[2 * rplane + at] = ceilf(select4(arch, h.min_replicas) * mult);
    }
    if (minute_idx == M) break;  // no minute reads the last hook's signals

    // what decide reads during the next minute, per second
    const size_t at = static_cast<size_t>(minute_idx) * sB + b;
    rps[at] = fmaxf(point, 0.0f) * kInv60;
    const float tmean = xla_sum(kTrendWindow, [&](int j) { return win[j]; }) *
                        (1.0f / static_cast<float>(kTrendWindow));
    const float cov = xla_sum(kTrendWindow, [&](int j) {
      return (static_cast<float>(j) - h.trend_tbar) * (win[j] - tmean);
    }) * (1.0f / static_cast<float>(kTrendWindow));
    const float slope = fdiv(cov, h.trend_tvar);
    rps[plane + at] = fmaxf(tmean + slope * h.trend_step, 0.0f) * kInv60;
    constexpr int m0 = kTrendWindow - kMeanWindow;
    rps[2 * plane + at] =
        xla_sum(kMeanWindow, [&](int j) { return win[m0 + j]; }) *
        (1.0f / static_cast<float>(kMeanWindow)) * kInv60;
  }
}

// scaling/policies.py::predictive_need: the replicas the horizon's
// forecast needs (per second of the minute)
template <class Fc>
__device__ __forceinline__ float forecast_need(const Fc& fc,
                                               const PredictiveHyper& h,
                                               int B) {
  float pred = fmaxf(fc.point(h.fc, h.horizon_min, B), 0.0f);
  if (h.conservative)
    pred = pred + (h.use_band ? h.band_q * h.sqrt_h
                              : (h.z * fc.resid) * h.sqrt_h);
  return (fmaxf(pred, 0.0f) * kInv60) * h.inv_cap;
}

// The predictive policy's forecaster Fc, minute by minute for one lane per
// thread: need [M, B], minute 0 from the forecaster's init.
template <class Fc>
__global__ void predictive_minutes_kernel(const float* __restrict__ rates,
                                          float* __restrict__ need,
                                          float* __restrict__ scratch, int B,
                                          int M, PredictiveHyper h) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Fc fc;
  fc.init(scratch + b, h.fc, B);
  need[b] = forecast_need(fc, h, B);
  const float* row = rates + static_cast<size_t>(b) * M;
  for (int m = 1; m < M; ++m) {
    fc.update(h.fc, row[m - 1], B);
    need[static_cast<size_t>(m) * B + b] = forecast_need(fc, h, B);
  }
}

// The archetype each lane carries after minute m, the slot of minute
// m + 1: arch [R, B] -> minute_arch [B, M].
__global__ void minute_arch_kernel(const int* __restrict__ arch,
                                   int* __restrict__ minute_arch, int B,
                                   int M, int stride) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(B) * M) return;
  const size_t b = i / M;
  const int m = static_cast<int>(i % M);
  minute_arch[i] = arch[static_cast<size_t>((m + 1) / stride) * B + b];
}

int blocks(size_t n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

template <class Fc>
void aapa_walk(const float* rates, const int* cls_arch, const float* cls_conf,
               float* rps, int* arch, float* adj, float* scratch, int B,
               int M, int R, const AAPAHyper& h, cudaStream_t stream) {
  aapa_minutes_kernel<Fc><<<blocks(B), kThreads, 0, stream>>>(
      rates, cls_arch, cls_conf, rps, arch, adj, scratch, B, M, R, h);
}

template <class Fc>
void predictive_walk(const float* rates, float* need, float* scratch, int B,
                     int M, const PredictiveHyper& h, cudaStream_t stream) {
  predictive_minutes_kernel<Fc><<<blocks(B), kThreads, 0, stream>>>(
      rates, need, scratch, B, M, h);
}

}  // namespace

void reclassify_launch(const float* rates, float* feats, float* logits,
                       int* cls_arch, float* cls_conf, int B, int M, int R,
                       int stride, int W, const FreqTables& freq,
                       WfVariant variant, const GBDTTables& gbdt,
                       bool gbdt_shared, CalCoeffs cal, cudaStream_t stream) {
  const int N = B * (R - 1);
  window_features_slots_launch(rates, feats, B, M, R, stride, W, freq,
                               variant, stream);
  gbdt_tables_launch(feats, logits, N, gbdt, gbdt_shared, stream);
  calibrate_kernel<<<blocks(N), kThreads, 0, stream>>>(logits, cls_arch,
                                                       cls_conf, N, cal);
}

void policy_signals_aapa_launch(const float* rates, float* rps, int* arch,
                                float* adj, int* minute_arch,
                                const int* cls_arch, const float* cls_conf,
                                float* scratch, int B, int M,
                                AAPAHyper hyper, cudaStream_t stream) {
  const int R = M / hyper.stride_min + 1;
  // the walk's instantiation for the forecaster's kind
  const auto walk = hyper.fc.kind == kLinearTrend ? aapa_walk<LinearTrendFc>
                    : hyper.fc.kind == kSeasonalNaive
                        ? aapa_walk<SeasonalNaiveFc>
                    : hyper.fc.kind == kEwma ? aapa_walk<EwmaFc>
                                             : aapa_walk<HoltWintersFc>;
  walk(rates, cls_arch, cls_conf, rps, arch, adj, scratch, B, M, R, hyper,
       stream);
  if (minute_arch)
    minute_arch_kernel<<<blocks(static_cast<size_t>(B) * M), kThreads, 0,
                         stream>>>(arch, minute_arch, B, M,
                                   hyper.stride_min);
}

void policy_signals_predictive_launch(const float* rates, float* need,
                                      float* scratch, int B, int M,
                                      PredictiveHyper hyper,
                                      cudaStream_t stream) {
  const auto walk =
      hyper.fc.kind == kLinearTrend     ? predictive_walk<LinearTrendFc>
      : hyper.fc.kind == kSeasonalNaive ? predictive_walk<SeasonalNaiveFc>
      : hyper.fc.kind == kEwma          ? predictive_walk<EwmaFc>
                                        : predictive_walk<HoltWintersFc>;
  walk(rates, need, scratch, B, M, hyper, stream);
}

}  // namespace repro_torch
