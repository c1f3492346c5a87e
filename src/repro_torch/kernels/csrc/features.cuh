// Window features on the card, one window per thread: the 28 statistical
// and time-domain features (core/features.py::stat_time_features) and the
// 10 frequency-domain features (core/features.py::freq_features), the
// same f32 ops in the same order as the plain versions. Shared by the
// standalone window_features kernel and the AAPA episode kernel.
//
// Order statistics come from an insertion sort of the window in local
// memory: the exact order statistics, as the reference's sort and the TPU
// kernel's rank counting give them.
#pragma once

#include "kernels.h"
#include "numerics.cuh"

namespace repro_torch {

constexpr int kMaxWindow = 64;
constexpr int kStatFeatures = 28;
constexpr int kFreqFeatures = 10;
constexpr int kFeatures = kStatFeatures + kFreqFeatures;
constexpr float kFeatEps = 1e-6f;
constexpr int kAcfLo = 2, kAcfHi = 30;

__device__ __forceinline__ float window_mean(const float* x, int n) {
  return xla_sum(n, [&](int j) { return x[j]; }) * (1.0f / static_cast<float>(n));
}

// Linear-interpolated quantile of the sorted window xs at q
// (core/features.py::quantile_weights).
__device__ __forceinline__ float sorted_quantile(const float* xs, int n,
                                                 double q) {
  const double pos = q * (n - 1);
  const int lo = static_cast<int>(floor(pos));
  const int hi = min(lo + 1, n - 1);
  const float w = static_cast<float>(pos) - static_cast<float>(lo);
  return xs[lo] * (1.0f - w) + xs[hi] * w;
}

// x [n] (3 <= n <= kMaxWindow), xs scratch [n] -> out [28]
__device__ inline void stat_time_features(const float* x, float* xs, int n,
                                   float* out) {
  const float rn = 1.0f / static_cast<float>(n);
  const float mean = window_mean(x, n);
  const float var = xla_sum(n, [&](int j) {
    const float d = x[j] - mean;
    return d * d;
  }) * rn;
  const float std = sqrtf(var);
  float xmin = x[0], xmax = x[0];
  for (int j = 1; j < n; ++j) {
    xmin = fminf(xmin, x[j]);
    xmax = fmaxf(xmax, x[j]);
  }

  for (int i = 0; i < n; ++i) {           // insertion sort
    const float v = x[i];
    int j = i;
    for (; j > 0 && xs[j - 1] > v; --j) xs[j] = xs[j - 1];
    xs[j] = v;
  }
  const float median = sorted_quantile(xs, n, 0.5);
  const float q25 = sorted_quantile(xs, n, 0.25);
  const float q75 = sorted_quantile(xs, n, 0.75);

  const float m3 = xla_sum(n, [&](int j) {
    const float d = x[j] - mean;
    return d * (d * d);
  }) * rn;
  const float m4 = xla_sum(n, [&](int j) {
    const float d = x[j] - mean;
    const float d2 = d * d;
    return d2 * d2;
  }) * rn;

  // OLS trend vs t, t centred on tbar; tvar is an exact f32 sum times 1/n
  const float tbar = static_cast<float>((n - 1) / 2.0);
  double tt = 0.0;
  for (int j = 0; j < n; ++j) {
    const double t = static_cast<double>(static_cast<float>(j) - tbar);
    tt += t * t;
  }
  const float tvar = static_cast<float>(tt) * rn;
  const float cov = xla_sum(n, [&](int j) {
    return (static_cast<float>(j) - tbar) * (x[j] - mean);
  }) * rn;
  const float slope = cov / tvar;
  const int half = n / 2;
  const float hi_mean = xla_sum(n - half, [&](int j) { return x[half + j]; }) *
                        (1.0f / static_cast<float>(n - half));
  const float lo_mean = xla_sum(half, [&](int j) { return x[j]; }) *
                        (1.0f / static_cast<float>(half));

  const float acf_den = static_cast<float>(n) * var + kFeatEps;
  auto acf = [&](int lag) {
    return xla_sum(n - lag, [&](int j) {
      return (x[j] - mean) * (x[j + lag] - mean);
    }) / acf_den;
  };
  float acf_max = acf(kAcfLo);
  int acf_arg = 0;
  for (int lag = kAcfLo + 1; lag <= kAcfHi; ++lag) {
    const float a = acf(lag);
    if (a > acf_max) {
      acf_max = a;
      acf_arg = lag - kAcfLo;
    }
  }

  float max_ad = 0.0f;
  for (int j = 0; j + 1 < n; ++j) max_ad = fmaxf(max_ad, fabsf(x[j + 1] - x[j]));
  const float mean_ad = xla_sum(n - 1, [&](int j) {
    return fabsf(x[j + 1] - x[j]);
  }) * (1.0f / static_cast<float>(n - 1));

  const float thresh = mean + std;
  const float n_peaks = xla_sum(n - 2, [&](int j) {
    const float mid = x[j + 1];
    return (mid > x[j] && mid >= x[j + 2] && mid > thresh) ? 1.0f : 0.0f;
  }) * rn;

  out[0] = mean;
  out[1] = std;
  out[2] = std / (mean + kFeatEps);
  out[3] = xmin;
  out[4] = xmax;
  out[5] = median;
  out[6] = q25;
  out[7] = q75;
  out[8] = q75 - q25;
  out[9] = m3 / (rpow(var, 1.5) + kFeatEps);
  out[10] = m4 / (var * var + kFeatEps) - 3.0f;
  out[11] = xmax / (median + kFeatEps);
  out[12] = xmax / (mean + kFeatEps);
  out[13] = xla_sum(n, [&](int j) { return x[j] <= kFeatEps ? 1.0f : 0.0f; }) * rn;
  out[14] = xmax - xmin;
  out[15] = slope / (mean + kFeatEps);
  out[16] = (cov * cov) / (tvar * var + kFeatEps);
  out[17] = (hi_mean + kFeatEps) / (lo_mean + kFeatEps);
  out[18] = acf(1);
  out[19] = acf(2);
  out[20] = acf(3);
  out[21] = acf(6);
  out[22] = acf(12);
  out[23] = acf_max;
  out[24] = static_cast<float>(acf_arg + kAcfLo) * (1.0f / static_cast<float>(kAcfHi));
  out[25] = mean_ad / (mean + kFeatEps);
  out[26] = max_ad / (mean + kFeatEps);
  out[27] = n_peaks;
}

// x [n] (4 <= n <= kMaxWindow) -> out [10]. The power spectrum of the
// mean-removed window, without the DC bin, from the f32 DFT table; each
// bin summed left to right over time.
__device__ inline void freq_features(const float* x, int n, const FreqTables& f,
                              float* out) {
  const int nb = n / 2, nf = nb + 1;
  const float mean = window_mean(x, n);
  float power[kMaxWindow / 2];
  for (int k = 1; k <= nb; ++k) {
    const float* cs = f.dft + static_cast<size_t>(k) * n;
    const float* sn = f.dft + static_cast<size_t>(nf + k) * n;
    const float x0 = x[0] - mean;
    float re = x0 * __ldg(cs), im = x0 * __ldg(sn);
    for (int j = 1; j < n; ++j) {
      const float xc = x[j] - mean;
      re = re + xc * __ldg(cs + j);
      im = im + xc * __ldg(sn + j);
    }
    power[k - 1] = re * re + im * im;
  }
  const float psum = seq_sum(0, nb, [&](int k) { return power[k]; });
  const float total = psum + kFeatEps;
  auto p = [&](int k) { return power[k] / total; };

  float top1 = power[0], top2 = -INFINITY;
  int dom = 0;
  for (int k = 1; k < nb; ++k) {
    const float v = power[k];
    if (v > top1) {
      top2 = top1;
      top1 = v;
      dom = k;
    } else if (v > top2) {
      top2 = v;
    }
  }
  int roll = 0;
  float cum = p(0);
  if (!(cum >= 0.85f)) {
    for (int k = 1; k < nb; ++k) {
      cum = cum + p(k);
      if (cum >= 0.85f) {
        roll = k;
        break;
      }
    }
  }
  const int b5 = min(5, nb), b15 = min(15, nb);
  out[0] = -seq_sum(0, nb, [&](int k) { return p(k) * rlog(p(k) + kFeatEps); }) *
           f.inv_log_nb;
  out[1] = static_cast<float>(dom) * f.inv_nb;
  out[2] = top1 / total;
  out[3] = (top1 + top2) / total;
  out[4] = seq_sum(0, b5, [&](int k) { return power[k]; }) / total;
  out[5] = seq_sum(b5, b15, [&](int k) { return power[k]; }) / total;
  out[6] = seq_sum(b15, nb, [&](int k) { return power[k]; }) / total;
  out[7] = seq_sum(0, nb, [&](int k) { return p(k) * static_cast<float>(k); }) *
           f.inv_nb;
  out[8] = rexp(seq_sum(0, nb, [&](int k) { return rlog(power[k] + kFeatEps); }) *
                f.inv_nb) /
           (psum * f.inv_nb + kFeatEps);
  out[9] = static_cast<float>(roll) * f.inv_nb;
}

}  // namespace repro_torch
