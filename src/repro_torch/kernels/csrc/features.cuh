// Window features on the card: the 28 statistical and time-domain features
// (core/features.py::stat_time_features) and the 10 frequency-domain
// features (core/features.py::freq_features), the same f32 ops in the
// same order as the plain versions, in two forms.
//
// * stat_time_features / freq_features: one window per thread at any width
//   (3 to 1,024), the window and the scratch read through pointers: the
//   caller puts them where they fit (local arrays of kMaxWindow up to 64
//   samples, rows of shared memory above). Order statistics come from an
//   insertion sort of the window: the exact order statistics, as the
//   reference's sort and the TPU kernel's rank counting give them. The
//   window_features kernel runs these at widths other than 60, and on the
//   AAPA pre-pass's windows of history_len other than 60.
// * stat_time_features_w60 / freq_features_w60 (below them): one window
//   per thread at 60 samples, the window in registers and no array on the
//   stack. Every loop is unrolled, so each index is a constant: the sums
//   are the same left-to-right sums in XLA's chunk order (xla_sum_c,
//   seq_sum_c), the 30 autocorrelations are unrolled lags, the order
//   statistics come from a sorting network (and, for a window holding NaN,
//   from the insertion sort's own order, insertion_sorted_at) and the real
//   FFT runs the plan for 60 samples. The window_features kernel runs these
//   at W = 60, the classification path's and the AAPA pre-pass's width.
//   Both forms give the same features on every window, NaN included (only
//   the sign of a zero order statistic may differ where a window mixes -0
//   and +0).
#pragma once

#include <type_traits>

#include "kernels.h"
#include "numerics.cuh"

namespace repro_torch {

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

// x [n] (3 <= n <= kMaxWideWindow), xs scratch [n] -> out [28]
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

// ducc0's generic forward pass (radfg) for an odd factor ip > 5
// (core/features.py::_radfg, op for op): C1(a, b, c) = cc[a + ido*(b + l1*c)]
// is rotated in place, the butterflies go to CH2(a, j) = ch[a + idl1*j], the
// result to cc[a + ido*(b + ip*c)], which is then copied to ch. wa holds the
// pass's twiddles [(ip-1) * (ido-1)], then csarr [2 * ip]. Kept out of line:
// no path at the system's 60-sample windows runs it.
static __device__ __noinline__ void radfg(int ip, int l1, int ido,
                                          const float* wa, float* cc,
                                          float* ch) {
  const int ipph = (ip + 1) / 2, idl1 = ido * l1;
  const float* cs = wa + (ip - 1) * (ido - 1);
  auto c1 = [&](int a, int b, int c) { return a + ido * (b + l1 * c); };
  if (ido > 1)
    for (int j = 1; j < ipph; ++j) {  // twiddle j and ip - j
      const int jc = ip - j;
      const int is1 = (j - 1) * (ido - 1), is2 = (jc - 1) * (ido - 1);
      for (int k = 0; k < l1; ++k)
        for (int i = 1; i < ido - 1; i += 2) {
          const float w1r = __ldg(wa + is1 + i - 1), w1i = __ldg(wa + is1 + i);
          const float w2r = __ldg(wa + is2 + i - 1), w2i = __ldg(wa + is2 + i);
          const float t1 = cc[c1(i, k, j)], t2 = cc[c1(i + 1, k, j)];
          const float t3 = cc[c1(i, k, jc)], t4 = cc[c1(i + 1, k, jc)];
          const float x1 = w1r * t1 + w1i * t2, x2 = w1r * t2 - w1i * t1;
          const float x3 = w2r * t3 + w2i * t4, x4 = w2r * t4 - w2i * t3;
          cc[c1(i, k, j)] = x3 + x1;
          cc[c1(i + 1, k, jc)] = x3 - x1;
          cc[c1(i + 1, k, j)] = x2 + x4;
          cc[c1(i, k, jc)] = x2 - x4;
        }
    }
  for (int j = 1; j < ipph; ++j)
    for (int k = 0; k < l1; ++k) {
      const float t1 = cc[c1(0, k, j)], t2 = cc[c1(0, k, ip - j)];
      cc[c1(0, k, j)] = t1 + t2;
      cc[c1(0, k, ip - j)] = t2 - t1;
    }
  for (int l = 1; l < ipph; ++l) {
    const int lc = ip - l;
    const float c2 = __ldg(cs + 2 * l), s2 = __ldg(cs + 2 * l + 1);
    const float c4 = __ldg(cs + 4 * l), s4 = __ldg(cs + 4 * l + 1);
    for (int ik = 0; ik < idl1; ++ik) {
      ch[ik + idl1 * l] = cc[ik] + c2 * cc[ik + idl1] + c4 * cc[ik + 2 * idl1];
      ch[ik + idl1 * lc] =
          s2 * cc[ik + idl1 * (ip - 1)] + s4 * cc[ik + idl1 * (ip - 2)];
    }
    int iang = 2 * l;
    for (int j = 3; j < ipph;) {  // groups of 4, then 2, then 1
      const int g = j < ipph - 3 ? 4 : (j < ipph - 1 ? 2 : 1);
      float ar[4], ai[4];
      for (int t = 0; t < g; ++t) {
        iang += l;
        if (iang > ip) iang -= ip;
        ar[t] = __ldg(cs + 2 * iang);
        ai[t] = __ldg(cs + 2 * iang + 1);
      }
      const int jc = ip - j;
      for (int ik = 0; ik < idl1; ++ik) {
        float re = ar[0] * cc[ik + idl1 * j], im = ai[0] * cc[ik + idl1 * jc];
        for (int t = 1; t < g; ++t) {
          re = re + ar[t] * cc[ik + idl1 * (j + t)];
          im = im + ai[t] * cc[ik + idl1 * (jc - t)];
        }
        ch[ik + idl1 * l] = ch[ik + idl1 * l] + re;
        ch[ik + idl1 * lc] = ch[ik + idl1 * lc] + im;
      }
      j += g;
    }
  }
  for (int ik = 0; ik < idl1; ++ik) {
    float s = cc[ik];
    for (int j = 1; j < ipph; ++j) s = s + cc[ik + idl1 * j];
    ch[ik] = s;
  }
  auto CC = [&](int a, int b, int c) -> float& {
    return cc[a + ido * (b + ip * c)];
  };
  auto CH = [&](int a, int b, int c) { return ch[c1(a, b, c)]; };
  for (int k = 0; k < l1; ++k)
    for (int i = 0; i < ido; ++i) CC(i, 0, k) = CH(i, k, 0);
  for (int j = 1; j < ipph; ++j) {
    const int jc = ip - j, j2 = 2 * j - 1;
    for (int k = 0; k < l1; ++k) {
      CC(ido - 1, j2, k) = CH(0, k, j);
      CC(0, j2 + 1, k) = CH(0, k, jc);
      for (int i = 1; i < ido - 1; i += 2) {
        const int ic = ido - i - 2;
        CC(i, j2 + 1, k) = CH(i, k, j) + CH(i, k, jc);
        CC(ic, j2, k) = CH(i, k, j) - CH(i, k, jc);
        CC(i + 1, j2 + 1, k) = CH(i + 1, k, j) + CH(i + 1, k, jc);
        CC(ic + 1, j2, k) = CH(i + 1, k, jc) - CH(i + 1, k, j);
      }
    }
  }
  for (int q = 0; q < ip * idl1; ++q) ch[q] = cc[q];
}

// One forward pass of ducc0's real FFT (rfftp: radf2, radf3, radf4, radf5,
// radfg above 5) from cc to ch, CC(a, b, c) = cc[a + ido*(b + l1*c)] in and
// CH(a, b, c) = ch[a + ido*(b + ip*c)] out, wa the pass's twiddles
// (core/features.py::_radix_pass, op for op). cc is scratch afterwards.
__device__ inline void radix_pass(int ip, int l1, int ido, const float* wa,
                                  float* cc, float* ch) {
  if (ip > 5) {
    radfg(ip, l1, ido, wa, cc, ch);
    return;
  }
  constexpr float kTaui3 = 0.8660254037844386467637231707529362f;
  constexpr float kHsqt2 = 0.7071067811865475244008443621048490f;
  constexpr float kTr11 = 0.3090169943749474241022934171828191f;
  constexpr float kTi11 = 0.9510565162951535721164393333793821f;
  constexpr float kTr12 = -0.8090169943749474241022934171828191f;
  constexpr float kTi12 = 0.5877852522924731291687059546390728f;
  auto CC = [&](int a, int b, int c) { return cc[a + ido * (b + l1 * c)]; };
  auto CH = [&](int a, int b, int c) -> float& {
    return ch[a + ido * (b + ip * c)];
  };
  // conj(twiddle x at i) * (CC(i-1, k, x+1) + i CC(i, k, x+1))
  auto mulpm = [&](int x, int i, int k, float& re, float& im) {
    const float wr = __ldg(wa + x * (ido - 1) + i - 2);
    const float wi = __ldg(wa + x * (ido - 1) + i - 1);
    const float e = CC(i - 1, k, x + 1), f = CC(i, k, x + 1);
    re = wr * e + wi * f;
    im = wr * f - wi * e;
  };
  if (ip == 2) {
    for (int k = 0; k < l1; ++k) {
      CH(0, 0, k) = CC(0, k, 0) + CC(0, k, 1);
      CH(ido - 1, 1, k) = CC(0, k, 0) - CC(0, k, 1);
    }
    if (ido % 2 == 0)
      for (int k = 0; k < l1; ++k) {
        CH(0, 1, k) = -CC(ido - 1, k, 1);
        CH(ido - 1, 0, k) = CC(ido - 1, k, 0);
      }
    for (int k = 0; k < l1; ++k)
      for (int i = 2; i < ido; i += 2) {
        const int ic = ido - i;
        float tr2, ti2;
        mulpm(0, i, k, tr2, ti2);
        CH(i - 1, 0, k) = CC(i - 1, k, 0) + tr2;
        CH(ic - 1, 1, k) = CC(i - 1, k, 0) - tr2;
        CH(i, 0, k) = ti2 + CC(i, k, 0);
        CH(ic, 1, k) = ti2 - CC(i, k, 0);
      }
  } else if (ip == 3) {
    for (int k = 0; k < l1; ++k) {
      const float cr2 = CC(0, k, 1) + CC(0, k, 2);
      CH(0, 0, k) = CC(0, k, 0) + cr2;
      CH(0, 2, k) = kTaui3 * (CC(0, k, 2) - CC(0, k, 1));
      CH(ido - 1, 1, k) = CC(0, k, 0) + -0.5f * cr2;
    }
    for (int k = 0; k < l1; ++k)
      for (int i = 2; i < ido; i += 2) {
        const int ic = ido - i;
        float dr2, di2, dr3, di3;
        mulpm(0, i, k, dr2, di2);
        mulpm(1, i, k, dr3, di3);
        const float cr2 = dr2 + dr3, ci2 = di2 + di3;
        CH(i - 1, 0, k) = CC(i - 1, k, 0) + cr2;
        CH(i, 0, k) = CC(i, k, 0) + ci2;
        const float tr2 = CC(i - 1, k, 0) + -0.5f * cr2;
        const float ti2 = CC(i, k, 0) + -0.5f * ci2;
        const float tr3 = kTaui3 * (di2 - di3);
        const float ti3 = kTaui3 * (dr3 - dr2);
        CH(i - 1, 2, k) = tr2 + tr3;
        CH(ic - 1, 1, k) = tr2 - tr3;
        CH(i, 2, k) = ti3 + ti2;
        CH(ic, 1, k) = ti3 - ti2;
      }
  } else if (ip == 4) {
    for (int k = 0; k < l1; ++k) {
      const float tr1 = CC(0, k, 3) + CC(0, k, 1);
      CH(0, 2, k) = CC(0, k, 3) - CC(0, k, 1);
      const float tr2 = CC(0, k, 0) + CC(0, k, 2);
      CH(ido - 1, 1, k) = CC(0, k, 0) - CC(0, k, 2);
      CH(0, 0, k) = tr2 + tr1;
      CH(ido - 1, 3, k) = tr2 - tr1;
    }
    if (ido % 2 == 0)
      for (int k = 0; k < l1; ++k) {
        const float ti1 = -kHsqt2 * (CC(ido - 1, k, 1) + CC(ido - 1, k, 3));
        const float tr1 = kHsqt2 * (CC(ido - 1, k, 1) - CC(ido - 1, k, 3));
        CH(ido - 1, 0, k) = CC(ido - 1, k, 0) + tr1;
        CH(ido - 1, 2, k) = CC(ido - 1, k, 0) - tr1;
        CH(0, 3, k) = ti1 + CC(ido - 1, k, 2);
        CH(0, 1, k) = ti1 - CC(ido - 1, k, 2);
      }
    for (int k = 0; k < l1; ++k)
      for (int i = 2; i < ido; i += 2) {
        const int ic = ido - i;
        float cr2, ci2, cr3, ci3, cr4, ci4;
        mulpm(0, i, k, cr2, ci2);
        mulpm(1, i, k, cr3, ci3);
        mulpm(2, i, k, cr4, ci4);
        const float tr1 = cr4 + cr2, tr4 = cr4 - cr2;
        const float ti1 = ci2 + ci4, ti4 = ci2 - ci4;
        const float tr2 = CC(i - 1, k, 0) + cr3, tr3 = CC(i - 1, k, 0) - cr3;
        const float ti2 = CC(i, k, 0) + ci3, ti3 = CC(i, k, 0) - ci3;
        CH(i - 1, 0, k) = tr2 + tr1;
        CH(ic - 1, 3, k) = tr2 - tr1;
        CH(i, 0, k) = ti1 + ti2;
        CH(ic, 3, k) = ti1 - ti2;
        CH(i - 1, 2, k) = tr3 + ti4;
        CH(ic - 1, 1, k) = tr3 - ti4;
        CH(i, 2, k) = tr4 + ti3;
        CH(ic, 1, k) = tr4 - ti3;
      }
  } else {  // ip == 5
    for (int k = 0; k < l1; ++k) {
      const float cr2 = CC(0, k, 4) + CC(0, k, 1), ci5 = CC(0, k, 4) - CC(0, k, 1);
      const float cr3 = CC(0, k, 3) + CC(0, k, 2), ci4 = CC(0, k, 3) - CC(0, k, 2);
      CH(0, 0, k) = CC(0, k, 0) + cr2 + cr3;
      CH(ido - 1, 1, k) = CC(0, k, 0) + kTr11 * cr2 + kTr12 * cr3;
      CH(0, 2, k) = kTi11 * ci5 + kTi12 * ci4;
      CH(ido - 1, 3, k) = CC(0, k, 0) + kTr12 * cr2 + kTr11 * cr3;
      CH(0, 4, k) = kTi12 * ci5 - kTi11 * ci4;
    }
    for (int k = 0; k < l1; ++k)
      for (int i = 2; i < ido; i += 2) {
        const int ic = ido - i;
        float dr2, di2, dr3, di3, dr4, di4, dr5, di5;
        mulpm(0, i, k, dr2, di2);
        mulpm(1, i, k, dr3, di3);
        mulpm(2, i, k, dr4, di4);
        mulpm(3, i, k, dr5, di5);
        const float cr2 = dr5 + dr2, ci5 = dr5 - dr2;
        const float ci2 = di2 + di5, cr5 = di2 - di5;
        const float cr3 = dr4 + dr3, ci4 = dr4 - dr3;
        const float ci3 = di3 + di4, cr4 = di3 - di4;
        CH(i - 1, 0, k) = CC(i - 1, k, 0) + cr2 + cr3;
        CH(i, 0, k) = CC(i, k, 0) + ci2 + ci3;
        const float tr2 = CC(i - 1, k, 0) + kTr11 * cr2 + kTr12 * cr3;
        const float ti2 = CC(i, k, 0) + kTr11 * ci2 + kTr12 * ci3;
        const float tr3 = CC(i - 1, k, 0) + kTr12 * cr2 + kTr11 * cr3;
        const float ti3 = CC(i, k, 0) + kTr12 * ci2 + kTr11 * ci3;
        const float tr5 = cr5 * kTi11 + cr4 * kTi12, tr4 = cr5 * kTi12 - cr4 * kTi11;
        const float ti5 = ci5 * kTi11 + ci4 * kTi12, ti4 = ci5 * kTi12 - ci4 * kTi11;
        CH(i - 1, 2, k) = tr2 + tr5;
        CH(ic - 1, 1, k) = tr2 - tr5;
        CH(i, 2, k) = ti5 + ti2;
        CH(ic, 1, k) = ti5 - ti2;
        CH(i - 1, 4, k) = tr3 + tr4;
        CH(ic - 1, 3, k) = tr3 - tr4;
        CH(i, 4, k) = ti4 + ti3;
        CH(ic, 3, k) = ti4 - ti3;
      }
  }
}

// XLA's CPU complex abs (core/features.py::complex_abs): max * sqrt(fma(r,
// r, 1)) with r = min / max, 0 where both parts are 0
__device__ __forceinline__ float complex_abs(float re, float im) {
  const float a = fabsf(re), b = fabsf(im);
  const float hi = fmaxf(a, b), lo = fminf(a, b);
  const float r = lo / hi;
  const float h = hi * sqrtf(__fmaf_rn(r, r, 1.0f));
  return hi == 0.0f ? 0.0f : h;
}

// x [n] (4 <= n <= kMaxWideWindow), a and b scratch [n] (a may be
// stat_time_features' xs) -> out [10]. The power spectrum |rfft(x -
// mean)|^2 without the DC bin, computed as the reference's jnp.fft.rfft
// (ducc0's radix passes), abs and square run on the CPU
// (core/features.py::power_spectrum); it goes into whichever of a and b
// the last pass did not write.
__device__ inline void freq_features(const float* x, int n, const FreqTables& f,
                                     float* a, float* b, float* out) {
  const int nb = n / 2;
  const float mean = window_mean(x, n);
  for (int j = 0; j < n; ++j) a[j] = x[j] - mean;
  float* p1 = a;
  float* p2 = b;
  for (int q = 0; q < f.n_pass; ++q) {
    radix_pass(f.ip[q], f.l1[q], f.ido[q], f.tw + f.off[q], p1, p2);
    float* t = p1;
    p1 = p2;
    p2 = t;
  }
  float* power = p2;
  for (int k = 1; k <= nb; ++k) {
    const float h = complex_abs(p1[2 * k - 1], 2 * k < n ? p1[2 * k] : 0.0f);
    power[k - 1] = h * h;
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


// ---- one window per thread at a compile-time width, in registers ----

// term(Lo) + ... + term(Hi - 1), left to right, Lo < Hi constants
template <int Lo, int Hi, class Term>
__device__ __forceinline__ float seq_sum_c(Term term) {
  static_assert(Lo < Hi, "empty sum");
  float s = term(Lo);
#pragma unroll
  for (int j = Lo + 1; j < Hi; ++j) s = s + term(j);
  return s;
}

// xla_sum at a compile-time length N (1 <= N <= 64): at most two chunks,
// the first ending 32 - low terms in
template <int N, class Term>
__device__ __forceinline__ float xla_sum_c(Term term) {
  static_assert(N >= 1 && N <= 2 * kXlaWindow, "one or two XLA chunks");
  constexpr int n_win = (N + kXlaWindow - 1) / kXlaWindow;
  constexpr int low = (n_win * kXlaWindow - N) / 2;
  if constexpr (n_win == 1) {
    return seq_sum_c<0, N>(term);
  } else {
    constexpr int cut = kXlaWindow - low;
    return seq_sum_c<0, cut>(term) + seq_sum_c<cut, N>(term);
  }
}

// f(std::integral_constant<int, I>) for I = Lo .. Hi - 1, in order
template <int Lo, int Hi, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (Lo < Hi) {
    f(std::integral_constant<int, Lo>{});
    static_for<Lo + 1, Hi>(f);
  }
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// Batcher's odd-even merge sort of v [N] ascending: the network for the
// next power of two n2 >= N with every comparator that touches an index
// >= N dropped (as if those held +inf, which never move). Each comparator
// is fminf / fmaxf, so for a window without NaN the sorted values are the
// insertion sort's, ties included (only the sign of equal zeros may land
// elsewhere).
template <int N, int LogP, int LogK>
__device__ __forceinline__ void sort_stage(float (&v)[N]) {
  constexpr int n2 = pow2_at_least(N);
  constexpr int p = 1 << LogP, k = 1 << LogK;
#pragma unroll
  for (int j = k % p; j + k < n2; j += 2 * k) {
#pragma unroll
    for (int i = 0; i < k; ++i) {
      const int a = i + j, b = i + j + k;
      if (b < N && a / (2 * p) == b / (2 * p)) {
        const float lo = fminf(v[a], v[b]), hi = fmaxf(v[a], v[b]);
        v[a] = lo;
        v[b] = hi;
      }
    }
  }
}

template <int N, int LogP = 0, int LogK = 0>
__device__ __forceinline__ void sort_network(float (&v)[N]) {
  constexpr int n2 = pow2_at_least(N);
  if constexpr ((1 << LogP) < n2) {
    sort_stage<N, LogP, LogK>(v);
    if constexpr (LogK > 0)
      sort_network<N, LogP, LogK - 1>(v);
    else
      sort_network<N, LogP + 1, LogP + 1>(v);
  }
}

// The value stat_time_features' insertion sort leaves at position r of
// the window x [n] (any memory but the stack) when x holds a NaN: `>`
// never moves a sample past a NaN, so each NaN stays where it is and each
// NaN-free run between them is sorted on its own, stably.
__device__ inline float insertion_sorted_at(const float* x, int n, int r) {
  if (isnan(x[r])) return x[r];
  int s = r, e = r + 1;  // the NaN-free run [s, e) around r
  while (s > 0 && !isnan(x[s - 1])) --s;
  while (e < n && !isnan(x[e])) ++e;
  for (int i = s; i < e; ++i) {
    int rank = s;
    for (int j = s; j < e; ++j)
      rank += (x[j] < x[i]) || (j < i && x[j] == x[i]) ? 1 : 0;
    if (rank == r) return x[i];
  }
  return x[r];
}

// The quantile at Num / Den of a window of N: its two order statistics
// lo, hi and the weight of hi (sorted_quantile's arithmetic)
template <int N, int Num, int Den>
struct QuantileAt {
  static constexpr int lo = Num * (N - 1) / Den;
  static constexpr int hi = lo + 1 < N ? lo + 1 : N - 1;
  static __device__ __forceinline__ float of(float a, float b) {
    const double pos = static_cast<double>(Num) / Den * (N - 1);
    const float w = static_cast<float>(pos) - static_cast<float>(lo);
    return a * (1.0f - w) + b * w;
  }
};

// stat_time_features for a window x [60] in registers; row: the same
// window in shared or global memory, read only when it holds a NaN. out
// [28].
__device__ __forceinline__ void stat_time_features_w60(const float (&x)[kW60],
                                                       const float* row,
                                                       float* out) {
  constexpr int N = kW60;
  // Computed in an order that keeps few copies of the window live: the
  // order statistics and the features of x itself first, then those of
  // the centred window xc.
  const float rn = 1.0f / static_cast<float>(N);
  const float mean = xla_sum_c<N>([&](int j) { return x[j]; }) * rn;
  float xmin = x[0], xmax = x[0];
#pragma unroll
  for (int j = 1; j < N; ++j) {
    xmin = fminf(xmin, x[j]);
    xmax = fmaxf(xmax, x[j]);
  }

  using Q25 = QuantileAt<N, 1, 4>;
  using Q50 = QuantileAt<N, 1, 2>;
  using Q75 = QuantileAt<N, 3, 4>;
  float xs[N];
#pragma unroll
  for (int j = 0; j < N; ++j) xs[j] = x[j];
  sort_network(xs);
  float s25[2] = {xs[Q25::lo], xs[Q25::hi]};
  float s50[2] = {xs[Q50::lo], xs[Q50::hi]};
  float s75[2] = {xs[Q75::lo], xs[Q75::hi]};
  if (mean != mean) {  // a NaN in the window: the insertion sort's order
    s25[0] = insertion_sorted_at(row, N, Q25::lo);
    s25[1] = insertion_sorted_at(row, N, Q25::hi);
    s50[0] = insertion_sorted_at(row, N, Q50::lo);
    s50[1] = insertion_sorted_at(row, N, Q50::hi);
    s75[0] = insertion_sorted_at(row, N, Q75::lo);
    s75[1] = insertion_sorted_at(row, N, Q75::hi);
  }
  const float median = Q50::of(s50[0], s50[1]);
  const float q25 = Q25::of(s25[0], s25[1]);
  const float q75 = Q75::of(s75[0], s75[1]);

  const float var = xla_sum_c<N>([&](int j) {
    const float d = x[j] - mean;
    return d * d;
  }) * rn;
  const float std = sqrtf(var);
  const float thresh = mean + std;
  const float n_peaks = xla_sum_c<N - 2>([&](int j) {
    const float mid = x[j + 1];
    return (mid > x[j] && mid >= x[j + 2] && mid > thresh) ? 1.0f : 0.0f;
  }) * rn;
  const float zero_frac =
      xla_sum_c<N>([&](int j) { return x[j] <= kFeatEps ? 1.0f : 0.0f; }) * rn;
  constexpr int half = N / 2;
  const float hi_mean = xla_sum_c<N - half>([&](int j) { return x[half + j]; }) *
                        (1.0f / static_cast<float>(N - half));
  const float lo_mean = xla_sum_c<half>([&](int j) { return x[j]; }) *
                        (1.0f / static_cast<float>(half));
  float max_ad = 0.0f;
#pragma unroll
  for (int j = 0; j + 1 < N; ++j) max_ad = fmaxf(max_ad, fabsf(x[j + 1] - x[j]));
  const float mean_ad = xla_sum_c<N - 1>([&](int j) {
    return fabsf(x[j + 1] - x[j]);
  }) * (1.0f / static_cast<float>(N - 1));

  float xc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) xc[j] = x[j] - mean;
  const float m3 = xla_sum_c<N>([&](int j) { return xc[j] * (xc[j] * xc[j]); }) * rn;
  const float m4 = xla_sum_c<N>([&](int j) {
    const float d2 = xc[j] * xc[j];
    return d2 * d2;
  }) * rn;

  const float tbar = static_cast<float>((N - 1) / 2.0);
  double tt = 0.0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const double t = static_cast<double>(static_cast<float>(j) - tbar);
    tt += t * t;
  }
  const float tvar = static_cast<float>(tt) * rn;
  const float cov = xla_sum_c<N>([&](int j) {
    return (static_cast<float>(j) - tbar) * xc[j];
  }) * rn;
  const float slope = cov / tvar;

  const float acf_den = static_cast<float>(N) * var + kFeatEps;
  float acf_at[kAcfHi + 1];            // lags 1 .. 30, constant indices
  static_for<1, kAcfHi + 1>([&](auto lag_c) {
    constexpr int lag = decltype(lag_c)::value;
    acf_at[lag] = xla_sum_c<N - lag>([&](int j) {
      return xc[j] * xc[j + lag];
    }) / acf_den;
  });
  float acf_max = acf_at[kAcfLo];
  int acf_arg = 0;
#pragma unroll
  for (int lag = kAcfLo + 1; lag <= kAcfHi; ++lag) {
    if (acf_at[lag] > acf_max) {
      acf_max = acf_at[lag];
      acf_arg = lag - kAcfLo;
    }
  }

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
  out[13] = zero_frac;
  out[14] = xmax - xmin;
  out[15] = slope / (mean + kFeatEps);
  out[16] = (cov * cov) / (tvar * var + kFeatEps);
  out[17] = (hi_mean + kFeatEps) / (lo_mean + kFeatEps);
  out[18] = acf_at[1];
  out[19] = acf_at[2];
  out[20] = acf_at[3];
  out[21] = acf_at[6];
  out[22] = acf_at[12];
  out[23] = acf_max;
  out[24] = static_cast<float>(acf_arg + kAcfLo) * (1.0f / static_cast<float>(kAcfHi));
  out[25] = mean_ad / (mean + kFeatEps);
  out[26] = max_ad / (mean + kFeatEps);
  out[27] = n_peaks;
}

// radix_pass (radf3, radf4, radf5) at a compile-time ip, l1, ido on arrays
// in registers: cc [ip * l1 * ido] in, ch out, wa the pass's twiddles.
template <int IP, int L1, int IDO, int N>
__device__ __forceinline__ void radix_pass_c(const float* wa,
                                             const float (&cc)[N],
                                             float (&ch)[N]) {
  static_assert(IP * L1 * IDO == N && IP >= 3 && IP <= 5,
                "the radices of the plan for 60 samples");
  constexpr float kTaui3 = 0.8660254037844386467637231707529362f;
  constexpr float kHsqt2 = 0.7071067811865475244008443621048490f;
  constexpr float kTr11 = 0.3090169943749474241022934171828191f;
  constexpr float kTi11 = 0.9510565162951535721164393333793821f;
  constexpr float kTr12 = -0.8090169943749474241022934171828191f;
  constexpr float kTi12 = 0.5877852522924731291687059546390728f;
  auto CC = [&](int a, int b, int c) { return cc[a + IDO * (b + L1 * c)]; };
  auto CH = [&](int a, int b, int c) -> float& {
    return ch[a + IDO * (b + IP * c)];
  };
  auto mulpm = [&](int x, int i, int k, float& re, float& im) {
    const float wr = __ldg(wa + x * (IDO - 1) + i - 2);
    const float wi = __ldg(wa + x * (IDO - 1) + i - 1);
    const float e = CC(i - 1, k, x + 1), f = CC(i, k, x + 1);
    re = wr * e + wi * f;
    im = wr * f - wi * e;
  };
  if constexpr (IP == 3) {
#pragma unroll
    for (int k = 0; k < L1; ++k) {
      const float cr2 = CC(0, k, 1) + CC(0, k, 2);
      CH(0, 0, k) = CC(0, k, 0) + cr2;
      CH(0, 2, k) = kTaui3 * (CC(0, k, 2) - CC(0, k, 1));
      CH(IDO - 1, 1, k) = CC(0, k, 0) + -0.5f * cr2;
    }
#pragma unroll
    for (int k = 0; k < L1; ++k) {
#pragma unroll
      for (int i = 2; i < IDO; i += 2) {
        const int ic = IDO - i;
        float dr2, di2, dr3, di3;
        mulpm(0, i, k, dr2, di2);
        mulpm(1, i, k, dr3, di3);
        const float cr2 = dr2 + dr3, ci2 = di2 + di3;
        CH(i - 1, 0, k) = CC(i - 1, k, 0) + cr2;
        CH(i, 0, k) = CC(i, k, 0) + ci2;
        const float tr2 = CC(i - 1, k, 0) + -0.5f * cr2;
        const float ti2 = CC(i, k, 0) + -0.5f * ci2;
        const float tr3 = kTaui3 * (di2 - di3);
        const float ti3 = kTaui3 * (dr3 - dr2);
        CH(i - 1, 2, k) = tr2 + tr3;
        CH(ic - 1, 1, k) = tr2 - tr3;
        CH(i, 2, k) = ti3 + ti2;
        CH(ic, 1, k) = ti3 - ti2;
      }
    }
  } else if constexpr (IP == 4) {
#pragma unroll
    for (int k = 0; k < L1; ++k) {
      const float tr1 = CC(0, k, 3) + CC(0, k, 1);
      CH(0, 2, k) = CC(0, k, 3) - CC(0, k, 1);
      const float tr2 = CC(0, k, 0) + CC(0, k, 2);
      CH(IDO - 1, 1, k) = CC(0, k, 0) - CC(0, k, 2);
      CH(0, 0, k) = tr2 + tr1;
      CH(IDO - 1, 3, k) = tr2 - tr1;
    }
    if constexpr (IDO % 2 == 0) {
#pragma unroll
      for (int k = 0; k < L1; ++k) {
        const float ti1 = -kHsqt2 * (CC(IDO - 1, k, 1) + CC(IDO - 1, k, 3));
        const float tr1 = kHsqt2 * (CC(IDO - 1, k, 1) - CC(IDO - 1, k, 3));
        CH(IDO - 1, 0, k) = CC(IDO - 1, k, 0) + tr1;
        CH(IDO - 1, 2, k) = CC(IDO - 1, k, 0) - tr1;
        CH(0, 3, k) = ti1 + CC(IDO - 1, k, 2);
        CH(0, 1, k) = ti1 - CC(IDO - 1, k, 2);
      }
    }
#pragma unroll
    for (int k = 0; k < L1; ++k) {
#pragma unroll
      for (int i = 2; i < IDO; i += 2) {
        const int ic = IDO - i;
        float cr2, ci2, cr3, ci3, cr4, ci4;
        mulpm(0, i, k, cr2, ci2);
        mulpm(1, i, k, cr3, ci3);
        mulpm(2, i, k, cr4, ci4);
        const float tr1 = cr4 + cr2, tr4 = cr4 - cr2;
        const float ti1 = ci2 + ci4, ti4 = ci2 - ci4;
        const float tr2 = CC(i - 1, k, 0) + cr3, tr3 = CC(i - 1, k, 0) - cr3;
        const float ti2 = CC(i, k, 0) + ci3, ti3 = CC(i, k, 0) - ci3;
        CH(i - 1, 0, k) = tr2 + tr1;
        CH(ic - 1, 3, k) = tr2 - tr1;
        CH(i, 0, k) = ti1 + ti2;
        CH(ic, 3, k) = ti1 - ti2;
        CH(i - 1, 2, k) = tr3 + ti4;
        CH(ic - 1, 1, k) = tr3 - ti4;
        CH(i, 2, k) = tr4 + ti3;
        CH(ic, 1, k) = tr4 - ti3;
      }
    }
  } else {  // IP == 5
#pragma unroll
    for (int k = 0; k < L1; ++k) {
      const float cr2 = CC(0, k, 4) + CC(0, k, 1), ci5 = CC(0, k, 4) - CC(0, k, 1);
      const float cr3 = CC(0, k, 3) + CC(0, k, 2), ci4 = CC(0, k, 3) - CC(0, k, 2);
      CH(0, 0, k) = CC(0, k, 0) + cr2 + cr3;
      CH(IDO - 1, 1, k) = CC(0, k, 0) + kTr11 * cr2 + kTr12 * cr3;
      CH(0, 2, k) = kTi11 * ci5 + kTi12 * ci4;
      CH(IDO - 1, 3, k) = CC(0, k, 0) + kTr12 * cr2 + kTr11 * cr3;
      CH(0, 4, k) = kTi12 * ci5 - kTi11 * ci4;
    }
#pragma unroll
    for (int k = 0; k < L1; ++k) {
#pragma unroll
      for (int i = 2; i < IDO; i += 2) {
        const int ic = IDO - i;
        float dr2, di2, dr3, di3, dr4, di4, dr5, di5;
        mulpm(0, i, k, dr2, di2);
        mulpm(1, i, k, dr3, di3);
        mulpm(2, i, k, dr4, di4);
        mulpm(3, i, k, dr5, di5);
        const float cr2 = dr5 + dr2, ci5 = dr5 - dr2;
        const float ci2 = di2 + di5, cr5 = di2 - di5;
        const float cr3 = dr4 + dr3, ci4 = dr4 - dr3;
        const float ci3 = di3 + di4, cr4 = di3 - di4;
        CH(i - 1, 0, k) = CC(i - 1, k, 0) + cr2 + cr3;
        CH(i, 0, k) = CC(i, k, 0) + ci2 + ci3;
        const float tr2 = CC(i - 1, k, 0) + kTr11 * cr2 + kTr12 * cr3;
        const float ti2 = CC(i, k, 0) + kTr11 * ci2 + kTr12 * ci3;
        const float tr3 = CC(i - 1, k, 0) + kTr12 * cr2 + kTr11 * cr3;
        const float ti3 = CC(i, k, 0) + kTr12 * ci2 + kTr11 * ci3;
        const float tr5 = cr5 * kTi11 + cr4 * kTi12, tr4 = cr5 * kTi12 - cr4 * kTi11;
        const float ti5 = ci5 * kTi11 + ci4 * kTi12, ti4 = ci5 * kTi12 - ci4 * kTi11;
        CH(i - 1, 2, k) = tr2 + tr5;
        CH(ic - 1, 1, k) = tr2 - tr5;
        CH(i, 2, k) = ti5 + ti2;
        CH(ic, 1, k) = ti5 - ti2;
        CH(i - 1, 4, k) = tr3 + tr4;
        CH(ic - 1, 3, k) = tr3 - tr4;
        CH(i, 4, k) = ti4 + ti3;
        CH(ic, 3, k) = ti4 - ti3;
      }
    }
  }
}

// freq_features for a window x [60] in registers, its FFT the plan
// kW60Plan (the binding checks f against it): out [10].
__device__ __forceinline__ void freq_features_w60(const float (&x)[kW60],
                                                  const FreqTables& f,
                                                  float* out) {
  constexpr int n = kW60, nb = n / 2;
  const float mean = xla_sum_c<n>([&](int j) { return x[j]; }) *
                     (1.0f / static_cast<float>(n));
  float a[n], b[n];
#pragma unroll
  for (int j = 0; j < n; ++j) a[j] = x[j] - mean;
  radix_pass_c<kW60Plan[0][0], kW60Plan[0][1], kW60Plan[0][2]>(
      f.tw + f.off[0], a, b);
  radix_pass_c<kW60Plan[1][0], kW60Plan[1][1], kW60Plan[1][2]>(
      f.tw + f.off[1], b, a);
  radix_pass_c<kW60Plan[2][0], kW60Plan[2][1], kW60Plan[2][2]>(
      f.tw + f.off[2], a, b);
  float power[nb];
#pragma unroll
  for (int k = 1; k <= nb; ++k) {
    const float h = complex_abs(b[2 * k - 1], 2 * k < n ? b[2 * k] : 0.0f);
    power[k - 1] = h * h;
  }
  const float psum = seq_sum_c<0, nb>([&](int k) { return power[k]; });
  const float total = psum + kFeatEps;
  float p[nb];
#pragma unroll
  for (int k = 0; k < nb; ++k) p[k] = power[k] / total;

  float top1 = power[0], top2 = -INFINITY;
  int dom = 0;
#pragma unroll
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
  // the first k whose running sum p(0) + ... + p(k) reaches 0.85, else 0
  int roll = 0;
  bool hit = false;
  float cum = p[0];
  hit = cum >= 0.85f;
#pragma unroll
  for (int k = 1; k < nb; ++k) {
    cum = cum + p[k];
    if (!hit && cum >= 0.85f) {
      roll = k;
      hit = true;
    }
  }
  constexpr int b5 = 5 < nb ? 5 : nb, b15 = 15 < nb ? 15 : nb;
  out[0] = -seq_sum_c<0, nb>([&](int k) { return p[k] * rlog(p[k] + kFeatEps); }) *
           f.inv_log_nb;
  out[1] = static_cast<float>(dom) * f.inv_nb;
  out[2] = top1 / total;
  out[3] = (top1 + top2) / total;
  out[4] = seq_sum_c<0, b5>([&](int k) { return power[k]; }) / total;
  out[5] = seq_sum_c<b5, b15>([&](int k) { return power[k]; }) / total;
  out[6] = seq_sum_c<b15, nb>([&](int k) { return power[k]; }) / total;
  out[7] = seq_sum_c<0, nb>([&](int k) { return p[k] * static_cast<float>(k); }) *
           f.inv_nb;
  out[8] = rexp(seq_sum_c<0, nb>([&](int k) { return rlog(power[k] + kFeatEps); }) *
                f.inv_nb) /
           (psum * f.inv_nb + kFeatEps);
  out[9] = static_cast<float>(roll) * f.inv_nb;
}

}  // namespace repro_torch
