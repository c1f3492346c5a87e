// Window features on the card: the 28 statistical and time-domain features
// (core/features.py::stat_time_features) and the 10 frequency-domain
// features (core/features.py::freq_features), the same f32 ops in the
// same order as the plain versions, in three forms.
//
// * stat_time_features / freq_features: one window per thread at up to 64
//   samples, the window and the scratch read through pointers (local
//   arrays of kMaxWindow). Order statistics come from an insertion sort of
//   the window: the exact order statistics, as the reference's sort and
//   the TPU kernel's rank counting give them. The window_features kernel's
//   generic variant runs these at widths other than 60 up to 64, and the
//   AAPA pre-pass's windows of such a history_len.
// * stat_time_features_w60 / freq_features_w60 (below them): one window
//   per thread at 60 samples, the window in registers and no array on the
//   stack. Every loop is unrolled, so each index is a constant: the sums
//   are the same left-to-right sums in XLA's chunk order (xla_sum_c,
//   seq_sum_c), the 30 autocorrelations are unrolled lags, the order
//   statistics come from a sorting network (and, for a window holding NaN,
//   from the insertion sort's own order, insertion_sorted_at) and the real
//   FFT runs the plan for 60 samples. The window_features kernel runs these
//   at W = 60, the classification path's and the AAPA pre-pass's width.
// * stat_time_features_warp / freq_features_warp (at the end): one window
//   per group of G lanes (8 or 32) at any width up to 1,024 (the wide
//   variant). The work is bound by operations, and a thread's W-term
//   chains leave a warp's lanes idle, so the lanes split it without
//   changing a bit: each XLA chunk of each sum is one lane's left-to-right
//   chain (a sum has at most 32 chunks of 32 terms), one lane a sum adds
//   the chunk totals in order; a bitonic sort in registers replaces the
//   O(W^2) insertion sort (a window holding NaN counts each sample's place
//   in the insertion sort's result instead); each radix pass spreads its
//   butterflies over the lanes (radix_pass with a Group), every output
//   computed op for op.
// All forms give the same features on every window, NaN included (only
// the sign of a zero order statistic may differ where a window mixes -0
// and +0).
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

// How a routine spreads iterations that write disjoint outputs: Serial
// runs them in order on the calling thread (the generic kernel); a Group
// over the G lanes of a warp that share one window, lane l taking l,
// l + G, ... (the wide kernel), with a sync where the routine reads what
// others wrote.
struct Serial {
  static constexpr int kLanes = 1;
  __device__ __forceinline__ int lane() const { return 0; }
  __device__ __forceinline__ void sync() const {}
};

// G lanes of a warp (8 or 32), lanes base .. base + G - 1, as one unit:
// its syncs, shuffles and reductions name only its own lanes, so the
// warp's groups run independently.
template <int G>
struct Group {
  static constexpr int kLanes = G;
  int l;          // the lane within the group
  int base;       // the group's first lane in the warp
  unsigned mask;  // the group's lanes
  __device__ __forceinline__ int lane() const { return l; }
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
  template <class T>
  __device__ __forceinline__ T shfl(T v, int src) const {
    return __shfl_sync(mask, v, src, G);
  }
  template <class T>
  __device__ __forceinline__ T shfl_xor(T v, int m) const {
    return __shfl_xor_sync(mask, v, m, G);
  }
  template <class T>
  __device__ __forceinline__ T shfl_down(T v, int d) const {
    return __shfl_down_sync(mask, v, d, G);
  }
  __device__ __forceinline__ int sum(int v) const {
    return static_cast<int>(__reduce_add_sync(mask, static_cast<unsigned>(v)));
  }
  // bit l: p on the group's lane l
  __device__ __forceinline__ unsigned ballot(bool p) const {
    return __ballot_sync(mask, p) >> base;
  }
};

// f(i) for i in [0, n)
template <class Par, class F>
__device__ __forceinline__ void each(const Par& par, int n, F f) {
  for (int i = par.lane(); i < n; i += Par::kLanes) f(i);
}

// q / m and q % m for 0 <= q < 2^20, 1 <= m < 2^10: the f32 quotient,
// corrected by one either way (cheaper than the integer division)
__device__ __forceinline__ void divmod_small(int q, int m, int* k, int* i) {
  int d = static_cast<int>(static_cast<float>(q) *
                           __frcp_rn(static_cast<float>(m)));
  int r = q - d * m;
  if (r < 0) {
    --d;
    r += m;
  } else if (r >= m) {
    ++d;
    r -= m;
  }
  *k = d;
  *i = r;
}

// f(k, i) for k in [0, n), i in [0, m): nested loops on one thread, the
// flattened pairs across a warp's lanes
template <class Par, class F>
__device__ __forceinline__ void each2(const Par& par, int n, int m, F f) {
  if constexpr (Par::kLanes == 1) {
    for (int k = 0; k < n; ++k)
      for (int i = 0; i < m; ++i) f(k, i);
  } else if (m > 0) {  // (k, i) steps by (dk, di) from the lane's pair
    int dk, di, k, i;
    divmod_small(Par::kLanes, m, &dk, &di);
    divmod_small(par.lane(), m, &k, &i);
    for (; k < n; k += dk, i += di) {
      if (i >= m) {
        i -= m;
        ++k;
        if (k >= n) break;
      }
      f(k, i);
    }
  }
}

// ducc0's generic forward pass (radfg) for an odd factor ip > 5
// (core/features.py::_radfg, op for op): C1(a, b, c) = cc[a + ido*(b + l1*c)]
// is rotated in place, the butterflies go to CH2(a, j) = ch[a + idl1*j], the
// result to cc[a + ido*(b + ip*c)], which is then copied to ch. wa holds the
// pass's twiddles [(ip-1) * (ido-1)], then csarr [2 * ip]. Each output is
// one iteration, its sums in the plain version's order; a phase reads what
// the one before wrote only after par.sync(). Kept out of line for one
// thread: no path at the system's 60-sample windows runs it.
template <class Par>
__device__ __forceinline__ void radfg_body(const Par& par, int ip, int l1,
                                           int ido, const float* wa,
                                           float* cc, float* ch) {
  const int ipph = (ip + 1) / 2, idl1 = ido * l1;
  const float* cs = wa + (ip - 1) * (ido - 1);
  auto c1 = [&](int a, int b, int c) { return a + ido * (b + l1 * c); };
  if (ido > 1) {
    each2(par, (ipph - 1) * l1, (ido - 1) / 2, [&](int jk, int ii) {
      const int j = 1 + jk / l1, k = jk % l1, i = 1 + 2 * ii;
      const int jc = ip - j;  // twiddle j and ip - j
      const int is1 = (j - 1) * (ido - 1), is2 = (jc - 1) * (ido - 1);
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
    });
    par.sync();
  }
  each2(par, ipph - 1, l1, [&](int jm, int k) {
    const int j = jm + 1;
    const float t1 = cc[c1(0, k, j)], t2 = cc[c1(0, k, ip - j)];
    cc[c1(0, k, j)] = t1 + t2;
    cc[c1(0, k, ip - j)] = t2 - t1;
  });
  par.sync();
  // ch[ik + idl1 * l] and ch[ik + idl1 * (ip - l)]: the first two terms,
  // then the rest in groups of 4, then 2, then 1 (a group's size is a
  // constant, so its twiddles stay in registers)
  each2(par, ipph - 1, idl1, [&](int lm, int ik) {
    const int l = lm + 1, lc = ip - l;
    const float c2 = __ldg(cs + 2 * l), s2 = __ldg(cs + 2 * l + 1);
    const float c4 = __ldg(cs + 4 * l), s4 = __ldg(cs + 4 * l + 1);
    float acc_re = cc[ik] + c2 * cc[ik + idl1] + c4 * cc[ik + 2 * idl1];
    float acc_im = s2 * cc[ik + idl1 * (ip - 1)] + s4 * cc[ik + idl1 * (ip - 2)];
    int iang = 2 * l;
    auto next = [&](float& ar, float& ai) {
      iang += l;
      if (iang > ip) iang -= ip;
      ar = __ldg(cs + 2 * iang);
      ai = __ldg(cs + 2 * iang + 1);
    };
    auto group = [&](int j, auto g_c) {  // the group's twiddles first
      constexpr int G = decltype(g_c)::value;
      const int jc = ip - j;
      float ar[G], ai[G];
#pragma unroll
      for (int t = 0; t < G; ++t) next(ar[t], ai[t]);
      float re = ar[0] * cc[ik + idl1 * j], im = ai[0] * cc[ik + idl1 * jc];
#pragma unroll
      for (int t = 1; t < G; ++t) {
        re = re + ar[t] * cc[ik + idl1 * (j + t)];
        im = im + ai[t] * cc[ik + idl1 * (jc - t)];
      }
      acc_re = acc_re + re;
      acc_im = acc_im + im;
    };
    int j = 3;
    for (; j < ipph - 3; j += 4) group(j, std::integral_constant<int, 4>{});
    for (; j < ipph - 1; j += 2) group(j, std::integral_constant<int, 2>{});
    for (; j < ipph; ++j) group(j, std::integral_constant<int, 1>{});
    ch[ik + idl1 * l] = acc_re;
    ch[ik + idl1 * lc] = acc_im;
  });
  each(par, idl1, [&](int ik) {
    float s = cc[ik];
    for (int j = 1; j < ipph; ++j) s = s + cc[ik + idl1 * j];
    ch[ik] = s;
  });
  par.sync();
  auto CC = [&](int a, int b, int c) -> float& {
    return cc[a + ido * (b + ip * c)];
  };
  auto CH = [&](int a, int b, int c) { return ch[c1(a, b, c)]; };
  each2(par, l1, ido, [&](int k, int i) { CC(i, 0, k) = CH(i, k, 0); });
  each2(par, ipph - 1, l1, [&](int jm, int k) {
    const int j = jm + 1, jc = ip - j, j2 = 2 * j - 1;
    CC(ido - 1, j2, k) = CH(0, k, j);
    CC(0, j2 + 1, k) = CH(0, k, jc);
    for (int i = 1; i < ido - 1; i += 2) {
      const int ic = ido - i - 2;
      CC(i, j2 + 1, k) = CH(i, k, j) + CH(i, k, jc);
      CC(ic, j2, k) = CH(i, k, j) - CH(i, k, jc);
      CC(i + 1, j2 + 1, k) = CH(i + 1, k, j) + CH(i + 1, k, jc);
      CC(ic + 1, j2, k) = CH(i + 1, k, jc) - CH(i + 1, k, j);
    }
  });
  par.sync();
  each(par, ip * idl1, [&](int q) { ch[q] = cc[q]; });
}

static __device__ __noinline__ void radfg(Serial par, int ip, int l1, int ido,
                                          const float* wa, float* cc,
                                          float* ch) {
  radfg_body(par, ip, l1, ido, wa, cc, ch);
}

template <int G>
__device__ __forceinline__ void radfg(const Group<G>& par, int ip, int l1,
                                      int ido, const float* wa, float* cc,
                                      float* ch) {
  radfg_body(par, ip, l1, ido, wa, cc, ch);
}

// One forward pass of ducc0's real FFT (rfftp: radf2, radf3, radf4, radf5,
// radfg above 5) from cc to ch, CC(a, b, c) = cc[a + ido*(b + l1*c)] in and
// CH(a, b, c) = ch[a + ido*(b + ip*c)] out, wa the pass's twiddles
// (core/features.py::_radix_pass, op for op), its butterflies spread by
// par. cc is scratch afterwards; ch is complete for every lane on return.
template <class Par>
__device__ inline void radix_pass(const Par& par, int ip, int l1, int ido,
                                  const float* wa, float* cc, float* ch) {
  if (ip > 5) {
    radfg(par, ip, l1, ido, wa, cc, ch);
    par.sync();
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
  const int n_odd = (ido - 1) / 2;  // butterflies i = 2, 4, ... < ido
  if (ip == 2) {
    each(par, l1, [&](int k) {
      CH(0, 0, k) = CC(0, k, 0) + CC(0, k, 1);
      CH(ido - 1, 1, k) = CC(0, k, 0) - CC(0, k, 1);
    });
    if (ido % 2 == 0)
      each(par, l1, [&](int k) {
        CH(0, 1, k) = -CC(ido - 1, k, 1);
        CH(ido - 1, 0, k) = CC(ido - 1, k, 0);
      });
    each2(par, l1, n_odd, [&](int k, int ii) {
      const int i = 2 + 2 * ii, ic = ido - i;
      float tr2, ti2;
      mulpm(0, i, k, tr2, ti2);
      CH(i - 1, 0, k) = CC(i - 1, k, 0) + tr2;
      CH(ic - 1, 1, k) = CC(i - 1, k, 0) - tr2;
      CH(i, 0, k) = ti2 + CC(i, k, 0);
      CH(ic, 1, k) = ti2 - CC(i, k, 0);
    });
  } else if (ip == 3) {
    each(par, l1, [&](int k) {
      const float cr2 = CC(0, k, 1) + CC(0, k, 2);
      CH(0, 0, k) = CC(0, k, 0) + cr2;
      CH(0, 2, k) = kTaui3 * (CC(0, k, 2) - CC(0, k, 1));
      CH(ido - 1, 1, k) = CC(0, k, 0) + -0.5f * cr2;
    });
    each2(par, l1, n_odd, [&](int k, int ii) {
      const int i = 2 + 2 * ii, ic = ido - i;
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
    });
  } else if (ip == 4) {
    each(par, l1, [&](int k) {
      const float tr1 = CC(0, k, 3) + CC(0, k, 1);
      CH(0, 2, k) = CC(0, k, 3) - CC(0, k, 1);
      const float tr2 = CC(0, k, 0) + CC(0, k, 2);
      CH(ido - 1, 1, k) = CC(0, k, 0) - CC(0, k, 2);
      CH(0, 0, k) = tr2 + tr1;
      CH(ido - 1, 3, k) = tr2 - tr1;
    });
    if (ido % 2 == 0)
      each(par, l1, [&](int k) {
        const float ti1 = -kHsqt2 * (CC(ido - 1, k, 1) + CC(ido - 1, k, 3));
        const float tr1 = kHsqt2 * (CC(ido - 1, k, 1) - CC(ido - 1, k, 3));
        CH(ido - 1, 0, k) = CC(ido - 1, k, 0) + tr1;
        CH(ido - 1, 2, k) = CC(ido - 1, k, 0) - tr1;
        CH(0, 3, k) = ti1 + CC(ido - 1, k, 2);
        CH(0, 1, k) = ti1 - CC(ido - 1, k, 2);
      });
    each2(par, l1, n_odd, [&](int k, int ii) {
      const int i = 2 + 2 * ii, ic = ido - i;
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
    });
  } else {  // ip == 5
    each(par, l1, [&](int k) {
      const float cr2 = CC(0, k, 4) + CC(0, k, 1), ci5 = CC(0, k, 4) - CC(0, k, 1);
      const float cr3 = CC(0, k, 3) + CC(0, k, 2), ci4 = CC(0, k, 3) - CC(0, k, 2);
      CH(0, 0, k) = CC(0, k, 0) + cr2 + cr3;
      CH(ido - 1, 1, k) = CC(0, k, 0) + kTr11 * cr2 + kTr12 * cr3;
      CH(0, 2, k) = kTi11 * ci5 + kTi12 * ci4;
      CH(ido - 1, 3, k) = CC(0, k, 0) + kTr12 * cr2 + kTr11 * cr3;
      CH(0, 4, k) = kTi12 * ci5 - kTi11 * ci4;
    });
    each2(par, l1, n_odd, [&](int k, int ii) {
      const int i = 2 + 2 * ii, ic = ido - i;
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
    });
  }
  par.sync();
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

// x [n] (4 <= n <= kMaxWindow), a and b scratch [n] (a may be
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
    radix_pass(Serial{}, f.ip[q], f.l1[q], f.ido[q], f.tw + f.off[q], p1,
               p2);
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

__host__ __device__ constexpr int log2_exact(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
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

// ---- one window per group of 8 or 32 lanes, any width up to 1,024 ----
// (the wide kernel)

constexpr int kWarp = 32;

// Where sample j of a window sits in its row: one pad float after every
// 32 samples, so that lanes reading samples 32 apart (the starts of XLA's
// chunks) hit distinct banks.
__device__ __forceinline__ int skew(int j) { return j + (j >> 5); }

// f(j, r1[skew(j)], r2[skew(j + d)]) for j = lo .. hi - 1 in order, in
// runs where neither pad offset changes: each term is two loads at a
// fixed distance from a pointer.
template <class F>
__device__ __forceinline__ void skewed_walk(const float* r1, const float* r2,
                                            int d, int lo, int hi, F f) {
  for (int j = lo; j < hi;) {
    const int o1 = j >> 5, o2 = (j + d) >> 5;
    const int end = min(hi, min((o1 + 1) * kWarp, (o2 + 1) * kWarp - d));
    const float* p1 = r1 + o1;
    const float* p2 = r2 + d + o2;
    for (; j < end; ++j) f(j, p1[j], p2[j]);
  }
}

// term(j, r1[skew(j)], r2[skew(j + d)]) summed left to right over a
// non-empty [lo, hi): one lane's XLA chunk. The chain starts from -0,
// which adds exactly as starting from the first term does.
template <class Term>
__device__ __forceinline__ float skewed_chain(const float* r1,
                                              const float* r2, int d, int lo,
                                              int hi, Term term) {
  float s = -0.0f;
  skewed_walk(r1, r2, d, lo, hi,
              [&](int j, float a, float b) { s = s + term(j, a, b); });
  return s;
}

// The chunk totals part[0], part[stride], ... of an n-term sum added left
// to right, as xla_sum adds them (0 for n <= 0)
__device__ __forceinline__ float chunk_total(const float* part, int n,
                                             int stride = 1) {
  const int n_win = xla_chunks(n);
  if (n_win == 0) return 0.0f;
  float total = part[0];
  for (int c = 1; c < n_win; ++c) total = total + part[c * stride];
  return total;
}

// The smallest and largest sample and the largest |x[j+1] - x[j]| of the
// window x [n] (skewed) with stat_time_features' bits, and the count of
// samples <= kFeatEps, on a group: lane l folds its ceil(n / G) samples
// left to right, then neighbouring lanes fold pairwise in order (the
// earlier samples the left operand). fminf and fmaxf pick one operand by
// value (NaN loses; equal zeros by a fixed rule), so they are
// associative, and the in-order regrouping gives the left-to-right fold's
// bits, the sign of a zero included. max_ad's terms are >= +0 or NaN, so
// each lane may start its fold from 0 as the chain does. Every lane gets
// the results.
struct Extremes {
  float xmin, xmax, max_ad;
  int zeros;
};
template <int G>
__device__ __forceinline__ Extremes warp_extremes(const float* x, int n,
                                                  const Group<G>& g) {
  const int per = (n + G - 1) / G;
  const int lo = g.l * per, hi = min(lo + per, n);
  float mn = 0.0f, mx = 0.0f, ad = 0.0f;
  int zeros = 0;
  if (lo < n) {
    mn = mx = x[skew(lo)];
    skewed_walk(x, x, 1, lo, hi, [&](int j, float v, float next) {
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
      if (j + 1 < n) ad = fmaxf(ad, fabsf(next - v));
      zeros += v <= kFeatEps ? 1 : 0;
    });
  }
  const int used = (n + per - 1) / per;
  for (int off = 1; off < G; off *= 2) {
    const float o_mn = g.shfl_down(mn, off);
    const float o_mx = g.shfl_down(mx, off);
    const float o_ad = g.shfl_down(ad, off);
    if ((g.l & (2 * off - 1)) == 0 && g.l + off < used) {
      mn = fminf(mn, o_mn);
      mx = fmaxf(mx, o_mx);
      ad = fmaxf(ad, o_ad);
    }
  }
  return {g.shfl(mn, 0), g.shfl(mx, 0), g.shfl(ad, 0), g.sum(zeros)};
}

// Bitonic sort, ascending, of the G R values v [R] of a group, element
// e = lane * R + k in register k of lane e / R, in the form without
// directions: each merge of two sorted blocks of size / 2 first compares
// e with its mirror e ^ (size - 1), then e with e ^ j for j = size / 4,
// ..., 1, the smaller value always to the lower index. Partners less than
// R apart are registers of one lane (every index a constant after
// unrolling, so v stays in registers); farther ones are a shuffle apart,
// and the lane holding the lower index keeps the minimum. Each comparator
// is fminf / fmaxf: for values without NaN the sorted values are the
// insertion sort's (only the sign of equal zeros may land elsewhere).
template <int G, int R>
__device__ __forceinline__ void warp_bitonic_sort(float (&v)[R],
                                                  const Group<G>& g) {
  constexpr int kLog = log2_exact(G * R);
  static_assert((1 << kLog) == G * R && R >= 2, "G R: a power of two");
  auto in_lane = [&](int a, int b) {  // a < b
    const float lo = fminf(v[a], v[b]), hi = fmaxf(v[a], v[b]);
    v[a] = lo;
    v[b] = hi;
  };
  static_for<1, kLog + 1>([&](auto ls_c) {
    constexpr int size = 1 << decltype(ls_c)::value;
    if constexpr (size <= R) {  // the mirror within each lane
#pragma unroll
      for (int k = 0; k < R; ++k)
        if ((k & (size / 2)) == 0) in_lane(k, k ^ (size - 1));
    } else {  // the mirror across lanes: my k meets its R - 1 - k
      constexpr int m = size / R - 1;
      const bool lower = (g.l & (size / R / 2)) == 0;
#pragma unroll
      for (int k = 0; k < R / 2; ++k) {
        const int kk = R - 1 - k;
        const float o_k = g.shfl_xor(v[kk], m);
        const float o_kk = g.shfl_xor(v[k], m);
        v[k] = lower ? fminf(v[k], o_k) : fmaxf(v[k], o_k);
        v[kk] = lower ? fminf(v[kk], o_kk) : fmaxf(v[kk], o_kk);
      }
    }
    static_for<2, decltype(ls_c)::value + 1>([&](auto t_c) {
      constexpr int j = size >> decltype(t_c)::value;
      if constexpr (j < R) {
#pragma unroll
        for (int k = 0; k < R; ++k)
          if ((k & j) == 0) in_lane(k, k + j);
      } else {
        constexpr int m = j / R;
        const bool lower = (g.l & m) == 0;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const float o = g.shfl_xor(v[k], m);
          v[k] = lower ? fminf(v[k], o) : fmaxf(v[k], o);
        }
      }
    });
  });
}

// Element r of warp_bitonic_sort's result, on every lane
template <int G, int R>
__device__ __forceinline__ float sorted_at(const float (&v)[R], int r,
                                           const Group<G>& g) {
  const int k = r % R;
  float s = v[0];
#pragma unroll
  for (int q = 1; q < R; ++q) s = q == k ? v[q] : s;
  return g.shfl(s, r / R);
}

// The two order statistics and the weight of the upper one that
// sorted_quantile interpolates at q in a window of n
struct QuantileRanks {
  int lo, hi;
  float w;
};
__device__ __forceinline__ QuantileRanks quantile_ranks(int n, double q) {
  const double pos = q * (n - 1);
  const int lo = static_cast<int>(floor(pos));
  return {lo, min(lo + 1, n - 1),
          static_cast<float>(pos) - static_cast<float>(lo)};
}

// The median and the quartiles q25 and q75 of the window x [n] (skewed,
// n <= G R), as stat_time_features' insertion sort gives them, on a
// group; every lane gets them. A window without NaN (its mean is not NaN)
// is sorted in registers (warp_bitonic_sort). Otherwise each sample's
// place in the insertion sort's result is counted across the lanes (a
// NaN stays where it is, each NaN-free run between them is sorted on its
// own, stably, as insertion_sorted_at says) and the six order statistics
// go through slots [6].
template <int G, int R>
__device__ __forceinline__ void warp_quartiles(const float* x, int n,
                                               bool has_nan, const Group<G>& g,
                                               float* slots, float* median,
                                               float* q25, float* q75) {
  const QuantileRanks q[3] = {quantile_ranks(n, 0.5), quantile_ranks(n, 0.25),
                              quantile_ranks(n, 0.75)};
  float s[6];
  if (!has_nan) {
    float v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int e = g.l * R + k;
      v[k] = e < n ? x[skew(e)] : INFINITY;
    }
    warp_bitonic_sort(v, g);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s[2 * i] = sorted_at(v, q[i].lo, g);
      s[2 * i + 1] = sorted_at(v, q[i].hi, g);
    }
  } else {
    for (int i = g.l; i < n; i += G) {
      const float xi = x[skew(i)];
      int pos = i;
      if (!isnan(xi)) {
        int lo = i, hi = i + 1;  // the NaN-free run [lo, hi) around i
        while (lo > 0 && !isnan(x[skew(lo - 1)])) --lo;
        while (hi < n && !isnan(x[skew(hi)])) ++hi;
        pos = lo;
        for (int j = lo; j < hi; ++j) {
          const float xj = x[skew(j)];
          pos += (xj < xi) || (j < i && xj == xi) ? 1 : 0;
        }
      }
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        if (pos == q[t].lo) slots[2 * t] = xi;
        if (pos == q[t].hi) slots[2 * t + 1] = xi;
      }
    }
    g.sync();
#pragma unroll
    for (int t = 0; t < 6; ++t) s[t] = slots[t];
  }
  *median = s[0] * (1.0f - q[0].w) + s[1] * q[0].w;
  *q25 = s[2] * (1.0f - q[1].w) + s[3] * q[1].w;
  *q75 = s[4] * (1.0f - q[2].w) + s[5] * q[2].w;
}

// Floats of a window's scratch `part` at width n: four sums' chunk
// totals, at least 64 (the features' operands, the 30 autocorrelations,
// the order statistics' slots)
__host__ __device__ constexpr int warp_part_floats(int n) {
  return 4 * ((n + kWarp - 1) / kWarp) > 64 ? 4 * ((n + kWarp - 1) / kWarp)
                                            : 64;
}

// Lane l writes out[k] = num[k] / den[k] for k = l, l + G, ... < count,
// then `tail` for the features whose last op is no division (den 1: x / 1
// is x): the lanes divide side by side, where one lane would do them one
// after another. part holds num [count] and den [count], written by lane
// 0.
template <int G, class Tail>
__device__ __forceinline__ void features_out(const float* part, int count,
                                             const Group<G>& g, float* out,
                                             Tail tail) {
  g.sync();
  for (int k = g.l; k < count; k += G)
    out[k] = tail(k, part[k] / part[count + k]);
}

// stat_time_features on a group: the window x [n] (skewed, 3 <= n <= G R,
// ceil(n / 32) <= G) -> out [28], lane l writing out[l], out[l + G], ...;
// the same f32 ops in the same order,
// bit for bit. Every sum is split across the lanes in XLA's chunks: each
// (sum, chunk) pair is one lane's left-to-right chain (the mean, lo_mean,
// hi_mean and mean_ad pairs in one pass, the four sums over the centred
// window one chunk a lane, the 30 autocorrelations' pairs), then one lane
// a sum adds its chunk totals left to right. The zero fraction and the
// peaks are sums of 0 and 1, whole numbers far below 2^24, so they are
// counted across the lanes in any order. x's row ends holding the
// centred window in plain order (for freq_features_warp); xc [n]
// (skewed) takes the centred window, then the autocorrelations' 30
// ceil((n - 1) / 32) chunk totals, and part [warp_part_floats(n)] is
// scratch.
template <int G, int R>
__device__ __forceinline__ void stat_time_features_warp(float* x, float* xc,
                                                        float* part, int n,
                                                        const Group<G>& g,
                                                        float* out) {
  const float rn = 1.0f / static_cast<float>(n);
  const int nc = xla_chunks(n), half = n / 2;
  int lo, hi;
  // sum s = 0 the mean, 1 lo_mean, 2 hi_mean, 3 mean_ad: its chunk c's
  // total at part[s * nc + c]
  auto span = [&](int s) {
    return s == 0 ? n : s == 1 ? half : s == 2 ? n - half : n - 1;
  };
  for (int q = g.l; q < 4 * nc; q += G) {
    int s, c;
    divmod_small(q, nc, &s, &c);
    const int base = s == 2 ? half : 0;
    if (xla_chunk(span(s), c, &lo, &hi))
      part[q] = skewed_chain(x, x, s == 3 ? 1 : 0, base + lo, base + hi,
                             [&](int, float a, float b) {
                               return s == 3 ? fabsf(b - a) : a;
                             });
  }
  g.sync();
  float total = 0.0f;
  if (g.l < 4) total = chunk_total(part + g.l * nc, span(g.l));
  const float mean = g.shfl(total, 0) * (1.0f / static_cast<float>(n));
  const float lo_mean = g.shfl(total, 1) * (1.0f / static_cast<float>(half));
  const float hi_mean = g.shfl(total, 2) *
                        (1.0f / static_cast<float>(n - half));
  const float mean_ad = g.shfl(total, 3) *
                        (1.0f / static_cast<float>(n - 1));
  const Extremes ext = warp_extremes(x, n, g);
  for (int j = g.l; j < n; j += G) xc[skew(j)] = x[skew(j)] - mean;
  float median, q25, q75;
  warp_quartiles<G, R>(x, n, mean != mean, g, part, &median, &q25, &q75);
  g.sync();  // xc is written and the slots are read

  // var, m3, m4 and cov over the centred window: lane c sums chunk c of
  // all four, their totals at part[s * nc + c]
  const float tbar = static_cast<float>((n - 1) / 2.0);
  if (xla_chunk(n, g.l, &lo, &hi)) {
    float s_var = -0.0f, s_m3 = -0.0f, s_m4 = -0.0f, s_cov = -0.0f;
    skewed_walk(xc, xc, 0, lo, hi, [&](int j, float d, float) {
      const float d2 = d * d;
      s_var = s_var + d * d;
      s_m3 = s_m3 + d * (d * d);
      s_m4 = s_m4 + d2 * d2;
      s_cov = s_cov + (static_cast<float>(j) - tbar) * d;
    });
    part[g.l] = s_var;
    part[nc + g.l] = s_m3;
    part[2 * nc + g.l] = s_m4;
    part[3 * nc + g.l] = s_cov;
  }
  g.sync();
  total = 0.0f;
  if (g.l < 4) total = chunk_total(part + g.l * nc, n);
  const float var = g.shfl(total, 0) * rn;
  const float m3 = g.shfl(total, 1) * rn;
  const float m4 = g.shfl(total, 2) * rn;
  const float cov = g.shfl(total, 3) * rn;

  const float std = sqrtf(var);
  const float thresh = mean + std;
  int peaks = 0;
  for (int j = g.l; j < n - 2; j += G) {
    const float mid = x[skew(j + 1)];
    peaks += (mid > x[skew(j)] && mid >= x[skew(j + 2)] && mid > thresh)
                 ? 1 : 0;
  }
  const float n_peaks = static_cast<float>(g.sum(peaks)) * rn;
  g.sync();  // x is read: its row takes the centred window, plain
  for (int j = g.l; j < n; j += G) x[j] = xc[skew(j)];
  g.sync();

  // the autocorrelations over the plain centred window: chunk c of lag
  // l + 1 is pair q = c * 30 + l, its total at xc[q]. A round's lanes take
  // one chunk at consecutive lags, so they read one stretch of the window
  // (at most two lanes a bank), and the pairs need no division: q + G is
  // (c, l) stepped by (G / 30, G % 30).
  const int nca = xla_chunks(n - 1);
  for (int q = g.l, c = g.l / kAcfHi, l = g.l % kAcfHi; q < kAcfHi * nca;
       q += G) {
    if (xla_chunk(n - 1 - l, c, &lo, &hi)) {
      const float* p = x + lo;
      float s = -0.0f;
      for (int j = 0; j < hi - lo; ++j) s = s + p[j] * p[j + l + 1];
      xc[q] = s;
    }
    l += G % kAcfHi;
    c += G / kAcfHi;
    if (l >= kAcfHi) {
      l -= kAcfHi;
      c += 1;
    }
  }
  g.sync();
  const float acf_den = static_cast<float>(n) * var + kFeatEps;
  for (int l = g.l; l < kAcfHi; l += G)  // lag l + 1's at part[l]
    part[l] = chunk_total(xc + l, n - 1 - l, kAcfHi) / acf_den;
  g.sync();
  auto acf_at = [&](int lag) { return part[lag - 1]; };
  const float acf1 = acf_at(1), acf2 = acf_at(2), acf3 = acf_at(3),
              acf6 = acf_at(6), acf12 = acf_at(12);
  float acf_max = acf_at(kAcfLo);
  int acf_arg = 0;
  for (int lag = kAcfLo + 1; lag <= kAcfHi; ++lag) {
    const float a = acf_at(lag);
    if (a > acf_max) {
      acf_max = a;
      acf_arg = lag - kAcfLo;
    }
  }

  // the OLS trend's sum of (j - tbar)^2: multiples of 1/4 far below 2^50,
  // so exact in f64 in any order, n (n^2 - 1) / 12
  const double tt = static_cast<double>(n) *
                    (static_cast<double>(n) * n - 1.0) / 12.0;
  const float tvar = static_cast<float>(tt) * rn;
  const float slope = cov / tvar;
  float* num = part;
  float* den = part + kStatFeatures;
  g.sync();  // the autocorrelations in part are read
  if (g.l == 0) {
    for (int k = 0; k < kStatFeatures; ++k) den[k] = 1.0f;
    num[0] = mean;
    num[1] = std;
    num[2] = std;
    den[2] = mean + kFeatEps;
    num[3] = ext.xmin;
    num[4] = ext.xmax;
    num[5] = median;
    num[6] = q25;
    num[7] = q75;
    num[8] = q75;  // - q25
    num[9] = m3;
    den[9] = rpow(var, 1.5) + kFeatEps;
    num[10] = m4;  // - 3
    den[10] = var * var + kFeatEps;
    num[11] = ext.xmax;
    den[11] = median + kFeatEps;
    num[12] = ext.xmax;
    den[12] = mean + kFeatEps;
    num[13] = static_cast<float>(ext.zeros) * rn;
    num[14] = ext.xmax;  // - xmin
    num[15] = slope;
    den[15] = mean + kFeatEps;
    num[16] = cov * cov;
    den[16] = tvar * var + kFeatEps;
    num[17] = hi_mean + kFeatEps;
    den[17] = lo_mean + kFeatEps;
    num[18] = acf1;
    num[19] = acf2;
    num[20] = acf3;
    num[21] = acf6;
    num[22] = acf12;
    num[23] = acf_max;
    num[24] = static_cast<float>(acf_arg + kAcfLo);  // * 1/30
    num[25] = mean_ad;
    den[25] = mean + kFeatEps;
    num[26] = ext.max_ad;
    den[26] = mean + kFeatEps;
    num[27] = n_peaks;
  }
  features_out(part, kStatFeatures, g, out, [&](int k, float v) {
    return k == 8 ? v - q25 : k == 10 ? v - 3.0f : k == 14 ? v - ext.xmin
           : k == 24 ? v * (1.0f / static_cast<float>(kAcfHi)) : v;
  });
}

// freq_features on a group: the centred window a [n] (in plain order, as
// stat_time_features_warp leaves it in x's row, 4 <= n <= 1,024) -> out
// [10], lane l writing out[l], out[l + G]; bit for bit with
// freq_features. b: a row of
// at least n floats; part: as stat_time_features_warp's. The radix passes
// ping-pong between a and b, each pass's butterflies across the lanes
// (radix_pass with the Group). Bins,
// their log and p(k) terms are computed across the lanes; each sum of
// them stays one left-to-right chain on a lane of its own (five, then
// three, side by side); the two largest bins are merged across the lanes
// (bins are >= +0 or NaN, so the merge's order changes no bit).
template <int G>
__device__ __forceinline__ void freq_features_warp(float* a, float* b,
                                                   float* part, int n,
                                                   const FreqTables& f,
                                                   const Group<G>& g,
                                                   float* out) {
  float* p1 = a;
  float* p2 = b;
  for (int q = 0; q < f.n_pass; ++q) {
    // pass q's plan by constant indices: a kernel parameter indexed at run
    // time would be copied to the stack
    int ip = f.ip[0], l1 = f.l1[0], ido = f.ido[0], off = f.off[0];
#pragma unroll
    for (int p = 1; p < kMaxFftPasses; ++p) {
      if (p == q) {
        ip = f.ip[p];
        l1 = f.l1[p];
        ido = f.ido[p];
        off = f.off[p];
      }
    }
    radix_pass(g, ip, l1, ido, f.tw + off, p1, p2);
    float* t = p1;
    p1 = p2;
    p2 = t;
  }
  // power [nb] the power spectrum, then [nb, 2 nb) the entropy's terms;
  // aux (the spectrum's row once it is read) [nb] the log terms, then the
  // centroid's, and [nb, 2 nb) p(k)
  const int nb = n / 2;
  float* power = p2;
  float* aux = p1;
  for (int k = g.l; k < nb; k += G) {
    const float h = complex_abs(p1[2 * k + 1], 2 * k + 2 < n ? p1[2 * k + 2]
                                                             : 0.0f);
    power[k] = h * h;
  }
  g.sync();
  for (int k = g.l; k < nb; k += G) aux[k] = rlog(power[k] + kFeatEps);

  // the plain scan's top1, top2 and dom: NaN bins never win its compares,
  // except a NaN first bin, which stays top1 (and top2 is then the largest
  // other bin)
  float t1 = -INFINITY, t2 = -INFINITY;
  int dom = nb;
  for (int k = g.l; k < nb; k += G) {
    const float v = power[k];
    if (v > t1) {
      t2 = t1;
      t1 = v;
      dom = k;
    } else if (v > t2) {
      t2 = v;
    }
  }
  for (int m = G / 2; m > 0; m /= 2) {
    const float o1 = g.shfl_xor(t1, m);
    const float o2 = g.shfl_xor(t2, m);
    const int od = g.shfl_xor(dom, m);
    if (o1 > t1 || (o1 == t1 && od < dom)) {
      t2 = fmaxf(t1, o2);
      t1 = o1;
      dom = od;
    } else {
      t2 = fmaxf(t2, o1);
    }
  }
  const float p0 = power[0];
  const float top1 = isnan(p0) ? p0 : t1, top2 = isnan(p0) ? t1 : t2;
  if (isnan(p0)) dom = 0;
  g.sync();  // the log terms are written

  // lane 0 psum, 1 the log terms' sum, 2-4 the three bands (an empty band
  // is 0)
  const int b5 = min(5, nb), b15 = min(15, nb);
  float s = 0.0f;
  if (g.l < 5) {
    const float* src = g.l == 1 ? aux : power;
    const int lo = g.l == 3 ? b5 : (g.l == 4 ? b15 : 0);
    const int hi = g.l == 2 ? b5 : (g.l == 3 ? b15 : nb);
    if (lo < hi) s = -0.0f;
    for (int k0 = lo; k0 < hi; k0 += 16) {  // 16 loads, then 16 adds
      float t[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) t[i] = k0 + i < hi ? src[k0 + i] : 0.0f;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (k0 + i < hi) s = s + t[i];
    }
  }
  const float psum = g.shfl(s, 0);
  const float log_sum = g.shfl(s, 1);
  const float low = g.shfl(s, 2);
  const float mid = g.shfl(s, 3);
  const float high = g.shfl(s, 4);
  const float total = psum + kFeatEps;
  g.sync();  // the log terms are read
  for (int k = g.l; k < nb; k += G) {
    const float p = power[k] / total;
    power[nb + k] = p * rlog(p + kFeatEps);
    aux[k] = p * static_cast<float>(k);
    aux[nb + k] = p;
  }
  g.sync();
  // lanes 0-2 turn the entropy's terms, the centroid's and p(k) into
  // their running sums, left to right in place; the roll-off is the first
  // k whose running sum of p reaches 0.85 (else 0)
  if (g.l < 3) {
    float* src = g.l == 0 ? power + nb : (g.l == 1 ? aux : aux + nb);
    float s2 = -0.0f;
    for (int k0 = 0; k0 < nb; k0 += 16) {
      float t[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) t[i] = k0 + i < nb ? src[k0 + i] : 0.0f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (k0 + i < nb) {
          s2 = s2 + t[i];
          src[k0 + i] = s2;
        }
      }
    }
  }
  g.sync();
  const float ent = power[2 * nb - 1], cent = aux[nb - 1];
  int roll = 0;
  for (int k0 = 0; k0 < nb; k0 += G) {
    const int k = k0 + g.l;
    const unsigned hit = g.ballot(k < nb && aux[nb + k] >= 0.85f);
    if (hit) {
      roll = k0 + __ffs(hit) - 1;
      break;
    }
  }
  const float flat = rexp(log_sum * f.inv_nb);
  float* num = part;
  float* den = part + kFreqFeatures;
  if (g.l == 0) {
    for (int k = 0; k < kFreqFeatures; ++k) den[k] = 1.0f;
    num[0] = -ent;  // * inv_log_nb
    num[1] = static_cast<float>(dom);  // * inv_nb
    num[2] = top1;
    den[2] = total;
    num[3] = top1 + top2;
    den[3] = total;
    num[4] = low;
    den[4] = total;
    num[5] = mid;
    den[5] = total;
    num[6] = high;
    den[6] = total;
    num[7] = cent;  // * inv_nb
    num[8] = flat;
    den[8] = psum * f.inv_nb + kFeatEps;
    num[9] = static_cast<float>(roll);  // * inv_nb
  }
  features_out(part, kFreqFeatures, g, out, [&](int k, float v) {
    return k == 0 ? v * f.inv_log_nb
           : k == 1 || k == 7 || k == 9 ? v * f.inv_nb : v;
  });
}

}  // namespace repro_torch
