// The port's shared f32 arithmetic on the card (repro_torch/_numerics.py):
// XLA CPU's summation order, and exp/log/log1p/pow evaluated in f64 and
// rounded once to f32, as the plain PyTorch versions evaluate them.
#pragma once

#include <cmath>

namespace repro_torch {

constexpr int kXlaWindow = 32;
constexpr float kInv60 = 1.0f / 60.0f;  // the reference's `/ 60.0`

// A sum of term(0) .. term(n - 1) in XLA CPU's order
// (_numerics.py::sum_chunks): chunks of 32 with half the padding in front,
// each summed left to right, then the chunk totals left to right. An
// empty sum is 0.
template <class Term>
__device__ __forceinline__ float xla_sum(int n, Term term) {
  const int n_win = (n + kXlaWindow - 1) / kXlaWindow;
  const int low = (n_win * kXlaWindow - n) / 2;
  float total = 0.0f;
  for (int w = 0; w < n_win; ++w) {
    const int lo = max(w * kXlaWindow - low, 0);
    const int hi = min((w + 1) * kXlaWindow - low, n);
    float s = term(lo);
    for (int j = lo + 1; j < hi; ++j) s = s + term(j);
    total = w == 0 ? s : total + s;
  }
  return total;
}

// The chunks of an n-term sum in xla_sum's order: how many (0 for n <=
// 0), and chunk c's terms [*lo, *hi), false past the last one
__device__ __forceinline__ int xla_chunks(int n) {
  return n > 0 ? (n + kXlaWindow - 1) / kXlaWindow : 0;
}
__device__ __forceinline__ bool xla_chunk(int n, int c, int* lo, int* hi) {
  const int n_win = xla_chunks(n);
  if (c >= n_win) return false;
  const int low = (n_win * kXlaWindow - n) / 2;
  *lo = max(c * kXlaWindow - low, 0);
  *hi = min((c + 1) * kXlaWindow - low, n);
  return true;
}

// term(lo) + ... + term(hi - 1), left to right (_numerics.py::seq_sum)
template <class Term>
__device__ __forceinline__ float seq_sum(int lo, int hi, Term term) {
  if (hi <= lo) return 0.0f;
  float s = term(lo);
  for (int j = lo + 1; j < hi; ++j) s = s + term(j);
  return s;
}

// x / y, the IEEE quotient. A zero dividend over a positive divisor is
// its own quotient (sign included) and skips the division: on the H100 a
// zero dividend sends the division down its slow path, which costs ~4x the
// fast one (a 1e5-division probe: 15.2 ms against 3.7 ms). The branch
// keeps those lanes out of the division.
__device__ __forceinline__ float fdiv(float x, float y) {
  float q = x;
  if (x != 0.0f || !(y > 0.0f)) q = x / y;
  return q;
}

__device__ __forceinline__ float rexp(float x) {
  return static_cast<float>(exp(static_cast<double>(x)));
}
__device__ __forceinline__ float rlog(float x) {
  return static_cast<float>(log(static_cast<double>(x)));
}
__device__ __forceinline__ float rlog1p(float x) {
  return static_cast<float>(log1p(static_cast<double>(x)));
}
__device__ __forceinline__ float rpow(float x, double y) {
  return static_cast<float>(pow(static_cast<double>(x), y));
}

}  // namespace repro_torch
