// holt_winters: one-step-ahead additive Holt-Winters forecasts over whole
// series, y [B, T] -> out [B, T] (core/forecasting.py::hw_smooth, its
// plain version; out[b, t] is the forecast of y[b, t] made after y[b, :t]).
//
// Replaces the Pallas TPU kernel src/repro/kernels/holt_winters.py
// (holt_winters_kernel, body _kernel). The TPU kernel kept TILE_B series in
// sublanes with the season as a (TILE_B, period) VMEM tile and picked the
// phase with a one-hot sum. Here each thread owns one series with level,
// trend and phase in registers (hw.cuh::hw_step, the recurrence the episode
// kernel's forecasters run), and the season is indexed at run time in
// [period, B] global scratch, where a warp's accesses coalesce and, at the
// paper's period of 60, the whole season of a 100,000-series batch (24 MB)
// stays in L2. `period` is a run-time argument: the registry allows any,
// e.g. 1440.
//
// Bound on the H100: bytes. The kernel reads y once and writes out once,
// 8 bytes per step, against ~15 f32 operations per step: at 100,000 x
// 2,880 that is 2.3 GB, 0.69 ms at 3.35 TB/s, against 0.06 ms of
// operations. With one thread per row, a warp's loads at step t would be
// T*4 bytes apart, so the block stages its 64 series through shared memory
// in tiles of 64 steps: loads and stores move 256-byte runs of each row,
// and each thread walks its own row of the tile, writing each forecast
// over the sample it has just read.
#include "hw.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 64;     // series per block
constexpr int kSteps = 64;       // time steps per staged tile
constexpr int kPad = kSteps + 1; // tile row stride: conflict-free columns

__global__ void holt_winters_kernel(const float* __restrict__ y,
                                    float* __restrict__ out,
                                    float* __restrict__ season_scratch,
                                    int B, int T, int period, HWCoeffs c) {
  __shared__ float tile[kThreads * kPad];
  const int b0 = blockIdx.x * kThreads;
  const int b = b0 + threadIdx.x;
  const int rows = min(kThreads, B - b0);
  const bool active = b < B;
  float* season = season_scratch + (active ? b : 0);  // phase p at p * B
  if (active)
    for (int p = 0; p < period; ++p) season[static_cast<size_t>(p) * B] = 0.0f;
  float level = active ? y[static_cast<size_t>(b) * T] : 0.0f;
  float trend = 0.0f;
  int phase = 0;

  for (int t0 = 0; t0 < T; t0 += kSteps) {
    const int steps = min(kSteps, T - t0);
    // stage y[b0 : b0 + rows, t0 : t0 + steps], each warp reading whole runs
    for (int i = threadIdx.x; i < rows * kSteps; i += kThreads) {
      const int r = i / kSteps, k = i % kSteps;
      if (k < steps)
        tile[r * kPad + k] = y[static_cast<size_t>(b0 + r) * T + t0 + k];
    }
    __syncthreads();
    if (active) {
      float* row = tile + threadIdx.x * kPad;
      for (int k = 0; k < steps; ++k) {
        float& s = season[static_cast<size_t>(phase) * B];
        const float yk = row[k];
        row[k] = (level + trend) + s;
        hw_step(level, trend, s, yk, c);
        phase = phase + 1 == period ? 0 : phase + 1;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * kSteps; i += kThreads) {
      const int r = i / kSteps, k = i % kSteps;
      if (k < steps)
        out[static_cast<size_t>(b0 + r) * T + t0 + k] = tile[r * kPad + k];
    }
    // the next tile's staging overwrites the tile only after this store
    __syncthreads();
  }
}

}  // namespace

void holt_winters_launch(const float* y, float* out, float* season_scratch,
                         int B, int T, int period, HWCoeffs c,
                         cudaStream_t stream) {
  const int grid = (B + kThreads - 1) / kThreads;
  holt_winters_kernel<<<grid, kThreads, 0, stream>>>(y, out, season_scratch,
                                                     B, T, period, c);
}

}  // namespace repro_torch
