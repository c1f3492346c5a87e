// holt_winters: one-step-ahead additive Holt-Winters forecasts over whole
// series, y [B, T] -> out [B, T] (core/forecasting.py::hw_smooth, its
// plain version; out[b, t] is the forecast of y[b, t] made after y[b, :t]).
//
// Replaces the Pallas TPU kernel src/repro/kernels/holt_winters.py
// (holt_winters_kernel, body _kernel). The TPU kernel kept TILE_B series in
// sublanes with the season as a (TILE_B, period) VMEM tile and picked the
// phase with a one-hot sum. Here each thread owns one series with level,
// trend and phase in registers (hw.cuh::hw_step, the recurrence the
// pre-pass's forecasters run). The phase is the same in every thread of a
// block, since all series start at phase 0 together.
//
// Bound on the H100: bytes. The kernel must read y once and write out once,
// 8 bytes per step, against ~15 f32 operations per step: at 100,000 x
// 2,880 that is 2.3 GB, 0.69 ms at 3.35 TB/s, against 0.06 ms of
// operations. What the design does about it:
//
// * The season stays on the SM. Up to kHWSharedPeriodMax (96) phases, each
//   block keeps its 64 series' seasons in shared memory, laid out
//   [period][series] so that a step's 64 accesses fall in distinct banks
//   (15 KB a block at the paper's period of 60). Longer seasons (the
//   registry allows any period, e.g. 1440: 368 KB a block) keep the
//   season in [period, B] global scratch, where a warp's accesses
//   coalesce. Neither variant zeroes its season: a slot is read as 0
//   until its first write, one period in. Both read the next step's slot
//   a step ahead, before this step's store (at period 1 the two are one
//   slot, and the value just computed is taken instead), so the season's
//   latency is off the recurrence's critical path.
// * Tiles of y stream in while the threads walk. A block stages its 64
//   series in tiles of kSteps (64) steps through kBufs (2) buffers with
//   cp.async: while the threads walk tile k, tile k+1 is on its way in.
//   Where T % 4 == 0 and both tensors are 16-B aligned, each copy moves
//   16 B (a warp reads two whole 256-B row segments per instruction);
//   otherwise 4 B. The 16-B chunks of a tile row sit XOR-swizzled (chunk
//   c of row r at c ^ (r % 8)), so a warp's 16-B copies, each thread's
//   16-B reads along its own row and the store's 16-B reads all run free
//   of bank conflicts, with no padding. Each thread writes its forecasts
//   over the samples it has read; after a barrier the block stores the
//   tile with coalesced stores and goes straight on to the next tile. A
//   buffer is refilled only after the barrier that follows its store.
//   Sizes: 64 series x 64 steps x 2 buffers is 32 KB of tiles; with the
//   15 KB season at period 60 a block holds 47 KB, so 4 blocks share an
//   SM, each with a 16-KB tile in flight: 64 KB a SM against the ~25 KB
//   (3.35 TB/s x ~1 us over 132 SMs) the bound needs. At the limit of 96
//   phases (56 KB a block) 4 blocks still fit. Rows of 256 B beat more
//   buffers of 128-B rows: 0.855 ms at 100,000 x 2,880 against 1.011 for
//   32 steps x 3 buffers and 0.904 for 32 x 4 (tools/time_kernel_trees.py
//   on an H100 80GB HBM3 at 700 W).
//
// The f32 operations and their order are hw_smooth's (forecast (level +
// trend) + s, level from y[b, 0], season from 0), so the kernel equals
// its plain version bit for bit.
#include <cstdint>

#include "hw.cuh"

namespace repro_torch {
namespace {

constexpr int kSeries = 64;               // series (threads) per block
constexpr int kSteps = 64;                // time steps per staged tile
constexpr int kBufs = 2;                  // tile buffers in the ring
constexpr int kChunks = kSteps / 4;       // 16-B chunks per tile row
constexpr int kTile = kSeries * kSteps;   // floats per tile

// float offset of step w of row r in a tile (chunks XOR-swizzled)
__device__ __forceinline__ int tile_at(int r, int w) {
  return r * kSteps + (((w >> 2) ^ (r & 7)) << 2) + (w & 3);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const auto s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const auto s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Start the copy of y[b0 : b0 + rows, t0 : t0 + steps] into `tile`.
template <bool kVec>
__device__ __forceinline__ void stage(float* tile, const float* y, int b0,
                                      int rows, int T, int t0, int steps) {
  if constexpr (kVec) {
    for (int i = threadIdx.x; i < kSeries * kChunks; i += kSeries) {
      const int r = i / kChunks, w = 4 * (i % kChunks);
      if (r < rows && w < steps)
        cp_async16(tile + tile_at(r, w),
                   y + static_cast<size_t>(b0 + r) * T + t0 + w);
    }
  } else {
    for (int i = threadIdx.x; i < kTile; i += kSeries) {
      const int r = i / kSteps, w = i % kSteps;
      if (r < rows && w < steps)
        cp_async4(tile + tile_at(r, w),
                  y + static_cast<size_t>(b0 + r) * T + t0 + w);
    }
  }
}

// Store the forecasts of `tile` to out[b0 : b0 + rows, t0 : t0 + steps].
template <bool kVec>
__device__ __forceinline__ void store(const float* tile, float* out, int b0,
                                      int rows, int T, int t0, int steps) {
  if constexpr (kVec) {
    for (int i = threadIdx.x; i < kSeries * kChunks; i += kSeries) {
      const int r = i / kChunks, w = 4 * (i % kChunks);
      if (r < rows && w < steps)
        *reinterpret_cast<float4*>(out + static_cast<size_t>(b0 + r) * T +
                                   t0 + w) =
            *reinterpret_cast<const float4*>(tile + tile_at(r, w));
    }
  } else {
    for (int i = threadIdx.x; i < kTile; i += kSeries) {
      const int r = i / kSteps, w = i % kSteps;
      if (r < rows && w < steps)
        out[static_cast<size_t>(b0 + r) * T + t0 + w] = tile[tile_at(r, w)];
    }
  }
}

// kShared: the season in shared memory ([period][kSeries] after the tile
// ring), else in season_scratch [period, B]. kVec: 16-B copies.
template <bool kShared, bool kVec>
__global__ void __launch_bounds__(kSeries)
    holt_winters_kernel(const float* __restrict__ y, float* __restrict__ out,
                        float* __restrict__ season_scratch, int B, int T,
                        int period, HWCoeffs c) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                          // kBufs tiles
  const int b0 = blockIdx.x * kSeries;
  const int b = b0 + threadIdx.x;
  const int rows = min(kSeries, B - b0);
  const bool active = b < B;
  // season slot p of this thread's series at season[p * stride]
  float* season = kShared ? smem + kBufs * kTile + threadIdx.x
                          : season_scratch + (active ? b : 0);
  const size_t stride = kShared ? kSeries : static_cast<size_t>(B);

  float level = active ? y[static_cast<size_t>(b) * T] : 0.0f;
  float trend = 0.0f;
  float s_cur = 0.0f;                          // the season at `phase`
  int phase = 0;

  const int n_tiles = (T + kSteps - 1) / kSteps;
  for (int k = 0; k < kBufs - 1; ++k) {
    if (k < n_tiles)
      stage<kVec>(ring + k * kTile, y, b0, rows, T, k * kSteps,
                  min(kSteps, T - k * kSteps));
    cp_async_commit();
  }
  for (int k = 0; k < n_tiles; ++k) {
    const int t0 = k * kSteps, steps = min(kSteps, T - t0);
    float* tile = ring + (k % kBufs) * kTile;
    cp_async_wait<kBufs - 2>();   // this thread's copies of tile k landed
    // everyone's copies of tile k are visible, and the store of tile k - 1
    // has read its buffer, which the next copy refills
    __syncthreads();
    const int kn = k + kBufs - 1;
    if (kn < n_tiles)
      stage<kVec>(ring + (kn % kBufs) * kTile, y, b0, rows, T, kn * kSteps,
                  min(kSteps, T - kn * kSteps));
    cp_async_commit();
    if (active) {
      for (int w0 = 0; w0 < steps; w0 += 4) {
        float4* at = reinterpret_cast<float4*>(tile + tile_at(threadIdx.x, w0));
        float v[4] = {at->x, at->y, at->z, at->w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (w0 + j < steps) {
            const int next = phase + 1 == period ? 0 : phase + 1;
            // the next step's slot, read before this step's store
            float pre = 0.0f;
            if (t0 + w0 + j + 1 >= period)
              pre = season[static_cast<size_t>(next) * stride];
            const float yj = v[j];
            v[j] = (level + trend) + s_cur;
            float s = s_cur;
            hw_step(level, trend, s, yj, c);
            season[static_cast<size_t>(phase) * stride] = s;
            s_cur = period == 1 ? s : pre;
            phase = next;
          }
        }
        *at = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();              // every row of tile k holds forecasts
    store<kVec>(tile, out, b0, rows, T, t0, steps);
  }
}

template <bool kShared, bool kVec>
void launch(const float* y, float* out, float* season_scratch, int B, int T,
            int period, HWCoeffs c, cudaStream_t stream) {
  const int grid = (B + kSeries - 1) / kSeries;
  const size_t smem =
      sizeof(float) * (kBufs * kTile + (kShared ? period * kSeries : 0));
  if (smem > 48 * 1024)  // periods above 64: 56 KB at 96
    cudaFuncSetAttribute(holt_winters_kernel<kShared, kVec>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  holt_winters_kernel<kShared, kVec><<<grid, kSeries, smem, stream>>>(
      y, out, season_scratch, B, T, period, c);
}

}  // namespace

void holt_winters_launch(const float* y, float* out, float* season_scratch,
                         int B, int T, int period, bool shared_season,
                         bool vec16, HWCoeffs c, cudaStream_t stream) {
  if (shared_season) {
    if (vec16)
      launch<true, true>(y, out, season_scratch, B, T, period, c, stream);
    else
      launch<true, false>(y, out, season_scratch, B, T, period, c, stream);
  } else if (vec16) {
    launch<false, true>(y, out, season_scratch, B, T, period, c, stream);
  } else {
    launch<false, false>(y, out, season_scratch, B, T, period, c, stream);
  }
}

bool holt_winters_vec16_ok(const float* y, const float* out, int T) {
  return T % 4 == 0 && reinterpret_cast<std::uintptr_t>(y) % 16 == 0 &&
         reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
}

}  // namespace repro_torch
