// plant_block: advance B cluster-plant lanes through the n decision-free
// ticks of one control period.
//
// Replaces the Pallas TPU kernel src/repro/kernels/plant_block.py
// (plant_block_kernel, body _kernel). Plain version:
// repro_torch/sim/cluster.py::plant_block_ref.
//
// Design: one thread per lane, the seven state scalars in registers, the
// tick loop inside the thread (plant.cuh::flow_tick, in the reference's
// order). Inside a decision-free block the startup pipeline is only ever
// popped, so the ring's head is the tick index: tick t pops slot t of the
// lane's input row (zero once t >= S) and nothing shifts until the block
// ends, when the row is written once in the reference's shifted layout.
// Per-tick outputs are laid out [7, T, B], so each tick's stores coalesce
// across the warp. The pipeline's [B, S] rows never go through a thread
// one by one:
//
// * The shifted write-back pipeline_out[b, j] = j + T < S ?
//   pipeline[b, j + T] : 0 is a flat copy of the block's contiguous
//   [lanes, S] span, done by the whole block before the ticks start:
//   neighbouring threads take neighbouring floats, stored 16 B a thread
//   where the span is 16-B aligned.
// * The popped slots, the first min(T, S) of each row, are staged into
//   shared memory with coalesced cp.async copies before the ticks that pop
//   them (the first chunk's in flight during the write-back), in chunks
//   of `chunk` ticks (rows of chunk | 1 floats, an odd stride, so a tick's
//   reads hit distinct banks): every chunk at once wherever
//   lanes x min(T, S) fits kPlantPopFloats (the launcher's choice,
//   kernels/plant_block.py::pop_chunk). No tick waits on device memory.
// * The lanes per block (32, 64 or 128) are the launcher's choice from B
//   (kernels/plant_block.py::choose_lanes): 128 wherever that still gives
//   every SM a block, fewer below, so 1024 lanes run as 32 blocks of 32
//   on 32 SMs, not 8 blocks on 8.
//
// Bound on the H100: bytes. Per lane and tick the kernel does ~36 f32
// operations (4 IEEE divisions among them) against 28 bytes of per-tick
// output, far below the card's operations-per-byte ridge. At 1024 lanes
// the launch itself is most of the time: plant_block_kernel<true>, the
// same launch with an empty body, gives that floor (chip_smoke.py phase 6).
//
// plant_block_per_thread_kernel, the kernel this design replaced (each
// thread pops its slots from device memory tick by tick and writes its
// own shifted row), stays as the variant the staged kernel is held
// against bit for bit and timed beside.
#include <cstdint>

#include "plant.cuh"

namespace repro_torch {
namespace {

constexpr int kShiftBatch = 4;  // write-back: 16-B groups a thread loads
                                // before it stores

// (row, column) of a flat index into rows of `width` floats, advanced by
// a fixed step without a division per element
struct FlatWalk {
  int row, col, step_row, step_col, width;
  __device__ FlatWalk(int e, int step, int w)
      : row(e / w), col(e % w), step_row(step / w), step_col(step % w),
        width(w) {}
  __device__ void next() {
    row += step_row;
    col += step_col;
    if (col >= width) col -= width, ++row;
  }
  __device__ void next1() {
    if (++col == width) col = 0, ++row;
  }
};

// a 4-B copy from device to shared memory that no register waits on
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const auto s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// the popped slots of ticks c0 .. c0 + width - 1 of the block's rows into
// pop (rows of `stride` floats), neighbouring threads on neighbouring
// slots, in flight until cp_async_wait_all
__device__ __forceinline__ void stage_pops(const float* span, float* pop,
                                           int rows, int S, int c0,
                                           int width, int stride) {
  const int tid = threadIdx.x, lanes = blockDim.x;
  FlatWalk at(tid, lanes, width);
  for (int e = tid; e < rows * width; e += lanes, at.next())
    cp_async4(pop + at.row * stride + at.col,
              span + static_cast<size_t>(at.row) * S + c0 + at.col);
}

// dst[e] = col(e) + T < S ? src[e + T] : 0 over a span of n floats that
// starts at a row boundary (rows of S floats). Each thread loads
// kShiftBatch 16-B groups before it stores any, so their loads share one
// round trip to memory.
__device__ __forceinline__ void shift_rows(const float* __restrict__ src,
                                           float* __restrict__ dst, int n,
                                           int S, int T) {
  const int tid = threadIdx.x, lanes = blockDim.x;
  int done = 0;
  if (reinterpret_cast<std::uintptr_t>(dst) % 16 == 0) {
    const int n4 = n / 4;
    FlatWalk at(4 * tid, 4 * lanes, S);
    for (int q0 = tid; q0 < n4; q0 += kShiftBatch * lanes) {
      float v[kShiftBatch][4];
#pragma unroll
      for (int i = 0; i < kShiftBatch; ++i, at.next()) {
        const int q = q0 + i * lanes;
        FlatWalk e = at;
#pragma unroll
        for (int j = 0; j < 4; ++j, e.next1())
          v[i][j] = q < n4 && e.col + T < S ? __ldg(src + 4 * q + j + T)
                                            : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kShiftBatch; ++i) {
        const int q = q0 + i * lanes;
        if (q < n4)
          reinterpret_cast<float4*>(dst)[q] =
              make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
      }
    }
    done = n4 * 4;
  }
  for (int e = done + tid; e < n; e += lanes)
    dst[e] = e % S + T < S ? __ldg(src + e + T) : 0.0f;
}

template <bool kEmpty>
__global__ void plant_block_kernel(
    const float* __restrict__ ready_in, const float* __restrict__ pipeline,
    const float* __restrict__ queue_in, const float* __restrict__ wait_in,
    const float* __restrict__ ema_in, const float* __restrict__ cool_in,
    const float* __restrict__ ps_in, const float* __restrict__ arrivals,
    float* __restrict__ ready_out, float* __restrict__ pipeline_out,
    float* __restrict__ queue_out, float* __restrict__ wait_out,
    float* __restrict__ ema_out, float* __restrict__ cool_out,
    float* __restrict__ ps_out, float* __restrict__ ticks, int B, int S,
    int T, int chunk, PlantCfg cfg) {
  if (kEmpty) return;
  extern __shared__ float pop[];  // [lanes][chunk | 1]
  const int tid = threadIdx.x, lanes = blockDim.x;
  const int b0 = blockIdx.x * lanes, rows = min(lanes, B - b0);
  const int b = b0 + tid;
  const bool active = tid < rows;
  float ready = 0.0f, queue = 0.0f, wait = 0.0f, ema = 0.0f, cool = 0.0f;
  float ps = 0.0f, arr = 0.0f;
  if (active) {
    ready = ready_in[b], queue = queue_in[b], wait = wait_in[b];
    ema = ema_in[b], cool = cool_in[b], ps = ps_in[b], arr = arrivals[b];
  }
  const float* span = pipeline + static_cast<size_t>(b0) * S;
  const int popped_ticks = min(T, S), stride = chunk | 1;
  // the first chunk's slots fly in while the block writes the shifted rows
  stage_pops(span, pop, rows, S, 0, min(chunk, popped_ticks), stride);
  shift_rows(span, pipeline_out + static_cast<size_t>(b0) * S, rows * S, S,
             T);

  const size_t plane = static_cast<size_t>(T) * B;
  auto tick = [&](int t, float popped) {
    ready = ready + popped;
    ps = fmaxf(ps - popped, 0.0f);
    const TickOut k = flow_tick(cfg, ready, queue, wait, ema, arr);
    cool = fmaxf(cool - 1.0f, 0.0f);
    float* o = ticks + static_cast<size_t>(t) * B + b;
    o[0] = k.served;
    o[plane] = k.violated;
    o[2 * plane] = k.cold;
    o[3 * plane] = ready + ps;
    o[4 * plane] = k.resp;
    o[5 * plane] = k.util;
    o[6 * plane] = ready;
  };
  int t = 0;
  for (int c0 = 0; c0 < popped_ticks; c0 += chunk) {
    const int width = min(chunk, popped_ticks - c0);
    if (c0 > 0) {
      __syncthreads();  // every tick of the last chunk popped
      stage_pops(span, pop, rows, S, c0, width, stride);
    }
    cp_async_wait_all();
    __syncthreads();
    if (active)
      for (; t < c0 + width; ++t) tick(t, pop[tid * stride + t - c0]);
  }
  if (!active) return;
  for (; t < T; ++t) tick(t, 0.0f);

  ready_out[b] = ready;
  queue_out[b] = queue;
  wait_out[b] = wait;
  ema_out[b] = ema;
  cool_out[b] = cool;
  ps_out[b] = ps;
}

// The per-thread kernel the staged one replaced, kept as its comparison:
// each thread pops its own row's slots from device memory tick by tick
// and writes its shifted row back, 128 lanes a block.
__global__ void plant_block_per_thread_kernel(
    const float* __restrict__ ready_in, const float* __restrict__ pipeline,
    const float* __restrict__ queue_in, const float* __restrict__ wait_in,
    const float* __restrict__ ema_in, const float* __restrict__ cool_in,
    const float* __restrict__ ps_in, const float* __restrict__ arrivals,
    float* __restrict__ ready_out, float* __restrict__ pipeline_out,
    float* __restrict__ queue_out, float* __restrict__ wait_out,
    float* __restrict__ ema_out, float* __restrict__ cool_out,
    float* __restrict__ ps_out, float* __restrict__ ticks, int B, int S,
    int T, PlantCfg cfg) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float ready = ready_in[b], queue = queue_in[b], wait = wait_in[b];
  float ema = ema_in[b], cool = cool_in[b], ps = ps_in[b];
  const float arr = arrivals[b];
  const float* row = pipeline + static_cast<size_t>(b) * S;
  const size_t plane = static_cast<size_t>(T) * B;

  for (int t = 0; t < T; ++t) {
    const float popped = t < S ? row[t] : 0.0f;
    ready = ready + popped;
    ps = fmaxf(ps - popped, 0.0f);
    const TickOut k = flow_tick(cfg, ready, queue, wait, ema, arr);
    cool = fmaxf(cool - 1.0f, 0.0f);
    float* o = ticks + static_cast<size_t>(t) * B + b;
    o[0] = k.served;
    o[plane] = k.violated;
    o[2 * plane] = k.cold;
    o[3 * plane] = ready + ps;
    o[4 * plane] = k.resp;
    o[5 * plane] = k.util;
    o[6 * plane] = ready;
  }

  ready_out[b] = ready;
  queue_out[b] = queue;
  wait_out[b] = wait;
  ema_out[b] = ema;
  cool_out[b] = cool;
  ps_out[b] = ps;
  float* out_row = pipeline_out + static_cast<size_t>(b) * S;
  for (int j = 0; j < S; ++j) out_row[j] = j + T < S ? row[j + T] : 0.0f;
}

}  // namespace

void plant_block_launch(const float* ready, const float* pipeline,
                        const float* queue, const float* wait_sum,
                        const float* util_ema, const float* cooldown,
                        const float* pipe_sum, const float* arrivals,
                        float* ready_out, float* pipeline_out,
                        float* queue_out, float* wait_sum_out,
                        float* util_ema_out, float* cooldown_out,
                        float* pipe_sum_out, float* ticks, int B, int S,
                        int T, PlantVariant variant, int lanes,
                        int chunk, PlantCfg cfg, cudaStream_t stream) {
  const int grid = (B + lanes - 1) / lanes;
  if (variant == kPlantPerThread) {
    plant_block_per_thread_kernel<<<grid, lanes, 0, stream>>>(
        ready, pipeline, queue, wait_sum, util_ema, cooldown, pipe_sum,
        arrivals, ready_out, pipeline_out, queue_out, wait_sum_out,
        util_ema_out, cooldown_out, pipe_sum_out, ticks, B, S, T, cfg);
    return;
  }
  const size_t smem = sizeof(float) * lanes * (chunk | 1);
  auto kernel = variant == kPlantEmpty ? plant_block_kernel<true>
                                       : plant_block_kernel<false>;
  kernel<<<grid, lanes, smem, stream>>>(
      ready, pipeline, queue, wait_sum, util_ema, cooldown, pipe_sum,
      arrivals, ready_out, pipeline_out, queue_out, wait_sum_out,
      util_ema_out, cooldown_out, pipe_sum_out, ticks, B, S, T, chunk, cfg);
}

}  // namespace repro_torch
