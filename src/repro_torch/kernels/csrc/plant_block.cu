// plant_block: advance B cluster-plant lanes through the n decision-free
// ticks of one control period.
//
// Replaces the Pallas TPU kernel src/repro/kernels/plant_block.py
// (plant_block_kernel, body _kernel). Plain version:
// repro_torch/sim/cluster.py::plant_block_ref.
//
// Design: one thread per lane, the seven state scalars in registers, the
// tick loop inside the thread. Inside a decision-free block the startup
// pipeline is only ever popped, so the ring's head is the tick index: tick
// t reads slot t of the lane's input row (zero once t >= S) and nothing
// shifts until the block ends, when the row is written once in the
// reference's shifted layout. Per-tick outputs are laid out [7, T, B], so
// each tick's stores coalesce across the warp.
//
// Bound on the H100: bytes. Per lane and tick the kernel does ~36 f32
// operations (4 IEEE divisions among them) against 28 bytes of per-tick
// output, far below the card's operations-per-byte ridge.
#include "plant.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;

__global__ void plant_block_kernel(
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
                        int T, PlantCfg cfg, cudaStream_t stream) {
  const int grid = (B + kThreads - 1) / kThreads;
  plant_block_kernel<<<grid, kThreads, 0, stream>>>(
      ready, pipeline, queue, wait_sum, util_ema, cooldown, pipe_sum,
      arrivals, ready_out, pipeline_out, queue_out, wait_sum_out,
      util_ema_out, cooldown_out, pipe_sum_out, ticks, B, S, T, cfg);
}

}  // namespace repro_torch
