// Device-side plant tick shared by plant_block.cu and episode_block.cu.
//
// `flow_tick` is src/repro/sim/cluster.py::_flow_tick op for op, in the
// same order. The build passes -fmad=false and no fast-math flag, so every
// product and quotient rounds on its own (IEEE `/`, through fdiv where a
// zero dividend is common: an idle queue, no arrivals) and agrees bit for
// bit with the plain PyTorch version (repro_torch/sim/cluster.py), which
// runs one rounding per op as well.
#pragma once

#include "kernels.h"
#include "numerics.cuh"

namespace repro_torch {

constexpr float kEps = 1e-9f;

struct TickOut {
  float served, violated, cold, resp, util;
};

__device__ __forceinline__ TickOut flow_tick(const PlantCfg& c, float ready,
                                             float& queue, float& wait_sum,
                                             float& util_ema,
                                             float arrivals) {
  const float throughput = ready * c.rps_per_replica;
  const float work = queue + arrivals;
  const float served = fminf(work, throughput);
  const float new_queue = work - served;
  const float wait_aged = wait_sum + queue;
  const float work_c = fmaxf(work, kEps);
  const float mean_age = fdiv(wait_aged, work_c);
  wait_sum = fdiv(wait_aged * new_queue, work_c);
  const float thr_c = fmaxf(throughput, kEps);
  const float util = fdiv(served, thr_c);
  float resp = c.service_sec / fmaxf(1.0f - util, 0.05f) + mean_age +
               fdiv(0.5f * new_queue, thr_c);
  resp = fminf(resp, c.resp_cap_sec);
  resp = served > 0.0f ? resp : 0.0f;
  TickOut t;
  t.served = served;
  t.violated = resp > c.slo_sec ? served : 0.0f;
  t.cold = ready < 0.5f ? arrivals : 0.0f;
  t.resp = resp;
  t.util = util;
  util_ema = util_ema + (util - util_ema) * c.inv_tau;
  queue = new_queue;
  return t;
}

}  // namespace repro_torch
