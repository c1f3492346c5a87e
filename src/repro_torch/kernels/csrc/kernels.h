// Launchers of the port's CUDA kernels, shared by the binding (binding.cpp)
// and the kernel sources. Plain C++: no PyTorch header is needed here, so
// nvcc compiles the .cu files in seconds.
#pragma once

#include <cuda_runtime_api.h>

namespace repro_torch {

// SimConfig's plant constants; inv_tau is the f32 reciprocal of
// metric_tau_sec (the reference's `/ metric_tau_sec` compiles to it).
struct PlantCfg {
  float rps_per_replica;
  float service_sec;
  float slo_sec;
  float resp_cap_sec;
  float inv_tau;
};

struct EpisodeCfg {
  PlantCfg plant;
  float max_replicas;
  float initial_replicas;
  int startup_sec;  // S, pipeline slots
  int ci;           // control interval, seconds, in [1, 60]
};

// scaling/policies.py::hpa_controller hyperparameters
struct HPAHyper {
  float inv_target;    // f32 reciprocal of target
  float tolerance;
  float cooldown_sec;  // cooldown_min * 60
  int buf_len;         // stabilization window, in decisions
};

// Outputs: 7 state arrays [B], pipeline_out [B, S] and ticks [7, T, B]
// (served, violated, cold, total, resp, util, ready).
void plant_block_launch(const float* ready, const float* pipeline,
                        const float* queue, const float* wait_sum,
                        const float* util_ema, const float* cooldown,
                        const float* pipe_sum, const float* arrivals,
                        float* ready_out, float* pipeline_out,
                        float* queue_out, float* wait_sum_out,
                        float* util_ema_out, float* cooldown_out,
                        float* pipe_sum_out, float* ticks, int B, int S,
                        int T, PlantCfg cfg, cudaStream_t stream);

// rates [B, M] -> out [12, B, M] (MinuteOut field order). Scratch:
// pipe [S, B] startup-pipeline ring, buf [buf_len, B] HPA window ring.
void episode_block_hpa_launch(const float* rates, float* out, float* pipe,
                              float* buf, int B, int M, EpisodeCfg cfg,
                              HPAHyper hyper, cudaStream_t stream);

}  // namespace repro_torch
