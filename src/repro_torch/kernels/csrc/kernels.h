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

// A GBDT ensemble's flattened node tables (core/gbdt.py::NodeTables) on
// the card; tree t = round * n_classes + class.
struct GBDTTables {
  const float* edges;   // [n_features, n_edges] bin edges, non-decreasing
  const int* feat;      // [n_trees, 2^depth - 1] split feature ids
  const int* thresh;    // [n_trees, 2^depth - 1] split bins (right if >)
  const float* leaf;    // [n_trees, 2^depth] leaf values
  const float* base;    // [n_classes] base logits
  int n_features, n_edges, n_trees, n_classes, depth;
};

// The frequency features' real DFT: dft [2, W/2 + 1, W] f32 cos and sin
// tables, and the f32 multipliers 1 / log(W/2) and 1 / (W/2).
struct FreqTables {
  const float* dft;
  float inv_log_nb, inv_nb;
};

// Beta calibration's a = softplus(a_raw), b = softplus(b_raw) and c, [K].
struct CalCoeffs {
  const float* a;
  const float* b;
  const float* c;
};

// scaling/policies.py::aapa_controller with the Holt-Winters forecaster.
struct AAPAHyper {
  // Table III by class id (core/archetypes.py::table_iii_arrays)
  float target_cpu[4], cooldown_min[4], min_replicas[4], warm_pool[4];
  float rps_per_replica;
  int stride_min, horizon_min;
  int forecast_confidence;     // Algorithm 1 conf *= interval confidence
  // Holt-Winters: alpha, beta, gamma and f32(1 - each); period slots
  float alpha, beta, gamma, one_m_alpha, one_m_beta, one_m_gamma;
  int period;
  float resid_rho, z, sqrt_h;  // residual EWMA, native band half-width
  // linear trend over the last 30 minutes: tbar, tvar and the step
  // (29 - tbar + horizon) to the forecast minute
  float trend_tbar, trend_tvar, trend_step;
  int classify;  // 0: constant STATIONARY_NOISY at 0.5, 1: GBDT + cal
  GBDTTables gbdt;
  CalCoeffs cal;
  FreqTables freq;
};

// rates [B, M] -> out [12, B, M], and, when arch_out is not null, the
// archetype each lane carries after each minute into arch_out [B, M].
// Scratch: pipe [S, B] startup-pipeline ring, scratch [60 + period, B]:
// the rate-history ring, then the Holt-Winters season.
void episode_block_aapa_launch(const float* rates, float* out, float* pipe,
                               float* scratch, int* arch_out, int B, int M,
                               EpisodeCfg cfg, AAPAHyper hyper,
                               cudaStream_t stream);

// windows [N, W] (3 <= W <= 64) -> features [N, 28]; with freq (the DFT
// table for W, 4 <= W <= 64) all 38 features [N, 38]
void window_features_launch(const float* windows, float* out, int N, int W,
                            const FreqTables* freq, cudaStream_t stream);

// X [N, n_features] -> logits [N, n_classes]
void gbdt_tables_launch(const float* X, float* out, int N, GBDTTables g,
                        cudaStream_t stream);

}  // namespace repro_torch
