// Launchers of the port's CUDA kernels, shared by the binding (binding.cpp)
// and the kernel sources. Plain C++: no PyTorch header is needed here, so
// nvcc compiles the .cu files in seconds.
#pragma once

#include <cuda_runtime_api.h>

#include <cstddef>

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
// (served, violated, cold, total, resp, util, ready). kPlantStaged:
// blocks of `lanes` (32, 64 or 128) lanes stage the popped slots `chunk`
// ticks at a time, lanes * (chunk | 1) <= kPlantPopFloats; kPlantEmpty:
// the same launch with an empty body (the launch's own time);
// kPlantPerThread: the per-thread kernel it replaced, 128 lanes a block.
constexpr int kPlantPopFloats = 8192;
enum PlantVariant { kPlantStaged = 0, kPlantPerThread = 1, kPlantEmpty = 2 };
void plant_block_launch(const float* ready, const float* pipeline,
                        const float* queue, const float* wait_sum,
                        const float* util_ema, const float* cooldown,
                        const float* pipe_sum, const float* arrivals,
                        float* ready_out, float* pipeline_out,
                        float* queue_out, float* wait_sum_out,
                        float* util_ema_out, float* cooldown_out,
                        float* pipe_sum_out, float* ticks, int B, int S,
                        int T, PlantVariant variant, int lanes,
                        int chunk, PlantCfg cfg, cudaStream_t stream);

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

// The frequency features' real FFT (core/features.py::rfft_plan): up to
// kMaxFftPasses radix passes in the order they run, pass q of radix ip[q]
// over l1[q] x ido[q] with its twiddles at tw + off[q]; and the f32
// multipliers 1 / log(W/2) and 1 / (W/2).
constexpr int kMaxFftPasses = 6;
struct FreqTables {
  const float* tw;
  int n_pass;
  int ip[kMaxFftPasses], l1[kMaxFftPasses], ido[kMaxFftPasses],
      off[kMaxFftPasses];
  float inv_log_nb, inv_nb;
};

// The window_features kernel's variants (window_features.cu) and their
// widest windows: the generic variant's local arrays hold kMaxWindow
// samples, the wide variant takes up to kMaxWideWindow
// (_numerics.MAX_TERMS: XLA's summation order is reproduced that far).
enum WfVariant { kWfW60 = 0, kWfGeneric = 1, kWfWide = 2 };
constexpr int kMaxWindow = 64;
constexpr int kMaxWideWindow = 1024;

// Beta calibration's a = softplus(a_raw), b = softplus(b_raw) and c, [K].
struct CalCoeffs {
  const float* a;
  const float* b;
  const float* c;
};

// Holt-Winters smoothing coefficients: alpha, beta, gamma and 1 - each
struct HWCoeffs {
  float alpha, beta, gamma, one_m_alpha, one_m_beta, one_m_gamma;
};

// The in-episode forecasters of forecast/models.py (forecasters.cuh), by
// kind, and their run-time hyperparameters as the pre-pass takes them.
enum FcKind { kHoltWinters = 0, kLinearTrend = 1, kSeasonalNaive = 2,
              kEwma = 3 };
struct FcHyper {
  int kind;          // FcKind: picks the minute walks' template
  int slots;         // rows of the [slots, B] scratch: the period
                     // (holt_winters, seasonal_naive), the window
                     // (linear_trend), 0 (ewma)
  float resid_rho;   // forecast/api.py RESID_RHO
  HWCoeffs hw;       // holt_winters
  float alpha;       // ewma
  // linear_trend: f32 1 / window, the OLS constants tbar and tvar, and
  // the step (window - 1) - tbar + h to the forecast minute at h = 1 and
  // at the policy's horizon
  float inv_n, tbar, tvar, step_1, step_h;
};

// scaling/policies.py::aapa_controller's minute hook, as the pre-pass runs
// it with any registry forecaster.
struct AAPAHyper {
  // Table III by class id (core/archetypes.py::table_iii_arrays)
  float target_cpu[4], cooldown_min[4], min_replicas[4];
  int stride_min, horizon_min;
  int forecast_confidence;     // Algorithm 1 conf *= interval confidence
  FcHyper fc;
  float z, sqrt_h;  // native band half-width z * resid * sqrt(horizon)
  // a conformal band (forecast/conformal.py): half-width band_q * sqrt_h
  // (sqrt_h 1 for a band that does not widen)
  int use_band;
  float band_q;
  // confidence scale max(band_scale, 1) in place of max(point, 1): the
  // scale of the band passed as aapa_controller's `band`
  int use_scale;
  float band_scale;
  // linear trend over the last 30 minutes: tbar, tvar and the step
  // (29 - tbar + horizon) to the forecast minute
  float trend_tbar, trend_tvar, trend_step;
  // 0: constant STATIONARY_NOISY at 0.5; 1: the reclassification's
  // archetype and confidence (reclassify_launch) at each slot
  int classify;
};

// scaling/policies.py::predictive_controller's forecast need with any
// registry forecaster, as the pre-pass runs it
struct PredictiveHyper {
  FcHyper fc;
  int horizon_min;
  float z, sqrt_h;      // native band half-width z * resid * sqrt(horizon)
  int use_band;         // a conformal band's q * sqrt_h instead
  float band_q;
  int conservative;     // scale to the band's upper edge, not the point
  float inv_cap;        // f32 reciprocal of rps_per_replica * target
};

// What the plant pass's decide reads of each policy's hyperparameters
// (the rest went into the pre-pass's signals):
// scaling/policies.py::aapa_decide: Table III's warm pool by class id,
// rps_per_replica, and the reclassification stride
struct AAPAPlantHyper {
  float warm_pool[4];
  float rps_per_replica;
  int stride_min;
};

// scaling/policies.py::hybrid_guard around AAPA's decide: f32 reciprocals
// of guard_target and rps_per_replica * guard_target, f32(1 -
// max_down_frac)
struct HybridPlantHyper {
  AAPAPlantHyper aapa;
  float inv_guard, inv_rps_guard, down_keep;
};

// scaling/policies.py::predictive_decide
struct PredictivePlantHyper {
  float inv_cap;        // f32 reciprocal of rps_per_replica * target
  float cooldown_sec;
};

// The pre-pass's signals as the plant pass reads them, laid out so that a
// warp's reads at one minute coalesce: rps [K, M, B], what decide reads
// during minute m (AAPA and hybrid: fc_rps, trend_rps, mean_rps; predictive:
// need_pred); arch [R, B] and adj [3, R, B] (cpu_adj, cool_adj_min,
// minrep_adj), the archetype and Algorithm 1's parameters in effect from
// minute r * stride_min (slot 0: the initial state), R = M / stride + 1.
struct PolicySignals {
  const float* rps;
  const int* arch;
  const float* adj;
  int R;
};

// scaling/policies.py::kpa_controller
struct KPAHyper {
  float service_sec;        // Little's law: queue + rate * service time
  float a_s, a_p;           // f32(min(dt / window, 1)) of both EMAs
  float inv_tgt;            // f32 reciprocal of the target concurrency
  float panic_threshold, stable_window_s, dt, cooldown_sec;
};

// y [B, T] -> out [B, T] one-step-ahead forecasts. shared_season (period
// <= kHWSharedPeriodMax): each block's seasons in shared memory; otherwise
// season_scratch [period, B] holds them. vec16 (holt_winters_vec16_ok):
// 16-B copies of y and out, else 4-B ones.
constexpr int kHWSharedPeriodMax = 96;
void holt_winters_launch(const float* y, float* out, float* season_scratch,
                         int B, int T, int period, bool shared_season,
                         bool vec16, HWCoeffs c, cudaStream_t stream);
bool holt_winters_vec16_ok(const float* y, const float* out, int T);

// The pre-pass (policy_signals.cu). AAPA and hybrid: rates [B, M] ->
// signals rps [3, M, B], arch [R, B], adj [3, R, B] and, when minute_arch
// is not null, the archetype each lane carries after each minute into
// minute_arch [B, M]. cls_arch and cls_conf [B, R - 1] hold slot r's
// archetype and confidence at column r - 1 (reclassify_launch's output,
// read only when the hyperparameters' classify is 1); scratch the
// forecaster's [hyper.fc.slots, B].
void policy_signals_aapa_launch(const float* rates, float* rps, int* arch,
                                float* adj, int* minute_arch,
                                const int* cls_arch, const float* cls_conf,
                                float* scratch, int B, int M,
                                AAPAHyper hyper, cudaStream_t stream);
// The AAPA and hybrid reclassifications (policy_signals.cu): for every
// lane b and slot r in [1, R), the window of W minutes of rates [B, M]
// before minute r * stride (zero before minute 0) -> its 38 features
// feats [B * (R - 1), 38] (window_features_slots_launch, kernel `variant`
// at W, the FFT plan freq), their GBDT logits logits [B * (R - 1), 4]
// (gbdt_tables_launch, tables in shared memory when gbdt_shared), then
// softmax, beta calibration and argmax -> cls_arch, cls_conf [B, R - 1].
void reclassify_launch(const float* rates, float* feats, float* logits,
                       int* cls_arch, float* cls_conf, int B, int M, int R,
                       int stride, int W, const FreqTables& freq,
                       WfVariant variant, const GBDTTables& gbdt,
                       bool gbdt_shared, CalCoeffs cal, cudaStream_t stream);
// Predictive: rates [B, M] -> need [M, B]; the forecaster's scratch
// [hyper.fc.slots, B].
void policy_signals_predictive_launch(const float* rates, float* need,
                                      float* scratch, int B, int M,
                                      PredictiveHyper hyper,
                                      cudaStream_t stream);

// The plant pass (episode_block.cu): rates [B, M] -> out [12, B, M]
// (MinuteOut field order), reading the pre-pass's signals where the policy
// has them. Its dynamic shared memory, which holds the startup pipeline
// (S slots) and the policy's ring (HPA's window: buf_len slots), is
// episode_smem_bytes(S, ring_len) per block of 32 lanes.
int episode_smem_bytes(int S, int ring_len);
void episode_block_hpa_launch(const float* rates, float* out, int B, int M,
                              EpisodeCfg cfg, HPAHyper hyper,
                              cudaStream_t stream);
void episode_block_kpa_launch(const float* rates, float* out, int B, int M,
                              EpisodeCfg cfg, KPAHyper hyper,
                              cudaStream_t stream);
void episode_block_predictive_launch(const float* rates, float* out,
                                     PolicySignals sig, int B, int M,
                                     EpisodeCfg cfg,
                                     PredictivePlantHyper hyper,
                                     cudaStream_t stream);
void episode_block_aapa_launch(const float* rates, float* out,
                               PolicySignals sig, int B, int M,
                               EpisodeCfg cfg, AAPAPlantHyper hyper,
                               cudaStream_t stream);
void episode_block_hybrid_launch(const float* rates, float* out,
                                 PolicySignals sig, int B, int M,
                                 EpisodeCfg cfg, HybridPlantHyper hyper,
                                 cudaStream_t stream);

// windows [N, W] (3 <= W <= 1,024) -> features [N, 28]; with freq (the
// FFT plan for W, W >= 4) all 38 features [N, 38]. variant: kWfW60, the
// kernel compiled for W == 60 (its FFT plan kW60Plan); kWfGeneric, W <=
// kMaxWindow (64), scratch in local arrays; kWfWide, any W, one window a
// group of lanes in shared memory.
constexpr int kW60 = 60;
constexpr int kW60Passes = 3;
constexpr int kW60Plan[kW60Passes][3] = {{5, 12, 1}, {3, 4, 5}, {4, 1, 15}};
void window_features_launch(const float* windows, float* out, int N, int W,
                            const FreqTables* freq, WfVariant variant,
                            cudaStream_t stream);
// The same kernels on the AAPA pre-pass's windows, read in place from
// rates [B, M]: window n = b * (R - 1) + r - 1, for r in [1, R), is the W
// minutes before minute r * stride, zero before minute 0 -> out [B * (R -
// 1), 38].
void window_features_slots_launch(const float* rates, float* out, int B,
                                  int M, int R, int stride, int W,
                                  const FreqTables& freq, WfVariant variant,
                                  cudaStream_t stream);

// X [N, n_features] -> logits [N, n_classes]. shared: the node tables in
// shared memory, for ensembles whose gbdt_shared_table_bytes are at most
// kGBDTSharedTableMax; otherwise the per-thread kernel of gbdt.cuh.
constexpr size_t kGBDTSharedTableMax = 104 * 1024;
size_t gbdt_shared_table_bytes(int n_trees, int depth);
void gbdt_tables_launch(const float* X, float* out, int N, GBDTTables g,
                        bool shared, cudaStream_t stream);

}  // namespace repro_torch
