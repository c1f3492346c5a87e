// Python binding of the port's CUDA kernels: the one source that includes
// PyTorch's headers. Each entry checks what it hands to a kernel, launches
// it on the current stream and checks the launch (a refused launch never
// runs, and a later synchronize would not report it).
#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

#include <vector>

#include "kernels.h"

namespace {

void check(const torch::Tensor& t, const char* name,
           const std::vector<int64_t>& shape) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == torch::kFloat32, name, " must be float32");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK(t.sizes() == c10::IntArrayRef(shape), name, " has shape ",
              t.sizes(), ", expected ", c10::IntArrayRef(shape));
}

void check_i32(const torch::Tensor& t, const char* name,
               const std::vector<int64_t>& shape) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == torch::kInt32, name, " must be int32");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK(t.sizes() == c10::IntArrayRef(shape), name, " has shape ",
              t.sizes(), ", expected ", c10::IntArrayRef(shape));
}

const float* in(const torch::Tensor& t) { return t.data_ptr<float>(); }
float* out(torch::Tensor& t) { return t.data_ptr<float>(); }

repro_torch::PlantCfg plant_cfg(double rps, double service, double slo,
                                double cap, double inv_tau) {
  return {static_cast<float>(rps), static_cast<float>(service),
          static_cast<float>(slo), static_cast<float>(cap),
          static_cast<float>(inv_tau)};
}

// inputs: ready, queue, wait_sum, util_ema, cooldown, pipe_sum, arrivals
// [B] and pipeline [B, S]; outputs: the same six state arrays [B],
// pipeline_out [B, S] and ticks [7, T, B]
void plant_block(std::vector<torch::Tensor> state, torch::Tensor pipeline,
                 std::vector<torch::Tensor> state_out,
                 torch::Tensor pipeline_out, torch::Tensor ticks,
                 double rps, double service, double slo, double cap,
                 double inv_tau) {
  TORCH_CHECK(state.size() == 7 && state_out.size() == 6,
              "plant_block takes 7 state inputs and 6 state outputs");
  TORCH_CHECK(pipeline.dim() == 2 && ticks.dim() == 3,
              "pipeline must be [B, S] and ticks [7, T, B]");
  const int64_t B = pipeline.size(0), S = pipeline.size(1);
  const int64_t T = ticks.size(1);
  TORCH_CHECK(B > 0 && S > 0 && T > 0, "empty plant block");
  for (auto& t : state) check(t, "plant state", {B});
  for (auto& t : state_out) check(t, "plant state output", {B});
  check(pipeline, "pipeline", {B, S});
  check(pipeline_out, "pipeline_out", {B, S});
  check(ticks, "ticks", {7, T, B});
  const c10::cuda::CUDAGuard guard(pipeline.device());
  repro_torch::plant_block_launch(
      in(state[0]), in(pipeline), in(state[1]), in(state[2]), in(state[3]),
      in(state[4]), in(state[5]), in(state[6]), out(state_out[0]),
      out(pipeline_out), out(state_out[1]), out(state_out[2]),
      out(state_out[3]), out(state_out[4]), out(state_out[5]), out(ticks),
      static_cast<int>(B), static_cast<int>(S), static_cast<int>(T),
      plant_cfg(rps, service, slo, cap, inv_tau),
      at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// rates [B, M] -> out [12, B, M]; scratch pipe [S, B] and buf [buf_len, B]
void episode_block_hpa(torch::Tensor rates, torch::Tensor out_,
                       torch::Tensor pipe, torch::Tensor buf, int64_t ci,
                       double rps, double service, double slo, double cap,
                       double inv_tau, double max_replicas,
                       double initial_replicas, double inv_target,
                       double tolerance, double cooldown_sec) {
  TORCH_CHECK(rates.dim() == 2 && pipe.dim() == 2 && buf.dim() == 2,
              "rates, pipe and buf must be 2-d");
  const int64_t B = rates.size(0), M = rates.size(1);
  const int64_t S = pipe.size(0), L = buf.size(0);
  TORCH_CHECK(B > 0 && M > 0 && S > 0 && L > 0, "empty episode block");
  TORCH_CHECK(ci >= 1 && ci <= 60, "control interval must be in [1, 60]");
  check(rates, "rates", {B, M});
  check(out_, "out", {12, B, M});
  check(pipe, "pipe", {S, B});
  check(buf, "buf", {L, B});
  repro_torch::EpisodeCfg cfg{plant_cfg(rps, service, slo, cap, inv_tau),
                              static_cast<float>(max_replicas),
                              static_cast<float>(initial_replicas),
                              static_cast<int>(S), static_cast<int>(ci)};
  repro_torch::HPAHyper hyper{static_cast<float>(inv_target),
                              static_cast<float>(tolerance),
                              static_cast<float>(cooldown_sec),
                              static_cast<int>(L)};
  const c10::cuda::CUDAGuard guard(rates.device());
  repro_torch::episode_block_hpa_launch(
      in(rates), out(out_), out(pipe), out(buf), static_cast<int>(B),
      static_cast<int>(M), cfg, hyper, at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// tables: edges [F, E], feat/thresh [T, 2^depth - 1] int32, leaf [T,
// 2^depth], base [K]
repro_torch::GBDTTables gbdt_tables(const torch::Tensor& edges,
                                    const torch::Tensor& feat,
                                    const torch::Tensor& thresh,
                                    const torch::Tensor& leaf,
                                    const torch::Tensor& base) {
  TORCH_CHECK(edges.dim() == 2 && feat.dim() == 2 && leaf.dim() == 2 &&
                  base.dim() == 1,
              "GBDT tables: edges, feat, thresh, leaf 2-d, base 1-d");
  const int64_t F = edges.size(0), E = edges.size(1);
  const int64_t T = feat.size(0), I = feat.size(1), L = leaf.size(1);
  const int64_t K = base.size(0);
  TORCH_CHECK(L >= 2 && (L & (L - 1)) == 0 && I == L - 1,
              "GBDT tables: 2^depth leaves and 2^depth - 1 nodes per tree");
  TORCH_CHECK(F >= 1 && F <= 64 && E >= 1 && K >= 1 && K <= 16 &&
                  T % K == 0 && T / K <= 1024 && L <= 4096,
              "GBDT tables: 1-64 features, 1-16 classes, at most 1024 "
              "rounds and depth 12");
  check(edges, "edges", {F, E});
  check_i32(feat, "feat", {T, I});
  check_i32(thresh, "thresh", {T, I});
  check(leaf, "leaf", {T, L});
  check(base, "base", {K});
  int depth = 0;
  while ((int64_t{1} << depth) < L) ++depth;
  return {in(edges), feat.data_ptr<int>(), thresh.data_ptr<int>(), in(leaf),
          in(base), static_cast<int>(F), static_cast<int>(E),
          static_cast<int>(T), static_cast<int>(K), depth};
}

// windows [N, W] -> out [N, 28] or, if dft is the [2, W/2 + 1, W] DFT
// table (an empty tensor otherwise), out [N, 38] with the frequency
// features; inv_log_nb and inv_nb are their f32 multipliers.
void window_features(torch::Tensor windows, torch::Tensor out_,
                     torch::Tensor dft, double inv_log_nb, double inv_nb) {
  TORCH_CHECK(windows.dim() == 2, "windows must be [N, W]");
  const int64_t N = windows.size(0), W = windows.size(1);
  const bool freq = dft.numel() > 0;
  TORCH_CHECK(N > 0 && W >= (freq ? 4 : 3) && W <= 64, "window_features "
              "takes N >= 1 windows of 3 (4 with the frequency features) "
              "to 64 samples");
  check(windows, "windows", {N, W});
  check(out_, "out", {N, freq ? 38 : 28});
  repro_torch::FreqTables tab{};
  if (freq) {
    check(dft, "dft", {2, W / 2 + 1, W});
    tab = {in(dft), static_cast<float>(inv_log_nb),
           static_cast<float>(inv_nb)};
  }
  const c10::cuda::CUDAGuard guard(windows.device());
  repro_torch::window_features_launch(in(windows), out(out_),
                                      static_cast<int>(N),
                                      static_cast<int>(W),
                                      freq ? &tab : nullptr,
                                      at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// X [N, F] -> out [N, K]
void gbdt_logits(torch::Tensor X, torch::Tensor out_, torch::Tensor edges,
                 torch::Tensor feat, torch::Tensor thresh, torch::Tensor leaf,
                 torch::Tensor base) {
  const repro_torch::GBDTTables g = gbdt_tables(edges, feat, thresh, leaf,
                                                base);
  TORCH_CHECK(X.dim() == 2 && X.size(0) > 0, "X must be [N, F], N >= 1");
  const int64_t N = X.size(0);
  check(X, "X", {N, g.n_features});
  check(out_, "out", {N, g.n_classes});
  const c10::cuda::CUDAGuard guard(X.device());
  repro_torch::gbdt_tables_launch(in(X), out(out_), static_cast<int>(N), g,
                                  at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// rates [B, M] -> out [12, B, M] and, if arch_out has B * M elements, the
// archetype after each minute into it; scratch pipe [S, B] and scratch
// [60 + period, B]. fhyper: Table III (16 floats: target_cpu, cooldown_min,
// min_replicas, warm_pool by class), rps_per_replica, alpha, beta, gamma,
// 1 - alpha, 1 - beta, 1 - gamma, resid_rho, z, sqrt(horizon),
// trend_tbar, trend_tvar, trend_step, inv_log_nb, inv_nb. ihyper:
// stride_min, horizon_min, forecast_confidence, period, classify.
void episode_block_aapa(torch::Tensor rates, torch::Tensor out_,
                        torch::Tensor pipe, torch::Tensor scratch,
                        torch::Tensor arch_out, int64_t ci,
                        double rps, double service, double slo, double cap,
                        double inv_tau, double max_replicas,
                        double initial_replicas, std::vector<double> fhyper,
                        std::vector<int64_t> ihyper, torch::Tensor dft,
                        torch::Tensor edges, torch::Tensor feat,
                        torch::Tensor thresh, torch::Tensor leaf,
                        torch::Tensor base, torch::Tensor cal_a,
                        torch::Tensor cal_b, torch::Tensor cal_c) {
  TORCH_CHECK(fhyper.size() == 31 && ihyper.size() == 5,
              "episode_block_aapa takes 31 float and 5 int hyperparameters");
  TORCH_CHECK(rates.dim() == 2 && pipe.dim() == 2 && scratch.dim() == 2,
              "rates, pipe and scratch must be 2-d");
  const int64_t B = rates.size(0), M = rates.size(1), S = pipe.size(0);
  const int64_t period = ihyper[3];
  TORCH_CHECK(B > 0 && M > 0 && S > 0 && period > 0, "empty episode block");
  TORCH_CHECK(ci >= 1 && ci <= 60, "control interval must be in [1, 60]");
  TORCH_CHECK(ihyper[0] >= 1 && ihyper[1] >= 1, "stride and horizon >= 1");
  check(rates, "rates", {B, M});
  check(out_, "out", {12, B, M});
  check(pipe, "pipe", {S, B});
  check(scratch, "scratch", {60 + period, B});
  check(dft, "dft", {2, 31, 60});
  int* arch = nullptr;
  if (arch_out.numel() > 0) {
    check_i32(arch_out, "arch_out", {B, M});
    arch = arch_out.data_ptr<int>();
  }
  repro_torch::AAPAHyper h{};
  for (int k = 0; k < 4; ++k) {
    h.target_cpu[k] = static_cast<float>(fhyper[k]);
    h.cooldown_min[k] = static_cast<float>(fhyper[4 + k]);
    h.min_replicas[k] = static_cast<float>(fhyper[8 + k]);
    h.warm_pool[k] = static_cast<float>(fhyper[12 + k]);
  }
  const auto f = [&](int i) { return static_cast<float>(fhyper[i]); };
  h.rps_per_replica = f(16);
  h.alpha = f(17);
  h.beta = f(18);
  h.gamma = f(19);
  h.one_m_alpha = f(20);
  h.one_m_beta = f(21);
  h.one_m_gamma = f(22);
  h.resid_rho = f(23);
  h.z = f(24);
  h.sqrt_h = f(25);
  h.trend_tbar = f(26);
  h.trend_tvar = f(27);
  h.trend_step = f(28);
  h.freq = {in(dft), f(29), f(30)};
  h.stride_min = static_cast<int>(ihyper[0]);
  h.horizon_min = static_cast<int>(ihyper[1]);
  h.forecast_confidence = static_cast<int>(ihyper[2]);
  h.period = static_cast<int>(period);
  h.classify = static_cast<int>(ihyper[4]);
  if (h.classify) {
    h.gbdt = gbdt_tables(edges, feat, thresh, leaf, base);
    TORCH_CHECK(h.gbdt.n_features == 38 && h.gbdt.n_classes == 4,
                "the AAPA classifier takes 38 features and 4 classes");
    check(cal_a, "cal_a", {4});
    check(cal_b, "cal_b", {4});
    check(cal_c, "cal_c", {4});
    h.cal = {in(cal_a), in(cal_b), in(cal_c)};
  }
  repro_torch::EpisodeCfg cfg{plant_cfg(rps, service, slo, cap, inv_tau),
                              static_cast<float>(max_replicas),
                              static_cast<float>(initial_replicas),
                              static_cast<int>(S), static_cast<int>(ci)};
  const c10::cuda::CUDAGuard guard(rates.device());
  repro_torch::episode_block_aapa_launch(
      in(rates), out(out_), out(pipe), out(scratch), arch,
      static_cast<int>(B), static_cast<int>(M), cfg, h,
      at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("plant_block", &plant_block, "plant_block CUDA kernel");
  m.def("episode_block_hpa", &episode_block_hpa,
        "episode_block CUDA kernel, HPA policy");
  m.def("episode_block_aapa", &episode_block_aapa,
        "episode_block CUDA kernel, AAPA policy");
  m.def("window_features", &window_features, "window_features CUDA kernel");
  m.def("gbdt_logits", &gbdt_logits, "gbdt_tables CUDA kernel");
}
