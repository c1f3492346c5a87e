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

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("plant_block", &plant_block, "plant_block CUDA kernel");
  m.def("episode_block_hpa", &episode_block_hpa,
        "episode_block CUDA kernel, HPA policy");
}
