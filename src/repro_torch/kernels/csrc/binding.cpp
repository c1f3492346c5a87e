// Python binding of the port's CUDA kernels: the one source that includes
// PyTorch's headers. Each entry checks what it hands to a kernel, launches
// it on the current stream and checks the launch (a refused launch never
// runs, and a later synchronize would not report it).
#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <type_traits>
#include <vector>

#include "kernels.h"

namespace {

// A failed check's message, composed with snprintf into a fixed buffer.
// TORCH_CHECK composes a message of more than one piece with a C++ string
// stream (c10::str); built this way on the H100 machine, a failed check of
// that kind ended the process with a segmentation fault, while a check
// whose message is one C string raised RuntimeError. So the binding's
// checks compose their messages without a stream and hand TORCH_CHECK one
// C string (REQUIRE).
class Message {
 public:
  Message() { text_[0] = '\0'; }
  const char* c_str() const { return text_; }
  void put(const char* s) { append("%s", s); }
  template <class T, std::enable_if_t<std::is_integral_v<T>, int> = 0>
  void put(T v) {
    append("%lld", static_cast<long long>(v));
  }
  void put(c10::IntArrayRef a) {
    put("[");
    for (size_t i = 0; i < a.size(); ++i) {
      if (i) put(", ");
      put(a[i]);
    }
    put("]");
  }

 private:
  template <class... Args>
  void append(const char* fmt, Args... args) {
    if (len_ + 1 >= sizeof(text_)) return;
    const int n = std::snprintf(text_ + len_, sizeof(text_) - len_, fmt,
                                args...);
    if (n > 0)
      len_ = std::min(len_ + static_cast<size_t>(n), sizeof(text_) - 1);
  }
  char text_[512];
  size_t len_ = 0;
};

template <class... Args>
Message compose(const Args&... args) {
  Message m;
  (m.put(args), ...);
  return m;
}

}  // namespace

// Every check of the binding: a false `cond` raises RuntimeError with the
// message the remaining arguments compose (see Message).
#define REQUIRE(cond, ...) TORCH_CHECK(cond, compose(__VA_ARGS__).c_str())

namespace {

// Every tensor an entry hands to its kernels lies on the device the entry
// guards (dev, that of its first tensor): a tensor on another card would
// be read through a pointer the kernel cannot follow.
void on_device(const torch::Tensor& t, const char* name,
               const c10::Device& dev) {
  REQUIRE(t.is_cuda(), name, " must be a CUDA tensor");
  REQUIRE(t.device() == dev, name, " is on cuda:", t.get_device(),
          ", the launch's device is cuda:", dev.index());
}

void check(const torch::Tensor& t, const char* name,
           const std::vector<int64_t>& shape, const c10::Device& dev) {
  on_device(t, name, dev);
  REQUIRE(t.scalar_type() == torch::kFloat32, name, " must be float32");
  REQUIRE(t.is_contiguous(), name, " must be contiguous");
  REQUIRE(t.sizes() == c10::IntArrayRef(shape), name, " has shape ",
          t.sizes(), ", expected ", c10::IntArrayRef(shape));
}

void check_i32(const torch::Tensor& t, const char* name,
               const std::vector<int64_t>& shape, const c10::Device& dev) {
  on_device(t, name, dev);
  REQUIRE(t.scalar_type() == torch::kInt32, name, " must be int32");
  REQUIRE(t.is_contiguous(), name, " must be contiguous");
  REQUIRE(t.sizes() == c10::IntArrayRef(shape), name, " has shape ",
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
// pipeline_out [B, S] and ticks [7, T, B]. variant: repro_torch::
// PlantVariant; lanes per block (32, 64 or 128; 128 for the per-thread
// kernel) and the ticks whose popped slots a block stages at once.
void plant_block(std::vector<torch::Tensor> state, torch::Tensor pipeline,
                 std::vector<torch::Tensor> state_out,
                 torch::Tensor pipeline_out, torch::Tensor ticks,
                 double rps, double service, double slo, double cap,
                 double inv_tau, int64_t variant, int64_t lanes,
                 int64_t chunk) {
  REQUIRE(state.size() == 7 && state_out.size() == 6,
          "plant_block takes 7 state inputs and 6 state outputs");
  REQUIRE(pipeline.dim() == 2 && ticks.dim() == 3,
          "pipeline must be [B, S] and ticks [7, T, B]");
  const int64_t B = pipeline.size(0), S = pipeline.size(1);
  const int64_t T = ticks.size(1);
  REQUIRE(B > 0 && S > 0 && T > 0, "empty plant block");
  const c10::Device dev = pipeline.device();
  for (auto& t : state) check(t, "plant state", {B}, dev);
  for (auto& t : state_out) check(t, "plant state output", {B}, dev);
  check(pipeline, "pipeline", {B, S}, dev);
  check(pipeline_out, "pipeline_out", {B, S}, dev);
  check(ticks, "ticks", {7, T, B}, dev);
  REQUIRE(variant >= repro_torch::kPlantStaged &&
              variant <= repro_torch::kPlantEmpty,
          "plant_block has no variant ", variant);
  REQUIRE(lanes == 32 || lanes == 64 || lanes == 128,
          "plant_block runs 32, 64 or 128 lanes a block, got ", lanes);
  REQUIRE(variant != repro_torch::kPlantPerThread || lanes == 128,
          "the per-thread plant_block kernel runs 128 lanes a block");
  REQUIRE(chunk >= 1 && chunk <= std::min(S, T) &&
              lanes * (chunk | 1) <= repro_torch::kPlantPopFloats,
          "plant_block stages 1 to min(S, T) ticks a chunk, at most ",
          repro_torch::kPlantPopFloats, " floats a block; got ", chunk,
          " ticks of ", lanes, " lanes");
  const c10::cuda::CUDAGuard guard(dev);
  repro_torch::plant_block_launch(
      in(state[0]), in(pipeline), in(state[1]), in(state[2]), in(state[3]),
      in(state[4]), in(state[5]), in(state[6]), out(state_out[0]),
      out(pipeline_out), out(state_out[1]), out(state_out[2]),
      out(state_out[3]), out(state_out[4]), out(state_out[5]), out(ticks),
      static_cast<int>(B), static_cast<int>(S), static_cast<int>(T),
      static_cast<repro_torch::PlantVariant>(variant),
      static_cast<int>(lanes), static_cast<int>(chunk),
      plant_cfg(rps, service, slo, cap, inv_tau),
      at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// tables: edges [F, E], feat/thresh [T, 2^depth - 1] int32, leaf [T,
// 2^depth], base [K]
repro_torch::GBDTTables gbdt_tables(const torch::Tensor& edges,
                                    const torch::Tensor& feat,
                                    const torch::Tensor& thresh,
                                    const torch::Tensor& leaf,
                                    const torch::Tensor& base,
                                    const c10::Device& dev) {
  REQUIRE(edges.dim() == 2 && feat.dim() == 2 && leaf.dim() == 2 &&
              base.dim() == 1,
          "GBDT tables: edges, feat, thresh, leaf 2-d, base 1-d");
  const int64_t F = edges.size(0), E = edges.size(1);
  const int64_t T = feat.size(0), I = feat.size(1), L = leaf.size(1);
  const int64_t K = base.size(0);
  REQUIRE(L >= 2 && (L & (L - 1)) == 0 && I == L - 1,
          "GBDT tables: 2^depth leaves and 2^depth - 1 nodes per tree");
  REQUIRE(F >= 1 && F <= 64 && E >= 1 && K >= 1 && K <= 16 &&
              T % K == 0 && T / K <= 1024 && L <= 4096,
          "GBDT tables: 1-64 features, 1-16 classes, at most 1024 "
          "rounds and depth 12");
  check(edges, "edges", {F, E}, dev);
  check_i32(feat, "feat", {T, I}, dev);
  check_i32(thresh, "thresh", {T, I}, dev);
  check(leaf, "leaf", {T, L}, dev);
  check(base, "base", {K}, dev);
  int depth = 0;
  while ((int64_t{1} << depth) < L) ++depth;
  return {in(edges), feat.data_ptr<int>(), thresh.data_ptr<int>(), in(leaf),
          in(base), static_cast<int>(F), static_cast<int>(E),
          static_cast<int>(T), static_cast<int>(K), depth};
}

// The real FFT's plan for windows of W samples (core/features.py::
// fft_tables): twiddles tw and plan [n_pass * 4] of (ip, l1, ido, offset)
repro_torch::FreqTables freq_tables(const torch::Tensor& tw,
                                    const std::vector<int64_t>& plan,
                                    int64_t W, double inv_log_nb,
                                    double inv_nb, const c10::Device& dev) {
  const int64_t n_pass = static_cast<int64_t>(plan.size()) / 4;
  REQUIRE(plan.size() % 4 == 0 && n_pass >= 1 &&
              n_pass <= repro_torch::kMaxFftPasses,
          "FFT plan: 1 to ", repro_torch::kMaxFftPasses,
          " passes of (ip, l1, ido, offset)");
  REQUIRE(tw.dim() == 1, "FFT twiddles must be 1-d");
  check(tw, "twiddles", {tw.size(0)}, dev);
  repro_torch::FreqTables f{};
  f.tw = in(tw);
  f.n_pass = static_cast<int>(n_pass);
  int64_t prod = 1;
  for (int64_t q = 0; q < n_pass; ++q) {
    const int64_t ip = plan[4 * q], l1 = plan[4 * q + 1];
    const int64_t ido = plan[4 * q + 2], off = plan[4 * q + 3];
    // a factor above 5 (ducc0's radfg) also takes csarr [2 * ip]
    const int64_t n_tw = (ip - 1) * (ido - 1) + (ip > 5 ? 2 * ip : 0);
    REQUIRE(ip >= 2 && l1 * ip * ido == W && off >= 0 &&
                off + n_tw <= tw.size(0),
            "FFT plan: pass ", q, " does not fit a window of ", W);
    prod *= ip;
    f.ip[q] = static_cast<int>(ip);
    f.l1[q] = static_cast<int>(l1);
    f.ido[q] = static_cast<int>(ido);
    f.off[q] = static_cast<int>(off);
  }
  REQUIRE(prod == W, "FFT plan: radices multiply to ", prod, ", not ",
          W);
  f.inv_log_nb = static_cast<float>(inv_log_nb);
  f.inv_nb = static_cast<float>(inv_nb);
  return f;
}

// The window_features kernel variant a launch asks for at width W
// (window_features.py: 0 "w60", 1 "generic", 2 "wide"), checked against
// what each takes: "w60" W = 60 and its FFT plan kW60Plan, "generic" W <=
// 64. freq: the FFT plan, or nullptr without the frequency features.
repro_torch::WfVariant wf_variant(int64_t variant, int64_t W,
                                  const repro_torch::FreqTables* freq) {
  REQUIRE(variant >= repro_torch::kWfW60 && variant <= repro_torch::kWfWide,
          "unknown window_features variant ", variant);
  REQUIRE(variant != repro_torch::kWfW60 || W == repro_torch::kW60,
          "the W = 60 window_features kernel got windows of ", W);
  REQUIRE(variant != repro_torch::kWfGeneric ||
              W <= repro_torch::kMaxWindow,
          "the generic window_features kernel takes windows of at most ",
          repro_torch::kMaxWindow, ", got ", W);
  for (int q = 0; freq && variant == repro_torch::kWfW60 &&
                  q < repro_torch::kW60Passes; ++q)
    REQUIRE(freq->n_pass == repro_torch::kW60Passes &&
                freq->ip[q] == repro_torch::kW60Plan[q][0] &&
                freq->l1[q] == repro_torch::kW60Plan[q][1] &&
                freq->ido[q] == repro_torch::kW60Plan[q][2],
            "FFT plan: pass ", q, " differs from the one the W = 60 "
            "kernel was compiled for");
  return static_cast<repro_torch::WfVariant>(variant);
}

// windows [N, W] -> out [N, 28] or, with an FFT plan (empty otherwise),
// out [N, 38] with the frequency features; inv_log_nb and inv_nb are
// their f32 multipliers. variant: see wf_variant.
void window_features(torch::Tensor windows, torch::Tensor out_,
                     torch::Tensor tw, std::vector<int64_t> plan,
                     double inv_log_nb, double inv_nb, int64_t variant) {
  REQUIRE(windows.dim() == 2, "windows must be [N, W]");
  const int64_t N = windows.size(0), W = windows.size(1);
  const bool freq = !plan.empty();
  REQUIRE(N > 0 && N <= INT32_MAX && W >= (freq ? 4 : 3) &&
              W <= repro_torch::kMaxWideWindow,
          "window_features takes 1 to 2^31 - 1 windows of 3 (4 with the "
          "frequency features) to ", repro_torch::kMaxWideWindow,
          " samples");
  const c10::Device dev = windows.device();
  check(windows, "windows", {N, W}, dev);
  check(out_, "out", {N, freq ? 38 : 28}, dev);
  repro_torch::FreqTables tab{};
  if (freq) tab = freq_tables(tw, plan, W, inv_log_nb, inv_nb, dev);
  const repro_torch::WfVariant v = wf_variant(variant, W, freq ? &tab
                                                               : nullptr);
  const c10::cuda::CUDAGuard guard(dev);
  repro_torch::window_features_launch(in(windows), out(out_),
                                      static_cast<int>(N),
                                      static_cast<int>(W),
                                      freq ? &tab : nullptr, v,
                                      at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// X [N, F] -> out [N, K]; shared: the node tables in shared memory (up to
// kGBDTSharedTableMax bytes), else the per-thread kernel
void gbdt_logits(torch::Tensor X, torch::Tensor out_, torch::Tensor edges,
                 torch::Tensor feat, torch::Tensor thresh, torch::Tensor leaf,
                 torch::Tensor base, bool shared) {
  REQUIRE(X.is_cuda(), "X must be a CUDA tensor");
  const c10::Device dev = X.device();
  const repro_torch::GBDTTables g = gbdt_tables(edges, feat, thresh, leaf,
                                                base, dev);
  REQUIRE(X.dim() == 2 && X.size(0) > 0, "X must be [N, F], N >= 1");
  const int64_t N = X.size(0);
  check(X, "X", {N, g.n_features}, dev);
  check(out_, "out", {N, g.n_classes}, dev);
  const size_t table_bytes =
      repro_torch::gbdt_shared_table_bytes(g.n_trees, g.depth);
  REQUIRE(!shared || table_bytes <= repro_torch::kGBDTSharedTableMax,
          "gbdt_tables keeps node tables in shared memory only up to ",
          repro_torch::kGBDTSharedTableMax, " bytes, got ", table_bytes);
  const c10::cuda::CUDAGuard guard(dev);
  repro_torch::gbdt_tables_launch(in(X), out(out_), static_cast<int>(N), g,
                                  shared, at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// The dynamic shared memory a plant-pass block needs for S pipeline slots
// and a policy ring of ring_len slots, and what a block can have on the
// device: (bytes, limit). The launcher refuses a launch that does not fit.
std::vector<int64_t> episode_smem(int64_t S, int64_t ring_len,
                                  int64_t device) {
  REQUIRE(S >= 1 && S <= 1 << 20 && ring_len >= 0 && ring_len <= 1 << 20,
          "startup_sec and the policy ring must be below 2^20 slots");
  return {repro_torch::episode_smem_bytes(static_cast<int>(S),
                                          static_cast<int>(ring_len)),
          static_cast<int64_t>(
              at::cuda::getDeviceProperties(static_cast<c10::DeviceIndex>(
                  device))->sharedMemPerBlockOptin)};
}

// The episode's shapes and SimConfig: rates [B, M] and out [12, B, M]
// checked, S pipeline slots and a policy ring of ring_len slots that fit
// in a block's shared memory.
repro_torch::EpisodeCfg episode_cfg(const torch::Tensor& rates,
                                    const torch::Tensor& out_, int64_t S,
                                    int64_t ring_len, int64_t ci, double rps,
                                    double service, double slo, double cap,
                                    double inv_tau, double max_replicas,
                                    double initial_replicas) {
  REQUIRE(rates.dim() == 2, "rates must be [B, M]");
  const int64_t B = rates.size(0), M = rates.size(1);
  REQUIRE(B > 0 && M > 0 && S > 0, "empty episode block");
  REQUIRE(ci >= 1 && ci <= 60, "control interval must be in [1, 60]");
  const c10::Device dev = rates.device();
  check(rates, "rates", {B, M}, dev);
  check(out_, "out", {12, B, M}, dev);
  const std::vector<int64_t> smem =
      episode_smem(S, ring_len, rates.get_device());
  REQUIRE(smem[0] <= smem[1], "episode_block: ", S,
          " startup-pipeline slots and a policy ring of ", ring_len,
          " slots need ", smem[0], " bytes of shared memory per block, "
          "more than the ", smem[1], " a block can have");
  return {plant_cfg(rps, service, slo, cap, inv_tau),
          static_cast<float>(max_replicas),
          static_cast<float>(initial_replicas), static_cast<int>(S),
          static_cast<int>(ci)};
}

// rates [B, M] -> out [12, B, M]; S pipeline slots and a window of
// buf_len decisions
void episode_block_hpa(torch::Tensor rates, torch::Tensor out_, int64_t S,
                       int64_t ci, double rps, double service, double slo,
                       double cap, double inv_tau, double max_replicas,
                       double initial_replicas, double inv_target,
                       double tolerance, double cooldown_sec,
                       int64_t buf_len) {
  REQUIRE(buf_len >= 1, "the stabilization window needs a slot");
  const repro_torch::EpisodeCfg cfg =
      episode_cfg(rates, out_, S, buf_len, ci, rps, service, slo, cap,
                  inv_tau, max_replicas, initial_replicas);
  const repro_torch::HPAHyper hyper{static_cast<float>(inv_target),
                                    static_cast<float>(tolerance),
                                    static_cast<float>(cooldown_sec),
                                    static_cast<int>(buf_len)};
  const c10::cuda::CUDAGuard guard(rates.device());
  repro_torch::episode_block_hpa_launch(
      in(rates), out(out_), static_cast<int>(rates.size(0)),
      static_cast<int>(rates.size(1)), cfg, hyper,
      at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Holt-Winters: alpha, beta, gamma, 1 - alpha, 1 - beta, 1 - gamma at
// f[0..5]
repro_torch::HWCoeffs hw_coeffs(const std::vector<double>& f) {
  return {static_cast<float>(f[0]), static_cast<float>(f[1]),
          static_cast<float>(f[2]), static_cast<float>(f[3]),
          static_cast<float>(f[4]), static_cast<float>(f[5])};
}

// The forecaster of a pre-pass walk. fc_i (2): kind (FcKind), scratch
// slots; fc_f (13): resid_rho, the 6 Holt-Winters coefficients, the EWMA's
// alpha, and linear trend's 1 / window, tbar, tvar, step_1, step_h.
repro_torch::FcHyper fc_hyper(const std::vector<double>& fc_f,
                              const std::vector<int64_t>& fc_i) {
  REQUIRE(fc_f.size() == 13 && fc_i.size() == 2,
          "a forecaster takes 13 float and 2 int hyperparameters");
  REQUIRE(fc_i[0] >= repro_torch::kHoltWinters &&
              fc_i[0] <= repro_torch::kEwma,
          "unknown forecaster kind ", fc_i[0]);
  REQUIRE(fc_i[0] == repro_torch::kEwma ? fc_i[1] == 0
                                        : fc_i[1] >= 1,
          "forecaster scratch slots: 0 for ewma, >= 1 otherwise");
  const auto f = [&](int i) { return static_cast<float>(fc_f[i]); };
  repro_torch::FcHyper h{};
  h.kind = static_cast<int>(fc_i[0]);
  h.slots = static_cast<int>(fc_i[1]);
  h.resid_rho = f(0);
  h.hw = hw_coeffs(std::vector<double>(fc_f.begin() + 1, fc_f.begin() + 7));
  h.alpha = f(7);
  h.inv_n = f(8);
  h.tbar = f(9);
  h.tvar = f(10);
  h.step_1 = f(11);
  h.step_h = f(12);
  return h;
}

// AAPA's minute-hook hyperparameters. fhyper (19): Table III (12 floats:
// target_cpu, cooldown_min, min_replicas by class), z, sqrt_h, trend_tbar,
// trend_tvar, trend_step, band_q, band_scale. ihyper (6): stride_min,
// horizon_min, forecast_confidence, classify, use_band, use_scale.
repro_torch::AAPAHyper aapa_hyper(const std::vector<double>& fhyper,
                                  const std::vector<int64_t>& ihyper,
                                  const repro_torch::FcHyper& fc) {
  REQUIRE(fhyper.size() == 19 && ihyper.size() == 6,
          "the AAPA policy takes 19 float and 6 int hyperparameters");
  REQUIRE(ihyper[0] >= 1 && ihyper[1] >= 1, "stride and horizon >= 1");
  repro_torch::AAPAHyper h{};
  for (int k = 0; k < 4; ++k) {
    h.target_cpu[k] = static_cast<float>(fhyper[k]);
    h.cooldown_min[k] = static_cast<float>(fhyper[4 + k]);
    h.min_replicas[k] = static_cast<float>(fhyper[8 + k]);
  }
  const auto f = [&](int i) { return static_cast<float>(fhyper[i]); };
  h.fc = fc;
  h.z = f(12);
  h.sqrt_h = f(13);
  h.trend_tbar = f(14);
  h.trend_tvar = f(15);
  h.trend_step = f(16);
  h.band_q = f(17);
  h.band_scale = f(18);
  h.stride_min = static_cast<int>(ihyper[0]);
  h.horizon_min = static_cast<int>(ihyper[1]);
  h.forecast_confidence = static_cast<int>(ihyper[2]);
  h.classify = static_cast<int>(ihyper[3]);
  h.use_band = static_cast<int>(ihyper[4]);
  h.use_scale = static_cast<int>(ihyper[5]);
  return h;
}

// The AAPA and hybrid reclassifications: rates [B, M], every lane's window
// of W minutes before minute r * stride, r in [1, R), R = M / stride + 1
// -> cls_arch int32 and cls_conf [B, R - 1] (slot r at column r - 1).
// Scratch: feats [B * (R - 1), 38] and logits [B * (R - 1), 4]. The
// features take the FFT plan for W (tw, plan, inv_log_nb, inv_nb) and the
// window_features variant (wf_variant); the GBDT its tables, in shared
// memory when gbdt_shared; the calibration cal_a, cal_b, cal_c [4].
void reclassify(torch::Tensor rates, torch::Tensor feats,
                torch::Tensor logits, torch::Tensor cls_arch,
                torch::Tensor cls_conf, int64_t stride, int64_t W,
                torch::Tensor tw, std::vector<int64_t> plan,
                double inv_log_nb, double inv_nb, int64_t variant,
                torch::Tensor edges, torch::Tensor feat, torch::Tensor thresh,
                torch::Tensor leaf, torch::Tensor base, bool gbdt_shared,
                torch::Tensor cal_a, torch::Tensor cal_b,
                torch::Tensor cal_c) {
  REQUIRE(rates.dim() == 2, "rates must be [B, M]");
  const int64_t B = rates.size(0), M = rates.size(1);
  REQUIRE(stride >= 1 && W >= 4 && W <= repro_torch::kMaxWideWindow,
          "a reclassification takes a stride >= 1 and windows of 4 to ",
          repro_torch::kMaxWideWindow, " minutes");
  const int64_t R = M / stride + 1, N = B * (R - 1);
  REQUIRE(B > 0 && R > 1 && N <= INT32_MAX, "reclassify: B >= 1 lanes, at "
          "least one slot (M >= stride), B * (M / stride) < 2^31");
  const c10::Device dev = rates.device();
  check(rates, "rates", {B, M}, dev);
  check(feats, "feats", {N, 38}, dev);
  check(logits, "logits", {N, 4}, dev);
  check_i32(cls_arch, "cls_arch", {B, R - 1}, dev);
  check(cls_conf, "cls_conf", {B, R - 1}, dev);
  const repro_torch::FreqTables tab =
      freq_tables(tw, plan, W, inv_log_nb, inv_nb, dev);
  const repro_torch::WfVariant v = wf_variant(variant, W, &tab);
  const repro_torch::GBDTTables g = gbdt_tables(edges, feat, thresh, leaf,
                                                base, dev);
  REQUIRE(g.n_features == 38 && g.n_classes == 4,
          "the AAPA classifier takes 38 features and 4 classes");
  REQUIRE(!gbdt_shared || repro_torch::gbdt_shared_table_bytes(
                              g.n_trees, g.depth) <=
                              repro_torch::kGBDTSharedTableMax,
          "gbdt_tables keeps node tables in shared memory only up to ",
          repro_torch::kGBDTSharedTableMax, " bytes");
  check(cal_a, "cal_a", {4}, dev);
  check(cal_b, "cal_b", {4}, dev);
  check(cal_c, "cal_c", {4}, dev);
  const c10::cuda::CUDAGuard guard(rates.device());
  repro_torch::reclassify_launch(
      in(rates), out(feats), out(logits), cls_arch.data_ptr<int>(),
      out(cls_conf), static_cast<int>(B), static_cast<int>(M),
      static_cast<int>(R), static_cast<int>(stride), static_cast<int>(W),
      tab, v, g, gbdt_shared, {in(cal_a), in(cal_b), in(cal_c)},
      at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// The AAPA and hybrid pre-pass: rates [B, M] -> rps [3, M, B], arch [R,
// B] int32, adj [3, R, B] (R = M / stride + 1) and, if minute_arch has B *
// M elements, the archetype after each minute into it. cls_arch [B, R - 1]
// int32 and cls_conf [B, R - 1]: reclassify's output, read when classify
// is 1. Scratch: the forecaster's [slots, B].
void policy_signals_aapa(torch::Tensor rates, torch::Tensor rps,
                         torch::Tensor arch, torch::Tensor adj,
                         torch::Tensor minute_arch, torch::Tensor cls_arch,
                         torch::Tensor cls_conf, torch::Tensor scratch,
                         std::vector<double> fhyper,
                         std::vector<int64_t> ihyper,
                         std::vector<double> fc_f,
                         std::vector<int64_t> fc_i) {
  const repro_torch::AAPAHyper h =
      aapa_hyper(fhyper, ihyper, fc_hyper(fc_f, fc_i));
  REQUIRE(rates.dim() == 2, "rates must be [B, M]");
  const int64_t B = rates.size(0), M = rates.size(1);
  const int64_t R = M / h.stride_min + 1;
  REQUIRE(B > 0 && M > 0, "empty episode block");
  const c10::Device dev = rates.device();
  check(rates, "rates", {B, M}, dev);
  check(rps, "rps", {3, M, B}, dev);
  check_i32(arch, "arch", {R, B}, dev);
  check(adj, "adj", {3, R, B}, dev);
  check_i32(cls_arch, "cls_arch", {B, R - 1}, dev);
  check(cls_conf, "cls_conf", {B, R - 1}, dev);
  check(scratch, "forecaster scratch", {h.fc.slots, B}, dev);
  int* per_minute = nullptr;
  if (minute_arch.numel() > 0) {
    check_i32(minute_arch, "minute_arch", {B, M}, dev);
    per_minute = minute_arch.data_ptr<int>();
  }
  const c10::cuda::CUDAGuard guard(rates.device());
  repro_torch::policy_signals_aapa_launch(
      in(rates), out(rps), arch.data_ptr<int>(), out(adj), per_minute,
      cls_arch.data_ptr<int>(), in(cls_conf), out(scratch),
      static_cast<int>(B), static_cast<int>(M), h,
      at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// The predictive pre-pass: rates [B, M] -> need [M, B]; scratch the
// forecaster's [slots, B]. fhyper (4): z, sqrt_h, band_q, inv_cap; ihyper
// (3): horizon_min, use_band, conservative.
void policy_signals_predictive(torch::Tensor rates, torch::Tensor need,
                               torch::Tensor scratch,
                               std::vector<double> fhyper,
                               std::vector<int64_t> ihyper,
                               std::vector<double> fc_f,
                               std::vector<int64_t> fc_i) {
  REQUIRE(fhyper.size() == 4 && ihyper.size() == 3,
          "the predictive policy takes 4 float and 3 int "
          "hyperparameters");
  REQUIRE(ihyper[0] >= 1, "horizon >= 1");
  REQUIRE(rates.dim() == 2, "rates must be [B, M]");
  const int64_t B = rates.size(0), M = rates.size(1);
  REQUIRE(B > 0 && M > 0, "empty episode block");
  repro_torch::PredictiveHyper h{};
  h.fc = fc_hyper(fc_f, fc_i);
  const c10::Device dev = rates.device();
  check(rates, "rates", {B, M}, dev);
  check(need, "need", {M, B}, dev);
  check(scratch, "forecaster scratch", {h.fc.slots, B}, dev);
  h.z = static_cast<float>(fhyper[0]);
  h.sqrt_h = static_cast<float>(fhyper[1]);
  h.band_q = static_cast<float>(fhyper[2]);
  h.inv_cap = static_cast<float>(fhyper[3]);
  h.horizon_min = static_cast<int>(ihyper[0]);
  h.use_band = static_cast<int>(ihyper[1]);
  h.conservative = static_cast<int>(ihyper[2]);
  const c10::cuda::CUDAGuard guard(rates.device());
  repro_torch::policy_signals_predictive_launch(
      in(rates), out(need), out(scratch), static_cast<int>(B),
      static_cast<int>(M), h, at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// The pre-pass's signals for the plant pass: rps [K, M, B] and, with a
// stride (AAPA, hybrid), arch [R, B] int32 and adj [3, R, B].
repro_torch::PolicySignals policy_signals(const torch::Tensor& rates,
                                          const torch::Tensor& rps,
                                          int64_t K, const torch::Tensor* arch,
                                          const torch::Tensor* adj,
                                          int64_t stride) {
  const int64_t B = rates.size(0), M = rates.size(1);
  const c10::Device dev = rates.device();
  check(rps, "rps", {K, M, B}, dev);
  repro_torch::PolicySignals g{in(rps), nullptr, nullptr, 0};
  if (arch != nullptr) {
    const int64_t R = M / stride + 1;
    check_i32(*arch, "arch", {R, B}, dev);
    check(*adj, "adj", {3, R, B}, dev);
    g.arch = arch->data_ptr<int>();
    g.adj = in(*adj);
    g.R = static_cast<int>(R);
  }
  return g;
}

// rates [B, M] -> out [12, B, M] from the AAPA pre-pass's signals (rps
// [3, M, B], arch [R, B], adj [3, R, B]). fhyper (5): Table III's warm
// pool by class, rps_per_replica. With guard (3 floats: f32 reciprocals of
// guard_target and rps_per_replica * guard_target, f32(1 - max_down_frac))
// the hybrid policy runs, without it (empty) AAPA.
void episode_block_aapa(torch::Tensor rates, torch::Tensor out_,
                        torch::Tensor rps, torch::Tensor arch,
                        torch::Tensor adj, int64_t S, int64_t ci, double rps_,
                        double service, double slo, double cap,
                        double inv_tau, double max_replicas,
                        double initial_replicas, std::vector<double> fhyper,
                        int64_t stride, std::vector<double> guard) {
  const repro_torch::EpisodeCfg cfg =
      episode_cfg(rates, out_, S, 0, ci, rps_, service, slo, cap, inv_tau,
                  max_replicas, initial_replicas);
  REQUIRE(fhyper.size() == 5, "the AAPA plant pass takes 5 floats");
  REQUIRE(stride >= 1, "stride >= 1");
  REQUIRE(guard.empty() || guard.size() == 3,
          "the hybrid guard takes 3 floats");
  const repro_torch::PolicySignals g =
      policy_signals(rates, rps, 3, &arch, &adj, stride);
  repro_torch::AAPAPlantHyper h{};
  for (int k = 0; k < 4; ++k) h.warm_pool[k] = static_cast<float>(fhyper[k]);
  h.rps_per_replica = static_cast<float>(fhyper[4]);
  h.stride_min = static_cast<int>(stride);
  const int B = static_cast<int>(rates.size(0));
  const int M = static_cast<int>(rates.size(1));
  const c10::cuda::CUDAGuard device_guard(rates.device());
  if (guard.empty()) {
    repro_torch::episode_block_aapa_launch(in(rates), out(out_), g, B, M,
                                           cfg, h,
                                           at::cuda::getCurrentCUDAStream());
  } else {
    const repro_torch::HybridPlantHyper hh{h, static_cast<float>(guard[0]),
                                           static_cast<float>(guard[1]),
                                           static_cast<float>(guard[2])};
    repro_torch::episode_block_hybrid_launch(
        in(rates), out(out_), g, B, M, cfg, hh,
        at::cuda::getCurrentCUDAStream());
  }
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// rates [B, M] -> out [12, B, M] from the predictive pre-pass's need [M,
// B]; inv_cap and cooldown_sec
void episode_block_predictive(torch::Tensor rates, torch::Tensor out_,
                              torch::Tensor need, int64_t S, int64_t ci,
                              double rps, double service, double slo,
                              double cap, double inv_tau,
                              double max_replicas, double initial_replicas,
                              double inv_cap, double cooldown_sec) {
  const repro_torch::EpisodeCfg cfg =
      episode_cfg(rates, out_, S, 0, ci, rps, service, slo, cap, inv_tau,
                  max_replicas, initial_replicas);
  const repro_torch::PolicySignals g =
      policy_signals(rates, need.view({1, need.size(0), need.size(1)}), 1,
                     nullptr, nullptr, 1);
  const repro_torch::PredictivePlantHyper h{static_cast<float>(inv_cap),
                                            static_cast<float>(cooldown_sec)};
  const c10::cuda::CUDAGuard guard(rates.device());
  repro_torch::episode_block_predictive_launch(
      in(rates), out(out_), g, static_cast<int>(rates.size(0)),
      static_cast<int>(rates.size(1)), cfg, h,
      at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// rates [B, M] -> out [12, B, M]. fhyper (8): service_sec, a_s, a_p,
// inv_tgt, panic_threshold, stable_window_s, dt, cooldown_sec.
void episode_block_kpa(torch::Tensor rates, torch::Tensor out_, int64_t S,
                       int64_t ci, double rps, double service, double slo,
                       double cap, double inv_tau, double max_replicas,
                       double initial_replicas, std::vector<double> fhyper) {
  const repro_torch::EpisodeCfg cfg =
      episode_cfg(rates, out_, S, 0, ci, rps, service, slo, cap, inv_tau,
                  max_replicas, initial_replicas);
  REQUIRE(fhyper.size() == 8,
          "the kpa policy takes 8 float hyperparameters");
  const auto f = [&](int i) { return static_cast<float>(fhyper[i]); };
  const repro_torch::KPAHyper h{f(0), f(1), f(2), f(3),
                                f(4), f(5), f(6), f(7)};
  const c10::cuda::CUDAGuard guard(rates.device());
  repro_torch::episode_block_kpa_launch(
      in(rates), out(out_), static_cast<int>(rates.size(0)),
      static_cast<int>(rates.size(1)), cfg, h,
      at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// y [B, T] -> out [B, T]; coeffs: alpha, beta, gamma, 1 - alpha, 1 - beta,
// 1 - gamma. shared_season (period <= 96): the season in shared memory and
// season_scratch empty, else season_scratch [period, B]; vec16: 16-B
// copies (T % 4 == 0, y and out 16-B aligned).
void holt_winters(torch::Tensor y, torch::Tensor out_,
                  torch::Tensor season_scratch, int64_t period,
                  std::vector<double> coeffs, bool shared_season,
                  bool vec16) {
  REQUIRE(y.dim() == 2, "y must be [B, T]");
  const int64_t B = y.size(0), T = y.size(1);
  REQUIRE(B > 0 && T > 0 && period >= 1,
          "holt_winters takes B, T >= 1 and period >= 1");
  REQUIRE(coeffs.size() == 6, "holt_winters takes 6 coefficients");
  const c10::Device dev = y.device();
  check(y, "y", {B, T}, dev);
  check(out_, "out", {B, T}, dev);
  REQUIRE(season_scratch.dim() == 2, "season scratch must be 2-d");
  if (shared_season) {
    REQUIRE(period <= repro_torch::kHWSharedPeriodMax,
            "holt_winters keeps the season in shared memory only up to "
            "period ", repro_torch::kHWSharedPeriodMax, ", got ", period);
    check(season_scratch, "season scratch", {0, B}, dev);
  } else {
    check(season_scratch, "season scratch", {period, B}, dev);
  }
  REQUIRE(!vec16 || repro_torch::holt_winters_vec16_ok(
                        in(y), in(out_), static_cast<int>(T)),
          "holt_winters' 16-B copies need T % 4 == 0 and 16-B aligned "
          "y and out");
  const c10::cuda::CUDAGuard guard(dev);
  repro_torch::holt_winters_launch(
      in(y), out(out_), out(season_scratch), static_cast<int>(B),
      static_cast<int>(T), static_cast<int>(period), shared_season, vec16,
      hw_coeffs(coeffs), at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("plant_block", &plant_block, "plant_block CUDA kernel");
  m.def("episode_smem", &episode_smem,
        "episode_block's shared memory per block and the device's limit");
  m.def("episode_block_hpa", &episode_block_hpa,
        "episode_block CUDA kernel, HPA policy");
  m.def("episode_block_aapa", &episode_block_aapa,
        "episode_block CUDA kernel, AAPA or (with a guard) hybrid policy");
  m.def("policy_signals_aapa", &policy_signals_aapa,
        "policy_signals CUDA kernels, AAPA and hybrid pre-pass");
  m.def("reclassify", &reclassify,
        "the AAPA and hybrid pre-pass's reclassifications: window_features, "
        "gbdt_tables and calibrate kernels");
  m.def("policy_signals_predictive", &policy_signals_predictive,
        "policy_signals CUDA kernel, predictive pre-pass");
  m.def("episode_block_predictive", &episode_block_predictive,
        "episode_block CUDA kernel, predictive policy");
  m.def("episode_block_kpa", &episode_block_kpa,
        "episode_block CUDA kernel, kpa policy");
  m.def("holt_winters", &holt_winters, "holt_winters CUDA kernel");
  m.def("window_features", &window_features, "window_features CUDA kernel");
  m.def("gbdt_logits", &gbdt_logits, "gbdt_tables CUDA kernel");
}
