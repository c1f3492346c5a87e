// episode_block: whole simulated episodes, plant ticks and the controller's
// decide in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/episode_block.py
// (episode_minutes, body _episode_kernel, minute body _make_minute_body).
// Plain version: repro_torch/kernels/ref.py::episode_block_ref (the
// control-period-blocked simulate).
//
// Design: one thread per lane with the whole minute loop inside the
// thread. The TPU grid's sequential minute axis becomes that loop, so the
// plant state (7 scalars), the minute accumulator (11) and the policy's
// scalars stay in registers for the whole episode. The only per-minute
// traffic is one rate read and the 12 MinuteOut stores. State that is
// indexed at run time lives in per-lane global scratch laid out
// [slots, B], so a warp's accesses coalesce:
//   * the S-slot startup pipeline is a ring with a head index: a pop reads
//     and clears the head slot and advances the head, a scale-up adds to
//     the slot behind the head (the logical tail), a scale-down rescales
//     the slots (skipped when the factor is exactly 1, where it is an
//     identity);
//   * HPA's stabilization window is a ring too; its max is order-free.
// decide and on_minute are device functions of a Policy type chosen at
// compile time (HPA here; kpa/predictive/aapa add their own Policy and the
// rate-history ring that those read). Hyperparameters, ci, S, M and the
// SimConfig floats are run-time arguments, so a sweep never rebuilds.
// Minute 0 starts from cluster.initial_state. A control interval that does
// not divide 60 (e.g. 7) ends each minute with a shorter remainder block.
//
// Bound on the H100: operations. Per lane-minute the kernel moves 52
// bytes (one rate in, 12 aggregates out) against ~60 ticks of ~45 f32
// operations. It runs at one thread per lane, so a 25,000-lane launch
// fills about a tenth of the card's thread slots and is latency-bound.
#include "plant.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;

struct LaneObs {
  float ready_total, ready, util_ema, queue, rate_rps;
};

// scaling/policies.py::hpa_controller
struct HPA {
  using Hyper = HPAHyper;
  struct State {
    float* buf;  // this lane's window ring, slot j at buf[j * B]
    int head;    // oldest entry
  };

  __device__ static State init(const Hyper& h, float* scratch, int b,
                               int B, float initial) {
    State s{scratch + b, 0};
    for (int j = 0; j < h.buf_len; ++j) s.buf[static_cast<size_t>(j) * B] = initial;
    return s;
  }

  __device__ static float decide(State& s, const Hyper& h,
                                 const LaneObs& o, int B, float& cool_req) {
    const float ratio = o.util_ema * h.inv_target;
    const bool in_band = fabsf(ratio - 1.0f) <= h.tolerance;
    float raw = ceilf(o.ready_total * ratio);
    raw = in_band ? o.ready_total : raw;
    // serverless scale-to-zero on sustained idle; traffic wakes it
    const bool idle =
        (o.util_ema < 0.02f) && (o.queue <= 0.0f) && (o.rate_rps <= 1e-6f);
    raw = idle ? 0.0f : fmaxf(raw, 1.0f);
    const bool wake = (o.rate_rps > 0.0f) || (o.queue > 0.0f);
    raw = wake ? fmaxf(raw, 1.0f) : raw;
    s.buf[static_cast<size_t>(s.head) * B] = raw;  // drop the oldest
    s.head = s.head + 1 == h.buf_len ? 0 : s.head + 1;
    float window_max = s.buf[0];
    for (int j = 1; j < h.buf_len; ++j)
      window_max = fmaxf(window_max, s.buf[static_cast<size_t>(j) * B]);
    const float stabilized = fmaxf(raw, window_max);
    const float desired = raw >= o.ready_total ? raw : stabilized;
    cool_req = h.cooldown_sec;
    return desired;
  }

  __device__ static void on_minute(State&, const Hyper&, int) {}
};

struct Acc {
  float served = 0.f, violated = 0.f, cold = 0.f, total = 0.f, resp_w = 0.f,
        resp_max = 0.f, ups = 0.f, downs = 0.f, osc = 0.f, util = 0.f,
        ready = 0.f;

  // cluster._acc_fold_plant; the head tick adds ups/downs/osc itself
  __device__ void fold(const TickOut& k, float total_now, float ready_now) {
    served = served + k.served;
    violated = violated + k.violated;
    cold = cold + k.cold;
    total = total + total_now;
    resp_w = resp_w + (k.served > 0.0f ? k.resp * k.served : 0.0f);
    resp_max = fmaxf(resp_max, k.resp);
    util = util + k.util;
    ready = ready + ready_now;
  }
};

template <class Policy>
__global__ void episode_kernel(const float* __restrict__ rates,
                               float* __restrict__ out,
                               float* __restrict__ pipe_scratch,
                               float* __restrict__ policy_scratch, int B,
                               int M, EpisodeCfg cfg,
                               typename Policy::Hyper hyper) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int S = cfg.startup_sec;
  const size_t sB = static_cast<size_t>(B);
  float* pipe = pipe_scratch + b;  // slot j at pipe[j * B]
  for (int j = 0; j < S; ++j) pipe[j * sB] = 0.0f;
  int head = 0;

  float ready = cfg.initial_replicas, queue = 0.0f, wait = 0.0f;
  float ema = 0.5f, cool = 0.0f, ps = 0.0f, last_dir = 0.0f;
  typename Policy::State pol =
      Policy::init(hyper, policy_scratch, b, B, cfg.initial_replicas);

  const int ci = cfg.ci;
  const int n_full = 60 / ci;
  const int rem = 60 - n_full * ci;
  const int n_blocks = n_full + (rem > 0 ? 1 : 0);
  const size_t plane = sB * M;
  const float* lane_rates = rates + static_cast<size_t>(b) * M;
  float* lane_out = out + static_cast<size_t>(b) * M;

  for (int m = 0; m < M; ++m) {
    const float rate = lane_rates[m];
    const float arr = rate * kInv60;
    Acc acc;
    for (int blk = 0; blk < n_blocks; ++blk) {
      const int n = blk < n_full ? ci : rem;

      // ---- block head: pop, flow tick, decide, limiter, scaling
      float popped = pipe[head * sB];
      pipe[head * sB] = 0.0f;
      head = head + 1 == S ? 0 : head + 1;
      ready = ready + popped;
      ps = fmaxf(ps - popped, 0.0f);
      const TickOut k = flow_tick(cfg.plant, ready, queue, wait, ema, arr);
      const float total = ready + ps;
      const LaneObs obs{total, ready, ema, queue, arr};
      float cool_req;
      float desired = Policy::decide(pol, hyper, obs, B, cool_req);
      desired = fminf(fmaxf(desired, 0.0f), cfg.max_replicas);

      // scaling/api.py::apply_decision (dt = 1 s)
      const bool up = desired > total + 0.5f;
      const bool down = (desired < total - 0.5f) && (cool <= 0.0f);
      const float add = up ? desired - total : 0.0f;
      const float remove = down ? total - desired : 0.0f;
      const float dir = up ? 1.0f : (down ? -1.0f : 0.0f);
      const float osc =
          (dir != 0.0f && last_dir != 0.0f && dir != last_dir) ? 1.0f : 0.0f;
      last_dir = dir != 0.0f ? dir : last_dir;
      cool = down ? cool_req : fmaxf(cool - 1.0f, 0.0f);

      // cluster._apply_scaling
      const int tail = head == 0 ? S - 1 : head - 1;
      pipe[tail * sB] = pipe[tail * sB] + add;
      ps = ps + add;
      const float n_start = ps;
      const float from_pipe = fminf(remove, n_start);
      const float factor = 1.0f - from_pipe / fmaxf(n_start, kEps);
      if (factor != 1.0f)
        for (int j = 0; j < S; ++j) pipe[j * sB] = pipe[j * sB] * factor;
      ps = ps * factor;
      ready = fmaxf(ready - (remove - from_pipe), 0.0f);

      acc.fold(k, ready + ps, ready);
      acc.ups = acc.ups + (up ? 1.0f : 0.0f);
      acc.downs = acc.downs + (down ? 1.0f : 0.0f);
      acc.osc = acc.osc + osc;

      // ---- decision-free plant ticks (cluster.advance_plant): the ring
      // is drained after S pops, so later ticks pop nothing
      for (int t = 0; t < n - 1; ++t) {
        if (t < S) {
          popped = pipe[head * sB];
          pipe[head * sB] = 0.0f;
          head = head + 1 == S ? 0 : head + 1;
          ready = ready + popped;
          ps = fmaxf(ps - popped, 0.0f);
        }
        const TickOut kt =
            flow_tick(cfg.plant, ready, queue, wait, ema, arr);
        acc.fold(kt, ready + ps, ready);
      }
      cool = fmaxf(cool - static_cast<float>(n - 1), 0.0f);
    }

    // MinuteOut, field order of cluster._minute_out
    float* o = lane_out + m;
    o[0] = acc.served;
    o[plane] = acc.violated;
    o[2 * plane] = acc.cold;
    o[3 * plane] = acc.total;
    o[4 * plane] = queue;
    o[5 * plane] = acc.resp_w;
    o[6 * plane] = acc.resp_max;
    o[7 * plane] = acc.ups;
    o[8 * plane] = acc.downs;
    o[9 * plane] = acc.osc;
    o[10 * plane] = acc.util * kInv60;
    o[11 * plane] = acc.ready * kInv60;
    Policy::on_minute(pol, hyper, m + 1);
  }
}

}  // namespace

void episode_block_hpa_launch(const float* rates, float* out, float* pipe,
                              float* buf, int B, int M, EpisodeCfg cfg,
                              HPAHyper hyper, cudaStream_t stream) {
  const int grid = (B + kThreads - 1) / kThreads;
  episode_kernel<HPA><<<grid, kThreads, 0, stream>>>(rates, out, pipe, buf,
                                                     B, M, cfg, hyper);
}

}  // namespace repro_torch
