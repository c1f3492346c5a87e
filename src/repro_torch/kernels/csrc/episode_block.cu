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
//   * HPA's stabilization window is a ring too; its max is order-free;
//   * AAPA's (and hybrid's) 60-minute rate history is a ring (oldest at
//     the head), and the Holt-Winters season of the AAPA, hybrid and
//     predictive forecasters (hw.cuh) is indexed by its phase.
// decide and on_minute are device functions of a Policy type chosen at
// compile time (HPA, AAPA, Hybrid, Predictive, KPA), the five policies of
// scaling/policies.py. Hyperparameters, ci, S, M and the SimConfig
// floats are run-time arguments, so a sweep never rebuilds. Minute 0
// starts from cluster.initial_state. A control interval that does not
// divide 60 (e.g. 7) ends each minute with a shorter remainder block.
//
// AAPA reclassifies inside the kernel, as the TPU kernel did: at every
// stride-th minute boundary a lane copies its history ring, oldest first,
// into local memory and runs the window-feature and GBDT device functions
// (features.cuh, gbdt.cuh) the standalone kernels run, then softmax, beta
// calibration and Algorithm 1. The 10 frequency features, which the TPU
// kernel could not lower (jnp.fft.rfft), come from the real FFT that
// jnp.fft.rfft runs on the CPU (features.cuh::radix_pass). Everything
// decide reads that changes only at a minute boundary (the forecaster's
// peak, the 30-minute trend, the 15-minute mean, the predictive policy's
// forecast need) is computed once there; KPA's state changes at every
// control-period head instead.
//
// Bound on the H100: operations. Per lane-minute the kernel moves 52
// bytes (one rate in, 12 aggregates out) against ~60 ticks of ~45 f32
// operations, plus the forecaster's and AAPA's trend work per minute and,
// every stride minutes, ~11,000 operations of features and trees. It runs at
// one thread per lane, so a 25,000-lane launch fills about a tenth of the
// card's thread slots and is latency-bound.
#include "features.cuh"
#include "gbdt.cuh"
#include "hw.cuh"
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
    int arch;    // no archetype (the kernel is launched without arch_out)
  };

  __device__ static State init(const Hyper& h, float* scratch, int b,
                               int B, float initial) {
    State s{scratch + b, 0, -1};
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

  __device__ static void on_minute(State&, const Hyper&, float, int, int) {}
};

constexpr int kHistory = 60;  // SimConfig.history_len, the feature window
constexpr int kTrendWindow = 30, kMeanWindow = 15;
constexpr float kOneMinusEps = 0.999999f;  // calibration's 1 - EPS clip

__device__ __forceinline__ float select4(int idx, const float* v) {
  return idx == 0 ? v[0] : (idx == 1 ? v[1] : (idx == 2 ? v[2] : v[3]));
}

// scaling/policies.py::aapa_controller with the Holt-Winters forecaster
// (forecast/models.py, core/forecasting.py) and a GBDT + beta-calibration
// classifier (core/pipeline.py::Classify) or the registry's constant one;
// with a conformal band (forecast/conformal.py) the interval confidence
// takes the band's half-width, and the scale of the `band` argument.
struct AAPA {
  using Hyper = AAPAHyper;
  struct State {
    float* hist;      // rate-history ring, slot j at hist[j * B]
    int head;         // oldest history slot
    HWForecaster fc;  // season in scratch after the history ring
    int arch;
    float conf, cpu_adj, cool_adj_min, minrep_adj;
    // pure functions of the history and the forecaster, refreshed at
    // each minute boundary: decide's forecast, trend and mean, per second
    float fc_rps, trend_rps, mean_rps;
  };

  __device__ static State init(const Hyper& h, float* scratch, int b, int B,
                               float) {
    State s;
    s.hist = scratch + b;
    for (int j = 0; j < kHistory; ++j) s.hist[static_cast<size_t>(j) * B] = 0.0f;
    s.head = 0;
    s.fc.init(scratch + static_cast<size_t>(kHistory) * B + b, h.hw, B);
    s.arch = 2;  // start conservative
    s.conf = 0.5f;
    s.cpu_adj = 0.5f;
    s.cool_adj_min = 5.0f;
    s.minrep_adj = 1.0f;
    s.fc_rps = s.trend_rps = s.mean_rps = 0.0f;  // all-zero history
    return s;
  }

  // history slot of minute j of the window, j = 0 the oldest
  __device__ static float hist_at(const State& s, int j, int B) {
    const int slot = s.head + j < kHistory ? s.head + j : s.head + j - kHistory;
    return s.hist[static_cast<size_t>(slot) * B];
  }

  // the classifier on the lane's 60-minute window, oldest first
  __device__ static void reclassify(State& s, const Hyper& h, int B) {
    if (h.classify == 0) {  // scaling/registry.py::default_classify
      s.arch = 2;
      s.conf = 0.5f;
      return;
    }
    float x[kHistory], xs[kHistory], feats[kFeatures];
    for (int j = 0; j < kHistory; ++j) x[j] = hist_at(s, j, B);
    stat_time_features(x, xs, kHistory, feats);
    freq_features(x, kHistory, h.freq, feats + kStatFeatures);
    int bins[kMaxGBDTFeatures];
    float logits[4];
    gbdt_logits(h.gbdt, feats, bins, logits);
    // core/gbdt.py::softmax, core/calibration.py::calibrate
    const float lmax = fmaxf(fmaxf(logits[0], logits[1]),
                             fmaxf(logits[2], logits[3]));
    float u[4], q[4];
    for (int k = 0; k < 4; ++k) u[k] = rexp(logits[k] - lmax);
    const float usum = ((u[0] + u[1]) + u[2]) + u[3];
    for (int k = 0; k < 4; ++k) {
      const float p = fminf(fmaxf(u[k] / usum, kFeatEps), kOneMinusEps);
      const float z = __ldg(h.cal.a + k) * rlog(p) -
                      __ldg(h.cal.b + k) * rlog1p(-p) + __ldg(h.cal.c + k);
      q[k] = 1.0f / (1.0f + rexp(-z));
    }
    const float qsum = ((q[0] + q[1]) + q[2]) + q[3] + kFeatEps;
    int arch = 0;
    float conf = q[0] / qsum;
    for (int k = 1; k < 4; ++k) {
      const float ck = q[k] / qsum;
      if (ck > conf) {
        conf = ck;
        arch = k;
      }
    }
    s.arch = arch;
    s.conf = conf;
  }

  __device__ static void on_minute(State& s, const Hyper& h, float rate,
                                   int minute_idx, int B) {
    // cluster._finish_minute: the minute's rate replaces the oldest slot
    s.hist[static_cast<size_t>(s.head) * B] = rate;
    s.head = s.head + 1 == kHistory ? 0 : s.head + 1;

    // the forecaster observes the newest history entry
    s.fc.update(h.hw, rate, B);
    const float point = fmaxf(s.fc.forecast_max(h.hw, h.horizon_min, B), 0.0f);

    if (minute_idx % h.stride_min == 0) {
      reclassify(s, h, B);
      if (h.forecast_confidence) {  // forecast/api.py interval_confidence
        const float half = h.use_band ? h.band_q * h.sqrt_h
                                      : (h.z * s.fc.resid) * h.sqrt_h;
        const float lo = fmaxf(point - half, 0.0f);
        const float hi = point + half;
        const float width = fmaxf(hi - lo, 0.0f);
        const float sc = fmaxf(h.use_scale ? h.band_scale : point, 1.0f);
        s.conf = s.conf * (sc / (sc + width));
      }
      // core/uncertainty.py::adjust on the Table III row
      const float c = fminf(fmaxf(s.conf, 0.0f), 1.0f);
      const float m = 1.0f + 0.5f * (1.0f - c);
      s.cpu_adj = select4(s.arch, h.target_cpu) * (1.0f - 0.2f * (1.0f - c));
      s.cool_adj_min = select4(s.arch, h.cooldown_min) * m;
      s.minrep_adj = ceilf(select4(s.arch, h.min_replicas) * m);
    }

    // what decide reads until the next minute boundary
    s.fc_rps = fmaxf(point, 0.0f) * kInv60;
    const int t0 = kHistory - kTrendWindow;
    const float tmean = xla_sum(kTrendWindow, [&](int j) { return hist_at(s, t0 + j, B); }) *
                        (1.0f / static_cast<float>(kTrendWindow));
    const float cov = xla_sum(kTrendWindow, [&](int j) {
      return (static_cast<float>(j) - h.trend_tbar) * (hist_at(s, t0 + j, B) - tmean);
    }) * (1.0f / static_cast<float>(kTrendWindow));
    const float slope = cov / h.trend_tvar;
    s.trend_rps = fmaxf(tmean + slope * h.trend_step, 0.0f) * kInv60;
    const int m0 = kHistory - kMeanWindow;
    s.mean_rps = xla_sum(kMeanWindow, [&](int j) { return hist_at(s, m0 + j, B); }) *
                 (1.0f / static_cast<float>(kMeanWindow)) * kInv60;
  }

  __device__ static float decide(State& s, const Hyper& h, const LaneObs& o,
                                 int, float& cool_req) {
    const float cpu = fmaxf(s.cpu_adj, 0.05f);
    const float cap = h.rps_per_replica * cpu;
    // reactive component (archetype-specific utilization target)
    const float ratio = o.util_ema / cpu;
    float reactive = ceilf(o.ready_total * ratio);
    reactive = fabsf(ratio - 1.0f) <= 0.1f ? o.ready_total : reactive;
    // strategy components (paper Table III)
    const float need_now = ceilf(o.rate_rps / cap);
    const float strat[4] = {
        ceilf(s.fc_rps / cap),                                  // PERIODIC
        need_now + select4(s.arch, h.warm_pool) + s.minrep_adj,  // SPIKE
        ceilf(s.mean_rps / cap),                                // STATIONARY
        ceilf(fmaxf(s.trend_rps, o.rate_rps) / cap)};           // RAMP
    cool_req = s.cool_adj_min * 60.0f;
    return fmaxf(fmaxf(reactive, select4(s.arch, strat)),
                 fmaxf(s.minrep_adj, 1.0f));
  }
};

// scaling/policies.py::hybrid_controller: AAPA's state, minute hook and
// decide, the decision floored by live utilization and its scale-down
// step bounded
struct Hybrid {
  using Hyper = HybridHyper;
  using State = AAPA::State;

  __device__ static State init(const Hyper& h, float* scratch, int b, int B,
                               float initial) {
    return AAPA::init(h.aapa, scratch, b, B, initial);
  }

  __device__ static void on_minute(State& s, const Hyper& h, float rate,
                                   int minute_idx, int B) {
    AAPA::on_minute(s, h.aapa, rate, minute_idx, B);
  }

  __device__ static float decide(State& s, const Hyper& h, const LaneObs& o,
                                 int B, float& cool_req) {
    const float desired = AAPA::decide(s, h.aapa, o, B, cool_req);
    const float floor = fmaxf(ceilf((o.ready_total * o.util_ema) * h.inv_guard),
                              ceilf(o.rate_rps * h.inv_rps_guard));
    const float guarded = fmaxf(desired, floor);
    const float step_floor = ceilf(o.ready_total * h.down_keep);
    return guarded < o.ready_total ? fmaxf(guarded, step_floor) : guarded;
  }
};

// scaling/policies.py::predictive_controller with the Holt-Winters
// forecaster, native or conformal band
struct Predictive {
  using Hyper = PredictiveHyper;
  struct State {
    HWForecaster fc;
    float need_pred;  // replicas the horizon's forecast needs (per minute)
    int arch;         // no archetype
  };

  // the forecast's replica need; it changes only when the forecaster
  // observes a minute
  __device__ static float forecast_need(const State& s, const Hyper& h,
                                        int B) {
    float pred = fmaxf(s.fc.forecast_max(h.hw, h.horizon_min, B), 0.0f);
    if (h.conservative)
      pred = pred + (h.use_band ? h.band_q * h.sqrt_h
                                : (h.z * s.fc.resid) * h.sqrt_h);
    return (fmaxf(pred, 0.0f) * kInv60) * h.inv_cap;
  }

  __device__ static State init(const Hyper& h, float* scratch, int b, int B,
                               float) {
    State s;
    s.fc.init(scratch + b, h.hw, B);
    s.arch = -1;
    s.need_pred = forecast_need(s, h, B);
    return s;
  }

  __device__ static void on_minute(State& s, const Hyper& h, float rate, int,
                                   int B) {
    s.fc.update(h.hw, rate, B);
    s.need_pred = forecast_need(s, h, B);
  }

  __device__ static float decide(State& s, const Hyper& h, const LaneObs& o,
                                 int, float& cool_req) {
    const float desired = ceilf(fmaxf(s.need_pred, o.rate_rps * h.inv_cap));
    // scale to zero when neither live traffic nor the forecast needs pods
    const bool idle =
        (desired < 1.0f) && (o.queue <= 0.0f) && (o.rate_rps <= 1e-6f);
    cool_req = h.cooldown_sec;
    return idle ? 0.0f : fmaxf(desired, 1.0f);
  }
};

// scaling/policies.py::kpa_controller: stable and panic EMAs of the
// estimated concurrency, updated at every control-period head
struct KPA {
  using Hyper = KPAHyper;
  struct State {
    float stable, panic, panic_left, panic_max;
    int arch;  // no archetype
  };

  __device__ static State init(const Hyper&, float*, int, int, float) {
    return State{0.0f, 0.0f, 0.0f, 0.0f, -1};
  }

  __device__ static void on_minute(State&, const Hyper&, float, int, int) {}

  __device__ static float decide(State& s, const Hyper& h, const LaneObs& o,
                                 int, float& cool_req) {
    const float conc = o.queue + o.rate_rps * h.service_sec;
    const float stable = s.stable + h.a_s * (conc - s.stable);
    const float panic = s.panic + h.a_p * (conc - s.panic);
    const float want_stable = ceilf(stable * h.inv_tgt);
    const float want_panic = ceilf(panic * h.inv_tgt);
    const float fleet = fmaxf(o.ready_total, 1.0f);
    const bool enter = want_panic >= h.panic_threshold * fleet;
    const float panic_left =
        enter ? h.stable_window_s : fmaxf(s.panic_left - h.dt, 0.0f);
    const bool in_panic = panic_left > 0.0f;
    const float panic_max =
        in_panic ? fmaxf(s.panic_left > 0.0f ? s.panic_max : 0.0f,
                         fmaxf(want_panic, fleet))
                 : 0.0f;
    float desired = in_panic ? panic_max : want_stable;
    // scale-to-zero on a truly idle stable window; wake on traffic
    const bool idle =
        (stable <= 1e-3f) && (o.queue <= 0.0f) && (o.rate_rps <= 1e-6f);
    desired = idle ? 0.0f : fmaxf(desired, 1.0f);
    s.stable = stable;
    s.panic = panic;
    s.panic_left = panic_left;
    s.panic_max = panic_max;
    cool_req = h.cooldown_sec;
    return desired;
  }
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
                               float* __restrict__ policy_scratch,
                               int* __restrict__ arch_out, int B, int M,
                               EpisodeCfg cfg,
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
    Policy::on_minute(pol, hyper, rate, m + 1, B);
    if (arch_out) arch_out[static_cast<size_t>(b) * M + m] = pol.arch;
  }
}

}  // namespace

void episode_block_hpa_launch(const float* rates, float* out, float* pipe,
                              float* buf, int B, int M, EpisodeCfg cfg,
                              HPAHyper hyper, cudaStream_t stream) {
  const int grid = (B + kThreads - 1) / kThreads;
  episode_kernel<HPA><<<grid, kThreads, 0, stream>>>(
      rates, out, pipe, buf, nullptr, B, M, cfg, hyper);
}

void episode_block_aapa_launch(const float* rates, float* out, float* pipe,
                               float* scratch, int* arch_out, int B, int M,
                               EpisodeCfg cfg, AAPAHyper hyper,
                               cudaStream_t stream) {
  const int grid = (B + kThreads - 1) / kThreads;
  episode_kernel<AAPA><<<grid, kThreads, 0, stream>>>(
      rates, out, pipe, scratch, arch_out, B, M, cfg, hyper);
}

void episode_block_hybrid_launch(const float* rates, float* out, float* pipe,
                                 float* scratch, int* arch_out, int B, int M,
                                 EpisodeCfg cfg, HybridHyper hyper,
                                 cudaStream_t stream) {
  const int grid = (B + kThreads - 1) / kThreads;
  episode_kernel<Hybrid><<<grid, kThreads, 0, stream>>>(
      rates, out, pipe, scratch, arch_out, B, M, cfg, hyper);
}

void episode_block_predictive_launch(const float* rates, float* out,
                                     float* pipe, float* season, int B,
                                     int M, EpisodeCfg cfg,
                                     PredictiveHyper hyper,
                                     cudaStream_t stream) {
  const int grid = (B + kThreads - 1) / kThreads;
  episode_kernel<Predictive><<<grid, kThreads, 0, stream>>>(
      rates, out, pipe, season, nullptr, B, M, cfg, hyper);
}

void episode_block_kpa_launch(const float* rates, float* out, float* pipe,
                              int B, int M, EpisodeCfg cfg, KPAHyper hyper,
                              cudaStream_t stream) {
  const int grid = (B + kThreads - 1) / kThreads;
  episode_kernel<KPA><<<grid, kThreads, 0, stream>>>(
      rates, out, pipe, nullptr, nullptr, B, M, cfg, hyper);
}

}  // namespace repro_torch
