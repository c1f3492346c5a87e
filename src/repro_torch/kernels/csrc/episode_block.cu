// episode_block: the plant pass of whole simulated episodes, the plant's
// ticks and the controller's decide for every lane and minute in one
// launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/episode_block.py
// (episode_minutes, body _episode_kernel, minute body _make_minute_body)
// together with its pre-pass policy_signals.cu. Plain version of the
// episode: repro_torch/kernels/ref.py::episode_block_ref (the
// control-period-blocked simulate); of this pass alone, given the
// pre-pass's signals: ref.py::plant_pass_ref.
//
// Design. What a policy's minute hook computes reads only the input rates,
// so the pre-pass (policy_signals.cu) has computed it for every lane and
// minute before this kernel runs; what is left here is the plant's
// recurrence and decide, a dependent chain per lane. One thread per lane
// walks the minutes with the plant state (7 scalars), the minute
// accumulator (11) and the policy's few scalars in registers; AAPA's and
// hybrid's decide reads its archetype, Algorithm 1's parameters and the
// forecast, trend and mean from the signals and carries no feature array.
// A block is one warp of 32 lanes. Its state indexed at run time lives in
// dynamic shared memory, laid out [slot][lane] so that a warp's access to
// one slot hits 32 banks:
//   * the S-slot startup pipeline, a ring whose head every lane shares: a
//     pop clears the head slot and advances the head, a scale-up adds to
//     the slot behind the head (the logical tail), a scale-down rescales
//     the slots (skipped when the factor is exactly 1, an identity). The
//     head slot's value is loaded a tick ahead of its pop (again after a
//     head's scaling), off the tick's dependent chain;
//   * HPA's stabilization window, a ring of buf_len decisions (its max is
//     order-free).
// Rates come in and the 12 MinuteOut fields go out through shared-memory
// tiles of 8 minutes, so that global loads and stores move whole 32-byte
// sectors of each lane's row where one word of 32 rows moved before. The
// signals, laid out [minute, lane], are read straight from global memory,
// one minute ahead of their use. The shared memory is
// episode_smem_bytes(S, ring_len); S and buf_len that do not fit at 32
// lanes a block are refused by the launcher. Hyperparameters, ci, S, M and
// the SimConfig floats are run-time arguments, so a sweep never rebuilds.
// Minute 0 starts from cluster.initial_state. A control interval that does
// not divide 60 (e.g. 7) ends each minute with a shorter remainder block.
//
// Bound on the H100: operations. Per lane-minute the episode moves 52
// bytes (one rate in, 12 aggregates out) against ~60 ticks of ~45 f32
// operations. A tick's chain (the pipeline pop, the plant's divisions,
// the EMAs) is sequential per lane, and a 25,000-lane launch holds ~6
// warps on each SM, so the pass is bound by that chain and by the
// instructions each tick issues. Most of those were the IEEE divisions'
// slow path, which a zero dividend (an empty queue, a minute without
// arrivals) takes: numerics.cuh::fdiv skips it.
#include "plant.cuh"

namespace repro_torch {
namespace {

constexpr int kLanes = 32;             // lanes (threads) per block: a warp
constexpr int kTile = 8;               // minutes per staged tile
constexpr int kRow = kTile + 1;        // a lane's tile row: conflict-free
constexpr int kFields = 12;            // MinuteOut fields
constexpr int kTileWords = kLanes * kRow;

struct LaneObs {
  float ready_total, ready, util_ema, queue, rate_rps;
};

// Each policy: its ring's slots in shared memory (0: none), init, a
// minute hook at the start of every minute (the signals it reads) and
// decide at every control-period head.

// scaling/policies.py::hpa_controller
struct HPA {
  using Hyper = HPAHyper;
  struct State {
    float* buf;  // this lane's window ring, slot j at buf[j * kLanes]
    int head;    // oldest entry
  };

  static int ring_len(const Hyper& h) { return h.buf_len; }

  __device__ static State init(const Hyper& h, float* ring,
                               const PolicySignals&, int, int, int,
                               float initial) {
    for (int j = 0; j < h.buf_len; ++j) ring[j * kLanes] = initial;
    return State{ring, 0};
  }

  __device__ static void minute(State&, const Hyper&, const PolicySignals&,
                                int, int, int, int) {}

  __device__ static float decide(State& s, const Hyper& h, const LaneObs& o,
                                 float& cool_req) {
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
    s.buf[s.head * kLanes] = raw;  // drop the oldest
    s.head = s.head + 1 == h.buf_len ? 0 : s.head + 1;
    float window_max = s.buf[0];
    for (int j = 1; j < h.buf_len; ++j)
      window_max = fmaxf(window_max, s.buf[j * kLanes]);
    const float stabilized = fmaxf(raw, window_max);
    const float desired = raw >= o.ready_total ? raw : stabilized;
    cool_req = h.cooldown_sec;
    return desired;
  }
};

// scaling/policies.py::aapa_decide on the pre-pass's signals: the
// archetype and Algorithm 1's parameters of the current reclassification
// slot, the forecast, trend and mean of the current minute
struct AAPA {
  using Hyper = AAPAPlantHyper;
  struct State {
    int arch;
    float cpu_adj, cool_adj_min, minrep_adj, fc_rps, trend_rps, mean_rps;
    // the next minute's, loaded a minute ahead
    int n_arch;
    float n_cpu, n_cool, n_minrep, n_fc, n_trend, n_mean;
  };

  static int ring_len(const Hyper&) { return 0; }

  // minute m's signals into the n_ fields (its slot's when m starts one)
  __device__ static void load(State& s, const Hyper& h,
                              const PolicySignals& g, int m, int b, int B,
                              int M) {
    const size_t sB = static_cast<size_t>(B);
    const size_t plane = sB * M, at = static_cast<size_t>(m) * sB + b;
    s.n_fc = __ldg(g.rps + at);
    s.n_trend = __ldg(g.rps + plane + at);
    s.n_mean = __ldg(g.rps + 2 * plane + at);
    if (m % h.stride_min == 0) {
      const size_t rplane = sB * g.R;
      const size_t rat = static_cast<size_t>(m / h.stride_min) * sB + b;
      s.n_arch = __ldg(g.arch + rat);
      s.n_cpu = __ldg(g.adj + rat);
      s.n_cool = __ldg(g.adj + rplane + rat);
      s.n_minrep = __ldg(g.adj + 2 * rplane + rat);
    }
  }

  __device__ static State init(const Hyper& h, float*,
                               const PolicySignals& g, int b, int B, int M,
                               float) {
    State s;
    load(s, h, g, 0, b, B, M);
    return s;
  }

  __device__ static void minute(State& s, const Hyper& h,
                                const PolicySignals& g, int m, int b, int B,
                                int M) {
    s.fc_rps = s.n_fc;
    s.trend_rps = s.n_trend;
    s.mean_rps = s.n_mean;
    if (m % h.stride_min == 0) {
      s.arch = s.n_arch;
      s.cpu_adj = s.n_cpu;
      s.cool_adj_min = s.n_cool;
      s.minrep_adj = s.n_minrep;
    }
    if (m + 1 < M) load(s, h, g, m + 1, b, B, M);
  }

  __device__ static float decide(State& s, const Hyper& h, const LaneObs& o,
                                 float& cool_req) {
    const float cpu = fmaxf(s.cpu_adj, 0.05f);
    const float cap = h.rps_per_replica * cpu;
    // reactive component (archetype-specific utilization target)
    const float ratio = fdiv(o.util_ema, cpu);
    float reactive = ceilf(o.ready_total * ratio);
    reactive = fabsf(ratio - 1.0f) <= 0.1f ? o.ready_total : reactive;
    // the archetype's strategy (paper Table III); decide selects one of
    // four, so only that one is computed
    float strat;
    if (s.arch == 1) {  // SPIKE
      strat = ceilf(fdiv(o.rate_rps, cap)) + h.warm_pool[1] + s.minrep_adj;
    } else {            // PERIODIC, STATIONARY, RAMP
      const float need = s.arch == 0   ? s.fc_rps
                         : s.arch == 2 ? s.mean_rps
                                       : fmaxf(s.trend_rps, o.rate_rps);
      strat = ceilf(fdiv(need, cap));
    }
    cool_req = s.cool_adj_min * 60.0f;
    return fmaxf(fmaxf(reactive, strat), fmaxf(s.minrep_adj, 1.0f));
  }
};

// scaling/policies.py::hybrid_controller: AAPA's decide inside
// hybrid_guard (a floor from live utilization, a bounded scale-down step)
struct Hybrid {
  using Hyper = HybridPlantHyper;
  using State = AAPA::State;

  static int ring_len(const Hyper&) { return 0; }

  __device__ static State init(const Hyper& h, float* ring,
                               const PolicySignals& g, int b, int B, int M,
                               float initial) {
    return AAPA::init(h.aapa, ring, g, b, B, M, initial);
  }

  __device__ static void minute(State& s, const Hyper& h,
                                const PolicySignals& g, int m, int b, int B,
                                int M) {
    AAPA::minute(s, h.aapa, g, m, b, B, M);
  }

  __device__ static float decide(State& s, const Hyper& h, const LaneObs& o,
                                 float& cool_req) {
    const float desired = AAPA::decide(s, h.aapa, o, cool_req);
    const float floor = fmaxf(ceilf((o.ready_total * o.util_ema) * h.inv_guard),
                              ceilf(o.rate_rps * h.inv_rps_guard));
    const float guarded = fmaxf(desired, floor);
    const float step_floor = ceilf(o.ready_total * h.down_keep);
    return guarded < o.ready_total ? fmaxf(guarded, step_floor) : guarded;
  }
};

// scaling/policies.py::predictive_decide on the pre-pass's forecast need
struct Predictive {
  using Hyper = PredictivePlantHyper;
  struct State {
    float need_pred, n_need;  // this minute's, and the next one's
  };

  static int ring_len(const Hyper&) { return 0; }

  __device__ static State init(const Hyper&, float*, const PolicySignals& g,
                               int b, int, int, float) {
    return State{0.0f, __ldg(g.rps + b)};
  }

  __device__ static void minute(State& s, const Hyper&,
                                const PolicySignals& g, int m, int b, int B,
                                int M) {
    s.need_pred = s.n_need;
    if (m + 1 < M)
      s.n_need = __ldg(g.rps + static_cast<size_t>(m + 1) * B + b);
  }

  __device__ static float decide(State& s, const Hyper& h, const LaneObs& o,
                                 float& cool_req) {
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
  };

  static int ring_len(const Hyper&) { return 0; }

  __device__ static State init(const Hyper&, float*, const PolicySignals&,
                               int, int, int, float) {
    return State{0.0f, 0.0f, 0.0f, 0.0f};
  }

  __device__ static void minute(State&, const Hyper&, const PolicySignals&,
                                int, int, int, int) {}

  __device__ static float decide(State& s, const Hyper& h, const LaneObs& o,
                                 float& cool_req) {
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
__global__ void __launch_bounds__(kLanes)
    episode_kernel(const float* __restrict__ rates, float* __restrict__ out,
                   PolicySignals sig, int B, int M, EpisodeCfg cfg,
                   typename Policy::Hyper hyper, int ring_len) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int b0 = blockIdx.x * kLanes;
  const int n_lanes = min(kLanes, B - b0);
  const bool active = lane < n_lanes;
  const int b = b0 + lane;
  const int S = cfg.startup_sec;
  float* pipe = smem + lane;                      // slot j at pipe[j * kLanes]
  float* ring = smem + S * kLanes + lane;         // the policy's ring
  float* rate_tile = smem + (S + ring_len) * kLanes;  // [lane][minute]
  float* out_tile = rate_tile + kTileWords;       // [field][lane][minute]

  for (int j = 0; j < S; ++j) pipe[j * kLanes] = 0.0f;
  int head = 0;
  float next_pop = 0.0f;  // pipe[head], loaded a tick ahead of its pop
  float ready = cfg.initial_replicas, queue = 0.0f, wait = 0.0f;
  float ema = 0.5f, cool = 0.0f, ps = 0.0f, last_dir = 0.0f;
  typename Policy::State pol;
  if (active)
    pol = Policy::init(hyper, ring, sig, b, B, M, cfg.initial_replicas);

  const int ci = cfg.ci;
  const int n_full = 60 / ci;
  const int rem = 60 - n_full * ci;
  const int n_blocks = n_full + (rem > 0 ? 1 : 0);
  const size_t plane = static_cast<size_t>(B) * M;

  for (int m0 = 0; m0 < M; m0 += kTile) {
    const int tm = min(kTile, M - m0);
    // stage the tile's rates: each load moves a run of one lane's row
    for (int i = lane; i < kLanes * kTile; i += kLanes) {
      const int r = i / kTile, k = i % kTile;
      if (r < n_lanes && k < tm)
        rate_tile[r * kRow + k] =
            __ldg(rates + static_cast<size_t>(b0 + r) * M + m0 + k);
    }
    __syncwarp();

    for (int k = 0; active && k < tm; ++k) {
      Policy::minute(pol, hyper, sig, m0 + k, b, B, M);
      const float arr = rate_tile[lane * kRow + k] * kInv60;
      Acc acc;
      for (int blk = 0; blk < n_blocks; ++blk) {
        const int n = blk < n_full ? ci : rem;

        // ---- block head: pop, flow tick, decide, limiter, scaling
        float popped = next_pop;
        pipe[head * kLanes] = 0.0f;
        head = head + 1 == S ? 0 : head + 1;
        ready = ready + popped;
        ps = fmaxf(ps - popped, 0.0f);
        const TickOut t = flow_tick(cfg.plant, ready, queue, wait, ema, arr);
        const float total = ready + ps;
        const LaneObs obs{total, ready, ema, queue, arr};
        float cool_req;
        float desired = Policy::decide(pol, hyper, obs, cool_req);
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
        pipe[tail * kLanes] = pipe[tail * kLanes] + add;
        ps = ps + add;
        const float n_start = ps;
        const float from_pipe = fminf(remove, n_start);
        const float factor = 1.0f - fdiv(from_pipe, fmaxf(n_start, kEps));
        if (factor != 1.0f)
          for (int j = 0; j < S; ++j)
            pipe[j * kLanes] = pipe[j * kLanes] * factor;
        ps = ps * factor;
        ready = fmaxf(ready - (remove - from_pipe), 0.0f);
        next_pop = pipe[head * kLanes];  // the scaling may have changed it

        acc.fold(t, ready + ps, ready);
        acc.ups = acc.ups + (up ? 1.0f : 0.0f);
        acc.downs = acc.downs + (down ? 1.0f : 0.0f);
        acc.osc = acc.osc + osc;

        // ---- decision-free plant ticks (cluster.advance_plant): the ring
        // is drained after S pops, so later ticks pop nothing
        for (int j = 0; j < n - 1; ++j) {
          if (j < S) {
            popped = next_pop;
            pipe[head * kLanes] = 0.0f;
            head = head + 1 == S ? 0 : head + 1;
            next_pop = pipe[head * kLanes];
            ready = ready + popped;
            ps = fmaxf(ps - popped, 0.0f);
          }
          const TickOut tj =
              flow_tick(cfg.plant, ready, queue, wait, ema, arr);
          acc.fold(tj, ready + ps, ready);
        }
        cool = fmaxf(cool - static_cast<float>(n - 1), 0.0f);
      }

      // MinuteOut, field order of cluster._minute_out
      float* o = out_tile + lane * kRow + k;
      o[0] = acc.served;
      o[kTileWords] = acc.violated;
      o[2 * kTileWords] = acc.cold;
      o[3 * kTileWords] = acc.total;
      o[4 * kTileWords] = queue;
      o[5 * kTileWords] = acc.resp_w;
      o[6 * kTileWords] = acc.resp_max;
      o[7 * kTileWords] = acc.ups;
      o[8 * kTileWords] = acc.downs;
      o[9 * kTileWords] = acc.osc;
      o[10 * kTileWords] = acc.util * kInv60;
      o[11 * kTileWords] = acc.ready * kInv60;
    }
    __syncwarp();

    // write the tile back: each store moves a run of one lane's row
    for (int f = 0; f < kFields; ++f)
      for (int i = lane; i < kLanes * kTile; i += kLanes) {
        const int r = i / kTile, k = i % kTile;
        if (r < n_lanes && k < tm)
          out[f * plane + static_cast<size_t>(b0 + r) * M + m0 + k] =
              out_tile[f * kTileWords + r * kRow + k];
      }
    __syncwarp();  // the next tile overwrites the tiles only after this
  }
}

template <class Policy>
void launch(const float* rates, float* out, PolicySignals sig, int B, int M,
            EpisodeCfg cfg, typename Policy::Hyper hyper,
            cudaStream_t stream) {
  const int ring_len = Policy::ring_len(hyper);
  const int bytes = episode_smem_bytes(cfg.startup_sec, ring_len);
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(episode_kernel<Policy>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const int grid = (B + kLanes - 1) / kLanes;
  episode_kernel<Policy><<<grid, kLanes, bytes, stream>>>(
      rates, out, sig, B, M, cfg, hyper, ring_len);
}

}  // namespace

int episode_smem_bytes(int S, int ring_len) {
  return static_cast<int>(sizeof(float)) *
         ((S + ring_len) * kLanes + (1 + kFields) * kTileWords);
}

void episode_block_hpa_launch(const float* rates, float* out, int B, int M,
                              EpisodeCfg cfg, HPAHyper hyper,
                              cudaStream_t stream) {
  launch<HPA>(rates, out, PolicySignals{}, B, M, cfg, hyper, stream);
}

void episode_block_kpa_launch(const float* rates, float* out, int B, int M,
                              EpisodeCfg cfg, KPAHyper hyper,
                              cudaStream_t stream) {
  launch<KPA>(rates, out, PolicySignals{}, B, M, cfg, hyper, stream);
}

void episode_block_predictive_launch(const float* rates, float* out,
                                     PolicySignals sig, int B, int M,
                                     EpisodeCfg cfg,
                                     PredictivePlantHyper hyper,
                                     cudaStream_t stream) {
  launch<Predictive>(rates, out, sig, B, M, cfg, hyper, stream);
}

void episode_block_aapa_launch(const float* rates, float* out,
                               PolicySignals sig, int B, int M,
                               EpisodeCfg cfg, AAPAPlantHyper hyper,
                               cudaStream_t stream) {
  launch<AAPA>(rates, out, sig, B, M, cfg, hyper, stream);
}

void episode_block_hybrid_launch(const float* rates, float* out,
                                 PolicySignals sig, int B, int M,
                                 EpisodeCfg cfg, HybridPlantHyper hyper,
                                 cudaStream_t stream) {
  launch<Hybrid>(rates, out, sig, B, M, cfg, hyper, stream);
}

}  // namespace repro_torch
