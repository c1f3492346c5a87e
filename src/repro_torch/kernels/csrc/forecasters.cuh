// The in-episode forecasters of forecast/models.py on the card, one lane
// per thread, as the pre-pass's minute walks run them (policy_signals.cu).
// Each is a compile-time choice of the walks; its hyperparameters
// (FcHyper) are run-time values, so a sweep over them does not rebuild.
//
// Every forecaster carries forecast/api.py's residual EWMA: `update(y)`
// first moves `resid` towards |y - the one-step point forecast| of the
// state before the update, then updates the state. `point(h, horizon)` is
// the peak point forecast over the next `horizon` minutes, clamped at 0 as
// the models' point functions clamp it. State that a lane indexes at run
// time (Holt-Winters' and seasonal naive's season, linear trend's window)
// lives in [slot, B] global scratch, slot j of lane b at scratch[j * B + b],
// as holt_winters.cu keeps its season: a warp's reads of one slot coalesce
// and no per-lane array sits on the stack.
#pragma once

#include <cmath>

#include "hw.cuh"
#include "numerics.cuh"

namespace repro_torch {

// forecast/models.py::holt_winters_forecaster: Holt-Winters state, the
// season in scratch rows 0 .. period - 1.
struct HoltWintersFc {
  float* season;
  int t;  // phase counter
  float level, trend, resid;

  __device__ void init(float* lane_scratch, const FcHyper& h, int B) {
    season = lane_scratch;
    for (int p = 0; p < h.slots; ++p)
      season[static_cast<size_t>(p) * B] = 0.0f;
    t = 0;
    level = trend = resid = 0.0f;
  }

  // core/forecasting.py::hw_forecast_max: the peak of the next `horizon`
  // steps, clamped at 0
  __device__ float point(const FcHyper& h, int horizon, int B) const {
    float best = -INFINITY;
    for (int k = 1; k <= horizon; ++k) {
      const int phase = (t + k - 1) % h.slots;
      const float pred = (level + static_cast<float>(k) * trend) +
                         season[static_cast<size_t>(phase) * B];
      best = fmaxf(best, pred);
    }
    return fmaxf(best, 0.0f);
  }

  __device__ void update(const FcHyper& h, float y, int B) {
    const float pred1 = point(h, 1, B);
    resid = resid + h.resid_rho * (fabsf(y - pred1) - resid);
    hw_step(level, trend, season[static_cast<size_t>(t % h.slots) * B], y,
            h.hw);
    t = t + 1;
  }
};

// forecast/models.py::linear_trend_forecaster: the OLS line over the last
// `window` observations (zeros before the first), in a scratch ring whose
// oldest entry is row t % window. core/forecasting.py::
// linear_trend_forecast: mean and slope summed in XLA's order, the f32
// reciprocal of the window where XLA multiplies by one, the slope's
// division by tvar IEEE. The line's values at h = 1 and at the horizon
// are kept from the last update: the next update's residual reads the
// first, and the peak over the horizon is the larger of the two (a line
// attains its maximum at an end).
struct LinearTrendFc {
  float* ring;
  int t;  // observations so far: the oldest entry sits in row t % window
  float at1, at_h, resid;

  __device__ void refresh(const FcHyper& h, int B) {
    const int n = h.slots;
    const int head = t % n;
    const auto at = [&](int j) {
      const int slot = head + j < n ? head + j : head + j - n;
      return ring[static_cast<size_t>(slot) * B];
    };
    const float mean = xla_sum(n, at) * h.inv_n;
    const float cov = xla_sum(n, [&](int j) {
      return (static_cast<float>(j) - h.tbar) * (at(j) - mean);
    }) * h.inv_n;
    const float slope = fdiv(cov, h.tvar);
    at1 = fmaxf(mean + slope * h.step_1, 0.0f);
    at_h = fmaxf(mean + slope * h.step_h, 0.0f);
  }

  __device__ void init(float* lane_scratch, const FcHyper& h, int B) {
    ring = lane_scratch;
    for (int j = 0; j < h.slots; ++j) ring[static_cast<size_t>(j) * B] = 0.0f;
    t = 0;
    resid = 0.0f;
    refresh(h, B);
  }

  // the horizon is the launch's (step_h); the state's line at h = 1 and h
  __device__ float point(const FcHyper& h, int horizon, int B) const {
    return fmaxf(at1, at_h);
  }

  __device__ void update(const FcHyper& h, float y, int B) {
    resid = resid + h.resid_rho * (fabsf(y - at1) - resid);
    ring[static_cast<size_t>(t % h.slots) * B] = y;
    t = t + 1;
    refresh(h, B);
  }
};

// forecast/models.py::seasonal_naive_forecaster: the last observation at
// each phase of the period, in scratch rows 0 .. period - 1 (0 until a
// phase is first seen), and the samples seen.
struct SeasonalNaiveFc {
  float* season;
  int t;
  float resid;

  __device__ void init(float* lane_scratch, const FcHyper& h, int B) {
    season = lane_scratch;
    for (int p = 0; p < h.slots; ++p)
      season[static_cast<size_t>(p) * B] = 0.0f;
    t = 0;
    resid = 0.0f;
  }

  // the maximum over phases (t + k) % period, k = 0 .. horizon - 1
  __device__ float point(const FcHyper& h, int horizon, int B) const {
    float best = -INFINITY;
    for (int k = 0; k < horizon; ++k)
      best = fmaxf(best, season[static_cast<size_t>((t + k) % h.slots) * B]);
    return fmaxf(best, 0.0f);
  }

  __device__ void update(const FcHyper& h, float y, int B) {
    const float pred1 = point(h, 1, B);
    resid = resid + h.resid_rho * (fabsf(y - pred1) - resid);
    season[static_cast<size_t>(t % h.slots) * B] = y;
    t = t + 1;
  }
};

// forecast/models.py::ewma_forecaster: an exponentially weighted level,
// the same forecast at every horizon. No scratch.
struct EwmaFc {
  float level, resid;

  __device__ void init(float* lane_scratch, const FcHyper& h, int B) {
    level = resid = 0.0f;
  }

  __device__ float point(const FcHyper& h, int horizon, int B) const {
    return fmaxf(level, 0.0f);
  }

  __device__ void update(const FcHyper& h, float y, int B) {
    resid = resid + h.resid_rho * (fabsf(y - fmaxf(level, 0.0f)) - resid);
    level = level + h.alpha * (y - level);
  }
};

}  // namespace repro_torch
