// Holt-Winters on the card, one series (lane) per thread: the additive
// recurrence core/forecasting.py::hw_step, and the in-episode forecaster
// forecast/models.py::holt_winters_forecaster (Holt-Winters state plus the
// residual EWMA of forecast/api.py). The standalone holt_winters kernel and
// the predictive, AAPA and hybrid policies of the episode kernel share it.
#pragma once

#include <cmath>

#include "kernels.h"

namespace repro_torch {

// One Holt-Winters step with observation y: level and trend in registers,
// s the season slot of this step's phase, read and replaced.
__device__ __forceinline__ void hw_step(float& level, float& trend, float& s,
                                        float y, const HWCoeffs& c) {
  const float s_t = s;
  const float lv = c.alpha * (y - s_t) + c.one_m_alpha * (level + trend);
  trend = c.beta * (lv - level) + c.one_m_beta * trend;
  s = c.gamma * (y - lv) + c.one_m_gamma * s_t;
  level = lv;
}

// A lane's Holt-Winters forecaster inside an episode; the season lives in
// per-lane global scratch, phase p at season[p * B].
struct HWForecaster {
  float* season;
  int t;  // phase counter
  float level, trend, resid;

  __device__ void init(float* lane_scratch, const HWHyper& h, int B) {
    season = lane_scratch;
    for (int p = 0; p < h.period; ++p) season[static_cast<size_t>(p) * B] = 0.0f;
    t = 0;
    level = trend = resid = 0.0f;
  }

  // core/forecasting.py::hw_forecast_max: the peak forecast of the next
  // `horizon` steps
  __device__ float forecast_max(const HWHyper& h, int horizon, int B) const {
    float best = -INFINITY;
    for (int k = 1; k <= horizon; ++k) {
      const int phase = (t + k - 1) % h.period;
      const float pred = (level + static_cast<float>(k) * trend) +
                         season[static_cast<size_t>(phase) * B];
      best = fmaxf(best, pred);
    }
    return best;
  }

  // forecast/api.py update: the residual EWMA against the clamped
  // one-step forecast, then hw_step
  __device__ void update(const HWHyper& h, float y, int B) {
    const float pred1 = fmaxf(forecast_max(h, 1, B), 0.0f);
    resid = resid + h.resid_rho * (fabsf(y - pred1) - resid);
    hw_step(level, trend, season[static_cast<size_t>(t % h.period) * B], y,
            h.c);
    t = t + 1;
  }
};

}  // namespace repro_torch
