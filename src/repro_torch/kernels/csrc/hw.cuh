// Holt-Winters on the card, one series (lane) per thread: the additive
// recurrence core/forecasting.py::hw_step. The standalone holt_winters
// kernel and the pre-pass's Holt-Winters forecaster (forecasters.cuh)
// share it.
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

}  // namespace repro_torch
