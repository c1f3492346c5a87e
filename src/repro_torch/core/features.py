"""Sliding-window feature extraction, 38 features (port of
``repro.core.features``, paper §III.B.1).

* ``stat_time_features``: 28 statistical + time-domain features, the
  plain version of the ``window_features`` CUDA kernel.
* ``freq_features``: 10 frequency-domain features from a real DFT of the
  mean-removed window.

Everything takes ``windows`` of shape [..., W] and runs on the windows'
device. The float ops are the reference's, in an order the CUDA device
functions (``kernels/csrc/features.cuh``) repeat, so the kernel and this
module agree bit for bit:

* Sums over the window axis follow XLA's CPU reduction order
  (``_numerics.xla_sum``), a division by a constant (``jnp.mean``'s
  ``/ n``, ``/ 30``, ``/ nb``) is a multiply by its f32 reciprocal, every
  other division is IEEE, and sqrt, pow, exp and log are correctly
  rounded (``_numerics``). XLA also contracts some products into a
  following add inside its fusions (``mean + EPS``, ``tvar * var +
  EPS``, the q75 interpolation), which the port does not, so about half
  of the continuous features differ from the reference's in the last
  one or two ulp; the quantized ones (``QUANTIZED``) are exact.
* The spectrum is a DFT with an f32 cos/sin table (built in f64, rounded
  once), summed sequentially over time. ``jnp.fft.rfft`` sums in another
  order, so the 10 frequency features agree with the reference to a
  tolerance (tests/test_torch_features.py), not bitwise.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import _device
from repro_torch import _numerics as N
from repro_torch._numerics import recip, seq_sum, xla_sum

EPS = 1e-6

STAT_TIME_NAMES = [
    "mean", "std", "cv", "min", "max", "median", "q25", "q75", "iqr",
    "skewness", "kurtosis", "max_to_median", "max_to_mean", "zero_fraction",
    "range",
    "trend_slope", "trend_r2", "half_ratio",
    "acf_1", "acf_2", "acf_3", "acf_6", "acf_12",
    "acf_max", "acf_argmax", "mean_abs_diff", "max_abs_diff", "n_peaks",
]
FREQ_NAMES = [
    "spectral_entropy", "dominant_freq", "dominant_power_ratio",
    "top2_power_ratio", "low_band_power", "mid_band_power",
    "high_band_power", "spectral_centroid", "spectral_flatness",
    "spectral_rolloff",
]
FEATURE_NAMES = STAT_TIME_NAMES + FREQ_NAMES
N_FEATURES = len(FEATURE_NAMES)  # 38

ACF_MAX_LAG_LO, ACF_MAX_LAG_HI = 2, 30  # lag range searched for acf_max
ACF_LAGS = (1, 2, 3, 6, 12)

#: features whose values are multiples of 1/W or 1/30 by construction
QUANTIZED = ("zero_fraction", "acf_argmax", "n_peaks", "dominant_freq",
             "spectral_rolloff")


def _mean(v: torch.Tensor) -> torch.Tensor:
    return xla_sum(v) * recip(v.shape[-1])


def quantile_weights(q: float, n: int) -> tuple[int, int, float, float]:
    """(lo, hi, 1 - w, w) of the linear-interpolated quantile at `q` of
    a sorted window of `n`, as the reference's f32 arithmetic gives
    them."""
    pos = q * (n - 1)
    lo = int(np.floor(pos))
    w = np.float32(np.float32(pos) - np.float32(lo))
    return lo, min(lo + 1, n - 1), float(np.float32(1.0) - w), float(w)


def trend_constants(n: int) -> tuple[float, float]:
    """(tbar, tvar) of the OLS trend over t = 0..n-1, as f32 values:
    tvar is the reference's `mean((t - tbar)**2)` (an exact f32 sum
    times the f32 reciprocal of n). XLA divides by it IEEE."""
    t = np.arange(n, dtype=np.float32) - np.float32((n - 1) / 2.0)
    tvar = np.float32(np.sum((t * t).astype(np.float64))) * np.float32(
        recip(n))
    return float(np.float32((n - 1) / 2.0)), float(np.float32(tvar))


def _acf(xc: torch.Tensor, var: torch.Tensor, lag: int) -> torch.Tensor:
    """Autocorrelation at `lag` (biased normalization by n)."""
    n = xc.shape[-1]
    prod = xc[..., : n - lag] * xc[..., lag:]
    return xla_sum(prod) / (float(n) * var + EPS)


def stat_time_features(windows: torch.Tensor) -> torch.Tensor:
    """28 statistical + time-domain features. [..., W] -> [..., 28]."""
    x = torch.as_tensor(windows).to(torch.float32)
    n = x.shape[-1]
    rn = recip(n)

    mean = _mean(x)
    xc = x - mean[..., None]
    xc2 = xc * xc
    var = xla_sum(xc2) * rn
    std = N.sqrt(var)
    cv = std / (mean + EPS)
    xmin = x.amin(-1)
    xmax = x.amax(-1)

    xs = torch.sort(x, dim=-1).values

    def quantile(q):
        lo, hi, w_lo, w_hi = quantile_weights(q, n)
        return xs[..., lo] * w_lo + xs[..., hi] * w_hi

    median = quantile(0.5)
    q25 = quantile(0.25)
    q75 = quantile(0.75)
    iqr = q75 - q25

    m3 = xla_sum(xc * xc2) * rn
    m4 = xla_sum(xc2 * xc2) * rn
    skew = m3 / (N.rounded(torch.pow, var, 1.5) + EPS)
    kurt = m4 / (var * var + EPS) - 3.0  # Fisher (excess) kurtosis

    max_to_median = xmax / (median + EPS)
    max_to_mean = xmax / (mean + EPS)
    zero_frac = xla_sum((x <= EPS).to(torch.float32)) * rn
    rng = xmax - xmin

    # OLS trend vs t, slope normalized by the window mean
    tbar, tvar = trend_constants(n)
    t = torch.arange(n, dtype=torch.float32, device=x.device) - tbar
    cov_tx = xla_sum(t * xc) * rn
    slope = cov_tx / _device.const(tvar, x.device)
    slope_norm = slope / (mean + EPS)
    r2 = (cov_tx * cov_tx) / (tvar * var + EPS)
    half = n // 2
    half_ratio = (_mean(x[..., half:]) + EPS) / (_mean(x[..., :half]) + EPS)

    acf_named = [_acf(xc, var, k) for k in ACF_LAGS]
    acfs = torch.stack([_acf(xc, var, k) for k in
                        range(ACF_MAX_LAG_LO, ACF_MAX_LAG_HI + 1)], -1)
    acf_max = acfs.amax(-1)
    acf_argmax = (torch.argmax(acfs, -1) + ACF_MAX_LAG_LO).to(
        torch.float32) * recip(ACF_MAX_LAG_HI)

    adx = (x[..., 1:] - x[..., :-1]).abs()
    mean_abs_diff = _mean(adx) / (mean + EPS)
    max_abs_diff = adx.amax(-1) / (mean + EPS)

    thresh = (mean + std)[..., None]
    mid, left, right = x[..., 1:-1], x[..., :-2], x[..., 2:]
    peaks = (mid > left) & (mid >= right) & (mid > thresh)
    n_peaks = xla_sum(peaks.to(torch.float32)) * rn

    return torch.stack(
        [mean, std, cv, xmin, xmax, median, q25, q75, iqr, skew, kurt,
         max_to_median, max_to_mean, zero_frac, rng,
         slope_norm, r2, half_ratio, *acf_named, acf_max, acf_argmax,
         mean_abs_diff, max_abs_diff, n_peaks], -1)


@functools.lru_cache(maxsize=None)
def dft_table(n: int, device: torch.device) -> torch.Tensor:
    """[2, n//2 + 1, n] f32 cos and sin of 2*pi*k*j/n, computed in f64
    and rounded once (the table the episode kernel reads too)."""
    k = np.arange(n // 2 + 1)[:, None]
    j = np.arange(n)[None, :]
    ang = 2.0 * np.pi * ((k * j) % n) / n
    tab = np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)
    return torch.as_tensor(tab, device=device)


def freq_constants(n: int) -> tuple[float, float]:
    """(1 / log(nb), 1 / nb) as f32 multipliers, nb = n // 2 bins."""
    nb = n // 2
    return recip(np.log(np.float32(nb))), recip(nb)


def power_spectrum(windows: torch.Tensor) -> torch.Tensor:
    """|DFT|^2 of the mean-removed window without the DC bin:
    [..., W] -> [..., W // 2], each bin summed sequentially over time."""
    x = torch.as_tensor(windows).to(torch.float32)
    n = x.shape[-1]
    xc = x - _mean(x)[..., None]
    cos, sin = dft_table(n, x.device)
    re = xc[..., 0, None] * cos[:, 0]
    im = xc[..., 0, None] * sin[:, 0]
    for j in range(1, n):
        re = re + xc[..., j, None] * cos[:, j]
        im = im + xc[..., j, None] * sin[:, j]
    return (re * re + im * im)[..., 1:]


def freq_features(windows: torch.Tensor) -> torch.Tensor:
    """10 frequency-domain features. [..., W] -> [..., 10]."""
    power = power_spectrum(windows)
    nb = power.shape[-1]
    inv_log_nb, inv_nb = freq_constants(2 * nb)
    psum = seq_sum(power, 0, nb)
    total = psum + EPS
    p = power / total[..., None]

    entropy = -seq_sum(p * N.rounded(torch.log, p + EPS), 0, nb) * inv_log_nb
    dom_idx = torch.argmax(power, -1)
    dom_freq = dom_idx.to(torch.float32) * inv_nb
    top = torch.topk(power, 2, dim=-1).values
    dom_ratio = top[..., 0] / total
    top2 = (top[..., 0] + top[..., 1]) / total

    b5, b15 = min(5, nb), min(15, nb)
    low = seq_sum(power, 0, b5) / total
    mid = seq_sum(power, b5, b15) / total
    high = seq_sum(power, b15, nb) / total

    idx = torch.arange(nb, dtype=torch.float32, device=power.device)
    centroid = seq_sum(p * idx, 0, nb) * inv_nb
    flatness = N.rounded(torch.exp, seq_sum(
        N.rounded(torch.log, power + EPS), 0, nb) * inv_nb) / (
        psum * inv_nb + EPS)
    cum = [p[..., 0]]
    for k in range(1, nb):
        cum.append(cum[-1] + p[..., k])
    hit = (torch.stack(cum, -1) >= 0.85).to(torch.float32)
    rolloff = torch.argmax(hit, -1).to(torch.float32) * inv_nb

    return torch.stack([entropy, dom_freq, dom_ratio, top2, low, mid, high,
                        centroid, flatness, rolloff], -1)


def extract_features(windows: torch.Tensor) -> torch.Tensor:
    """All 38 features. [..., W] -> [..., 38]."""
    return torch.cat([stat_time_features(windows), freq_features(windows)],
                     -1)
