"""Sliding-window feature extraction, 38 features (port of
``repro.core.features``, paper §III.B.1).

* ``stat_time_features``: 28 statistical + time-domain features, the
  plain version of the ``window_features`` CUDA kernel.
* ``freq_features``: 10 frequency-domain features from a real FFT of the
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
* The spectrum is the real FFT ``jnp.fft.rfft`` runs on the CPU (ducc0's
  ``rfftp``: radix-4, 2, 3 and 5 passes and the generic odd-factor
  pass, twiddles rounded once from f64), then XLA's complex ``abs``
  (max * sqrt(fma(r, r, 1)), r = min / max) and the square, op for op in
  f32, so the power spectrum, and with it every frequency feature's ties,
  is the reference's bit for bit wherever ducc0 runs those passes: every
  width up to 136, and above it every width up to 1,024 without a prime
  factor of 137 or more, but for the even widths 1,008 to 1,022. At the
  others (211, 223, ...) ducc0 takes another algorithm (Bluestein's, for
  a large prime factor), which the port does not repeat: there the
  spectrum differs from the reference's by up to about 1e-6 of the
  window's largest bin, and the features stay within the reference's
  kernel tolerance (a standing difference, ``ROADMAP.md``;
  ``tools/sweep_spectrum_widths.py`` lists the widths).
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


#: the constants of ducc0's radix-3, -4 and -5 passes, rounded to f32
_TAUI3 = float(np.float32(0.8660254037844386467637231707529362))
_HSQT2 = float(np.float32(0.7071067811865475244008443621048490))
_TR11, _TI11 = (float(np.float32(0.3090169943749474241022934171828191)),
                float(np.float32(0.9510565162951535721164393333793821)))
_TR12, _TI12 = (float(np.float32(-0.8090169943749474241022934171828191)),
                float(np.float32(0.5877852522924731291687059546390728)))


def _factorize(n: int) -> list[int]:
    """ducc0's factor order for a real FFT: 4s, then a 2 swapped to the
    front, then odd factors ascending."""
    fct = []
    while n % 4 == 0:
        fct.append(4)
        n //= 4
    if n % 2 == 0:
        n //= 2
        fct.append(2)
        fct[0], fct[-1] = fct[-1], fct[0]
    d = 3
    while d * d <= n:
        while n % d == 0:
            fct.append(d)
            n //= d
        d += 2
    if n > 1:
        fct.append(n)
    return fct


@functools.lru_cache(maxsize=None)
def rfft_plan(n: int) -> tuple[tuple[int, int, int, tuple[float, ...]], ...]:
    """The passes of a forward real FFT of length `n`, in the order they
    run: (ip, l1, ido, twiddles) per pass, the twiddles cos and sin of
    2*pi*j*l1*i/n for j < ip, i <= (ido-1)/2, as ducc0's `wa` array
    ([(ip-1) * (ido-1)]), and for a factor above 5 then ducc0's `csarr`
    ([2 * ip]: cos and sin of 2*pi*m/ip, the upper half mirrored), all
    computed in f64 and rounded once."""
    passes, l1 = [], n
    for ip in reversed(_factorize(n)):
        ido = n // l1
        l1 //= ip
        wa = np.zeros((ip - 1, ido - 1))
        for j in range(1, ip):
            for i in range(1, (ido - 1) // 2 + 1):
                ang = 2.0 * np.pi * (j * l1 * i) / n
                wa[j - 1, 2 * i - 2] = np.cos(ang)
                wa[j - 1, 2 * i - 1] = np.sin(ang)
        tw = [wa.reshape(-1)]
        if ip > 5:
            m = np.arange(1, (ip - 1) // 2 + 1)
            cs = np.zeros((ip, 2))
            cs[0, 0] = 1.0
            cs[m, 0] = cs[ip - m, 0] = np.cos(2.0 * np.pi * m / ip)
            cs[m, 1] = np.sin(2.0 * np.pi * m / ip)
            cs[ip - m, 1] = -cs[m, 1]
            tw.append(cs.reshape(-1))
        passes.append((ip, l1, ido, tuple(
            float(v) for v in np.concatenate(tw).astype(np.float32))))
    return tuple(passes)


@functools.lru_cache(maxsize=None)
def fft_tables(n: int, device: torch.device):
    """`rfft_plan(n)` as the kernels take it: (every pass's twiddles in one
    f32 tensor on `device`, at least one element; the flat plan list of
    (ip, l1, ido, offset of the pass's twiddles) per pass)."""
    tw, plan = [], []
    for ip, l1, ido, wa in rfft_plan(n):
        plan += [ip, l1, ido, len(tw)]
        tw.extend(wa)
    return (torch.tensor(tw or [0.0], dtype=torch.float32, device=device),
            plan)


def _radfg(ip: int, l1: int, ido: int, wa, cc: list) -> list:
    """ducc0's generic forward pass (radfg) for an odd factor ip > 5, on a
    list of n columns laid out as `_radix_pass`'s: C1(a, b, c) =
    cc[a + ido*(b + l1*c)] is rotated in place, the butterflies go to
    CH2(a, j) = ch[a + idl1*j], and the result to CC(a, b, c) =
    out[a + ido*(b + ip*c)]."""
    cc, ch, out = list(cc), [None] * len(cc), [None] * len(cc)
    ipph, idl1 = (ip + 1) // 2, ido * l1
    cs = wa[(ip - 1) * (ido - 1):]                   # csarr

    def c1(a, b, c):
        return a + ido * (b + l1 * c)

    for j in range(1, ipph) if ido > 1 else ():      # twiddle j and ip-j
        jc = ip - j
        is1, is2 = (j - 1) * (ido - 1), (jc - 1) * (ido - 1)
        for k in range(l1):
            for i in range(1, ido - 1, 2):
                w1r, w1i = wa[is1 + i - 1], wa[is1 + i]
                w2r, w2i = wa[is2 + i - 1], wa[is2 + i]
                t1, t2 = cc[c1(i, k, j)], cc[c1(i + 1, k, j)]
                t3, t4 = cc[c1(i, k, jc)], cc[c1(i + 1, k, jc)]
                x1, x2 = w1r * t1 + w1i * t2, w1r * t2 - w1i * t1
                x3, x4 = w2r * t3 + w2i * t4, w2r * t4 - w2i * t3
                cc[c1(i, k, j)], cc[c1(i + 1, k, jc)] = x3 + x1, x3 - x1
                cc[c1(i + 1, k, j)], cc[c1(i, k, jc)] = x2 + x4, x2 - x4
    for j in range(1, ipph):
        jc = ip - j
        for k in range(l1):
            t1, t2 = cc[c1(0, k, j)], cc[c1(0, k, jc)]
            cc[c1(0, k, j)], cc[c1(0, k, jc)] = t1 + t2, t2 - t1
    for l in range(1, ipph):
        lc = ip - l
        for ik in range(idl1):
            ch[ik + idl1 * l] = (cc[ik] + cs[2 * l] * cc[ik + idl1]
                                 + cs[4 * l] * cc[ik + 2 * idl1])
            ch[ik + idl1 * lc] = (cs[2 * l + 1] * cc[ik + idl1 * (ip - 1)]
                                  + cs[4 * l + 1] * cc[ik + idl1 * (ip - 2)])
        iang, j = 2 * l, 3
        while j < ipph:                  # groups of 4, then 2, then 1
            g = 4 if j < ipph - 3 else (2 if j < ipph - 1 else 1)
            ar = []
            for _ in range(g):
                iang += l
                if iang > ip:
                    iang -= ip
                ar.append((cs[2 * iang], cs[2 * iang + 1]))
            jc = ip - j
            for ik in range(idl1):
                re = ar[0][0] * cc[ik + idl1 * j]
                im = ar[0][1] * cc[ik + idl1 * jc]
                for t in range(1, g):
                    re = re + ar[t][0] * cc[ik + idl1 * (j + t)]
                    im = im + ar[t][1] * cc[ik + idl1 * (jc - t)]
                ch[ik + idl1 * l] = ch[ik + idl1 * l] + re
                ch[ik + idl1 * lc] = ch[ik + idl1 * lc] + im
            j += g
    for ik in range(idl1):
        s = cc[ik]
        for j in range(1, ipph):
            s = s + cc[ik + idl1 * j]
        ch[ik] = s

    def put(a, b, c, v):
        out[a + ido * (b + ip * c)] = v

    def CH(a, b, c):
        return ch[c1(a, b, c)]

    for k in range(l1):
        for i in range(ido):
            put(i, 0, k, CH(i, k, 0))
    for j in range(1, ipph):
        jc, j2 = ip - j, 2 * j - 1
        for k in range(l1):
            put(ido - 1, j2, k, CH(0, k, j))
            put(0, j2 + 1, k, CH(0, k, jc))
            for i in range(1, ido - 1, 2):
                ic = ido - i - 2
                put(i, j2 + 1, k, CH(i, k, j) + CH(i, k, jc))
                put(ic, j2, k, CH(i, k, j) - CH(i, k, jc))
                put(i + 1, j2 + 1, k, CH(i + 1, k, j) + CH(i + 1, k, jc))
                put(ic + 1, j2, k, CH(i + 1, k, jc) - CH(i + 1, k, j))
    return out


def _radix_pass(ip: int, l1: int, ido: int, wa, cc: list) -> list:
    """One forward pass of ducc0's rfftp (radf2/3/4/5, `_radfg` above 5) on
    a list of n columns: CC(a, b, c) = cc[a + ido*(b + l1*c)] in,
    CH(a, b, c) = ch[a + ido*(b + ip*c)] out."""
    if ip > 5:
        return _radfg(ip, l1, ido, wa, cc)
    ch = [None] * len(cc)

    def CC(a, b, c):
        return cc[a + ido * (b + l1 * c)]

    def put(a, b, c, v):
        ch[a + ido * (b + ip * c)] = v

    def mulpm(x, i, k):
        """conj(twiddle) * (CC(i-1, k, x+1) + i CC(i, k, x+1))"""
        wr, wi = wa[x * (ido - 1) + i - 2], wa[x * (ido - 1) + i - 1]
        e, f = CC(i - 1, k, x + 1), CC(i, k, x + 1)
        return wr * e + wi * f, wr * f - wi * e

    inner = [(k, i, ido - i) for k in range(l1) for i in range(2, ido, 2)]
    if ip == 2:
        for k in range(l1):
            put(0, 0, k, CC(0, k, 0) + CC(0, k, 1))
            put(ido - 1, 1, k, CC(0, k, 0) - CC(0, k, 1))
        if ido % 2 == 0:
            for k in range(l1):
                put(0, 1, k, -CC(ido - 1, k, 1))
                put(ido - 1, 0, k, CC(ido - 1, k, 0))
        for k, i, ic in inner:
            tr2, ti2 = mulpm(0, i, k)
            put(i - 1, 0, k, CC(i - 1, k, 0) + tr2)
            put(ic - 1, 1, k, CC(i - 1, k, 0) - tr2)
            put(i, 0, k, ti2 + CC(i, k, 0))
            put(ic, 1, k, ti2 - CC(i, k, 0))
    elif ip == 3:
        for k in range(l1):
            cr2 = CC(0, k, 1) + CC(0, k, 2)
            put(0, 0, k, CC(0, k, 0) + cr2)
            put(0, 2, k, _TAUI3 * (CC(0, k, 2) - CC(0, k, 1)))
            put(ido - 1, 1, k, CC(0, k, 0) + -0.5 * cr2)
        for k, i, ic in inner:
            dr2, di2 = mulpm(0, i, k)
            dr3, di3 = mulpm(1, i, k)
            cr2, ci2 = dr2 + dr3, di2 + di3
            put(i - 1, 0, k, CC(i - 1, k, 0) + cr2)
            put(i, 0, k, CC(i, k, 0) + ci2)
            tr2 = CC(i - 1, k, 0) + -0.5 * cr2
            ti2 = CC(i, k, 0) + -0.5 * ci2
            tr3 = _TAUI3 * (di2 - di3)
            ti3 = _TAUI3 * (dr3 - dr2)
            put(i - 1, 2, k, tr2 + tr3)
            put(ic - 1, 1, k, tr2 - tr3)
            put(i, 2, k, ti3 + ti2)
            put(ic, 1, k, ti3 - ti2)
    elif ip == 4:
        for k in range(l1):
            tr1 = CC(0, k, 3) + CC(0, k, 1)
            put(0, 2, k, CC(0, k, 3) - CC(0, k, 1))
            tr2 = CC(0, k, 0) + CC(0, k, 2)
            put(ido - 1, 1, k, CC(0, k, 0) - CC(0, k, 2))
            put(0, 0, k, tr2 + tr1)
            put(ido - 1, 3, k, tr2 - tr1)
        if ido % 2 == 0:
            for k in range(l1):
                ti1 = -_HSQT2 * (CC(ido - 1, k, 1) + CC(ido - 1, k, 3))
                tr1 = _HSQT2 * (CC(ido - 1, k, 1) - CC(ido - 1, k, 3))
                put(ido - 1, 0, k, CC(ido - 1, k, 0) + tr1)
                put(ido - 1, 2, k, CC(ido - 1, k, 0) - tr1)
                put(0, 3, k, ti1 + CC(ido - 1, k, 2))
                put(0, 1, k, ti1 - CC(ido - 1, k, 2))
        for k, i, ic in inner:
            cr2, ci2 = mulpm(0, i, k)
            cr3, ci3 = mulpm(1, i, k)
            cr4, ci4 = mulpm(2, i, k)
            tr1, tr4 = cr4 + cr2, cr4 - cr2
            ti1, ti4 = ci2 + ci4, ci2 - ci4
            tr2, tr3 = CC(i - 1, k, 0) + cr3, CC(i - 1, k, 0) - cr3
            ti2, ti3 = CC(i, k, 0) + ci3, CC(i, k, 0) - ci3
            put(i - 1, 0, k, tr2 + tr1)
            put(ic - 1, 3, k, tr2 - tr1)
            put(i, 0, k, ti1 + ti2)
            put(ic, 3, k, ti1 - ti2)
            put(i - 1, 2, k, tr3 + ti4)
            put(ic - 1, 1, k, tr3 - ti4)
            put(i, 2, k, tr4 + ti3)
            put(ic, 1, k, tr4 - ti3)
    else:                                            # ip == 5
        for k in range(l1):
            cr2, ci5 = CC(0, k, 4) + CC(0, k, 1), CC(0, k, 4) - CC(0, k, 1)
            cr3, ci4 = CC(0, k, 3) + CC(0, k, 2), CC(0, k, 3) - CC(0, k, 2)
            put(0, 0, k, CC(0, k, 0) + cr2 + cr3)
            put(ido - 1, 1, k, CC(0, k, 0) + _TR11 * cr2 + _TR12 * cr3)
            put(0, 2, k, _TI11 * ci5 + _TI12 * ci4)
            put(ido - 1, 3, k, CC(0, k, 0) + _TR12 * cr2 + _TR11 * cr3)
            put(0, 4, k, _TI12 * ci5 - _TI11 * ci4)
        for k, i, ic in inner:
            dr2, di2 = mulpm(0, i, k)
            dr3, di3 = mulpm(1, i, k)
            dr4, di4 = mulpm(2, i, k)
            dr5, di5 = mulpm(3, i, k)
            cr2, ci5 = dr5 + dr2, dr5 - dr2
            ci2, cr5 = di2 + di5, di2 - di5
            cr3, ci4 = dr4 + dr3, dr4 - dr3
            ci3, cr4 = di3 + di4, di3 - di4
            put(i - 1, 0, k, CC(i - 1, k, 0) + cr2 + cr3)
            put(i, 0, k, CC(i, k, 0) + ci2 + ci3)
            tr2 = CC(i - 1, k, 0) + _TR11 * cr2 + _TR12 * cr3
            ti2 = CC(i, k, 0) + _TR11 * ci2 + _TR12 * ci3
            tr3 = CC(i - 1, k, 0) + _TR12 * cr2 + _TR11 * cr3
            ti3 = CC(i, k, 0) + _TR12 * ci2 + _TR11 * ci3
            tr5, tr4 = cr5 * _TI11 + cr4 * _TI12, cr5 * _TI12 - cr4 * _TI11
            ti5, ti4 = ci5 * _TI11 + ci4 * _TI12, ci5 * _TI12 - ci4 * _TI11
            put(i - 1, 2, k, tr2 + tr5)
            put(ic - 1, 1, k, tr2 - tr5)
            put(i, 2, k, ti5 + ti2)
            put(ic, 1, k, ti5 - ti2)
            put(i - 1, 4, k, tr3 + tr4)
            put(ic - 1, 3, k, tr3 - tr4)
            put(i, 4, k, ti4 + ti3)
            put(ic, 3, k, ti4 - ti3)
    return ch


def rfft_halfcomplex(x: torch.Tensor) -> list[torch.Tensor]:
    """The forward real FFT of the last axis in ducc0's halfcomplex order:
    n columns r0, re1, im1, re2, im2, ... (re(n/2) last for even n)."""
    cols = list(x.unbind(-1))
    for ip, l1, ido, wa in rfft_plan(x.shape[-1]):
        cols = _radix_pass(ip, l1, ido, wa, cols)
    return cols


def complex_abs(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """XLA's CPU complex abs: max * sqrt(fma(r, r, 1)), r = min / max,
    0 where both parts are 0."""
    a, b = re.abs(), im.abs()
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    r = lo / hi
    h = hi * N.sqrt(N.fma(r, r, 1.0))
    return torch.where(hi == 0, torch.zeros_like(h), h)


def freq_constants(n: int) -> tuple[float, float]:
    """(1 / log(nb), 1 / nb) as f32 multipliers, nb = n // 2 bins."""
    nb = n // 2
    return recip(np.log(np.float32(nb))), recip(nb)


def power_spectrum(windows: torch.Tensor) -> torch.Tensor:
    """``|rfft(window - mean)| ** 2`` without the DC bin, as the reference
    computes it on the CPU: [..., W] -> [..., W // 2]."""
    x = torch.as_tensor(windows).to(torch.float32)
    n = x.shape[-1]
    r = rfft_halfcomplex(x - _mean(x)[..., None])
    zero = torch.zeros_like(r[0])
    bins = []
    for k in range(1, n // 2 + 1):
        h = complex_abs(r[2 * k - 1], r[2 * k] if 2 * k < n else zero)
        bins.append(h * h)
    return torch.stack(bins, -1)


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
