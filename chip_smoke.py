#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. Print the card (``nvidia-smi`` name and power limit) and build the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` (timed).
2. ``plant_block`` kernel vs its plain PyTorch version on the card:
   100,003 random lanes (not a multiple of the block size), S=30,
   n_ticks in {14, 29, 3}; rtol/atol 1e-5, then bit for bit with the plain
   version and with the per-thread kernel it replaced, the variant
   logged.
3. ``episode_block`` kernel vs its plain version (the blocked simulate):
   HPA on ``burst_storm(n_workloads=4099, minutes=30)`` at control
   intervals 15 and 7 (remainder block); rtol 3e-6 / atol 1e-4 on all 12
   MinuteOut fields.
4. The unfused path (``simulate(..., decide_kernel=False)``: one
   ``plant_block`` launch per control period) against the fused episode
   kernel on ``archetype_mix(n_workloads=1024, minutes=120)``.
5. The main path at fleet scale, the paper's Table IV baseline row: HPA
   over ``burst_storm(n_workloads=100_000, minutes=1440, seed=0)``,
   default SimConfig (ci=15), ``make_simulator(w_chunk=25_000)`` on the
   episode kernel, then ``metrics.pooled`` and ``evals.rei.rei``.
6. Each kernel against its plain version once more at the shapes its
   path gives it (``episode_block`` on one 25,000 x 1440 chunk of the
   fleet, ``plant_block`` at 1024 lanes x S=30 x 14 ticks and at 100,003
   lanes, bit for bit, also with the per-thread kernel), with the
   tolerances above, and per-kernel times at those shapes (CUDA events;
   ``plant_block``, its per-thread kernel, the same launch with an empty
   body (the launch's floor) and its plain version replayed from a CUDA
   graph, so the host's per-launch overhead is not counted), against the
   card's bound; ``plant_block`` at 1024 lanes also at 1, 7 and 29
   ticks.
7. One more fleet run under ``torch.profiler``: device time by kernel and
   the device's busy share of the wall time.
8. The classification path at AAPAset scale (the ``aapaset_300k``
   recipe: ``generate_traces(n_functions=150, n_days=14, seed=0)``,
   60-minute windows at stride 10): ``window_features`` against its
   plain version bit for bit (gate beside it: quantized features exact,
   the rest at rtol/atol 5e-4), for the 28 features and for all 38 in one
   launch (the classification path's), with the kernel compiled for
   W = 60, with the generic kernel forced at W = 60 (timed too) and at
   W = 45 (the windows' first 45 samples); a seeded GBDT at the paper's
   size (60 rounds x 4 classes, depth 4, 64
   bins, 38 features; bin edges are quantiles of the port's own
   features over these windows) through ``gbdt_tables`` (its tables in
   shared memory) against its plain version (argmax exact, logits within
   4 ulp of the largest, then bit for bit) and against the generic
   per-thread kernel (bit for bit), and the same for an ensemble of depth
   6 whose tables exceed the shared-memory budget (the generic kernel),
   each variant logged; then the whole path (features -> logits ->
   softmax -> beta calibration -> archetype) timed, with its archetype
   histogram (the wall of the counted run and the median of 20 more),
   and each kernel's time (``gbdt_tables``' generic kernel too).
9. The ``episode_block`` kernel's AAPA policy (that classifier inside)
   against its plain version: ``archetype_mix`` 1024 x 120 at ci 7
   (remainder block) with stride 10 and 2, and the first 480 minutes of
   one 25,000-lane chunk of the AAPA fleet; all 12 MinuteOut fields at
   the episode tolerance and the archetype of every lane after every
   minute exactly.
10. The AAPA fleet: the same 100,000 x 1440 ``burst_storm`` rates as the
    HPA row through ``make_simulator(w_chunk=25_000)``, classified by
    phase 22's trained classifier, pooled metrics and REI, timed, then
    once more under ``torch.profiler``.
11. ``holt_winters`` against its plain version (``hw_smooth``), bit for
    bit (gate beside it: the reference's rtol 1e-4 / atol 1e-3), each
    run's kernel variant logged: 100,003 x 2,880 at period 60 (the season
    in shared memory), 20,011 x 1,000 at period 96 (the shared-memory
    limit) and 97 (global scratch), 4,099 x 3,000 at period 1,440 and 257
    x 61 at alpha 0.37 (T % 4 != 0: 4-B copies).
12. The uncertainty path (paper §III.C.3): split-conformal calibration of
    the paper's Holt-Winters (period 60, alpha 0.1, beta 0.01, gamma
    0.3) at alpha 0.9, burn-in 60, on ``burst_storm(n_workloads=100_000,
    minutes=2_880, seed=1)``, then its coverage on phase 5's held-out
    fleet day, each timed after a warm-up call and profiled. Each call
    must launch ``holt_winters`` exactly once and run no plain version;
    the coverage is printed, not gated. ``holt_winters`` timed at the
    split's shape, also with the season forced to global scratch and on
    a 16-B-misaligned copy of the split (4-B copies, checked equal).
13. The ``episode_block`` kernel's predictive (native, and conservative
    with the band), kpa, AAPA-with-band and hybrid-with-band (phase 8's
    classifier) policies against their plain episodes: a 25,000 x 240
    chunk of the fleet at ci 15 and ``archetype_mix`` 1024 x 120 at ci 7;
    archetypes exact for aapa and hybrid.
14. A 100,000 x 1440 Table IV row (episode + pooled metrics + REI) for
    each of those five policies (AAPA and hybrid with phase 22's trained
    classifier), with the episode kernel's time per
    25,000-lane launch against its bound, split into the pre-pass
    (``policy_signals``) and the plant pass where the policy has one.
15. The pre-pass kernels against their plain version
    (``ref.policy_signals_ref``) bit for bit on the 25,000 x 1440 chunk:
    AAPA with the band and the forecast confidence (every signal, slot
    and per-minute archetype), and predictive conservative with the band.
16. For information: the plant pass over all 100,000 lanes in one launch
    against four 25,000-lane launches (HPA's episode, AAPA's plant pass),
    and each kernel entry's registers, stack and shared memory from
    ``cuobjdump --dump-resource-usage`` of the built extension; fails
    unless both W = 60 ``window_features`` entries and both shared-memory
    ``gbdt_tables`` entries (the paper's depth and any depth) hold no
    stack and no local memory.
17. Every registry forecaster in the episode: predictive, predictive
    conservative with the band, AAPA (phase 8's classifier, the forecast
    confidence on) and hybrid with the band, each under linear trend,
    seasonal naive and EWMA, on ``archetype_mix`` 4,096 x 240, equal to
    their plain episodes bit for bit, archetypes included.
18. The pre-pass's new minute walks (predictive conservative with the
    band and AAPA, under each of those forecasters) against
    ``ref.policy_signals_ref`` bit for bit on the 25,000 x 1440 chunk,
    and each walk's time per launch (CUDA events) against its bound.
19. The Table IV evaluation matrix (``evals.matrix.make_runner``) on the
    card at three sizes: ``benchmarks/bench_autoscaling.py``'s SPEC (4
    ``archetype_pure`` scenarios x 5 seeds x 32 workloads x 1440 min
    under HPA, predictive and AAPA) and SWEEP_SPEC (predictive under the
    four forecasters, ``archetype_mix`` 8 x 1440), both rebuilt here, and
    a fleet-size matrix (HPA, kpa, predictive, AAPA and hybrid x the four
    forecasters: 14 controller lanes x (``burst_storm``,
    ``diurnal_ramp``) x 50,000 workloads x 1440 min, pooled mode,
    ``w_chunk`` 25,000): wall, lane-minutes/s, peak memory, launches;
    the fleet matrix once more under ``torch.profiler``.
20. A small matrix (the reference's acceptance matrix's shape) on the
    card against the port's plain matrix on the CPU: rtol 2e-6 (the
    reference's tolerance for reordered pooling), counts exact.

21. AAPAset on the card (run between phases 9 and 10):
    ``aapaset.build.build(registry.get("aapaset_300k",
    feature_path="kernel"))`` — 301,650 windows of 150 functions x 14
    days through the ``window_features`` kernel and the labeling
    functions — timed whole, then its host part (traces, windows) and
    device part (features, LFs) alone; its label distribution and LF
    coverage. Gates: the ``feature_path="ref"`` path (the plain features
    on the card) gives the same features, votes, labels and confidence
    bit for bit; ``manifest.save`` then ``load`` under a temporary root
    round-trips every array exactly.
22. The classifier trained on the card (run after 21):
    ``core.pipeline.train_from_loader`` on that artifact at the paper's
    ``GBDTConfig()`` (60 rounds x 4 classes, depth 4, 64 bins) and beta
    calibration: fit and training walls, train/val/test accuracy, the
    calibrated test ECE. Gates: a second fit of the first 4 rounds, under
    ``torch.profiler`` (device time of the histograms, the split search
    and the rest), gives the same trees bit for bit; the trained
    classifier's ``gbdt_tables`` logits on all 301,650 windows equal its
    plain version's as in phase 8. The AAPA and hybrid Table IV rows of
    phases 10 and 14 classify with this trained classifier; phases 8-9,
    13, 15, 17 and 19 keep the seeded classifier for their kernel gates.
23. Fleet runs through ``evals.fleet.run_fleet`` (after 20):
    ``burst_storm`` 100,000 x 1440 in chunks of 25,000 under HPA and
    AAPA (the trained classifier), one dispatch (after a warm-up run) and
    streamed; gate: equal at the reference's rtol 2e-6 (quantiles at the
    histogram's half-bin bound). HPA streamed at 100,000 and at
    1,000,000 x 1440 (40 chunks); gate: the 10^6-lane run's peak device
    memory within 5% of the 10^5-lane run's. A stream fed by
    ``AAPAsetLoader.rate_chunks`` of phase 21's artifact, 100,000 x 1440
    under HPA and AAPA. Each prints wall, lane-minutes/s, dispatches,
    peak device memory, host generation time and share, and the pooled
    metrics per policy.

Phases 4, 5, 8, 10, 12, 14, 19, 21, 22 and each run of 23 reset the
kernels' launch counts just before they run and read them just after; a
path whose kernel was never launched fails (the predictive, AAPA and
hybrid rows: the pre-pass and the plant pass; the matrices: every
policy's minute walk under every forecaster; the AAPAset build:
``window_features``; training: ``gbdt_tables``; every fleet run:
``episode_block``, and with AAPA ``policy_signals``). Kernel-vs-plain
comparisons and timing launches are not counted. The plain runs of
phases 8, 9, 11, 13, 17, 18, 20 and 21 are checked to launch no kernel
(the plain AAPA and hybrid episodes classify through the plain GBDT).

Output: progress lines, then a JSON line of per-kernel numbers, then the
``nvidia-smi`` line, then the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores

# f32 operations per lane and tick, counted from the CUDA sources:
# flow_tick 28 (5 of them divisions), pipeline pop 3, cooldown decay 2,
# total replicas 1 (plant_block); the episode kernel adds the minute fold
# (11) in place of the cooldown decay and, per control-period head,
# decide + limiter + scaling (52) plus the HPA window max (buf_len).
PLANT_OPS_PER_TICK = 34
EPISODE_OPS_PER_TICK = 42
EPISODE_OPS_PER_HEAD = 52

# minutes of the AAPA fleet chunk that phase 9 holds against the plain
# episode
AAPA_PLAIN_MINUTES = 480

PLANT_TOL = dict(rtol=1e-5, atol=1e-5)
EPISODE_TOL = dict(rtol=3e-6, atol=1e-4)
FEATURE_TOL = dict(rtol=5e-4, atol=5e-4)

# The AAPA policy's operations, counted from episode_block.cu and
# features.cuh / gbdt.cuh (integer compares count as operations; an f64
# exp or log counts as one): decide per control-period head, on_minute
# per minute (Holt-Winters update, the horizon's peak forecast, the
# 30-minute trend and the 15-minute mean), calibration per reclassification.
AAPA_OPS_PER_HEAD = 26
AAPA_OPS_PER_MINUTE = 20 + 4 * 15 + 157 + 17   # HW + residual, 15-min peak,
#                                               trend, mean
AAPA_CAL_OPS = 60
# Interval confidence per reclassification (forecast_confidence on).
AAPA_CONF_OPS = 10
# The other policies, counted from episode_block.cu the same way. Hybrid
# adds its guard (floor, bounded step) to AAPA's decide; predictive runs
# the forecaster's update (as AAPA: 20), the horizon's peak (4 a step) and
# its replica need (6) per minute, and 9 operations per decide; KPA's two
# EMAs, panic window and idle test take 32 per decide and nothing per
# minute.
HYBRID_GUARD_OPS = 11
PRED_OPS_PER_HEAD = 9
PRED_OPS_PER_MINUTE = 20 + 4 * 15 + 6
KPA_OPS_PER_HEAD = 32
# The pre-pass's bytes per lane-minute: one rate in, and out the three
# signals (AAPA, hybrid) or one (predictive); per reclassification slot
# the archetype and Algorithm 1's three parameters.
PREPASS_SLOT_BYTES = 16
# holt_winters: the forecast (2 adds) and hw_step (13) per series and step
HW_OPS_PER_STEP = 15
HW_TOL = dict(rtol=1e-4, atol=1e-3)
# phase 23's fleets: 10^5 lanes (and a 10x stream) x a day, 4 chunks each
FLEET_LANES, FLEET_CHUNK, FLEET_MINUTES = 100_000, 25_000, 1440
# radf2/3/4/5 of the real FFT, counted from features.cuh::radix_pass:
# (first loop per k, the even-ido loop per k, the inner loop per (k, i))
FFT_PASS_OPS = {2: (2, 1, 10), 3: (6, 0, 28), 4: (6, 8, 34), 5: (20, 0, 72)}


def stat_feature_ops(w: int) -> int:
    """Operations of the 28 stat/time features of one window of `w`
    (features.cuh::stat_time_features), with the sort counted as the
    w*log2(w) comparisons a comparison sort needs at least and each
    autocorrelation lag's sum once."""
    acf = sum(4 * (w - lag) for lag in range(1, 31))        # lags 1..30
    return (w + 1 + 3 * w + 1 + 2 * w + int(w * np.log2(w)) + 12
            + 3 * (4 * w + 1) + 3 * w + (w + 2) + acf + 4 * (w - 1)
            + 4 * (w - 2) + 30)


def fft_ops(w: int) -> int:
    """Operations of the real FFT of one window (features.cuh::radix_pass
    over core.features.rfft_plan(w))."""
    from repro_torch.core import features
    total = 0
    for ip, l1, ido, _ in features.rfft_plan(w):
        first, even, inner = FFT_PASS_OPS[ip]
        total += l1 * (first + (even if ido % 2 == 0 else 0)
                       + inner * ((ido - 1) // 2))
    return total


def freq_feature_ops(w: int) -> int:
    """Operations of the 10 frequency features of one window
    (features.cuh::freq_features): the mean, its subtraction once per
    sample, the FFT, XLA's complex abs and the square (11 per bin) and the
    spectral statistics."""
    nb = w // 2
    return w + 1 + w + fft_ops(w) + nb * 11 + nb * 3 + nb * 20 + 10


def gbdt_ops(n_features: int, n_edges: int, n_trees: int,
             depth: int) -> int:
    """Operations of one row's logits (gbdt.cuh::gbdt_logits): the binary
    searches, one compare and two index ops per tree level, one add per
    tree."""
    return (n_features * int(np.ceil(np.log2(n_edges + 1)))
            + n_trees * (3 * depth + 1))


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: bool = True):
    """(mean device time of `fn` over `iters` calls bracketed by CUDA
    events, the last call's result); one warm-up call first unless the
    caller already ran it."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        result = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, result


def graph_ms(fn, iters: int) -> float:
    """Device time per call of `fn`: `iters` calls captured in one CUDA
    graph, one replay bracketed by CUDA events (no host launch overhead
    inside the timed region)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # allocator and lazy init
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(got, want, tol, what: str) -> float:
    worst = 0.0
    for i, (a, e) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, e, **tol, msg=lambda m: f"{what}[{i}]: {m}")
        worst = max(worst, float((a - e).abs().max()))
    return worst


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plant_bytes(B: int, S: int, T: int) -> float:
    # read 7 state columns + pipeline; write 6 state columns, pipeline
    # and 7 per-tick arrays
    return 4.0 * B * (7 + S + 6 + S + 7 * T)


def plant_inputs(rng, B: int, S: int, dev):
    pipeline = rng.gamma(1.0, 0.6, (B, S)).astype(np.float32)
    cols = (rng.gamma(2.0, 2.0, B), pipeline, rng.gamma(1.0, 25.0, B),
            rng.gamma(1.0, 5.0, B), rng.random(B), rng.uniform(0.0, 20.0, B),
            pipeline.sum(axis=1), rng.gamma(2.0, 30.0, B))
    return [torch.as_tensor(np.asarray(c, np.float32), device=dev)
            for c in cols]


def plant_equal(args, n_ticks: int, what: str) -> tuple[float, str]:
    """``plant_block`` (the staged kernel) against its plain version
    (within rtol/atol 1e-5, then bit for bit) and against the per-thread
    kernel it replaced (bit for bit): (max_abs_err, the variant that
    ran)."""
    from repro_torch.kernels import plant_block, ref
    launcher = plant_block.plant_tick_block_cuda
    ks, kt = launcher(*args, n_ticks=n_ticks)
    variant = launcher.last_variant
    os_, ot = launcher(*args, n_ticks=n_ticks, variant="per_thread")
    rs, rt = ref.plant_block_ref(*args, n_ticks=n_ticks)
    err = max(max_abs_err(ks, rs, PLANT_TOL, f"state {what}"),
              max_abs_err(kt, rt, PLANT_TOL, f"ticks {what}"))
    for i, (a, o, e) in enumerate(zip((*ks, *kt), (*os_, *ot), (*rs, *rt))):
        if not (torch.equal(a, e) and torch.equal(a, o)):
            raise RuntimeError(f"plant_block {variant} {what}: output {i} "
                               "differs from the plain version's or the "
                               "per-thread kernel's bits")
    return err, variant


def seeded_classifier(feats: np.ndarray, dev, seed: int = 0,
                      depth: int = 4):
    """A seeded GBDT + beta calibration at the paper's classifier size
    (``GBDTConfig`` defaults: 60 rounds x 4 classes, depth 4, 64 bins),
    its bin edges quantiles of `feats` [N, 38]; `depth` deepens its
    trees."""
    from repro_torch.core import calibration, gbdt
    from repro_torch.core.pipeline import Classify
    c = gbdt.GBDTConfig(depth=depth)
    rng = np.random.default_rng(seed)
    n_int = 2 ** c.depth - 1
    shape = (c.n_rounds, c.n_classes)
    params = gbdt.from_arrays(
        rng.integers(0, feats.shape[1], shape + (n_int,)),
        rng.integers(0, c.n_bins - 1, shape + (n_int,)),
        rng.normal(0.0, 0.15, shape + (n_int + 1,)),
        gbdt.compute_bin_edges(feats, c.n_bins),
        np.log(np.float32([0.55, 0.15, 0.15, 0.15])), device=dev)
    cal = calibration.from_arrays(rng.normal(0.55, 0.1, c.n_classes),
                                  rng.normal(0.55, 0.1, c.n_classes),
                                  rng.normal(0.0, 0.1, c.n_classes),
                                  device=dev)
    return Classify(params, cal)


def gbdt_equal(params, feats, label: str) -> tuple[float, str]:
    """``gbdt_tables`` on `feats` against its plain version (argmax exact,
    logits within 4 ulp of the largest, then bit for bit) and against the
    generic per-thread kernel (bit for bit); returns (the largest logit
    difference, the kernel variant the ensemble took)."""
    from repro_torch.kernels import gbdt_tables, ops, ref
    launcher = gbdt_tables.gbdt_logits_cuda
    lg_k = ops.gbdt_logits(params, feats)
    variant = launcher.last_variant
    lg_p = launch_free(lambda: ref.gbdt_logits_ref(params, feats),
                       "gbdt_tables")
    if not torch.equal(lg_k.argmax(-1), lg_p.argmax(-1)):
        raise RuntimeError(f"gbdt_tables, {label}: argmax differs from the "
                           "plain version")
    ulp4 = 4 * float(np.spacing(np.float32(lg_p.abs().max().item())))
    err = float((lg_k - lg_p).abs().max())
    if err > ulp4:
        raise RuntimeError(f"gbdt_tables, {label}: logits differ by {err} "
                           f"> 4 ulp ({ulp4})")
    lg_g = launcher(params, feats, variant="generic")
    if not (torch.equal(lg_k, lg_p) and torch.equal(lg_k, lg_g)):
        raise RuntimeError(f"gbdt_tables {variant}, {label}: logits differ "
                           "from the plain version's or the generic "
                           "kernel's bits")
    log(f"[gbdt_tables] {feats.shape[0]} x {feats.shape[1]}, {label}, "
        f"kernel {variant}: equal to the plain version and to the generic "
        f"kernel bit for bit (argmax exact, within 4 ulp), "
        f"max_abs_err={err}")
    return err, variant


def episode_ops(B: int, M: int, heads: int, downs: float, S: int,
                head_ops: int, minute_ops: int = 0, reclass_ops: int = 0,
                stride: int = 1) -> float:
    """Operations of one episode launch: the plant's ticks, decide,
    limiter and scaling per control-period head (plus the policy's
    `head_ops`), the policy's `minute_ops` per minute, `reclass_ops` every
    `stride` minutes, and the pipeline rescale of each scale-down."""
    return (B * M * (60 * EPISODE_OPS_PER_TICK
                     + heads * (EPISODE_OPS_PER_HEAD + head_ops)
                     + minute_ops)
            + B * (M // stride) * reclass_ops + downs * S)


def aapa_episode_ops(B: int, M: int, heads: int, stride: int, downs: float,
                     cls, S: int, *, guard: bool = False,
                     confidence: bool = False) -> float:
    """Operations of one AAPA (or, with `guard`, hybrid) episode launch:
    the plant as for HPA, the decide per head, on_minute per minute, and
    per reclassification the 38 features, the trees, the calibration and
    (with `confidence`) the interval confidence."""
    return episode_ops(B, M, heads, downs, S,
                       AAPA_OPS_PER_HEAD + (HYBRID_GUARD_OPS if guard
                                            else 0),
                       AAPA_OPS_PER_MINUTE,
                       reclassification_ops(cls, confidence), stride)


def reclassification_ops(cls, confidence: bool) -> int:
    """Operations of one reclassification: the 38 features, the trees,
    the calibration and (with `confidence`) the interval confidence."""
    t = cls.params.tables
    n_edges = cls.params.bin_edges.shape[1]
    return (stat_feature_ops(60) + freq_feature_ops(60)
            + gbdt_ops(38, n_edges, t.feat.shape[0], cls.params.depth)
            + AAPA_CAL_OPS + (AAPA_CONF_OPS if confidence else 0))


def prepass_bound(ctrl, B: int, M: int, cls) -> tuple[float, str]:
    """The pre-pass's bound: rates in, signals out; the forecaster per
    minute (and AAPA's trend, mean and reclassifications)."""
    if ctrl.name == "predictive":
        return bound_ms(4.0 * B * M * 2, float(B) * M * PRED_OPS_PER_MINUTE)
    stride = int(ctrl.hyper["stride_min"])
    return bound_ms(4.0 * B * M * 4 + PREPASS_SLOT_BYTES * B * (M // stride),
                    float(B) * M * AAPA_OPS_PER_MINUTE + float(B) * (
                        M // stride) * reclassification_ops(
                        cls, bool(ctrl.hyper["forecast_confidence"])))


def forecaster_ops(name: str, horizon: int, window: int = 30) -> int:
    """Operations of one forecaster update and the horizon's peak per
    minute (forecasters.cuh): the residual EWMA (5) and the model's own;
    Holt-Winters' recurrence and a step of its peak (AAPA_OPS_PER_MINUTE's
    20 + 4 a step); linear trend's two XLA-order sums over the window
    (5 a slot) and its two line values; seasonal naive's store and a
    phase, a load and a max per step of the peak; the EWMA's 3."""
    return {"holt_winters": 20 + 4 * horizon,
            "linear_trend": 5 + 5 * window + 10,
            "seasonal_naive": 5 + 3 + 3 * horizon,
            "ewma": 5 + 3 + 1}[name]


def walk_bound(ctrl, B: int, M: int, cls) -> tuple[float, str]:
    """`prepass_bound` of a predictive or AAPA pre-pass under any
    registry forecaster: the Holt-Winters forecaster's share of the
    minute's operations replaced by the walk's own."""
    from repro_torch.kernels import policy_signals
    horizon = int(ctrl.hyper["horizon_min"])
    name = policy_signals.forecaster_name(ctrl)
    window = int(ctrl.hyper["forecaster"].hyper.get("window", 30))
    delta = forecaster_ops(name, horizon, window) - forecaster_ops(
        "holt_winters", horizon)
    if ctrl.name == "predictive":
        return bound_ms(4.0 * B * M * 2, float(B) * M * (
            PRED_OPS_PER_MINUTE + delta))
    stride = int(ctrl.hyper["stride_min"])
    return bound_ms(4.0 * B * M * 4 + PREPASS_SLOT_BYTES * B * (M // stride),
                    float(B) * M * (AAPA_OPS_PER_MINUTE + delta) + float(B) * (
                        M // stride) * reclassification_ops(
                        cls, bool(ctrl.hyper["forecast_confidence"])))


def bench_spec(matrix):
    """``benchmarks/bench_autoscaling.py``'s SPEC, built here: Fig 2's
    archetype-pure scenarios x 5 seeds x 32 workloads x one day under HPA,
    predictive and AAPA."""
    from repro_torch.core.archetypes import ARCHETYPE_NAMES
    return matrix.spec(
        "bench_autoscaling_fig2", policies=("hpa", "predictive", "aapa"),
        forecasters=("holt_winters",),
        scenarios=tuple(("archetype_pure", {"kind": k})
                        for k in ARCHETYPE_NAMES),
        seeds=tuple(range(1000, 1005)), n_workloads=32, minutes=1440)


def sweep_spec(matrix):
    """``benchmarks/bench_autoscaling.py``'s SWEEP_SPEC, built here: the
    generic predictive policy under every registry forecaster."""
    from repro_torch.forecast import registry as forecast_registry
    return matrix.spec(
        "bench_forecaster_sweep", policies=("predictive",),
        forecasters=tuple(forecast_registry.available()),
        scenarios=(("archetype_mix", {}),), seeds=(4242,), n_workloads=8,
        minutes=1440)


def fleet_spec(matrix):
    """The fleet-size matrix: every policy x every forecaster over a day
    of 50,000 workloads of synchronized bursts and of diurnal growth."""
    from repro_torch.forecast import registry as forecast_registry
    return matrix.spec(
        "fleet_policy_forecaster", policies=("hpa", "kpa", "predictive",
                                             "aapa", "hybrid"),
        forecasters=tuple(forecast_registry.available()),
        scenarios=(("burst_storm", {}), ("diurnal_ramp", {})), seeds=(0,),
        n_workloads=50_000, minutes=1440)


def accept_spec(matrix):
    """The shape of the reference's acceptance matrix
    (tests/test_evals.py ACCEPT_SPEC)."""
    return matrix.spec(
        "t_matrix", policies=("hpa", "kpa", "predictive", "aapa"),
        forecasters=("holt_winters", "ewma"),
        scenarios=(("burst_storm", {}), ("idle_wake", {}),
                   ("archetype_mix", {})), seeds=(0, 1), n_workloads=2,
        minutes=60)


def run_matrix(matrix, sp, cls, label: str, profile: bool = False, **kw):
    """One matrix on the card, timed from rates on the host to metrics,
    with the launch counts reset just before it and read just after;
    fails if an episode or pre-pass kernel did not run or a metric is not
    finite. With `profile`, runs it once more under torch.profiler.
    Returns (pooled, per-workload, counts, walks)."""
    from repro_torch.kernels import ops, policy_signals
    t0 = time.perf_counter()
    rates = matrix.build_rates(sp)
    gen_s = time.perf_counter() - t0
    runner = matrix.make_runner(sp, cls, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pool, per_w = runner(rates)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    walks = dict(policy_signals.policy_signals_cuda.by_walk)
    peak = torch.cuda.max_memory_allocated()
    S, Z, F, P = sp.shape
    if tuple(pool.slo_violation_rate.shape) != (S, Z, F, P):
        raise RuntimeError(f"{label}: pooled shape "
                           f"{tuple(pool.slo_violation_rate.shape)}")
    for name, v in pool._asdict().items():
        if not torch.isfinite(v).all():
            raise RuntimeError(f"{label}: non-finite {name}")
    forecasting = [p for p in sp.policies
                   if p in policy_signals.POLICIES]
    if counts["episode_block"] == 0 or (forecasting and (
            counts["policy_signals"] == 0 or len(walks) != len(
                forecasting) * F)):
        raise RuntimeError(f"{label}: launches {counts}, walks {walks}")
    lanes = S * Z * sp.n_workloads
    runs = sum(1 for f in range(F) for p in sp.policies
               if f == 0 or p in policy_signals.POLICIES)
    log(f"[matrix {label}] {S}x{Z}x{F}x{P} cells, {sp.n_workloads} "
        f"workloads x {sp.minutes} min ({runs} controller lanes): wall "
        f"{wall:.4f} s ({runs * lanes * sp.minutes / wall:.6g} lane-minutes"
        f"/s), rates generated in {gen_s:.1f} s, peak device memory {peak} "
        f"bytes, launches {counts}, pre-pass walks {walks}")
    log(f"[matrix {label}] mean over cells: slo_violation_rate "
        f"{float(pool.slo_violation_rate.mean())} replica_minutes "
        f"{float(pool.replica_minutes.mean())} scaling_actions "
        f"{float(pool.scaling_actions.mean())}")
    if profile:
        profile_row(lambda: (runner(rates), torch.cuda.synchronize()),
                    f"matrix {label}")
    return pool, per_w, counts, walks


def split_ms(rates, ctrl, cfg) -> dict:
    """Per-launch times of the episode (CUDA events, 3 launches after a
    warm-up): the whole episode and, where the policy has a pre-pass, the
    pre-pass and the plant pass alone."""
    from repro_torch.kernels import episode_block, ops, policy_signals
    ms = cuda_ms(lambda: ops.episode_block(rates, ctrl, cfg), iters=3)[0]
    if ctrl.name not in policy_signals.POLICIES:
        return dict(ms=ms, prepass_ms=None, plant_ms=ms)
    pre = cuda_ms(lambda: policy_signals.policy_signals_cuda(
        rates, ctrl, cfg), iters=3)[0]
    sig = policy_signals.policy_signals_cuda(rates, ctrl, cfg)
    plant = cuda_ms(lambda: episode_block.plant_pass_cuda(rates, ctrl, cfg,
                                                          sig), iters=3)[0]
    return dict(ms=ms, prepass_ms=pre, plant_ms=plant)


def resource_usage(so: Path) -> dict[str, dict[str, int]]:
    """Registers, stack, shared and local memory of every kernel entry in
    the built extension (``cuobjdump --dump-resource-usage``), by
    demangled name."""
    import re
    import shutil
    bindir = Path("/usr/local/cuda/bin")
    tool = shutil.which("cuobjdump") or str(bindir / "cuobjdump")
    dump = subprocess.run([tool, "--dump-resource-usage", str(so)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    found = re.findall(r"Function (\S+):\s+REG:(\d+)\s+STACK:(\d+)\s+"
                       r"SHARED:(\d+)\s+LOCAL:(\d+)", dump)
    if not found:
        raise RuntimeError(f"no kernel entries in cuobjdump's output:\n"
                           f"{dump[:2000]}")
    filt = shutil.which("cu++filt") or str(bindir / "cu++filt")
    names = subprocess.run([filt], input="\n".join(f[0] for f in found),
                           capture_output=True, text=True, check=True,
                           timeout=60).stdout.split("\n")
    return {name.strip(): dict(reg=int(r), stack=int(st), shared=int(sh),
                               local=int(lo))
            for name, (_, r, st, sh, lo) in zip(names, found)}


def launch_free(fn, what: str):
    """`fn()`, a plain version's run, checked to launch no kernel."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    result = fn()
    counts = ops.launch_counts()
    if any(counts.values()):
        raise RuntimeError(f"{what}: the plain version launched kernels "
                           f"{counts}")
    return result


class forbidden:
    """Within the block, calling `module.name` (a plain version) raises:
    the path must not reach it."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name

    def __enter__(self):
        self.saved = getattr(self.module, self.name)

        def refuse(*args, **kwargs):
            raise RuntimeError(f"the plain version {self.name} ran on the "
                               "card's path")
        setattr(self.module, self.name, refuse)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def assert_episode(got, want, what: str) -> float:
    """MinuteOut at the episode tolerance and archetypes exactly; returns
    the largest MinuteOut difference."""
    (out_k, arch_k), (out_p, arch_p) = got, want
    err = max_abs_err(out_k, out_p, EPISODE_TOL, what)
    if not torch.equal(arch_k, arch_p):
        bad = (arch_k != arch_p).nonzero()[:5].tolist()
        raise RuntimeError(f"{what}: archetype sequences differ at "
                           f"(lane, minute) {bad}")
    return err


def profile_row(run, label: str):
    """`run()` under torch.profiler: prints device time by kernel and the
    busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        prof_s = time.perf_counter() - t0
    by_kernel = sorted(((e.self_device_time_total, e.count, e.key)
                        for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and e.self_device_time_total > 0), reverse=True)
    device_ms = sum(t for t, _, _ in by_kernel) / 1e3
    log(f"[profile] {label}: wall {prof_s:.4f} s under the profiler, device"
        f" busy {device_ms:.3f} ms ({device_ms / (prof_s * 1e3):.4f} of "
        f"wall)")
    for t, n, key in by_kernel[:10]:
        log(f"[profile]   {t / 1e3:10.3f} ms  x{n:<6d} {key[:90]}")


def fleet_row(controller, cfg, rates, w_chunk: int, label: str):
    """The Table IV row on the card: a `make_simulator(w_chunk=...)`
    episode over `rates`, pooled metrics and REI, timed after a warm-up
    run with the launch counts reset just before it. Checks that the
    episode kernel ran and that the result is sound, prints it, and
    returns (launch counts, the row as a function, the first chunk's
    scale-downs)."""
    from repro_torch.evals import metrics, rei
    from repro_torch.kernels import ops
    from repro_torch.sim import cluster
    W, M = rates.shape
    sim = cluster.make_simulator(controller, cfg, w_chunk=w_chunk)

    def row():
        """Episode, then pooled metrics and REI: (out, wall of the
        episode, pool, score)."""
        t0 = time.perf_counter()
        out = sim(rates)
        torch.cuda.synchronize()
        episode_s = time.perf_counter() - t0
        pool = metrics.pooled(out)
        score = rei.rei(pool.slo_violation_rate, pool.replica_minutes,
                        pool.scaling_actions, minutes=M, n_workloads=W)
        torch.cuda.synchronize()
        return out, episode_s, pool, score

    row()                                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out, episode_s, pool, score = row()
    row_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    from repro_torch.kernels import policy_signals
    if counts["episode_block"] == 0 or (
            controller.name in policy_signals.POLICIES
            and counts["policy_signals"] == 0):
        raise RuntimeError(f"{label} launched no episode_block kernel or no "
                           f"pre-pass: {counts}")
    if tuple(out.served.shape) != (W, M):
        raise RuntimeError(f"MinuteOut shape {tuple(out.served.shape)}")
    for name, v in (*pool._asdict().items(), *score._asdict().items()):
        if not torch.isfinite(v).all():
            raise RuntimeError(f"non-finite {name}: {v}")
    if not all(bool(torch.isfinite(f).all()) for f in out):
        raise RuntimeError("non-finite MinuteOut values")
    served = float(out.served.double().sum())
    arrivals = float(rates.double().sum())
    if served > arrivals + 1e-3 * arrivals:
        raise RuntimeError(f"served {served} exceeds arrivals {arrivals}")
    log(f"[{label}] episode wall {episode_s:.4f} s "
        f"({W * M / episode_s:.6g} lane-minutes/s), episode + metrics + "
        f"REI {row_s:.4f} s, peak device memory {peak} bytes, "
        f"launches {counts}")
    log(f"[{label}] pooled slo_violation_rate="
        f"{float(pool.slo_violation_rate)} replica_minutes="
        f"{float(pool.replica_minutes)} scaling_actions="
        f"{float(pool.scaling_actions)} p95_ms={float(pool.p95_response_ms)}"
        f" rei={float(score.rei)} served={served} arrivals={arrivals}")
    return counts, row, float(out.downs[:w_chunk].double().sum())


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        np.ascontiguousarray(a).view(np.uint8),
        np.ascontiguousarray(b).view(np.uint8))


def aapaset_phase(dev):
    """21. AAPAset built on the card; returns (the built dataset, a
    loader over it, the build's launch counts)."""
    import tempfile

    from repro_torch.aapaset import build, loader, manifest, registry
    from repro_torch.data import azure_synth, windows
    from repro_torch.kernels import ops
    cfg = registry.get("aapaset_300k", feature_path="kernel")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    built = build.build(cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    if counts["window_features"] == 0:
        raise RuntimeError(f"the AAPAset build launched no window_features "
                           f"kernel: {counts}")
    n = len(built)
    # its host part (traces, windows) and device part (features, LFs),
    # each timed alone
    t0 = time.perf_counter()
    ds = windows.make_windows(
        azure_synth.generate_traces(n_functions=cfg.n_functions,
                                    n_days=cfg.n_days, seed=cfg.seed,
                                    family=cfg.family),
        window=cfg.window, stride=cfg.stride,
        min_total_invocations=cfg.min_total_invocations)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    build.featurize_windows(ds.windows, chunk=cfg.chunk, use_kernel=True)
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    if not same_bits(ds.windows, built.windows):
        raise RuntimeError("AAPAset: the windows differ between two builds")
    card = manifest.dataset_card(built)
    log(f"[aapaset] {cfg.name} (feature_path kernel): {n} windows of "
        f"{cfg.n_functions} functions x {cfg.n_days} days built in "
        f"{build_s:.4f} s ({n / build_s:.6g} windows/s); alone: traces + "
        f"windows (host) {host_s:.4f} s, features + LFs (device, "
        f"{-(-n // cfg.chunk)} chunks) {device_s:.4f} s; launches {counts}")
    log(f"[aapaset] labels: {card['n_labeled']} labeled, abstain rate "
        f"{card['abstain_rate']}, class balance {card['class_balance']}, "
        f"LF coverage {card['lf_coverage']}, conflict rate "
        f"{card['lf_conflict_rate']}, mean agreement "
        f"{card['mean_agreement']}, splits {card['split_sizes']}")
    plain = launch_free(lambda: build.featurize_windows(
        built.windows, chunk=cfg.chunk, use_kernel=False), "AAPAset ref path")
    for name, a, b in zip(("features", "labels", "confidence", "votes"),
                          (built.features, built.labels, built.confidence,
                           built.votes), plain):
        if not same_bits(a, b):
            raise RuntimeError(f"AAPAset: {name} of the kernel path differ "
                               "from the ref path's bits on the card")
    with tempfile.TemporaryDirectory() as root:
        man = manifest.save(built, cfg, root)
        back = manifest.load(cfg, root, verify=True)
    for name in (*manifest._SHARD_KEYS, "series", "series_pattern"):
        if not same_bits(getattr(built, name), getattr(back, name)):
            raise RuntimeError(f"AAPAset: {name} changed through save/load")
    log(f"[aapaset] the ref path on the card gives the same features, "
        f"votes, labels and confidence bit for bit; save -> load "
        f"round-trips every array exactly ({len(man['shards'])} shards, "
        f"{cfg.name}-{man['hash']})")
    return built, loader.AAPAsetLoader(built, man, dev), counts


def device_ms_by_range(run, names) -> dict:
    """`run()` under torch.profiler: device ms launched inside each
    ``record_function`` range of `names`, and in all ("total")."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    out = {n: sum(e.device_time_total for e in rows if e.key == n) / 1e3
           for n in names}
    out["total"] = sum(e.self_device_time_total for e in rows
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       ) / 1e3
    return out


def training_phase(data_loader, dev):
    """22. The classifier trained on the card from the AAPAset artifact;
    returns (its Classify, what was measured, training's launch counts)."""
    from repro_torch.core import calibration, gbdt, pipeline
    from repro_torch.kernels import ops
    cfg = gbdt.GBDTConfig()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    trained = pipeline.train_from_loader(data_loader, cfg)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    if counts["gbdt_tables"] == 0:
        raise RuntimeError(f"training launched no gbdt_tables kernel: "
                           f"{counts}")
    X, y, _ = data_loader.arrays("train")
    X_test, y_test, _ = data_loader.arrays("test")
    cls = trained.make_classify()
    probs = calibration.calibrate(trained.cal, gbdt.softmax(
        ops.gbdt_logits(trained.params, torch.as_tensor(X_test, device=dev))))
    ece = calibration.expected_calibration_error(probs.cpu().numpy(),
                                                 y_test)
    if not all(np.isfinite([trained.train_acc, trained.val_acc,
                            trained.test_acc, ece])):
        raise RuntimeError("training: a non-finite accuracy or ECE")
    log(f"[train] GBDT {cfg.n_rounds} rounds x {cfg.n_classes} classes, "
        f"depth {cfg.depth}, {cfg.n_bins} bins on {len(y)} training rows: "
        f"fit {trained.fit_seconds:.4f} s, fit + accuracies + calibration "
        f"{train_s:.4f} s; accuracy train {trained.train_acc} val "
        f"{trained.val_acc} test {trained.test_acc}; calibrated test ECE "
        f"{ece}; launches {counts}")
    # a second fit of the first 4 rounds; then one more under the profiler
    first = gbdt.GBDTConfig(n_rounds=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = gbdt.fit(X, y, first)
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    for name in ("feat", "thresh", "leaf"):
        if not torch.equal(getattr(again, name),
                           getattr(trained.params, name)[:4]):
            raise RuntimeError(f"GBDT fit on the card is not deterministic:"
                               f" the first 4 rounds' {name} differ")
    split = device_ms_by_range(lambda: gbdt.fit(X, y, first),
                               ("gbdt.histograms", "gbdt.split_search"))
    rest = split["total"] - split["gbdt.histograms"] \
        - split["gbdt.split_search"]
    log(f"[train] a second fit of the first 4 rounds ({refit_s:.4f} s) "
        f"gives the same trees bit for bit; a third's device time under "
        f"the profiler: histograms {split['gbdt.histograms']} ms, split "
        f"search {split['gbdt.split_search']} ms, the rest {rest} ms "
        f"(total {split['total']} ms)")
    # one root-level histogram alone (CUDA events): the sorted segment sum
    # beside index_add_'s float atomics on the same inputs
    K, F, B = cfg.n_classes, X.shape[1], cfg.n_bins
    xb = gbdt.bin_features(torch.as_tensor(X, device=dev),
                           trained.params.bin_edges).long()
    seg = ((torch.arange(K, device=dev) * F * B)[:, None, None]
           + torch.arange(F, device=dev) * B + xb).reshape(-1)
    gh = torch.randn(seg.shape[0], 2, device=dev)
    hist_ms = cuda_ms(lambda: gbdt._segment_sum(gh, seg, K * F * B),
                      iters=5)[0]
    atomic_ms = cuda_ms(lambda: gh.new_zeros(K * F * B, 2).index_add_(
        0, seg, gh), iters=5)[0]
    log(f"[train] one root-level histogram ({seg.shape[0]} entries into "
        f"{K * F * B} bins): sorted segment sum {hist_ms} ms, index_add_ "
        f"with float atomics {atomic_ms} ms")
    split.update(refit_s=refit_s, hist_ms=hist_ms, atomic_ms=atomic_ms)
    feats = torch.as_tensor(data_loader.data.features, device=dev)
    gbdt_equal(trained.params, feats, "the trained classifier")
    return cls, dict(train_s=train_s, fit_s=trained.fit_seconds,
                     test_acc=trained.test_acc, ece=ece, split=split), counts


def fleet_close(a, b, rtol: float, what: str) -> None:
    """The reference's fleet comparison (tests/test_fleet.py ``_close``):
    every pooled metric at `rtol` (quantiles at the histogram's half-bin
    bound) and atol 1e-3."""
    from repro_torch.evals import metrics
    q = 2.5 * metrics.quantile_rel_bound()
    for field in a._fields:
        tol = max(rtol, q) if field.startswith(("p95", "p99")) else rtol
        np.testing.assert_allclose(getattr(a, field), getattr(b, field),
                                   rtol=tol, atol=1e-3,
                                   err_msg=f"{what}: {field}")


def fleet_phase(cls, data_loader) -> dict:
    """23. Fleet runs through ``evals.fleet.run_fleet``; returns each
    run's meta and launch counts."""
    import dataclasses

    from repro_torch.evals import fleet
    from repro_torch.kernels import ops, policy_signals
    runs = {}

    def run(label, sp, **kw):
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        res = fleet.run_fleet(sp, classify=cls, **kw)
        counts = ops.launch_counts()
        if counts["episode_block"] == 0 or (
                any(p in policy_signals.POLICIES for p in sp.policies)
                and counts["policy_signals"] == 0):
            raise RuntimeError(f"fleet {label}: launches {counts}")
        for name, v in (*res.pooled._asdict().items(),
                        *res.rei._asdict().items()):
            if not np.isfinite(v).all():
                raise RuntimeError(f"fleet {label}: non-finite {name}")
        m = res.meta
        log(f"[fleet {label}] {'+'.join(sp.policies)}, {m['workloads']} x "
            f"{m['minutes']} in chunks of {m['w_chunk']}: wall "
            f"{m['wall_s']:.4f} s ({m['lane_minutes_per_sec']:.6g} "
            f"lane-minutes/s), {m['dispatches']} dispatches, peak device "
            f"memory {m['peak_device_bytes']} bytes ({live} live before "
            f"the run), host generation "
            f"{m['gen_s']:.4f} s (share {m['gen_share']:.4f}), launches "
            f"{counts}")
        for i, p in enumerate(sp.policies):
            log(f"[fleet {label}] {p}: slo_violation_rate "
                f"{res.pooled.slo_violation_rate[i]} replica_minutes "
                f"{res.pooled.replica_minutes[i]} scaling_actions "
                f"{res.pooled.scaling_actions[i]} p95_ms "
                f"{res.pooled.p95_response_ms[i]} rei {res.rei.rei[i]}")
        runs[label] = dict(meta=m, launches=counts)
        return res

    sp = fleet.spec("fleet_1e5", policies=("hpa", "aapa"),
                    scenario="burst_storm", n_workloads=FLEET_LANES,
                    w_chunk=FLEET_CHUNK, minutes=FLEET_MINUTES, seed=0)
    one = run("one-dispatch 1e5", sp, warmup=True)
    streamed = run("stream 1e5", sp, stream=True)
    fleet_close(streamed.pooled, one.pooled, 2e-6, "stream vs one-dispatch")
    np.testing.assert_allclose(streamed.rei.rei, one.rei.rei, rtol=2e-6)
    log("[fleet] the stream equals the one-dispatch run (rtol 2e-6, "
        "quantiles at the half-bin bound)")
    hpa = dataclasses.replace(sp, name="fleet_hpa_1e5", policies=("hpa",))
    base = run("stream hpa 1e5", hpa, stream=True)
    big = run("stream hpa 1e6", dataclasses.replace(
        hpa, name="fleet_hpa_1e6", n_workloads=10 * FLEET_LANES),
        stream=True)
    p5 = base.meta["peak_device_bytes"]
    p6 = big.meta["peak_device_bytes"]
    if abs(p6 - p5) > 0.05 * p5:
        raise RuntimeError(f"the 1e6-lane stream's peak device memory {p6} "
                           f"is not within 5% of the 1e5-lane stream's {p5}")
    log(f"[fleet] 1e6-lane peak device memory {p6} bytes, "
        f"{p6 / p5:.6f} x the 1e5-lane stream's")
    feed = dataclasses.replace(sp, name="fleet_aapaset_1e5")
    run("loader stream 1e5", feed, stream=True,
        chunks=data_loader.rate_chunks(feed.n_workloads, feed.w_chunk,
                                       minutes=feed.minutes))
    # what one chunk's fold into the pooled accumulators costs beside its
    # episode (HPA, the first chunk of the 1e5 fleet)
    from repro_torch.evals import metrics
    from repro_torch.sim.cluster import MinuteOut
    cfg = sp.sim_config()
    ctrl = fleet.controllers(hpa)[0]
    chunk = torch.as_tensor(fleet.chunk_rates(sp, 0), device="cuda")
    edges = metrics.response_edges(sp.bins, cfg.resp_cap_sec)
    ep_ms, out = cuda_ms(lambda: ops.episode_block(chunk, ctrl, cfg),
                         iters=3)
    flat = MinuteOut(*(f.reshape(-1) for f in out))
    acc = metrics.accum_init(sp.bins)
    fold_ms = cuda_ms(lambda: metrics.accum_update_pooled(acc, flat, edges),
                      iters=5)[0]
    log(f"[fleet] per {FLEET_CHUNK} x {FLEET_MINUTES} HPA chunk: episode "
        f"{ep_ms} ms, its fold into the pooled accumulators {fold_ms} ms")
    runs["fold"] = dict(episode_ms=ep_ms, fold_ms=fold_ms)
    return runs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import (_build, gbdt_tables, holt_winters, ops,
                                     plant_block, ref, window_features)
    from repro_torch.scaling import registry, scenarios
    from repro_torch.sim import cluster

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # ---- 1. build
    t0 = time.perf_counter()
    _build.extension()
    log(f"[build] kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(s.name for s in _build.SOURCES)})")

    # ---- 2. plant_block kernel vs plain
    rng = np.random.default_rng(0)
    B, S = 100_003, 30
    plant_err = 0.0
    for n_ticks in (14, 29, 3):
        args = plant_inputs(rng, B, S, dev)
        err, variant = plant_equal(args, n_ticks, f"B={B} T={n_ticks}")
        plant_err = max(plant_err, err)
    torch.cuda.synchronize()
    log(f"[plant_block] B={B} S={S} n_ticks=14/29/3, kernel {variant}: "
        f"equal to the plain version and to the per-thread kernel bit for "
        f"bit, max_abs_err={plant_err}")

    # ---- 3. episode_block kernel vs plain
    sc = scenarios.burst_storm(n_workloads=4099, minutes=30)
    rates = torch.as_tensor(sc.rates, device=dev)
    episode_err = 0.0
    for ci in (15, 7):
        cfg = cluster.SimConfig(control_interval_sec=ci)
        ctrl = registry.make("hpa", cfg)
        got = ops.episode_block(rates, ctrl, cfg)
        want = ref.episode_block_ref(rates, ctrl, cfg)
        episode_err = max(episode_err, max_abs_err(
            got, want, EPISODE_TOL, f"episode ci={ci}"))
    torch.cuda.synchronize()
    log(f"[episode_block] burst_storm 4099x30 ci=15/7 matches the plain "
        f"version, max_abs_err={episode_err}")

    # ---- 4. unfused path (plant_block per control period) vs fused
    cfg = cluster.SimConfig()
    ctrl = registry.make("hpa", cfg)
    mix = torch.as_tensor(
        scenarios.archetype_mix(n_workloads=1024, minutes=120).rates,
        device=dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    unfused = cluster.simulate(mix, ctrl, cfg, decide_kernel=False)
    torch.cuda.synchronize()
    unfused_s = time.perf_counter() - t0
    unfused_counts = ops.launch_counts()
    if unfused_counts["plant_block"] == 0:
        raise RuntimeError(f"unfused path launched no plant_block kernel: "
                           f"{unfused_counts}")
    fused = cluster.simulate(mix, ctrl, cfg)
    paths_err = max_abs_err(unfused, fused, EPISODE_TOL, "unfused vs fused")
    log(f"[paths] archetype_mix 1024x120: unfused path ({unfused_s:.3f} s,"
        f" launches {unfused_counts}, plant_block kernel "
        f"{plant_block.plant_tick_block_cuda.last_variant}) agrees with the "
        f"fused kernel, max_abs_err={paths_err}")

    # ---- 5. main path at fleet scale
    W, M, w_chunk = 100_000, 1440, 25_000
    t0 = time.perf_counter()
    fleet = scenarios.burst_storm(n_workloads=W, minutes=M, seed=0)
    fleet_rates = torch.as_tensor(fleet.rates, device=dev)
    log(f"[fleet] burst_storm {W}x{M} generated in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({fleet_rates.numel() * 4 / 1e6:.0f} MB of rates on the card)")
    main_counts, main_path, downs = fleet_row(ctrl, cfg, fleet_rates,
                                              w_chunk, "fleet")

    # ---- 6. kernels vs plain at their paths' shapes, and their times
    chunk = fleet_rates[:w_chunk]
    ep_ms, got = cuda_ms(lambda: ops.episode_block(chunk, ctrl, cfg),
                         iters=3)
    # one plain run (~3.5M eager launches); phases 3-4 warmed its path
    ep_plain_ms, want = cuda_ms(
        lambda: ref.episode_block_ref(chunk, ctrl, cfg), iters=1,
        warmup=False)
    ep_main_err = max_abs_err(got, want, EPISODE_TOL,
                              f"episode {w_chunk}x{M}")
    episode_err = max(episode_err, ep_main_err)
    del got, want
    log(f"[episode_block] fleet chunk {w_chunk}x{M} ci="
        f"{cfg.control_interval_sec} matches the plain version, "
        f"max_abs_err={ep_main_err}")
    buf_len = int(ctrl.hyper["buf_len"])
    ci, n_full, rem = cluster._ci_blocks(cfg)
    heads = n_full + (rem > 0)
    ep_ops = episode_ops(w_chunk, M, heads, downs, cfg.startup_sec, buf_len)
    ep_bound, ep_by = bound_ms(13.0 * 4 * w_chunk * M, ep_ops)

    Bu = mix.shape[0]
    pb = plant_inputs(np.random.default_rng(1), Bu, cfg.startup_sec, dev)
    T = ci - 1
    pb_main_err, pb_variant = plant_equal(pb, T, f"B={Bu} T={T}")
    plant_err = max(plant_err, pb_main_err)
    log(f"[plant_block] B={Bu} S={cfg.startup_sec} n_ticks={T}, kernel "
        f"{pb_variant}: equal to the plain version and to the per-thread "
        f"kernel bit for bit, max_abs_err={pb_main_err}")
    plant_launcher = plant_block.plant_tick_block_cuda

    def plant_times(args):
        """CUDA-graph replay of the staged kernel, the per-thread kernel,
        the same launch with an empty body, and the plain version."""
        return dict(
            ms=graph_ms(lambda: ops.plant_tick_block(*args, n_ticks=T),
                        iters=20),
            per_thread_ms=graph_ms(lambda: plant_launcher(
                *args, n_ticks=T, variant="per_thread"), iters=20),
            floor_ms=graph_ms(lambda: plant_block.empty_launch_cuda(
                *args, n_ticks=T), iters=20),
            plain_ms=graph_ms(lambda: ref.plant_block_ref(*args, n_ticks=T),
                              iters=3))
    pb_times = plant_times(pb)
    # what each tick adds at 1024 lanes, where the launch is most of it
    pb_by_ticks = {n: graph_ms(lambda: ops.plant_tick_block(*pb, n_ticks=n),
                               iters=20) for n in (1, 7, 14, 29)}
    pb_host_ms, _ = cuda_ms(lambda: ops.plant_tick_block(*pb, n_ticks=T),
                            iters=20)
    pb_bound, pb_by = bound_ms(plant_bytes(Bu, cfg.startup_sec, T),
                               Bu * T * PLANT_OPS_PER_TICK)
    big = plant_inputs(np.random.default_rng(2), B, S, dev)
    big_err, big_variant = plant_equal(big, T, f"B={B} T={T}")
    plant_err = max(plant_err, big_err)
    big_times = plant_times(big)
    big_bound, big_by = bound_ms(plant_bytes(B, S, T),
                                 B * T * PLANT_OPS_PER_TICK)
    log(f"[timing] episode_block {w_chunk}x{M}: {ep_ms} ms, plain "
        f"{ep_plain_ms} ms, bound {ep_bound} ms ({ep_by})")
    log(f"[timing] plant_block B={Bu} S={S} T={T} (CUDA-graph replay), "
        f"kernel {pb_variant}: {pb_times['ms']} ms (eager back-to-back "
        f"calls: {pb_host_ms} ms each), the per-thread kernel "
        f"{pb_times['per_thread_ms']} ms, the same launch with an empty "
        f"body {pb_times['floor_ms']} ms, plain {pb_times['plain_ms']} ms, "
        f"bound {pb_bound} ms ({pb_by})")
    log(f"[timing] plant_block B={Bu} S={S} (CUDA-graph replay) at "
        f"n_ticks 1/7/14/29: {list(pb_by_ticks.values())} ms")
    log(f"[timing] plant_block B={B} S={S} T={T} (CUDA-graph replay), "
        f"kernel {big_variant}: {big_times['ms']} ms, the per-thread "
        f"kernel {big_times['per_thread_ms']} ms, the same launch with an "
        f"empty body {big_times['floor_ms']} ms, plain "
        f"{big_times['plain_ms']} ms, bound {big_bound} ms ({big_by})")

    # ---- 7. where the fleet run's device time goes
    profile_row(main_path, "HPA fleet episode + metrics + REI")

    # ---- 8. classification path at AAPAset scale
    from repro_torch.core import features
    from repro_torch.data import azure_synth, windows
    t0 = time.perf_counter()
    ds = windows.make_windows(azure_synth.generate_traces(
        n_functions=150, n_days=14, seed=0))
    wins = torch.as_tensor(ds.windows, device=dev)
    N = wins.shape[0]
    log(f"[classify] {N} windows x 60 ({wins.numel() * 4 / 1e6:.1f} MB) "
        f"made in {time.perf_counter() - t0:.1f} s")
    quant = [features.FEATURE_NAMES.index(n) for n in features.QUANTIZED]
    quant28 = [i for i in quant if i < 28]
    wf_launcher = window_features.window_features_cuda
    wf_err = 0.0
    # W = 60 (the w60 kernel, then the generic one forced) and W = 45
    for width, variant in ((60, None), (60, "generic"), (45, None)):
        x = wins if width == 60 else wins[:, :width].contiguous()
        wf_k = wf_launcher(x, variant=variant)
        wf_var = wf_launcher.last_variant
        wf_p = launch_free(lambda: ref.window_features_ref(x),
                           "window_features")
        if not torch.equal(wf_k[:, quant28], wf_p[:, quant28]):
            raise RuntimeError("window_features: quantized features differ "
                               "from the plain version")
        err = max_abs_err([wf_k], [wf_p], FEATURE_TOL, "window_features")
        if not torch.equal(wf_k, wf_p):
            raise RuntimeError(f"window_features {wf_var} at W = {width}: "
                               "the 28 features differ from the plain "
                               "version's bits")
        log(f"[window_features] {N} x {width}, 28 features, kernel "
            f"{wf_var}: equal to the plain version bit for bit (within "
            f"rtol/atol 5e-4, quantized features exact), "
            f"max_abs_err={err}")
        feats = wf_launcher(x, freq=True, variant=variant)
        fx_p = launch_free(lambda: ref.extract_features_ref(x),
                           "extract_features")
        if not (torch.equal(feats[:, :28], wf_k)
                and torch.equal(feats[:, quant], fx_p[:, quant])):
            raise RuntimeError("window_features with the frequency "
                               "features: the 28 differ from the 28-feature "
                               "launch, or quantized features differ from "
                               "the plain version")
        fx_err = max_abs_err([feats], [fx_p], FEATURE_TOL,
                             "extract_features")
        if not torch.equal(feats, fx_p):
            raise RuntimeError(f"window_features {wf_var} at W = {width}: "
                               "the 38 features differ from the plain "
                               "version's bits")
        wf_err = max(wf_err, err, fx_err)
        log(f"[window_features] {N} x {width}, all 38 features in one "
            f"launch, kernel {wf_launcher.last_variant}: equal to the plain "
            f"version bit for bit (the 28 equal to the 28-feature launch), "
            f"max_abs_err={fx_err}")
        del x, wf_k, wf_p, fx_p
    feats = ops.extract_features_fused(wins)
    cls = seeded_classifier(feats.cpu().numpy(), dev)
    gb_launcher = gbdt_tables.gbdt_logits_cuda
    gb_err = 0.0
    # the paper's ensemble (tables in shared memory), then one of depth 6
    # whose tables exceed the shared-memory budget
    for label, params in (("240 trees of depth 4", cls.params),
                          ("240 trees of depth 6", seeded_classifier(
                              feats.cpu().numpy(), dev, depth=6).params)):
        err, gb_var = gbdt_equal(params, feats, label)
        gb_err = max(gb_err, err)
    if gb_var != "generic":
        raise RuntimeError("the depth-6 ensemble did not take the generic "
                           "gbdt_tables kernel")

    def classify_path():
        feats = ops.extract_features_fused(wins)
        return cls(feats)

    classify_path()                                   # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    arch, conf = classify_path()
    torch.cuda.synchronize()
    classify_s = time.perf_counter() - t0
    classify_counts = ops.launch_counts()
    for k in ("window_features", "gbdt_tables"):
        if classify_counts[k] == 0:
            raise RuntimeError(f"classification path launched no {k} "
                               f"kernel: {classify_counts}")
    if not bool(torch.isfinite(conf).all()) or not (
            (arch >= 0) & (arch < 4)).all():
        raise RuntimeError("classification path: bad archetype or "
                           "confidence")
    hist = torch.bincount(arch.long(), minlength=4).tolist()
    walls = []
    for _ in range(20):       # one run's wall is mostly host noise
        t0 = time.perf_counter()
        classify_path()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    classify_med = float(np.median(walls))
    log(f"[classify] features -> logits -> calibrated archetype for {N} "
        f"windows: {classify_s} s, the median of 20 more runs "
        f"{classify_med} s ({N / classify_med} windows/s), "
        f"archetype histogram {hist}, mean confidence "
        f"{float(conf.mean())}, launches {classify_counts}")
    wf28_ms = cuda_ms(lambda: ops.window_features(wins), iters=10)[0]
    wf28_bound, wf28_by = bound_ms(4.0 * N * (60 + 28),
                                   float(N) * stat_feature_ops(60))
    wf_ms = cuda_ms(lambda: ops.extract_features_fused(wins), iters=10)[0]
    wf_variant = wf_launcher.last_variant
    wf_generic_ms = cuda_ms(lambda: wf_launcher(wins, freq=True,
                                                variant="generic"),
                            iters=10)[0]
    wf_plain_ms = cuda_ms(lambda: ref.extract_features_ref(wins),
                          iters=2)[0]
    centred = wins - wins.mean(-1, keepdim=True)
    rfft_ms = cuda_ms(lambda: torch.fft.rfft(centred, dim=-1), iters=10)[0]
    twiddle_bytes = 4.0 * features.fft_tables(60, dev)[0].numel()
    wf_bound, wf_by = bound_ms(
        4.0 * N * (60 + 38) + twiddle_bytes,
        float(N) * (stat_feature_ops(60) + freq_feature_ops(60)))
    gb_ms = cuda_ms(lambda: ops.gbdt_logits(cls.params, feats), iters=10)[0]
    gb_variant = gb_launcher.last_variant
    gb_generic_ms = cuda_ms(lambda: gb_launcher(cls.params, feats,
                                                variant="generic"),
                            iters=10)[0]
    gb_plain_ms = cuda_ms(
        lambda: ref.gbdt_logits_ref(cls.params, feats), iters=2)[0]
    n_edges = cls.params.bin_edges.shape[1]
    table_bytes = sum(t.numel() * 4 for t in (
        cls.params.bin_edges, *cls.params.tables, cls.params.base))
    gb_bound, gb_by = bound_ms(4.0 * N * (38 + 4) + table_bytes,
                               float(N) * gbdt_ops(38, n_edges, 240, 4))
    log(f"[timing] window_features {N} x 60, 38 features (the "
        f"classification path's launch, kernel {wf_variant}): {wf_ms} ms, "
        f"the generic kernel {wf_generic_ms} ms, plain {wf_plain_ms} "
        f"ms, bound {wf_bound} ms ({wf_by}); torch.fft.rfft for the 10 "
        f"frequency features' FFT alone: {rfft_ms} ms")
    log(f"[timing] window_features {N} x 60, 28 features: {wf28_ms} ms, "
        f"bound {wf28_bound} ms ({wf28_by})")
    log(f"[timing] gbdt_tables {N} x 38, kernel {gb_variant}: {gb_ms} ms, "
        f"the generic kernel {gb_generic_ms} ms, plain {gb_plain_ms} ms, "
        f"bound {gb_bound} ms ({gb_by})")
    del feats, centred, arch, conf

    # ---- 9. the AAPA episode kernel against its plain version
    from repro_torch.kernels import episode_block
    aapa_err = 0.0
    for stride in (10, 2):
        cfg7 = cluster.SimConfig(control_interval_sec=7)
        actrl = registry.make("aapa", cfg7, classify=cls, stride_min=stride)
        aapa_err = max(aapa_err, assert_episode(
            episode_block.aapa_episode_cuda(mix, actrl, cfg7),
            launch_free(lambda: ref.aapa_episode_ref(mix, actrl, cfg7),
                        f"aapa ci=7 stride={stride}"),
            f"aapa archetype_mix ci=7 stride={stride}"))
    torch.cuda.synchronize()
    log(f"[episode_block<AAPA>] archetype_mix 1024x120 ci=7 stride 10/2 "
        f"matches the plain version (archetypes exact), "
        f"max_abs_err={aapa_err}")
    # the plain check runs the chunk's first AAPA_PLAIN_MINUTES minutes
    # (the plain episode is host-bound: a whole day takes ~75 s)
    actrl = registry.make("aapa", cfg, classify=cls)
    got = episode_block.aapa_episode_cuda(chunk, actrl, cfg)
    arch_hist = torch.bincount(got[1].reshape(-1).long(),
                               minlength=4).tolist()
    aapa_downs = float(got[0].downs.double().sum())
    head = chunk[:, :AAPA_PLAIN_MINUTES].contiguous()
    got = episode_block.aapa_episode_cuda(head, actrl, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = launch_free(lambda: ref.aapa_episode_ref(head, actrl, cfg),
                       f"aapa {w_chunk}x{AAPA_PLAIN_MINUTES}")
    torch.cuda.synchronize()
    aapa_plain_s = time.perf_counter() - t0
    chunk_err = assert_episode(got, want,
                               f"aapa {w_chunk}x{AAPA_PLAIN_MINUTES}")
    aapa_err = max(aapa_err, chunk_err)
    log(f"[episode_block<AAPA>] fleet chunk {w_chunk}x{AAPA_PLAIN_MINUTES} "
        f"ci=15 stride 10 matches the plain version (archetypes exact), "
        f"max_abs_err={chunk_err}; lane-minutes by archetype over the day "
        f"{arch_hist}")
    del got, want, head
    aapa_split = split_ms(chunk, actrl, cfg)
    aapa_ms = aapa_split["ms"]
    stride = int(actrl.hyper["stride_min"])
    aapa_bound, aapa_by = bound_ms(
        13.0 * 4 * w_chunk * M,
        aapa_episode_ops(w_chunk, M, heads, stride, aapa_downs, cls,
                         cfg.startup_sec))
    log(f"[timing] episode_block<AAPA> {w_chunk}x{M}: {aapa_ms} ms (pre-pass "
        f"{aapa_split['prepass_ms']} ms, plant pass {aapa_split['plant_ms']} "
        f"ms), plain {w_chunk}x{AAPA_PLAIN_MINUTES} {aapa_plain_s * 1e3} ms "
        f"(one run, host clock), bound {aapa_bound} ms ({aapa_by})")

    # ---- 21-22. AAPAset built and the classifier trained on the card;
    # the AAPA and hybrid fleet rows of phases 10 and 14 classify with it
    built, data_loader, aapaset_counts = aapaset_phase(dev)
    tcls, train_info, train_counts = training_phase(data_loader, dev)

    # ---- 10. the AAPA fleet: Table IV row
    tctrl = registry.make("aapa", cfg, classify=tcls)
    aapa_counts, aapa_path, _ = fleet_row(tctrl, cfg, fleet_rates, w_chunk,
                                          "aapa fleet")
    profile_row(aapa_path, "AAPA fleet episode + metrics + REI")

    # ---- 11. holt_winters kernel vs plain
    from repro_torch.forecast import conformal
    from repro_torch.forecast import registry as forecast_registry
    hw_launcher = holt_winters.holt_winters_cuda
    hw_err = 0.0
    for (hb, ht, period, alpha) in ((100_003, 2880, 60, 0.1),
                                    (20_011, 1000, 96, 0.1),
                                    (20_011, 1000, 97, 0.1),
                                    (4099, 3000, 1440, 0.1),
                                    (257, 61, 60, 0.37)):
        y = torch.as_tensor(np.random.default_rng(hb).gamma(
            2.0, 60.0, (hb, ht)).astype(np.float32), device=dev)
        got = ops.holt_winters(y, period=period, alpha=alpha)
        hw_var = hw_launcher.last_variant
        want = launch_free(lambda: ref.holt_winters_ref(
            y, period=period, alpha=alpha), "holt_winters")
        err = max_abs_err([got], [want], HW_TOL, f"holt_winters {hb}x{ht}")
        if not torch.equal(got, want):
            raise RuntimeError(f"holt_winters {hw_var} {hb}x{ht} period "
                               f"{period}: the forecasts differ from the "
                               "plain version's bits")
        hw_err = max(hw_err, err)
        log(f"[holt_winters] {hb}x{ht} period {period} alpha {alpha}, "
            f"kernel {hw_var}: equal to the plain version bit for bit "
            f"(within rtol 1e-4 / atol 1e-3), max_abs_err={err}")
        del y, got, want
    torch.cuda.synchronize()

    # ---- 12. split-conformal calibration on the card, then coverage
    t0 = time.perf_counter()
    split = torch.as_tensor(scenarios.burst_storm(
        n_workloads=W, minutes=2 * M, seed=1).rates, device=dev)
    log(f"[conformal] calibration split burst_storm {W}x{2 * M} generated "
        f"in {time.perf_counter() - t0:.1f} s ({split.numel() * 4 / 1e6:.0f}"
        f" MB of rates on the card)")
    fcst = forecast_registry.make("holt_winters")
    band = conformal.calibrate(fcst, split, alpha=0.9)      # warm-up
    conformal.coverage(fcst, band, fleet_rates)
    conformal_counts = {}
    with forbidden(ref, "holt_winters_ref"):
        for what, call in (
                ("calibrate", lambda: conformal.calibrate(fcst, split,
                                                          alpha=0.9)),
                ("coverage", lambda: conformal.coverage(fcst, band,
                                                        fleet_rates))):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            result = call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            if counts != dict(dict.fromkeys(counts, 0), holt_winters=1):
                raise RuntimeError(f"{what} launched {counts}, not one "
                                   "holt_winters kernel")
            conformal_counts[what] = counts["holt_winters"]
            if what == "calibrate":
                band, calibrate_s = result, wall
            else:
                cov, coverage_s = result, wall
    q, scale = float(band.q), float(band.scale)
    conf = float(conformal.confidence(band))
    if not (np.isfinite([q, scale, conf, cov]).all() and q > 0
            and 0.0 < conf <= 1.0 and 0.0 <= cov <= 1.0):
        raise RuntimeError(f"conformal band q={q} scale={scale} "
                           f"confidence={conf} coverage={cov}")
    log(f"[conformal] calibrate {W}x{2 * M} at alpha 0.9: q={q} scale="
        f"{scale} confidence={conf}, wall {calibrate_s:.4f} s "
        f"({W * 2 * M / calibrate_s:.6g} series-minutes/s); coverage on "
        f"the held-out fleet day {W}x{M}: {cov}, wall {coverage_s:.4f} s; "
        f"holt_winters launches {conformal_counts}")
    hw_ms = cuda_ms(lambda: ops.holt_winters(split), iters=5)[0]
    hw_variant = hw_launcher.last_variant
    hw_global_ms = cuda_ms(lambda: hw_launcher(split, variant="global"),
                           iters=5)[0]
    odd = torch.empty(split.numel() + 1, device=dev)[1:].view_as(split)
    odd.copy_(split)                       # 16-B misaligned: 4-B copies
    hw_4b_ms = cuda_ms(lambda: hw_launcher(odd), iters=5)[0]
    if not torch.equal(hw_launcher(odd), hw_launcher(split)):
        raise RuntimeError("holt_winters: the 4-B copies' forecasts differ "
                           "from the 16-B copies'")
    del odd
    hw_plain_ms = cuda_ms(lambda: ref.holt_winters_ref(split), iters=1)[0]
    hw_bound, hw_by = bound_ms(2.0 * 4 * split.numel(),
                               float(split.numel()) * HW_OPS_PER_STEP)
    log(f"[timing] holt_winters {W}x{2 * M} (kernel {hw_variant}): {hw_ms} "
        f"ms; the season in global scratch {hw_global_ms} ms; 4-B copies "
        f"of a misaligned split {hw_4b_ms} ms; plain {hw_plain_ms} ms, "
        f"bound {hw_bound} ms ({hw_by})")
    resid = (split - ops.holt_winters(split)).abs()[:, 60:].reshape(-1)
    sort_ms = cuda_ms(lambda: torch.sort(resid), iters=3)[0]
    log(f"[timing] the calibration's sort of {resid.numel()} residuals: "
        f"{sort_ms} ms")
    del resid
    profile_row(lambda: (conformal.calibrate(fcst, split, alpha=0.9),
                         torch.cuda.synchronize()), "conformal calibrate")
    del split

    # ---- 13. the other policies' episode kernels vs their plain episodes
    pols = {
        "predictive": ("predictive", {}),
        "predictive_conservative_band": ("predictive",
                                         dict(band=band,
                                              conservative=True)),
        "kpa": ("kpa", {}),
        "aapa_band": ("aapa", dict(band=band, classify=cls)),
        "hybrid_band": ("hybrid", dict(band=band, classify=cls)),
    }
    short = fleet_rates[:w_chunk, :240].contiguous()
    cfg7 = cluster.SimConfig(control_interval_sec=7)
    pol_err, pol_plain_s = {}, {}
    for label, (name, kw) in pols.items():
        err = 0.0
        for rr, c, what in ((short, cfg, f"{w_chunk}x240 ci=15"),
                            (mix, cfg7, "1024x120 ci=7")):
            ctrl = registry.make(name, c, **kw)
            arch = name in episode_block.ARCHETYPE_POLICIES
            got = (episode_block.aapa_episode_cuda if arch
                   else ops.episode_block)(rr, ctrl, c)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = launch_free(lambda: (
                ref.aapa_episode_ref if arch else ref.episode_block_ref)(
                    rr, ctrl, c), f"{label} {what}")
            torch.cuda.synchronize()
            if rr is short:
                pol_plain_s[label] = time.perf_counter() - t0
            err = max(err, assert_episode(got, want, f"{label} {what}")
                      if arch else max_abs_err(got, want, EPISODE_TOL,
                                               f"{label} {what}"))
            del got, want
        pol_err[label] = err
        log(f"[episode_block<{label}>] {w_chunk}x240 ci=15 and 1024x120 "
            f"ci=7 match the plain version"
            + (" (archetypes exact)" if name in
               episode_block.ARCHETYPE_POLICIES else "")
            + f", max_abs_err={err}")

    # ---- 14. a Table IV row for each of them, and the kernel's time
    pol_rows = {}
    for label, (name, kw) in pols.items():
        if "classify" in kw:                  # the trained classifier
            kw = dict(kw, classify=tcls)
        ctrl = registry.make(name, cfg, **kw)
        counts, _, pdowns = fleet_row(ctrl, cfg, fleet_rates, w_chunk,
                                      f"{label} fleet")
        split = split_ms(chunk, ctrl, cfg)
        ms = split["ms"]
        ms240 = cuda_ms(lambda: ops.episode_block(short, ctrl, cfg),
                        iters=3)[0]
        if name == "predictive":
            n_ops = episode_ops(w_chunk, M, heads, pdowns, cfg.startup_sec,
                                PRED_OPS_PER_HEAD, PRED_OPS_PER_MINUTE)
        elif name == "kpa":
            n_ops = episode_ops(w_chunk, M, heads, pdowns, cfg.startup_sec,
                                KPA_OPS_PER_HEAD)
        else:
            n_ops = aapa_episode_ops(w_chunk, M, heads,
                                     int(ctrl.hyper["stride_min"]), pdowns,
                                     cls, cfg.startup_sec,
                                     guard=name == "hybrid",
                                     confidence=True)
        bnd, by = bound_ms(13.0 * 4 * w_chunk * M, n_ops)
        pol_rows[label] = dict(launches=counts["episode_block"], ms=ms,
                               prepass_ms=split["prepass_ms"],
                               plant_ms=split["plant_ms"],
                               prepass_launches=counts["policy_signals"],
                               ms_240=ms240, bound_ms=bnd, bound_by=by)
        log(f"[timing] episode_block<{label}> {w_chunk}x{M}: {ms} ms "
            f"(pre-pass {split['prepass_ms']} ms, plant pass "
            f"{split['plant_ms']} ms; {w_chunk}x240: {ms240} ms), plain "
            f"{w_chunk}x240 {pol_plain_s[label] * 1e3} ms (one run, host "
            f"clock), bound {bnd} ms ({by})")

    # ---- 15. the pre-pass kernels vs their plain version on the chunk
    from repro_torch.kernels import policy_signals
    sig_err = 0.0
    for label in ("aapa_band", "predictive_conservative_band"):
        name, kw = pols[label]
        ctrl = registry.make(name, cfg, **kw)
        arch = name in episode_block.ARCHETYPE_POLICIES
        got = policy_signals.policy_signals_cuda(chunk, ctrl, cfg,
                                                 minute_arch=arch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = launch_free(lambda: ref.policy_signals_ref(
            chunk, ctrl, cfg, minute_arch=arch), f"policy_signals {label}")
        torch.cuda.synchronize()
        sig_plain_s = time.perf_counter() - t0
        for field, a, e in zip(policy_signals.Signals._fields, got, want):
            if (a is None) != (e is None) or (
                    a is not None and not torch.equal(a, e)):
                raise RuntimeError(f"policy_signals {label}: {field} differs "
                                   "from the plain version")
        log(f"[policy_signals<{label}>] {w_chunk}x{M} equals the plain "
            f"version bit for bit (plain {sig_plain_s:.1f} s, host clock)")
        if name == "aapa":
            pre_plain_ms = sig_plain_s * 1e3
            pre_ctrl = ctrl
        del got, want
    pre_ms = pol_rows["aapa_band"]["prepass_ms"]
    pre_bound, pre_by = prepass_bound(pre_ctrl, w_chunk, M, cls)
    log(f"[timing] policy_signals<aapa_band> {w_chunk}x{M}: {pre_ms} ms, "
        f"plain {pre_plain_ms} ms (one run, host clock), bound {pre_bound} "
        f"ms ({pre_by})")

    # ---- 16. one launch over the fleet, and each kernel's resources
    hctrl = registry.make("hpa", cfg)
    wide_hpa = cuda_ms(lambda: ops.episode_block(fleet_rates, hctrl, cfg),
                       iters=1)[0]
    four_hpa = cuda_ms(lambda: [ops.episode_block(
        fleet_rates[i:i + w_chunk], hctrl, cfg) for i in range(0, W, w_chunk)],
        iters=1)[0]
    sig_all = policy_signals.policy_signals_cuda(fleet_rates, actrl, cfg)
    sig_chunks = [policy_signals.policy_signals_cuda(
        fleet_rates[i:i + w_chunk], actrl, cfg) for i in range(0, W, w_chunk)]
    wide_aapa = cuda_ms(lambda: episode_block.plant_pass_cuda(
        fleet_rates, actrl, cfg, sig_all), iters=1)[0]
    four_aapa = cuda_ms(lambda: [episode_block.plant_pass_cuda(
        fleet_rates[i:i + w_chunk], actrl, cfg, sig) for i, sig in zip(
            range(0, W, w_chunk), sig_chunks)], iters=1)[0]
    del sig_all, sig_chunks
    log(f"[wide] {W}x{M} in one launch against {W // w_chunk} launches of "
        f"{w_chunk}: HPA episode {wide_hpa} / {four_hpa} ms, AAPA plant pass "
        f"{wide_aapa} / {four_aapa} ms")
    usage = resource_usage(next(_build.BUILD_DIR.glob("*.so")))
    for entry, u in sorted(usage.items()):
        log(f"[resources] REG {u['reg']:3d} STACK {u['stack']:5d} SHARED "
            f"{u['shared']:6d} LOCAL {u['local']:5d}  {entry[:110]}")
    gb_entries = {e: u for e, u in usage.items()
                  if "gbdt_shared_kernel" in e}
    if len(gb_entries) != 2 or any(u["stack"] or u["local"]
                                   for u in gb_entries.values()):
        raise RuntimeError(f"the shared-memory gbdt_tables kernels (the "
                           f"paper's depth compiled in, and any depth) are "
                           f"not two entries without stack or local "
                           f"memory: {gb_entries}")
    w60_entries = {e: u for e, u in usage.items()
                   if "window_features_kernel<(bool)1" in e}
    if len(w60_entries) != 2 or any(u["stack"] or u["local"]
                                    for u in w60_entries.values()):
        raise RuntimeError(f"the W = 60 window_features kernels are not two "
                           f"entries without stack or local memory: "
                           f"{w60_entries}")
    plant_entries = {p: [u for e, u in usage.items()
                         if "episode_kernel" in e and f"::{p}>" in e]
                     for p in ("HPA", "AAPA", "Hybrid")}
    for p, us in plant_entries.items():
        if len(us) != 1:
            raise RuntimeError(f"no single episode_kernel<{p}> entry in "
                               f"{sorted(usage)}")
    if any(plant_entries[p][0]["stack"] > plant_entries["HPA"][0]["stack"]
           for p in ("AAPA", "Hybrid")):
        raise RuntimeError(f"the AAPA or hybrid plant pass holds more stack "
                           f"than HPA's: {plant_entries}")

    # ---- 17. every registry forecaster in the episode, bit for bit
    from repro_torch.evals import matrix
    from repro_torch.forecast import registry as forecast_registry
    new_fcs = [f for f in forecast_registry.available()
               if f != "holt_winters"]
    fmix = torch.as_tensor(scenarios.archetype_mix(
        n_workloads=4096, minutes=240, seed=5).rates, device=dev)
    fc_cases = {
        "predictive": ("predictive", {}),
        "predictive_conservative_band": ("predictive",
                                         dict(band=band, conservative=True)),
        "aapa_conf": ("aapa", dict(classify=cls, forecast_confidence=True)),
        "hybrid_band": ("hybrid", dict(classify=cls, band=band)),
    }
    t0 = time.perf_counter()
    for fname in new_fcs:
        for label, (name, kw) in fc_cases.items():
            ctrl = registry.make(name, cfg, forecaster=fname, **kw)
            arch = name in episode_block.ARCHETYPE_POLICIES
            got = (episode_block.aapa_episode_cuda if arch
                   else ops.episode_block)(fmix, ctrl, cfg)
            want = launch_free(lambda: (
                ref.aapa_episode_ref if arch else ref.episode_block_ref)(
                    fmix, ctrl, cfg), f"{label}[{fname}]")
            outs = zip(got[0], want[0]) if arch else zip(got, want)
            if not all(torch.equal(a, e) for a, e in outs) or (
                    arch and not torch.equal(got[1], want[1])):
                raise RuntimeError(f"episode {label}[{fname}] 4096x240 "
                                   "differs from its plain version")
            del got, want
    torch.cuda.synchronize()
    log(f"[forecasters] {len(new_fcs) * len(fc_cases)} episodes "
        f"({', '.join(fc_cases)} x {', '.join(new_fcs)}) on archetype_mix "
        f"4096x240 equal their plain versions bit for bit, archetypes "
        f"included ({time.perf_counter() - t0:.1f} s)")

    # ---- 18. the new pre-pass walks vs plain on the chunk, and their times
    walk_rows = {}
    for fname in new_fcs:
        for label in ("predictive_conservative_band", "aapa_conf"):
            name, kw = fc_cases[label]
            ctrl = registry.make(name, cfg, forecaster=fname, **kw)
            arch = name == "aapa"
            got = policy_signals.policy_signals_cuda(chunk, ctrl, cfg,
                                                     minute_arch=arch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = launch_free(lambda: ref.policy_signals_ref(
                chunk, ctrl, cfg, minute_arch=arch),
                f"policy_signals {label}[{fname}]")
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            for field, a, e in zip(policy_signals.Signals._fields, got,
                                   want):
                if (a is None) != (e is None) or (
                        a is not None and not torch.equal(a, e)):
                    raise RuntimeError(f"policy_signals {label}[{fname}]: "
                                       f"{field} differs from the plain "
                                       "version")
            del got, want
            ms = cuda_ms(lambda: policy_signals.policy_signals_cuda(
                chunk, ctrl, cfg), iters=3)[0]
            bnd, by = walk_bound(ctrl, w_chunk, M, cls)
            walk_rows[f"{name}:{fname}"] = dict(
                label=label, ms=ms, plain_ms=plain_s * 1e3, bound_ms=bnd,
                bound_by=by)
            log(f"[policy_signals<{name}:{fname}>] {label} {w_chunk}x{M} "
                f"equals the plain version bit for bit; {ms} ms per launch,"
                f" plain {plain_s * 1e3} ms (one run, host clock), bound "
                f"{bnd} ms ({by})")

    # ---- 19. the Table IV matrix on the card at three sizes
    run_matrix(matrix, bench_spec(matrix), cls, "SPEC")
    run_matrix(matrix, sweep_spec(matrix), cls, "SWEEP_SPEC")
    fleet_pool, _, fleet_counts, fleet_walks = run_matrix(
        matrix, fleet_spec(matrix), cls, "fleet", profile=True,
        per_workload=False, w_chunk=w_chunk)
    for walk in walk_rows:
        if fleet_walks.get(walk, 0) == 0:
            raise RuntimeError(f"the fleet matrix launched no {walk} walk: "
                               f"{fleet_walks}")

    # ---- 20. a small matrix on the card against the plain matrix on the CPU
    small = accept_spec(matrix)
    small_rates = matrix.build_rates(small)
    card = matrix.make_runner(small, device="cuda")(small_rates)
    plain = launch_free(lambda: matrix.make_runner(small, device="cpu")(
        small_rates), "matrix on the CPU")
    counts_exact = ("scaling_actions", "oscillations",
                    "mean_action_interval_min", "overprovision_rate")
    small_err = 0.0
    for mode, got, want in (("pooled", card[0], plain[0]),
                            ("per workload", card[1], plain[1])):
        for field, a, e in zip(got._fields, got, want):
            a = a.cpu()
            if field in counts_exact:
                if not torch.equal(a, e):
                    raise RuntimeError(f"matrix {mode} {field}: the card's "
                                       "counts differ from the CPU's")
            else:
                torch.testing.assert_close(
                    a, e, rtol=2e-6, atol=0.0,
                    msg=lambda m: f"matrix {mode} {field}: {m}")
            small_err = max(small_err, float((a - e).abs().max()))
    log(f"[matrix small] {small.shape} x {small.n_workloads} x "
        f"{small.minutes} on the card matches the plain matrix on the CPU "
        f"(rtol 2e-6, counts exact), max_abs_err={small_err}")

    # ---- 23. fleet runs through evals.fleet
    del built
    fleet_runs = fleet_phase(tcls, data_loader)

    kernels = [
        dict(name="plant_block", route="cuda",
             source="src/repro_torch/kernels/csrc/plant_block.cu",
             replaces="src/repro/kernels/plant_block.py:96",
             launches=unfused_counts["plant_block"], max_abs_err=plant_err,
             ms=pb_times["ms"], variant=pb_variant,
             per_thread_ms=pb_times["per_thread_ms"],
             floor_ms=pb_times["floor_ms"], plain_ms=pb_times["plain_ms"],
             bound_ms=pb_bound, bound_by=pb_by, library_ms=None,
             fleet_width=dict(lanes=B, ms=big_times["ms"],
                              variant=big_variant,
                              per_thread_ms=big_times["per_thread_ms"],
                              floor_ms=big_times["floor_ms"],
                              plain_ms=big_times["plain_ms"],
                              bound_ms=big_bound)),
        dict(name="episode_block", policy="hpa", route="cuda",
             source="src/repro_torch/kernels/csrc/episode_block.cu",
             replaces="src/repro/kernels/episode_block.py:210",
             launches=main_counts["episode_block"],
             max_abs_err=episode_err, ms=ep_ms, plain_ms=ep_plain_ms,
             bound_ms=ep_bound, bound_by=ep_by, library_ms=None),
        dict(name="episode_block<AAPA>", policy="aapa", route="cuda",
             source="src/repro_torch/kernels/csrc/episode_block.cu",
             replaces="src/repro/kernels/episode_block.py:210",
             launches=aapa_counts["episode_block"], max_abs_err=aapa_err,
             ms=aapa_ms, prepass_ms=aapa_split["prepass_ms"],
             plant_ms=aapa_split["plant_ms"], plain_ms=aapa_plain_s * 1e3,
             plain_shape=f"{w_chunk}x{AAPA_PLAIN_MINUTES}",
             bound_ms=aapa_bound, bound_by=aapa_by, library_ms=None),
        dict(name="policy_signals", policy="aapa_band", route="cuda",
             source="src/repro_torch/kernels/csrc/policy_signals.cu",
             replaces="src/repro/kernels/episode_block.py:210",
             launches=aapa_counts["policy_signals"], max_abs_err=0.0,
             ms=pre_ms, plain_ms=pre_plain_ms, bound_ms=pre_bound,
             bound_by=pre_by, library_ms=None),
        dict(name="window_features", route="cuda",
             source="src/repro_torch/kernels/csrc/window_features.cu",
             replaces="src/repro/kernels/window_features.py:163",
             launches=classify_counts["window_features"],
             max_abs_err=wf_err, ms=wf_ms, variant=wf_variant,
             generic_ms=wf_generic_ms, plain_ms=wf_plain_ms,
             bound_ms=wf_bound, bound_by=wf_by, library_ms=rfft_ms),
        dict(name="gbdt_tables", route="cuda",
             source="src/repro_torch/kernels/csrc/gbdt_tables.cu",
             replaces="src/repro/kernels/gbdt_tables.py:53",
             launches=classify_counts["gbdt_tables"], max_abs_err=gb_err,
             ms=gb_ms, variant=gb_variant, generic_ms=gb_generic_ms,
             plain_ms=gb_plain_ms, bound_ms=gb_bound, bound_by=gb_by,
             library_ms=None),
        dict(name="holt_winters", route="cuda",
             source="src/repro_torch/kernels/csrc/holt_winters.cu",
             replaces="src/repro/kernels/holt_winters.py:55",
             launches=sum(conformal_counts.values()), max_abs_err=hw_err,
             ms=hw_ms, variant=hw_variant, global_ms=hw_global_ms,
             ms_4b=hw_4b_ms, plain_ms=hw_plain_ms, bound_ms=hw_bound,
             bound_by=hw_by, library_ms=None),
    ] + [
        dict(name=f"episode_block<{label}>", policy=pols[label][0],
             route="cuda",
             source="src/repro_torch/kernels/csrc/episode_block.cu",
             replaces="src/repro/kernels/episode_block.py:210",
             launches=row["launches"], max_abs_err=pol_err[label],
             ms=row["ms"], prepass_ms=row["prepass_ms"],
             plant_ms=row["plant_ms"], ms_240=row["ms_240"],
             plain_ms=pol_plain_s[label] * 1e3,
             plain_shape=f"{w_chunk}x240", bound_ms=row["bound_ms"],
             bound_by=row["bound_by"], library_ms=None)
        for label, row in pol_rows.items()] + [
        dict(name=f"policy_signals<{walk}>", policy=walk.split(":")[0],
             forecaster=walk.split(":")[1], route="cuda",
             source="src/repro_torch/kernels/csrc/policy_signals.cu",
             replaces="src/repro/kernels/episode_block.py:210",
             launches=fleet_walks[walk], max_abs_err=0.0, ms=row["ms"],
             plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
             bound_by=row["bound_by"], library_ms=None)
        for walk, row in walk_rows.items()]
    # launches on this slice's paths (phases 21-23)
    fleet_paths = {f"fleet {label}": run["launches"]
                   for label, run in fleet_runs.items() if "launches" in run}
    slice_paths = {
        "window_features": {"aapaset build": aapaset_counts},
        "gbdt_tables": {"training": train_counts},
        "episode_block": fleet_paths, "policy_signals": fleet_paths}
    for row in kernels:
        if row["name"] in slice_paths:
            row["paths"] = {path: counts[row["name"]] for path, counts in
                            slice_paths[row["name"]].items()}
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
