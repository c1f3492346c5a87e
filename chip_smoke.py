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
   W = 45 (the windows' first 45 samples), and with the wide kernel at
   W = 65, 72, 90, 120, 211, 360 and 1,024 (windows of the same traces
   at stride 140, ~20,000 a width; each timed beside its plain version,
   its bound and ``torch.fft.rfft``); a seeded GBDT at the paper's
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
   (remainder block) with stride 10 and 2, and the first 120 minutes of
   one 25,000-lane chunk of the AAPA fleet; all 12 MinuteOut fields at
   the episode tolerance and the archetype of every lane after every
   minute exactly. Then AAPA and hybrid at ``history_len`` 45, 90 and 120
   on ``archetype_mix`` 1024 x 150, each equal to its plain episode bit
   for bit, archetypes included (the reclassification on the generic
   window_features kernel at 45, the wide one above), and the
   reclassification of the 25,000 x 1440 chunk at each of those lengths
   timed against its bound, beside the AAPA episode of that chunk there.
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
    and per-minute archetype), and predictive conservative with the band;
    then the reclassification alone (``policy_signals.reclassify_cuda``:
    ``window_features`` on windows read in place from the rates,
    ``gbdt_tables``, the calibration kernel) against
    ``ref.reclassify_ref`` bit for bit, timed per 25,000 x 1440 launch
    against its bound.
16. For information: the plant pass over all 100,000 lanes in one launch
    against four 25,000-lane launches (HPA's episode, AAPA's plant pass),
    and each kernel entry's registers, stack and shared memory from
    ``cuobjdump --dump-resource-usage`` of the built extension; fails
    unless the three W = 60 ``window_features`` entries (28 and 38
    features, and the pre-pass's windows) and both shared-memory
    ``gbdt_tables`` entries (the paper's depth and any depth) hold no
    stack and no local memory, unless the twelve wide
    ``window_features`` entries (four lane and register shapes x 28 and 38
    features and the pre-pass's windows) hold no local memory and at most
    ``WIDE_SPILL_MAX`` bytes of stack (a few register spills), and unless
    the calibration kernel is there.
17. Every registry forecaster in the episode: predictive, predictive
    conservative with the band, AAPA (phase 8's classifier, the forecast
    confidence on) and hybrid with the band, each under linear trend,
    seasonal naive and EWMA, on ``archetype_mix`` 4,096 x 75 (one and a
    quarter of the seasonal forecaster's 60-minute periods, so its last
    15 minutes read the period before; AAPA reclassifying every 10 minutes;
    240 minutes until the training phases needed the time, 120 until
    phase 34 did), equal to their plain episodes bit for bit, archetypes
    included.
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
    AAPA (the trained classifier), one dispatch (over rates generated once
    before it and passed as its chunks, after a warm-up run) and
    streamed; gate: equal at the reference's rtol 2e-6 (quantiles at the
    histogram's half-bin bound). The same streamed at 200,000 x 1440 (8
    chunks; HPA alone at 10^5 and 10^6 lanes until phases 24-26 needed the
    time); gate: its peak device memory within 5% of the 10^5-lane
    stream's. A stream fed by
    ``AAPAsetLoader.rate_chunks`` of phase 21's artifact, 100,000 x 1440
    under HPA and AAPA. Each prints wall, lane-minutes/s, dispatches,
    peak device memory, host generation time and share, and the pooled
    metrics per policy.
24. Decision telemetry on the card (after 23): each of the five policies
    (AAPA and hybrid with phase 22's classifier) traced by
    ``simulate(..., decide_kernel=False, telemetry=True)`` on
    ``archetype_mix`` 1024 x 120 at ci 15 and 7 (240 minutes before PR
    26; cut for phase 35's time). Gates: its MinuteOut
    equals the untraced unfused run's bit for bit and the fused kernel's
    at the episode tolerance; its trace equals the same run's on the CPU:
    discrete fields exact,
    NaN where NaN, plant fields at the episode tolerance, forecast fields
    at rtol 1e-4 / atol 1e-3; ``plant_block`` launched (and
    ``gbdt_tables`` for AAPA and hybrid), ``episode_block`` not; the
    default ``decide_kernel`` refuses ``telemetry`` with ValueError. Then
    the fleet capture: phase 23's one-dispatch HPA + AAPA fleet with
    ``FleetSpec.trace_lanes=16``; gates: pooled metrics equal the
    untraced run's at rtol 2e-6, decisions [4, 1440, 4, 2, 16], every
    traced lane's blame counts sum to its violated requests, peak device
    memory at most 3 GB (15,471,030,272 bytes before the traced runners
    folded each minute as it ends); prints wall,
    lane-minutes/s, launches and peak device memory, and the card's busy
    share under ``torch.profiler`` over the capture's first hour. The
    traced path is host-bound, so each policy's runs, the fleet capture
    and phase 25's obs card run in worker processes side by side
    (CARD_WORKERS at a time); their walls are taken so.
25. An obs card (``obs.artifacts.capture_matrix``) of
    ``bench_autoscaling``'s SPEC, 4 lanes a cell traced, under a
    temporary root: wall of the traced run, the blame walk and the
    publish apart, and the blame totals. Gates: the card loads back equal
    (card, trace, blame); ``violations_total`` equals the blame counts'
    sum and the traced lanes' violations.
26. Tuning on the card at ``benchmarks/bench_tuning.py``'s FULL sizes:
    the 10^3-point HPA grid (8 x 240 ``archetype_pure``) in candidates/s
    and the card's busy share under ``torch.profiler``; grid_refine and
    population on ``archetype_pure`` and ``diurnal_ramp`` with each REI
    delta against the paper default. Gates: ``registry.make("tuned:hpa@
    <hash>")`` rebuilt from the card runs the episode of
    ``registry.make("hpa", **best)`` bit for bit; a second forced search
    gives the same winner and hash; ``episode_block`` launched once a
    candidate.
27. The model substrate at smoke size on the card, every arch of
    ``configs.ARCH_IDS``: forward, loss, prefill and decode shapes and
    finite values; decode token by token against the full forward for
    stablelm, mamba2 and zamba2 (rtol 0.05, atol 0.05; 0.1 for zamba2,
    the reference's bf16 tolerance).
28. The autoscaled serving endpoint at full width: ``stablelm_1_6b``
    (24 layers, d_model 2048, vocab 100352, bf16, weights from a seeded
    ``torch.Generator`` on the card) in a ``ServingEngine`` of 8 replicas
    x 4 lanes (max_len 64), the launcher's 10-minute bursty script
    (``launch.serve.bursty_rates``, 20 steps a minute) under AAPA with
    the classifier trained on ``aapaset_ci`` on the card
    (``GBDTConfig(n_rounds=10, depth=3)``), its features and logits
    through ``kernels.ops`` (the plain versions are forbidden on this
    path). Gates: ``window_features`` and ``gbdt_tables`` launched, as
    many times as ``torch.profiler`` counts their kernels; requests
    served; finite logits. Prints the summary, the run's wall, peak
    device memory, and the decode step's median time (CUDA events, every
    slot at the last position) beside its bound: weights read once (the
    embedding table at the slots' rows), the KV cache read, the logits
    written, over 3.35 TB/s.
29. The same script on the CPU at smoke size with the card's classifier
    carried across (``TrainedAAPA.save``/``load``): the scheduler never
    reads the logits, so the summary must equal the card's exactly and
    the decision log must match (discrete fields exact, forecast fields
    at rtol 1e-4 / atol 1e-3, the rest at rtol/atol 1e-5); the CPU run
    launches no kernel.
30. The LM trainer at full width: ``launch.train.main`` for 4 steps of
    ``internlm2_1_8b`` (24 layers, d_model 2048, vocab 92,544, bf16,
    weights from seed 0) at the launcher's batch (8 x 64 tokens, two
    microbatches, the default AdamW). Prints the losses (finite), the
    median ms a step over steps 2-4 (CUDA events between steps), the
    launches of one more step (profiler), peak device memory and the
    step's bound: params and optimizer state read and written once over
    3.35 TB/s, or its products (counted on the meta device) at the bf16
    and f32 peaks. The training path launches none of the five kernels
    (their counts are read and must stay 0).
31. Checkpoint and resume with deterministic algorithms: the params
    alone at full width, written and read back bit for bit (the full
    state's round trip at full width was cut for time: ~140 s of the
    script's limit on an H100 80GB HBM3 at 700 W); then at smoke size steps 1-2, an
    ``AsyncCheckpointer.save`` of params and optimizer state at steps 1
    and 2, steps 3-4; restored into new tensors, steps 3-4 again must
    equal the uninterrupted run bit for bit (params, master, m, v,
    losses), and one checkpoint is kept. Prints the write's and the
    restore's times.
32. The card against the CPU: ``internlm2_1_8b``, ``qwen3_moe_30b_a3b``
    and ``mamba2_2_7b`` at smoke size in f32, the same weights and
    batches, 3 train steps (two microbatches): losses at rtol 1e-4, then
    1e-3; params and m at rtol 1e-4 / atol 1e-5 of each leaf's largest
    entry (``tests/test_torch_train.py``'s tolerances).
33. The launch tools: ``launch.dryrun.run_cell`` for all 32 cells on the
    meta device and ``launch.roofline.probe_cell`` for each (a line per
    cell: argument bytes, activation estimate, FLOPs, bytes, fits one
    card, the roofline's terms); every cell the dry run says fits runs
    for real on the card (a decode step, or a train step on two of its
    microbatches) and must not run out of memory, its peak printed beside
    the estimate; ``launch.train --arch internlm2_1_8b --dry-run`` must
    exit 0. Each of phases 30-33 prints its wall.
34. The fleet plane over a device mesh (run after 23): phase 23's
    100,000 x 1440 HPA + AAPA fleet (the rates phase 23 generated for its
    one-dispatch run, passed to ``run_fleet`` as its chunks), one
    dispatch (after a warm-up run) and streamed, over ``launch.mesh.make_production_mesh()`` (every
    visible card: one when the script runs as it should, with no
    arguments) and over a logical mesh of MESH_SHARDS entries, every one
    the first card (chunk c on entry c mod n); gate: pooled metrics and
    REI bit for bit with phase 23's unsharded runs; walls against
    unsharded runs over the same host rates (phase 23's one dispatch and
    a stream over them, itself bit for bit with phase 23's generated
    stream). Each mesh's one-dispatch row once more under
    ``torch.profiler``: by card, the union of its kernel and copy spans
    (busy), of its kernels' and of its copies', and the idle share of
    the profiled wall; ``bench_autoscaling``'s SPEC matrix under each mesh
    against phase 19's (per workload bit for bit; pooled rtol 2e-6,
    counts exact); AAPAset ``aapaset_300k`` built under the logical mesh
    (chunks round-robin) bit for bit with phase 21's build. Prints the
    distinct cards, mesh shape, walls, lane-minutes/s, peak memory of the
    largest card and busy time by card; there is no fallback: a mismatch
    fails the run. Then SPEC's cells over their first
    TRACED_SPEC_MINUTES minutes traced (TRACE_LANES lanes a cell),
    unsharded and under the logical mesh: the traces and per-workload
    accumulators bit for bit.
35. Model sharding: a ``torch.distributed`` world of one process per
    visible card (NCCL; one card: a (1, 1) mesh, the expert-parallel
    path with one model column), ``deepseek_v2_lite_16b`` at full width
    cut to SHARD_LAYERS layers (the dense first layer and two MoE
    layers, so one card also holds the unsharded step): one sharded train
    step of the launcher's 8 x 64 batch against the unsharded step on
    the first card (loss within 0.05; new params within a bf16 rounding
    plus 2.5 x the step's learning rate). Prints each rank's step wall,
    peak memory and NCCL set-up time.

Phases 4, 5, 8, 10, 12, 14, 19, 21, 22, each run of 23, 24 and 34, 25, 26
and 28 reset the kernels' launch counts just before they run and read them just
after; a path whose kernel was never launched fails (the predictive,
AAPA and hybrid rows: the pre-pass and the plant pass; the matrices:
every policy's minute walk under every forecaster; the AAPAset build:
``window_features``; training: ``gbdt_tables``; every fleet run:
``episode_block``, and with AAPA ``policy_signals`` and, with a GBDT
classifier, its reclassification ``reclassify``; phase 9's other
history lengths: ``episode_block``, ``policy_signals`` and
``reclassify``; the traced runs and
the obs card: ``plant_block``, and with AAPA or hybrid ``gbdt_tables``;
tuning: ``episode_block``; serving: ``window_features`` and
``gbdt_tables``; each mesh's fleet runs: ``episode_block``,
``policy_signals`` and ``reclassify``, its matrix every minute walk, its
AAPAset build ``window_features``). Kernel-vs-plain
comparisons and timing launches are not counted. The plain runs of
phases 8, 9, 11, 13, 17, 18, 20 and 21 are checked to launch no kernel
(the plain AAPA and hybrid episodes classify through the plain GBDT).

Output: progress lines, then a JSON line of per-kernel numbers, then the
``nvidia-smi`` line, then the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import os
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
BF16_OPS_PER_S = 989e12        # bf16 on the tensor cores, dense

# f32 operations per lane and tick, counted from the CUDA sources:
# flow_tick 28 (5 of them divisions), pipeline pop 3, cooldown decay 2,
# total replicas 1 (plant_block); the episode kernel adds the minute fold
# (11) in place of the cooldown decay and, per control-period head,
# decide + limiter + scaling (52) plus the HPA window max (buf_len).
PLANT_OPS_PER_TICK = 34
EPISODE_OPS_PER_TICK = 42
EPISODE_OPS_PER_HEAD = 52

# minutes of the AAPA fleet chunk that phase 9 holds against the plain
# episode (480 before PR 26: the plain episode is host-bound, ~30 s)
AAPA_PLAIN_MINUTES = 120
# minutes of phase 17's episodes (the plain episodes are host-bound: their
# time grows with the minutes)
FORECASTER_MINUTES = 75
# phase 8's widths past the generic window_features kernel's 64 samples
# (the wide kernel; 211: ducc0 takes Bluestein's algorithm there), on
# windows of the AAPAset traces at this stride (~20,000 a width)
WIDE_WIDTHS = (65, 72, 90, 120, 211, 360, 1024)
WIDE_STRIDE = 140
WIDE_SPILL_MAX = 64  # bytes of register spills a wide kernel may keep
# phase 9's AAPA and hybrid episodes on other history lengths
# (SimConfig.history_len), on archetype_mix of these lanes x minutes
HISTORY_LENS = (45, 90, 120)
HISTORY_LANES, HISTORY_MINUTES = 1024, 150

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
# phase 23's fleets: 10^5 lanes (and a 2x stream) x a day, 4 chunks each
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


def radfg_ops(ip: int, l1: int, ido: int) -> int:
    """Operations of ducc0's generic pass for an odd factor ip > 5
    (features.cuh::radfg): the twiddles (16 a complex pair), the
    butterflies (2), per rotation l the two first terms (7 a column) and
    4 a column for each further j, the sum over j, and the reorder (4 a
    pair)."""
    ipph, idl1, pairs = (ip + 1) // 2, ido * l1, (ido - 1) // 2
    return ((ipph - 1) * l1 * (16 * pairs + 2)
            + (ipph - 1) * idl1 * (7 + 4 * (ipph - 3))
            + idl1 * (ipph - 1) + (ipph - 1) * l1 * pairs * 4)


def fft_ops(w: int) -> int:
    """Operations of the real FFT of one window (features.cuh::radix_pass
    over core.features.rfft_plan(w))."""
    from repro_torch.core import features
    total = 0
    for ip, l1, ido, _ in features.rfft_plan(w):
        if ip > 5:
            total += radfg_ops(ip, l1, ido)
            continue
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


def reclassification_ops(cls, confidence: bool, width: int = 60) -> int:
    """Operations of one reclassification of a `width`-minute window: the
    38 features, the trees, the calibration and (with `confidence`) the
    interval confidence."""
    t = cls.params.tables
    n_edges = cls.params.bin_edges.shape[1]
    return (stat_feature_ops(width) + freq_feature_ops(width)
            + gbdt_ops(38, n_edges, t.feat.shape[0], cls.params.depth)
            + AAPA_CAL_OPS + (AAPA_CONF_OPS if confidence else 0))


def reclassify_bound(cls, B: int, M: int, stride: int,
                     width: int) -> tuple[float, str]:
    """The bound of `policy_signals.reclassify_cuda` on rates [B, M]: the
    rates and the classifier's tables read once, each slot's archetype
    and confidence written once; per window its features, trees and
    calibration."""
    n = B * (M // stride)
    table_bytes = sum(t.numel() * 4 for t in (
        cls.params.bin_edges, *cls.params.tables, cls.params.base))
    return bound_ms(4.0 * B * M + table_bytes + 8.0 * n,
                    float(n) * reclassification_ops(cls, False, width))


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
    busy share of the wall time; returns (device ms, wall s)."""
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
    return device_ms, prof_s


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
    from repro_torch.core.pipeline import Classify
    from repro_torch.kernels import policy_signals
    counts = dict(ops.launch_counts(),
                  reclassify=policy_signals.reclassify_cuda.launches)
    peak = torch.cuda.max_memory_allocated()
    classifies = isinstance(controller.hyper.get("classify"), Classify)
    if counts["episode_block"] == 0 or (
            controller.name in policy_signals.POLICIES
            and counts["policy_signals"] == 0) or (
            classifies and counts["reclassify"] == 0):
        raise RuntimeError(f"{label} launched no episode_block kernel, no "
                           f"pre-pass or no reclassification: {counts}")
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
    return cls, dict(dataset_id=trained.dataset_id, train_s=train_s,
                     fit_s=trained.fit_seconds,
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
    t0 = time.perf_counter()
    rates = fleet.build_rates(sp)     # made once: phase 34 runs them too
    log(f"[fleet] {sp.n_workloads} x {sp.minutes} rates generated on the "
        f"host in {time.perf_counter() - t0:.1f} s")
    one = run("one-dispatch 1e5", sp, warmup=True, chunks=rates)
    runs["one-dispatch 1e5"].update(result=one, rates=rates)
    streamed = run("stream 1e5", sp, stream=True)
    runs["stream 1e5"]["result"] = streamed
    fleet_close(streamed.pooled, one.pooled, 2e-6, "stream vs one-dispatch")
    np.testing.assert_allclose(streamed.rei.rei, one.rei.rei, rtol=2e-6)
    log("[fleet] the stream equals the one-dispatch run (rtol 2e-6, "
        "quantiles at the half-bin bound)")
    big = run("stream 2e5", dataclasses.replace(
        sp, name="fleet_2e5", n_workloads=2 * FLEET_LANES), stream=True)
    p5 = streamed.meta["peak_device_bytes"]
    p6 = big.meta["peak_device_bytes"]
    if abs(p6 - p5) > 0.05 * p5:
        raise RuntimeError(f"the 2e5-lane stream's peak device memory {p6} "
                           f"is not within 5% of the 1e5-lane stream's {p5}")
    log(f"[fleet] 2e5-lane peak device memory {p6} bytes, "
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
    ctrl = fleet.controllers(sp)[0]
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


# ---- phase 34: the fleet plane over a device mesh
# the logical mesh: this many entries, every one the first card
MESH_SHARDS = 4
# what a matrix's pooled sums in another order keep exactly (phase 20's)
COUNTS_EXACT = ("scaling_actions", "oscillations",
                "mean_action_interval_min", "overprovision_rate")


def _union_ms(spans) -> float:
    """The length of the union of (start, end) spans in us, in ms."""
    total, reach = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > reach:
            total += hi - max(lo, reach)
            reach = hi
    return total / 1e3


def busy_by_card(run) -> dict[str, dict[str, float]]:
    """`run()` under torch.profiler, by card: `busy_ms`, the union of the
    spans in which a kernel or a copy ran (work on two streams at once
    counts once), `kernel_ms` and `copy_ms` the unions of the kernels'
    and of the copies' and memsets' spans, `wall_ms` the run's wall under
    the profiler (to a synchronize of every card) and `idle_share`, one
    less busy over wall."""
    from torch.profiler import ProfilerActivity, profile
    cards = range(torch.cuda.device_count())
    for d in cards:
        torch.cuda.synchronize(d)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        for d in cards:
            torch.cuda.synchronize(d)
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans: dict[int, dict[str, list]] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kind = "copy" if e.name.startswith(("Memcpy", "Memset")) \
                else "kernel"
            spans.setdefault(e.device_index, {"kernel": [], "copy": []})[
                kind].append((e.time_range.start, e.time_range.end))
    out = {}
    for k, by in sorted(spans.items()):
        busy = _union_ms(by["kernel"] + by["copy"])
        out[f"cuda:{k}"] = dict(busy_ms=busy,
                                kernel_ms=_union_ms(by["kernel"]),
                                copy_ms=_union_ms(by["copy"]),
                                wall_ms=wall_ms,
                                idle_share=1.0 - busy / wall_ms)
    return out


def same_tree(got, want, what: str) -> None:
    """Every field of two NamedTuples of arrays or tensors bit for bit."""
    for field, a, b in zip(got._fields, got, want):
        a, b = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
                for x in (a, b))
        if not same_bits(a, b):
            raise RuntimeError(f"{what}: {field} differs from the unsharded "
                               f"run's bits")


def mesh_phase(tcls, one, streamed, rates, spec_run, mcls, built) -> dict:
    """34. The fleet plane over a device mesh (``dist.sharding``): phase
    23's 100,000 x 1440 fleet row (HPA and AAPA with phase 22's
    classifier; its `rates`, passed as `chunks`), one dispatch and
    streamed, over
    ``launch.mesh.make_production_mesh()`` (every visible card) and over a
    logical mesh of MESH_SHARDS entries on the first card, each bit for
    bit with phase 23's unsharded run of the same mode (`one`,
    `streamed`) and timed against an unsharded run over the same host
    rates; each card's busy time under ``torch.profiler``
    (`busy_by_card`);
    ``bench_autoscaling``'s SPEC matrix under both meshes against phase
    19's unsharded run (`spec_run`: spec, pooled, per-workload, with
    `mcls`): per-workload bit for bit, pooled at rtol 2e-6, counts exact;
    the AAPAset build under the logical mesh, bit for bit with phase 21's
    (`built`). Returns each run's meta and launch counts."""
    from repro_torch.aapaset import build as aapaset_build
    from repro_torch.aapaset import registry as aapaset_registry
    from repro_torch.dist import sharding as shd
    from repro_torch.evals import fleet, matrix
    from repro_torch.kernels import ops, policy_signals
    from repro_torch.launch import mesh as launch_mesh
    sp = one.spec
    meshes = {"production": launch_mesh.make_production_mesh(),
              f"logical {MESH_SHARDS}": shd.Mesh(
                  [torch.device("cuda", 0)] * MESH_SHARDS)}
    runs: dict = {}
    # the unsharded stream over the same host rates: phase 23's stream
    # generates its chunks on the host, another workload for the wall
    base = {"one-dispatch": one, "stream": fleet.run_fleet(
        sp, classify=tcls, chunks=rates, stream=True)}
    same_tree(base["stream"].pooled, streamed.pooled,
              "unsharded stream over the rates, pooled")
    log(f"[mesh] unsharded stream over phase 23's rates: wall "
        f"{base['stream'].meta['wall_s']:.4f} s, pooled bit for bit with "
        f"phase 23's generated stream")
    try:
        for name, mesh in meshes.items():
            shd.set_mesh(mesh)
            for mode, want in base.items():
                label = f"{name} {mode}"
                for d in range(torch.cuda.device_count()):
                    torch.cuda.synchronize(d)
                ops.reset_launch_counts()
                res = fleet.run_fleet(sp, classify=tcls, chunks=rates,
                                      stream=mode == "stream",
                                      warmup=mode == "one-dispatch")
                counts = dict(ops.launch_counts(),
                              reclassify=policy_signals.reclassify_cuda
                              .launches)
                if min(counts["episode_block"], counts["policy_signals"],
                       counts["reclassify"]) == 0:
                    raise RuntimeError(f"mesh {label}: launches {counts}")
                same_tree(res.pooled, want.pooled, f"mesh {label} pooled")
                same_tree(res.rei, want.rei, f"mesh {label} REI")
                m = res.meta
                log(f"[mesh {label}] mesh {m['mesh']} on {m['n_devices']} "
                    f"distinct card(s): wall {m['wall_s']:.4f} s "
                    f"({m['lane_minutes_per_sec']:.6g} lane-minutes/s; "
                    f"unsharded over the same rates "
                    f"{want.meta['wall_s']:.4f} s, "
                    f"{want.meta['lane_minutes_per_sec']:.6g}), peak device "
                    f"memory {m['peak_device_bytes']} bytes (largest card), "
                    f"launches {counts};"
                    f" pooled metrics and REI equal the unsharded run's bit "
                    f"for bit")
                runs[label] = dict(meta=m, launches=counts)
            busy = busy_by_card(lambda: fleet.run_fleet(sp, classify=tcls,
                                                        chunks=rates))
            log(f"[mesh {name}] one-dispatch row under torch.profiler, by "
                f"card (busy: the union of kernel and copy spans): {busy}")
            runs[f"{name} busy_ms"] = busy
            spec_, pool1, per1 = spec_run
            pool, per_w, counts, _ = run_matrix(matrix, spec_, mcls,
                                                f"SPEC mesh {name}")
            same_tree(per_w, per1, f"matrix mesh {name} per workload")
            for field, a, e in zip(pool._fields, pool, pool1):
                if field in COUNTS_EXACT:
                    if not torch.equal(a, e):
                        raise RuntimeError(f"matrix mesh {name} {field}: "
                                           "counts differ")
                else:
                    torch.testing.assert_close(
                        a, e, rtol=2e-6, atol=0.0,
                        msg=lambda msg: f"matrix mesh {name} {field}: {msg}")
            log(f"[matrix SPEC mesh {name}] per workload bit for bit, "
                f"pooled at rtol 2e-6 (counts exact) of the unsharded run")
            runs[f"{name} matrix"] = dict(launches=counts)
        name = f"logical {MESH_SHARDS}"
        mesh = meshes[name]
        runs["traced SPEC"] = traced_spec_under_mesh(matrix, spec_run[0],
                                                     mcls, mesh)
        shd.set_mesh(mesh)
        cfg = aapaset_registry.get("aapaset_300k", feature_path="kernel")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        again = aapaset_build.build(cfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        if counts["window_features"] == 0:
            raise RuntimeError(f"mesh AAPAset: launches {counts}")
        for field in ("windows", "features", "labels", "confidence",
                      "votes", "split"):
            if not same_bits(getattr(again, field), getattr(built, field)):
                raise RuntimeError(f"mesh AAPAset: {field} differs from the "
                                   "unsharded build's bits")
        log(f"[mesh {name}] AAPAset {cfg.name} built in {build_s:.4f} s "
            f"({len(again) / build_s:.6g} windows/s), chunks round-robin "
            f"over {mesh.size} entries; launches {counts}; features, labels,"
            f" confidence and votes equal the unsharded build's bit for bit")
        runs["aapaset"] = dict(build_s=build_s, launches=counts)
    finally:
        shd.set_mesh(None)
    # phases 24-25's worker processes share the cards with this process:
    # hand its cached blocks back first
    reserved = [torch.cuda.memory_reserved(d)
                for d in range(torch.cuda.device_count())]
    torch.cuda.empty_cache()
    log(f"[mesh] device memory reserved by this process, by card: "
        f"{reserved} bytes before emptying the cache, "
        f"{[torch.cuda.memory_reserved(d) for d in range(len(reserved))]} "
        f"after")
    return runs


def traced_spec_under_mesh(matrix, spec_, cls, mesh) -> dict:
    """Phase 34's traced matrix: ``bench_autoscaling``'s SPEC cells over
    their first TRACED_SPEC_MINUTES minutes, TRACE_LANES lanes of each
    cell traced, unsharded and then under `mesh` (each entry traces the
    sampled lanes of its slice): the traces and per-workload accumulators
    bit for bit, the launch counts read after each run."""
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import ops
    rates = matrix.build_rates(spec_)[..., :TRACED_SPEC_MINUTES]
    out = {}
    for label, m in (("unsharded", None), ("mesh", mesh)):
        shd.set_mesh(m)
        runner = matrix.make_runner(spec_, cls, telemetry=True,
                                    trace_lanes=TRACE_LANES)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        pool, per_w, ct = runner(rates)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        if counts["plant_block"] == 0:
            raise RuntimeError(f"traced SPEC {label}: launches {counts}")
        out[label] = dict(wall_s=wall, launches=counts, run=(per_w, ct))
    shd.set_mesh(None)
    (per1, ct1), (per2, ct2) = out["unsharded"].pop("run"), \
        out["mesh"].pop("run")
    same_tree(per2, per1, "traced SPEC per workload")
    same_tree(ct2.decisions, ct1.decisions, "traced SPEC decisions")
    same_tree(ct2.minutes, ct1.minutes, "traced SPEC minutes")
    log(f"[mesh traced SPEC] {spec_.shape} cells x {spec_.n_workloads} "
        f"workloads x {TRACED_SPEC_MINUTES} min, {TRACE_LANES} lanes a "
        f"cell traced: unsharded {out['unsharded']['wall_s']:.2f} s, over "
        f"{mesh.size} logical entries {out['mesh']['wall_s']:.2f} s "
        f"(launches {out['mesh']['launches']}); the trace "
        f"{tuple(ct2.decisions.minute.shape)} and the per-workload "
        f"accumulators equal the unsharded run's bit for bit")
    return out


# ---- phases 24-26: decision telemetry, obs cards and tuning on the card
POLICIES5 = ("hpa", "kpa", "predictive", "aapa", "hybrid")
ARCH_POLICIES = ("aapa", "hybrid")
# the trace against the CPU's (tests/test_torch_obs.py): discrete fields
# exact, plant fields at the episode tolerance, forecast fields at the
# forecast tolerance (the port's and XLA's contraction differ there)
TRACE_DISCRETE = ("minute", "sec", "scale_up", "scale_down",
                  "cooldown_blocked", "capacity_capped", "archetype")
TRACE_FORECAST = ("fc_point", "fc_lo", "fc_hi", "confidence", "guard_floor")
FORECAST_TOL = dict(rtol=1e-4, atol=1e-3)
TRACE_LANES = 16
# phase 34 traces SPEC's cells over their first minutes only (the traced
# path is host-bound eager control periods: 3.9 s unsharded and 17.1 s
# over a logical mesh of 4 at 60 minutes)
TRACED_SPEC_MINUTES = 30
# the fleet capture's peak device memory: its gate, and the 10^5 x 1440
# HPA + AAPA capture's peak when the traced runner kept the whole
# episode's MinuteOut (H100 80GB HBM3 at 700 W)
TRACED_PEAK_LIMIT = 3_000_000_000
TRACED_PEAK_BEFORE = 15_471_030_272
# phase 24's traced episodes: archetype_mix lanes x minutes; phases 24-25
# run their 12 jobs in this many worker processes, each job bounded by
# JOB_TIMEOUT_S (a lost worker must not hang the script)
TELEMETRY_LANES, TELEMETRY_MINUTES = 1024, 120
CARD_WORKERS = 7
JOB_TIMEOUT_S = 600
# benchmarks/bench_tuning.py's FULL sizes
TUNING_FULL = dict(n_workloads=8, minutes=240, grid_points=10,
                   refine=dict(points=5, rounds=4),
                   population=dict(population=32, generations=6))


def classify_on(cls, dev):
    """`cls` (a ``core.pipeline.Classify``) with its ensemble and
    calibration copied to `dev`."""
    from repro_torch.core import calibration, gbdt, pipeline
    p, c = cls.params, cls.cal
    return pipeline.Classify(
        gbdt.GBDTParams(*(t.to(dev) for t in (p.feat, p.thresh, p.leaf,
                                              p.bin_edges, p.base))),
        calibration.BetaCalibration(*(t.to(dev) for t in (c.a_raw, c.b_raw,
                                                          c.c))))


def phase_job(job: dict):
    """One job of phases 24-25 in its own worker process (the traced path
    is host-bound, so independent runs go to processes side by side): a
    policy's traced rows, the fleet capture or the obs card. `job` holds
    the classifier on the CPU; returns what the phase function returns."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    from repro_torch.kernels import _build
    _build.extension()
    cls = classify_on(job["classify"], torch.device("cuda"))
    if job["kind"] == "row":
        return traced_row(job["policy"], job["ci"], cls, job["classify"])
    if job["kind"] == "fleet":
        return fleet_capture(cls, job["one_dispatch"])
    return obs_phase(cls, job["classifier_id"])


def trace_close(got, want, what: str) -> float:
    """A trace against another (each a ControlTrace of tensors or arrays):
    NaN where NaN, discrete record fields exact, forecast fields at
    FORECAST_TOL, the rest at the episode tolerance; returns the largest
    difference of the plant fields."""
    from repro_torch.obs import trace
    got, want = trace.to_numpy(got), trace.to_numpy(want)
    worst = 0.0
    for field in trace.DecisionRecord._fields:
        a, e = getattr(got.decisions, field), getattr(want.decisions, field)
        if a.shape != e.shape or not np.array_equal(np.isnan(a),
                                                    np.isnan(e)):
            raise RuntimeError(f"{what}: {field} shape or NaN differ")
        if field in TRACE_DISCRETE:
            if not np.array_equal(a, e, equal_nan=True):
                raise RuntimeError(f"{what}: {field} differs at "
                                   f"{int((a != e).sum())} decisions")
            continue
        tol = FORECAST_TOL if field in TRACE_FORECAST else EPISODE_TOL
        np.testing.assert_allclose(a, e, equal_nan=True,
                                   err_msg=f"{what}: {field}", **tol)
        if field not in TRACE_FORECAST and np.isfinite(a).any():
            worst = max(worst, float(np.nanmax(np.abs(a - e))))
    for field, a, e in zip(trace.MinuteTrace._fields, got.minutes,
                           want.minutes):
        np.testing.assert_allclose(a, e, err_msg=f"{what}: {field}",
                                   **EPISODE_TOL)
    return worst


def blame_lanes(ct, cfg, lanes, what: str) -> dict:
    """Blame every traced lane (``(pre, post)`` index pairs of `ct`); each
    lane's blame counts must sum to its violated requests. Returns the
    per-cause totals."""
    from repro_torch.obs import attribute, trace
    totals = {c: 0.0 for c in attribute.CAUSES}
    for pre, post in lanes:
        ln = trace.lane(ct, pre, post)
        b = attribute.attribute(ln, cfg)
        violated = float(np.asarray(ln.minutes.violated, np.float64).sum())
        if not np.isclose(sum(b.counts.values()), violated, rtol=1e-9,
                          atol=1e-6):
            raise RuntimeError(f"{what} lane {pre}{post}: blame counts sum "
                               f"to {sum(b.counts.values())}, violated "
                               f"{violated}")
        for c in totals:
            totals[c] += b.counts[c]
    return totals


def telemetry_phases(tcls, one_dispatch, classifier_id: str) -> dict:
    """24-25. Decision telemetry and an obs card on the card, each run in
    its own worker process side by side (CARD_WORKERS at a time): the
    five policies traced at ci 15 and 7 against their untraced, fused and
    CPU runs; the 10^5-lane fleet capture against phase 23's untraced
    one-dispatch run; the obs card."""
    import multiprocessing
    cpu_cls = classify_on(tcls, torch.device("cpu"))
    jobs = {"fleet": dict(kind="fleet", one_dispatch=one_dispatch),
            "obs card": dict(kind="obs", classifier_id=classifier_id)}
    jobs.update({f"{policy} ci={ci}": dict(kind="row", policy=policy, ci=ci)
                 for ci in (15, 7) for policy in POLICIES5})
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(CARD_WORKERS) as pool:
        pending = {label: pool.apply_async(phase_job, (dict(
            job, classify=cpu_cls),)) for label, job in jobs.items()}
        done = {label: run.get(timeout=JOB_TIMEOUT_S)
                for label, run in pending.items()}
    log(f"[telemetry] phases 24-25 in {CARD_WORKERS} worker processes: "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(rows={label: done[label] for label in jobs
                      if jobs[label]["kind"] == "row"},
                fleet=done["fleet"], obs=done["obs card"])


def traced_row(policy: str, ci: int, tcls, cpu_cls) -> dict:
    """One policy of phase 24 at control interval `ci` (AAPA and hybrid
    with `tcls`): traced on the card over ``archetype_mix``, held against
    its untraced and fused runs there and against the same traced run on
    the CPU (with `cpu_cls`)."""
    from repro_torch.kernels import ops
    from repro_torch.obs import trace
    from repro_torch.scaling import registry, scenarios
    from repro_torch.sim import cluster
    host = scenarios.archetype_mix(n_workloads=TELEMETRY_LANES,
                                   minutes=TELEMETRY_MINUTES).rates
    mix = torch.as_tensor(host, device="cuda")
    cfg = cluster.SimConfig(control_interval_sec=ci)
    H = len(trace.head_schedule(cfg))
    arch = policy in ARCH_POLICIES
    ctrl = registry.make(policy, cfg, **(dict(classify=tcls) if arch else {}))
    label = f"{policy} ci={ci}"
    if policy == "hpa":
        try:
            cluster.simulate(mix, ctrl, cfg, telemetry=True)
        except ValueError:
            pass
        else:
            raise RuntimeError("telemetry with the default decide_kernel "
                               "did not raise")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out, ct = cluster.simulate(mix, ctrl, cfg, decide_kernel=False,
                               telemetry=True)
    torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    if (counts["plant_block"] == 0 or counts["episode_block"]
            or (arch and counts["gbdt_tables"] == 0)):
        raise RuntimeError(f"traced {label}: launches {counts}")
    if tuple(ct.decisions.desired.shape) != (TELEMETRY_LANES,
                                             TELEMETRY_MINUTES, H):
        raise RuntimeError(f"traced {label}: decisions "
                           f"{tuple(ct.decisions.desired.shape)}")
    t0 = time.perf_counter()
    base = cluster.simulate(mix, ctrl, cfg, decide_kernel=False)
    torch.cuda.synchronize()
    untraced_s = time.perf_counter() - t0
    for field, a, b in zip(out._fields, out, base):
        if not torch.equal(a, b):
            raise RuntimeError(f"traced {label}: MinuteOut.{field} differs "
                               "from the untraced run")
    fused_err = max_abs_err(out, cluster.simulate(mix, ctrl, cfg),
                            EPISODE_TOL, f"traced {label} vs fused")
    cctrl = registry.make(policy, cfg,
                          **(dict(classify=cpu_cls) if arch else {}))
    t0 = time.perf_counter()
    cout, cct = cluster.simulate(torch.as_tensor(host), cctrl, cfg,
                                 device="cpu", decide_kernel=False,
                                 telemetry=True)
    cpu_s = time.perf_counter() - t0
    cpu_err = max(max_abs_err(tuple(a.cpu() for a in out), cout,
                              EPISODE_TOL, f"traced {label} card vs CPU"),
                  trace_close(ct, cct, f"trace {label} card vs CPU"))
    log(f"[telemetry {label}] archetype_mix {TELEMETRY_LANES}x"
        f"{TELEMETRY_MINUTES}: traced {traced_s:.3f} s, untraced "
        f"{untraced_s:.3f} s (same MinuteOut bit for bit), the CPU's traced "
        f"run {cpu_s:.3f} s; vs the fused kernel max_abs_err={fused_err}, "
        f"trace vs the CPU's max_abs_err={cpu_err} (discrete fields exact);"
        f" launches {counts}")
    return dict(traced_s=traced_s, untraced_s=untraced_s, cpu_s=cpu_s,
                fused_err=fused_err, cpu_err=cpu_err, launches=counts)


def fleet_capture(tcls, one_dispatch) -> dict:
    """Phase 24's fleet capture: phase 23's one-dispatch fleet with
    TRACE_LANES lanes a chunk traced, against that untraced run."""
    import dataclasses

    from repro_torch.evals import fleet
    from repro_torch.kernels import ops
    from repro_torch.obs import trace
    sp = dataclasses.replace(one_dispatch.spec, name="fleet_trace_1e5",
                             trace_lanes=TRACE_LANES)
    cfg = sp.sim_config()
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    res = fleet.run_fleet(sp, classify=tcls)
    counts = ops.launch_counts()
    if (counts["plant_block"] == 0 or counts["gbdt_tables"] == 0
            or counts["episode_block"]):
        raise RuntimeError(f"fleet capture: launches {counts}")
    fleet_close(res.pooled, one_dispatch.pooled, 2e-6,
                "fleet capture vs the untraced one-dispatch run")
    np.testing.assert_allclose(res.rei.rei, one_dispatch.rei.rei, rtol=2e-6)
    H = len(trace.head_schedule(cfg))
    shape = (sp.n_chunks, sp.minutes, H, len(sp.policies), TRACE_LANES)
    if res.trace.decisions.desired.shape != shape:
        raise RuntimeError(f"fleet capture: decisions "
                           f"{res.trace.decisions.desired.shape}, expected "
                           f"{shape}")
    blame = {p: blame_lanes(res.trace, cfg, [
        ((c,), (i, k)) for c in range(sp.n_chunks)
        for k in range(TRACE_LANES)], f"fleet capture {p}")
        for i, p in enumerate(sp.policies)}
    m = res.meta
    if m["peak_device_bytes"] > TRACED_PEAK_LIMIT:
        raise RuntimeError(f"fleet capture: peak device memory "
                           f"{m['peak_device_bytes']} bytes, over "
                           f"{TRACED_PEAK_LIMIT}")
    log(f"[telemetry fleet] peak device memory {m['peak_device_bytes']} "
        f"bytes (the whole-episode MinuteOut of the traced runner before "
        f"it folded each minute: {TRACED_PEAK_BEFORE} bytes)")
    log(f"[telemetry fleet] {'+'.join(sp.policies)}, {m['workloads']} x "
        f"{m['minutes']} in chunks of {m['w_chunk']}, {TRACE_LANES} lanes "
        f"a chunk traced: wall {m['wall_s']:.4f} s "
        f"({m['lane_minutes_per_sec']:.6g} lane-minutes/s; untraced "
        f"one-dispatch {one_dispatch.meta['wall_s']:.4f} s), peak device "
        f"memory {m['peak_device_bytes']} bytes ({live} live before), "
        f"launches {counts}; pooled metrics equal the untraced run "
        f"(rtol 2e-6); decisions {shape}; every traced lane's blame sums "
        f"to its violations")
    for p, totals in blame.items():
        log(f"[telemetry fleet] {p} blame over the traced lanes: {totals}")
    # the path's host share: the first hour of the same capture under the
    # profiler (a day's millions of eager launches would swamp it)
    hour = dataclasses.replace(sp, minutes=60)
    busy_ms, prof_s = profile_row(
        lambda: fleet.run_fleet(hour, classify=tcls),
        f"fleet capture, {hour.n_workloads} x {hour.minutes}")
    return dict(meta=m, launches=counts, blame=blame,
                hour_busy_share=busy_ms / (prof_s * 1e3))


def obs_phase(tcls, classifier_id: str) -> dict:
    """25. An obs card of ``bench_autoscaling``'s SPEC (Fig 2), four lanes
    a cell traced, under a temporary root: published, loaded back equal,
    its blame totals summing to the traced violations."""
    import tempfile

    from repro_torch.evals import matrix
    from repro_torch.kernels import ops
    from repro_torch.obs import artifacts
    sp = bench_spec(matrix)
    with tempfile.TemporaryDirectory() as root:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        cap = artifacts.capture_matrix(sp, tcls, classifier_id=classifier_id,
                                       trace_lanes=4, root=root)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        if counts["plant_block"] == 0 or counts["gbdt_tables"] == 0:
            raise RuntimeError(f"obs card: launches {counts}")
        back = artifacts.load_capture(sp.name, cap.card["key"], root)
    if not back.cached or back.card != json.loads(json.dumps(
            cap.card, default=float)):
        raise RuntimeError("obs card: the published card does not load "
                           "back equal")
    for a, b in zip((*cap.trace.decisions, *cap.trace.minutes),
                    (*back.trace.decisions, *back.trace.minutes)):
        if not np.array_equal(a, b, equal_nan=True):
            raise RuntimeError("obs card: the trace does not load back "
                               "equal")
    if list(back.blames) != list(cap.blames) or any(
            back.blames[k].counts != cap.blames[k].counts
            for k in cap.blames):
        raise RuntimeError("obs card: the blame walked again differs")
    totals = cap.card["blame_totals"]
    violated = float(np.asarray(cap.trace.minutes.violated,
                                np.float64).sum())
    if not (np.isclose(cap.card["violations_total"], sum(totals.values()),
                       rtol=1e-12)
            and np.isclose(cap.card["violations_total"], violated,
                           rtol=1e-9)):
        raise RuntimeError(f"obs card: violations_total "
                           f"{cap.card['violations_total']}, blame "
                           f"{sum(totals.values())}, traced {violated}")
    m = cap.meta
    log(f"[obs card] {sp.name} ({len(cap.blames)} traced lanes, "
        f"{cap.card['hash']}): wall {wall:.4f} s = traced run "
        f"{m['run_s']:.4f} s + blame walk {m['blame_s']:.4f} s + publish "
        f"{m['publish_s']:.4f} s; launches {counts}; loads back equal; "
        f"violations_total {cap.card['violations_total']} = the blame "
        f"counts' sum; blame totals {totals}")
    return dict(wall_s=wall, **m, launches=counts, blame_totals=totals,
                violations_total=cap.card["violations_total"])


def tuning_phase() -> dict:
    """26. Tuning on the card at ``benchmarks/bench_tuning.py``'s FULL
    sizes: the 10^3-point HPA grid's throughput, grid_refine and
    population on two scenarios, and the ``tuned:`` winner rebuilt."""
    import tempfile

    import repro_torch.tuning as tuning
    from repro_torch.kernels import ops
    from repro_torch.scaling import registry
    from repro_torch.sim import cluster
    from repro_torch.tuning import artifacts as tuning_artifacts
    knobs = TUNING_FULL
    sp = tuning.spec(
        "bench_throughput", policy="hpa", strategy="grid",
        points=knobs["grid_points"], scenario="archetype_pure",
        n_workloads=knobs["n_workloads"], minutes=knobs["minutes"])
    cands = tuning.grid_candidates(sp.space, sp.points)
    rates = tuning.build_rates(sp)
    evaluate = tuning.make_evaluator(sp)
    evaluate(cands[:16], rates)                       # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, rei = evaluate(cands, rates)
    grid_s = time.perf_counter() - t0
    grid_counts = ops.launch_counts()
    if grid_counts["episode_block"] != len(cands) or not np.isfinite(
            rei).all():
        raise RuntimeError(f"tuning grid: launches {grid_counts}")
    busy_ms, prof_s = profile_row(lambda: (evaluate(cands[:100], rates),
                                           torch.cuda.synchronize()),
                                  "tuning, 100 HPA candidates")
    log(f"[tuning] {len(cands)}-point HPA grid, {sp.n_workloads} x "
        f"{sp.minutes} archetype_pure: {grid_s:.4f} s "
        f"({len(cands) / grid_s:.6g} candidates/s, "
        f"{len(cands) * sp.n_workloads * sp.minutes / grid_s:.6g} "
        f"lane-minutes/s), launches {grid_counts}; the card busy "
        f"{busy_ms / (prof_s * 1e3):.4f} of the wall under the profiler")
    out = dict(grid=dict(candidates=len(cands), wall_s=grid_s,
                         candidates_per_sec=len(cands) / grid_s,
                         busy_share=busy_ms / (prof_s * 1e3),
                         launches=grid_counts), searches={})
    with tempfile.TemporaryDirectory() as root:
        ops.reset_launch_counts()
        for strategy in ("grid_refine", "population"):
            for scenario in ("archetype_pure", "diurnal_ramp"):
                ssp = tuning.spec(
                    f"bench_{strategy}_{scenario}", policy="hpa",
                    strategy=strategy, scenario=scenario,
                    n_workloads=knobs["n_workloads"],
                    minutes=knobs["minutes"],
                    **knobs["refine" if strategy == "grid_refine"
                            else "population"])
                run = tuning.search(ssp, root=root, force=True)
                r = run.result
                out["searches"][f"{strategy}/{scenario}"] = dict(
                    ref=f"tuned:hpa@{run.card['hash']}", best=r.best,
                    best_rei=r.best_rei, default_rei=r.default_rei,
                    rei_delta=r.best_rei - r.default_rei,
                    candidates=r.meta["n_candidates"],
                    candidates_per_sec=r.meta["candidates_per_sec"],
                    wall_s=r.meta["wall_s"], compiles=r.meta["compiles"])
                log(f"[tuning] {strategy} on {scenario}: best {r.best} REI "
                    f"{r.best_rei} against the paper default's "
                    f"{r.default_rei} (delta "
                    f"{r.best_rei - r.default_rei:+.6f})"
                    f", {r.meta['n_candidates']} candidates in "
                    f"{r.meta['wall_s']:.4f} s "
                    f"({r.meta['candidates_per_sec']:.6g}/s), static "
                    f"groups {r.meta['compiles']}, card {run.card['hash']}")
        search_counts = ops.launch_counts()
        if search_counts["episode_block"] == 0:
            raise RuntimeError(f"tuning searches: launches {search_counts}")
        # the winner, rebuilt by name from its card
        first = tuning.spec("bench_grid_refine_archetype_pure", policy="hpa",
                            strategy="grid_refine", scenario="archetype_pure",
                            n_workloads=knobs["n_workloads"],
                            minutes=knobs["minutes"], **knobs["refine"])
        info = out["searches"]["grid_refine/archetype_pure"]
        saved = tuning_artifacts.DEFAULT_ROOT
        tuning_artifacts.DEFAULT_ROOT = Path(root)
        try:
            cfg = first.sim_config()
            tuned = registry.make(info["ref"], cfg)
        finally:
            tuning_artifacts.DEFAULT_ROOT = saved
        direct = registry.make("hpa", cfg, **info["best"])
        r_first = torch.as_tensor(tuning.build_rates(first), device="cuda")
        for field, a, b in zip(cluster.MinuteOut._fields,
                               cluster.simulate(r_first, tuned, cfg),
                               cluster.simulate(r_first, direct, cfg)):
            if not torch.equal(a, b):
                raise RuntimeError(f"tuned: episode {field} differs from "
                                   "registry.make('hpa', **best)")
        again = tuning.search(first, root=root, force=True)
        if (again.result.best != info["best"]
                or f"tuned:hpa@{again.card['hash']}" != info["ref"]):
            raise RuntimeError("tuning: a second forced search gave another"
                               " winner or hash")
    log(f"[tuning] {info['ref']} rebuilds registry.make('hpa', "
        f"**{info['best']}) bit for bit; a second forced search gives the "
        f"same winner and hash; search launches {search_counts}")
    out["search_launches"] = search_counts
    return out


# ---- phases 27-29: the model substrate and the autoscaled serving endpoint
SERVE_MINUTES = 10
SERVE_ARCH = "stablelm_1_6b"
DECODE_ITERS = 20
SERVE_KERNELS = {"window_features": ("window_features_kernel",),
                 "gbdt_tables": ("gbdt_tables_kernel", "gbdt_shared_kernel")}
MODEL_TOL = dict(rtol=0.05, atol=0.05)      # the reference's bf16 tolerance


def model_phase(dev) -> dict:
    """27. Every arch at smoke size on the card: the reference's smoke
    claims (forward, loss, prefill and decode shapes, finite values) and
    its prefill/decode consistency for the archs it names."""
    from repro_torch.configs import ARCH_IDS, get_config, smoke_config
    from repro_torch.models import model as M
    B, S = 2, 32
    t0 = time.perf_counter()
    for arch in ARCH_IDS:
        cfg = smoke_config(get_config(arch))
        params = M.init(torch.Generator(device=dev).manual_seed(0), cfg)
        n_text = S - (cfg.n_img_tokens or 0)
        ones = torch.ones((B, n_text), dtype=torch.long, device=dev)
        batch = {"tokens": ones}
        if cfg.n_img_tokens:
            batch["img_embeds"] = torch.zeros(
                (B, cfg.n_img_tokens, cfg.d_model), dtype=cfg.jdtype,
                device=dev)
        if cfg.family == "encdec":
            batch["enc_embeds"] = torch.zeros(
                (B, cfg.enc_len, cfg.d_model), dtype=cfg.jdtype, device=dev)
        loss, _ = M.loss_fn(params, dict(batch, labels=ones), cfg)
        logits, _ = M.forward(params, batch, cfg)
        lg, cache = M.prefill(params, batch, cfg, 64)
        lg2, _ = M.decode_step(params, cache, ones[:, :1],
                               n_text + (cfg.n_img_tokens or 0), cfg)
        if (not torch.isfinite(loss) or logits.shape != (B, n_text, cfg.vocab)
                or lg.shape != (B, 1, cfg.vocab)
                or lg2.shape != (B, 1, cfg.vocab)
                or not torch.isfinite(logits.float()).all()
                or not torch.isfinite(lg2.float()).all()):
            raise RuntimeError(f"{arch} smoke on the card: loss {loss}, "
                               f"shapes {tuple(logits.shape)} "
                               f"{tuple(lg.shape)} {tuple(lg2.shape)}")
    worst = {}
    for arch in ("stablelm_1_6b", "mamba2_2_7b", "zamba2_2_7b"):
        cfg = smoke_config(get_config(arch))
        params = M.init(torch.Generator(device=dev).manual_seed(1), cfg)
        toks = torch.as_tensor(np.random.default_rng(2).integers(
            0, cfg.vocab, (B, 8)), device=dev)
        tol = dict(MODEL_TOL, atol=0.1) if arch == "zamba2_2_7b" \
            else MODEL_TOL
        full, _ = M.forward(params, {"tokens": toks}, cfg, remat=False)
        lg, cache = M.prefill(params, {"tokens": toks[:, :4]}, cfg, 16)
        got, want = [lg[:, 0]], [full[:, 3]]
        for t in range(4, 8):
            lg, cache = M.decode_step(params, cache, toks[:, t:t + 1], t,
                                      cfg)
            got.append(lg[:, 0])
            want.append(full[:, t])
        worst[arch] = max_abs_err([g.float() for g in got],
                                  [w.float() for w in want], tol,
                                  f"{arch} prefill/decode consistency")
    wall = time.perf_counter() - t0
    log(f"[models] {len(ARCH_IDS)} archs at smoke size on the card: "
        f"forward, loss, prefill and decode shapes and finite values; "
        f"decode token by token equals the full forward "
        f"(rtol 0.05, atol 0.05 / 0.1 hybrid), max_abs_err {worst}; "
        f"{wall:.1f} s")
    return dict(wall_s=wall, consistency_err=worst)


def decode_bound(cfg, params, slots: int, max_len: int) -> tuple:
    """(bytes, operations, bound ms, bound_by) of one decode step of
    `slots` tokens: every weight read once (the embedding table only at
    the slots' rows), the whole KV cache read and one position written,
    the logits written; two operations a weight per token."""
    n_params = sum(t.numel() for t in _leaves(params))
    itemsize = cfg.jdtype.itemsize
    table = cfg.vocab * cfg.d_model
    weights = (n_params - table + slots * cfg.d_model) * itemsize
    kv = 2 * cfg.n_layers * slots * max_len * cfg.kv_heads * cfg.hdim \
        * cfg.cache_jdtype.itemsize
    kv_write = kv // max_len
    logits = slots * cfg.vocab * itemsize
    n_bytes = weights + kv + kv_write + logits
    ops_ = 2 * (n_params - table) * slots \
        + 4 * cfg.n_layers * slots * max_len * cfg.n_heads * cfg.hdim
    ms, by = bound_ms(n_bytes, ops_ * F32_OPS_PER_S / BF16_OPS_PER_S)
    return n_bytes, ops_, ms, by


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def serving_phase(dev) -> dict:
    """28-29. The launcher's 10-minute bursty script at the full width of
    `SERVE_ARCH` on the card under AAPA (the classifier trained on
    ``aapaset_ci`` there), its kernels counted and profiled, its decode
    step timed against its bound; then the same script on the CPU at
    smoke size with the same classifier carried across: the same
    summary, the decision log within tolerance."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core import gbdt, pipeline
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve as launcher
    from repro_torch.models import model as M
    from repro_torch.obs import trace as obs_trace

    t_phase = t0 = time.perf_counter()
    trained = pipeline.train_classifier(
        "aapaset_ci", gbdt.GBDTConfig(n_rounds=10, depth=3), device=dev)
    train_s = time.perf_counter() - t0
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = M.init(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    rates = launcher.bursty_rates(SERVE_MINUTES)
    lines = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with forbidden(ref, "gbdt_logits_ref"), \
            forbidden(ref, "extract_features_ref"), \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng, auto = launcher.serve(SERVE_MINUTES, "aapa", trained, params,
                                   cfg, rates, np.random.default_rng(0),
                                   device=dev, log=lines.append)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    device_events = [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    profiled = {name: sum(e.count for e in device_events
                          if any(k in e.key for k in kernel_names))
                for name, kernel_names in SERVE_KERNELS.items()}
    for name in SERVE_KERNELS:
        if counts[name] == 0 or profiled[name] != counts[name]:
            raise RuntimeError(
                f"serving: {name} launches {counts[name]}, profiled "
                f"{profiled[name]} (device events: "
                f"{sorted(e.key[:60] for e in device_events)[:40]})")
    summary = eng.summary()
    card_trace = auto.decision_trace()
    logits = eng.last_logits
    if (summary["served"] == 0 or logits.shape != (eng.max_replicas
                                                   * eng.lanes, 1, cfg.vocab)
            or not torch.isfinite(logits.float()).all()):
        raise RuntimeError(f"serving: summary {summary}, logits "
                           f"{tuple(logits.shape)}")
    for line in lines:
        log(f"[serve] {line}")
    log(f"[serve] {cfg.name} at full width ({n_params} parameters, "
        f"{weight_bytes} bytes of {cfg.dtype} weights, initialized on the "
        f"card in {init_s:.2f} s), {eng.max_replicas} replicas x "
        f"{eng.lanes} lanes, max_len {eng.max_len}, AAPA with the "
        f"classifier trained on {trained.dataset_id} (test acc "
        f"{trained.test_acc:.4f}, {train_s:.1f} s): {SERVE_MINUTES} minutes "
        f"x {launcher.STEPS_PER_MIN} steps in {serve_s:.3f} s, "
        f"{eng.decode_steps} decode steps, {len(auto.decisions)} control "
        f"steps, peak device memory {peak} bytes; launches {counts} "
        f"(the profiler counts {profiled})")
    log(f"[serve] summary {summary}")

    # the decode step at the run's shape: every slot, the last position
    slots = eng.max_replicas * eng.lanes
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        1, 8, (slots, 1)), device=dev)
    step = lambda: M.decode_step(params, eng.cache, toks,  # noqa: E731
                                 eng.max_len - 1, cfg)
    step()
    times = []
    for _ in range(DECODE_ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    decode_ms = float(np.median(times))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DECODE_ITERS):
        step()
    torch.cuda.synchronize()
    decode_wall_ms = (time.perf_counter() - t0) * 1e3 / DECODE_ITERS
    d_bytes, d_ops, d_bound, d_by = decode_bound(cfg, params, slots,
                                                 eng.max_len)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    step_kernels = sum(e.count for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
    log(f"[decode] {cfg.name} full width, {slots} slots x max_len "
        f"{eng.max_len}: median {decode_ms:.4f} ms a step on the card "
        f"(CUDA events, {DECODE_ITERS} steps; {decode_wall_ms:.4f} ms of "
        f"wall a step back to back), {step_kernels} kernel launches a "
        f"step; bound {d_bound:.4f} ms by {d_by} ({d_bytes} bytes: weights "
        f"read once, the KV cache read, the logits written; {d_ops} "
        f"operations at the bf16 peak)")

    # 29. the same script on the CPU at smoke size, the same classifier
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "classifier.npz"
        trained.save(path)
        cpu_trained = pipeline.TrainedAAPA.load(path, device="cpu")
    scfg = smoke_config(cfg)
    t0 = time.perf_counter()
    ceng, cauto = launch_free(lambda: launcher.serve(
        SERVE_MINUTES, "aapa", cpu_trained, M.init(0, scfg, device="cpu"),
        scfg, rates, np.random.default_rng(0), device="cpu",
        log=lambda *a: None), "serving on the CPU")
    cpu_s = time.perf_counter() - t0
    if ceng.summary() != summary:
        raise RuntimeError(f"serving: the CPU's summary {ceng.summary()} "
                           f"differs from the card's {summary}")
    cpu_trace = cauto.decision_trace()
    worst = 0.0
    for field in obs_trace.DecisionRecord._fields:
        a, e = getattr(card_trace, field), getattr(cpu_trace, field)
        if field in TRACE_DISCRETE:
            if not np.array_equal(a, e, equal_nan=True):
                raise RuntimeError(f"serving trace {field}: the card's "
                                   "decisions differ from the CPU's")
            continue
        tol = FORECAST_TOL if field in TRACE_FORECAST \
            else dict(rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a, e, equal_nan=True,
                                   err_msg=f"serving trace {field}", **tol)
        if np.isfinite(a).any():
            worst = max(worst, float(np.nanmax(np.abs(a - e))))
    log(f"[serve cpu] the same script on the CPU at smoke size "
        f"({cpu_s:.2f} s): summary equal, {len(cpu_trace.desired)} "
        f"decisions with discrete fields equal and the rest within "
        f"tolerance (max_abs_err {worst}); phases 28-29 "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(launches=counts, profiled=profiled, serve_s=serve_s,
                decode_ms=decode_ms, decode_wall_ms=decode_wall_ms,
                decode_bound_ms=d_bound, decode_bound_by=d_by,
                decode_bytes=d_bytes, decode_kernels=step_kernels,
                decode_steps=eng.decode_steps, summary=summary,
                peak_bytes=peak, trace_err=worst, cpu_s=cpu_s)


# ---- phases 30-33: training and the launch tools
TRAIN_ARCH = "internlm2_1_8b"
TRAIN_STEPS = 4
TRAIN_BATCH = (8, 64)                 # the launcher's token batch
CARD_ARCHS = ("internlm2_1_8b", "qwen3_moe_30b_a3b", "mamba2_2_7b")
LOSS_RTOL = (1e-4, 1e-3, 1e-3)        # test_torch_train.py's, by step


def train_step_bound(cfg, params, opt) -> tuple:
    """(bytes, products, bound ms, bound_by) of one train step at the
    launcher's batch: its inputs (params, optimizer state, tokens and
    labels) read once and its outputs (new params and state) written
    once; its products counted on the meta device (``launch.roofline``),
    the bf16 ones at the tensor cores' peak, the f32 ones at the CUDA
    cores'."""
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch import roofline
    from repro_torch.train import optimizer as opt_lib
    state = sum(t.numel() * t.element_size()
                for t in opt_lib.leaves((params, opt)))
    batch = 2 * TRAIN_BATCH[0] * TRAIN_BATCH[1] * 4
    n_bytes = 2 * state + batch
    counts = roofline.probe_counts(
        cfg, ShapeSpec("launcher", TRAIN_BATCH[1], TRAIN_BATCH[0], "train"))
    f32 = counts["flops_f32"]
    t_ops = ((counts["flops"] - f32) / BF16_OPS_PER_S
             + f32 / F32_OPS_PER_S) * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (n_bytes, counts["flops"], max(t_ops, t_bytes),
            "bytes" if t_bytes >= t_ops else "operations")


def scratch_dir() -> Path:
    """``build/`` of the checkout (gitignored), for checkpoints."""
    path = ROOT / "build"
    path.mkdir(exist_ok=True)
    return path


def step_profile(fn) -> tuple[int, float]:
    """(kernels, their summed device ms) the profiler counts on the card in
    one call of `fn`."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.count for e in kernels),
            sum(e.self_device_time_total for e in kernels) / 1e3)


def lm_training_phase(dev, smi: str) -> dict:
    """30. The LM trainer at full width: ``launch.train.main`` for
    TRAIN_STEPS steps of TRAIN_ARCH (the launcher's batch, two
    microbatches, the default AdamW) on the card, timed by CUDA events
    between steps; one more step under the profiler for its launches."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher
    from repro_torch.train.train_step import make_train_step

    cfg = get_config(TRAIN_ARCH)
    events, losses = [], []

    def on_step(step, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        losses.append(metrics["loss"])

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()      # what earlier phases keep
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as tmp:
        params, opt = launcher.main(
            ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
             "--ckpt-dir", tmp], on_step=on_step)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - held
    losses = [float(x) for x in losses]
    steps_ms = [events[i - 1].elapsed_time(events[i])
                for i in range(1, len(events))]
    step_ms = float(np.median(steps_ms))
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise RuntimeError(f"training at full width: losses {losses}")
    if any(counts.values()):
        raise RuntimeError(f"the train step launched the autoscaler's "
                           f"kernels {counts}")
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, TRAIN_BATCH),
                           dtype=torch.int32, device=dev)
    step = make_train_step(cfg, microbatches=2)
    t0 = time.perf_counter()
    launches, busy_ms = step_profile(
        lambda: step(params, opt, {"tokens": toks, "labels": toks}))
    profiled_ms = (time.perf_counter() - t0) * 1e3
    n_bytes, n_ops, bound, by = train_step_bound(cfg, params, opt)
    log(f"[train] {cfg.name} at full width ({n_params} parameters, "
        f"{cfg.dtype}), {TRAIN_STEPS} steps of {TRAIN_BATCH[0]} x "
        f"{TRAIN_BATCH[1]} tokens, 2 microbatches, AdamW defaults, through "
        f"launch.train.main in {wall:.2f} s: losses {losses}; median "
        f"{step_ms:.2f} ms a step over steps 2-{TRAIN_STEPS} (CUDA events "
        f"between steps: {[round(x, 2) for x in steps_ms]}), {launches} "
        f"kernel launches and {busy_ms:.2f} ms of device time a step "
        f"(profiler; the profiled step took {profiled_ms:.2f} ms); peak "
        f"device memory {peak} bytes above the {held} earlier phases hold; "
        f"bound {bound:.3f} ms by {by} ({n_bytes} bytes: params and "
        f"optimizer state read and written once; {n_ops:.4e} product "
        f"FLOPs); the autoscaler's kernels launched {counts} "
        f"[{smi}]")
    del params, opt, step
    return dict(step_ms=step_ms, steps_ms=steps_ms, launches=launches,
                busy_ms=busy_ms, profiled_ms=profiled_ms,
                peak_bytes=peak, losses=losses, bound_ms=bound, bound_by=by,
                bound_bytes=n_bytes, flops=n_ops, wall_s=wall,
                n_params=n_params)


def _host_copy(tree):
    from repro_torch.train import optimizer as opt_lib
    return opt_lib.tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def _same_bits(got_tree, want_tree, what: str) -> None:
    from repro_torch.train import optimizer as opt_lib
    for i, (a, b) in enumerate(zip(opt_lib.leaves(got_tree),
                                   opt_lib.leaves(want_tree))):
        if a.dtype != b.dtype or not torch.equal(a.cpu(), b.cpu()):
            raise RuntimeError(f"{what}: leaf {i} differs after the resume")


def resume_round_trip(cfg, dev, root: Path, save_at=(2,)) -> dict:
    """Steps 1-2 from seeded weights, ``AsyncCheckpointer.save`` (keep 1)
    of the params and optimizer state after each step of `save_at`, steps
    3-4; the checkpoint restored into new tensors and steps 3-4 again:
    params, moments and losses must equal the uninterrupted run's bit for
    bit, and one checkpoint is kept."""
    from repro_torch.models import model as M
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    ts = make_train_step(cfg, microbatches=2)
    rng = np.random.default_rng(5)
    batches = [torch.as_tensor(rng.integers(0, cfg.vocab, TRAIN_BATCH),
                               dtype=torch.int32, device=dev)
               for _ in range(4)]
    params = M.init(torch.Generator(device=dev).manual_seed(3), cfg)
    opt = opt_lib.init(params)
    writer = ckpt.AsyncCheckpointer(root, keep=1)
    for i, toks in enumerate(batches[:2]):
        params, opt, _ = ts(params, opt, {"tokens": toks, "labels": toks})
        if i + 1 in save_at:
            torch.cuda.synchronize()
            t_save = time.perf_counter()
            writer.save(i + 1, {"params": params, "opt": opt})
            snap_s = time.perf_counter() - t_save
    losses = []
    for toks in batches[2:]:
        params, opt, m = ts(params, opt, {"tokens": toks, "labels": toks})
        losses.append(float(m["loss"]))
    writer.close()
    write_s = time.perf_counter() - t_save
    kept = sorted(p.name for p in root.iterdir())
    want = _host_copy({"params": params, "opt": opt})
    del params, opt
    torch.cuda.empty_cache()
    shapes = M.init(0, cfg, device="meta")
    t0 = time.perf_counter()
    state, step = ckpt.restore(root, {"params": shapes,
                                      "opt": opt_lib.init(shapes)},
                               device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if step != 2 or kept != ["step_00000002"]:
        raise RuntimeError(f"resume: restored step {step}, kept {kept}")
    params, opt = state["params"], state["opt"]
    del state
    again = []
    for toks in batches[2:]:
        params, opt, m = ts(params, opt, {"tokens": toks, "labels": toks})
        again.append(float(m["loss"]))
    if again != losses:
        raise RuntimeError(f"resume: losses {again} != {losses}")
    _same_bits({"params": params, "opt": opt}, want, f"resume {cfg.name}")
    del params, opt, want
    torch.cuda.empty_cache()
    ckpt_bytes = sum(f.stat().st_size for f in root.rglob("*")
                     if f.is_file())
    return dict(losses=losses, snapshot_s=snap_s, write_s=write_s,
                restore_s=restore_s, kept=kept, ckpt_bytes=ckpt_bytes)


def checkpoint_phase(dev, smi: str) -> dict:
    """31. Checkpoint and resume, deterministic (the embedding's and MoE's
    index accumulations sort instead of using atomics): the params alone
    at full width written and read back bit for bit (the full state's
    round trip took ~140 s of the script's time limit on an H100 80GB
    HBM3 at 700 W), then
    `resume_round_trip` at smoke size, with retention."""
    import tempfile

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import model as M
    from repro_torch.train import checkpoint as ckpt

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    out = {}
    try:
        with tempfile.TemporaryDirectory(dir=scratch_dir()) as tmp:
            params = M.init(torch.Generator(device=dev).manual_seed(3), cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt.save(Path(tmp) / "params", 0, params)
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            back, _ = ckpt.restore(Path(tmp) / "params", params)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            _same_bits(back, params, "params at full width")
            out["params_only"] = dict(write_s=write_s, restore_s=restore_s)
            del params, back
            out["smoke"] = resume_round_trip(smoke_config(cfg), dev,
                                             Path(tmp) / "smoke",
                                             save_at=(1, 2))
    finally:
        torch.use_deterministic_algorithms(was)
    wall = time.perf_counter() - t_phase
    log(f"[ckpt] {cfg.name}'s params at full width ({cfg.param_count()} "
        f"bf16 parameters), deterministic: written in "
        f"{out['params_only']['write_s']:.2f} s and restored in "
        f"{out['params_only']['restore_s']:.2f} s, bit for bit [{smi}]")
    s = out["smoke"]
    log(f"[ckpt] the round trip at smoke size on the card: bit for bit, "
        f"losses {s['losses']}, saved at steps 1 and 2 and kept "
        f"{s['kept']}; phase 31 {wall:.1f} s")
    out["wall_s"] = wall
    return out


def card_vs_cpu_phase(dev) -> dict:
    """32. CARD_ARCHS at smoke size in f32, the same seeded weights and
    batches, three train steps (two microbatches, AdamW defaults) on the
    card and on the CPU: losses at test_torch_train.py's tolerances by
    step, params and moments at rtol 1e-4 / atol 1e-5 of each leaf's
    largest entry."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    t0 = time.perf_counter()
    worst = {}
    for arch in CARD_ARCHS:
        cfg = dataclasses.replace(smoke_config(get_config(arch)),
                                  dtype="float32", cache_dtype="float32")
        base = M.init(0, cfg, device="cpu")
        rng = np.random.default_rng(7)
        batches = [rng.integers(0, cfg.vocab, (4, 32)) for _ in range(3)]
        runs = []
        for d in (dev, torch.device("cpu")):
            params = opt_lib.tree_map(lambda t: t.to(d), base)
            opt = opt_lib.init(params)
            ts = make_train_step(cfg, microbatches=2)
            losses = []
            for b in batches:
                toks = torch.as_tensor(b, dtype=torch.int32, device=d)
                params, opt, m = ts(params, opt, {"tokens": toks,
                                                  "labels": toks})
                losses.append(float(m["loss"]))
            runs.append((losses, _host_copy({"params": params,
                                             "m": opt.m})))
        (card, card_tree), (cpu, cpu_tree) = runs
        for i, (a, e) in enumerate(zip(card, cpu)):
            if not np.isclose(a, e, rtol=LOSS_RTOL[i], atol=0.0):
                raise RuntimeError(f"{arch}: loss {i + 1} on the card {a}, "
                                   f"on the CPU {e}")
        err = 0.0
        for a, e in zip(opt_lib.leaves(card_tree), opt_lib.leaves(cpu_tree)):
            scale = float(e.abs().max())
            torch.testing.assert_close(a, e, rtol=1e-4,
                                       atol=1e-5 * max(scale, 1e-30))
            err = max(err, float((a - e).abs().max()))
        worst[arch] = dict(losses_card=card, losses_cpu=cpu,
                           max_abs_err=err)
    wall = time.perf_counter() - t0
    log(f"[train card vs cpu] {', '.join(CARD_ARCHS)} at smoke size, f32, "
        f"3 steps of 4 x 32 tokens: losses within rtol {LOSS_RTOL}, params "
        f"and m within rtol 1e-4 / atol 1e-5 of each leaf's largest entry: "
        f"{worst}; {wall:.1f} s")
    return dict(archs=worst, wall_s=wall)


def _fit_run(arch: str, shape_name: str, rec: dict, dev) -> dict:
    """One real run of a cell the dry run says fits: the decode step, or
    the train step on two of its microbatches (the same microbatch,
    accumulator and optimizer state, so the same peak), from seeded
    weights; its peak device memory beside the estimate."""
    import dataclasses

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import specs as sp
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    cfg, shape = get_config(arch), SHAPES[shape_name]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()      # what earlier phases keep
    t0 = time.perf_counter()
    params = M.init(torch.Generator(device=dev).manual_seed(0), cfg)
    gen = np.random.default_rng(0)
    if shape.kind == "decode":
        cache = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                             device=dev)
        toks = torch.as_tensor(gen.integers(0, cfg.vocab,
                                            (shape.global_batch, 1)),
                               dtype=torch.int32, device=dev)

        def step():
            return M.decode_step(params, cache, toks, shape.seq_len - 1,
                                 cfg)[0]
        what = "one decode step"
    elif shape.kind == "train":
        mb = rec["microbatches"]
        n = shape.global_batch // mb * min(mb, 2)
        specs = sp.input_specs(cfg, dataclasses.replace(shape,
                                                        global_batch=n))
        batch = {k: torch.as_tensor(gen.integers(0, cfg.vocab, v.shape),
                                    dtype=v.dtype, device=dev)
                 if v.dtype == torch.int32 else
                 torch.zeros(v.shape, dtype=v.dtype, device=dev)
                 for k, v in specs.items()}
        opt = opt_lib.init(params)
        ts = make_train_step(cfg, microbatches=min(mb, 2))

        def step():
            return ts(params, opt, batch)[2]["loss"]
        what = f"the train step on {min(mb, 2)} of its {mb} microbatches"
    else:
        raise RuntimeError(f"no real run for a {shape.kind} cell")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()     # the arguments are resident
    t0 = time.perf_counter()
    out = step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    finite = bool(torch.isfinite(out.float()).all())
    del params, out
    torch.cuda.empty_cache()
    if not finite:
        raise RuntimeError(f"{arch} {shape_name}: non-finite output")
    est = rec["memory"]["total_bytes"]
    return dict(what=what, peak_bytes=peak, estimate_bytes=est,
                estimate_err=(est - peak) / peak, wall_s=wall, init_s=init_s)


def launch_tools_phase(dev, smi: str) -> dict:
    """33. ``launch.dryrun.run_cell`` for every cell on the meta device,
    ``launch.roofline.probe_cell`` for the ``train_4k`` cells, a real run
    of every cell the dry run says fits (it must not run out of memory),
    and ``launch.train --dry-run``."""
    from repro_torch.configs import cells
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch import train as launcher

    t0 = time.perf_counter()
    recs = {}
    for arch, shape in cells():
        recs[(arch, shape)] = rec = dryrun.run_cell(arch, shape)
        if not rec.get("ok"):
            raise RuntimeError(f"dry run {arch} {shape}: {rec}")
    dry_s = time.perf_counter() - t0
    t1 = time.perf_counter()      # the probes' counts are the dry run's
    roof = {(a, s): roofline.probe_cell(a, s) for a, s in cells()}
    roof_s = time.perf_counter() - t1
    for (arch, shape), rec in recs.items():
        r = roof[(arch, shape)]
        log(f"[dryrun] {arch} {shape}: arguments "
            f"{rec['memory']['argument_bytes']} bytes, activations ~"
            f"{rec['memory']['activation_bytes']} bytes, "
            f"{rec['flops_per_device']:.4e} FLOPs, "
            f"{rec['bytes_accessed_per_device']:.4e} bytes moved, "
            f"microbatches {rec['microbatches']}, fits one card "
            f"{rec['fits_one_card']}; roofline compute {r['compute_s']:.4e} "
            f"s, memory {r['memory_s']:.4e} s, dominant {r['dominant']}, "
            f"useful {r['useful_flop_ratio']:.3f}")
    fits = [k for k, r in recs.items() if r["fits_one_card"]]
    real = {}
    for arch, shape in fits:
        real[f"{arch}|{shape}"] = run = _fit_run(arch, shape,
                                                 recs[(arch, shape)], dev)
        log(f"[dryrun real] {arch} {shape}: {run['what']} in "
            f"{run['wall_s']:.2f} s (its arguments made in "
            f"{run['init_s']:.2f} s), peak device memory {run['peak_bytes']} "
            f"bytes (above what earlier phases hold) against the dry run's "
            f"{run['estimate_bytes']} "
            f"(estimate error {run['estimate_err']:+.3f}) [{smi}]")
    try:
        launcher.main(["--arch", TRAIN_ARCH, "--dry-run"])
        code = None
    except SystemExit as e:
        code = e.code
    if code != 0:
        raise RuntimeError(f"launch.train --dry-run exited {code}")
    wall = time.perf_counter() - t0
    log(f"[launch tools] {len(recs)} cells dry-run in {dry_s:.1f} s, "
        f"{len(roof)} roofline records in {roof_s:.1f} s, "
        f"{len(fits)} cells fit one card and ran: "
        f"{', '.join(f'{a} {s}' for a, s in fits)}; launch.train --dry-run "
        f"exit 0; phase 33 {wall:.1f} s")
    return dict(dry_s=dry_s, roof_s=roof_s, fits=[f"{a}|{s}" for a, s in fits],
                real=real, wall_s=wall,
                roofline={a: {k: r[k] for k in ("compute_s", "memory_s",
                                                 "dominant",
                                                 "useful_flop_ratio")}
                          for (a, s), r in roof.items() if s == "train_4k"})


# ---- phase 35: model sharding over a world of one process per card
SHARD_ARCH = "deepseek_v2_lite_16b"
# the first dense layer and two MoE layers: one card also holds the
# unsharded step (~57 GB at its peak)
SHARD_LAYERS = 3
SHARD_DEADLINE_S = 600
# The first sharded step against the unsharded one, in two variants of
# the config. As configured, the expert-parallel path drops tokens by
# each rank's capacity (the reference's), so the gradients differ from
# the unsharded step's: the loss within the reference's 0.05
# (tests/test_distributed.py) and grad_norm within 3% (0.65% at (2, 2)
# and (4, 1), 1.9% at the smoke config's width). With a capacity at
# which no token drops ("no drops": capacity_factor ceil(E / top_k)) the
# two compute one function but for the aux loss, which the sharded step
# averages over the ranks' rows: grad_norm within 1e-3 and each leaf's
# new first moment m (0.1 x the clipped gradient, f32) within 0.25 of
# the unsharded one's, |m - m'| / |m'| in the Frobenius norm. The aux
# loss moves the routers' m most: at most 0.112 at (4, 1) on four cards,
# where a replicated leaf's gradient summed over half the ranks errs by
# 0.74-0.86, and 0.03 at the smoke config's width. In both, new bf16
# params within one bf16 rounding (2^-7 of the value) plus 2.5 x the
# step's learning rate (AdamW's first update is +-lr for every entry).
SHARD_LOSS_ATOL = 0.05
SHARD_TOL = {"config": dict(grad_norm=0.03, m=None),
             "no drops": dict(grad_norm=1e-3, m=0.25)}


def shard_cfg(n_layers: int, variant: str = "config"):
    """SHARD_ARCH at full width cut to `n_layers`; the "no drops" variant
    with a capacity that holds every token (see SHARD_TOL)."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(SHARD_ARCH), n_layers=n_layers)
    if variant == "no drops":
        cfg = dataclasses.replace(cfg, capacity_factor=float(
            -(-cfg.n_experts // cfg.top_k)))
    return cfg


def launcher_batch(cfg, dev) -> dict:
    """The launcher's token batch (8 x 64 from ``default_rng(0)``)."""
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, TRAIN_BATCH), dtype=torch.int32, device=dev)
    return {"tokens": toks, "labels": toks}


def same_init(params, group=None) -> None:
    """Every rank drew the same parameters (each draws them from the same
    seed on its own card): the f64 sums of the leaves agree."""
    import torch.distributed as dist

    from repro_torch.train import optimizer as opt_lib
    s = torch.stack([t.double().sum() for t in opt_lib.leaves(params)])
    all_s = [torch.empty_like(s) for _ in range(dist.get_world_size(group))]
    dist.all_gather(all_s, s, group=group)
    if not all(torch.equal(a, s) for a in all_s):
        raise RuntimeError("the ranks drew different parameters")


def warm_groups(mesh, dev) -> None:
    """A first all-reduce on each axis's group and the world's: NCCL
    makes a group's communicator at its first collective."""
    import torch.distributed as dist
    for entry in list(mesh.axis_names) + [mesh.axis_names]:
        dist.all_reduce(torch.ones(1, device=dev), group=mesh.group(entry))


def step_errors(local, opt, metrics, sh, want, dev) -> dict | None:
    """The first sharded step against the unsharded one (`want`, on rank
    0: its params and first moments on the host, its grad_norm): every
    rank gathers the new params and m leaf by leaf, rank 0 measures them.
    Returns, on rank 0, the params' largest |diff| and how many entries
    exceed a bf16 rounding plus 2.5 lr, each m leaf's Frobenius error
    |m - m'| / |m'|, and grad_norm's relative error; None elsewhere."""
    from repro_torch.dist import sharding as shd
    from repro_torch.train import optimizer as opt_lib
    out = None if want is None else dict(
        params_max_abs_err=0.0, params_bad=0, m_rel=[],
        grad_norm_rel=abs(float(metrics["grad_norm"]) - want["grad_norm"])
        / want["grad_norm"])
    shs = opt_lib.leaves(sh)
    for i, (x, mo, s) in enumerate(zip(opt_lib.leaves(local),
                                       opt_lib.leaves(opt.m), shs)):
        g, gm = shd.gather_leaf(x, s).float(), shd.gather_leaf(mo, s)
        if out is not None:
            e = want["params"][i].to(dev).float()
            d = (g - e).abs()
            out["params_bad"] += int((d > e.abs() * 2.0 ** -7
                                      + 2.5 * want["lr"]).sum())
            out["params_max_abs_err"] = max(out["params_max_abs_err"],
                                            float(d.max()))
            em = want["m"][i].to(dev)
            ref = float(torch.linalg.vector_norm(em))
            diff = float(torch.linalg.vector_norm(gm - em))
            out["m_rel"].append(diff / ref if ref > 0 else diff)
        del g, gm
    return out


def check_step(where: str, tol: dict, first, errs, unsharded) -> None:
    """Rank 0's gate of a first sharded step (`tol`: SHARD_TOL's)."""
    faults = []
    if abs(first["loss"] - unsharded["loss"]) > SHARD_LOSS_ATOL:
        faults.append(f"loss {first['loss']} against {unsharded['loss']}")
    if errs["grad_norm_rel"] > tol["grad_norm"]:
        faults.append(f"grad_norm {first['grad_norm']} against "
                      f"{unsharded['grad_norm']}")
    m_rel = errs["m_rel"]
    worst = sorted(range(len(m_rel)), key=lambda i: -m_rel[i])[:3]
    if tol["m"] is not None and m_rel[worst[0]] > tol["m"]:
        faults.append("m leaves " + ", ".join(
            f"{i}: {m_rel[i]:.4g}" for i in worst) + f" over {tol['m']}")
    if errs["params_bad"]:
        faults.append(f"{errs['params_bad']} new param entries off")
    if faults:
        raise RuntimeError(f"{where} against the unsharded step: "
                           + "; ".join(faults))


def sharded_step_rank(rank: int, shapes, n_layers: int, steps: int) -> dict:
    """One rank of phase 35 (and of tools/run_sharded_training.py's first
    part), for each variant of SHARD_TOL: rank 0 runs the unsharded step
    of SHARD_ARCH cut to `n_layers` at full width on its card; then for
    each mesh shape every rank places the same seeded params by
    ``param_shardings`` and runs sharded steps of the launcher's batch
    (`steps` as configured, one without drops). The first step's loss,
    grad_norm, first moments and new params are held against the
    unsharded step's on rank 0 (`step_errors`, `check_step`); every rank
    reports its walls, peak memory and the mesh's NCCL set-up time (its
    groups made and a first all-reduce on each, `warm_groups`)."""
    import torch.distributed as dist

    from repro_torch.dist import sharding as shd
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"rank": rank, "card": torch.cuda.get_device_name(dev),
           "variants": {}}
    for variant, tol in SHARD_TOL.items():
        cfg = shard_cfg(n_layers, variant)
        batch = launcher_batch(cfg, dev)
        ts = make_train_step(cfg)
        res = out["variants"][variant] = {"meshes": {}}
        want = None
        if rank == 0:
            params = M.init(0, cfg, device=dev)
            opt = opt_lib.init(params)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            p1, o1, m1 = ts(params, opt, batch)
            torch.cuda.synchronize(dev)
            res["unsharded"] = dict(
                wall_s=time.perf_counter() - t0,
                peak_bytes=torch.cuda.max_memory_allocated(dev),
                n_params=sum(t.numel() for t in opt_lib.leaves(params)),
                **{k: float(v) for k, v in m1.items()})
            want = dict(params=[t.to("cpu", copy=True)
                                for t in opt_lib.leaves(p1)],
                        m=[t.to("cpu", copy=True)
                           for t in opt_lib.leaves(o1.m)],
                        grad_norm=float(m1["grad_norm"]),
                        lr=3e-4 * int(o1.step) / 100)  # AdamWConfig's warmup
            del params, opt, p1, o1
            torch.cuda.empty_cache()
        for shape in shapes:
            dist.barrier()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            mesh = launch_mesh.make_debug_mesh(*shape, device=dev.type)
            warm_groups(mesh, dev)
            torch.cuda.synchronize(dev)
            nccl_s = time.perf_counter() - t0
            shd.set_mesh(mesh)
            sh = M.param_shardings(cfg)
            full = M.init(0, cfg, device=dev)
            same_init(full)
            local = shd.device_put(full, sh)
            del full
            opt = opt_lib.init(local)
            lb = shd.device_put(batch, shd.batch_shardings(batch))
            walls, peaks, losses = [], [], []
            for step in range(steps if variant == "config" else 1):
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                local, opt, m = ts(local, opt, lb)
                torch.cuda.synchronize(dev)
                walls.append(time.perf_counter() - t0)
                peaks.append(torch.cuda.max_memory_allocated(dev))
                losses.append(float(m["loss"]))
                if step == 0:
                    first = {k: float(v) for k, v in m.items()}
                    errs = step_errors(local, opt, m, sh, want, dev)
            if not np.isfinite(losses).all():
                raise RuntimeError(f"mesh {shape}: losses {losses}")
            if rank == 0:
                check_step(f"{variant}, mesh {shape}", tol, first, errs,
                           res["unsharded"])
            res["meshes"][str(shape)] = dict(
                nccl_s=nccl_s, walls_s=walls, peak_bytes=peaks,
                losses=losses, first=first, errors=errs,
                local_params=sum(t.numel() for t in opt_lib.leaves(local)))
            del local, opt, lb
            shd.set_mesh(None)
            torch.cuda.empty_cache()
    return out


def shard_readings(errs) -> str:
    """One line of a rank-0 step's errors against the unsharded step."""
    return (f"grad_norm rel. {errs['grad_norm_rel']:.6g}, largest m leaf "
            f"rel. {max(errs['m_rel']):.6g} (median "
            f"{sorted(errs['m_rel'])[len(errs['m_rel']) // 2]:.6g}), params "
            f"max |diff| {errs['params_max_abs_err']:.6g}")


def sharded_training_phase(smi: str) -> dict:
    """35. Model sharding over a world of one process per visible card
    (``dist.world.spawn``, NCCL, a ``file://`` store under ``build/``):
    SHARD_ARCH at full width cut to SHARD_LAYERS layers, a sharded step
    on the mesh (cards, 1) of the launcher's 8 x 64 batch in each variant
    of SHARD_TOL, against the unsharded step on the first card
    (`sharded_step_rank`). Prints each rank's step wall, peak memory and
    NCCL set-up time."""
    from repro_torch.dist import world
    n = torch.cuda.device_count()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ranks = world.spawn(sharded_step_rank, n, backend="nccl",
                        root=scratch_dir() / "world",
                        deadline_s=SHARD_DEADLINE_S,
                        args=([(n, 1)], SHARD_LAYERS, 1))
    wall = time.perf_counter() - t0
    for variant in SHARD_TOL:
        un = ranks[0]["variants"][variant]["unsharded"]
        for r in ranks:
            for shape, m in r["variants"][variant]["meshes"].items():
                log(f"[sharded train] {variant}: rank {r['rank']} "
                    f"({r['card']}) mesh {shape}: {SHARD_ARCH} at full width "
                    f"cut to {SHARD_LAYERS} layers ({un['n_params']} "
                    f"parameters, {m['local_params']} on this card), step "
                    f"wall {m['walls_s'][0]:.3f} s, peak device memory "
                    f"{m['peak_bytes'][0]} bytes, NCCL set-up "
                    f"{m['nccl_s']:.3f} s; loss {m['first']['loss']} "
                    f"grad_norm {m['first']['grad_norm']} aux "
                    f"{m['first']['aux']}")
        m0 = ranks[0]["variants"][variant]["meshes"][str((n, 1))]
        log(f"[sharded train] {variant}: unsharded step on one card: wall "
            f"{un['wall_s']:.3f} s, peak {un['peak_bytes']} bytes, loss "
            f"{un['loss']} grad_norm {un['grad_norm']}; the sharded step "
            f"within SHARD_TOL: loss |diff| "
            f"{abs(m0['first']['loss'] - un['loss'])}, "
            f"{shard_readings(m0['errors'])}")
    log(f"[sharded train] phase 35 took {wall:.1f} s with {n} process(es), "
        f"the main process holding {held} bytes [{smi}]")
    return dict(wall_s=wall, ranks=ranks)


def training_phases(dev, smi: str) -> dict:
    """30-33, each timed."""
    out = {}
    for name, fn in (("train", lambda: lm_training_phase(dev, smi)),
                     ("ckpt", lambda: checkpoint_phase(dev, smi)),
                     ("card_vs_cpu", lambda: card_vs_cpu_phase(dev)),
                     ("launch", lambda: launch_tools_phase(dev, smi))):
        t0 = time.perf_counter()
        out[name] = fn()
        log(f"[phases] {name} {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    # cuBLAS is deterministic in phase 31 only with a fixed workspace,
    # which it takes when its first handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    traces = azure_synth.generate_traces(n_functions=150, n_days=14, seed=0)
    ds = windows.make_windows(traces)
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
    # the wide kernel past 64 samples, on windows of the same traces at a
    # longer stride (~20,000 windows a width)
    wide_rows = {}
    for width in WIDE_WIDTHS:
        x = torch.as_tensor(windows.make_windows(
            traces, window=width, stride=WIDE_STRIDE).windows, device=dev)
        n = x.shape[0]
        err = 0.0
        for freq in (False, True):
            got = wf_launcher(x, freq=freq)
            if wf_launcher.last_variant != "wide":
                raise RuntimeError(f"window_features at W = {width} took "
                                   f"the {wf_launcher.last_variant} kernel")
            t0 = time.perf_counter()
            want = launch_free(lambda: (
                ref.extract_features_ref if freq
                else ref.window_features_ref)(x), "window_features")
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            q = quant if freq else quant28
            if not torch.equal(got[:, q], want[:, q]):
                raise RuntimeError(f"window_features wide at W = {width}: "
                                   "quantized features differ from the "
                                   "plain version")
            err = max(err, max_abs_err([got], [want], FEATURE_TOL,
                                       f"window_features W={width}"))
            if not torch.equal(got, want):
                raise RuntimeError(f"window_features wide at W = {width}: "
                                   f"the {got.shape[1]} features differ "
                                   "from the plain version's bits")
        del got, want
        ms = cuda_ms(lambda: wf_launcher(x, freq=True), iters=3)[0]
        centred = x - x.mean(-1, keepdim=True)
        rfft = cuda_ms(lambda: torch.fft.rfft(centred, dim=-1), iters=3)[0]
        bnd, by = bound_ms(
            4.0 * n * (width + 38)
            + 4.0 * features.fft_tables(width, dev)[0].numel(),
            float(n) * (stat_feature_ops(width) + freq_feature_ops(width)))
        wide_rows[width] = dict(windows=n, ms=ms, plain_ms=plain_s * 1e3,
                                bound_ms=bnd, bound_by=by, max_abs_err=err,
                                library_ms=rfft)
        wf_err = max(wf_err, err)
        log(f"[window_features] {n} x {width}, 28 and 38 features, kernel "
            f"wide: equal to the plain version bit for bit (within rtol/atol "
            f"5e-4, quantized features exact), max_abs_err={err}; 38 "
            f"features {ms} ms, plain {plain_s * 1e3} ms (one run, host "
            f"clock), bound {bnd} ms ({by}); torch.fft.rfft alone {rfft} ms")
        del x, centred
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

    # AAPA and hybrid on other rate histories: the pre-pass reclassifies on
    # the generic (45) or the wide (90, 120) window_features kernel
    from repro_torch.kernels import policy_signals
    rc_launcher = policy_signals.reclassify_cuda
    hmix = torch.as_tensor(scenarios.archetype_mix(
        n_workloads=HISTORY_LANES, minutes=HISTORY_MINUTES, seed=3).rates,
        device=dev)
    history_rows, wide_launches = {}, 0
    for hl in HISTORY_LENS:
        hcfg = cluster.SimConfig(history_len=hl)
        for policy in ("aapa", "hybrid"):
            hctrl = registry.make(policy, hcfg, classify=cls)
            ops.reset_launch_counts()
            got = episode_block.aapa_episode_cuda(hmix, hctrl, hcfg)
            torch.cuda.synchronize()
            counts = dict(ops.launch_counts(),
                          reclassify=rc_launcher.launches)
            if not (counts["episode_block"] and counts["policy_signals"]
                    and counts["reclassify"]):
                raise RuntimeError(f"{policy} at history_len {hl} launched "
                                   f"{counts}")
            variant = rc_launcher.last_variant
            if variant == "wide":
                wide_launches += counts["reclassify"]
            t0 = time.perf_counter()
            want = launch_free(lambda: ref.aapa_episode_ref(hmix, hctrl,
                                                            hcfg),
                               f"{policy} history_len {hl}")
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            if not (all(torch.equal(a, e) for a, e in zip(got[0], want[0]))
                    and torch.equal(got[1], want[1])):
                raise RuntimeError(f"{policy} at history_len {hl}: the "
                                   "episode differs from its plain "
                                   "episode's bits")
            n_arch = len(torch.unique(want[1]))
            history_rows[f"{policy}@{hl}"] = dict(
                launches=counts, variant=variant, plain_s=plain_s)
            log(f"[episode_block<{policy}>] history_len {hl}, archetype_mix "
                f"{HISTORY_LANES}x{HISTORY_MINUTES}: equal to the plain "
                f"episode bit for bit, archetypes included ({n_arch} "
                f"archetypes); reclassification kernel {variant}, launches "
                f"{counts}; plain {plain_s:.1f} s (host clock)")
            del got, want
        hms = cuda_ms(lambda: rc_launcher(chunk, cls, stride, hl),
                      iters=3)[0]
        hbound, hby = reclassify_bound(cls, w_chunk, M, stride, hl)
        hctrl = registry.make("aapa", hcfg, classify=cls)
        hep_ms = cuda_ms(lambda: episode_block.aapa_episode_cuda(
            chunk, hctrl, hcfg), iters=3)[0]
        history_rows[f"reclassify@{hl}"] = dict(
            ms=hms, bound_ms=hbound, bound_by=hby, aapa_episode_ms=hep_ms)
        log(f"[timing] reclassify {w_chunk}x{M} at history_len {hl} "
            f"(kernel {rc_launcher.last_variant}): {hms} ms, bound {hbound} "
            f"ms ({hby}); the AAPA episode there {hep_ms} ms (at 60: "
            f"{aapa_ms} ms)")

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
    # the reclassification alone on the chunk, at the default 60 minutes
    # (the W = 60 kernels): bit for bit with its plain version, and timed
    got = rc_launcher(chunk, cls, stride, 60)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = launch_free(lambda: ref.reclassify_ref(chunk, cls, stride, 60),
                       "reclassify")
    torch.cuda.synchronize()
    rc_plain_ms = (time.perf_counter() - t0) * 1e3
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError("reclassify on the chunk differs from its plain "
                           "version")
    del got, want
    rc_ms = cuda_ms(lambda: rc_launcher(chunk, cls, stride, 60), iters=5)[0]
    rc_bound, rc_by = reclassify_bound(cls, w_chunk, M, stride, 60)
    log(f"[timing] reclassify {w_chunk}x{M} at history_len 60 (kernel "
        f"{rc_launcher.last_variant}): {rc_ms} ms, equal to the plain "
        f"version bit for bit (plain {rc_plain_ms} ms, one run, host "
        f"clock), bound {rc_bound} ms ({rc_by})")

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
    if len(w60_entries) != 3 or any(u["stack"] or u["local"]
                                    for u in w60_entries.values()):
        raise RuntimeError(f"the W = 60 window_features kernels (28 and 38 "
                           f"features, and the pre-pass's windows) are not "
                           f"three entries without stack or local memory: "
                           f"{w60_entries}")
    # the wide kernel: its (lanes a window, sort registers) pairs (8, 16),
    # (32, 8), (32, 16), (32, 32) x (28 and 38 features, and the
    # pre-pass's windows). ptxas gives most entries 72 registers (7 blocks
    # an SM) and spills a few of them: at most WIDE_SPILL_MAX bytes of
    # stack, and no other local memory.
    wide_entries = {e: u for e, u in usage.items()
                    if "window_features_wide_kernel" in e}
    if len(wide_entries) != 12 or any(u["local"]
                                      or u["stack"] > WIDE_SPILL_MAX
                                      for u in wide_entries.values()):
        raise RuntimeError(f"the wide window_features kernels are not 12 "
                           f"entries within {WIDE_SPILL_MAX} B of spills "
                           f"and no local memory: {wide_entries}")
    if not any("calibrate_kernel" in e for e in usage):
        raise RuntimeError(f"no calibrate_kernel entry in {sorted(usage)}")
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
        n_workloads=4096, minutes=FORECASTER_MINUTES, seed=5).rates,
        device=dev)
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
                raise RuntimeError(f"episode {label}[{fname}] 4096x"
                                   f"{FORECASTER_MINUTES} differs from its "
                                   "plain version")
            del got, want
    torch.cuda.synchronize()
    log(f"[forecasters] {len(new_fcs) * len(fc_cases)} episodes "
        f"({', '.join(fc_cases)} x {', '.join(new_fcs)}) on archetype_mix "
        f"4096x{FORECASTER_MINUTES} equal their plain versions bit for bit, "
        f"archetypes "
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
    spec_pool, spec_per_w, _, _ = run_matrix(matrix, bench_spec(matrix), cls,
                                             "SPEC")
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
    fleet_runs = fleet_phase(tcls, data_loader)

    # ---- 34. the fleet plane over a device mesh
    mesh_runs = mesh_phase(
        tcls, fleet_runs["one-dispatch 1e5"]["result"],
        fleet_runs["stream 1e5"].pop("result"),
        fleet_runs["one-dispatch 1e5"].pop("rates"),
        (bench_spec(matrix), spec_pool, spec_per_w), cls, built)
    del built

    # ---- 24-26. telemetry, an obs card and tuning on the card
    telemetry = telemetry_phases(
        tcls, fleet_runs["one-dispatch 1e5"].pop("result"),
        train_info["dataset_id"])
    obs_card = telemetry["obs"]
    tuning_runs = tuning_phase()

    # ---- 27-29. the model substrate and the autoscaled serving endpoint
    model_phase(dev)
    serving = serving_phase(dev)

    # ---- 30-33. training and the launch tools
    training_phases(dev, smi)

    # ---- 35. model sharding over a world of one process per card
    sharded_training_phase(smi)

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
        dict(name="reclassify", policy="aapa_band", route="cuda",
             source="src/repro_torch/kernels/csrc/policy_signals.cu",
             parts=["src/repro_torch/kernels/csrc/window_features.cu",
                    "src/repro_torch/kernels/csrc/gbdt_tables.cu",
                    "src/repro_torch/kernels/csrc/policy_signals.cu"],
             replaces="src/repro/kernels/episode_block.py:210",
             launches=aapa_counts["reclassify"], max_abs_err=0.0,
             ms=rc_ms, plain_ms=rc_plain_ms, bound_ms=rc_bound,
             bound_by=rc_by, library_ms=None,
             history_len={hl: history_rows[f"reclassify@{hl}"]
                          for hl in HISTORY_LENS}),
        dict(name="window_features<wide>", route="cuda",
             source="src/repro_torch/kernels/csrc/window_features.cu",
             replaces="src/repro/kernels/window_features.py:163",
             launches=wide_launches,
             max_abs_err=max(r["max_abs_err"] for r in wide_rows.values()),
             width=120, ms=wide_rows[120]["ms"],
             plain_ms=wide_rows[120]["plain_ms"],
             bound_ms=wide_rows[120]["bound_ms"],
             bound_by=wide_rows[120]["bound_by"],
             library_ms=wide_rows[120]["library_ms"], by_width=wide_rows),
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
    # launches on the later slices' paths (phases 21-26)
    fleet_paths = {f"fleet {label}": run["launches"]
                   for label, run in fleet_runs.items() if "launches" in run}
    traced_paths = {f"telemetry {label}": row["launches"]
                    for label, row in telemetry["rows"].items()}
    traced_paths.update({"telemetry fleet": telemetry["fleet"]["launches"],
                         "obs card": obs_card["launches"]})
    mesh_paths = {f"mesh {label}": run["launches"]
                  for label, run in mesh_runs.items()
                  if "launches" in run and label != "aapaset"}
    slice_paths = {
        "window_features": {"aapaset build": aapaset_counts,
                            "mesh aapaset build":
                                mesh_runs["aapaset"]["launches"],
                            "serving": serving["launches"]},
        "gbdt_tables": {"training": train_counts, **traced_paths,
                        "serving": serving["launches"]},
        "plant_block": traced_paths,
        "episode_block": {**fleet_paths, **mesh_paths,
                          "tuning grid": tuning_runs["grid"]["launches"],
                          "tuning searches":
                              tuning_runs["search_launches"]},
        "policy_signals": {**fleet_paths, **mesh_paths}}
    for row in kernels:
        if row["name"] in slice_paths:
            row["paths"] = {path: counts[row["name"]] for path, counts in
                            slice_paths[row["name"]].items()}
    log(f"[chip_smoke] phases 1-35 in {time.perf_counter() - t_start:.1f} "
        f"s, the build included")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
