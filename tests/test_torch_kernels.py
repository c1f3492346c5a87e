"""The port's kernels (``repro_torch.kernels``) on the CPU: plain PyTorch
versions against the JAX reference's oracles and its Pallas kernels in
interpret mode, device dispatch, and wrapper validation. The CUDA
kernels themselves are checked in tests/test_torch_cuda.py."""
import _torch_threads  # noqa: F401  (one torch thread)
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as ref_cal
from repro.core import gbdt as ref_gbdt
from repro.core import pipeline as ref_pipeline
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.scaling import registry as ref_registry
from repro.sim import cluster as ref_cluster
from repro_torch import _numerics
from repro_torch.core import features
from repro_torch.core import gbdt as t_gbdt
from repro_torch.core.calibration import BetaCalibration
from repro_torch.core.pipeline import Classify
from repro_torch.kernels import (episode_block, gbdt_tables, holt_winters,
                                 ops, plant_block, policy_signals, ref,
                                 window_features)
from repro_torch.scaling import registry as t_registry
from repro_torch.sim import cluster as t_cluster

PLANT_TOL = dict(rtol=1e-5, atol=1e-5)     # test_kernel_properties.py
EPISODE_TOL = dict(rtol=3e-6, atol=1e-4)   # test_kernel_smoke.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plant_state(rng, b, s):
    pipeline = rng.gamma(1.0, 0.6, (b, s)).astype(np.float32)
    return [np.asarray(c, np.float32) for c in (
        rng.gamma(2.0, 2.0, b), pipeline, rng.gamma(1.0, 25.0, b),
        rng.gamma(1.0, 5.0, b), rng.random(b), rng.uniform(0.0, 20.0, b),
        pipeline.sum(axis=1), rng.gamma(2.0, 30.0, b))]


def _close(got, want, tol, what):
    for i, (a, e) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(e), **tol,
                                   err_msg=f"{what}[{i}]")


@pytest.mark.parametrize("b,s,n_ticks", [(5, 30, 15), (4, 12, 29),
                                         (3, 30, 3)])
def test_plant_block_ref_matches_reference(b, s, n_ticks):
    """Torch plain version vs the reference oracle and vs the reference
    Pallas kernel in interpret mode (tile 4; b=5 pads a tile)."""
    state = _plant_state(np.random.default_rng(b * 31 + n_ticks), b, s)
    got = ref.plant_block_ref(*map(torch.as_tensor, state),
                              n_ticks=n_ticks)
    jx = [jnp.asarray(x) for x in state]
    for want, what in (
            (ref_ref.plant_block_ref(*jx, n_ticks=n_ticks), "oracle"),
            (ref_ops.plant_tick_block(*jx, n_ticks=n_ticks, tile_b=4,
                                      interpret=True), "pallas")):
        _close(got[0], want[0], PLANT_TOL, f"{what} state")
        _close(got[1], want[1], PLANT_TOL, f"{what} ticks")


def test_episode_block_ref_matches_reference_kernel():
    """Torch plain episode vs the reference Pallas episode kernel in
    interpret mode: HPA, ci=30 (compiles in seconds), 5 lanes, tile 4."""
    rng = np.random.default_rng(5)
    rates = rng.uniform(0.0, 200.0, size=(5, 6)).astype(np.float32)
    rcfg = ref_cluster.SimConfig(control_interval_sec=30)
    want = ref_ops.episode_block(jnp.asarray(rates),
                                 ref_registry.make("hpa", rcfg), rcfg,
                                 tile_b=4, interpret=True)
    cfg = t_cluster.SimConfig(control_interval_sec=30)
    got = ref.episode_block_ref(torch.as_tensor(rates),
                                t_registry.make("hpa", cfg), cfg)
    _close(got, want, EPISODE_TOL, "MinuteOut")


def test_cpu_dispatch_runs_plain_versions_only():
    """CPU tensors go to the plain version and launch nothing."""
    ops.reset_launch_counts()
    state = [torch.as_tensor(x) for x in
             _plant_state(np.random.default_rng(1), 6, 30)]
    got = ops.plant_tick_block(*state, n_ticks=14)
    want = ref.plant_block_ref(*state, n_ticks=14)
    for a, e in zip((*got[0], *got[1]), (*want[0], *want[1])):
        assert torch.equal(a, e)
    cfg = t_cluster.SimConfig()
    ctrl = t_registry.make("hpa", cfg)
    rates = torch.as_tensor(
        np.random.default_rng(2).uniform(0, 900, (3, 4)).astype(np.float32))
    for a, e in zip(ops.episode_block(rates, ctrl, cfg),
                    ref.episode_block_ref(rates, ctrl, cfg)):
        assert torch.equal(a, e)
    windows = torch.as_tensor(np.random.default_rng(4).gamma(
        2.0, 10.0, (5, 60)).astype(np.float32))
    assert torch.equal(ops.window_features(windows),
                       ref.window_features_ref(windows))
    assert torch.equal(ops.extract_features_fused(windows),
                       ref.extract_features_ref(windows))
    params = _tiny_port_gbdt()[1]
    X = torch.as_tensor(np.random.default_rng(5).normal(
        size=(7, 38)).astype(np.float32))
    assert torch.equal(ops.gbdt_logits(params, X),
                       ref.gbdt_logits_ref(params, X))
    y = torch.as_tensor(np.random.default_rng(6).gamma(
        2.0, 10.0, (3, 70)).astype(np.float32))
    assert torch.equal(ops.holt_winters(y, period=7),
                       ref.holt_winters_ref(y, period=7))
    for name in ("predictive", "kpa", "hybrid"):
        ctrl = t_registry.make(name, cfg)
        for a, e in zip(ops.episode_block(rates, ctrl, cfg),
                        ref.episode_block_ref(rates, ctrl, cfg)):
            assert torch.equal(a, e)
    assert ops.launch_counts() == {"plant_block": 0, "episode_block": 0,
                                   "policy_signals": 0,
                                   "window_features": 0, "gbdt_tables": 0,
                                   "holt_winters": 0}


def test_kernel_wrappers_reject_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes the
    plain version itself."""
    state = [torch.as_tensor(x) for x in
             _plant_state(np.random.default_rng(3), 2, 30)]
    for variant in ("staged", "per_thread"):
        with pytest.raises(ValueError, match="CUDA"):
            plant_block.plant_tick_block_cuda(*state, n_ticks=3,
                                              variant=variant)
    with pytest.raises(ValueError, match="CUDA"):
        plant_block.empty_launch_cuda(*state, n_ticks=3)
    cfg = t_cluster.SimConfig()
    with pytest.raises(ValueError, match="CUDA"):
        episode_block.episode_block_cuda(torch.ones(2, 3),
                                         t_registry.make("hpa", cfg), cfg)
    for name in ("aapa", "predictive", "kpa", "hybrid"):
        with pytest.raises(ValueError, match="CUDA"):
            episode_block.episode_block_cuda(
                torch.ones(2, 3), t_registry.make(name, cfg), cfg)
    for variant in (None, "shared", "global"):
        with pytest.raises(ValueError, match="CUDA"):
            holt_winters.holt_winters_cuda(torch.ones(2, 3), variant=variant)
    for freq in (False, True):
        for variant in (None, "w60", "generic"):
            with pytest.raises(ValueError, match="CUDA"):
                window_features.window_features_cuda(
                    torch.ones(2, 60), freq=freq, variant=variant)
    for variant in (None, "shared", "generic"):
        with pytest.raises(ValueError, match="CUDA"):
            gbdt_tables.gbdt_logits_cuda(_tiny_port_gbdt()[1],
                                         torch.ones(2, 38), variant=variant)


_KERNELS_H = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
              / "kernels" / "csrc" / "kernels.h").read_text()


@pytest.mark.parametrize("period,want", [(1, "shared"), (60, "shared"),
                                         (96, "shared"), (97, "global"),
                                         (1440, "global")])
def test_holt_winters_variant_by_period(period, want):
    """The season sits in shared memory up to the limit the CUDA source
    compiles (kHWSharedPeriodMax), in global scratch past it."""
    assert f"kHWSharedPeriodMax = {holt_winters.SHARED_PERIOD_MAX};" in (
        _KERNELS_H)
    assert holt_winters.choose_variant(period) == want


@pytest.mark.parametrize("n_trees,depth,want", [
    (240, 4, "shared"), (1, 12, "shared"), (16_000, 1, "generic"),
    (240, 6, "generic"), (1024, 6, "generic")])
def test_gbdt_tables_variant_by_table_bytes(n_trees, depth, want):
    """The node tables sit in shared memory up to the limit the CUDA
    source compiles (kGBDTSharedTableMax), 8 B a node and 4 a leaf; the
    paper's 240 trees of depth 4 take 44,160 B of it."""
    assert f"kGBDTSharedTableMax = {gbdt_tables.SHARED_TABLE_MAX // 1024}" \
        " * 1024;" in _KERNELS_H
    assert gbdt_tables.shared_table_bytes(240, 4) == 44_160
    assert gbdt_tables.choose_variant(
        gbdt_tables.shared_table_bytes(n_trees, depth)) == want


def test_gbdt_tables_variant_at_the_limit_and_refusals():
    limit = gbdt_tables.SHARED_TABLE_MAX
    assert gbdt_tables.choose_variant(limit) == "shared"
    assert gbdt_tables.choose_variant(limit + 1) == "generic"
    with pytest.raises(ValueError, match="table_bytes"):
        gbdt_tables.choose_variant(0)


@pytest.mark.parametrize("B,want", [
    (1, 32), (1024, 32), (131 * 64, 32), (131 * 64 + 1, 64),
    (131 * 128, 64), (131 * 128 + 1, 128), (100_003, 128)])
def test_plant_block_lanes_by_B(B, want):
    """128 lanes a block wherever every one of the card's 132 SMs still
    gets a block, then 64, else 32: 1024 lanes take 32 blocks, not 8."""
    assert plant_block.choose_lanes(B, 132) == want
    assert -(-B // want) >= min(132, -(-B // 32))


@pytest.mark.parametrize("lanes,S,n_ticks,want", [
    (128, 30, 14, 14), (32, 30, 14, 14), (64, 1, 5, 1), (128, 100, 70, 63),
    (64, 200, 200, 127), (32, 300, 260, 255), (32, 255, 300, 255)])
def test_plant_block_pop_chunk(lanes, S, n_ticks, want):
    """Every popped slot at once where lanes x (chunk | 1) floats fit the
    staging buffer the CUDA source sizes (kPlantPopFloats), else the most
    ticks that fit."""
    assert f"kPlantPopFloats = {plant_block.POP_FLOATS};" in _KERNELS_H
    chunk = plant_block.pop_chunk(lanes, S, n_ticks)
    assert chunk == want
    assert lanes * (chunk | 1) <= plant_block.POP_FLOATS


def test_plant_block_launch_shape_refusals():
    with pytest.raises(ValueError, match="n_sm"):
        plant_block.choose_lanes(0, 132)
    with pytest.raises(ValueError, match="lanes"):
        plant_block.pop_chunk(48, 30, 14)
    with pytest.raises(ValueError, match="n_ticks"):
        plant_block.pop_chunk(32, 30, 0)


def test_holt_winters_variant_refuses_bad_period_and_copy_width():
    with pytest.raises(ValueError, match="period"):
        holt_winters.choose_variant(0)
    y = torch.zeros(4 * 8 + 1)
    assert holt_winters.vec16(8, y[:32].view(4, 8))
    assert not holt_winters.vec16(8, y[1:].view(4, 8))   # 4-B offset
    assert not holt_winters.vec16(7, y[:28].view(4, 7))  # T % 4 != 0


@pytest.mark.parametrize("width,want", [(3, "generic"), (59, "generic"),
                                        (60, "w60"), (61, "generic"),
                                        (64, "generic"), (65, "wide"),
                                        (120, "wide"), (1024, "wide")])
def test_window_features_variant_by_width(width, want):
    """Only W = 60 takes the kernel compiled for it, whose FFT plan
    (csrc/kernels.h kW60Plan) is the plan the launcher hands over."""
    assert f"kW60 = {window_features.W60};" in _KERNELS_H
    plan = features.fft_tables(60, torch.device("cpu"))[1]
    compiled = ", ".join(f"{{{ip}, {l1}, {ido}}}" for ip, l1, ido in zip(
        plan[0::4], plan[1::4], plan[2::4]))
    assert f"kW60Plan[kW60Passes][3] = {{{compiled}}};" in _KERNELS_H
    assert window_features.choose_variant(width) == want


def test_window_features_variant_codes_and_limits():
    """The launcher's variants are csrc/kernels.h's WfVariant, in order;
    the generic variant's local arrays (kMaxWindow) and the wide variant's
    widest window (kMaxWideWindow, the plain version's MAX_TERMS) are the
    launcher's limits, and a forced variant that does not take the width
    is refused."""
    assert ("enum WfVariant { kWfW60 = 0, kWfGeneric = 1, kWfWide = 2 };"
            in _KERNELS_H)
    assert window_features.VARIANTS == ("w60", "generic", "wide")
    assert f"kMaxWindow = {window_features.GENERIC_MAX_W};" in _KERNELS_H
    assert f"kMaxWideWindow = {window_features.MAX_W};" in _KERNELS_H
    assert window_features.MAX_W == _numerics.MAX_TERMS
    assert window_features.check_variant("wide", 3) == 2
    assert window_features.check_variant("generic", 64) == 1
    assert window_features.check_variant("w60", 60) == 0
    for variant, width in (("generic", 65), ("w60", 59), ("bogus", 60)):
        with pytest.raises(ValueError, match="variant"):
            window_features.check_variant(variant, width)


def test_reclassify_wrapper_rejects_cpu_tensors():
    """The pre-pass's reclassification launches its kernels or raises: it
    refuses CPU rates and counts no launch; the pre-pass takes the
    history lengths from the trend's 30 minutes to the widest
    window_features kernel."""
    cls = Classify(_tiny_port_gbdt()[1], BetaCalibration(
        *(torch.zeros(4) for _ in range(3))))
    before = policy_signals.reclassify_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        policy_signals.reclassify_cuda(torch.ones(2, 30), cls, 10, 60)
    assert policy_signals.reclassify_cuda.launches == before
    assert (policy_signals.MIN_HISTORY, policy_signals.MAX_HISTORY) == (
        30, window_features.MAX_W)


def _tiny_port_gbdt():
    """The reference's tiny GBDT (tests/test_kernel_smoke.py) and its
    port."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(96, 38)).astype(np.float32)
    y = rng.integers(0, 4, 96).astype(np.int32)
    params = ref_gbdt.fit(X, y, ref_gbdt.GBDTConfig(n_rounds=4, depth=3))
    return params, t_gbdt.from_arrays(
        *(np.asarray(a) for a in (params.feat, params.thresh, params.leaf,
                                  params.bin_edges, params.base)),
        device="cpu")


def test_window_features_ref_matches_reference_kernel():
    """Torch plain version vs the reference Pallas kernel in interpret
    mode, all-zero and spike windows included (rtol/atol 5e-4,
    test_kernel_smoke.py)."""
    rng = np.random.default_rng(42)
    x = rng.gamma(2.0, 10.0, size=(8, 60)).astype(np.float32)
    x[0, :] = 0.0
    x[4, 30] = 1e5
    want = ref_ops.window_features(jnp.asarray(x), tile_n=8, interpret=True)
    got = ref.window_features_ref(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4,
                               atol=5e-4)


def test_gbdt_logits_ref_matches_reference_kernel():
    """Torch plain version vs the reference Pallas kernel in interpret
    mode: argmax exact, logits to 4 ulp of the largest."""
    params, port = _tiny_port_gbdt()
    X = np.random.default_rng(23).normal(size=(37, 38)).astype(np.float32)
    want = np.asarray(ref_ops.gbdt_logits(params, jnp.asarray(X), tile_n=16,
                                          interpret=True))
    got = ref.gbdt_logits_ref(port, torch.as_tensor(X)).numpy()
    ulp = np.spacing(np.abs(want).max().astype(np.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * ulp)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_aapa_episode_ref_matches_reference_kernel():
    """Torch plain AAPA episode vs the reference Pallas episode kernel in
    interpret mode, which reclassifies inside: the tiny GBDT with a beta
    calibration, 5 lanes, ci=30, stride 2."""
    params, port = _tiny_port_gbdt()
    raw = [np.float32([0.3, 0.5, 0.7, 0.9]), np.float32([0.6, 0.4, 0.2, 0.1]),
           np.float32([0.1, -0.2, 0.0, 0.3])]
    ref_classify = ref_pipeline.TrainedAAPA(
        params, ref_cal.BetaCalibration(*map(jnp.asarray, raw)), 0.0, 0.0,
        0.0, np.zeros(4), 96, 0.0).make_classify()
    rates = np.random.default_rng(5).uniform(0.0, 200.0, (5, 6)).astype(
        np.float32)
    rcfg = ref_cluster.SimConfig(control_interval_sec=30)
    want = ref_ops.episode_block(
        jnp.asarray(rates), ref_registry.make(
            "aapa", rcfg, classify=ref_classify, stride_min=2),
        rcfg, tile_b=4, interpret=True)
    cfg = t_cluster.SimConfig(control_interval_sec=30)
    classify = Classify(port, BetaCalibration(*map(torch.as_tensor, raw)))
    ctrl = t_registry.make("aapa", cfg, classify=classify, stride_min=2)
    got = ref.episode_block_ref(torch.as_tensor(rates), ctrl, cfg)
    _close(got, want, EPISODE_TOL, "MinuteOut")


def test_plain_aapa_episode_classifies_through_plain_logits():
    """The plain AAPA episode rebuilds its controller on the classifier's
    plain logits (`ref.gbdt_logits_ref`), so on the card it launches no
    `gbdt_tables` kernel; the rebuilt controller keeps every
    hyperparameter and classifies alike."""
    port = _tiny_port_gbdt()[1]
    raw = [torch.tensor([0.3, 0.5, 0.7, 0.9]),
           torch.tensor([0.6, 0.4, 0.2, 0.1]),
           torch.tensor([0.1, -0.2, 0.0, 0.3])]
    classify = Classify(port, BetaCalibration(*raw))
    cfg = t_cluster.SimConfig(control_interval_sec=30)
    ctrl = t_registry.make("aapa", cfg, classify=classify, stride_min=2,
                           horizon_min=5, forecast_confidence=True)
    plain = ref._plain_controller(ctrl, cfg)
    assert plain.hyper["classify"].logits is ref.gbdt_logits_ref
    assert classify.logits is None
    for k in ("stride_min", "horizon_min", "forecaster",
              "forecast_confidence"):
        assert plain.hyper[k] == ctrl.hyper[k]
    X = torch.as_tensor(np.random.default_rng(6).normal(
        size=(9, 38)).astype(np.float32))
    for a, e in zip(plain.hyper["classify"](X), classify(X)):
        assert torch.equal(a, e)
    hpa = t_registry.make("hpa", cfg)
    assert ref._plain_controller(hpa, cfg) is hpa
    rates = torch.as_tensor(np.random.default_rng(7).uniform(
        0.0, 200.0, (3, 8)).astype(np.float32))
    for a, e in zip(ref.episode_block_ref(rates, ctrl, cfg),
                    t_cluster.simulate(rates, ctrl, cfg, device="cpu",
                                       plant_kernel=False,
                                       decide_kernel=False)):
        assert torch.equal(a, e)
