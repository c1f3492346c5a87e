"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test carries the ``requires_cuda`` marker and skips inside
the ``cuda`` fixture when there is no card (the kernels have no CPU
mode). This file imports neither JAX nor the JAX package, so it runs on
the GPU machine as it is:

    python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import calibration, features, gbdt
from repro_torch.core.pipeline import Classify
from repro_torch.data import azure_synth, windows
from repro_torch.forecast import conformal
from repro_torch.forecast import registry as forecast_registry
from repro_torch.kernels import (episode_block, gbdt_tables, holt_winters,
                                 ops, plant_block, policy_signals, ref,
                                 window_features)
from repro_torch.scaling import registry, scenarios
from repro_torch.sim import cluster

PLANT_TOL = dict(rtol=1e-5, atol=1e-5)
EPISODE_TOL = dict(rtol=3e-6, atol=1e-4)

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    """Decided per test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _plant_state(rng, b, s, dev):
    pipeline = rng.gamma(1.0, 0.6, (b, s)).astype(np.float32)
    return [torch.as_tensor(np.asarray(c, np.float32), device=dev)
            for c in (rng.gamma(2.0, 2.0, b), pipeline,
                      rng.gamma(1.0, 25.0, b), rng.gamma(1.0, 5.0, b),
                      rng.random(b), rng.uniform(0.0, 20.0, b),
                      pipeline.sum(axis=1), rng.gamma(2.0, 30.0, b))]


def _rates(seed, dev, w=257, m=12):
    rng = np.random.default_rng(seed)
    rates = rng.uniform(0.0, 3000.0, (w, m)).astype(np.float32)
    rates[::3, 4:] = 0.0                   # scale-downs and scale-to-zero
    return torch.as_tensor(rates, device=dev)


@pytest.mark.parametrize("b,s,n_ticks,chunks", [
    (1003, 30, 14, 1), (1003, 30, 29, 1), (1003, 30, 3, 1),
    (1, 30, 14, 1), (31, 30, 14, 1), (33, 30, 14, 1), (1024, 30, 14, 1),
    (257, 1, 14, 1), (257, 9, 14, 1), (257, 14, 14, 1), (257, 30, 1, 1),
    (17_000, 100, 70, 2), (1003, 300, 260, 2)])
def test_plant_block_kernel_matches_plain(cuda, b, s, n_ticks, chunks):
    """Bit for bit with the plain version and with the per-thread kernel
    it replaced: ragged blocks of 32, 64 and 128 lanes, S = 1, S < T,
    S = T, S > T, T = 1, and popped slots staged in more than one chunk
    (17,000 lanes take blocks of 128, 1,003 blocks of 32)."""
    state = _plant_state(np.random.default_rng(b + s + n_ticks), b, s, cuda)
    launcher = plant_block.plant_tick_block_cuda
    before = launcher.launches
    got = launcher(*state, n_ticks=n_ticks)
    lanes = plant_block.choose_lanes(
        b, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert launcher.last_variant == f"staged/{lanes} lanes/{chunks} chunks"
    old = launcher(*state, n_ticks=n_ticks, variant="per_thread")
    assert launcher.last_variant == "per_thread"
    want = ref.plant_block_ref(*state, n_ticks=n_ticks)
    torch.cuda.synchronize()
    assert launcher.launches == before + 2
    for a, o, e in zip((*got[0], *got[1]), (*old[0], *old[1]),
                       (*want[0], *want[1])):
        torch.testing.assert_close(a, e, **PLANT_TOL)
        assert torch.equal(a, e) and torch.equal(a, o)


@pytest.mark.parametrize("ci", [15, 7])
def test_episode_block_kernel_matches_plain(cuda, ci):
    cfg = cluster.SimConfig(control_interval_sec=ci)
    ctrl = registry.make("hpa", cfg)
    rates = _rates(ci, cuda)
    got = episode_block.episode_block_cuda(rates, ctrl, cfg)
    want = ref.episode_block_ref(rates, ctrl, cfg)
    torch.cuda.synchronize()
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, **EPISODE_TOL)


def test_default_path_is_the_episode_kernel(cuda):
    """`make_simulator` on its default device launches one episode kernel
    per chunk (after one pre-pass per chunk for AAPA), and chunking
    changes no bit."""
    cfg = cluster.SimConfig()
    rates = _rates(1, cuda, w=256)
    for name, pre in (("hpa", 0), ("aapa", 4)):
        ctrl = registry.make(name, cfg)
        ops.reset_launch_counts()
        chunked = cluster.make_simulator(ctrl, cfg, w_chunk=64)(rates)
        assert ops.launch_counts() == {"plant_block": 0, "episode_block": 4,
                                       "policy_signals": pre,
                                       "window_features": 0,
                                       "gbdt_tables": 0, "holt_winters": 0}
        whole = cluster.make_simulator(ctrl, cfg)(rates)
        for a, b in zip(chunked, whole):
            assert torch.equal(a, b)


def test_unfused_path_launches_plant_block(cuda):
    cfg = cluster.SimConfig()
    ctrl = registry.make("hpa", cfg)
    rates = _rates(2, cuda, w=64, m=5)
    ops.reset_launch_counts()
    unfused = cluster.simulate(rates, ctrl, cfg, decide_kernel=False)
    assert ops.launch_counts() == {"plant_block": 5 * 4, "episode_block": 0,
                                   "policy_signals": 0,
                                   "window_features": 0, "gbdt_tables": 0,
                                   "holt_winters": 0}
    fused = cluster.simulate(rates, ctrl, cfg)
    for a, e in zip(unfused, fused):
        torch.testing.assert_close(a, e, **EPISODE_TOL)


def test_unknown_policy_raises(cuda):
    cfg = cluster.SimConfig()
    ctrl = registry.make("hpa", cfg)._replace(name="no_such_policy")
    with pytest.raises(NotImplementedError, match="compiled"):
        episode_block.episode_block_cuda(_rates(3, cuda), ctrl, cfg)


def _windows(dev, n=2000):
    ds = windows.make_windows(azure_synth.generate_traces(
        n_functions=8, n_days=2, seed=0))
    x = np.concatenate([ds.windows[:n], np.zeros((1, 60), np.float32),
                        np.full((1, 60), 5.0, np.float32)])
    return torch.as_tensor(x, device=dev)


def _classifier(dev, seed=0, rounds=60, depth=4):
    """A seeded GBDT at the paper's size whose edges are quantiles of the
    port's own features, and a beta calibration."""
    rng = np.random.default_rng(seed)
    feats = features.extract_features(_windows(dev)).cpu().numpy()
    K, I = 4, 2 ** depth - 1
    params = gbdt.from_arrays(
        rng.integers(0, 38, (rounds, K, I)), rng.integers(0, 63,
                                                          (rounds, K, I)),
        rng.normal(0.0, 0.2, (rounds, K, I + 1)),
        gbdt.compute_bin_edges(feats, 64),
        np.log(np.float32([0.4, 0.2, 0.3, 0.1])), device=dev)
    cal = calibration.from_arrays(rng.normal(0.5, 0.2, 4),
                                  rng.normal(0.5, 0.2, 4),
                                  rng.normal(0.0, 0.2, 4), device=dev)
    return Classify(params, cal)


def _edge_windows(dev, width: int, n: int = 300):
    """AAPAset-like windows of `width` minutes, then windows with ties, a
    constant, all zeros and single spikes: n + 19 windows, 319 by
    default, not a multiple of the 64-window block."""
    rng = np.random.default_rng(width)
    real = windows.make_windows(azure_synth.generate_traces(
        n_functions=8, n_days=2, seed=0), window=width).windows[:n]
    ties = rng.integers(0, 3, (4, width)).astype(np.float32)
    spikes = np.zeros((12, width), np.float32)
    spikes[np.arange(12), rng.integers(0, width, 12)] = np.float32(1e5)
    spikes[6:] += np.float32(2.0)
    edge = np.stack([np.full(width, 3.0, np.float32),
                     np.zeros(width, np.float32)])
    x = np.concatenate([real, ties, edge, spikes, ties[:1]])
    return torch.as_tensor(x, device=dev)


def _window_features_plain(x, freq, monkeypatch):
    """The plain version; below W = 30 (where ``core.features._acf`` has a
    lag past the window and raises) each such autocorrelation is the empty
    sum 0, as the TPU kernel and the CUDA kernels take it."""
    acf = features._acf
    monkeypatch.setattr(features, "_acf", lambda xc, var, lag: (
        acf(xc, var, lag) if lag <= xc.shape[-1] else torch.zeros_like(var)))
    return (ref.extract_features_ref if freq else ref.window_features_ref)(x)


#: widths past the generic kernel's 64 samples: the wide kernel's (211:
#: ducc0 takes Bluestein's algorithm there, the port its generic pass)
WIDE_WIDTHS = (65, 72, 90, 120, 211, 360, 1024)


@pytest.mark.parametrize("width,freq", [(w, f) for w in (*range(3, 65),
                                                         *WIDE_WIDTHS)
                                        for f in (False, True)
                                        if w >= 4 or not f])
def test_window_features_kernel_matches_plain(cuda, width, freq,
                                              monkeypatch):
    """The 28 features, and with `freq` all 38 (the classification path's
    launch, `ops.extract_features_fused`), bit for bit at every width the
    kernel takes up to 64 and at widths past it: the W = 60 kernel at 60,
    the generic one elsewhere up to 64 (and at 60 too), the wide one above
    64 (and, forced, at every width); ties, constant, zero and spike
    windows."""
    x = _edge_windows(cuda, width)
    want = _window_features_plain(x, freq, monkeypatch)
    launcher = window_features.window_features_cuda
    before = launcher.launches
    got = launcher(x, freq=freq)
    torch.cuda.synchronize()
    assert launcher.launches == before + 1
    assert launcher.last_variant == window_features.choose_variant(width)
    assert launcher.last_variant == ("w60" if width == 60 else "generic"
                                     if width <= 64 else "wide")
    assert torch.equal(got, want)
    if freq:
        assert torch.equal(ops.extract_features_fused(x), got)
    if width == window_features.W60:
        assert torch.equal(launcher(x, freq=freq, variant="generic"), want)
    if width <= window_features.GENERIC_MAX_W:
        assert torch.equal(launcher(x, freq=freq, variant="wide"), want)
        assert launcher.last_variant == "wide"


def test_window_features_variant_limits(cuda):
    """The generic kernel's local arrays hold 64 samples and the wide
    kernel takes up to 1,024 (the plain version's XLA-order sums stop
    there too): anything else raises before a launch."""
    launcher = window_features.window_features_cuda
    before = launcher.launches
    x = torch.ones((3, 65), device=cuda)
    with pytest.raises(ValueError, match="generic"):
        launcher(x, variant="generic")
    with pytest.raises(ValueError, match="w60"):
        launcher(x, variant="w60")
    with pytest.raises(ValueError, match="1024"):
        launcher(torch.ones((3, 1025), device=cuda))
    assert launcher.launches == before


@pytest.mark.parametrize("freq", [False, True])
def test_window_features_w60_keeps_nan_windows_as_generic(cuda, freq):
    """Windows holding NaN: the W = 60 kernel gives what the generic
    kernel (the insertion sort, fminf / fmaxf) gives, NaN for NaN."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 4, (200, 60)).astype(np.float32)
    for i in range(200):
        x[i, rng.integers(0, 60, 1 + i % 5)] = np.nan
    x[0] = np.nan
    x = torch.as_tensor(x, device=cuda)
    got = window_features.window_features_cuda(x, freq=freq, variant="w60")
    want = window_features.window_features_cuda(x, freq=freq,
                                                variant="generic")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0.0, atol=0.0,
                               equal_nan=True)


def _insertion_sorted(row: np.ndarray) -> np.ndarray:
    """What an insertion sort with `>` leaves: each NaN where it is, each
    NaN-free run between them sorted on its own, stably."""
    out, start = row.copy(), 0
    for end in [*np.flatnonzero(np.isnan(row)), row.size]:
        out[start:end] = np.sort(row[start:end], kind="stable")
        start = end + 1
    return out


@pytest.mark.parametrize("width", [45, 64, 65, 120, 1024])
def test_window_features_wide_keeps_insertion_sort_order(cuda, width):
    """Windows holding NaN, mixed +-0 and +-inf: the wide kernel's median,
    q25 and q75 are the order statistics an insertion sort leaves (NaN in
    place, each NaN-free run sorted on its own), NaN for NaN and -0 equal
    to +0; up to 64 samples all 38 features equal the generic kernel's."""
    rng = np.random.default_rng(width)
    x = rng.integers(0, 4, (130, width)).astype(np.float32)
    for i in range(100):
        x[i, rng.integers(0, width, 1 + i % 7)] = np.nan
    x[0] = np.nan
    x[100:110] = rng.choice(np.float32([0.0, -0.0, 1.0]), (10, width))
    x[110:120] = rng.choice(np.float32([0.0, -0.0, np.inf, -np.inf]),
                            (10, width))
    x[120:125, :2] = np.nan
    x[125:, -1] = np.nan
    want = np.empty((x.shape[0], 3), np.float32)
    for row, w in zip(x, want):
        xs = _insertion_sorted(row)
        for k, q in enumerate((0.5, 0.25, 0.75)):
            pos = q * (width - 1)
            lo = int(np.floor(pos))
            hi = min(lo + 1, width - 1)
            wt = np.float32(pos) - np.float32(lo)
            with np.errstate(invalid="ignore"):  # inf * 0 is NaN here too
                w[k] = xs[lo] * (np.float32(1.0) - wt) + xs[hi] * wt
    x = torch.as_tensor(x, device=cuda)
    launcher = window_features.window_features_cuda
    for freq in (False, True):
        got = launcher(x, freq=freq, variant="wide")
        torch.cuda.synchronize()
        torch.testing.assert_close(got[:, 5:8].cpu(), torch.as_tensor(want),
                                   rtol=0.0, atol=0.0, equal_nan=True)
        if width <= window_features.GENERIC_MAX_W:
            torch.testing.assert_close(
                got, launcher(x, freq=freq, variant="generic"), rtol=0.0,
                atol=0.0, equal_nan=True)


GBDT_CASES = {
    # name: (features, edges, rounds, classes, depth, rows)
    "paper": (38, 63, 60, 4, 4, 2002),
    "thresholds": (38, 63, 60, 4, 4, 1001),
    "dup_edges": (38, 63, 60, 4, 4, 1001),
    "special_features": (38, 63, 60, 4, 4, 1001),
    "depth1": (38, 63, 60, 4, 1, 1001),
    "depth6": (38, 63, 20, 4, 6, 1001),
    "k1": (38, 63, 60, 1, 4, 1001),
    "k16": (38, 63, 12, 16, 4, 1001),
    "n1": (38, 63, 60, 4, 4, 1),
    "ragged_n": (38, 63, 60, 4, 4, 385),
    "generic": (38, 63, 60, 4, 6, 1001),
}


def _gbdt_case(dev, name):
    """A seeded ensemble and rows for one GBDT_CASES entry: thresholds in
    [0, E) (-1, 0, E - 1, E and E + 7 for "thresholds"), non-decreasing
    edges (runs of equal edges for "dup_edges"), and rows with NaN, +-0,
    +-inf and values equal to an edge (40% of them for
    "special_features", 10% elsewhere). "paper" is the port's features of
    AAPAset-like windows through `_classifier`."""
    F, E, rounds, K, depth, N = GBDT_CASES[name]
    if name == "paper":
        cls = _classifier(dev)
        X = features.extract_features(_windows(dev))
        X[0, :3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
        return cls.params, X
    rng = np.random.default_rng(sorted(GBDT_CASES).index(name))
    edges = gbdt.compute_bin_edges(rng.normal(size=(2000, F)), E + 1)
    if name == "dup_edges":
        edges[:, 10:20] = edges[:, 10:11]
        edges[:, 40:] = edges[:, -1:]
    n_int = 2 ** depth - 1
    thresh = (rng.choice(np.array([-1, 0, E - 1, E, E + 7]),
                         (rounds, K, n_int)) if name == "thresholds"
              else rng.integers(0, E, (rounds, K, n_int)))
    params = gbdt.from_arrays(
        rng.integers(0, F, (rounds, K, n_int)), thresh,
        rng.normal(0.0, 0.2, (rounds, K, n_int + 1)), edges,
        rng.normal(0.0, 1.0, K), device=dev)
    X = rng.normal(size=(N, F)).astype(np.float32)
    u = rng.random((N, F))
    share = 0.2 if name == "special_features" else 0.05
    special = np.float32([np.nan, 0.0, -0.0, np.inf, -np.inf])
    X[u < share] = rng.choice(special, int((u < share).sum()))
    at = (u >= share) & (u < 2 * share)
    X[at] = edges[np.nonzero(at)[1], rng.integers(0, E, int(at.sum()))]
    return params, torch.as_tensor(X, device=dev)


@pytest.mark.parametrize("name", sorted(GBDT_CASES))
def test_gbdt_tables_kernel_matches_plain(cuda, name):
    """Bit for bit with the plain version in the variant the launcher
    chooses, and in both variants where the tables fit shared memory:
    thresholds past either end, equal edges, NaN / +-0 / +-inf features
    and features equal to an edge, depth 1 and 6, K = 1 and 16, N = 1 and
    N not a multiple of the 384-row tile, and an ensemble too large for
    shared memory ("generic", 240 trees of depth 6)."""
    params, X = _gbdt_case(cuda, name)
    nbytes = gbdt_tables.shared_table_bytes(params.tables.feat.shape[0],
                                            params.depth)
    chosen = gbdt_tables.choose_variant(nbytes)
    assert (chosen == "generic") == (name == "generic")
    launcher = gbdt_tables.gbdt_logits_cuda
    before = launcher.launches
    got = launcher(params, X)
    assert launcher.last_variant == chosen
    want = ref.gbdt_logits_ref(params, X)
    variants = ["shared", "generic"] if chosen == "shared" else ["generic"]
    others = [launcher(params, X, variant=v) for v in variants]
    torch.cuda.synchronize()
    assert launcher.launches == before + 1 + len(variants)
    assert torch.equal(got, want)
    for other in others:
        assert torch.equal(other, want)


@pytest.mark.parametrize("ci,stride,fc_conf", [(15, 10, False),
                                               (7, 2, False),
                                               (15, 5, True)])
def test_aapa_episode_kernel_matches_plain(cuda, ci, stride, fc_conf):
    cfg = cluster.SimConfig(control_interval_sec=ci)
    ctrl = registry.make("aapa", cfg, classify=_classifier(cuda),
                         stride_min=stride, forecast_confidence=fc_conf)
    rates = torch.as_tensor(scenarios.archetype_mix(
        n_workloads=129, minutes=90, seed=1).rates, device=cuda)
    got, got_arch = episode_block.aapa_episode_cuda(rates, ctrl, cfg)
    ops.reset_launch_counts()
    want, want_arch = ref.aapa_episode_ref(rates, ctrl, cfg)
    torch.cuda.synchronize()
    # the plain episode classifies through the plain GBDT: no kernel
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCHERS, 0)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, **EPISODE_TOL)
    assert torch.equal(got_arch, want_arch)
    assert len(torch.unique(want_arch)) >= 3
    # without the archetype output the kernel computes the same episode
    for a, e in zip(episode_block.episode_block_cuda(rates, ctrl, cfg), got):
        assert torch.equal(a, e)


def test_aapa_default_classifier_kernel_matches_plain(cuda):
    cfg = cluster.SimConfig()
    ctrl = registry.make("aapa", cfg)
    rates = _rates(4, cuda, m=40)
    got = episode_block.episode_block_cuda(rates, ctrl, cfg)
    want = ref.episode_block_ref(rates, ctrl, cfg)
    torch.cuda.synchronize()
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, **EPISODE_TOL)


#: registry forecasters other than Holt-Winters, at their defaults and at
#: a window over 32 (XLA's chunked sum), a period shorter than the
#: 15-minute horizon (phases wrap) and an alpha off the default
FORECASTER_CASES = [("linear_trend", {}), ("linear_trend", dict(window=45)),
                    ("seasonal_naive", {}), ("seasonal_naive",
                                             dict(period=7)),
                    ("ewma", {}), ("ewma", dict(alpha=0.37))]
FORECASTER_IDS = ["lt", "lt45", "sn", "sn7", "ewma", "ewma37"]


def _forecaster_controller(policy, fname, fkw, cfg, dev):
    """`policy` on the forecaster `fname` (hyperparameters `fkw`):
    predictive, predictive conservative with the native band, AAPA with
    the seeded GBDT every 5 minutes and the forecast confidence on
    (native band), hybrid with the GBDT and the conformal band."""
    fcst = forecast_registry.make(fname, **fkw)
    kw = {"predictive": {},
          "conservative": dict(conservative=True),
          "aapa": dict(classify=_classifier(dev), stride_min=5,
                       forecast_confidence=True),
          "hybrid": dict(classify=_classifier(dev), band=_band(dev))}[policy]
    return registry.make("predictive" if policy == "conservative" else policy,
                         cfg, forecaster=fcst, **kw)


@pytest.mark.parametrize("ci,b,m", [(15, 33, 121), (30, 1000, 61),
                                    (7, 1, 90)])
@pytest.mark.parametrize("fname,fkw", FORECASTER_CASES, ids=FORECASTER_IDS)
@pytest.mark.parametrize("policy", ["predictive", "conservative", "aapa",
                                    "hybrid"])
def test_forecaster_episode_kernel_matches_plain(cuda, policy, fname, fkw,
                                                 ci, b, m):
    """Every registry forecaster's minute walk in the episode, bit for bit
    against the plain episode, at lane counts that are not a multiple of
    the block and minute counts that are not a multiple of the tile, with
    AAPA's and hybrid's archetypes exact."""
    cfg = cluster.SimConfig(control_interval_sec=ci)
    ctrl = _forecaster_controller(policy, fname, fkw, cfg, cuda)
    rates = torch.as_tensor(scenarios.archetype_mix(
        n_workloads=b, minutes=m, seed=b + m).rates, device=cuda)
    before = policy_signals.policy_signals_cuda.launches
    if ctrl.name in episode_block.ARCHETYPE_POLICIES:
        got, got_arch = episode_block.aapa_episode_cuda(rates, ctrl, cfg)
        want, want_arch = ref.aapa_episode_ref(rates, ctrl, cfg)
        assert torch.equal(got_arch, want_arch)
    else:
        got = episode_block.episode_block_cuda(rates, ctrl, cfg)
        want = ref.episode_block_ref(rates, ctrl, cfg)
    torch.cuda.synchronize()
    assert policy_signals.policy_signals_cuda.launches == before + 1
    for a, e in zip(got, want):
        assert torch.equal(a, e)


@pytest.mark.parametrize("fname,fkw", FORECASTER_CASES, ids=FORECASTER_IDS)
@pytest.mark.parametrize("policy", ["conservative", "aapa"])
def test_forecaster_signals_kernel_matches_plain(cuda, policy, fname, fkw):
    """The new minute walks against `policy_signals_ref`, bit for bit:
    every per-minute signal, slot and per-minute archetype; 293 lanes x
    97 minutes."""
    cfg = cluster.SimConfig()
    ctrl = _forecaster_controller(policy, fname, fkw, cfg, cuda)
    rates = torch.as_tensor(scenarios.archetype_mix(
        n_workloads=293, minutes=97, seed=3).rates, device=cuda)
    arch = ctrl.name == "aapa"
    got = policy_signals.policy_signals_cuda(rates, ctrl, cfg,
                                             minute_arch=arch)
    want = ref.policy_signals_ref(rates, ctrl, cfg, minute_arch=arch)
    torch.cuda.synchronize()
    for name, a, e in zip(policy_signals.Signals._fields, got, want):
        assert (a is None) == (e is None), name
        assert a is None or torch.equal(a, e), name


def test_aapa_kernel_rejects_bare_callable_classify(cuda):
    """A classify that is neither core.pipeline.Classify nor the
    registry's default_classify cannot be compiled into the pre-pass: the
    launcher raises, it never falls back to the plain path."""
    cfg = cluster.SimConfig()
    for policy in ("aapa", "hybrid"):
        ctrl = registry.make(policy, cfg, classify=lambda f: (
            torch.zeros(f.shape[:-1], dtype=torch.int32, device=f.device),
            torch.full(f.shape[:-1], 0.9, device=f.device)))
        with pytest.raises(NotImplementedError, match="Classify"):
            episode_block.episode_block_cuda(_rates(5, cuda), ctrl, cfg)


def test_aapa_kernel_rejects_other_history_len(cuda):
    """The pre-pass's minute walks read the last 30 minutes of the
    history for the trend, and the widest feature window is 1,024
    minutes: an AAPA or hybrid episode on a `history_len` outside [30,
    1024] raises before any launch, and never falls back to the plain
    path."""
    for history_len in (29, 1025):
        cfg = cluster.SimConfig(history_len=history_len)
        for policy in ("aapa", "hybrid"):
            before = ops.launch_counts()
            with pytest.raises(NotImplementedError, match="history_len"):
                episode_block.episode_block_cuda(
                    _rates(5, cuda), registry.make(policy, cfg), cfg)
            assert ops.launch_counts() == before


@pytest.mark.parametrize("history_len", [45, 90, 120, 211, 1024])
@pytest.mark.parametrize("policy", ["aapa", "hybrid"])
def test_aapa_kernel_at_other_history_len(cuda, policy, history_len):
    """AAPA and hybrid on a rate history of 45, 90, 120, 211 (an FFT of
    one odd pass) and 1,024 minutes: the pre-pass reclassifies on the
    generic (45) or the wide (the others) window_features kernel, bit for
    bit with `policy_signals_ref`, and the
    fused episode equals its plain episode bit for bit, archetypes
    included; 293 lanes x 150 minutes, reclassifying every 10."""
    cfg = cluster.SimConfig(history_len=history_len)
    kw = dict(classify=_classifier(cuda), forecast_confidence=True)
    if policy == "hybrid":
        kw["band"] = _band(cuda)
    ctrl = registry.make(policy, cfg, **kw)
    rates = torch.as_tensor(scenarios.archetype_mix(
        n_workloads=293, minutes=150, seed=history_len).rates, device=cuda)
    ops.reset_launch_counts()
    got = policy_signals.policy_signals_cuda(rates, ctrl, cfg,
                                             minute_arch=True)
    assert policy_signals.reclassify_cuda.launches == 1
    assert policy_signals.reclassify_cuda.last_variant == (
        "generic" if history_len <= 64 else "wide")
    want = ref.policy_signals_ref(rates, ctrl, cfg, minute_arch=True)
    torch.cuda.synchronize()
    for name, a, e in zip(policy_signals.Signals._fields, got, want):
        assert torch.equal(a, e), name
    assert len(torch.unique(want.arch)) >= 3
    out, arch = episode_block.aapa_episode_cuda(rates, ctrl, cfg)
    want_out, want_arch = ref.aapa_episode_ref(rates, ctrl, cfg)
    torch.cuda.synchronize()
    assert torch.equal(arch, want_arch)
    for a, e in zip(out, want_out):
        assert torch.equal(a, e)


@pytest.mark.parametrize("history_len,stride,depth", [
    (60, 10, 4), (60, 2, 4), (60, 10, 6), (45, 10, 4), (90, 7, 4),
    (120, 10, 6), (211, 10, 4), (1024, 30, 4)])
def test_reclassify_kernel_matches_plain(cuda, history_len, stride, depth):
    """The pre-pass's reclassifications (window_features on windows read
    in place from the rates, gbdt_tables, the calibration kernel) against
    `reclassify_ref` bit for bit: archetype and confidence of every lane
    and slot; the paper's ensemble (tables in shared memory) and a
    depth-6 one (the generic GBDT kernel); 293 lanes (not a multiple of
    any block) x 1,100 minutes, windows from the zero history before
    minute 0 to well inside the rates."""
    cls = _classifier(cuda, depth=depth)
    rates = torch.as_tensor(scenarios.archetype_mix(
        n_workloads=293, minutes=1100, seed=depth).rates, device=cuda)
    launcher = policy_signals.reclassify_cuda
    before = launcher.launches
    arch, conf = launcher(rates, cls, stride, history_len)
    assert launcher.launches == before + 1
    assert launcher.last_variant == window_features.choose_variant(
        history_len)
    assert arch.shape == (293, 1100 // stride)
    ops.reset_launch_counts()
    want_arch, want_conf = ref.reclassify_ref(rates, cls, stride,
                                              history_len)
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCHERS, 0)
    assert torch.equal(arch, want_arch)
    assert torch.equal(conf, want_conf)
    assert len(torch.unique(want_arch)) >= 3


def _probe_tool():
    """tools/probe_binding_errors.py, whose cases the test runs."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / \
        "probe_binding_errors.py"
    spec = importlib.util.spec_from_file_location("probe_binding_errors",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("case", ["bad_rank", "bad_shape", "bad_size",
                                  "oversize_shared_memory"])
def test_binding_errors_raise_runtime_error(cuda, case):
    """A binding called directly with a tensor of the wrong rank or shape,
    an out-of-range size or a plant pass whose shared memory does not fit
    raises RuntimeError in the calling process, not a signal (the shape
    and shared-memory checks compose their messages: binding.cpp's
    REQUIRE). Each call runs in a subprocess
    (``tools/probe_binding_errors.py``), so that a crash fails this test
    alone."""
    from pathlib import Path
    tool = _probe_tool()
    proc = tool.probe(Path(__file__).resolve().parents[1], tool.CASES[case])
    assert proc.returncode == 0, (proc.returncode, proc.stdout,
                                  proc.stderr[-3000:])
    assert "(a RuntimeError)" in proc.stdout, proc.stdout


@pytest.mark.parametrize("case", ["other_card_output", "other_card_tables",
                                  "other_card_signals", "other_card_first"])
def test_binding_rejects_tensors_on_another_card(cuda, case):
    """An entry handed a tensor on another card than its first tensor's
    (an output, the GBDT tables, the pre-pass's signals, or the first
    tensor itself beside an output on the first card) raises RuntimeError
    naming both cards before it launches, not an illegal address. Needs
    two cards; each call in a subprocess, as above."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (a tensor on another card); "
                    f"this machine has {torch.cuda.device_count()}")
    from pathlib import Path
    tool = _probe_tool()
    proc = tool.probe(Path(__file__).resolve().parents[1],
                      tool.MISMATCH_CASES[case])
    assert proc.returncode == 0, (proc.returncode, proc.stdout,
                                  proc.stderr[-3000:])
    assert "(a RuntimeError)" in proc.stdout, proc.stdout
    assert "the launch's device is cuda:" in proc.stdout, proc.stdout


@pytest.mark.parametrize("b,t,period,alpha,variant,offset", [
    (1003, 300, 60, 0.1, None, 0), (257, 61, 60, 0.37, None, 0),
    (130, 500, 1440, 0.1, None, 0), (65, 100, 96, 0.33, None, 0),
    (64, 33, 97, 0.1, None, 0), (1, 1, 1, 0.1, None, 0),
    (130, 62, 60, 0.1, None, 0), (67, 63, 97, 0.2, None, 0),
    (129, 98, 96, 0.1, None, 0), (66, 101, 97, 0.1, None, 0),
    (70, 20, 60, 0.1, None, 0), (33, 7, 96, 0.1, None, 0),
    (5, 3, 2, 0.1, None, 0), (200, 64, 1, 0.1, None, 0),
    (131, 300, 60, 0.1, "global", 0), (3, 9, 1, 0.1, "global", 0),
    (100, 128, 60, 0.1, None, 1), (100, 128, 1440, 0.1, None, 1)])
def test_holt_winters_kernel_matches_plain(cuda, b, t, period, alpha,
                                           variant, offset):
    """Bit for bit: both variants either side of the shared-memory limit
    (period 96 / 97) and forced to global scratch at short periods; long
    seasons; alpha where hw_smooth's two roundings of 1 - alpha differ;
    T = 1, 2, 3 (mod 4) (4-B copies) and a 16-B-misaligned y (`offset`);
    ragged lane blocks and time tiles; T shorter than a tile and than the
    period."""
    rng = np.random.default_rng(b + t)
    y_np = rng.gamma(2.0, 50.0, (b, t)).astype(np.float32)
    y = torch.empty(b * t + offset, dtype=torch.float32, device=cuda)
    y = y[offset:].view(b, t)
    y.copy_(torch.as_tensor(y_np))
    before = holt_winters.holt_winters_cuda.launches
    got = holt_winters.holt_winters_cuda(y, period=period, alpha=alpha,
                                         variant=variant)
    want = ref.holt_winters_ref(y, period=period, alpha=alpha)
    torch.cuda.synchronize()
    assert holt_winters.holt_winters_cuda.launches == before + 1
    chosen = variant or holt_winters.choose_variant(period)
    wide = t % 4 == 0 and offset == 0
    assert holt_winters.holt_winters_cuda.last_variant == (
        f"{chosen}/{16 if wide else 4}B")
    assert torch.equal(got, want)


def test_conformal_path_on_the_card(cuda):
    """`calibrate` and `coverage` on a CUDA split launch the holt_winters
    kernel once each and give the plain path's band."""
    fcst = forecast_registry.make("holt_winters")
    split = torch.as_tensor(scenarios.burst_storm(
        n_workloads=300, minutes=400, seed=1).rates, device=cuda)
    ops.reset_launch_counts()
    band = conformal.calibrate(fcst, split, alpha=0.9)
    cov = conformal.coverage(fcst, band, split[:, 200:])
    assert ops.launch_counts()["holt_winters"] == 2
    plain = conformal.calibrate(fcst, split.cpu(), alpha=0.9, device="cpu")
    assert float(band.q) == float(plain.q)
    assert float(band.scale) == float(plain.scale)
    assert 0.0 < cov <= 1.0


def _band(dev):
    split = torch.as_tensor(scenarios.burst_storm(
        n_workloads=64, minutes=240, seed=1).rates, device=dev)
    return conformal.calibrate(forecast_registry.make("holt_winters"),
                               split, alpha=0.9)


def _wrapped(dev, widen=True):
    """Holt-Winters wrapped in the band, as a `forecaster=` argument."""
    return conformal.wrap(forecast_registry.make("holt_winters"), _band(dev),
                          widen_with_horizon=widen)


@pytest.mark.parametrize("ci", [15, 7])
@pytest.mark.parametrize("policy,kw", [
    ("predictive", {}), ("predictive", dict(conservative=True)),
    ("predictive", dict(band=True, conservative=True)),
    ("predictive", dict(forecaster="wrapped", conservative=True)),
    ("predictive", dict(forecaster="unwidened", conservative=True)),
    ("kpa", {}), ("kpa", dict(panic_threshold=1.2))],
    ids=["predictive", "conservative", "band", "wrapped", "unwidened", "kpa",
         "kpa_panicky"])
def test_policy_episode_kernel_matches_plain(cuda, policy, kw, ci):
    cfg = cluster.SimConfig(control_interval_sec=ci)
    if kw.get("band"):
        kw = dict(kw, band=_band(cuda))
    if kw.get("forecaster"):
        kw = dict(kw, forecaster=_wrapped(cuda, kw["forecaster"] == "wrapped"))
    ctrl = registry.make(policy, cfg, **kw)
    rates = torch.as_tensor(scenarios.archetype_mix(
        n_workloads=129, minutes=90, seed=1).rates, device=cuda)
    got = episode_block.episode_block_cuda(rates, ctrl, cfg)
    ops.reset_launch_counts()
    want = ref.episode_block_ref(rates, ctrl, cfg)
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCHERS, 0)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, **EPISODE_TOL)


@pytest.mark.parametrize("ci", [15, 7])
@pytest.mark.parametrize("wrapped", [False, True], ids=["band", "wrapped"])
@pytest.mark.parametrize("policy", ["aapa", "hybrid"])
def test_band_archetype_episode_kernel_matches_plain(cuda, policy, wrapped,
                                                     ci):
    """AAPA and hybrid with the conformal band (as `band=`, or as a
    wrapped forecaster with the forecast confidence on: the band's
    half-width, the point's scale) and the seeded classifier: MinuteOut
    and every lane's archetype sequence."""
    cfg = cluster.SimConfig(control_interval_sec=ci)
    kw = (dict(forecaster=_wrapped(cuda), forecast_confidence=True)
          if wrapped else dict(band=_band(cuda)))
    ctrl = registry.make(policy, cfg, classify=_classifier(cuda),
                         stride_min=5, **kw)
    rates = torch.as_tensor(scenarios.archetype_mix(
        n_workloads=129, minutes=90, seed=1).rates, device=cuda)
    got, got_arch = episode_block.aapa_episode_cuda(rates, ctrl, cfg)
    ops.reset_launch_counts()
    want, want_arch = ref.aapa_episode_ref(rates, ctrl, cfg)
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCHERS, 0)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, **EPISODE_TOL)
    assert torch.equal(got_arch, want_arch)
    assert len(torch.unique(want_arch)) >= 3


def _controller(policy, cfg, dev):
    """The policy of a template case: predictive conservative with the
    band, AAPA with the seeded GBDT reclassifying every 5 minutes with the
    forecast confidence on, hybrid with the GBDT and the band."""
    kw = {"predictive": lambda: dict(band=_band(dev), conservative=True),
          "aapa": lambda: dict(classify=_classifier(dev), stride_min=5,
                               forecast_confidence=True),
          "hybrid": lambda: dict(classify=_classifier(dev),
                                 band=_band(dev))}.get(policy, dict)()
    return registry.make(policy, cfg, **kw)


@pytest.mark.parametrize("policy,kw", [
    ("aapa", dict(stride_min=10)), ("aapa", dict(stride_min=2)),
    ("aapa", dict(stride_min=10, forecast_confidence=True)),
    ("aapa", dict(classify=None)), ("aapa", dict(band=True)),
    ("hybrid", dict(band=True, stride_min=5)), ("predictive", {}),
    ("predictive", dict(band=True, conservative=True))],
    ids=["aapa_s10", "aapa_s2", "aapa_conf", "aapa_default", "aapa_band",
         "hybrid_band", "predictive", "predictive_conservative_band"])
def test_policy_signals_kernel_matches_plain(cuda, policy, kw):
    """The pre-pass kernels against `policy_signals_ref`, bit for bit: the
    per-minute signals, the slots, and the archetype after every minute;
    293 lanes (not a multiple of the block) x 97 minutes."""
    cfg = cluster.SimConfig()
    kw = dict(kw)
    if policy != "predictive" and kw.pop("classify", True) is not None:
        kw["classify"] = _classifier(cuda)
    if kw.get("band"):
        kw["band"] = _band(cuda)
    ctrl = registry.make(policy, cfg, **kw)
    rates = torch.as_tensor(scenarios.archetype_mix(
        n_workloads=293, minutes=97, seed=2).rates, device=cuda)
    arch = policy != "predictive"
    before = policy_signals.policy_signals_cuda.launches
    got = policy_signals.policy_signals_cuda(rates, ctrl, cfg,
                                             minute_arch=arch)
    assert policy_signals.policy_signals_cuda.launches == before + 1
    ops.reset_launch_counts()
    want = ref.policy_signals_ref(rates, ctrl, cfg, minute_arch=arch)
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCHERS, 0)
    for name, a, e in zip(policy_signals.Signals._fields, got, want):
        assert (a is None) == (e is None), name
        assert a is None or torch.equal(a, e), name


@pytest.mark.parametrize("ci,startup", [(15, 30), (30, 60), (7, 60)])
@pytest.mark.parametrize("b,m", [(1, 90), (33, 121), (1000, 61)])
@pytest.mark.parametrize("policy", ["hpa", "kpa", "predictive", "aapa",
                                    "hybrid"])
def test_episode_templates_ragged_shapes(cuda, policy, b, m, ci, startup):
    """Every template of the episode kernel against its plain episode at
    lane counts that are not a multiple of the 32-lane block and minute
    counts that are not a multiple of the 8-minute tile, with the
    archetypes of AAPA and hybrid exact."""
    cfg = cluster.SimConfig(control_interval_sec=ci, startup_sec=startup)
    ctrl = _controller(policy, cfg, cuda)
    rates = torch.as_tensor(scenarios.archetype_mix(
        n_workloads=b, minutes=m, seed=b + m).rates, device=cuda)
    if policy in episode_block.ARCHETYPE_POLICIES:
        got, got_arch = episode_block.aapa_episode_cuda(rates, ctrl, cfg)
        want, want_arch = ref.aapa_episode_ref(rates, ctrl, cfg)
        assert torch.equal(got_arch, want_arch)
    else:
        got = episode_block.episode_block_cuda(rates, ctrl, cfg)
        want = ref.episode_block_ref(rates, ctrl, cfg)
    torch.cuda.synchronize()
    for a, e in zip(got, want):
        assert torch.equal(a, e)


def test_plant_pass_matches_plain(cuda):
    """The plant pass alone, from the pre-pass's signals, against
    `plant_pass_ref` on the same signals."""
    cfg = cluster.SimConfig(control_interval_sec=7)
    ctrl = _controller("hybrid", cfg, cuda)
    rates = torch.as_tensor(scenarios.archetype_mix(
        n_workloads=129, minutes=90, seed=1).rates, device=cuda)
    sig = policy_signals.policy_signals_cuda(rates, ctrl, cfg)
    before = episode_block.episode_block_cuda.launches
    got = episode_block.plant_pass_cuda(rates, ctrl, cfg, sig)
    assert episode_block.episode_block_cuda.launches == before + 1
    want = ref.plant_pass_ref(rates, ctrl, cfg, sig)
    torch.cuda.synchronize()
    for a, e in zip(got, want):
        assert torch.equal(a, e)
    with pytest.raises(ValueError, match="signals"):
        episode_block.plant_pass_cuda(rates, ctrl, cfg, None)


def test_startup_pipeline_too_large_for_shared_memory_raises(cuda):
    """The pipeline and HPA's window live in shared memory at 32 lanes a
    block; a startup_sec whose ring does not fit is refused, never moved
    to global memory."""
    rates = _rates(6, cuda, w=40, m=3)
    for policy in ("hpa", "kpa"):
        cfg = cluster.SimConfig(startup_sec=4000)
        with pytest.raises(RuntimeError, match="shared memory"):
            episode_block.episode_block_cuda(
                rates, registry.make(policy, cfg), cfg)
    cfg = cluster.SimConfig(startup_sec=1500)    # fits: 1500 + 20 slots
    got = episode_block.episode_block_cuda(rates, registry.make("hpa", cfg),
                                           cfg)
    want = ref.episode_block_ref(rates, registry.make("hpa", cfg), cfg)
    for a, e in zip(got, want):
        assert torch.equal(a, e)


def _fit_inputs(n=20_000, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 38)).astype(np.float32)
    X[:, 7] = rng.integers(0, 60, n) / np.float32(60)    # quantized column
    y = np.argmax(X[:, :4] + 0.7 * rng.normal(size=(n, 4)), 1)
    return X, y.astype(np.int32)


def test_gbdt_fit_on_the_card_is_deterministic(cuda):
    """Two fits of the same inputs on the card give the same trees bit
    for bit (each histogram bin is summed in row order after a stable
    sort, never by float atomics)."""
    X, y = _fit_inputs()
    cfg = gbdt.GBDTConfig(n_rounds=6)
    a = gbdt.fit(X, y, cfg, device=cuda)
    b = gbdt.fit(X, y, cfg, device=cuda)
    for name in ("feat", "thresh", "leaf", "bin_edges", "base"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_gbdt_fit_on_the_card_equals_the_cpu(cuda):
    """The card's fit gives the CPU's trees bit for bit: both sum every
    histogram bin in row order, cumulate bins in the same order and take
    correctly rounded exps."""
    X, y = _fit_inputs(n=12_000, seed=6)
    cfg = gbdt.GBDTConfig(n_rounds=3)
    a = gbdt.fit(X, y, cfg, device=cuda)
    b = gbdt.fit(X, y, cfg, device="cpu")
    for name in ("feat", "thresh", "leaf", "bin_edges", "base"):
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name)), name


def test_featurize_windows_on_the_card_equals_the_cpu(cuda):
    """The AAPAset featurize step on the card (the window_features kernel)
    equals the CPU's (the plain features) bit for bit: features, labels,
    confidence and votes."""
    from repro_torch.aapaset import build
    wins = windows.make_windows(azure_synth.generate_traces(
        n_functions=24, n_days=2, seed=4)).windows
    launches = window_features.window_features_cuda.launches
    card = build.featurize_windows(wins, chunk=1000, device=cuda)
    assert window_features.window_features_cuda.launches > launches
    cpu = build.featurize_windows(wins, chunk=1000, device="cpu")
    for a, e in zip(card, cpu):
        assert a.dtype == e.dtype
        np.testing.assert_array_equal(a.view(np.uint8), e.view(np.uint8))


def test_run_fleet_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A fleet run on the card against the same run on the CPU (plain
    episodes): pooled metrics and REI at rtol 2e-6, quantiles at the
    histogram's half-bin bound, as the reference holds its own reordered
    pooling. AAPA classifies with a classifier trained on the card and
    loaded on both devices."""
    from repro_torch.core import pipeline
    from repro_torch.evals import fleet
    from repro_torch.evals import metrics as EM
    trained = pipeline.train_aapa(
        azure_synth.generate_traces(n_functions=12, n_days=4, seed=2),
        gbdt.GBDTConfig(n_rounds=6), device=cuda)
    trained.save(tmp_path / "cls.npz")
    sp = fleet.spec("t_fleet", policies=("hpa", "predictive", "aapa"),
                    scenario="burst_storm", n_workloads=512, w_chunk=128,
                    minutes=120, seed=3)
    got = fleet.run_fleet(sp, device=cuda, classify=pipeline.TrainedAAPA.load(
        tmp_path / "cls.npz", device=cuda).make_classify())
    want = fleet.run_fleet(sp, device="cpu", stream=True,
                           classify=pipeline.TrainedAAPA.load(
                               tmp_path / "cls.npz",
                               device="cpu").make_classify())
    assert got.meta["peak_device_bytes"] > 0
    q = 2.5 * EM.quantile_rel_bound()
    for field in got.pooled._fields:
        tol = max(2e-6, q) if field.startswith(("p95", "p99")) else 2e-6
        np.testing.assert_allclose(getattr(got.pooled, field),
                                   getattr(want.pooled, field), rtol=tol,
                                   atol=1e-3, err_msg=field)
    np.testing.assert_allclose(got.rei.rei, want.rei.rei, rtol=2e-6)


# ------------------------------------------------- decision telemetry ----
TRACE_DISCRETE = ("minute", "sec", "scale_up", "scale_down",
                  "cooldown_blocked", "capacity_capped", "archetype")
TRACE_FORECAST = ("fc_point", "fc_lo", "fc_hi", "confidence", "guard_floor")


def _trained_pair(tmp_path, dev):
    """One small classifier trained on the card, loaded on the card and on
    the CPU: (its Classify on `dev`, on the CPU)."""
    from repro_torch.core import pipeline
    trained = pipeline.train_aapa(
        azure_synth.generate_traces(n_functions=12, n_days=4, seed=2),
        gbdt.GBDTConfig(n_rounds=6), device=dev)
    trained.save(tmp_path / "cls.npz")
    return tuple(pipeline.TrainedAAPA.load(tmp_path / "cls.npz",
                                           device=d).make_classify()
                 for d in (dev, "cpu"))


def _assert_trace_close(got, want):
    """The card's trace against the CPU's: NaN where NaN, discrete fields
    exact, forecast fields rtol 1e-4 / atol 1e-3, the rest at the episode
    tolerance."""
    from repro_torch.obs import trace
    got, want = trace.to_numpy(got), trace.to_numpy(want)
    for field in trace.DecisionRecord._fields:
        a, e = getattr(got.decisions, field), getattr(want.decisions, field)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(e),
                                      err_msg=field)
        if field in TRACE_DISCRETE:
            np.testing.assert_array_equal(a, e, err_msg=field)
        else:
            tol = (dict(rtol=1e-4, atol=1e-3) if field in TRACE_FORECAST
                   else EPISODE_TOL)
            np.testing.assert_allclose(a, e, equal_nan=True, err_msg=field,
                                       **tol)
    for field, a, e in zip(trace.MinuteTrace._fields, got.minutes,
                           want.minutes):
        np.testing.assert_allclose(a, e, err_msg=field, **EPISODE_TOL)


@pytest.mark.parametrize("ci", [15, 7])
@pytest.mark.parametrize("policy", ["hpa", "aapa"])
def test_traced_episode_on_the_card(cuda, tmp_path, policy, ci):
    """The traced unfused episode on the card: its MinuteOut equals the
    untraced one bit for bit and the fused kernel's at the episode
    tolerance, it launches `plant_block` (and `gbdt_tables` for AAPA), and
    its trace equals the same run's on the CPU at the trace tolerances."""
    cfg = cluster.SimConfig(control_interval_sec=ci)
    rates = torch.as_tensor(scenarios.archetype_mix(n_workloads=96,
                                                    minutes=40).rates)
    kw, ckw = {}, {}
    if policy == "aapa":
        card_cls, cpu_cls = _trained_pair(tmp_path, cuda)
        kw, ckw = dict(classify=card_cls), dict(classify=cpu_cls)
    ctrl = registry.make(policy, cfg, **kw)
    ops.reset_launch_counts()
    out, ct = cluster.simulate(rates.to(cuda), ctrl, cfg,
                               decide_kernel=False, telemetry=True)
    counts = ops.launch_counts()
    assert counts["plant_block"] > 0 and counts["episode_block"] == 0
    assert (counts["gbdt_tables"] > 0) == (policy == "aapa")
    base = cluster.simulate(rates.to(cuda), ctrl, cfg, decide_kernel=False)
    for a, b in zip(out, base):
        assert torch.equal(a, b)
    for a, e in zip(out, cluster.simulate(rates.to(cuda), ctrl, cfg)):
        torch.testing.assert_close(a, e, **EPISODE_TOL)
    cout, cct = cluster.simulate(rates, registry.make(policy, cfg, **ckw),
                                 cfg, device="cpu", decide_kernel=False,
                                 telemetry=True)
    for a, e in zip(out, cout):
        torch.testing.assert_close(a.cpu(), e, **EPISODE_TOL)
    _assert_trace_close(ct, cct)


def test_default_decide_kernel_refuses_telemetry(cuda):
    """On the card `simulate` defaults to the fused kernel, which keeps its
    decisions on the card: asking it for a trace raises, never falls back
    to the unfused path quietly."""
    from repro_torch.scaling import batch
    cfg = cluster.SimConfig()
    ctrl = registry.make("hpa", cfg)
    rates = _rates(4, cuda, w=8, m=3)
    with pytest.raises(ValueError, match="decide_kernel"):
        cluster.simulate(rates, ctrl, cfg, telemetry=True)
    with pytest.raises(ValueError, match="decide_kernel"):
        cluster.make_simulator(ctrl, cfg, telemetry=True)
    with pytest.raises(ValueError, match="decide_kernel"):
        batch.make_batch_simulator([ctrl], cfg, telemetry=True)


def test_fleet_trace_lanes_on_the_card(cuda):
    """`FleetSpec.trace_lanes` on the card: pooled metrics equal the
    untraced one-dispatch run (the fused kernel) at rtol 2e-6, the trace
    [C, M, H, P, K] equals the CPU's at the trace tolerances."""
    from repro_torch.evals import fleet
    from repro_torch.evals import metrics as EM
    from repro_torch.obs import trace
    kw = dict(policies=("hpa", "predictive", "kpa"), scenario="burst_storm",
              n_workloads=256, w_chunk=128, minutes=60, seed=3)
    base = fleet.run_fleet(fleet.spec("t_trace", **kw), device=cuda)
    sp = fleet.spec("t_trace", trace_lanes=4, **kw)
    ops.reset_launch_counts()
    got = fleet.run_fleet(sp, device=cuda)
    assert ops.launch_counts()["plant_block"] > 0
    H = len(trace.head_schedule(sp.sim_config()))
    assert got.trace.decisions.desired.shape == (2, 60, H, 3, 4)
    q = 2.5 * EM.quantile_rel_bound()
    for field in got.pooled._fields:
        tol = max(2e-6, q) if field.startswith(("p95", "p99")) else 2e-6
        np.testing.assert_allclose(getattr(got.pooled, field),
                                   getattr(base.pooled, field), rtol=tol,
                                   atol=1e-3, err_msg=field)
    _assert_trace_close(got.trace, fleet.run_fleet(sp, device="cpu").trace)


def test_tuning_evaluator_on_the_card_equals_the_cpu(cuda):
    """`tuning.make_evaluator` on the card (one episode kernel launch a
    candidate) against the CPU's: REI and pooled metrics at rtol 2e-6,
    the same static-group count."""
    import repro_torch.tuning as tuning
    sp = tuning.spec("t_tune", policy="hpa", strategy="grid", points=3,
                     n_workloads=8, minutes=120)
    cands = tuning.grid_candidates(sp.space, sp.points)
    rates = tuning.build_rates(sp)
    ev_card, ev_cpu = (tuning.make_evaluator(sp, device=d)
                       for d in (cuda, "cpu"))
    ops.reset_launch_counts()
    met, rei = ev_card(cands, rates)
    assert ops.launch_counts()["episode_block"] == len(cands)
    cmet, crei = ev_cpu(cands, rates)
    np.testing.assert_allclose(rei, crei, rtol=2e-6)
    for field, a, e in zip(met._fields, met, cmet):
        np.testing.assert_allclose(a, e, rtol=2e-6, atol=1e-3,
                                   err_msg=field)
    assert ev_card._cache_size() == ev_cpu._cache_size() == 1


# ---- the serving endpoint: adapter, model substrate and engine
SERVE_DISCRETE = ("minute", "sec", "scale_up", "scale_down",
                  "cooldown_blocked", "capacity_capped", "archetype")
SERVE_FORECAST = ("fc_point", "fc_lo", "fc_hi", "confidence", "guard_floor")


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def _classify_to(cls, dev):
    p, c = cls.params, cls.cal
    return Classify(
        gbdt.GBDTParams(*(t.to(dev) for t in (p.feat, p.thresh, p.leaf,
                                              p.bin_edges, p.base))),
        calibration.BetaCalibration(*(t.to(dev) for t in (c.a_raw, c.b_raw,
                                                          c.c))))


def test_serving_adapter_on_the_card_equals_the_cpu(cuda):
    """The launcher's 10-minute bursty script under AAPA on the card
    (adapter, controller and classifier on CUDA tensors: the
    `window_features` and `gbdt_tables` kernels) against the same script
    on the CPU (their plain versions): summaries equal, decision logs with
    discrete fields exact and forecast fields at rtol 1e-4 / atol 1e-3."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import model as M
    cfg = smoke_config(get_config("stablelm_1_6b"))
    params = M.init(0, cfg, device="cpu")
    cls = _classifier("cpu")
    runs = []
    for dev in (cuda, torch.device("cpu")):
        ops.reset_launch_counts()
        eng, auto = launcher.serve(
            10, "aapa", None, _tree_to(params, dev), cfg,
            launcher.bursty_rates(10), np.random.default_rng(0), device=dev,
            classify=_classify_to(cls, dev),
            log=lambda *a: None)
        runs.append((eng.summary(), auto.decision_trace(),
                     ops.launch_counts()))
    (card, card_trace, counts), (cpu, cpu_trace, cpu_counts) = runs
    assert counts["window_features"] > 0 and counts["gbdt_tables"] > 0
    assert not any(cpu_counts.values())
    assert card == cpu
    for field in card_trace._fields:
        a, e = getattr(card_trace, field), getattr(cpu_trace, field)
        if field in SERVE_DISCRETE:
            np.testing.assert_array_equal(a, e, err_msg=field)
        else:
            tol = (dict(rtol=1e-4, atol=1e-3) if field in SERVE_FORECAST
                   else dict(rtol=1e-5, atol=1e-5))
            np.testing.assert_allclose(a, e, equal_nan=True, err_msg=field,
                                       **tol)


@pytest.mark.parametrize("arch", [
    "deepseek_v2_lite_16b", "qwen3_moe_30b_a3b", "stablelm_1_6b",
    "deepseek_67b", "mistral_nemo_12b", "internlm2_1_8b", "mamba2_2_7b",
    "zamba2_2_7b", "whisper_large_v3", "internvl2_76b"])
def test_smoke_decode_on_the_card_equals_the_cpu(cuda, arch):
    """Prefill and one decode step of the smoke-size model in bf16 on the
    card against the CPU's, at the reference's bf16 tolerance (rtol 0.05,
    atol 0.05; 0.1 for the hybrid)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import model as M
    cfg = smoke_config(get_config(arch))
    params = M.init(0, cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 8)))}
    if cfg.n_img_tokens:
        batch["img_embeds"] = torch.as_tensor(rng.normal(
            size=(2, cfg.n_img_tokens, cfg.d_model)), dtype=cfg.jdtype)
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.as_tensor(rng.normal(
            size=(2, cfg.enc_len, cfg.d_model)), dtype=cfg.jdtype)
    nxt = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 1)))
    pos = 8 + (cfg.n_img_tokens or 0)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        p = _tree_to(params, dev)
        lg, cache = M.prefill(p, _tree_to(batch, dev), cfg, 16)
        lg2, _ = M.decode_step(p, cache, nxt.to(dev), pos, cfg)
        outs.append((lg.float().cpu(), lg2.float().cpu()))
    atol = 0.1 if arch == "zamba2_2_7b" else 0.05
    for got, want in zip(*outs):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0.05,
                                   atol=atol)


def test_cuda_serving_engine_refuses_without_a_card(monkeypatch):
    """A ServingEngine asked for CUDA raises when CUDA is absent (here
    made absent), rather than running on the CPU."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServingEngine
    cfg = smoke_config(get_config("stablelm_1_6b"))
    params = M.init(0, cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params)


# ---- training and the launch tools
def _f32_smoke(arch):
    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    return dataclasses.replace(smoke_config(get_config(arch)),
                               dtype="float32", cache_dtype="float32")


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "qwen3_moe_30b_a3b",
                                  "mamba2_2_7b"])
def test_train_steps_on_the_card_equal_the_cpu(cuda, arch):
    """Three train steps (two microbatches) at smoke size in f32 from the
    same weights and batches on the card and on the CPU: losses at
    rtol 1e-4 for the first step and 1e-3 after (AdamW's first update is
    lr * sign(g)), params and m at rtol 1e-4 / atol 1e-5 of each leaf's
    largest entry (test_torch_train.py's tolerances)."""
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step
    cfg = _f32_smoke(arch)
    base = M.init(0, cfg, device="cpu")
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, cfg.vocab, (4, 32)) for _ in range(3)]
    runs = []
    for dev in (cuda, torch.device("cpu")):
        params = opt_lib.tree_map(lambda t: t.to(dev), base)
        opt = opt_lib.init(params)
        ts = make_train_step(cfg, microbatches=2)
        losses = []
        for b in batches:
            toks = torch.as_tensor(b, dtype=torch.int32, device=dev)
            params, opt, m = ts(params, opt, {"tokens": toks,
                                              "labels": toks})
            losses.append(float(m["loss"]))
        runs.append((losses, opt_lib.leaves((params, opt.m))))
    (card, card_leaves), (cpu, cpu_leaves) = runs
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-4)
    np.testing.assert_allclose(card[1:], cpu[1:], rtol=1e-3)
    for a, e in zip(card_leaves, cpu_leaves):
        e = e.numpy()
        np.testing.assert_allclose(a.cpu().numpy(), e, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(e).max(), 1e-30))


def test_resume_on_the_card_is_bit_for_bit(cuda, tmp_path, monkeypatch):
    """Deterministic algorithms on: two steps, an async checkpoint, two
    more; restored into new tensors, the last two steps again give the
    same params, moments and losses bit for bit."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import model as M
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        cfg = smoke_config(get_config("internlm2_1_8b"))
        ts = make_train_step(cfg, microbatches=2)
        rng = np.random.default_rng(5)
        batches = [torch.as_tensor(rng.integers(0, cfg.vocab, (8, 64)),
                                   dtype=torch.int32, device=cuda)
                   for _ in range(4)]
        params = M.init(torch.Generator(device=cuda).manual_seed(3), cfg)
        opt = opt_lib.init(params)
        for toks in batches[:2]:
            params, opt, _ = ts(params, opt, {"tokens": toks,
                                              "labels": toks})
        writer = ckpt.AsyncCheckpointer(tmp_path, keep=1)
        writer.save(2, {"params": params, "opt": opt})
        losses = []
        for toks in batches[2:]:
            params, opt, m = ts(params, opt, {"tokens": toks,
                                              "labels": toks})
            losses.append(float(m["loss"]))
        writer.close()
        shapes = M.init(0, cfg, device="meta")
        state, step = ckpt.restore(tmp_path, {"params": shapes,
                                              "opt": opt_lib.init(shapes)},
                                   device=cuda)
        assert step == 2
        p2, o2 = state["params"], state["opt"]
        again = []
        for toks in batches[2:]:
            p2, o2, m = ts(p2, o2, {"tokens": toks, "labels": toks})
            again.append(float(m["loss"]))
    finally:
        torch.use_deterministic_algorithms(was)
    assert again == losses
    for a, b in zip(opt_lib.leaves((p2, o2)), opt_lib.leaves((params, opt))):
        assert torch.equal(a, b)


def test_launch_train_on_the_card(cuda, tmp_path):
    """``launch.train`` at smoke size with its default device (the card):
    finite losses, a checkpoint every two steps, a resume."""
    from repro_torch.launch import train as launcher
    from repro_torch.train import checkpoint as ckpt
    seen = []
    argv = ["--arch", "internlm2_1_8b", "--local-smoke", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"]
    params, _ = launcher.main(argv + ["--steps", "4"],
                              on_step=lambda s, m: seen.append(
                                  float(m["loss"])))
    assert len(seen) == 4 and np.isfinite(seen).all()
    assert params["embed"].is_cuda and ckpt.latest_step(tmp_path) == 4


def test_dry_run_fitting_cell_runs_on_the_card(cuda):
    """A cell the dry run says fits (mamba2's batch-1 524,288-token
    decode) runs for real on the card, its peak device memory within 5%
    of the dry run's estimate (the caching allocator rounds each block
    up)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    rec = dryrun.run_cell("mamba2_2_7b", "long_500k")
    assert rec["ok"] and rec["fits_one_card"]
    cfg, shape = get_config("mamba2_2_7b"), SHAPES["long_500k"]
    torch.cuda.empty_cache()
    params = M.init(torch.Generator(device=cuda).manual_seed(0), cfg)
    cache = M.init_cache(cfg, 1, shape.seq_len, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()      # the arguments are resident
    logits, _ = M.decode_step(params, cache, torch.ones(
        (1, 1), dtype=torch.int32, device=cuda), shape.seq_len - 1, cfg)
    assert torch.isfinite(logits.float()).all()
    peak = torch.cuda.max_memory_allocated()
    assert abs(peak - rec["memory"]["total_bytes"]) <= 0.05 * peak


# ------------------------------------------------------------ device mesh ----
def _mesh_fleet_case(dev, classify):
    """A small fleet (HPA and AAPA, 8 chunks) and its unsharded runs, one
    dispatch and streamed, on `dev`."""
    from repro_torch.evals import fleet
    sp = fleet.spec("t_mesh", policies=("hpa", "aapa"),
                    scenario="burst_storm", n_workloads=2048, w_chunk=256,
                    minutes=120, seed=3)
    return sp, [fleet.run_fleet(sp, classify=classify, stream=stream,
                                device=dev) for stream in (False, True)]


def _assert_same(got, want, what):
    def host(x):
        return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    for field in got._fields:
        a, e = host(getattr(got, field)), host(getattr(want, field))
        assert a.shape == e.shape and a.tobytes() == e.tobytes(), \
            f"{what}: {field}"


def _sharded_fleet(sp, want, classify, mesh, n_cards):
    """The fleet under `mesh`, both modes, bit for bit with `want`, the
    episode kernel and AAPA's pre-pass launched."""
    from repro_torch.dist import sharding as shd
    from repro_torch.evals import fleet
    shd.set_mesh(mesh)
    try:
        for stream, ref_run in zip((False, True), want):
            ops.reset_launch_counts()
            got = fleet.run_fleet(sp, classify=classify, stream=stream)
            counts = ops.launch_counts()
            assert counts["episode_block"] > 0, counts
            assert counts["policy_signals"] > 0, counts
            _assert_same(got.pooled, ref_run.pooled, "pooled")
            _assert_same(got.rei, ref_run.rei, "rei")
            assert got.meta["mesh"] == mesh.shape
            assert got.meta["n_devices"] == n_cards
            assert got.meta["peak_device_bytes"] > 0
    finally:
        shd.set_mesh(None)


def test_fleet_on_a_logical_mesh_of_one_card(cuda):
    """A 4-entry mesh of the first card: chunk c on entry c mod 4, HPA and
    AAPA (a seeded classifier), one dispatch and streamed, bit for bit
    with the unsharded runs."""
    from repro_torch.dist import sharding as shd
    cls = _classifier(cuda)
    sp, want = _mesh_fleet_case(cuda, cls)
    _sharded_fleet(sp, want, cls, shd.Mesh([torch.device("cuda", 0)] * 4),
                   1)


def test_matrix_on_a_logical_mesh_of_one_card(cuda):
    """The matrix under a 4-entry mesh of the first card: per-workload
    results bit for bit with the unsharded run, pooled at rtol 2e-6 with
    counts and quantile bins equal; the batch simulator bit for bit."""
    from repro_torch.dist import sharding as shd
    from repro_torch.evals import matrix
    from repro_torch.scaling import batch
    sp = matrix.spec("t_mesh", policies=("hpa", "predictive", "aapa"),
                     scenarios=(("burst_storm", {}), ("idle_wake", {})),
                     seeds=(0, 1), n_workloads=64, minutes=240)
    cls = _classifier(cuda)
    rates = matrix.build_rates(sp)
    pool1, per1 = matrix.make_runner(sp, cls)(rates)
    ctrls = matrix.controllers(sp, cls)
    out1 = batch.make_batch_simulator(ctrls, sp.sim_config())(rates[0, 0])
    shd.set_mesh(shd.Mesh([torch.device("cuda", 0)] * 4))
    try:
        pool, per = matrix.make_runner(sp, cls)(rates)
        out = batch.make_batch_simulator(ctrls, sp.sim_config())(rates[0, 0])
    finally:
        shd.set_mesh(None)
    _assert_same(per, per1, "per workload")
    _assert_same(out, out1, "batch")
    for field in pool._fields:
        a, e = getattr(pool, field), getattr(pool1, field)
        if field in ("scaling_actions", "oscillations", "p95_response_ms",
                     "p99_response_ms", "overprovision_rate"):
            assert torch.equal(a, e), field
        else:
            torch.testing.assert_close(a, e, rtol=2e-6, atol=0.0)


def test_cpu_device_under_a_mesh_of_cards_raises(cuda):
    """Under a mesh of cards, an entry point asked for the CPU raises
    ValueError instead of running the plain path on the cards' tensors."""
    from repro_torch.aapaset import build
    from repro_torch.dist import sharding as shd
    from repro_torch.evals import fleet
    sp = fleet.spec("t_mesh_cpu", policies=("hpa",), scenario="burst_storm",
                    n_workloads=64, w_chunk=16, minutes=30, seed=0)
    shd.set_mesh(shd.Mesh([torch.device("cuda", 0)] * 2))
    try:
        for run in (lambda: fleet.run_fleet(sp, device="cpu"),
                    lambda: fleet.make_chunk_folder(sp, device="cpu"),
                    lambda: build.featurize_windows(
                        np.zeros((4, 60), np.float32), device="cpu")):
            with pytest.raises(ValueError, match="disagrees with the active"):
                run()
    finally:
        shd.set_mesh(None)


def test_fleet_over_every_card(cuda):
    """The production mesh over every visible card: chunk c on card
    c mod n, the classifier copied to each, bit for bit with the
    unsharded runs on the first card. Needs two cards."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more CUDA devices to split the fleet "
                    f"over cards; this machine has {n}")
    from repro_torch.launch import mesh as launch_mesh
    cls = _classifier(torch.device("cuda", 0))
    sp, want = _mesh_fleet_case(torch.device("cuda", 0), cls)
    _sharded_fleet(sp, want, cls, launch_mesh.make_production_mesh(),
                   min(n, sp.n_chunks))
