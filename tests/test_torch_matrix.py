"""The Table IV evaluation matrix of the port (``repro_torch.evals.matrix``
over ``scaling.batch``, ``scaling.scenarios`` and ``data.azure_synth``)
against the JAX reference on the CPU.

Inputs are seeded NumPy on both sides, so the trace families and every
scenario are held bit for bit. The matrix's cells are held at the
reference's own matrix tolerances (tests/test_evals.py
``_assert_metrics_close``: rtol 2e-4, the histogram quantiles at
``Q_RTOL``, abs 1e-3), per cell, pooled and per workload; its batched
episodes at the reference's batch tolerance (tests/test_scaling.py: rtol
1e-5). The pooled mode, which folds each chunk of workloads as it goes,
is held against the per-workload mode at the reference's reordered-
pooling tolerance (rtol 2e-6, tests/test_fleet.py) with the counts exact.
Result cards are addressed by the reference's hashes.
"""
import _torch_threads  # noqa: F401  (one torch thread)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.aapaset import manifest as ref_manifest
from repro.data import azure_synth as ref_synth
from repro.evals import artifacts as ref_artifacts
from repro.evals import matrix as ref_matrix
from repro.evals import metrics as ref_EM
from repro.scaling import batch as ref_batch
from repro.scaling import scenarios as ref_scenarios
from repro.sim import cluster as ref_cluster
from repro_torch.aapaset import manifest
from repro_torch.data import azure_synth
from repro_torch.evals import artifacts, matrix
from repro_torch.evals import metrics as EM
from repro_torch.forecast import registry as t_fregistry
from repro_torch.scaling import batch, registry, scenarios
from repro_torch.sim import cluster

Q_RTOL = 2.5 * ref_EM.quantile_rel_bound()
POOL_RTOL = 2e-6
#: metrics that count: exact in every mode
COUNTS = ("scaling_actions", "oscillations", "mean_action_interval_min",
          "overprovision_rate")

ACCEPT = dict(policies=("hpa", "kpa", "predictive", "aapa"),
              forecasters=("holt_winters", "ewma"),
              scenarios=(("burst_storm", {}), ("idle_wake", {}),
                         ("archetype_mix", {})),
              seeds=(0, 1), n_workloads=2, minutes=60)
SWEEP = dict(policies=("predictive",),
             forecasters=tuple(t_fregistry.available()),
             scenarios=(("archetype_mix", {}),), seeds=(4242,),
             n_workloads=2, minutes=120)
SPECS = {"accept": ("t_matrix", ACCEPT), "sweep": ("t_sweep", SWEEP)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(case):
    """(reference MatrixSpec, the port's) of a case."""
    if case == "smoke":
        return ref_matrix.smoke_spec(), matrix.smoke_spec()
    name, kw = SPECS[case]
    return ref_matrix.spec(name, **kw), matrix.spec(name, **kw)


@functools.lru_cache(maxsize=None)
def _port_run(case, per_workload=True):
    _, ts = _specs(case)
    return matrix.make_runner(ts, device="cpu", per_workload=per_workload)(
        matrix.build_rates(ts))


def _assert_cell_close(got, want, where):
    """`_assert_metrics_close` of tests/test_evals.py, every field."""
    for field in EM.EpisodeMetrics._fields:
        tol = Q_RTOL if field.startswith(("p95", "p99")) else 2e-4
        np.testing.assert_allclose(
            np.asarray(getattr(got, field)), np.asarray(getattr(want,
                                                                field)),
            rtol=tol, atol=1e-3, err_msg=f"{where} {field}")


# ------------------------------------------------------------- inputs ----
@pytest.mark.parametrize("family", ref_synth.TRACE_FAMILIES)
def test_trace_families_match_reference(family):
    want = ref_synth.generate_traces(n_functions=6, n_days=2, seed=3,
                                     family=family)
    got = azure_synth.generate_traces(n_functions=6, n_days=2, seed=3,
                                      family=family)
    for field in ("rates", "counts", "pattern", "base_rate"):
        a, e = getattr(got, field), getattr(want, field)
        assert a.dtype == e.dtype and np.array_equal(a, e), field
    with pytest.raises(ValueError, match="family"):
        azure_synth.generate_traces(2, 1, family="no_such_family")


SCENARIOS = [("archetype_pure", dict(kind="SPIKE")),
             ("archetype_pure", dict(kind="RAMP", minutes=200)),
             ("archetype_mix", {}), ("burst_storm", {}),
             ("diurnal_ramp", {}), ("diurnal_ramp", dict(growth=3.0)),
             ("idle_wake", {}), ("idle_wake", dict(burst=50.0))]


@pytest.mark.parametrize("name,kw", SCENARIOS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCENARIOS)])
def test_scenarios_match_reference(name, kw):
    assert scenarios.available() == ref_scenarios.available()
    kw = dict(dict(n_workloads=5, minutes=300, seed=7), **kw)
    want = ref_scenarios.get(name, **kw)
    got = scenarios.get(name, **kw)
    assert got.name == want.name and got.meta == want.meta
    assert got.rates.dtype == want.rates.dtype
    assert np.array_equal(got.rates, want.rates)


@pytest.mark.parametrize("sweep,values", [("startup_sweep", (10, 60)),
                                          ("rps_per_replica_sweep",
                                           (5.0, 40.0))])
def test_plant_sweeps_match_reference(sweep, values):
    kw = dict(values=values, n_workloads=3, minutes=90, seed=1)
    want = getattr(ref_scenarios, sweep)(**kw)
    got = getattr(scenarios, sweep)(**kw)
    assert [s.name for s in got] == [s.name for s in want]
    for g, w in zip(got, want):
        assert np.array_equal(g.rates, w.rates) and g.meta == w.meta
        assert (g.cfg.startup_sec, g.cfg.rps_per_replica) == (
            w.cfg.startup_sec, w.cfg.rps_per_replica)


# ------------------------------------------------------------- matrix ----
@pytest.mark.parametrize("case", ["accept", "smoke", "sweep"])
def test_matrix_matches_reference(case):
    """The port's matrix against `repro.evals.matrix.make_runner`, cell by
    cell, pooled [S, Z, F, P] and per workload [S, Z, F, P, W]: the
    reference's acceptance matrix (4 policies x holt_winters/ewma x 3
    scenarios x 2 seeds), its CI smoke matrix, and predictive under all
    four forecasters."""
    rs, ts = _specs(case)
    assert ts.content_key() == rs.content_key()
    rates = matrix.build_rates(ts)
    assert np.array_equal(rates, ref_matrix.build_rates(rs))
    want_pool, want_w = ref_matrix.make_runner(rs)(rates)
    pool, per_w = _port_run(case)
    S, Z, F, P = ts.shape
    assert tuple(pool.slo_violation_rate.shape) == (S, Z, F, P)
    assert tuple(per_w.slo_violation_rate.shape) == (S, Z, F, P,
                                                     ts.n_workloads)
    for idx in np.ndindex(S, Z, F, P):
        _assert_cell_close(type(pool)(*(a[idx] for a in pool)),
                           jax.tree.map(lambda a: a[idx], want_pool),
                           f"pooled {idx}")
    _assert_cell_close(per_w, want_w, "per workload")
    assert float(pool.scaling_actions.sum()) > 0


@pytest.mark.parametrize("case", ["smoke"])
def test_pooled_mode_matches_per_workload_mode(case):
    """`per_workload=False` folds each chunk into its cell's pooled
    accumulators; it agrees with the per-workload mode's pooled result at
    the reordered-pooling tolerance, counts exact, and so does a chunked
    run (one workload per episode call)."""
    _, ts = _specs(case)
    want, _ = _port_run(case)
    got, none = _port_run(case, per_workload=False)
    assert none is None
    pools = [got, matrix.make_runner(ts, device="cpu", per_workload=False,
                                     w_chunk=1)(matrix.build_rates(ts))[0]]
    for field in EM.EpisodeMetrics._fields:
        for pool in pools:
            a, e = getattr(pool, field), getattr(want, field)
            if field in COUNTS:
                assert torch.equal(a, e), field
            else:
                np.testing.assert_allclose(a.numpy(), e.numpy(),
                                           rtol=POOL_RTOL, atol=0,
                                           err_msg=field)


def test_evaluate_controllers_matches_matrix_path():
    """`evaluate_controllers` on one scenario's rates equals the matrix
    runner's cells for the same controllers (which
    `test_matrix_matches_reference` holds against the reference)."""
    _, ts = _specs("accept")
    rates = matrix.build_rates(ts)[2, 1]              # archetype_mix, 1
    ctrls = matrix.controllers(ts)
    pool, per_w = matrix.evaluate_controllers(ctrls, rates, device="cpu")
    mpool, mper_w = _port_run("accept")
    F, P = ts.shape[2:]
    for field in EM.EpisodeMetrics._fields:
        a = getattr(pool, field).reshape(F, P)
        assert torch.equal(a, getattr(mpool, field)[2, 1]), field
        a = getattr(per_w, field).reshape(F, P, -1)
        assert torch.equal(a, getattr(mper_w, field)[2, 1]), field


def test_run_is_content_addressed_with_the_reference_hash(tmp_path,
                                                          monkeypatch):
    """A spec's card hash is the reference's; `run` writes the card and
    result under the port's own root and a second run is a cache hit
    that loads the same result; the renderers read it."""
    rs, ts = _specs("smoke")
    key = dict(ts.content_key(), classifier="default_classify")
    rkey = dict(rs.content_key(), classifier="default_classify")
    assert artifacts.card_hash(key) == ref_artifacts.card_hash(rkey)
    assert manifest.hash_json(key) == ref_manifest.hash_json(rkey)
    assert artifacts.DEFAULT_ROOT != ref_artifacts.DEFAULT_ROOT
    run1 = matrix.run(ts, root=tmp_path, device="cpu")
    assert not run1.cached
    assert run1.card["hash"] == ref_artifacts.card_hash(rkey)
    assert (tmp_path / f"ci_smoke-{run1.card['hash']}"
            / "result.npz").exists()

    def boom(*a, **k):
        raise AssertionError("a cache hit must not run the matrix")

    monkeypatch.setattr(matrix, "_execute", boom)
    run2 = matrix.run(ts, root=tmp_path, device="cpu")
    assert run2.cached and run2.card["hash"] == run1.card["hash"]
    for tree in ("pooled", "per_workload", "rei"):
        for a, e in zip(getattr(run2.result, tree),
                        getattr(run1.result, tree)):
            assert np.array_equal(a, e)
    pool, _ = _port_run("smoke")
    assert np.array_equal(run1.result.pooled.p95_response_ms,
                          pool.p95_response_ms.numpy())
    for table in ("policy_comparison", "per_scenario", "rei_sensitivity"):
        assert "|" in run2.card["tables"][table]
    assert "| hpa |" in artifacts.policy_table(run2.result, ts)
    with pytest.raises(ValueError, match="classifier_id"):
        matrix.run(ts, classify=lambda f: None, root=tmp_path,
                   device="cpu")


def test_renderers_match_reference():
    """The three paper tables render the same text from the same
    result."""
    rs, ts = _specs("accept")
    pool, per_w = _port_run("accept")
    rei_b = matrix.ER.rei(pool.slo_violation_rate, pool.replica_minutes,
                          pool.scaling_actions, minutes=ts.minutes,
                          n_workloads=ts.n_workloads)
    got = matrix.EvalResult(*(matrix._to_numpy(t)
                              for t in (pool, per_w, rei_b)))
    want = ref_matrix.EvalResult(*(ref_matrix.EM.EpisodeMetrics(*t)
                                   if i < 2 else
                                   ref_matrix.ER.REIBreakdown(*t)
                                   for i, t in enumerate(got)))
    for fn in ("policy_table", "scenario_table", "rei_sensitivity_table"):
        assert getattr(artifacts, fn)(got, ts) == getattr(
            ref_artifacts, fn)(want, rs), fn


# -------------------------------------------------------------- batch ----
def _rates(shape, lam=1500, seed=1):
    return np.random.default_rng(seed).poisson(lam, shape).astype(
        np.float32)


def test_batch_simulate_matches_reference():
    """Every policy over the same lanes in one call, against the
    reference's fused P x W batch (its tests/test_scaling.py tolerance);
    one workload per episode call changes no bit."""
    rates = _rates((3, 60))
    cfg, rcfg = cluster.SimConfig(), ref_cluster.SimConfig()
    names = ("hpa", "kpa", "predictive")
    want = ref_batch.batch_simulate(
        [ref_batch.registry.get_controller(n, rcfg) for n in names],
        jnp.asarray(rates), rcfg)
    ctrls = [registry.get_controller(n, cfg) for n in names]
    got = batch.batch_simulate(ctrls, rates, cfg, device="cpu")
    chunked = batch.make_batch_simulator(ctrls, cfg, device="cpu",
                                         w_chunk=1)(rates)
    assert tuple(got.served.shape) == (len(names), 3, 60)
    for field, a, c, e in zip(cluster.MinuteOut._fields, got, chunked,
                              want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-5,
                                   atol=1e-5, err_msg=field)
        assert torch.equal(a, c), field


def test_forecast_batch_simulator_lanes():
    """Forecasters x policies: lane (f, p) is policy p on forecaster f;
    a policy without a forecaster is refused."""
    cfg = cluster.SimConfig()
    rates = _rates((2, 60), seed=4)
    fcs = ("ewma", "seasonal_naive")
    out = batch.make_forecast_batch_simulator(("predictive", "aapa"), fcs,
                                              cfg, device="cpu")(rates)
    assert tuple(out.served.shape) == (2, 2, 2, 60)
    for f, fc in enumerate(fcs):
        single = cluster.simulate(rates, registry.get_controller(
            "aapa", cfg, forecaster=fc), cfg, device="cpu")
        assert torch.equal(out.served[f, 1], single.served)
    with pytest.raises(TypeError, match="takes no forecaster"):
        batch.make_forecast_batch_simulator(("hpa",), fcs, cfg,
                                            device="cpu")


def test_grid_simulator_and_evaluator_match_reference():
    """A grid over stackable keys: each point's episodes against the
    reference's grid lanes (its tolerance, rtol 1e-5), and the
    evaluator's pooled metrics and REI against the reference's (rtol
    2e-5, tests/test_tuning.py). Static keys group as the reference's
    do (`test_grid_split_validates_like_the_reference`)."""
    grid = [{"target": t, "cooldown_min": c}
            for t, c in ((0.5, 2.0), (0.8, 5.0), (0.65, 8.0))]
    rates = _rates((2, 60), lam=2400, seed=3)
    cfg, rcfg = cluster.SimConfig(), ref_cluster.SimConfig()
    got = batch.make_grid_simulator("hpa", grid, cfg, device="cpu")(rates)
    want = ref_batch.make_grid_simulator("hpa", grid, rcfg)(
        jnp.asarray(rates))
    assert tuple(got.served.shape) == (3, 2, 60)
    for field in ("served", "ready_mean", "replica_seconds"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-5, err_msg=field)
    met, rb = batch.make_grid_evaluator("hpa", cfg, device="cpu")(grid,
                                                                  rates)
    rmet, rrb = ref_batch.make_grid_evaluator("hpa", rcfg)(grid, rates)
    for field in EM.EpisodeMetrics._fields:
        np.testing.assert_allclose(getattr(met, field).numpy(),
                                   np.asarray(getattr(rmet, field)),
                                   rtol=2e-5, atol=1e-5, err_msg=field)
    np.testing.assert_allclose(rb.rei.numpy(), np.asarray(rrb.rei),
                               rtol=2e-5, atol=1e-5)


def test_grid_split_validates_like_the_reference():
    fixed = {"cooldown_min": 2.0}
    grid = [{"target": 0.5, "stabilization_min": 2.0},
            {"target": 0.6, "stabilization_min": 8.0},
            {"target": 0.7, "stabilization_min": 2.0}]
    _, traced, groups = batch.grid_split("hpa", grid, fixed)
    _, rtraced, rgroups = ref_batch.grid_split("hpa", grid, fixed)
    assert (traced, groups) == (rtraced, rgroups)
    with pytest.raises(TypeError, match=r"cooldwon_min.*accepts"):
        batch.make_grid_simulator("hpa", [{"target": 0.5}],
                                  cluster.SimConfig(), cooldwon_min=2.0)
    with pytest.raises(TypeError, match=r"grid keys.*accepts"):
        batch.grid_split("hpa", [{"tarket": 0.5}], {})
    with pytest.raises(TypeError, match="also passed as fixed"):
        batch.grid_split("hpa", [{"target": 0.5}], {"target": 0.7})
    with pytest.raises(ValueError, match="same keys"):
        batch.grid_split("hpa", [{"target": 0.5}, {"tolerance": 0.1}], {})


def test_telemetry_is_refused_and_device_options_are_accepted():
    """`telemetry=True` is refused where the reference refuses it: with the
    fused episode kernel and with `w_chunk` (the traced runs themselves are
    tests/test_torch_obs.py's); `shard=` and `donate=` are accepted (no
    mesh on one card); a `w_chunk` that does not divide the workloads is
    refused, as in the reference."""
    cfg = cluster.SimConfig()
    ctrls = [registry.get_controller("hpa", cfg)]
    with pytest.raises(ValueError, match="decide_kernel"):
        batch.make_batch_simulator(ctrls, cfg, device="cpu",
                                   decide_kernel=True, telemetry=True)
    with pytest.raises(ValueError, match="w_chunk"):
        batch.make_batch_simulator(ctrls, cfg, device="cpu", w_chunk=2,
                                   telemetry=True)
    with pytest.raises(ValueError, match="w_chunk"):
        matrix.make_runner(matrix.smoke_spec(), device="cpu", w_chunk=2,
                           telemetry=True)
    sim = batch.make_batch_simulator(ctrls, cfg, device="cpu", shard=False,
                                     donate=True, w_chunk=2)
    with pytest.raises(ValueError, match="must divide"):
        sim(_rates((3, 5)))
