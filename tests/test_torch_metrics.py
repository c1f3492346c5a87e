"""Parity of the port's metrics, REI, NumPy oracle and scenario
generators with the JAX reference, on the CPU.

Metric tolerances are the reference's own (tests/test_evals.py): rtol
2e-4 with abs 1e-3, quantiles at 2.5x the histogram's half-bin bound.
"""
import _torch_threads  # noqa: F401  (one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rei as ref_core_rei
from repro.data import azure_synth as ref_synth
from repro.evals import metrics as ref_metrics
from repro.evals import rei as ref_rei
from repro.scaling import registry as ref_registry
from repro.scaling import scenarios as ref_scenarios
from repro.sim import cluster as ref_cluster
from repro.sim import metrics as ref_oracle
from repro_torch.core import archetypes as t_arch
from repro_torch.core import rei as t_core_rei
from repro_torch.data import azure_synth as t_synth
from repro_torch.evals import metrics as t_metrics
from repro_torch.evals import rei as t_rei
from repro_torch.scaling import registry as t_registry
from repro_torch.scaling import scenarios as t_scenarios
from repro_torch.sim import cluster as t_cluster
from repro_torch.sim import metrics as t_oracle

Q_RTOL = 2.5 * ref_metrics.quantile_rel_bound()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_minute_out(rng, shape):
    """Random but consistent MinuteOut arrays (as tests/test_evals.py)."""
    served = rng.gamma(1.5, 200.0, shape).astype(np.float32)
    served[rng.random(shape) < 0.15] = 0.0
    resp = rng.gamma(2.0, 0.4, shape).astype(np.float32)
    return t_cluster.MinuteOut(
        served=served,
        violated=(served * (rng.random(shape) < 0.3)).astype(np.float32),
        cold_starts=rng.poisson(0.5, shape).astype(np.float32),
        replica_seconds=rng.gamma(2.0, 300.0, shape).astype(np.float32),
        queue_end=rng.gamma(1.0, 5.0, shape).astype(np.float32),
        resp_sum=(resp * served).astype(np.float32),
        resp_max=resp,
        ups=rng.poisson(1.0, shape).astype(np.float32),
        downs=rng.poisson(1.0, shape).astype(np.float32),
        oscillations=rng.poisson(0.3, shape).astype(np.float32),
        util_mean=rng.random(shape).astype(np.float32),
        ready_mean=rng.gamma(2.0, 3.0, shape).astype(np.float32))


def _as_ref(out):
    return ref_cluster.MinuteOut(*(jnp.asarray(np.asarray(v)) for v in out))


def _assert_metrics_close(got, want, rtol=2e-4):
    for field in t_metrics.EpisodeMetrics._fields:
        a = np.asarray(getattr(got, field))
        e = np.asarray(getattr(want, field))
        tol = Q_RTOL if field.startswith(("p95", "p99")) else rtol
        np.testing.assert_allclose(a, e, rtol=tol, atol=1e-3,
                                   err_msg=field)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_matches_reference(seed):
    rng = np.random.default_rng(seed)
    out = _random_minute_out(rng, (3, int(rng.integers(30, 200))))
    got = t_metrics.compute(out, device="cpu")
    _assert_metrics_close(got, ref_metrics.compute(_as_ref(out)))
    for w in range(3):                       # and the NumPy oracle
        host = t_oracle.aggregate(t_cluster.MinuteOut(*(v[w] for v in out)))
        _assert_metrics_close(
            t_metrics.EpisodeMetrics(*(f[w] for f in got)),
            t_metrics.EpisodeMetrics(**host.as_dict()))


def test_pooled_matches_reference():
    out = _random_minute_out(np.random.default_rng(9), (2, 4, 50))
    got = t_metrics.pooled(out, device="cpu")
    assert got.slo_violation_rate.shape == (2,)
    _assert_metrics_close(got, ref_metrics.pooled(_as_ref(out)))


def test_accumulators_match_post_hoc_compute():
    """Per-minute `accum_update` / `accum_update_pooled` folds agree with
    the post-hoc paths (up to f32 summation order)."""
    out = _random_minute_out(np.random.default_rng(4), (3, 40))
    edges = t_metrics.response_edges(device="cpu")
    acc = t_metrics.accum_init(lanes=(3,), device="cpu")
    pool = t_metrics.accum_init(device="cpu")
    for m in range(40):
        minute = t_cluster.MinuteOut(*(torch.as_tensor(v[:, m])
                                       for v in out))
        acc = t_metrics.accum_update(acc, minute, edges)
        pool = t_metrics.accum_update_pooled(pool, minute, edges)
    _assert_metrics_close(t_metrics.finalize(acc, edges),
                          t_metrics.compute(out, device="cpu"))
    _assert_metrics_close(t_metrics.finalize(pool, edges),
                          t_metrics.pooled(out, device="cpu"))


def test_response_edges_match_reference():
    """The port rounds the f64 geomspace once to f32. The reference's
    f32 `jnp.geomspace` (f32 log10, linspace and pow) lands up to 9 ulp
    from that; both are far inside one log-bin (0.6%)."""
    got = t_metrics.response_edges(device="cpu").numpy()
    want = np.asarray(ref_metrics.response_edges())
    exact = np.geomspace(600.0 * 1e-5, 600.0, 1024).astype(np.float32)
    np.testing.assert_array_equal(got, exact)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 16, ulps.max()
    assert t_metrics.quantile_rel_bound() == ref_metrics.quantile_rel_bound()


def test_make_metrics_simulator_matches_reference():
    cfg = t_cluster.SimConfig()
    rates = np.random.default_rng(6).uniform(0, 2500, (3, 10)).astype(
        np.float32)
    pool, per_w = t_metrics.make_metrics_simulator(
        t_registry.make("hpa", cfg), cfg, device="cpu")(rates)
    rcfg = ref_cluster.SimConfig()
    ref_pool, ref_per_w = ref_metrics.make_metrics_simulator(
        ref_registry.make("hpa", rcfg), rcfg)(jnp.asarray(rates))
    _assert_metrics_close(pool, ref_pool)
    _assert_metrics_close(per_w, ref_per_w)


def test_rei_and_sensitivity_match_reference():
    rng = np.random.default_rng(8)
    v = rng.uniform(0.0, 0.4, (4, 3)).astype(np.float32)
    pm = rng.uniform(100.0, 30000.0, (4, 3)).astype(np.float32)
    act = rng.uniform(0.0, 400.0, (4, 3)).astype(np.float32)
    for kw in (dict(), dict(minutes=120, n_workloads=8),
               dict(baseline_pod_minutes=900.0, baseline_actions=4.0)):
        got = t_rei.rei(torch.as_tensor(v), torch.as_tensor(pm),
                        torch.as_tensor(act), **kw)
        want = ref_rei.rei(v, pm, act, **kw)
        for a, e in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-6)
        got = t_rei.sensitivity(v, pm, act, device="cpu", **kw)
        want = ref_rei.sensitivity(v, pm, act, **kw)
        for a, e in zip(got, want):
            assert a.shape == (6, 4, 3)
            np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-6)
    b = t_core_rei.rei(0.05, 2000.0, 30.0, device="cpu")
    rb = ref_core_rei.rei(0.05, 2000.0, 30.0)
    assert b.rei == pytest.approx(rb.rei, rel=1e-6)
    assert [s.rei for s in t_core_rei.sensitivity(
        0.05, 2000.0, 30.0, device="cpu")] == \
        pytest.approx([s.rei for s in ref_core_rei.sensitivity(
            0.05, 2000.0, 30.0)], rel=1e-6)


def test_core_rei_runs_on_the_card_unless_asked():
    """`core.rei` defaults to the card like every other entry point: with
    no CUDA device it raises rather than compute on the CPU."""
    if torch.cuda.is_available():
        assert t_core_rei.rei(0.05, 2000.0, 30.0).rei == pytest.approx(
            t_core_rei.rei(0.05, 2000.0, 30.0, device="cpu").rei)
        return
    for fn in (t_core_rei.rei, t_core_rei.sensitivity):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(0.05, 2000.0, 30.0)


def test_numpy_oracle_matches_reference_exactly():
    out = _random_minute_out(np.random.default_rng(11), (4, 60))
    for got, want in (
            (t_oracle.aggregate(out, workload_axis=True),
             ref_oracle.aggregate(_as_ref(out), workload_axis=True)),
            *zip(t_oracle.per_workload(out),
                 ref_oracle.per_workload(_as_ref(out)))):
        assert got.as_dict() == want.as_dict()


def test_scenarios_and_traces_are_bit_identical():
    for kw in (dict(n_workloads=5, minutes=90, seed=3),
               dict(n_workloads=3, minutes=1500, seed=1)):
        got = t_scenarios.burst_storm(**kw)
        want = ref_scenarios.burst_storm(**kw)
        np.testing.assert_array_equal(got.rates, want.rates)
        assert got.meta == want.meta
        got = t_scenarios.archetype_mix(**kw)
        want = ref_scenarios.archetype_mix(**kw)
        np.testing.assert_array_equal(got.rates, want.rates)
        assert got.meta == want.meta
    mix = {t_arch.Archetype.SPIKE: 1.0}
    got = t_synth.generate_traces(n_functions=4, n_days=1, seed=5, mix=mix)
    want = ref_synth.generate_traces(
        n_functions=4, n_days=1, seed=5,
        mix={ref_synth.Archetype.SPIKE: 1.0})
    for f in ("rates", "counts", "pattern", "base_rate"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert t_scenarios.available() == ref_scenarios.available()
    with pytest.raises(KeyError, match="unknown scenario"):
        t_scenarios.get("no_such_scenario")


def test_interop_carries_metrics_across():
    from repro_torch import interop
    out = _random_minute_out(np.random.default_rng(12), (2, 30))
    ref_em = jax.tree.map(np.asarray, ref_metrics.compute(_as_ref(out)))
    em = interop.from_reference(ref_em, device="cpu")
    assert isinstance(em, t_metrics.EpisodeMetrics)
    _assert_metrics_close(em, t_metrics.compute(out, device="cpu"))
