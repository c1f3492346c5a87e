"""The port's whole slice at a small size against the JAX reference:
burst_storm -> HPA -> make_simulator(w_chunk) -> pooled metrics -> REI,
the path ``chip_smoke.py`` runs at fleet scale on the card."""
import _torch_threads  # noqa: F401  (one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.evals import metrics as ref_metrics
from repro.evals import rei as ref_rei
from repro.scaling import registry as ref_registry
from repro.scaling import scenarios as ref_scenarios
from repro.sim import cluster as ref_cluster
from repro_torch.evals import metrics as t_metrics
from repro_torch.evals import rei as t_rei
from repro_torch.scaling import registry as t_registry
from repro_torch.scaling import scenarios as t_scenarios
from repro_torch.sim import cluster as t_cluster


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_slice_matches_reference():
    W, M = 8, 30
    sc = t_scenarios.burst_storm(n_workloads=W, minutes=M)
    out = t_cluster.make_simulator(
        t_registry.make("hpa", sc.cfg), sc.cfg, device="cpu",
        w_chunk=4)(sc.rates)
    pool = t_metrics.pooled(out, device="cpu")
    score = t_rei.rei(pool.slo_violation_rate, pool.replica_minutes,
                      pool.scaling_actions, minutes=M, n_workloads=W)

    rsc = ref_scenarios.burst_storm(n_workloads=W, minutes=M)
    np.testing.assert_array_equal(sc.rates, rsc.rates)
    ref_out = ref_cluster.make_simulator(
        ref_registry.make("hpa", rsc.cfg), rsc.cfg, decide_kernel=False,
        plant_kernel=False, w_chunk=4)(jnp.asarray(rsc.rates))
    ref_pool = ref_metrics.pooled(ref_out)
    ref_score = ref_rei.rei(ref_pool.slo_violation_rate,
                            ref_pool.replica_minutes,
                            ref_pool.scaling_actions, minutes=M,
                            n_workloads=W)

    for name, a, e in zip(t_cluster.MinuteOut._fields, out, ref_out):
        assert a.shape == (W, M)
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=3e-6,
                                   atol=1e-4, err_msg=name)
    q_rtol = 2.5 * ref_metrics.quantile_rel_bound()
    for name in t_metrics.EpisodeMetrics._fields:
        a = getattr(pool, name).numpy()
        e = np.asarray(getattr(ref_pool, name))
        rtol = q_rtol if name.startswith(("p95", "p99")) else 2e-4
        np.testing.assert_allclose(a, e, rtol=rtol, atol=1e-3, err_msg=name)
    for a, e in zip(score, ref_score):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=2e-4)
    # the REI arithmetic itself, on identical inputs, to the reference's
    # own precision
    same = t_rei.rei(*(torch.as_tensor(np.array(x)) for x in (
        ref_pool.slo_violation_rate, ref_pool.replica_minutes,
        ref_pool.scaling_actions)), minutes=M, n_workloads=W)
    for a, e in zip(same, ref_score):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-6)
    assert 0.0 <= float(score.rei) <= 1.0
