"""The port's fleet runner (``repro_torch.evals.fleet``) against the JAX
reference's (``repro.evals.fleet``) on the CPU, unsharded (the
reference's sharded fleet test fails under jax 0.9.0, C3b).

Tolerances are the reference's own (tests/test_fleet.py): pooled metrics
at rtol 2e-4 against the reference (the port pools each chunk's
[w_chunk, M] outputs at once, the reference minute by minute in its
scan, so the f32 sums run in another order), one-dispatch against
streaming at rtol 2e-6; quantiles at the histogram's half-bin bound
(they snap to bin representatives), atol 1e-3 throughout. REI likewise.
Chunk rates and seeds are NumPy and equal bit for bit.
"""
import dataclasses

import numpy as np
import pytest

from repro.aapaset import loader as ref_loader_mod
from repro.aapaset import registry as ref_registry
from repro.aapaset import build as ref_build
from repro.evals import fleet as ref_fleet
from repro_torch.aapaset import build, loader
from repro_torch.evals import fleet, matrix
from repro_torch.evals import metrics as EM

Q_RTOL = 2.5 * EM.quantile_rel_bound()
SPEC_KW = dict(policies=("hpa", "predictive"), scenario="burst_storm",
               n_workloads=8, w_chunk=4, minutes=40, seed=3)
FLEET_SPEC = fleet.spec("t_fleet", **SPEC_KW)          # tests/test_fleet.py
REF_SPEC = ref_fleet.spec("t_fleet", **SPEC_KW)


def _close(a, b, *, rtol):
    for field in EM.EpisodeMetrics._fields:
        tol = max(rtol, Q_RTOL) if field.startswith(("p95", "p99")) \
            else rtol
        np.testing.assert_allclose(
            np.asarray(getattr(a, field)), np.asarray(getattr(b, field)),
            rtol=tol, atol=1e-3, err_msg=field)


@pytest.fixture(scope="module")
def runs():
    return (ref_fleet.run_fleet(REF_SPEC),
            fleet.run_fleet(FLEET_SPEC, device="cpu"),
            fleet.run_fleet(FLEET_SPEC, stream=True, device="cpu"))


def test_fleet_matches_reference(runs):
    ref, one, _ = runs
    _close(one.pooled, ref.pooled, rtol=2e-4)
    np.testing.assert_allclose(one.rei.rei, np.asarray(ref.rei.rei),
                               rtol=2e-4)
    assert one.pooled.slo_violation_rate.shape == (2,)
    for key in ("workloads", "minutes", "policies", "w_chunk",
                "dispatches", "stream"):
        assert one.meta[key] == ref.meta[key], key
    assert one.meta["n_devices"] == 1 and one.meta["mesh"] is None
    assert one.meta["peak_device_bytes"] is None      # the CPU has none
    assert one.trace is None


def test_one_dispatch_matches_stream(runs):
    ref, one, streamed = runs
    assert one.meta["dispatches"] == 1
    assert streamed.meta["dispatches"] == FLEET_SPEC.n_chunks
    _close(one.pooled, streamed.pooled, rtol=2e-6)
    np.testing.assert_allclose(one.rei.rei, streamed.rei.rei, rtol=2e-6)
    assert 0.0 <= streamed.meta["gen_share"] <= 1.0
    assert streamed.meta["gen_s"] > 0


def test_fleet_matches_controller_evaluator(runs):
    """The chunked pooled metrics agree with the unchunked pooled
    evaluator on the same rates."""
    _, one, _ = runs
    rates = fleet.build_rates(FLEET_SPEC)
    W, M = FLEET_SPEC.n_workloads, FLEET_SPEC.minutes
    pool, none = matrix.evaluate_controllers(
        fleet.controllers(FLEET_SPEC), rates.reshape(W, M),
        FLEET_SPEC.sim_config(), per_workload=False, device="cpu")
    assert none is None
    _close(one.pooled, type(pool)(*(a.numpy() for a in pool)), rtol=2e-4)
    assert one.meta["lane_minutes_per_sec"] > 0


def test_chunk_rates_bit_for_bit():
    for c in range(FLEET_SPEC.n_chunks):
        assert fleet.chunk_seed(3, c) == ref_fleet.chunk_seed(3, c)
        a = fleet.chunk_rates(FLEET_SPEC, c)
        b = ref_fleet.chunk_rates(REF_SPEC, c)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(fleet.build_rates(FLEET_SPEC),
                                  ref_fleet.build_rates(REF_SPEC))
    streamed = list(fleet.rate_chunks(FLEET_SPEC))
    assert len(streamed) == FLEET_SPEC.n_chunks
    assert not np.array_equal(streamed[0], streamed[1])


def test_trace_lanes_raises():
    """The decision trace needs the one-dispatch mode: a stream with
    `trace_lanes` raises, as in the reference (the traced runs themselves
    are tests/test_torch_obs.py's)."""
    sp = dataclasses.replace(FLEET_SPEC, trace_lanes=2)
    with pytest.raises(ValueError, match="one-dispatch"):
        fleet.run_fleet(sp, stream=True, device="cpu")
    with pytest.raises(ValueError, match="one-dispatch"):
        ref_fleet.run_fleet(dataclasses.replace(REF_SPEC, trace_lanes=2),
                            stream=True)


def test_fleet_spec_validates_chunking():
    with pytest.raises(ValueError, match="must divide"):
        fleet.spec("bad", policies=("hpa",), n_workloads=10, w_chunk=4)
    sp = fleet.spec("ok", policies=("hpa",), n_workloads=12, w_chunk=4,
                    sim={"control_interval_sec": 30},
                    scenario_kw={"burst_prob": 0.1})
    assert sp.n_chunks == 3 and sp.sim == (("control_interval_sec", 30),)
    assert sp.sim_config().control_interval_sec == 30


def test_loader_fed_stream_matches_reference():
    """A stream fed by `AAPAsetLoader.rate_chunks` (real traces) under
    HPA and AAPA (the default classifier), against the reference's run
    on the same artifact's chunks."""
    cfg = dict(n_functions=4, n_days=2, chunk=512)
    data = ref_build.build(ref_registry.get("aapaset_ci", **cfg))
    man = {"config": {"name": "aapaset_ci"}, "hash": "0" * 12}
    ref_ld = ref_loader_mod.AAPAsetLoader(data, man)
    port_ld = loader.AAPAsetLoader(
        build.BuiltDataset(**dataclasses.asdict(data)), man, device="cpu")
    kw = dict(policies=("hpa", "aapa"), n_workloads=6, w_chunk=3,
              minutes=30, seed=0)
    ref = ref_fleet.run_fleet(ref_fleet.spec("t_loader", **kw), stream=True,
                              chunks=ref_ld.rate_chunks(6, 3, minutes=30))
    got = fleet.run_fleet(fleet.spec("t_loader", **kw), stream=True,
                          chunks=port_ld.rate_chunks(6, 3, minutes=30),
                          device="cpu")
    assert got.meta["workloads"] == ref.meta["workloads"] == 6
    _close(got.pooled, ref.pooled, rtol=2e-4)
    np.testing.assert_allclose(got.rei.rei, np.asarray(ref.rei.rei),
                               rtol=2e-4)
