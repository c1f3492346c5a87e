"""The port's device mesh (``repro_torch.dist.sharding``,
``repro_torch.launch.mesh``) and the fleet plane under it, on the CPU.

A mesh may list one device several times, so an 8-entry mesh of the CPU
runs the same split and fold code as eight cards. The reference's own
sharded tests need an 8-device JAX run that fails under jax 0.9.0 (C3b);
here its `MeshRules.spec` runs on a stand-in mesh object (it reads only
``mesh.shape``), and its fleet and matrix run unsharded.

Tolerances: a sharded run against the port's unsharded run bit for bit
(lanes are independent; the fleet sums whole chunks' accumulators in
chunk order), except the matrix's pooled metrics, whose devices' parts
sum in another order (rtol 2e-6, counts and quantile bins equal: the
reference's pin, tests/test_fleet.py). Against the reference the fleet
and the matrix hold rtol 2e-6, quantiles at the histogram's half-bin
bound for the fleet and equal bins for the matrix.
"""
import _torch_threads  # noqa: F401  (one torch thread)
import dataclasses
import itertools
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as ref_cal
from repro.core import gbdt as ref_gbdt
from repro.core import pipeline as ref_pipeline
from repro.dist import sharding as ref_shd
from repro.evals import fleet as ref_fleet
from repro.evals import matrix as ref_matrix
from repro.evals import rei as ref_rei
from repro_torch import interop
from repro_torch.aapaset import build
from repro_torch.data import azure_synth, windows
from repro_torch.dist import sharding as shd
from repro_torch.evals import fleet, matrix
from repro_torch.evals import metrics as EM
from repro_torch.evals import rei as ER
from repro_torch.launch import mesh as launch_mesh
from repro_torch.scaling import batch, policies, registry, scenarios
from repro_torch.sim.cluster import SimConfig

CPU = torch.device("cpu")
Q_RTOL = 2.5 * EM.quantile_rel_bound()
FLEET_KW = dict(scenario="burst_storm", n_workloads=32, w_chunk=8,
                minutes=40, seed=0)
MATRIX_KW = dict(policies=("hpa", "predictive"),
                 scenarios=(("burst_storm", {}),), seeds=(0,),
                 n_workloads=8, minutes=60)


@pytest.fixture(autouse=True)
def _no_mesh():
    """Every test starts and ends without an active mesh."""
    shd.set_mesh(None)
    yield
    shd.set_mesh(None)


def _mesh(n: int):
    return shd.set_mesh(shd.Mesh([CPU] * n))


@pytest.fixture(scope="module")
def classifier(tmp_path_factory):
    """A seeded classifier: (the reference's, the port's from its npz)."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(96, 38)).astype(np.float32)
    y = rng.integers(0, 4, 96).astype(np.int32)
    params = ref_gbdt.fit(X, y, ref_gbdt.GBDTConfig(n_rounds=4, depth=3))
    cal = ref_cal.fit(np.asarray(ref_gbdt.predict_proba(
        params, jnp.asarray(X))), y)
    tr = ref_pipeline.TrainedAAPA(params, cal, 0.0, 0.0, 0.0,
                                  np.zeros(4), 96, 0.0)
    path = tmp_path_factory.mktemp("mesh") / "classifier.npz"
    tr.save(path)
    return tr, interop.trained_from_reference(path, device="cpu")


def _equal(a, b, what=""):
    for field in a._fields:
        x, e = np.asarray(getattr(a, field)), np.asarray(getattr(b, field))
        assert x.shape == e.shape and x.tobytes() == e.tobytes(), \
            f"{what}: {field}"


# ------------------------------------------------------------ mesh rules ----
class _StandIn:
    """What the reference's `MeshRules.spec` reads of a jax Mesh."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _rule_pair(shape):
    ref = ref_shd.MeshRules(
        mesh=_StandIn(shape),
        dp=tuple(a for a in ("pod", "data") if a in shape),
        mp="model" if "model" in shape else None)
    if "model" in shape:
        port = shd.set_mesh(launch_mesh.make_debug_mesh(shape["data"],
                                                        shape["model"]))
    else:
        port = _mesh(shape["data"])
    return ref, port


@pytest.mark.parametrize("shape", [{"data": 8}, {"data": 4, "model": 2}])
def test_mesh_rules_spec_matches_reference(shape):
    """`MeshRules` resolves, sizes and builds specs as the reference's on
    a grid of logical names and shapes (non-dividing dims replicate)."""
    ref, port = _rule_pair(shape)
    assert port.mesh.shape == shape and port.dp == ref.dp
    assert port.mp == ref.mp
    names = (None, "dp", "mp", "data", "model", "pod", "other")
    for logical in names:
        assert port.resolve(logical) == ref.resolve(logical), logical
        assert port.axis_size(logical) == ref.axis_size(logical), logical
    dims = (1, 2, 3, 4, 6, 8, 10, 16)
    for logicals in itertools.product(names[:5], repeat=2):
        for dims_ in itertools.product(dims, repeat=2):
            got = port.spec(logicals, dims_)
            want = ref.spec(logicals, dims_)
            assert tuple(got) == tuple(want), (logicals, dims_, got, want)
    for logicals, dims_ in ((("dp",), (10, 3)), (("dp", "mp", None),
                                                  (16, 6, 5))):
        assert tuple(port.spec(logicals, dims_)) == tuple(
            ref.spec(logicals, dims_))


def test_spec_strict_warn_once_and_replication(caplog):
    """strict= raises ValueError in both packages; a non-dividing dim
    replicates and is logged once per (logical, size, dim)."""
    ref, port = _rule_pair({"data": 8})
    for rules in (ref, port):
        with pytest.raises(ValueError, match="does not divide"):
            rules.spec(("dp",), (10,), strict=True)
    n0 = len(shd._WARNED)
    with caplog.at_level(logging.WARNING, logger=shd.__name__):
        for _ in range(3):
            assert port.spec(("dp",), (12,)) == shd.P(None)
    assert len(shd._WARNED) - n0 == 1
    assert sum("does not divide" in r.message for r in caplog.records) == 1
    assert port.spec(("dp",), (16,)) == shd.P("data")


def test_lane_sharding_of_the_matrix_rates():
    """The reference's pin: the matrix's [S, Z, W, M] rates shard W over
    "data"; without a mesh there is no sharding; strict raises on a W the
    axis does not divide."""
    rates = matrix.build_rates(matrix.spec("t_shard", **MATRIX_KW))
    assert shd.lane_sharding(rates.shape, w_axis=2, strict=True) is None
    _mesh(8)
    sh = shd.lane_sharding(rates.shape, w_axis=2, strict=True)
    assert sh.spec == shd.P(None, None, "data", None)
    assert sh.devices == (CPU,) * 8
    assert sh.bounds() == [(i, i + 1) for i in range(8)]
    with pytest.raises(ValueError, match="does not divide"):
        shd.lane_sharding((1, 1, 10, 60), w_axis=2, strict=True)
    parts = shd.scatter(rates, sh)
    assert [p.shape for p in parts] == [(1, 1, 1, 60)] * 8
    assert torch.equal(shd.gather(parts, 2, CPU), torch.as_tensor(rates))


def test_debug_mesh_shards_lanes_over_its_data_axis():
    """make_debug_mesh(4, 2): lanes split over the 4 data entries; the
    model helpers raise, naming model sharding."""
    shd.set_mesh(launch_mesh.make_debug_mesh(4, 2))
    assert shd.active().mesh.shape == {"data": 4, "model": 2}
    sh = shd.lane_sharding((2, 8, 30), w_axis=1)
    assert sh.spec == shd.P(None, "data", None) and len(sh.devices) == 4
    assert shd.lane_devices() == (CPU,) * 4
    with pytest.raises(NotImplementedError, match="model sharding"):
        shd.constrain(torch.zeros(4, 4), ("dp", "mp"))


# ------------------------------------------------------------------ fleet ----
def _fleet_specs(pols):
    return (fleet.spec("t_fleet_shard", policies=pols, **FLEET_KW),
            ref_fleet.spec("t_fleet_shard", policies=pols, **FLEET_KW))


@pytest.fixture(scope="module")
def unsharded_fleets(classifier):
    """The port's unsharded runs: {policies: (one dispatch, stream)}."""
    cls = classifier[1].make_classify()
    out = {}
    for pols in (("hpa",), ("hpa", "aapa")):
        sp, _ = _fleet_specs(pols)
        out[pols] = (fleet.run_fleet(sp, classify=cls, device="cpu"),
                     fleet.run_fleet(sp, classify=cls, stream=True,
                                     device="cpu"))
    return out


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("n", [8, 3])
@pytest.mark.parametrize("pols", [("hpa",), ("hpa", "aapa")])
def test_sharded_fleet_equals_unsharded(classifier, unsharded_fleets, pols,
                                        n, stream):
    """Chunk c on mesh entry c mod n (3: the 4 chunks not a multiple of
    the entries): pooled metrics and REI bit for bit with the unsharded
    run of the same mode."""
    sp, _ = _fleet_specs(pols)
    _mesh(n)
    got = fleet.run_fleet(sp, classify=classifier[1].make_classify(),
                          stream=stream, device="cpu")
    want = unsharded_fleets[pols][int(stream)]
    _equal(got.pooled, want.pooled, "pooled")
    _equal(got.rei, want.rei, "rei")
    assert got.meta["mesh"] == {"data": n} and got.meta["n_devices"] == 1
    assert got.meta["dispatches"] == want.meta["dispatches"]
    assert want.meta["mesh"] is None


def test_one_dispatch_takes_given_chunks(unsharded_fleets):
    """run_fleet's one-dispatch mode over given chunks (an array, or the
    chunks one by one) is the run over its own generated rates bit for
    bit; chunks of another shape raise."""
    sp, _ = _fleet_specs(("hpa",))
    want = unsharded_fleets[("hpa",)][0]
    rates = fleet.build_rates(sp)
    for chunks in (rates, iter(list(rates))):
        got = fleet.run_fleet(sp, chunks=chunks, device="cpu")
        _equal(got.pooled, want.pooled, "pooled")
        assert got.meta["dispatches"] == 1
        assert got.meta["workloads"] == sp.n_workloads
    with pytest.raises(ValueError, match="one-dispatch"):
        fleet.run_fleet(sp, chunks=rates[:2], device="cpu")


@pytest.mark.parametrize("pols", [("hpa",), ("hpa", "aapa")])
def test_sharded_fleet_matches_reference(classifier, pols):
    """The reference's pin on the port: the fleet under an 8-entry mesh
    within rtol 2e-6 of the reference's unsharded run (quantiles at the
    half-bin bound), one dispatch, mesh {"data": 8}."""
    sp, rsp = _fleet_specs(pols)
    want = ref_fleet.run_fleet(rsp, classify=classifier[0].make_classify())
    _mesh(8)
    got = fleet.run_fleet(sp, classify=classifier[1].make_classify(),
                          device="cpu")
    assert got.meta["dispatches"] == 1
    assert got.meta["mesh"] == {"data": 8}
    for field in got.pooled._fields:
        tol = max(2e-6, Q_RTOL) if field.startswith(("p95", "p99")) \
            else 2e-6
        np.testing.assert_allclose(getattr(got.pooled, field),
                                   np.asarray(getattr(want.pooled, field)),
                                   rtol=tol, atol=1e-3, err_msg=field)
    np.testing.assert_allclose(got.rei.rei, np.asarray(want.rei.rei),
                               rtol=2e-6)


def test_sharded_traced_fleet_equals_unsharded(classifier):
    """trace_lanes under a 3-entry mesh: each entry's chunks as the cells
    of its traced episode; accumulators and the trace in chunk order,
    bit for bit with the unsharded capture."""
    sp = dataclasses.replace(_fleet_specs(("hpa", "aapa"))[0],
                             trace_lanes=3)
    cls = classifier[1].make_classify()
    want = fleet.run_fleet(sp, classify=cls, device="cpu")
    _mesh(3)
    got = fleet.run_fleet(sp, classify=cls, device="cpu")
    _equal(got.pooled, want.pooled, "pooled")
    _equal(got.trace.decisions, want.trace.decisions, "decisions")
    _equal(got.trace.minutes, want.trace.minutes, "minutes")
    assert got.trace.decisions.minute.shape[0] == sp.n_chunks


# ----------------------------------------------------------------- matrix ----
@pytest.fixture(scope="module")
def matrix_runs():
    """(spec, rates, the reference's unsharded (pooled, REI), the port's
    unsharded (pooled, per workload))."""
    sp = matrix.spec("t_shard", **MATRIX_KW)
    rates = matrix.build_rates(sp)
    rpool, _ = ref_matrix.make_runner(ref_matrix.spec("t_shard",
                                                      **MATRIX_KW))(rates)
    rrei = ref_rei.rei(rpool.slo_violation_rate, rpool.replica_minutes,
                       rpool.scaling_actions, minutes=sp.minutes,
                       n_workloads=sp.n_workloads).rei
    return sp, rates, (rpool, rrei), matrix.make_runner(sp, device="cpu")(
        rates)


def test_sharded_matrix_matches_reference(matrix_runs):
    """THE acceptance pin of the reference, on the port: pooled metrics
    and REI under an 8-entry mesh within rtol 2e-6 of the reference's
    unsharded run, quantile bins equal."""
    sp, rates, (rpool, rrei), _ = matrix_runs
    _mesh(8)
    pool, _ = matrix.make_runner(sp, device="cpu")(rates)
    for field in ("slo_violation_rate", "mean_response_ms",
                  "replica_minutes", "avg_cpu_util", "scaling_actions",
                  "total_requests"):
        np.testing.assert_allclose(getattr(pool, field).numpy(),
                                   np.asarray(getattr(rpool, field)),
                                   rtol=2e-6, err_msg=field)
    # equal bins: each package computes its bin representatives in its
    # own f32 order (3e-7 apart), adjacent bins lie percents apart
    edges = np.asarray(EM.response_edges(sp.bins, device="cpu"))
    for field in ("p95_response_ms", "p99_response_ms"):
        got = getattr(pool, field).numpy()
        want = np.asarray(getattr(rpool, field))
        np.testing.assert_array_equal(
            np.searchsorted(edges, got / 1e3), np.searchsorted(
                edges, want / 1e3), err_msg=field)
        np.testing.assert_allclose(got, want, rtol=2e-6, err_msg=field)
    rei = ER.rei(pool.slo_violation_rate, pool.replica_minutes,
                 pool.scaling_actions, minutes=sp.minutes,
                 n_workloads=sp.n_workloads).rei
    np.testing.assert_allclose(rei.numpy(), np.asarray(rrei), rtol=2e-6,
                               atol=2e-6)


@pytest.mark.parametrize("n", [8, 3])
def test_sharded_matrix_per_workload_equals_unsharded(matrix_runs, n):
    """Per-workload accumulators come back in lane order bit for bit (3:
    W = 8 does not divide, the run is whole on the first entry); pooled
    ones at rtol 2e-6 with counts and quantile bins equal."""
    sp, rates, _, (pool1, per1) = matrix_runs
    _mesh(n)
    pool, per = matrix.make_runner(sp, device="cpu")(rates)
    _equal(per, per1, "per workload")
    for field in pool._fields:
        np.testing.assert_allclose(getattr(pool, field).numpy(),
                                   getattr(pool1, field).numpy(),
                                   rtol=2e-6, atol=0, err_msg=field)
    for field in ("scaling_actions", "oscillations", "p95_response_ms",
                  "p99_response_ms", "total_requests"):
        assert torch.equal(getattr(pool, field), getattr(pool1, field))


def test_sharded_pooled_matrix_and_evaluator(matrix_runs):
    """The fleet-scale pooled mode and the controller evaluator (tuning's
    scorer) under the mesh, at rtol 2e-6 of their unsharded runs."""
    sp, rates, _, _ = matrix_runs
    ctrls = matrix.controllers(sp)
    want = (matrix.make_runner(sp, device="cpu", per_workload=False)(
        rates)[0], matrix.make_controller_evaluator(
        ctrls, sp.sim_config(), device="cpu", per_workload=False)(
        rates[0, 0])[0])
    _mesh(2)
    got = (matrix.make_runner(sp, device="cpu", per_workload=False,
                              w_chunk=2)(rates)[0],
           matrix.make_controller_evaluator(
               ctrls, sp.sim_config(), device="cpu", per_workload=False)(
               rates[0, 0])[0])
    for g, w in zip(got, want):
        for field in g._fields:
            np.testing.assert_allclose(getattr(g, field).numpy(),
                                       getattr(w, field).numpy(),
                                       rtol=2e-6, atol=0, err_msg=field)


def test_telemetry_under_a_mesh_needs_shard_false(matrix_runs):
    """Traced runs under a 4-entry mesh need no ``shard=False`` any more:
    each entry traces the sampled lanes of its slice (3 of W = 8 here, so
    one entry traces none; the first 30 minutes) and the traces join in
    lane order. The
    matrix's trace and per-workload accumulators, pooled or not, and the
    batch simulator's MinuteOut and trace equal the unsharded runs' bit
    for bit; the matrix's pooled-only metrics at rtol 2e-6 (the devices'
    parts sum in another order), scaling actions exact. ``shard=False``
    runs whole on one device, bit for bit too."""
    sp, rates, _, _ = matrix_runs
    rates = rates[..., :30]                    # the traced path is eager
    want = {per: matrix.make_runner(sp, device="cpu", telemetry=True,
                                    trace_lanes=3, per_workload=per)(rates)
            for per in (True, False)}
    cfg = SimConfig()
    ctrls = [registry.make("hpa", cfg), registry.make("predictive", cfg)]
    sim = batch.make_batch_simulator(ctrls, cfg, device="cpu",
                                     telemetry=True, trace_lanes=3)
    want_batch = sim(rates[0, 0])
    _mesh(4)
    for per, shard in ((True, True), (True, False), (False, True)):
        pool1, per1, ct1 = want[per]
        pool, per_w, ct = matrix.make_runner(
            sp, device="cpu", telemetry=True, trace_lanes=3,
            per_workload=per, shard=shard)(rates)
        what = f"per_workload {per} shard {shard}"
        _equal(ct.decisions, ct1.decisions, f"{what} decisions")
        _equal(ct.minutes, ct1.minutes, f"{what} minutes")
        assert ct.decisions.minute.shape[-1] == 3
        if per:
            _equal(per_w, per1, f"{what} per workload")
            _equal(pool, pool1, f"{what} pooled")
            continue
        for field in pool._fields:
            np.testing.assert_allclose(
                getattr(pool, field).numpy(),
                getattr(pool1, field).numpy(), rtol=2e-6, atol=0,
                err_msg=f"{what} {field}")
        assert torch.equal(pool.scaling_actions, pool1.scaling_actions)
    out, ct = sim(rates[0, 0])
    _equal(out, want_batch[0], "batch MinuteOut")
    _equal(ct.decisions, want_batch[1].decisions, "batch decisions")
    _equal(ct.minutes, want_batch[1].minutes, "batch minutes")


# ------------------------------------------------ batch simulator, build ----
def test_sharded_batch_simulator_equals_unsharded(classifier):
    """make_batch_simulator under a 2-entry mesh (and w_chunk within each
    entry's slice), HPA and AAPA, and the grid simulator: MinuteOut
    [P, W, M] bit for bit."""
    cfg = SimConfig()
    ctrls = [registry.make("hpa", cfg), registry.make(
        "aapa", cfg, classify=classifier[1].make_classify())]
    rates = scenarios.archetype_mix(n_workloads=8, minutes=40,
                                    seed=2).rates
    want = batch.make_batch_simulator(ctrls, cfg, device="cpu")(rates)
    _mesh(2)
    for w_chunk in (None, 2):
        got = batch.make_batch_simulator(ctrls, cfg, device="cpu",
                                         w_chunk=w_chunk)(rates)
        _equal(got, want, f"w_chunk {w_chunk}")
    got = batch.make_grid_simulator("hpa", [{"target": 0.6},
                                            {"target": 0.8}], cfg,
                                    device="cpu")(rates)
    shd.set_mesh(None)
    _equal(got, batch.make_grid_simulator(
        "hpa", [{"target": 0.6}, {"target": 0.8}], cfg, device="cpu")(
        rates), "grid")


def test_sharded_featurize_windows_equals_unsharded():
    """The AAPAset featurization, chunks round-robin over a 3-entry mesh:
    features, labels, confidence and votes bit for bit."""
    traces = azure_synth.generate_traces(n_functions=6, n_days=2, seed=4)
    wins = windows.make_windows(traces).windows[:700]
    want = build.featurize_windows(wins, chunk=128, device="cpu")
    _mesh(3)
    got = build.featurize_windows(wins, chunk=128, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_classifier_placement(classifier):
    """`Classify.to` and `TrainedAAPA.to` are the classifier itself on its
    own device; `policies.on_device` rebuilds an AAPA controller only when
    its classifier lies elsewhere (here a stand-in classifier whose `to`
    makes a new one), and leaves a policy without one alone."""
    trained = classifier[1]
    cls = trained.make_classify()
    assert cls.to("cpu") is cls and cls.device == CPU
    assert trained.to(CPU).params is trained.params

    class Elsewhere:
        def to(self, device):
            return Elsewhere()

    cfg = SimConfig()
    ctrl = registry.make("aapa", cfg, classify=cls)
    assert policies.on_device(ctrl, cfg, CPU) is ctrl
    hpa = registry.make("hpa", cfg)
    assert policies.on_device(hpa, cfg, CPU) is hpa
    far = registry.make("hybrid", cfg, classify=Elsewhere())
    placed = policies.on_device(far, cfg, CPU)
    assert placed is not far and placed.name == "hybrid"
    assert isinstance(placed.hyper["classify"], Elsewhere)
    assert placed.hyper["classify"] is not far.hyper["classify"]
    assert placed.hyper["guard_target"] == far.hyper["guard_target"]


def _entry_points(matrix_sp, rates):
    """Each lane-sharded entry point asked for `device`, run once."""
    sp = fleet.spec("t_fleet_place", policies=("hpa",), **FLEET_KW)
    hpa = [registry.make("hpa", SimConfig())]
    wins = np.zeros((4, 60), np.float32)
    return {
        "fleet runner": lambda d: fleet.make_fleet_runner(sp, device=d),
        "chunk folder": lambda d: fleet.make_chunk_folder(sp, device=d),
        "run_fleet": lambda d: fleet.run_fleet(sp, device=d),
        "batch": lambda d: batch.make_batch_simulator(hpa, device=d)(
            rates[0, 0]),
        "matrix": lambda d: matrix.make_runner(matrix_sp, device=d)(rates),
        "evaluator": lambda d: matrix.make_controller_evaluator(
            hpa, SimConfig(), device=d)(rates[0, 0]),
        "featurize": lambda d: build.featurize_windows(wins, device=d),
    }


@pytest.mark.parametrize("entry", ["fleet runner", "chunk folder",
                                   "run_fleet", "batch", "matrix",
                                   "evaluator", "featurize"])
def test_device_of_another_type_than_the_mesh_raises(matrix_runs, entry):
    """Under a CPU mesh an entry point asked for a device of another type
    raises ValueError instead of choosing a path for tensors that sit
    elsewhere; the mesh's own type passes the check."""
    sp, rates, _, _ = matrix_runs
    run = _entry_points(sp, rates)[entry]
    _mesh(2)
    with pytest.raises(ValueError, match="disagrees with the active mesh"):
        run("meta")
    with pytest.raises(ValueError, match="disagrees with the active mesh"):
        shd.check_device("cuda")
    shd.check_device("cpu")
