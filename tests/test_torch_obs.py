"""The port's decision telemetry (``repro_torch.obs``, ``simulate(...,
telemetry=True)`` and the runners over it) against the JAX reference's
(``repro.obs``) on the CPU.

The same NumPy-seeded rates go through both packages: the reference's
blocked scan with telemetry, the port's blocked loop with
``device="cpu"``. What is held, and how:

* the port's traced `MinuteOut` equals its untraced run bit for bit;
* discrete record fields (minute, sec, scale_up, scale_down,
  cooldown_blocked, capacity_capped, archetype) equal the reference's
  exactly, and NaN stands where the reference has NaN;
* plant fields at the episode tolerance (rtol 3e-6 / atol 1e-4);
* forecast fields (fc_*, confidence, guard_floor) at the forecast
  tolerance (rtol 1e-4 / atol 1e-3): the port does not contract products
  into adds where XLA does (ROADMAP C, standing differences);
* blame: `attribute` on one numpy trace gives the same `Blame` in both
  packages exactly; on each package's own trace the blame counts are
  equal for every policy on these inputs.
"""
import _torch_threads  # noqa: F401  (one torch thread)
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.evals import fleet as ref_fleet
from repro.evals import matrix as ref_matrix
from repro.obs import artifacts as ref_OA
from repro.obs import attribute as ref_AT
from repro.obs import trace as ref_T
from repro.scaling import batch as ref_batch
from repro.scaling import registry as ref_registry
from repro.sim import cluster as ref_cluster
from repro_torch.evals import fleet, matrix
from repro_torch.obs import artifacts as OA
from repro_torch.obs import attribute as AT
from repro_torch.obs import trace as T
from repro_torch.scaling import batch, registry, scenarios
from repro_torch.sim import cluster

POLICIES = ("hpa", "kpa", "predictive", "aapa", "hybrid")
CIS = (15, 7)
DISCRETE = ("minute", "sec", "scale_up", "scale_down", "cooldown_blocked",
            "capacity_capped", "archetype")
FORECAST = ("fc_point", "fc_lo", "fc_hi", "confidence", "guard_floor")
EPISODE_TOL = dict(rtol=3e-6, atol=1e-4)
FORECAST_TOL = dict(rtol=1e-4, atol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rates(ci, n=3, minutes=40, seed=3):
    cfg = cluster.SimConfig(control_interval_sec=ci)
    return np.asarray(scenarios.get("burst_storm", n_workloads=n,
                                    minutes=minutes, seed=seed,
                                    cfg=cfg).rates, np.float32)


def _np(tree):
    return type(tree)(*(np.asarray(a.detach().cpu()) if
                        isinstance(a, torch.Tensor) else np.asarray(a)
                        for a in tree))


def _assert_records(got, want, where=""):
    """A port DecisionRecord against the reference's, by field kind."""
    got, want = _np(got), _np(want)
    for field in T.DecisionRecord._fields:
        a, e = getattr(got, field), getattr(want, field)
        assert a.shape == e.shape, (where, field, a.shape, e.shape)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(e),
                                      err_msg=f"{where} {field} NaN")
        if field in DISCRETE:
            np.testing.assert_array_equal(a, e, err_msg=f"{where} {field}")
        else:
            tol = FORECAST_TOL if field in FORECAST else EPISODE_TOL
            np.testing.assert_allclose(a, e, equal_nan=True,
                                       err_msg=f"{where} {field}", **tol)


def _assert_minutes(got, want, where=""):
    for field, a, e in zip(T.MinuteTrace._fields, _np(got), _np(want)):
        assert a.shape == e.shape, (where, field)
        np.testing.assert_allclose(a, e, err_msg=f"{where} {field}",
                                   **EPISODE_TOL)


def _same(a, b, where=""):
    """Bit for bit, NaN where NaN."""
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                               msg=lambda m: f"{where}: {m}")


def _assert_equal_out(a, b, where=""):
    for field, x, y in zip(a._fields, a, b):
        _same(x, y, f"{where} {field}")


#: EpisodeMetrics fields that are counts or ratios of counts
COUNT_FIELDS = ("overprovision_rate", "scaling_actions", "oscillations",
                "mean_action_interval_min")


def _assert_pooled_close(a, b, where=""):
    """Pooled metrics of a minute-by-minute fold (the traced runners)
    against a fold of whole [W, M] chunks (the untraced ones): the counts
    exact, the sums at rtol 2e-6 (f32 summation order)."""
    for field, x, y in zip(a._fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        if field in COUNT_FIELDS:
            np.testing.assert_array_equal(x, y, err_msg=f"{where} {field}")
        else:
            np.testing.assert_allclose(x, y, rtol=2e-6, atol=0,
                                       err_msg=f"{where} {field}")


# --------------------------------------------------------------- simulate
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("ci", CIS)
def test_simulate_telemetry_matches_reference(policy, ci):
    """Traced `simulate` of W lanes: MinuteOut bit for bit with the
    untraced run, the trace ([W, M, H] / [W, M]) against the reference's
    `make_simulator(telemetry=True)`."""
    rates = _rates(ci)
    cfg = cluster.SimConfig(control_interval_sec=ci)
    rcfg = ref_cluster.SimConfig(control_interval_sec=ci)
    ctrl = registry.make(policy, cfg)
    base = cluster.simulate(torch.as_tensor(rates), ctrl, cfg, device="cpu")
    out, ct = cluster.simulate(torch.as_tensor(rates), ctrl, cfg,
                               device="cpu", telemetry=True)
    _assert_equal_out(base, out, "telemetry on vs off")
    H = len(T.head_schedule(cfg))
    assert ct.decisions.desired.shape == rates.shape + (H,)
    assert ct.minutes.rate.shape == rates.shape
    _, rct = ref_cluster.make_simulator(
        ref_registry.make(policy, rcfg), rcfg, telemetry=True)(
            jnp.asarray(rates))
    _assert_records(ct.decisions, rct.decisions, f"{policy} ci={ci}")
    _assert_minutes(ct.minutes, rct.minutes, f"{policy} ci={ci}")


def test_single_lane_and_chunked_simulator_layouts():
    """One lane gives [M, H] / [M]; `make_simulator(w_chunk=...)` gives
    the unchunked trace, lanes first."""
    cfg = cluster.SimConfig()
    rates = torch.as_tensor(_rates(15, n=4, minutes=12))
    ctrl = registry.make("predictive", cfg)
    _, one = cluster.simulate(rates[1], ctrl, cfg, device="cpu",
                              telemetry=True)
    assert one.decisions.desired.shape == (12, 4)
    assert one.minutes.rate.shape == (12,)
    out, ct = cluster.make_simulator(ctrl, cfg, device="cpu",
                                     telemetry=True)(rates)
    out2, ct2 = cluster.make_simulator(ctrl, cfg, device="cpu", w_chunk=2,
                                       telemetry=True)(rates)
    _assert_equal_out(out, out2)
    for a, b in zip((*ct.decisions, *ct.minutes),
                    (*ct2.decisions, *ct2.minutes)):
        _same(a, b)
    for a, b in zip(one.decisions, ct.decisions):
        _same(a, b[1])


def test_trace_head_schedule_nondividing_interval():
    """ci 7 does not divide 60: the trace's sec field replays the blocked
    loop's head schedule, the tail head included."""
    cfg = cluster.SimConfig(control_interval_sec=7)
    heads = T.head_schedule(cfg)
    assert heads == [0, 7, 14, 21, 28, 35, 42, 49, 56]
    assert heads == ref_T.head_schedule(ref_cluster.SimConfig(
        control_interval_sec=7))
    _, ct = cluster.simulate(torch.as_tensor(_rates(7, minutes=5)[0]),
                             registry.make("hpa", cfg), cfg, device="cpu",
                             telemetry=True)
    np.testing.assert_array_equal(ct.decisions.sec[0].numpy(),
                                  np.asarray(heads, np.float32))
    np.testing.assert_array_equal(ct.decisions.minute[:, 0].numpy(),
                                  np.arange(5, dtype=np.float32))


def test_explain_signals_per_policy():
    """hpa and kpa report no signals (NaN), predictive the forecast, aapa
    adds confidence and archetype, hybrid adds the guard floor; hybrid's
    floor is what its decide enforces."""
    cfg = cluster.SimConfig()
    rates = torch.as_tensor(_rates(15, minutes=30))
    d = {p: cluster.simulate(rates, registry.make(p, cfg), cfg,
                             device="cpu", telemetry=True)[1].decisions
         for p in POLICIES}
    for p in ("hpa", "kpa"):
        assert registry.make(p, cfg).explain is None
        assert torch.isnan(d[p].fc_point).all()
    assert torch.isfinite(d["predictive"].fc_point).any()
    assert torch.isnan(d["predictive"].confidence).all()
    assert torch.isfinite(d["aapa"].confidence).all()
    assert torch.isfinite(d["aapa"].archetype).all()
    assert torch.isnan(d["aapa"].guard_floor).all()
    floor = d["hybrid"].guard_floor
    assert torch.isfinite(floor).all()
    assert (d["hybrid"].desired_raw >= floor).all()


def test_rebuilt_controllers_keep_explain():
    cfg = cluster.SimConfig()
    for p in ("aapa", "hybrid"):
        ctrl = registry.make(p, cfg)
        from repro_torch.scaling import policies
        assert policies.rebuild(ctrl, cfg).explain is not None


# ------------------------------------------------------------ the runners
@pytest.mark.parametrize("ci", CIS)
def test_batch_telemetry_matches_reference(ci):
    """`make_batch_simulator(telemetry=True, trace_lanes=K)`: MinuteOut
    bit for bit with the untraced batch, the trace [M, H, P, K] against
    the reference's fused batch."""
    rates = _rates(ci, n=4, minutes=30)
    cfg = cluster.SimConfig(control_interval_sec=ci)
    rcfg = ref_cluster.SimConfig(control_interval_sec=ci)
    ctrls = [registry.make(p, cfg) for p in POLICIES]
    base = batch.make_batch_simulator(ctrls, cfg, device="cpu")(rates)
    out, ct = batch.make_batch_simulator(ctrls, cfg, device="cpu",
                                         telemetry=True,
                                         trace_lanes=2)(rates)
    _assert_equal_out(base, out)
    H = len(T.head_schedule(cfg))
    assert ct.decisions.desired.shape == (30, H, len(POLICIES), 2)
    assert ct.minutes.rate.shape == (30, len(POLICIES), 2)
    _, rct = ref_batch.make_batch_simulator(
        [ref_registry.make(p, rcfg) for p in POLICIES], rcfg,
        telemetry=True, trace_lanes=2)(jnp.asarray(rates))
    _assert_records(ct.decisions, rct.decisions, f"batch ci={ci}")
    _assert_minutes(ct.minutes, rct.minutes, f"batch ci={ci}")


def _matrix_specs(ci):
    kw = dict(policies=POLICIES, forecasters=("holt_winters", "ewma"),
              scenarios=(("burst_storm", {}), ("idle_wake", {})),
              seeds=(0,), n_workloads=3, minutes=25,
              sim={"control_interval_sec": ci})
    return ref_matrix.spec("t_obs", **kw), matrix.spec("t_obs", **kw)


@pytest.mark.parametrize("ci", CIS)
def test_matrix_telemetry_matches_reference(ci):
    """`make_runner(telemetry=True)`: metrics bit for bit with the
    untraced runner per workload, and pooled (folded minute by minute as
    the traced episode runs) at `_assert_pooled_close`; the trace [S, Z,
    M, H, F, P, K] against the reference's; `make_controller_evaluator`
    the same on one cell."""
    rsp, sp = _matrix_specs(ci)
    rates = matrix.build_rates(sp)
    for per_workload in (True, False):
        base = matrix.make_runner(sp, device="cpu",
                                  per_workload=per_workload)(rates)
        got = matrix.make_runner(sp, device="cpu", per_workload=per_workload,
                                 telemetry=True, trace_lanes=2)(rates)
        check = _assert_equal_out if per_workload else _assert_pooled_close
        for b, g in zip(base, got[:2]):
            if b is not None:
                check(b, g, f"per_workload={per_workload}")
    ct = got[2]
    S, Z, F, P = sp.shape
    H = len(T.head_schedule(sp.sim_config()))
    assert ct.decisions.desired.shape == (S, Z, sp.minutes, H, F, P, 2)
    assert ct.minutes.violated.shape == (S, Z, sp.minutes, F, P, 2)
    _, _, rct = ref_matrix.make_runner(rsp, telemetry=True,
                                       trace_lanes=2)(rates)
    _assert_records(ct.decisions, rct.decisions, f"matrix ci={ci}")
    _assert_minutes(ct.minutes, rct.minutes, f"matrix ci={ci}")

    ctrls = matrix.controllers(sp)
    pool, per_w, ect = matrix.make_controller_evaluator(
        ctrls, sp.sim_config(), device="cpu", telemetry=True,
        trace_lanes=2)(rates[1, 0])
    assert ect.decisions.desired.shape == (sp.minutes, H, F * P, 2)
    for a, b in zip(ect.decisions, ct.decisions):
        _same(a, b[1, 0].reshape(a.shape))


@pytest.mark.parametrize("ci", CIS)
def test_fleet_trace_lanes_matches_reference(ci):
    """`FleetSpec.trace_lanes`: K sampled lanes per chunk, [C, M, H, P,
    K]; pooled metrics (folded minute by minute) against the untraced
    one-dispatch run at `_assert_pooled_close`; the stream refuses it."""
    kw = dict(policies=POLICIES, n_workloads=6, w_chunk=3, minutes=25,
              seed=1, sim={"control_interval_sec": ci})
    r0 = fleet.run_fleet(fleet.spec("t_obs", **kw), device="cpu")
    sp = fleet.spec("t_obs", trace_lanes=2, **kw)
    r1 = fleet.run_fleet(sp, device="cpu")
    assert r0.trace is None
    _assert_pooled_close(r0.pooled, r1.pooled, "fleet")
    H = len(T.head_schedule(sp.sim_config()))
    assert r1.trace.decisions.desired.shape == (2, 25, H, len(POLICIES), 2)
    assert r1.trace.minutes.rate.shape == (2, 25, len(POLICIES), 2)
    rr = ref_fleet.run_fleet(ref_fleet.spec("t_obs", trace_lanes=2, **kw))
    _assert_records(r1.trace.decisions, rr.trace.decisions, "fleet")
    _assert_minutes(r1.trace.minutes, rr.trace.minutes, "fleet")
    with pytest.raises(ValueError, match="one-dispatch"):
        fleet.run_fleet(sp, stream=True, device="cpu")


def test_fused_kernel_and_chunks_refuse_telemetry():
    """No quiet fallback: asking the fused episode kernel for a trace
    raises the reference's ValueError; batch telemetry refuses
    `w_chunk`."""
    cfg = cluster.SimConfig()
    ctrl = registry.make("hpa", cfg)
    rates = torch.as_tensor(_rates(15, minutes=5))
    with pytest.raises(ValueError, match="decide_kernel"):
        cluster.simulate(rates, ctrl, cfg, device="cpu", decide_kernel=True,
                         telemetry=True)
    with pytest.raises(ValueError, match="decide_kernel"):
        cluster.make_simulator(ctrl, cfg, device="cpu", decide_kernel=True,
                               telemetry=True)
    with pytest.raises(ValueError, match="decide_kernel"):
        batch.make_batch_simulator([ctrl], cfg, device="cpu",
                                   decide_kernel=True, telemetry=True)
    with pytest.raises(ValueError, match="w_chunk"):
        batch.make_batch_simulator([ctrl], cfg, device="cpu", w_chunk=1,
                                   telemetry=True)
    with pytest.raises(ValueError, match="w_chunk"):
        matrix.make_runner(matrix.smoke_spec(), device="cpu", w_chunk=1,
                           telemetry=True)


# ----------------------------------------------------------- trace helpers
def test_trace_helpers_match_reference():
    for W, k in ((10, 3), (7, 7), (100, 16), (5, None), (1, 1)):
        got, want = T.sample_lanes(W, k), ref_T.sample_lanes(W, k)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="positive"):
        T.sample_lanes(10, 0)
    recs = [T.DecisionRecord(*(float(i + j) for j in
                               range(len(T.DecisionRecord._fields))))
            for i in range(3)]
    rrecs = [ref_T.DecisionRecord(*r) for r in recs]
    for a, b in zip(T.stack_records(recs), ref_T.stack_records(rrecs)):
        np.testing.assert_array_equal(a, b)
    assert T.stack_records([]).minute.shape == (0,)
    nan = T.explain_nan((2,))
    assert nan._fields == ref_T.ExplainOut._fields
    assert all(torch.isnan(x).all() for x in nan)


# ------------------------------------------------------------ attribution
def _own_traces(policy, ci=15):
    """(the port's numpy trace, the reference's) of one lane."""
    cfg = cluster.SimConfig(control_interval_sec=ci)
    rcfg = ref_cluster.SimConfig(control_interval_sec=ci)
    rates = _rates(ci, n=3, minutes=60, seed=5)[1]
    _, ct = cluster.simulate(torch.as_tensor(rates),
                             registry.make(policy, cfg), cfg, device="cpu",
                             telemetry=True)
    _, rct = ref_cluster.simulate(jnp.asarray(rates),
                                  ref_registry.make(policy, rcfg), rcfg,
                                  telemetry=True)
    return T.to_numpy(ct), ref_T.to_numpy(rct), cfg


def _assert_blame_equal(a, b):
    np.testing.assert_array_equal(a.cause, b.cause)
    np.testing.assert_array_equal(a.responsible, b.responsible)
    np.testing.assert_array_equal(a.need, b.need)
    assert a.counts == b.counts


@pytest.mark.parametrize("policy", POLICIES)
def test_blame_matches_reference(policy):
    """`attribute` of the two packages on one numpy trace: the same Blame
    exactly; and on each package's own trace the same blame counts."""
    ct, rct, cfg = _own_traces(policy)
    for trace in (ct, rct):
        _assert_blame_equal(AT.attribute(trace, cfg),
                            ref_AT.attribute(trace, cfg))
    own, ref_own = AT.attribute(ct, cfg), ref_AT.attribute(rct, cfg)
    assert own.counts == pytest.approx(ref_own.counts, rel=3e-6, abs=1e-4)
    np.testing.assert_array_equal(own.cause, ref_own.cause)
    assert sum(own.counts.values()) == pytest.approx(own.total)


def test_blame_cascade_buckets_reachable():
    """capacity_capped and cooldown_suppressed fire on inputs built to
    trigger them (the reference's cases), as in the reference."""
    cfg = cluster.SimConfig(max_replicas=3.0)
    _, ct = cluster.simulate(torch.full((20,), 20000.0), registry.make(
        "hpa", cfg), cfg, device="cpu", telemetry=True)
    b = AT.attribute(T.to_numpy(ct), cfg)
    assert b.counts["capacity_capped"] > 0
    cfg2 = cluster.SimConfig()
    lull = np.concatenate([np.full(20, 6000.0), np.full(10, 100.0),
                           np.full(20, 6000.0)]).astype(np.float32)
    _, ct2 = cluster.simulate(torch.as_tensor(lull),
                              registry.make("hpa", cfg2), cfg2,
                              device="cpu", telemetry=True)
    b2 = AT.attribute(T.to_numpy(ct2), cfg2)
    assert b2.counts["cooldown_suppressed"] > 0
    for b_ in (b, b2):
        assert set(np.unique(b_.cause)) <= set(range(-1, len(AT.CAUSES)))


def test_blame_tables_match_reference():
    ct, _, cfg = _own_traces("aapa")
    b = AT.attribute(ct, cfg)
    assert AT.blame_table({"aapa": b}) == ref_AT.blame_table({"aapa": b})
    rows = AT.archetype_counts(ct, b)
    assert rows == ref_AT.archetype_counts(ct, b)
    assert AT.archetype_table(rows) == ref_AT.archetype_table(rows)
    for max_rows in (24, 10**6):
        assert (AT.timeline(ct, b, max_rows=max_rows)
                == ref_AT.timeline(ct, b, max_rows=max_rows))


# -------------------------------------------------------------- obs cards
def test_obs_card_publish_cache_and_reference_card(tmp_path):
    """The obs card: the reference's key and hash under the port's root,
    its blame totals summing to the traced violations, a cache hit on
    reload; `load_capture(root=...)` reads the reference's card."""
    sp, rsp = matrix.smoke_spec(), ref_matrix.smoke_spec()
    cap = OA.capture_matrix(sp, root=tmp_path / "port", device="cpu")
    assert not cap.cached
    assert set(cap.meta) == {"run_s", "blame_s", "publish_s"}
    assert OA.DEFAULT_ROOT.name == "obs_torch"
    out = OA.capture_dir(sp.name, cap.card["key"], tmp_path / "port")
    for name in ("card.json", "trace.npz", "timeline.md"):
        assert (out / name).exists()
    assert cap.card["violations_total"] == pytest.approx(
        sum(cap.card["blame_totals"].values()))
    violated = float(np.asarray(cap.trace.minutes.violated,
                                np.float64).sum())
    assert cap.card["violations_total"] == pytest.approx(violated)
    cap2 = OA.capture_matrix(sp, root=tmp_path / "port", device="cpu")
    assert cap2.cached and list(cap2.blames) == list(cap.blames)
    for a, b in zip(cap.trace.decisions, cap2.trace.decisions):
        np.testing.assert_array_equal(a, b)
    with open(out / "card.json") as f:
        assert json.load(f)["tables"]["blame"].startswith("| lane |")

    rcap = ref_OA.capture_matrix(rsp, root=tmp_path / "ref")
    assert cap.card["hash"] == rcap.card["hash"]
    assert cap.card["key"] == rcap.card["key"]
    for c in AT.CAUSES:
        assert cap.card["blame_totals"][c] == pytest.approx(
            rcap.card["blame_totals"][c], rel=3e-6, abs=1e-4)
    loaded = OA.load_capture(rsp.name, rcap.card["key"], tmp_path / "ref")
    assert loaded.cached and loaded.card["hash"] == rcap.card["hash"]
    for label, b in loaded.blames.items():
        _assert_blame_equal(b, rcap.blames[label])
    with pytest.raises(ValueError, match="classifier_id"):
        OA.capture_matrix(sp, classify=registry.default_classify,
                          root=tmp_path, device="cpu")


@pytest.mark.parametrize("ci", CIS)
def test_traced_pooled_fold_is_the_minute_fold_of_the_episode(ci):
    """The traced pooled runner folds each minute into its cells'
    accumulators as the minute ends: bit for bit the minute-by-minute
    `accum_update_pooled` fold (in f64, rounded to f32 at the end) of the
    untraced episode's MinuteOut, with only the traced lanes' minutes
    kept."""
    from repro_torch.evals import metrics as EM
    cfg = cluster.SimConfig(control_interval_sec=ci)
    G, W, M = 2, 3, 20
    rates = torch.as_tensor(np.random.default_rng(3).poisson(
        900, (G, W, M)).astype(np.float32))
    ctrl = registry.get_controller("hpa", cfg)
    edges = EM.response_edges(EM.DEFAULT_BINS, cfg.resp_cap_sec,
                              device="cpu")
    acc, ct = matrix._lane_runner([ctrl], cfg, edges, per_workload=False,
                                  telemetry=True, trace_lanes=2)(rates)
    out = cluster.simulate(rates.reshape(G * W, M), ctrl, cfg, device="cpu")
    want = EM.MetricAccum(*(a.double() for a in EM.accum_init(
        EM.DEFAULT_BINS, (G,), device="cpu")))
    for m in range(M):
        want = EM.accum_update_pooled(want, cluster.MinuteOut(*(
            f[:, m].contiguous().reshape(G, W) for f in out)), edges)
    for field, a, b in zip(want._fields, acc, want):
        assert a.dtype == torch.float32
        _same(a[0], b.float(), f"pooled {field}")
    assert ct.minutes.served.shape == (G, M, 1, 2)
