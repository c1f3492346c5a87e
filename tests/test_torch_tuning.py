"""The port's tuning plane (``repro_torch.tuning`` and the ``tuned:``
registry namespace) against the JAX reference's (``repro.tuning``) on
the CPU.

Proposals come from NumPy's generator in both packages, so the candidate
sequences (grid, samples, perturbations) are the reference's exactly and
the content keys and card hashes are equal. Each candidate's REI is held
at the matrix's reordered-pooling tolerance (rtol 2e-6,
tests/test_fleet.py). The winner is the reference's where the runner-up
trails by more than that tolerance; on a near-tie the port's winner
scores within it of the reference's best.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.tuning as ref_tuning
import repro_torch.tuning as tuning
from repro.scaling import registry as ref_registry
from repro.sim import cluster as ref_cluster
from repro.tuning import artifacts as ref_artifacts
from repro_torch.scaling import batch, registry
from repro_torch.sim import cluster
from repro_torch.tuning import artifacts

REI_RTOL = 2e-6
# the packages re-export the `search` function under the submodule's name
search_mod = sys.modules["repro_torch.tuning.search"]
ref_search = sys.modules["repro.tuning.search"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(name, **kw):
    return ref_tuning.spec(name, **kw), tuning.spec(name, **kw)


def _assert_search_matches(got, want):
    """Per-candidate REI at REI_RTOL, the same candidates in the same
    order, and the winner as the module docstring sets out."""
    strip = [{k: v for k, v in row.items() if k != "rei"}
             for row in got.table]
    assert strip == [{k: v for k, v in row.items() if k != "rei"}
                     for row in want.table]
    rei = np.array([row["rei"] for row in got.table])
    ref_rei = np.array([row["rei"] for row in want.table])
    np.testing.assert_allclose(rei, ref_rei, rtol=REI_RTOL, atol=0)
    np.testing.assert_allclose(got.default_rei, want.default_rei,
                               rtol=REI_RTOL)
    ranked = np.sort(ref_rei)[::-1]
    if len(ranked) == 1 or ranked[0] - ranked[1] > REI_RTOL * abs(ranked[0]):
        assert got.best == want.best
    else:
        assert got.best_rei >= want.best_rei - REI_RTOL * abs(want.best_rei)
    assert got.meta["n_candidates"] == want.meta["n_candidates"]
    assert got.meta["compiles"] == want.meta["compiles"]
    assert len(got.trace) == len(want.trace)


# ----------------------------------------------------------- proposals ----
@pytest.mark.parametrize("policy", sorted(tuning.DEFAULT_SPACES))
def test_candidate_sequences_match_reference(policy):
    """`grid_candidates`, `_sample` and `_perturb` give the reference's
    sequences exactly (the same NumPy generator draws)."""
    rsp, sp = _both(f"seq_{policy}", policy=policy, points=3)
    assert sp.space == rsp.space
    assert sp.content_key() == rsp.content_key()
    assert tuning.grid_candidates(sp.space, 3) == \
        ref_tuning.grid_candidates(rsp.space, 3)
    assert tuning.default_candidate(sp) == ref_tuning.default_candidate(rsp)
    rng, ref_rng = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(5):
        cand = search_mod._sample(sp.space, rng)
        assert cand == ref_search._sample(rsp.space, ref_rng)
        for sigma in (0.25, 0.05):
            assert search_mod._perturb(cand, sp.space, sigma, rng) == \
                ref_search._perturb(cand, rsp.space, sigma, ref_rng)


def test_search_space_validation_matches_reference():
    for kw, err, match in (
            (dict(space={"targett": (0.4, 0.9)}), TypeError,
             r"targett.*accepts"),
            (dict(space={"stabilization_min": ("range", 1.0, 9.0)}),
             TypeError, "not stackable"),
            (dict(space={"target": (0.9, 0.4)}), ValueError, "empty range"),
            (dict(strategy="simulated_annealing"), ValueError,
             "unknown strategy")):
        with pytest.raises(err, match=match):
            tuning.spec("x", policy="hpa", **kw)
        with pytest.raises(err, match=match):
            ref_tuning.spec("x", policy="hpa", **kw)


# ----------------------------------------------------------- execution ----
def test_smoke_search_matches_reference():
    """`run_search(smoke_spec())`: the 16-point hpa grid and the default
    point."""
    got = tuning.run_search(tuning.smoke_spec(), device="cpu")
    want = ref_tuning.run_search(ref_tuning.smoke_spec())
    _assert_search_matches(got, want)
    assert got.meta["compiles"] == 2     # the grid's group and the default


def test_refine_and_population_searches_match_reference():
    """grid_refine's shrinking boxes and population's perturbations, fed
    back from the scores, propose the reference's candidates."""
    for kw in (dict(policy="hpa", strategy="grid_refine", points=2,
                    rounds=2, space={"target": (0.45, 0.9)},
                    scenario="diurnal_ramp"),
               dict(policy="kpa", strategy="population", population=4,
                    generations=2)):
        rsp, sp = _both("t_search", n_workloads=2, minutes=60, **kw)
        got = tuning.run_search(sp, device="cpu")
        want = ref_tuning.run_search(rsp)
        _assert_search_matches(got, want)
        assert [t.get("box") for t in got.trace] == \
            [t.get("box") for t in want.trace]


def test_grid_evaluator_counts_static_groups():
    """`_cache_size()` counts what the reference's compile cache counts:
    one entry per static group, group size and rates shape."""
    rates = np.random.default_rng(2).poisson(
        2400, (2, 30)).astype(np.float32)
    cfg = cluster.SimConfig()
    ev = batch.make_grid_evaluator("hpa", cfg, device="cpu")
    ev([{"target": t} for t in (0.5, 0.7, 0.9)], rates)
    assert ev._cache_size() == 1
    ev([{"target": t} for t in (0.45, 0.85, 0.65)], rates)
    assert ev._cache_size() == 1
    ev([{"target": 0.6, "stabilization_min": s} for s in (2.0, 8.0)],
       rates)
    assert ev._cache_size() == 3


# ------------------------------------------------- cards + tuned: names ----
def _tiny(name="tiny", **kw):
    base = dict(policy="hpa", strategy="grid", points=3,
                space={"target": (0.45, 0.9)}, n_workloads=2, minutes=40)
    base.update(kw)
    return ref_tuning.spec(name, **base), tuning.spec(name, **base)


def test_search_card_hash_and_cache(tmp_path, monkeypatch):
    """`search` publishes under the reference's hash, serves an identical
    spec from its card, and re-runs on `force`."""
    rsp, sp = _tiny(name="det")
    run1 = tuning.search(sp, root=tmp_path, device="cpu")
    assert not run1.cached
    key = dict(sp.content_key(), classifier="default_classify")
    assert run1.card["hash"] == ref_artifacts.card_hash(
        dict(rsp.content_key(), classifier="default_classify"))
    assert artifacts.result_dir(sp.name, key, tmp_path).parent == tmp_path
    assert artifacts.DEFAULT_ROOT.name == "tuning_torch"
    calls = []
    real = search_mod.run_search
    monkeypatch.setattr(search_mod, "run_search",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    run2 = tuning.search(sp, root=tmp_path, device="cpu")
    assert run2.cached and not calls
    assert run2.result.best == run1.result.best
    run3 = tuning.search(sp, root=tmp_path, force=True, device="cpu")
    assert not run3.cached and calls
    assert run3.card["hash"] == run1.card["hash"]
    assert [c["hash"] for c in artifacts.list_cards(tmp_path)] == \
        [run1.card["hash"]]


@pytest.mark.parametrize("publisher", ["port", "reference"])
def test_tuned_names_resolve_cards_of_either_package(tmp_path, monkeypatch,
                                                      publisher):
    """``tuned:<policy>@<hash>`` rebuilds the winner of a card published by
    either package: its episode equals ``registry.make(policy, **best)``
    bit for bit; overrides apply on top; a wrong policy or an unknown hash
    fails loudly."""
    rsp, sp = _tiny(name="roundtrip")
    if publisher == "port":
        run = tuning.search(sp, root=tmp_path, device="cpu")
    else:
        run = ref_tuning.search(rsp, root=tmp_path)
    monkeypatch.setattr(artifacts, "DEFAULT_ROOT", tmp_path)
    ref = f"tuned:hpa@{run.card['hash']}"
    cfg = cluster.SimConfig()
    tuned = registry.make(ref, cfg)
    direct = registry.make("hpa", cfg, **run.result.best)
    assert registry.spec(ref).name == "hpa"
    rates = np.random.default_rng(3).poisson(
        2400, (2, 60)).astype(np.float32)
    out_t = cluster.simulate(rates, tuned, cfg, device="cpu")
    out_d = cluster.simulate(rates, direct, cfg, device="cpu")
    for field, a, b in zip(out_t._fields, out_t, out_d):
        assert torch.equal(a, b), field
    # the reference rebuilds the same point from the same card
    monkeypatch.setattr(ref_artifacts, "DEFAULT_ROOT", tmp_path)
    ref_out = ref_cluster.simulate(
        jnp.asarray(rates[0]), ref_registry.make(ref, ref_cluster.SimConfig()),
        ref_cluster.SimConfig())
    np.testing.assert_allclose(out_t.replica_seconds[0].numpy(),
                               np.asarray(ref_out.replica_seconds),
                               rtol=3e-6, atol=1e-4)
    assert registry.make(ref, cfg, cooldown_min=0.0).hyper[
        "cooldown_sec"] == 0.0
    assert artifacts.resolve(ref[len("tuned:"):], root=tmp_path) == (
        "hpa", run.result.best)
    with pytest.raises(ValueError, match="tuned"):
        registry.make(f"tuned:kpa@{run.card['hash']}", cfg)
    with pytest.raises(FileNotFoundError):
        registry.make("tuned:hpa@000000000000", cfg)
