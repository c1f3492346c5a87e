"""End-to-end behaviour of the port on the CPU: traces -> weak labels ->
classifier -> calibrated confidence -> archetype-aware autoscaling, on
the reference's miniature dataset (``tests/test_system.py``) with its
inputs and its assertions: the classifier's accuracy on the weak labels,
and the paper's central claims directionally (AAPA has no more SLO
violations and cold starts than HPA, at more replica-minutes)."""
import _torch_threads  # noqa: F401  (one torch thread)
import pytest
import torch

from repro_torch.core import gbdt, pipeline
from repro_torch.core.controllers import aapa_controller, hpa_controller
from repro_torch.data.azure_synth import generate_traces
from repro_torch.sim import metrics as MM
from repro_torch.sim.cluster import SimConfig, make_simulator

# Heavyweight model/train/system tier, as the reference's.
pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def mini():
    traces = generate_traces(n_functions=24, n_days=4, seed=7)
    trained = pipeline.train_aapa(
        traces, gbdt.GBDTConfig(n_rounds=15, depth=3), device="cpu")
    return traces, trained


def test_classifier_accuracy_on_weak_labels(mini):
    _, trained = mini
    # paper: 99.8% — mini dataset should still be >97%
    assert trained.test_acc > 0.97
    assert trained.n_windows > 1000
    assert abs(trained.label_dist.sum() - 1.0) < 1e-6


def test_aapa_beats_hpa_on_violations(mini):
    traces, trained = mini
    cfg = SimConfig()
    classify = trained.make_classify()
    rates = torch.as_tensor(traces.counts[:12, :1440])

    hpa_out = make_simulator(hpa_controller(cfg), cfg, device="cpu")(rates)
    aapa_out = make_simulator(aapa_controller(cfg, classify), cfg,
                              device="cpu")(rates)
    hpa_m = MM.aggregate(hpa_out, workload_axis=True)
    aapa_m = MM.aggregate(aapa_out, workload_axis=True)

    # the paper's central claims, directionally: fewer violations and
    # fewer cold starts, at higher resource cost
    assert aapa_m.slo_violation_rate <= hpa_m.slo_violation_rate
    assert aapa_m.cold_start_rate <= hpa_m.cold_start_rate
    assert aapa_m.replica_minutes > hpa_m.replica_minutes
