import os
import sys

# NOTE: do NOT set xla_force_host_platform_device_count here — smoke tests
# and benches must see 1 device (the dry-run sets 512 itself). Tests that
# need a multi-device mesh spawn a subprocess with XLA_FLAGS set.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    # Tier-1 CI runs `-m "not slow"`; the nightly job runs everything.
    config.addinivalue_line(
        "markers",
        "slow: heavyweight model/train/system tests, run in the nightly "
        "full-suite CI job (tier-1 deselects them with -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "requires_tpu: compiled-mode (interpret=False) kernel parity "
        "pins; auto-skipped unless jax.default_backend() == 'tpu'")
    config.addinivalue_line(
        "markers",
        "requires_cuda: CUDA kernel vs plain-version checks of the "
        "PyTorch port; skipped in-test when torch.cuda is unavailable")


def pytest_collection_modifyitems(config, items):
    import pytest
    tpu_items = [it for it in items
                 if it.get_closest_marker("requires_tpu") is not None]
    if not tpu_items:
        return
    import jax
    if jax.default_backend() == "tpu":
        return
    skip = pytest.mark.skip(
        reason="requires a TPU backend (interpret=False kernel path)")
    for it in tpu_items:
        it.add_marker(skip)
