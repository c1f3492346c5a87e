"""Policy auto-tuning (port of ``repro.tuning``): search strategies over
candidate lanes with content-addressed tuning cards and a ``tuned:``
registry namespace.

    import repro_torch.tuning as tuning
    run = tuning.search(tuning.spec("hpa_spike", policy="hpa"))
    ctrl = registry.make(f"tuned:hpa@{run.card['hash']}", cfg)

NB: the package re-exports the ``search`` *function*, so
``repro_torch.tuning.search`` is the front door, not the submodule —
use ``from repro_torch.tuning import search as ...`` accordingly.
"""
from repro_torch.tuning.search import (DEFAULT_SPACES, STRATEGIES,
                                       TuneResult, TuneRun, TuneSpec,
                                       build_rates, default_candidate,
                                       grid_candidates, make_evaluator,
                                       run_search, search, smoke_spec, spec)
from repro_torch.tuning import artifacts

__all__ = ["DEFAULT_SPACES", "STRATEGIES", "TuneResult", "TuneRun",
           "TuneSpec", "artifacts", "build_rates", "default_candidate",
           "grid_candidates", "make_evaluator", "run_search", "search",
           "smoke_spec", "spec"]
