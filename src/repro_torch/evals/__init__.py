"""The evaluation plane (port of ``repro.evals``): run -> aggregate ->
compare.

* ``metrics``   — EpisodeMetrics over tensors, fixed-bin histogram
                  quantiles, per-workload and pooled accumulators.
* ``rei``       — batched REI and weight sensitivity with
                  scenario-aware baselines.
* ``matrix``    — policies x forecasters x scenarios x seeds;
                  ``run(spec)`` is the front door.
* ``artifacts`` — content-addressed result cards and the paper-table
                  renderers.

The fleet runner (``repro.evals.fleet``) is not ported yet.
"""
from repro_torch.evals import artifacts, matrix, metrics, rei  # noqa: F401
from repro_torch.evals.matrix import (EvalResult, MatrixRun,  # noqa: F401
                                      MatrixSpec, run, smoke_spec, spec)
