"""The evaluation plane (port of ``repro.evals``): run -> aggregate ->
compare.

* ``metrics``   — EpisodeMetrics over tensors, fixed-bin histogram
                  quantiles, per-workload and pooled accumulators.
* ``rei``       — batched REI and weight sensitivity with
                  scenario-aware baselines.
* ``matrix``    — policies x forecasters x scenarios x seeds;
                  ``run(spec)`` is the front door.
* ``fleet``     — 10^5-10^6 workload lanes: W-chunked episodes with the
                  workload axis pooled chunk by chunk (O(bins)
                  accumulators), one dispatch or a streaming fold.
* ``artifacts`` — content-addressed result cards and the paper-table
                  renderers.
"""
from repro_torch.evals import artifacts, fleet, matrix, metrics, rei  # noqa: F401,E501
from repro_torch.evals.matrix import (EvalResult, MatrixRun,  # noqa: F401
                                      MatrixSpec, run, smoke_spec, spec)
