"""Decision telemetry (port of ``repro.obs``): see what every control
decision saw, attribute every violated minute to the decision stage that
caused it.

* ``trace``     — the `DecisionRecord` / `ControlTrace` schema captured by
                  the unfused episode (``sim.cluster.simulate(...,
                  decide_kernel=False, telemetry=True)``) and the runners
                  over it (``scaling.batch``, ``evals.matrix``,
                  ``evals.fleet``).
* ``attribute`` — host-side SLO blame: walk violated minutes back
                  through the startup_sec cold-start window to the
                  responsible decision and classify the cause; blame and
                  per-archetype tables.
* ``artifacts`` — content-addressed obs cards (trace npz + blame summary
                  + decision timeline markdown) under
                  ``experiments/obs_torch``.

Only ``trace`` loads eagerly (the simulator imports it); ``attribute``
and ``artifacts`` resolve lazily because they import the evaluation
plane, which imports the simulator.
"""
from repro_torch.obs import trace  # noqa: F401
from repro_torch.obs.trace import (ControlTrace, DecisionRecord,  # noqa: F401
                                   ExplainOut, MinuteTrace)

_LAZY = ("attribute", "artifacts")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f"repro_torch.obs.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'repro_torch.obs' has no attribute "
                         f"{name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
