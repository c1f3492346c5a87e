"""PyTorch/CUDA port of the AAPA reproduction (``repro``, the JAX package).

Subpackages mirror ``repro`` module for module, so each ported piece sits
where its reference counterpart does. Everything here imports ``torch``
and ``numpy`` only. Tensor-making entry points take an explicit
``device=`` that defaults to ``"cuda"`` and raise when CUDA is absent;
the CPU path (the kernels' plain PyTorch versions) runs only when the
caller asks for ``device="cpu"``.

Ported so far: HPA and AAPA episodes through the cluster plant
(``sim.cluster``, ``scaling``), AAPA's inference stack (``core``: window
features, GBDT node tables, beta calibration, Table III, Algorithm 1,
``TrainedAAPA.load``; ``data.windows``), the forecasters (``forecast``),
the ``plant_block``, ``episode_block``, ``window_features`` and
``gbdt_tables`` CUDA kernels (``kernels``), per-episode and pooled
metrics (``evals.metrics``) and REI (``evals.rei``, ``core.rei``).
"""
