"""PyTorch/CUDA port of the AAPA reproduction (``repro``, the JAX package).

Subpackages mirror ``repro`` module for module, so each ported piece sits
where its reference counterpart does. Everything here imports ``torch``
and ``numpy`` only. Tensor-making entry points take an explicit
``device=`` that defaults to ``"cuda"`` and raise when CUDA is absent;
the CPU path (the kernels' plain PyTorch versions) runs only when the
caller asks for ``device="cpu"``.

Ported so far: episodes of all five policies through the cluster plant
(``sim.cluster``, ``scaling``), AAPA's stack (``core``: window features,
weak labels, GBDT and beta-calibration training and inference, Table
III, Algorithm 1, ``TrainedAAPA``; ``data``), the AAPAset engine
(``aapaset``), the forecasters (``forecast``), the evaluation plane
(``evals``: metrics, REI, the Table IV matrix, fleet runs, result cards),
decision telemetry and tuning (``obs``, ``tuning``), the serving
endpoint (``scaling.adapter``, the model substrate in ``models`` and
``configs``, ``serve``, ``launch.serve``) and the ``plant_block``,
``episode_block``, ``window_features``, ``gbdt_tables`` and
``holt_winters`` CUDA kernels (``kernels``).
"""
