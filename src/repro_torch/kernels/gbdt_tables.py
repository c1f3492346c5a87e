"""``gbdt_tables`` CUDA kernel: GBDT logits from raw features through the
flattened node tables (source ``csrc/gbdt_tables.cu``, inference in
``csrc/gbdt.cuh``).

Replaces the Pallas TPU kernel ``repro/kernels/gbdt_tables.py``
(``gbdt_logits_kernel``). Plain version: ``kernels.ref.gbdt_logits_ref``
(``core.gbdt.predict_logits``); ``kernels.ops.gbdt_logits`` dispatches
between the two by device.
"""
from __future__ import annotations

import torch

from repro_torch.core.gbdt import GBDTParams
from repro_torch.kernels import _build


def table_args(params: GBDTParams) -> tuple[torch.Tensor, ...]:
    """The tensors the kernels take for an ensemble: edges, feat, thresh,
    leaf, base."""
    t = params.tables
    return (params.bin_edges, t.feat, t.thresh, t.leaf, params.base)


def gbdt_logits_cuda(params: GBDTParams, X: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: X [N, F] (contiguous float32 on the ensemble's
    CUDA device) -> logits [N, K]. Raises on any other input."""
    if X.device.type != "cuda" or params.device != X.device:
        raise ValueError("gbdt_tables kernel needs X and the ensemble on one "
                         f"CUDA device, got {X.device} and {params.device}")
    F = params.bin_edges.shape[0]
    if (X.dim() != 2 or X.dtype != torch.float32 or not X.is_contiguous()
            or X.shape[0] < 1 or X.shape[1] != F):
        raise ValueError(f"X: expected a contiguous float32 [N, {F}] tensor, "
                         f"N >= 1; got {tuple(X.shape)} {X.dtype}")
    out = torch.empty((X.shape[0], params.base.shape[0]),
                      dtype=torch.float32, device=X.device)
    _build.extension().gbdt_logits(X, out, *table_args(params))
    gbdt_logits_cuda.launches += 1
    return out


gbdt_logits_cuda.launches = 0
