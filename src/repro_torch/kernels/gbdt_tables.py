"""``gbdt_tables`` CUDA kernel: GBDT logits from raw features through the
flattened node tables (source ``csrc/gbdt_tables.cu``, per-thread
inference in ``csrc/gbdt.cuh``).

Replaces the Pallas TPU kernel ``repro/kernels/gbdt_tables.py``
(``gbdt_logits_kernel``). Plain version: ``kernels.ref.gbdt_logits_ref``
(``core.gbdt.predict_logits``); ``kernels.ops.gbdt_logits`` dispatches
between the two by device. The kernel's design and bound are described in
its source.

The kernel has two variants, both hand-written and bit for bit with the
plain version: the node tables staged in shared memory by a persistent
grid (``"shared"``, ensembles whose tables take at most
``SHARED_TABLE_MAX`` bytes there, the paper's 44 KB among them) or read
through the read-only cache by one thread a row (``"generic"``, any
ensemble). ``choose_variant`` picks one from the table bytes alone.
"""
from __future__ import annotations

import torch

from repro_torch.core.gbdt import GBDTParams
from repro_torch.kernels import _build

#: the most node-table bytes the shared variant stages (csrc/kernels.h
#: kGBDTSharedTableMax: what 384-row tiles of 64 features leave of a
#: block's 227 KB)
SHARED_TABLE_MAX = 104 * 1024
VARIANTS = ("shared", "generic")


def table_args(params: GBDTParams) -> tuple[torch.Tensor, ...]:
    """The tensors the kernels take for an ensemble: edges, feat, thresh,
    leaf, base."""
    t = params.tables
    return (params.bin_edges, t.feat, t.thresh, t.leaf, params.base)


def shared_table_bytes(n_trees: int, depth: int) -> int:
    """Bytes of the shared variant's tables: an 8-B word per internal
    node and a 4-B leaf value (csrc/gbdt_tables.cu
    gbdt_shared_table_bytes)."""
    return n_trees * (8 * (2 ** depth - 1) + 4 * 2 ** depth)


def choose_variant(table_bytes: int) -> str:
    """Where the kernel keeps an ensemble's node tables."""
    if table_bytes < 1:
        raise ValueError(f"table_bytes must be >= 1, got {table_bytes}")
    return "shared" if table_bytes <= SHARED_TABLE_MAX else "generic"


def gbdt_logits_cuda(params: GBDTParams, X: torch.Tensor, *,
                     variant: str | None = None) -> torch.Tensor:
    """Launch the kernel: X [N, F] (contiguous float32 on the ensemble's
    CUDA device) -> logits [N, K]. `variant` forces one (``"shared"`` only
    up to ``SHARED_TABLE_MAX`` table bytes); by default ``choose_variant``
    of the ensemble's table bytes. Raises on any other input."""
    if X.device.type != "cuda" or params.device != X.device:
        raise ValueError("gbdt_tables kernel needs X and the ensemble on one "
                         f"CUDA device, got {X.device} and {params.device}")
    F = params.bin_edges.shape[0]
    if (X.dim() != 2 or X.dtype != torch.float32 or not X.is_contiguous()
            or X.shape[0] < 1 or X.shape[1] != F):
        raise ValueError(f"X: expected a contiguous float32 [N, {F}] tensor, "
                         f"N >= 1; got {tuple(X.shape)} {X.dtype}")
    nbytes = shared_table_bytes(params.tables.feat.shape[0], params.depth)
    variant = choose_variant(nbytes) if variant is None else variant
    if variant not in VARIANTS or (variant == "shared"
                                   and nbytes > SHARED_TABLE_MAX):
        raise ValueError(f"variant {variant!r} for {nbytes} table bytes: "
                         f"expected one of {VARIANTS}, 'shared' only up to "
                         f"{SHARED_TABLE_MAX}")
    out = torch.empty((X.shape[0], params.base.shape[0]),
                      dtype=torch.float32, device=X.device)
    _build.extension().gbdt_logits(X, out, *table_args(params),
                                   variant == "shared")
    gbdt_logits_cuda.launches += 1
    gbdt_logits_cuda.last_variant = variant
    return out


gbdt_logits_cuda.launches = 0
gbdt_logits_cuda.last_variant = None
