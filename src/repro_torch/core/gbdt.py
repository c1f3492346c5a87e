"""Histogram GBDT inference over flattened node tables (port of
``repro.core.gbdt``, inference only; training stays in the reference).

A trained ensemble's [rounds, K, ...] level-order trees are flattened
once into `NodeTables` over one round-major tree axis (tree t = round *
K + class); internal nodes are heap-indexed per level (node n at depth d
at 2^d - 1 + n). Inference bins each feature (the count of bin edges <=
x), descends every tree one level per step and sums each class's leaf
values over rounds, in XLA CPU's reduction order (``_numerics``), onto
the base logits. This is the plain version of the ``gbdt_tables`` CUDA
kernel (``kernels.gbdt_tables``), which does the same integer and float
work in the same order.

Bins follow the reference's host path ``bin_features``
(``searchsorted(side="right")``): a NaN feature falls in the last bin.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import _device
from repro_torch import _numerics as N


class NodeTables(NamedTuple):
    """Level-order trees over one round-major tree axis (T = rounds *
    K)."""
    feat: torch.Tensor    # [T, 2^depth - 1] int32 split feature ids
    thresh: torch.Tensor  # [T, 2^depth - 1] int32 split bins (right if >)
    leaf: torch.Tensor    # [T, 2^depth] f32 leaf values (lr folded in)


def node_tables(feat, thresh, leaf) -> NodeTables:
    """[rounds, K, ...] level-order trees -> contiguous NodeTables."""
    R, K, I = feat.shape
    L = leaf.shape[-1]
    return NodeTables(
        feat=feat.to(torch.int32).reshape(R * K, I).contiguous(),
        thresh=thresh.to(torch.int32).reshape(R * K, I).contiguous(),
        leaf=leaf.to(torch.float32).reshape(R * K, L).contiguous())


@dataclasses.dataclass(frozen=True)
class GBDTConfig:
    n_classes: int = 4
    n_rounds: int = 60
    depth: int = 4
    learning_rate: float = 0.25
    reg_lambda: float = 1.0
    n_bins: int = 64
    min_child_weight: float = 1e-3
    class_weighted: bool = True  # weights inversely proportional to frequency


@dataclasses.dataclass
class GBDTParams:
    """Trained ensemble (tensors on one device). Trees are level-order.

    feat/thresh: [rounds, K, 2^depth - 1] split feature / bin (right if >).
    leaf:        [rounds, K, 2^depth] leaf values (learning rate folded in).
    bin_edges:   [F, n_bins - 1] quantile bin edges.
    base:        [K] initial logits (log priors).
    tables:      the flattened NodeTables, derived once at construction.
    """

    feat: torch.Tensor
    thresh: torch.Tensor
    leaf: torch.Tensor
    bin_edges: torch.Tensor
    base: torch.Tensor
    tables: NodeTables | None = None

    def __post_init__(self):
        # the kernels index each row's bins by these ids
        n_features = self.bin_edges.shape[0]
        if self.feat.numel() and not (0 <= int(self.feat.min())
                                      <= int(self.feat.max()) < n_features):
            raise ValueError(f"split features must lie in [0, {n_features})"
                             f", got {int(self.feat.min())}.."
                             f"{int(self.feat.max())}")
        if self.tables is None:
            self.tables = node_tables(self.feat, self.thresh, self.leaf)

    @property
    def depth(self) -> int:
        return int(np.log2(self.leaf.shape[-1]) + 0.5)

    @property
    def device(self) -> torch.device:
        return self.base.device


def compute_bin_edges(X: np.ndarray, n_bins: int) -> np.ndarray:
    """Per-feature quantile bin edges. X [N, F] -> [F, n_bins - 1]."""
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    edges = np.quantile(X, qs, axis=0).T.astype(np.float32)  # [F, B-1]
    # strictly increasing edges keep searchsorted well-behaved on ties
    edges += np.arange(n_bins - 1, dtype=np.float32) * 1e-9
    return edges


def bin_features(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """X [N, F], edges [F, B-1] (non-decreasing) -> int32 bins [N, F] in
    [0, B-1]: the number of edges <= x, B-1 for a NaN."""
    X = X.to(torch.float32)
    bins = torch.searchsorted(edges.contiguous(), X.T.contiguous(),
                              right=True).T
    bins = torch.where(torch.isnan(X), edges.shape[-1], bins)
    return bins.to(torch.int32)


def traverse_tables(tables: NodeTables, xb: torch.Tensor) -> torch.Tensor:
    """Descend all trees for all rows: xb [N, F] int32 bins -> per-tree
    leaf values [N, T] (`_descend` of the reference, as index walks)."""
    T = tables.feat.shape[0]
    depth = tables.leaf.shape[-1].bit_length() - 1
    trees = torch.arange(T, device=xb.device)
    feat, thresh = tables.feat.long(), tables.thresh
    xb = xb.long()
    node = torch.zeros((xb.shape[0], T), dtype=torch.long, device=xb.device)
    for d in range(depth):
        at = (1 << d) - 1 + node
        xv = torch.gather(xb, 1, feat[trees, at])
        node = node * 2 + (xv > thresh[trees, at]).long()
    return tables.leaf[trees, node]


def table_logits(base: torch.Tensor, tables: NodeTables,
                 xb: torch.Tensor) -> torch.Tensor:
    """binned xb [N, F] -> logits [N, K]: per-class leaf sums over
    rounds (XLA's order) added to the base logits."""
    vals = traverse_tables(tables, xb)                   # [N, T]
    K = base.shape[0]
    per_class = vals.reshape(vals.shape[0], -1, K).transpose(1, 2)
    return base + N.xla_sum(per_class)


def predict_logits(params: GBDTParams, X: torch.Tensor) -> torch.Tensor:
    """X [N, F] -> logits [N, K] (plain PyTorch)."""
    xb = bin_features(X, params.bin_edges)
    return table_logits(params.base, params.tables, xb)


def softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: exp(x - max) over its sum
    (sequential over the K classes), exp correctly rounded."""
    u = N.rounded(torch.exp, logits - logits.amax(-1, keepdim=True))
    return u / N.seq_sum(u, 0, u.shape[-1])[..., None]


def predict_proba(params: GBDTParams, X: torch.Tensor) -> torch.Tensor:
    return softmax(predict_logits(params, X))


def predict(params: GBDTParams, X: torch.Tensor) -> torch.Tensor:
    return torch.argmax(predict_logits(params, X), -1)


def from_arrays(feat, thresh, leaf, bin_edges, base,
                device="cuda") -> GBDTParams:
    """GBDTParams from NumPy arrays (the reference's npz keys)."""
    dev = _device.resolve(device)

    def t(a, dtype):
        return torch.as_tensor(np.array(a)).to(device=dev, dtype=dtype)

    return GBDTParams(feat=t(feat, torch.int32), thresh=t(thresh, torch.int32),
                      leaf=t(leaf, torch.float32),
                      bin_edges=t(bin_edges, torch.float32).contiguous(),
                      base=t(base, torch.float32))


def load(path, device="cuda") -> GBDTParams:
    """Read an ensemble saved by the reference's ``gbdt.save``."""
    with np.load(path) as z:
        return from_arrays(z["feat"], z["thresh"], z["leaf"],
                           z["bin_edges"], z["base"], device=device)
