"""Histogram-based gradient-boosted decision trees in PyTorch (port of
``repro.core.gbdt``): training and inference.

Stands in for the paper's LightGBM classifier (§III.C.1): multiclass
softmax objective, quantile-binned features (64 bins), depth-limited
level-order trees, class weights inversely proportional to frequency.

Training (`fit`) builds each round's K class trees at once
(`_build_tree` over [K, N] gradients, where the reference vmaps one
class's build): one (class, node, feature, bin) histogram of gradients
and hessians per level, cumulative sums over the bins, the split gain of
every (feature, bin), and the first best split. The histograms are f32
sums in row order, as the reference's ``segment_sum`` adds them:
``index_add_`` on the CPU, a stable sort of the bin indices and
``segment_reduce`` on the card (`_segment_sum`), in place of float
atomics, so two fits of the same inputs give the same trees bit for bit,
on either device. The cumulative sums follow XLA CPU's order
(`xla_cumsum`). What still separates a fit from the reference's is the
softmax's exp (correctly rounded here, not in XLA), so gradients may
differ in the last ulp and a split whose gain ties its runner-up within
float noise may go the other way.

Inference: a trained ensemble's [rounds, K, ...] level-order trees are
flattened once into `NodeTables` over one round-major tree axis (tree t
= round * K + class); internal nodes are heap-indexed per level (node n
at depth d at 2^d - 1 + n). Inference bins each feature (the count of
bin edges <= x), descends every tree one level per step and sums each
class's leaf values over rounds, in XLA CPU's reduction order
(``_numerics``), onto the base logits. This is the plain version of the
``gbdt_tables`` CUDA kernel (``kernels.gbdt_tables``), which does the
same integer and float work in the same order. `predict_logits_scan`,
the reference's per-round walk, is the parity oracle: it sums the
rounds in order, so it agrees with the table path to a few ulp.

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


def traverse_tables_chunked(tables: NodeTables, xb: torch.Tensor,
                            tree_chunk: int | None = None) -> torch.Tensor:
    """`traverse_tables`, bit-identical, over chunks of the tree axis
    (trees are independent, so chunking only reorders which tree is
    evaluated when, never a float op). `tree_chunk=None` picks the
    largest divisor of T that is <= 32."""
    T = tables.feat.shape[0]
    if tree_chunk is None:
        tree_chunk = next(tc for tc in range(min(T, 32), 0, -1)
                          if T % tc == 0)
    if tree_chunk >= T:
        return traverse_tables(tables, xb)
    return torch.cat([traverse_tables(NodeTables(*(
        a[lo:lo + tree_chunk] for a in tables)), xb)
        for lo in range(0, T, tree_chunk)], 1)


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


def predict_logits_scan(params: GBDTParams, X: torch.Tensor) -> torch.Tensor:
    """The reference's per-round walk, rounds summed in order onto the
    base logits: the parity oracle of the table path and the kernel."""
    xb = bin_features(X, params.bin_edges).long()
    N, K = xb.shape[0], params.base.shape[0]
    rows = torch.arange(N, device=xb.device)
    logits = params.base.expand(N, K)
    for feat, thresh, leaf in zip(params.feat.long(), params.thresh,
                                  params.leaf):
        node = torch.zeros((K, N), dtype=torch.long, device=xb.device)
        for d in range(params.depth):
            at = (1 << d) - 1 + node
            go = xb[rows, feat.gather(1, at)] > thresh.gather(1, at)
            node = node * 2 + go.long()
        logits = logits + leaf.gather(1, node).T
    return logits


# XLA CPU computes a cumulative sum in blocks of 16: each block
# sequentially, then the block totals' exclusive prefix (the same scheme
# again) added to each block
CUMSUM_BLOCK = 16


def _seq_cumsum(v: torch.Tensor) -> torch.Tensor:
    out = [v[..., 0]]
    for j in range(1, v.shape[-1]):
        out.append(out[-1] + v[..., j])
    return torch.stack(out, -1)


def xla_cumsum(v: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over the last axis in XLA CPU's order
    (``jnp.cumsum``; see `CUMSUM_BLOCK`), on any device."""
    n = v.shape[-1]
    if n <= CUMSUM_BLOCK:
        return _seq_cumsum(v)
    nb = -(-n // CUMSUM_BLOCK)
    vp = torch.nn.functional.pad(v, (0, nb * CUMSUM_BLOCK - n))
    within = _seq_cumsum(vp.reshape(v.shape[:-1] + (nb, CUMSUM_BLOCK)))
    inc = xla_cumsum(within[..., -1])
    exc = torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :-1]], -1)
    return (within + exc[..., None]).reshape(
        v.shape[:-1] + (nb * CUMSUM_BLOCK,))[..., :n]


def _segment_sum(values: torch.Tensor, index: torch.Tensor,
                 n: int) -> torch.Tensor:
    """out[i] = sum of values[j] over index[j] == i, in order of j (the
    reference's ``segment_sum``); values [M, C] -> [n, C].

    On the CPU ``index_add_`` adds in order of j. On the card it would
    use float atomics, whose order varies from run to run; there
    `_sorted_segment_sum` gives the same sums on every run and on both
    devices."""
    if values.device.type == "cpu":
        return values.new_zeros((n,) + values.shape[1:]).index_add_(
            0, index, values)
    return _sorted_segment_sum(values, index, n)


def _sorted_segment_sum(values: torch.Tensor, index: torch.Tensor,
                        n: int) -> torch.Tensor:
    """`_segment_sum` without atomics: a stable sort of the indices keeps
    each segment's values in order of j, and ``segment_reduce`` sums
    each segment in that order."""
    keys, order = torch.sort(index.to(torch.int32), stable=True)
    return torch.segment_reduce(values[order], "sum",
                                lengths=torch.bincount(keys, minlength=n),
                                axis=0, unsafe=True)


def _build_tree(xb, g, h, *, depth, n_bins, reg_lambda, min_child_weight):
    """Greedy level-order trees, one per row of g and h, built at once.

    xb [N, F] int bins; g, h [K, N] grad/hess ([N] for one tree). Returns
    (feat [K, 2^depth-1], thresh [K, 2^depth-1], leaf [K, 2^depth],
    leaf_id [K, N]), without the K axis for one tree.
    """
    if g.dim() == 1:
        return tuple(a[0] for a in _build_tree(
            xb, g[None], h[None], depth=depth, n_bins=n_bins,
            reg_lambda=reg_lambda, min_child_weight=min_child_weight))
    K, N = g.shape
    F, B = xb.shape[1], n_bins
    dev = g.device
    xb = xb.long()
    rows = torch.arange(N, device=dev)
    trees = torch.arange(K, device=dev)[:, None]
    # each (class, row, feature)'s gradient and hessian, and its
    # feature * B + bin; (class, row, feature) order keeps every bin's
    # sum in row order
    gh = torch.stack([g, h], -1)[:, :, None, :].expand(K, N, F, 2) \
        .reshape(-1, 2)
    fbin = torch.arange(F, device=dev) * B + xb                # [N, F]
    valid_bin = torch.arange(B, device=dev) < B - 1
    node = torch.zeros((K, N), dtype=torch.long, device=dev)
    feats_out, thresh_out = [], []

    for d in range(depth):
        n_nodes = 1 << d
        with torch.profiler.record_function("gbdt.histograms"):
            seg = (trees * n_nodes + node)[:, :, None] * (F * B) + fbin
            hist = _segment_sum(gh, seg.reshape(-1), K * n_nodes * F * B)
        with torch.profiler.record_function("gbdt.split_search"):
            cum = xla_cumsum(hist.reshape(K, n_nodes, F, B, 2)
                             .movedim(-1, -2))             # [..., 2, B]
            GL, HL = cum[..., 0, :], cum[..., 1, :]
            GT, HT = GL[..., -1:], HL[..., -1:]
            GR, HR = GT - GL, HT - HL
            gain = (GL * GL / (HL + reg_lambda) + GR * GR / (HR + reg_lambda)
                    - GT * GT / (HT + reg_lambda))
            valid = ((HL >= min_child_weight) & (HR >= min_child_weight)
                     & valid_bin)
            flat_gain = torch.where(valid, gain, -torch.inf) \
                .reshape(K, n_nodes, F * B)
            best = torch.argmax(flat_gain, -1)             # first maximum
            best_gain = flat_gain.gather(-1, best[..., None])[..., 0]
            # nodes with no valid split: degenerate split (all left)
            no_split = ~torch.isfinite(best_gain)
            bf = torch.where(no_split, 0, best // B)
            bb = torch.where(no_split, B - 1, best % B)
        feats_out.append(bf)
        thresh_out.append(bb)
        go_right = xb[rows, bf.gather(1, node)] > bb.gather(1, node)
        node = node * 2 + go_right.long()

    n_leaves = 1 << depth
    with torch.profiler.record_function("gbdt.histograms"):
        sums = _segment_sum(torch.stack([g, h], -1).reshape(-1, 2),
                            (trees * n_leaves + node).reshape(-1),
                            K * n_leaves).reshape(K, n_leaves, 2)
    leaf = -sums[..., 0] / (sums[..., 1] + reg_lambda)
    return (torch.cat(feats_out, 1).to(torch.int32),
            torch.cat(thresh_out, 1).to(torch.int32), leaf, node)


def _boost_round(xb, y_onehot, w, logits, cfg: GBDTConfig):
    """One boosting round: K trees (one per class), built at once.
    Returns new logits and the round's (feat [K, 2^d - 1], thresh, leaf
    [K, 2^d])."""
    p = softmax(logits)
    G = (p - y_onehot) * w[:, None]
    H = (p * (1.0 - p)).clamp_min(1e-6) * w[:, None]
    feat, thresh, leaf, leaf_id = _build_tree(
        xb, G.T, H.T, depth=cfg.depth, n_bins=cfg.n_bins,
        reg_lambda=cfg.reg_lambda, min_child_weight=cfg.min_child_weight)
    leaf = leaf * cfg.learning_rate
    return logits + leaf.gather(1, leaf_id).T, (feat, thresh, leaf)


def fit(X: np.ndarray, y: np.ndarray, cfg: GBDTConfig = GBDTConfig(),
        *, verbose: bool = False, device="cuda") -> GBDTParams:
    """Train on `device`. X [N, F] float, y [N] int in [0, K)."""
    dev = _device.resolve(device)
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.int32)
    N = X.shape[0]
    K = cfg.n_classes

    edges = torch.as_tensor(np.ascontiguousarray(
        compute_bin_edges(X, cfg.n_bins)), device=dev)
    xb = bin_features(torch.as_tensor(X, device=dev), edges)

    counts = np.bincount(y, minlength=K).astype(np.float64)
    priors = np.maximum(counts, 1.0) / max(N, 1)
    base = torch.as_tensor(np.log(priors).astype(np.float32), device=dev)
    w_cls = (N / (K * np.maximum(counts, 1.0)) if cfg.class_weighted
             else np.ones(K))
    y_t = torch.as_tensor(y, device=dev).long()
    w = torch.as_tensor(w_cls.astype(np.float32), device=dev)[y_t]
    y_onehot = torch.nn.functional.one_hot(y_t, K).to(torch.float32)

    logits = base.expand(N, K)
    feats, threshs, leaves = [], [], []
    for r in range(cfg.n_rounds):
        logits, (f, t, lv) = _boost_round(xb, y_onehot, w, logits, cfg)
        feats.append(f), threshs.append(t), leaves.append(lv)
        if verbose and (r % 10 == 0 or r == cfg.n_rounds - 1):
            acc = float((logits.argmax(-1) == y_t).float().mean())
            print(f"  round {r:3d}  train_acc={acc:.4f}")

    return GBDTParams(feat=torch.stack(feats), thresh=torch.stack(threshs),
                      leaf=torch.stack(leaves), bin_edges=edges, base=base)


def save(params: GBDTParams, path) -> None:
    """The reference's npz (``gbdt.save``): loads in either package."""
    np.savez(path, **{k: getattr(params, k).cpu().numpy() for k in
                      ("feat", "thresh", "leaf", "bin_edges", "base")})


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
