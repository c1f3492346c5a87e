"""Chunked AAPAset builder: traces -> windows -> 38 features -> 10-LF
weak labels + agreement confidence -> day splits (port of
``repro.aapaset.build``, paper §III.B).

Each chunk of windows goes through feature extraction and the labeling
functions on the windows' device: on the card the ``window_features``
kernel (``kernels.ops.extract_features_fused``, all 38 features in one
launch), on the CPU the plain features (``core.features``). The
reference pads the tail chunk so that every chunk reuses one XLA
compilation and puts an ``optimization_barrier`` between the feature and
the LF stages so that XLA cannot fuse them; eager PyTorch compiles
nothing per shape and fuses nothing, so neither is needed here. The
reference shards each chunk's windows over a device mesh; under an
active mesh (``dist.sharding.set_mesh``) the port gives each device
whole chunks instead, chunk k to device k mod n of the mesh's data axes,
a round of n chunks queued before their results are read back. All math
is per window, so neither the chunking nor the placement changes a row.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core import features as F
from repro_torch.core import labeling
from repro_torch.data import windows as W
from repro_torch.data.azure_synth import generate_traces
from repro_torch.dist import sharding as shd

DEFAULT_CHUNK = 8192
SPLIT_NAMES = ("train", "val", "test")


@dataclasses.dataclass
class BuiltDataset:
    """Materialized AAPAset: window arrays + weak labels + provenance.

    `split` codes rows 0/1/2 = train/val/test (``SPLIT_NAMES``); `votes`
    keeps the raw per-LF outputs so dataset cards can report coverage and
    conflict without re-running the LFs.
    """

    windows: np.ndarray      # [N, W] f32 per-minute invocation counts
    features: np.ndarray     # [N, 38] f32
    labels: np.ndarray       # [N] int32 in {-1, 0..3} (-1 = all abstained)
    confidence: np.ndarray   # [N] f32 LF agreement fraction
    votes: np.ndarray        # [N, N_LFS] int8 raw LF outputs
    func_id: np.ndarray      # [N] int32
    start_min: np.ndarray    # [N] int32
    pattern: np.ndarray      # [N] int32 generator ground truth
    day: np.ndarray          # [N] int32 1-based day of window end
    split: np.ndarray        # [N] int8 0/1/2 = train/val/test
    series: np.ndarray       # [F_active, T] f32 counts of kept functions
    series_pattern: np.ndarray  # [F_active] int32

    def __len__(self):
        return self.windows.shape[0]

    def split_mask(self, name: str) -> np.ndarray:
        return self.split == SPLIT_NAMES.index(name)


def _build_chunk(wb: torch.Tensor, *, use_kernel: bool):
    """One chunk: windows [C, W] -> (features [C, 38], labels [C],
    confidence [C], votes [C, N_LFS] int8)."""
    if use_kernel:
        from repro_torch.kernels import ops
        feats = ops.extract_features_fused(wb)
    else:
        feats = F.extract_features(wb)
    votes = labeling.apply_lfs(feats)
    labels, conf, _ = labeling.majority_vote(votes)
    return feats, labels, conf, votes.to(torch.int8)


def featurize_windows(windows: np.ndarray, *, chunk: int = DEFAULT_CHUNK,
                      use_kernel: bool | None = None, device="cuda"):
    """Extract 38 features + weak labels + LF votes for every window.

    Returns (features [N, 38], labels [N], confidence [N],
    votes [N, N_LFS]) as host arrays. `use_kernel=None` takes the
    ``window_features`` kernel iff `device` is CUDA; ``True`` asks for
    the kernel and raises on the CPU, which has none. Under an active
    mesh the chunks run round-robin on its data-axis devices (see the
    module docstring), and `device` must be of their type
    (``dist.sharding.check_device``)."""
    dev = _device.resolve(device)
    devs = shd.placement(dev)
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    if use_kernel and dev.type != "cuda":
        raise ValueError("the window_features kernel needs a CUDA device; "
                         "pass use_kernel=False for the plain features")
    windows = np.asarray(windows, np.float32)
    N = windows.shape[0]

    feats = np.empty((N, F.N_FEATURES), np.float32)
    labels = np.empty((N,), np.int32)
    conf = np.empty((N,), np.float32)
    votes = np.empty((N, labeling.N_LFS), np.int8)
    for first in range(0, N, chunk * len(devs)):
        queued = []
        for d, lo in zip(devs, range(first, min(first + chunk * len(devs),
                                                N), chunk)):
            hi = min(lo + chunk, N)
            wb = torch.as_tensor(windows[lo:hi]).to(d)
            queued.append((lo, hi, _build_chunk(wb, use_kernel=use_kernel)))
        for lo, hi, out in queued:
            for dst, src in zip((feats, labels, conf, votes), out):
                dst[lo:hi] = src.cpu().numpy()
    return feats, labels, conf, votes


def build(cfg, *, device="cuda") -> BuiltDataset:
    """Full build for one `manifest.DatasetConfig`: generate traces, slice
    windows, run the chunked featurize/label step on `device`, assign day
    splits. The feature path is `cfg.resolved_feature_path(device)`."""
    traces = generate_traces(n_functions=cfg.n_functions,
                             n_days=cfg.n_days, seed=cfg.seed,
                             family=cfg.family)
    ds = W.make_windows(traces, window=cfg.window, stride=cfg.stride,
                        min_total_invocations=cfg.min_total_invocations)
    feats, labels, conf, votes = featurize_windows(
        ds.windows, chunk=cfg.chunk,
        use_kernel=cfg.resolved_feature_path(device) == "kernel",
        device=device)

    masks = W.default_day_split(ds, cfg.n_days)
    split = np.full((len(ds),), -1, np.int8)
    for code, name in enumerate(SPLIT_NAMES):
        split[masks[name]] = code
    if (split < 0).any():
        raise AssertionError("day split left windows unassigned — "
                             "default_day_split must cover every day")

    active = np.unique(ds.func_id)
    return BuiltDataset(
        windows=ds.windows, features=feats, labels=labels,
        confidence=conf, votes=votes, func_id=ds.func_id,
        start_min=ds.start_min, pattern=ds.pattern,
        day=ds.day().astype(np.int32), split=split,
        series=traces.counts[active].astype(np.float32),
        series_pattern=traces.pattern[active].astype(np.int32))
