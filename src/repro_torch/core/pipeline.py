"""End-to-end AAPA pipeline: traces -> windows -> features -> weak labels
-> GBDT -> beta calibration -> deployable classifier (port of
``repro.core.pipeline``).

The classifier trains on the weak labels of days 1-9, calibrates on the
validation days 10-11 and reports accuracy on days 12-14 (paper Figure
1), on the card unless the caller asks for the CPU: `train_aapa` from a
TraceSet, `train_from_loader` / `train_classifier` from a named,
hash-pinned AAPAset artifact (``repro_torch.aapaset``). Its accuracies
and validation probabilities come from ``kernels.ops.gbdt_logits``, the
``gbdt_tables`` kernel on the card.

`TrainedAAPA.save` and `.load` use the reference's single-file npz (same
keys), so a classifier trained by either package loads in the other.
`make_classify` returns the `classify(features [..., 38]) -> (class id,
confidence)` that ``scaling.policies.aapa_controller`` takes.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core import calibration, gbdt
from repro_torch.data import windows as W
from repro_torch.data.azure_synth import TraceSet


def _params_to(p: gbdt.GBDTParams, dev: torch.device) -> gbdt.GBDTParams:
    """`p` with every tensor, its node tables too, copied to `dev`."""
    return gbdt.GBDTParams(
        *(t.to(dev) for t in (p.feat, p.thresh, p.leaf, p.bin_edges,
                              p.base)),
        tables=gbdt.NodeTables(*(t.to(dev) for t in p.tables)))


def _cal_to(c: calibration.BetaCalibration,
            dev: torch.device) -> calibration.BetaCalibration:
    return calibration.BetaCalibration(*(t.to(dev) for t in (
        c.a_raw, c.b_raw, c.c)))


@dataclasses.dataclass(frozen=True)
class Classify:
    """classify(features [..., F]) -> (class id int32 [...], confidence
    f32 [...]): GBDT logits, softmax, beta calibration, argmax and max.
    The logits come from `logits(params, X [N, F])`, by default
    ``kernels.ops.gbdt_logits`` (the ``gbdt_tables`` kernel on CUDA
    tensors, its plain version on the CPU); a plain episode on the card
    passes ``kernels.ref.gbdt_logits_ref``. The AAPA episode kernel reads
    `params` and `cal` to run the same classifier per lane.

    `classify_windows(windows [..., W])` is what the eager AAPA and
    hybrid minute hooks call: the 38 features from `features([N, W])`,
    by default ``kernels.ops.extract_features_fused`` (the
    ``window_features`` kernel on CUDA tensors, its plain version on the
    CPU; a plain episode on the card passes
    ``kernels.ref.extract_features_ref``), then the classifier."""
    params: gbdt.GBDTParams
    cal: calibration.BetaCalibration
    logits: Callable[[gbdt.GBDTParams, torch.Tensor], torch.Tensor] | None \
        = None
    features: Callable[[torch.Tensor], torch.Tensor] | None = None

    @property
    def device(self) -> torch.device:
        return self.params.device

    def to(self, device) -> "Classify":
        """This classifier with its ensemble and calibration copied to
        `device` (itself when they are there): what AAPA and hybrid lanes
        on that device classify with."""
        dev = _device.canonical(device)
        if self.params.device == dev:
            return self
        return dataclasses.replace(self, params=_params_to(self.params, dev),
                                   cal=_cal_to(self.cal, dev))

    def classify_windows(self, windows: torch.Tensor):
        from repro_torch.kernels import ops
        features = self.features or ops.extract_features_fused
        feats = features(windows.reshape(-1, windows.shape[-1]).contiguous())
        return self(feats.reshape(windows.shape[:-1] + feats.shape[-1:]))

    def __call__(self, feats: torch.Tensor):
        from repro_torch.kernels import ops
        logits = self.logits or ops.gbdt_logits
        lanes = feats.shape[:-1]
        flat = feats.reshape(-1, feats.shape[-1]).to(torch.float32)
        probs = gbdt.softmax(logits(self.params, flat))
        calp = calibration.calibrate(self.cal, probs)
        arch = torch.argmax(calp, -1).to(torch.int32)
        return arch.reshape(lanes), calp.amax(-1).reshape(lanes)


@dataclasses.dataclass
class TrainedAAPA:
    params: gbdt.GBDTParams
    cal: calibration.BetaCalibration
    train_acc: float
    val_acc: float
    test_acc: float
    label_dist: np.ndarray     # weak-label distribution over 4 classes
    n_windows: int
    fit_seconds: float
    dataset_id: str = ""       # "name-hash12" when trained from an artifact

    def make_classify(self) -> Classify:
        return Classify(self.params, self.cal)

    def to(self, device) -> "TrainedAAPA":
        """This classifier with its tensors copied to `device`."""
        cls = self.make_classify().to(device)
        return dataclasses.replace(self, params=cls.params, cal=cls.cal)

    def save(self, path: str | pathlib.Path) -> None:
        """Single-file npz round-trip (classifier + calibration + card),
        the reference's keys."""
        p, cal = self.params, self.cal

        def host(t):
            return t.detach().cpu().numpy()

        np.savez(
            path,
            feat=host(p.feat), thresh=host(p.thresh), leaf=host(p.leaf),
            bin_edges=host(p.bin_edges), base=host(p.base),
            cal_a_raw=host(cal.a_raw), cal_b_raw=host(cal.b_raw),
            cal_c=host(cal.c),
            label_dist=np.asarray(self.label_dist),
            scalars=np.array([self.train_acc, self.val_acc, self.test_acc,
                              float(self.n_windows), self.fit_seconds],
                             np.float64),
            dataset_id=np.array(self.dataset_id))

    @classmethod
    def load(cls, path: str | pathlib.Path,
             device="cuda") -> "TrainedAAPA":
        with np.load(path) as z:
            return cls._from_npz(z, device)

    @classmethod
    def _from_npz(cls, z, device="cuda") -> "TrainedAAPA":
        params = gbdt.from_arrays(z["feat"], z["thresh"], z["leaf"],
                                  z["bin_edges"], z["base"], device=device)
        cal = calibration.from_arrays(z["cal_a_raw"], z["cal_b_raw"],
                                      z["cal_c"], device=device)
        s = z["scalars"]
        return cls(params=params, cal=cal, train_acc=float(s[0]),
                   val_acc=float(s[1]), test_acc=float(s[2]),
                   label_dist=np.asarray(z["label_dist"]),
                   n_windows=int(s[3]), fit_seconds=float(s[4]),
                   dataset_id=str(z["dataset_id"]))


def featurize_and_label(ds: W.WindowDataset, batch: int = 8192,
                        device="cuda"):
    """Extract 38 features + weak labels for every window on `device`.

    Thin wrapper over the chunked AAPAset builder, for callers that work
    from a raw ``WindowDataset`` rather than a named artifact. Always the
    plain feature math (the reference's contract: the same bytes on
    every backend); artifact builds choose their feature path through
    ``DatasetConfig.feature_path``."""
    from repro_torch.aapaset.build import featurize_windows
    feats, labels, confs, _ = featurize_windows(
        ds.windows, chunk=batch, use_kernel=False, device=device)
    return feats, labels, confs


def _fit_classifier(X, y, split_masks, cfg: gbdt.GBDTConfig,
                    *, verbose: bool, dataset_id: str = "",
                    device="cuda") -> TrainedAAPA:
    """Shared trainer: fit on the train mask, calibrate on val, report
    accuracies. `X`/`y` must already be restricted to labeled windows
    (y >= 0). Predictions go through ``kernels.ops.gbdt_logits``."""
    from repro_torch.kernels import ops
    dev = _device.resolve(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    params = gbdt.fit(X[split_masks["train"]], y[split_masks["train"]],
                      cfg, verbose=verbose, device=dev)
    sync()
    fit_s = time.perf_counter() - t0

    def logits(m):
        return ops.gbdt_logits(params, torch.as_tensor(X[m]).to(dev))

    def acc(m):
        if m.sum() == 0:
            return float("nan")
        pred = logits(m).argmax(-1).cpu().numpy()
        return float((pred == y[m]).mean())

    probs_val = gbdt.softmax(logits(split_masks["val"]))
    cal = calibration.fit(probs_val, y[split_masks["val"]], device=dev)

    dist = np.bincount(y, minlength=4) / max(len(y), 1)
    return TrainedAAPA(params=params, cal=cal,
                       train_acc=acc(split_masks["train"]),
                       val_acc=acc(split_masks["val"]),
                       test_acc=acc(split_masks["test"]),
                       label_dist=dist, n_windows=len(y),
                       fit_seconds=fit_s, dataset_id=dataset_id)


def train_aapa(traces: TraceSet, cfg: gbdt.GBDTConfig = gbdt.GBDTConfig(),
               *, verbose: bool = False, device="cuda") -> TrainedAAPA:
    """Train directly from a TraceSet (no artifact cache)."""
    ds = W.make_windows(traces)
    split = W.default_day_split(ds, traces.n_days)
    X, y, conf = featurize_and_label(ds, device=device)

    labeled = y >= 0  # drop windows where every LF abstained
    masks = {k: m[labeled] for k, m in split.items()}
    return _fit_classifier(X[labeled], y[labeled], masks, cfg,
                           verbose=verbose, device=device)


def train_from_loader(loader, cfg: gbdt.GBDTConfig = gbdt.GBDTConfig(),
                      *, verbose: bool = False) -> TrainedAAPA:
    """Train from a built AAPAset artifact through its loader, on the
    loader's device: the classifier names the exact dataset it was
    trained on (``trained.dataset_id``)."""
    from repro_torch.aapaset.build import SPLIT_NAMES
    idx = loader.split_indices(None)                 # all labeled rows
    X = loader.data.features[idx]
    y = loader.data.labels[idx]
    split = loader.data.split[idx]
    masks = {name: split == code
             for code, name in enumerate(SPLIT_NAMES)}
    return _fit_classifier(X, y, masks, cfg, verbose=verbose,
                           dataset_id=loader.dataset_id,
                           device=loader.device)


# Bump whenever gbdt.fit / calibration.fit / _fit_classifier change in a
# way that alters trained outputs: it keys the classifier npz cache the
# same way aapaset's SCHEMA_VERSION keys dataset artifacts.
CLASSIFIER_VERSION = 1


def train_classifier(dataset: str = "aapaset_ci",
                     cfg: gbdt.GBDTConfig = gbdt.GBDTConfig(),
                     *, root=None, cache: bool = True,
                     verbose: bool = False, loader_factory=None,
                     device="cuda") -> TrainedAAPA:
    """Build-or-load a named dataset on `device`, then train-or-load the
    classifier on the loader's device.

    The trained model is cached as npz inside the dataset artifact
    directory under the port's root (``aapaset.manifest.DEFAULT_ROOT``),
    keyed by (CLASSIFIER_VERSION, GBDT config), so callers reuse one fit.
    On a classifier-cache hit no dataset shard is touched; on a miss the
    dataset comes from `loader_factory()` when given (lets callers share
    one loaded artifact) else is built or loaded fresh.
    """
    from repro_torch.aapaset import manifest as MF
    from repro_torch.aapaset import registry
    from repro_torch.aapaset.loader import AAPAsetLoader

    root = MF.DEFAULT_ROOT if root is None else root
    key = MF.hash_json({"v": CLASSIFIER_VERSION,
                        "gbdt": dataclasses.asdict(cfg)}, n=8)
    path = MF.artifact_dir(registry.get(dataset), root, device) \
        / f"classifier-{key}.npz"
    if cache and path.exists():       # skip loading the dataset shards
        return TrainedAAPA.load(path, device=device)
    loader = loader_factory() if loader_factory is not None \
        else AAPAsetLoader.from_name(dataset, root, device=device)
    trained = train_from_loader(loader, cfg, verbose=verbose)
    # a dataset too small for a test split (n_days <= 2) yields
    # test_acc = NaN by design — return it, but never cache it
    if cache and np.isfinite(trained.test_acc):
        path.parent.mkdir(parents=True, exist_ok=True)
        MF.sweep_stale_tmp(path.parent, f".tmp-*-{path.name}")
        tmp = path.with_name(f".tmp-{os.getpid()}-{path.name}")
        trained.save(tmp)
        tmp.replace(path)             # atomic: never a half-written cache
    return trained
