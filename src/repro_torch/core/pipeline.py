"""The deployable AAPA classifier: GBDT + beta calibration (port of
``repro.core.pipeline``, inference only).

`TrainedAAPA.load` reads the single-file npz the reference's
``TrainedAAPA.save`` writes (same keys); training stays in the reference
until the port's training path lands. `make_classify` returns the
`classify(features [..., 38]) -> (class id, confidence)` that
``scaling.policies.aapa_controller`` takes.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Callable

import numpy as np
import torch

from repro_torch.core import calibration, gbdt


@dataclasses.dataclass(frozen=True)
class Classify:
    """classify(features [..., F]) -> (class id int32 [...], confidence
    f32 [...]): GBDT logits, softmax, beta calibration, argmax and max.
    The logits come from `logits(params, X [N, F])`, by default
    ``kernels.ops.gbdt_logits`` (the ``gbdt_tables`` kernel on CUDA
    tensors, its plain version on the CPU); a plain episode on the card
    passes ``kernels.ref.gbdt_logits_ref``. The AAPA episode kernel reads
    `params` and `cal` to run the same classifier per lane."""
    params: gbdt.GBDTParams
    cal: calibration.BetaCalibration
    logits: Callable[[gbdt.GBDTParams, torch.Tensor], torch.Tensor] | None \
        = None

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
