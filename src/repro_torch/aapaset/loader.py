"""Deterministic sharded loaders over built AAPAset artifacts (port of
``repro.aapaset.loader``).

One loader feeds all three consumers:

* ``arrays(split)`` — full-split (X, y, conf) host arrays for
  ``core.gbdt.fit`` and ``core.calibration.fit`` (both are full-batch);
* ``batches(split, ...)`` — seeded, shardable minibatches as tensors on
  the loader's device (``shard_index``/``num_shards`` partition the
  permutation the way a data-parallel axis would split a global batch);
* ``series()`` — the kept functions' count series for
  ``forecast.backtest`` / ``forecast.conformal``;
* ``rate_chunks(...)`` — a deterministic fleet feed for
  ``evals.fleet``'s streaming runs.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Iterator

import numpy as np
import torch

from repro_torch import _device
from repro_torch.aapaset import manifest as MF
from repro_torch.aapaset import registry
from repro_torch.aapaset.build import BuiltDataset


@dataclasses.dataclass
class AAPAsetLoader:
    data: BuiltDataset
    manifest: dict
    device: str | torch.device = "cuda"   # where `batches` puts tensors

    @classmethod
    def from_name(cls, name: str,
                  root: pathlib.Path | str = MF.DEFAULT_ROOT, *,
                  device="cuda", **overrides) -> "AAPAsetLoader":
        """Build-or-load a registry dataset (built on `device`) and wrap
        it."""
        cfg = registry.get(name, **overrides)
        built, man = MF.build_or_load(cfg, root, device=device)
        return cls(built, man, device)

    @property
    def name(self) -> str:
        return self.manifest["config"]["name"]

    @property
    def dataset_id(self) -> str:
        """`name-hash12`: the exact artifact identity for logs/benches."""
        return f"{self.name}-{self.manifest['hash']}"

    def split_indices(self, split: str | None = None,
                      *, labeled_only: bool = True) -> np.ndarray:
        mask = np.ones(len(self.data), bool) if split is None \
            else self.data.split_mask(split)
        if labeled_only:
            mask = mask & (self.data.labels >= 0)
        return np.nonzero(mask)[0]

    def arrays(self, split: str | None = None,
               *, labeled_only: bool = True):
        """(X [n, 38], y [n], conf [n]) host arrays for one split."""
        idx = self.split_indices(split, labeled_only=labeled_only)
        return (self.data.features[idx], self.data.labels[idx],
                self.data.confidence[idx])

    def batches(self, split: str, batch_size: int, *, seed: int = 0,
                shard_index: int = 0, num_shards: int = 1,
                labeled_only: bool = True,
                drop_remainder: bool = True) -> Iterator[tuple]:
        """Deterministic minibatches of (X, y, conf) as tensors on the
        loader's device.

        The same (seed, num_shards) always yields the same batch stream;
        shards partition the shuffled index set disjointly. With
        ``drop_remainder=True`` (the lockstep data-parallel setting)
        every shard sees the same number of rows and batches; with
        ``False`` the shards cover the split exactly.
        """
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} out of range "
                             f"for num_shards {num_shards}")
        dev = _device.resolve(self.device)
        idx = self.split_indices(split, labeled_only=labeled_only)
        perm = np.random.default_rng(seed).permutation(idx)
        mine = perm[shard_index::num_shards]
        if drop_remainder:            # equalize shards for lockstep dp
            mine = mine[: len(perm) // num_shards]
        stop = len(mine) - (len(mine) % batch_size if drop_remainder
                            else 0)
        for lo in range(0, stop, batch_size):
            take = mine[lo:lo + batch_size]
            yield tuple(torch.as_tensor(a[take]).to(dev)
                        for a in (self.data.features, self.data.labels,
                                  self.data.confidence))

    def series(self, *, max_functions: int | None = None) -> np.ndarray:
        """[F, T] counts of the kept functions, for forecast backtests."""
        s = self.data.series
        return s if max_functions is None else s[:max_functions]

    def rate_chunks(self, n_workloads: int, w_chunk: int, *,
                    minutes: int | None = None, seed: int = 0,
                    shard_index: int = 0,
                    num_shards: int = 1) -> Iterator[np.ndarray]:
        """Deterministic fleet feed: [w_chunk, minutes] f32 trace chunks
        for ``evals.fleet`` streaming runs, sampled (with replacement
        past F) from the kept functions' count series.

        Chunk c is drawn with an rng seeded on (seed, c), so any chunk
        can be regenerated independently of the others, and a fleet
        larger than the artifact never materializes [W, T] at once —
        each shard generates only the chunks where ``c % num_shards ==
        shard_index`` (disjoint, jointly exhaustive)."""
        if n_workloads % w_chunk:
            raise ValueError(f"w_chunk {w_chunk} must divide "
                             f"n_workloads {n_workloads}")
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} out of range "
                             f"for num_shards {num_shards}")
        s = self.data.series
        T = s.shape[1] if minutes is None else min(int(minutes), s.shape[1])
        for c in range(n_workloads // w_chunk):
            if c % num_shards != shard_index:
                continue
            rng = np.random.default_rng(
                np.random.SeedSequence([seed, c]))
            take = rng.integers(0, s.shape[0], size=w_chunk)
            yield np.ascontiguousarray(s[take, :T]).astype(np.float32)
