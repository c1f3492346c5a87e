"""AAPAset (port of ``repro.aapaset``): the paper's 300K weakly labeled
window dataset as an engine — chunked build on the card, content-addressed
shard cache under ``experiments/aapaset_torch``, named dataset registry,
and sharded loaders (paper §III.B, §IV.A).

    from repro_torch import aapaset
    loader = aapaset.AAPAsetLoader.from_name("aapaset_ci")
    X, y, conf = loader.arrays("train")

``manifest`` also holds the content-keying and atomic staged-publish
recipe that ``evals.artifacts`` addresses its result cards with.
"""
from repro_torch.aapaset.build import BuiltDataset, featurize_windows
from repro_torch.aapaset.loader import AAPAsetLoader
from repro_torch.aapaset.manifest import (DEFAULT_ROOT, DatasetConfig,
                                          build_or_load, config_hash,
                                          dataset_card, is_cached,
                                          read_manifest)
from repro_torch.aapaset.registry import available, get, register

__all__ = [
    "AAPAsetLoader", "BuiltDataset", "DatasetConfig", "DEFAULT_ROOT",
    "available", "build_or_load", "config_hash", "dataset_card",
    "featurize_windows", "get", "is_cached", "read_manifest", "register",
]
