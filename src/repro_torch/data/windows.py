"""Sliding-window dataset construction (NumPy copy of ``repro.data.windows``,
paper §III.B.1, §IV.A).

60-minute windows, 10-minute stride; day-based splits: days 1-9 train,
10-11 validation, 12-14 test.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.azure_synth import MINUTES_PER_DAY, TraceSet

WINDOW_MIN = 60
STRIDE_MIN = 10


@dataclasses.dataclass
class WindowDataset:
    windows: np.ndarray    # [N, window] f32 counts (width need not be 60)
    func_id: np.ndarray    # [N] int32
    start_min: np.ndarray  # [N] int32 (global minute index of window start)
    pattern: np.ndarray    # [N] int32 generator ground truth (diagnostics)

    def __len__(self):
        return self.windows.shape[0]

    def day(self) -> np.ndarray:
        """1-based day index of each window (by window end)."""
        width = self.windows.shape[1]
        return ((self.start_min + width - 1) // MINUTES_PER_DAY) + 1


def make_windows(traces: TraceSet, *, window: int = WINDOW_MIN,
                 stride: int = STRIDE_MIN,
                 min_total_invocations: float = 1000.0) -> WindowDataset:
    """Slice every function's count series into sliding windows.

    Functions with fewer than `min_total_invocations` total invocations are
    filtered out (paper §IV.A preprocessing step 1).
    """
    counts = traces.counts
    active = counts.sum(axis=1) >= min_total_invocations
    counts = counts[active]
    patterns = traces.pattern[active]
    func_idx = np.nonzero(active)[0]

    F, T = counts.shape
    starts = np.arange(0, T - window + 1, stride, dtype=np.int32)
    # stride-window view: [F, n_starts, window]
    wins = np.lib.stride_tricks.sliding_window_view(
        counts, window, axis=1)[:, ::stride, :]
    n_starts = wins.shape[1]
    windows = wins.reshape(-1, window).astype(np.float32)
    func_id = np.repeat(func_idx, n_starts).astype(np.int32)
    start_min = np.tile(starts[:n_starts], F).astype(np.int32)
    pattern = np.repeat(patterns, n_starts).astype(np.int32)
    return WindowDataset(windows, func_id, start_min, pattern)


def day_split(ds: WindowDataset, train_days=(1, 9), val_days=(10, 11),
              test_days=(12, 14)):
    """Split by day-of-window-end. Returns dict of boolean masks."""
    d = ds.day()
    def mask(lo_hi):
        lo, hi = lo_hi
        return (d >= lo) & (d <= hi)
    return {"train": mask(train_days), "val": mask(val_days),
            "test": mask(test_days)}


def default_day_split(ds: WindowDataset, n_days: int):
    """Day split in the paper's 9/2/3 proportions, covering every day of
    the trace (at n_days=14 this is exactly the paper's 1-9 / 10-11 /
    12-14 split). Returns dict of boolean masks."""
    t_end = max(int(n_days * 9 / 14), 1)
    v_end = max(int(n_days * 11 / 14), t_end + 1)
    return day_split(ds, train_days=(1, t_end),
                     val_days=(t_end + 1, v_end),
                     test_days=(v_end + 1, n_days))


def subset(ds: WindowDataset, mask: np.ndarray) -> WindowDataset:
    return WindowDataset(ds.windows[mask], ds.func_id[mask],
                         ds.start_min[mask], ds.pattern[mask])
