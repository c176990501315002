"""Sliding-window index arithmetic over 1-based row ids."""

from __future__ import annotations

import numpy as np


def window_index_matrix(n_rows: int, window: int) -> np.ndarray:
    """All stride-1 sliding windows over ``n_rows`` positions: an int
    matrix (n_rows - window + 1, window) whose row ``i`` is
    ``[i, ..., i + window - 1]``."""
    if n_rows < window:
        return np.empty((0, window), dtype=np.int64)
    starts = np.arange(n_rows - window + 1, dtype=np.int64)[:, None]
    return starts + np.arange(window, dtype=np.int64)[None, :]
