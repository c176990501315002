"""Chunked min-max normalization, as ``fmda_tpu.data.normalize`` does it:

- per-chunk MIN/MAX per feature column;
- a MIN==MAX jitter guard (``max += max*1e-3``, or ``1e-3`` if zero);
- order-book size columns share one MIN/MAX across the levels of a side;
- the last chunk's stats are kept for validation, test and serving.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np


class NormParams(NamedTuple):
    x_min: np.ndarray  # (F,)
    x_max: np.ndarray  # (F,)


def _shared_book_indices(
    x_fields: Sequence[str], side: str, levels: int
) -> List[int]:
    names = [f"{side}_{i}_size" for i in range(levels)]
    return [x_fields.index(n) for n in names if n in x_fields]


def chunk_norm_params(
    x: np.ndarray,
    x_fields: Sequence[str],
    *,
    bid_levels: int = 0,
    ask_levels: int = 0,
) -> NormParams:
    """One chunk's min/max stats with the jitter and shared-book guards."""
    x = np.asarray(x, dtype=np.float64)
    # cast to float32 (the pipeline dtype) BEFORE the degenerate-range
    # guard, so a range that underflows to zero in f32 is caught
    x_min = np.nanmin(x, axis=0).astype(np.float32)
    x_max = np.nanmax(x, axis=0).astype(np.float32)

    degenerate = (x_max - x_min) == 0
    x_max = np.where(
        degenerate & (x_max != 0),
        x_max + x_max * np.float32(0.001),
        x_max,
    )
    x_max = np.where(degenerate & (x_max == 0), np.float32(0.001), x_max)
    # subnormal constants defeat the multiplicative jitter in float32
    x_max = np.where(
        (x_max - x_min) == 0, x_min + np.float32(0.001), x_max
    )

    x_fields = list(x_fields)
    if "bid_0_size" in x_fields:
        for side, levels in (("ask", ask_levels), ("bid", bid_levels)):
            idx = _shared_book_indices(x_fields, side, levels)
            if idx:
                x_min[idx] = x_min[idx].min()
                x_max[idx] = x_max[idx].max()

    return NormParams(x_min, x_max)


def normalize(x: np.ndarray, params: NormParams) -> np.ndarray:
    """Min-max scale."""
    return (np.asarray(x, np.float32) - params.x_min) / (
        params.x_max - params.x_min
    )
