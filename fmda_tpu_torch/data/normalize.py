"""Chunked min-max normalization, as ``fmda_tpu.data.normalize`` does it:

- per-chunk MIN/MAX per feature column;
- a MIN==MAX jitter guard (``max += max*1e-3``, or ``1e-3`` if zero);
- order-book size columns share one MIN/MAX across the levels of a side;
- the last chunk's stats are kept for validation, test and serving.

:func:`save_norm_params`/:func:`load_norm_params` read and write the
reference's JSON artifact (``{name: {"MIN": .., "MAX": ..}}``), so a
model trained by ``fmda_tpu`` carries its norm stats into the port.
"""

from __future__ import annotations

import json
from typing import Dict, List, NamedTuple, Sequence

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


def save_norm_params(
    path: str, params: NormParams, x_fields: Sequence[str]
) -> None:
    """Write the stats as ``{name: {"MIN": .., "MAX": ..}}`` JSON, in
    ``x_fields`` order."""
    payload: Dict[str, Dict[str, float]] = {
        name: {"MIN": float(params.x_min[i]), "MAX": float(params.x_max[i])}
        for i, name in enumerate(x_fields)
    }
    with open(path, "w") as fh:
        json.dump(payload, fh)


def load_norm_params(path: str) -> NormParams:
    """Read the stats :func:`save_norm_params` (or ``fmda_tpu``'s) wrote,
    float32, in the file's column order."""
    with open(path) as fh:
        payload = json.load(fh)
    x_min = np.array([v["MIN"] for v in payload.values()], np.float32)
    x_max = np.array([v["MAX"] for v in payload.values()], np.float32)
    return NormParams(x_min, x_max)
