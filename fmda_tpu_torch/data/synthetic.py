"""Seeded synthetic warehouse rows: a random walk over the feature schema.

One row per 5-minute bar of the regular session (09:30 to 15:55, 78 bars a
day, weekdays only), so 20,000 rows are about a year of trading.  Every
table column walks on its own; the OHLC columns keep high >= open, close
>= low around a close that walks, so the derived views and the movement
targets come out as a real feed gives them.
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict, List, Sequence

import numpy as np

BARS_PER_DAY = 78


def session_timestamps(n_rows: int, start: str = "2024-01-02") -> List[str]:
    """``n_rows`` bar timestamps from ``start``, weekdays 09:30-15:55."""
    day = _dt.datetime.strptime(start, "%Y-%m-%d")
    out: List[str] = []
    while len(out) < n_rows:
        if day.weekday() < 5:
            open_ = day.replace(hour=9, minute=30)
            for k in range(min(BARS_PER_DAY, n_rows - len(out))):
                ts = open_ + _dt.timedelta(minutes=5 * k)
                out.append(ts.strftime("%Y-%m-%d %H:%M:%S"))
        day += _dt.timedelta(days=1)
    return out


def random_walk_rows(
    columns: Sequence[str], n_rows: int, *, seed: int = 0,
    start: str = "2024-01-02",
) -> List[Dict[str, float]]:
    """Warehouse row dicts (``Timestamp`` plus every column)."""
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.normal(size=(n_rows, len(columns))), axis=0)
    table = {c: walk[:, i] for i, c in enumerate(columns)}
    if "4_close" in table:
        close = 400.0 + np.cumsum(rng.normal(0.0, 0.5, size=n_rows))
        spread = np.abs(rng.normal(0.0, 0.4, size=(n_rows, 3)))
        table["4_close"] = close
        table["1_open"] = close + rng.normal(0.0, 0.2, size=n_rows)
        body_hi = np.maximum(close, table["1_open"])
        body_lo = np.minimum(close, table["1_open"])
        table["2_high"] = body_hi + spread[:, 0]
        table["3_low"] = body_lo - spread[:, 1]
        if "5_volume" in table:
            table["5_volume"] = 1e5 * (1.0 + spread[:, 2])
    stamps = session_timestamps(n_rows, start)
    names = list(table)
    matrix = np.stack([table[c] for c in names], axis=1).tolist()
    return [dict(zip(names, row), Timestamp=ts)
            for ts, row in zip(stamps, matrix)]
