"""Windowed technical indicators and target construction (numpy).

The warehouse's derived views, kept bit-identical to the ones the JAX
package computes over the same SQLite file.  SQL window-frame semantics:

- ``ROWS BETWEEN k PRECEDING AND CURRENT ROW`` aggregates over *up to*
  ``k+1`` trailing rows, partial at the head of the table;
- ``STD()`` is the population standard deviation;
- ``LAG``/``LEAD`` give NULL beyond the table edge, and the downstream
  ``CASE WHEN NULL`` / ``IFNULL`` turn those into 0 (NaN propagation
  plus explicit zeroing here).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from fmda_tpu_torch.config import FeatureConfig


def _trailing_window_view(x: np.ndarray, rows: int) -> np.ndarray:
    """(N, rows) view where row i holds x[i-rows+1 .. i], NaN-padded at
    the head."""
    x = np.asarray(x, np.float64)
    padded = np.concatenate([np.full(rows - 1, np.nan), x])
    return np.lib.stride_tricks.sliding_window_view(padded, rows)


def rolling_mean(x: np.ndarray, rows: int) -> np.ndarray:
    """SQL ``AVG(...) OVER (ROWS BETWEEN rows-1 PRECEDING AND CURRENT ROW)``."""
    return np.nanmean(_trailing_window_view(x, rows), axis=1)


def rolling_std(x: np.ndarray, rows: int) -> np.ndarray:
    """SQL ``STD(...)`` over the trailing frame (population std)."""
    return np.nanstd(_trailing_window_view(x, rows), axis=1)


def rolling_min(x: np.ndarray, rows: int) -> np.ndarray:
    return np.nanmin(_trailing_window_view(x, rows), axis=1)


def rolling_max(x: np.ndarray, rows: int) -> np.ndarray:
    return np.nanmax(_trailing_window_view(x, rows), axis=1)


def lag(x: np.ndarray, k: int) -> np.ndarray:
    """SQL ``LAG(x, k)``: NaN for the first k rows."""
    x = np.asarray(x, np.float64)
    out = np.full_like(x, np.nan)
    if k < len(x):
        out[k:] = x[: len(x) - k]
    return out


def lead(x: np.ndarray, k: int) -> np.ndarray:
    """SQL ``LEAD(x, k)``: NaN for the last k rows."""
    x = np.asarray(x, np.float64)
    out = np.full_like(x, np.nan)
    if k < len(x):
        out[: len(x) - k] = x[k:]
    return out


def bollinger_bands(
    close: np.ndarray, period: int, n_std: float
) -> Dict[str, np.ndarray]:
    """Distances to the Bollinger bands: ``(avg + n*std) - close`` and
    ``close - (avg - n*std)``."""
    avg = rolling_mean(close, period)
    std = rolling_std(close, period)
    close = np.asarray(close, np.float64)
    return {
        "upper_BB_dist": (avg + n_std * std) - close,
        "lower_BB_dist": close - (avg - n_std * std),
    }


def stochastic_oscillator(close: np.ndarray, preceding: int = 14) -> np.ndarray:
    """0-1 ranged %K over ``preceding`` PRECEDING AND CURRENT ROW."""
    rows = preceding + 1
    lo = rolling_min(close, rows)
    hi = rolling_max(close, rows)
    close = np.asarray(close, np.float64)
    rng = hi - lo
    out = np.full_like(close, np.nan)
    np.divide(close - lo, rng, out=out, where=rng != 0)
    return out


def price_change(close: np.ndarray) -> np.ndarray:
    """``close - LAG(close, 1)``; first row NaN."""
    return np.asarray(close, np.float64) - lag(close, 1)


def average_true_range(
    high: np.ndarray, low: np.ndarray, preceding: int = 14
) -> np.ndarray:
    """``AVG(high - low)`` over the trailing ``preceding+1``-row frame."""
    return rolling_mean(np.asarray(high, np.float64) - np.asarray(low, np.float64),
                        preceding + 1)


def movement_targets(
    close: np.ndarray,
    atr: np.ndarray,
    *,
    n1: float = 1.5,
    n2: float = 3.0,
    lead1: int = 8,
    lead2: int = 15,
) -> np.ndarray:
    """ATR-scaled future-movement labels, (N, 4) float {0,1} columns
    [up1, up2, down1, down2]; rows whose LEAD runs past the edge get 0."""
    close = np.asarray(close, np.float64)
    atr = np.asarray(atr, np.float64)
    p_lead1 = lead(close, lead1)
    p_lead2 = lead(close, lead2)
    with np.errstate(invalid="ignore"):
        up1 = p_lead1 >= close + n1 * atr
        up2 = p_lead2 >= close + n2 * atr
        down1 = p_lead1 <= close - n1 * atr
        down2 = p_lead2 <= close - n2 * atr
    return np.stack([up1, up2, down1, down2], axis=1).astype(np.float64)


def derived_features(
    table: Dict[str, np.ndarray], cfg: FeatureConfig
) -> Dict[str, np.ndarray]:
    """All view columns of :meth:`FeatureConfig.derived_columns` from the
    warehoused table columns."""
    out: Dict[str, np.ndarray] = {}
    close = table.get("4_close")
    if cfg.bollinger_period and cfg.bollinger_std and close is not None:
        out.update(bollinger_bands(close, cfg.bollinger_period, cfg.bollinger_std))
    if cfg.get_stock_volume and "5_volume" in table:
        for p in cfg.volume_ma_periods:
            out[f"vol_MA{p}"] = rolling_mean(table["5_volume"], p)
    if close is not None:
        for p in cfg.price_ma_periods:
            out[f"price_MA{p}"] = rolling_mean(close, p)
    if "delta" in table:
        for p in cfg.delta_ma_periods:
            out[f"delta_MA{p}"] = rolling_mean(table["delta"], p)
    if cfg.stochastic_oscillator and close is not None:
        out["stoch"] = stochastic_oscillator(close, cfg.stoch_preceding)
    if close is not None and "2_high" in table and "3_low" in table:
        out["ATR"] = average_true_range(
            table["2_high"], table["3_low"], cfg.atr_preceding
        )
        out["price_change"] = price_change(close)
    return out


def landed_row_transform(columns, cfg: FeatureConfig):
    """Stateful chunk mapper from raw landed table columns to the joined
    ``x_fields`` rows :meth:`Warehouse.fetch` serves for the same
    positions.

    Each call maps one ``(B, W)`` float64 chunk (columns in ``columns``
    order, as ``iter_row_chunks`` yields them) to ``(B, W+D)`` float32
    rows: the raw columns, then :meth:`FeatureConfig.derived_columns`,
    NaN -> 0.  The closure keeps the trailing ``cfg.max_lookback - 1`` raw
    rows as context, so the windowed views at chunk boundaries equal the
    whole table's; build a fresh transform per replay (its state carries
    across calls, in landed order only).
    """
    columns = tuple(columns)
    derived_cols = cfg.derived_columns()
    context = max(0, cfg.max_lookback - 1)
    buf = np.empty((0, len(columns)), np.float64)

    def transform(matrix: np.ndarray) -> np.ndarray:
        nonlocal buf
        matrix = np.asarray(matrix, np.float64).reshape(-1, len(columns))
        full = np.concatenate([buf, matrix], axis=0)
        table = {c: full[:, j] for j, c in enumerate(columns)}
        derived = derived_features(table, cfg)
        b = matrix.shape[0]
        out = np.empty((b, len(columns) + len(derived_cols)), np.float64)
        out[:, : len(columns)] = matrix
        for j, c in enumerate(derived_cols):
            out[:, len(columns) + j] = derived[c][len(full) - b:]
        if context:
            buf = full[-context:]
        return np.nan_to_num(out, nan=0.0).astype(np.float32)

    return transform


def build_targets(table: Dict[str, np.ndarray], cfg: FeatureConfig) -> np.ndarray:
    """Target matrix (N, 4) from the warehoused table."""
    atr = average_true_range(table["2_high"], table["3_low"], cfg.atr_preceding)
    return movement_targets(
        table["4_close"],
        atr,
        n1=cfg.target_n1,
        n2=cfg.target_n2,
        lead1=cfg.target_lead1,
        lead2=cfg.target_lead2,
    )
