"""Order-book microstructure and candle features (numpy, float64, host).

The streaming engine's per-row feature arithmetic, as
``fmda_tpu.ops.microstructure`` defines it, vectorised over a poll's rows:
missing values arrive as NaN or 0, and a division by zero gives 0 (a SQL
null after ``fillna(0)``).  Arrays are ``(N,)`` or ``(N, levels)`` float64;
every function is pure.  The arithmetic is the reference's operation for
operation, so both packages land the same bits.
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict, Sequence

import numpy as np

from fmda_tpu_torch.utils.timeutils import day_of_week, session_start_flag, week_of_month


def _safe_div(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """x/y with 0 where the denominator is 0 (SQL null -> fillna(0))."""
    num = np.asarray(num, np.float64)
    den = np.asarray(den, np.float64)
    out = np.zeros(np.broadcast_shapes(num.shape, den.shape), np.float64)
    np.divide(num, den, out=out, where=den != 0)
    return out


def weighted_average_distance(
    prices: np.ndarray, sizes: np.ndarray
) -> np.ndarray:
    """Size-weighted average distance from the best price,
    ``sum_l (p_0 - p_l) * s_l / sum_l s_l``; levels with a zero or NaN
    price or size add 0 to the numerator."""
    prices = np.nan_to_num(np.asarray(prices, np.float64))
    sizes = np.nan_to_num(np.asarray(sizes, np.float64))
    best = prices[:, :1]
    num = ((best - prices) * sizes).sum(axis=1)
    den = sizes.sum(axis=1)
    return _safe_div(num, den)


def volume_imbalance(bid_sizes: np.ndarray, ask_sizes: np.ndarray) -> np.ndarray:
    """(V_b - V_a) / (V_b + V_a) at the best level."""
    vb = np.nan_to_num(np.asarray(bid_sizes, np.float64))[:, 0]
    va = np.nan_to_num(np.asarray(ask_sizes, np.float64))[:, 0]
    return _safe_div(vb - va, vb + va)


def delta(bid_sizes: np.ndarray, ask_sizes: np.ndarray) -> np.ndarray:
    """Total ask size minus total bid size."""
    vb = np.nan_to_num(np.asarray(bid_sizes, np.float64)).sum(axis=1)
    va = np.nan_to_num(np.asarray(ask_sizes, np.float64)).sum(axis=1)
    return va - vb


def micro_price(
    bids: np.ndarray, bid_sizes: np.ndarray, asks: np.ndarray, ask_sizes: np.ndarray
) -> np.ndarray:
    """Gatheral-Oomen micro-price ``I*P_a + (1-I)*P_b`` with
    ``I = V_b / (V_b + V_a)``."""
    pb = np.nan_to_num(np.asarray(bids, np.float64))[:, 0]
    pa = np.nan_to_num(np.asarray(asks, np.float64))[:, 0]
    vb = np.nan_to_num(np.asarray(bid_sizes, np.float64))[:, 0]
    va = np.nan_to_num(np.asarray(ask_sizes, np.float64))[:, 0]
    i_t = _safe_div(vb, vb + va)
    out = i_t * pa + (1.0 - i_t) * pb
    # 0/0 book -> I null -> product null -> fillna(0)
    return np.where((vb + va) == 0, 0.0, out)


def spread(bids: np.ndarray, asks: np.ndarray) -> np.ndarray:
    """``bid_0 - ask_0`` when both sides are quoted, else 0 (the sign is
    the feature's own convention)."""
    pb = np.nan_to_num(np.asarray(bids, np.float64))[:, 0]
    pa = np.nan_to_num(np.asarray(asks, np.float64))[:, 0]
    return np.where((pa != 0) & (pb != 0), pb - pa, 0.0)


def rebase_levels(prices: np.ndarray) -> np.ndarray:
    """Prices relative to the best level: ``p_0 - p_l`` for levels >= 1,
    0 where the level is unquoted; level 0 is dropped.  Input (N, L);
    output (N, L-1)."""
    prices = np.nan_to_num(np.asarray(prices, np.float64))
    best = prices[:, :1]
    rebased = np.where(prices[:, 1:] != 0, best - prices[:, 1:], 0.0)
    return rebased


def wick_percentage(
    open_: np.ndarray, high: np.ndarray, low: np.ndarray, close: np.ndarray
) -> np.ndarray:
    """Candle wick fraction: high - close for a bullish candle, low -
    close for a bearish one, over the candle's size."""
    o = np.asarray(open_, np.float64)
    h = np.asarray(high, np.float64)
    l = np.asarray(low, np.float64)
    c = np.asarray(close, np.float64)
    candle = h - l
    wick = np.where(c >= o, h - c, l - c)
    return _safe_div(wick, candle)


def calendar_features(timestamps: Sequence[_dt.datetime]) -> Dict[str, np.ndarray]:
    """Manual one-hot calendar features:
    ``day_1..day_4`` (ISO weekday), ``week_1..week_4`` (week of month),
    ``session_start``."""
    n = len(timestamps)
    out: Dict[str, np.ndarray] = {}
    days = np.array([day_of_week(t) for t in timestamps])
    weeks = np.array([week_of_month(t) for t in timestamps])
    session = np.array([session_start_flag(t) for t in timestamps], np.float64)
    for d in range(1, 5):
        out[f"day_{d}"] = (days == d).astype(np.float64)
    for w in range(1, 5):
        out[f"week_{w}"] = (weeks == w).astype(np.float64)
    out["session_start"] = session
    return out


def deep_features(
    bids: np.ndarray,
    bid_sizes: np.ndarray,
    asks: np.ndarray,
    ask_sizes: np.ndarray,
    timestamps: Sequence[_dt.datetime],
) -> Dict[str, np.ndarray]:
    """All order-book features for a batch of rows, keyed by the warehouse
    column names of :meth:`FeatureConfig.deep_columns`."""
    n, bid_levels = np.asarray(bids).shape
    ask_levels = np.asarray(asks).shape[1]
    out: Dict[str, np.ndarray] = {}
    bid_sizes = np.nan_to_num(np.asarray(bid_sizes, np.float64))
    ask_sizes = np.nan_to_num(np.asarray(ask_sizes, np.float64))
    for i in range(bid_levels):
        out[f"bid_{i}_size"] = bid_sizes[:, i]
    rb = rebase_levels(bids)
    for i in range(1, bid_levels):
        out[f"bid_{i}"] = rb[:, i - 1]
    for i in range(ask_levels):
        out[f"ask_{i}_size"] = ask_sizes[:, i]
    ra = rebase_levels(asks)
    for i in range(1, ask_levels):
        out[f"ask_{i}"] = ra[:, i - 1]
    out["bids_ord_WA"] = weighted_average_distance(bids, bid_sizes)
    out["asks_ord_WA"] = weighted_average_distance(asks, ask_sizes)
    out["vol_imbalance"] = volume_imbalance(bid_sizes, ask_sizes)
    out["delta"] = delta(bid_sizes, ask_sizes)
    out["micro_price"] = micro_price(bids, bid_sizes, asks, ask_sizes)
    out["spread"] = spread(bids, asks)
    out.update(calendar_features(timestamps))
    return out
