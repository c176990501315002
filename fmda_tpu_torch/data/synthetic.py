"""Synthetic market data: the seeded multi-day feed corpus, and seeded
random-walk warehouse rows.

:func:`synthetic_session_messages` yields the five feeds' messages bar by
bar, in the wire shapes the streaming engine consumes, as
``fmda_tpu.data.synthetic`` generates them (the same numpy draws in the
same order, so both packages yield the same messages for a seed);
:func:`build_corpus` replays them through bus -> engine -> warehouse, so
every one of the 108 features comes out of the engine's own join and
feature path.  The price process is learnable from the features:

- a slow momentum state and an order-book imbalance state (both AR(1))
  drive the drift of the mid price;
- the book's size ladder shows the imbalance state (and so
  ``vol_imbalance`` and ``delta`` do);
- volatility follows its own regime, seen in the VIX feed and the bars'
  high-low range (so in ATR).

:func:`random_walk_rows` is the cheaper stand-in: warehouse row dicts
whose every column walks on its own (no engine), one row per 5-minute bar
of the regular session (09:30 to 15:55, 78 bars a day, weekdays only).
"""

from __future__ import annotations

import datetime as dt
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from fmda_tpu_torch.config import (
    DEFAULT_TOPICS,
    FeatureConfig,
    TOPIC_COT,
    TOPIC_DEEP,
    TOPIC_IND,
    TOPIC_VIX,
    TOPIC_VOLUME,
    WarehouseConfig,
)
from fmda_tpu_torch.utils.timeutils import format_ts

BARS_PER_DAY = 78

_COT_KEYS = (
    "long_pos", "long_pos_change", "long_open_int",
    "short_pos", "short_pos_change", "short_open_int",
)


@dataclass(frozen=True)
class SyntheticMarketConfig:
    """Knobs of the synthetic market (all deterministic given ``seed``)."""

    seed: int = 0
    n_days: int = 52
    bars_per_day: int = 78  # 09:30..15:55 at 5-minute cadence
    start_date: str = "2020-01-06"  # a Monday
    start_price: float = 330.0
    #: drift per bar contributed by the (observable) imbalance state
    imbalance_drift: float = 0.22
    #: drift per bar contributed by the (latent but inferable) momentum
    momentum_drift: float = 0.55
    #: noise std of the bar-to-bar return
    noise: float = 0.35
    #: AR(1) coefficients of the momentum / imbalance / vol states
    momentum_ar: float = 0.97
    imbalance_ar: float = 0.90
    vol_ar: float = 0.995


def synthetic_session_messages(
    fc: FeatureConfig, cfg: SyntheticMarketConfig
) -> Iterator[Tuple[str, dict]]:
    """Yield (topic, message) for every feed tick of every trading day,
    in the exact wire shapes the streaming engine consumes."""
    r = np.random.default_rng(cfg.seed)
    day = dt.datetime.strptime(cfg.start_date, "%Y-%m-%d")
    price = cfg.start_price
    momentum = 0.0
    imbalance = 0.0
    vol = 1.0
    cot_state = {
        g: {k: float(r.integers(10_000, 90_000)) for k in _COT_KEYS}
        for g in ("Asset", "Leveraged")
    }

    for _ in range(cfg.n_days):
        while day.weekday() >= 5:  # skip to the next weekday
            day += dt.timedelta(days=1)
        t0 = day.replace(hour=9, minute=30)
        for bar in range(cfg.bars_per_day):
            ts = format_ts(t0 + dt.timedelta(minutes=5 * bar))
            ts_late = format_ts(
                t0 + dt.timedelta(minutes=5 * bar, seconds=40))

            # state evolution: momentum/imbalance/vol AR(1) regimes
            momentum = cfg.momentum_ar * momentum + float(
                r.normal(0, 0.12))
            imbalance = float(np.clip(
                cfg.imbalance_ar * imbalance
                + 0.25 * np.sign(momentum) * abs(r.normal(0, 0.35))
                + float(r.normal(0, 0.22)), -0.95, 0.95))
            vol = float(np.clip(
                cfg.vol_ar * vol + float(r.normal(0, 0.035)), 0.45, 2.4))

            o = price
            drift = (cfg.imbalance_drift * imbalance
                     + cfg.momentum_drift * momentum)
            price = max(5.0, price + drift + float(
                r.normal(0, cfg.noise * vol)))
            c = price
            h = max(o, c) + abs(float(r.normal(0, 0.22 * vol))) + 0.05
            low = min(o, c) - abs(float(r.normal(0, 0.22 * vol))) - 0.05

            # order book: imbalance visible in the size ladder
            bid_scale = 500.0 * (1.0 + 0.8 * imbalance)
            ask_scale = 500.0 * (1.0 - 0.8 * imbalance)
            deep = {"Timestamp": ts}
            for lvl in range(fc.bid_levels):
                deep[f"bids_{lvl}"] = {
                    f"bid_{lvl}": round(c - 0.01 * (lvl + 1), 2),
                    f"bid_{lvl}_size": int(max(1, r.normal(
                        bid_scale / (lvl + 1), 25))),
                }
            for lvl in range(fc.ask_levels):
                deep[f"asks_{lvl}"] = {
                    f"ask_{lvl}": round(c + 0.01 * (lvl + 1), 2),
                    f"ask_{lvl}_size": int(max(1, r.normal(
                        ask_scale / (lvl + 1), 25))),
                }
            yield TOPIC_DEEP, deep

            yield TOPIC_VOLUME, {
                "1_open": round(o, 4), "2_high": round(h, 4),
                "3_low": round(low, 4), "4_close": round(c, 4),
                "5_volume": int(r.integers(5_000, 50_000) * vol),
                "Timestamp": ts_late,
            }
            yield TOPIC_VIX, {
                "VIX": round(13.0 + 9.0 * (vol - 0.45), 2),
                "Timestamp": ts_late,
            }
            ind = fc.empty_ind_message()
            ind["Timestamp"] = ts_late
            yield TOPIC_IND, ind
            if bar == 0:  # COT positioning drifts slowly, one update a day
                for g in cot_state:
                    for k in ("long_pos", "short_pos"):
                        change = float(r.normal(0, 800))
                        cot_state[g][k] = max(
                            1_000.0, cot_state[g][k] + change)
                        cot_state[g][k.replace("_pos", "_pos_change")] = change
            cot = {"Timestamp": ts_late}
            for g, vals in cot_state.items():
                cot[g] = {f"{g}_{k}": v for k, v in vals.items()}
            yield TOPIC_COT, cot
        day += dt.timedelta(days=1)


def build_corpus(
    fc: FeatureConfig,
    cfg: SyntheticMarketConfig,
    warehouse_config: Optional[WarehouseConfig] = None,
):
    """Replay the synthetic feeds through the streaming stack: bus ->
    :class:`~fmda_tpu_torch.stream.engine.StreamEngine` -> warehouse.

    Returns (warehouse, engine_stats).  The engine steps once a trading
    day, so the join buffers stay small and the warehouse's derived views
    extend incrementally.
    """
    from fmda_tpu_torch.stream import InProcessBus, StreamEngine, Warehouse

    wh = Warehouse(fc, warehouse_config or WarehouseConfig(path=":memory:"))
    bus = InProcessBus(DEFAULT_TOPICS)
    engine = StreamEngine(bus, wh, fc)
    per_day = 5 * cfg.bars_per_day  # five feed messages per bar
    pending = 0
    for topic, msg in synthetic_session_messages(fc, cfg):
        bus.publish(topic, msg)
        pending += 1
        if pending >= per_day:
            engine.step()
            pending = 0
    engine.step()
    return wh, dict(engine.stats)


def session_timestamps(n_rows: int, start: str = "2024-01-02") -> List[str]:
    """``n_rows`` bar timestamps from ``start``, weekdays 09:30-15:55."""
    day = dt.datetime.strptime(start, "%Y-%m-%d")
    out: List[str] = []
    while len(out) < n_rows:
        if day.weekday() < 5:
            open_ = day.replace(hour=9, minute=30)
            for k in range(min(BARS_PER_DAY, n_rows - len(out))):
                ts = open_ + dt.timedelta(minutes=5 * k)
                out.append(ts.strftime("%Y-%m-%d %H:%M:%S"))
        day += dt.timedelta(days=1)
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
