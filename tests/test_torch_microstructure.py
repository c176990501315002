"""fmda_tpu_torch's microstructure features and time helpers against
``fmda_tpu``'s on the same seeded inputs: seeded books with zero and NaN
levels, candles, calendar features and market hours.  Both sides are numpy
float64 on the host, so they must be exactly equal."""

import datetime as dt

import numpy as np
import pytest

from fmda_tpu.config import FeatureConfig as JaxFeatureConfig
from fmda_tpu.ops import indicators as jax_indicators
from fmda_tpu.ops import microstructure as jax_ms
from fmda_tpu.utils import jsonutils as jax_json
from fmda_tpu.utils import timeutils as jax_time

from fmda_tpu_torch.config import FeatureConfig
from fmda_tpu_torch.ops import indicators
from fmda_tpu_torch.ops import microstructure as ms
from fmda_tpu_torch.utils import jsonutils
from fmda_tpu_torch.utils import timeutils

ROWS = 64
LEVELS = 7


def _book(seed):
    """(bids, bid_sizes, asks, ask_sizes), (ROWS, LEVELS) float64, with
    unquoted (0) and missing (NaN) levels and whole empty rows."""
    rng = np.random.default_rng(seed)
    mid = 300.0 + rng.normal(0, 5, size=(ROWS, 1))
    step = np.arange(1, LEVELS + 1) * 0.01
    bids, asks = mid - step, mid + step
    bid_sizes = rng.integers(1, 900, size=(ROWS, LEVELS)).astype(np.float64)
    ask_sizes = rng.integers(1, 900, size=(ROWS, LEVELS)).astype(np.float64)
    for arr in (bids, bid_sizes, asks, ask_sizes):
        hole = rng.random(arr.shape)
        arr[hole < 0.08] = 0.0
        arr[(hole >= 0.08) & (hole < 0.14)] = np.nan
    bids[3], bid_sizes[3] = 0.0, 0.0  # an empty bid side
    asks[5], ask_sizes[5] = np.nan, np.nan  # a missing ask side
    bid_sizes[7, 0] = ask_sizes[7, 0] = 0.0  # 0/0 at the best level
    return bids, bid_sizes, asks, ask_sizes


def _stamps(seed):
    rng = np.random.default_rng(seed)
    base = dt.datetime(2019, 12, 26, 9, 30)
    return [base + dt.timedelta(minutes=int(m))
            for m in rng.integers(0, 60 * 24 * 70, size=ROWS)]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_book_features_equal_the_reference(seed):
    bids, bid_sizes, asks, ask_sizes = _book(seed)
    for name, args in (
        ("weighted_average_distance", (bids, bid_sizes)),
        ("weighted_average_distance", (asks, ask_sizes)),
        ("volume_imbalance", (bid_sizes, ask_sizes)),
        ("delta", (bid_sizes, ask_sizes)),
        ("micro_price", (bids, bid_sizes, asks, ask_sizes)),
        ("spread", (bids, asks)),
        ("rebase_levels", (bids,)),
        ("rebase_levels", (asks,)),
    ):
        _same(getattr(ms, name)(*args), getattr(jax_ms, name)(*args))


@pytest.mark.parametrize("seed", [0, 1])
def test_deep_features_equal_the_reference(seed):
    args = (*_book(seed), _stamps(seed))
    ours, ref = ms.deep_features(*args), jax_ms.deep_features(*args)
    assert list(ours) == list(ref)
    for k in ref:
        _same(ours[k], ref[k])
    assert set(ref) == set(FeatureConfig().deep_columns())


def test_candle_and_calendar_features_equal_the_reference():
    rng = np.random.default_rng(3)
    o, c = rng.normal(100, 2, ROWS), rng.normal(100, 2, ROWS)
    h = np.maximum(o, c) + np.abs(rng.normal(0, 1, ROWS))
    low = np.minimum(o, c) - np.abs(rng.normal(0, 1, ROWS))
    h[:4] = low[:4]  # zero-size candles
    _same(ms.wick_percentage(o, h, low, c),
          jax_ms.wick_percentage(o, h, low, c))
    stamps = _stamps(4)
    ours, ref = ms.calendar_features(stamps), jax_ms.calendar_features(stamps)
    assert list(ours) == list(ref)
    for k in ref:
        _same(ours[k], ref[k])


def test_timeutils_equal_the_reference():
    stamps = _stamps(5) + [dt.datetime(2020, 12, 31, 11, 30),
                           dt.datetime(2020, 2, 29, 12, 15),
                           dt.datetime(2021, 8, 1, 9, 30)]
    for t in stamps:
        s = timeutils.format_ts(t)
        assert s == jax_time.format_ts(t)
        assert timeutils.parse_ts(s) == jax_time.parse_ts(s)
        assert timeutils.to_epoch(s) == jax_time.to_epoch(s)
        for floor in (60, 300, 3600):
            e = timeutils.to_epoch(s)
            assert (timeutils.floor_epoch(e, floor)
                    == jax_time.floor_epoch(e, floor))
        for fn in ("day_of_week", "week_of_month", "session_start_flag",
                   "forex_market_hours"):
            assert getattr(timeutils, fn)(t) == getattr(jax_time, fn)(t)
        assert (timeutils.last_day_of_month(t.date())
                == jax_time.last_day_of_month(t.date()))
        for hour in ("09:30", "16:00", "04:05"):
            assert (timeutils.market_hour_to_dt(t, hour)
                    == jax_time.market_hour_to_dt(t, hour))
    day = {"date": "2020-02-07", "status": "open",
           "open": {"start": "09:30", "end": "16:00"},
           "premarket": {"start": "04:00", "end": "09:30"},
           "postmarket": None}
    now = dt.datetime(2020, 2, 7, 10, 1, 2)
    assert (timeutils.stock_market_hours(now, day)
            == jax_time.stock_market_hours(now, day))
    assert timeutils.TS_FORMAT == jax_time.TS_FORMAT
    # off the fast path's layout: the same result or the same error
    for odd in ("2020-02-07 9:30:00", "2020-02-07T09:30:00",
                "+020-02-07 09:30:00", "2020-02-30 09:30:00"):
        outcomes = []
        for fn in (timeutils.parse_ts, jax_time.parse_ts):
            try:
                outcomes.append(fn(odd))
            except ValueError as e:
                outcomes.append(type(e))
        assert outcomes[0] == outcomes[1]
    with pytest.raises(ValueError):
        timeutils.parse_ts("2020-02-07T09:30:00")


def test_to_epoch_cache_stays_bounded(monkeypatch):
    monkeypatch.setattr(timeutils, "_EPOCH_CACHE_MAX", 4)
    monkeypatch.setattr(timeutils, "_EPOCH_CACHE", {})
    for minute in range(10):
        s = f"2020-02-07 09:{minute:02d}:00"
        assert timeutils.to_epoch(s) == jax_time.to_epoch(s)
        assert len(timeutils._EPOCH_CACHE) <= 4


def test_jsonutils_equal_the_reference():
    payload = {"1. open": "334.02", "5. volume": "90211",
               "nested": [{"2. high": "1e3", "x": "n/a"}, ("7", 3.5)]}
    for fn, args in ((
            "change_keys", (payload, ". ", "_")),
            ("values_to_numbers", (payload,)), ("to_number", ("12",)),
            ("to_number", ("1.5",)), ("to_number", ("abc",))):
        assert getattr(jsonutils, fn)(*args) == getattr(jax_json, fn)(*args)


@pytest.mark.parametrize("chunk", [7, 25, 200])
def test_landed_row_transform_equals_the_reference(chunk):
    """The chunked mapper from raw landed columns to the joined view, over
    seeded table rows in chunks, both packages the same bits."""
    kw = dict(bid_levels=2, ask_levels=2, event_list=("Core CPI",),
              get_cot=False)
    fc, jfc = FeatureConfig(**kw), JaxFeatureConfig(**kw)
    columns = fc.table_columns()
    rng = np.random.default_rng(6)
    raw = np.cumsum(rng.normal(size=(200, len(columns))), axis=0)
    ours = indicators.landed_row_transform(columns, fc)
    ref = jax_indicators.landed_row_transform(columns, jfc)
    for lo in range(0, len(raw), chunk):
        _same(ours(raw[lo:lo + chunk]), ref(raw[lo:lo + chunk]))
