"""Time handling for the data plane and the serving path: timestamp
parsing and alignment, calendar features and market hours, as
``fmda_tpu.utils.timeutils`` defines them.

Pure functions over epoch seconds and naive exchange-local ``datetime``
objects; the streaming engine, the microstructure features, the synthetic
corpus and the acquisition layer share them.
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict

TS_FORMAT = "%Y-%m-%d %H:%M:%S"


def get_timezone(name: str):
    """A tzinfo for ``name``; UTC when the zone database is missing."""
    try:
        from zoneinfo import ZoneInfo

        return ZoneInfo(name)
    except Exception:  # noqa: BLE001 — no tzdata on disk
        return _dt.timezone.utc


def parse_ts(ts: str) -> _dt.datetime:
    """Parse a naive, exchange-local ``YYYY-MM-DD HH:MM:SS`` timestamp.

    Field slicing on the fixed layout (the engine parses one a message per
    feed, the staleness check one a signal; ~10x faster than
    ``strptime``); anything off the layout goes through ``strptime``, for
    the same errors on malformed input."""
    try:
        if (
            len(ts) == 19
            and ts[4] == "-" and ts[7] == "-" and ts[10] == " "
            and ts[13] == ":" and ts[16] == ":"
            # isdigit rejects the signs and spaces bare int() accepts, so
            # the fast path admits exactly what strptime admits
            and ts[0:4].isdigit() and ts[5:7].isdigit()
            and ts[8:10].isdigit() and ts[11:13].isdigit()
            and ts[14:16].isdigit() and ts[17:19].isdigit()
        ):
            return _dt.datetime(
                int(ts[0:4]), int(ts[5:7]), int(ts[8:10]),
                int(ts[11:13]), int(ts[14:16]), int(ts[17:19]),
            )
    except ValueError:
        pass
    return _dt.datetime.strptime(ts, TS_FORMAT)


def format_ts(dt: _dt.datetime) -> str:
    return dt.strftime(TS_FORMAT)


#: memo for :func:`to_epoch`: a tick's timestamp is converted once a feed
#: and once a join probe; bounded, so a long-running daemon cannot grow it
#: without limit
_EPOCH_CACHE: Dict[str, int] = {}
_EPOCH_CACHE_MAX = 65536


def to_epoch(ts: str) -> int:
    """Naive timestamp string -> epoch seconds (read as UTC: the engine
    needs a consistent total order and arithmetic, not a wall clock)."""
    hit = _EPOCH_CACHE.get(ts)
    if hit is not None:
        return hit
    epoch = int(parse_ts(ts).replace(tzinfo=_dt.timezone.utc).timestamp())
    if len(_EPOCH_CACHE) >= _EPOCH_CACHE_MAX:
        _EPOCH_CACHE.clear()
    _EPOCH_CACHE[ts] = epoch
    return epoch


def floor_epoch(epoch_s: int, floor_s: int) -> int:
    """Round down to a multiple of ``floor_s`` seconds."""
    return (epoch_s // floor_s) * floor_s


def day_of_week(dt: _dt.datetime) -> int:
    """ISO day of week, Monday = 1."""
    return dt.isoweekday()


def week_of_month(dt: _dt.datetime) -> int:
    """Week of the month with Sunday-start weeks and one minimal day: the
    index of the calendar row that holds ``dt``."""
    first = dt.replace(day=1)
    # the first day's offset within its (Sunday-start) week
    first_dow_sunday0 = (first.weekday() + 1) % 7
    return (dt.day + first_dow_sunday0 - 1) // 7 + 1


def session_start_flag(dt: _dt.datetime) -> int:
    """0 iff hour >= 11 AND minute >= 30, else 1: the feature's literal
    predicate (so 12:15 still gives 1)."""
    return 0 if (dt.hour >= 11 and dt.minute >= 30) else 1


def last_day_of_month(date: _dt.date) -> _dt.date:
    """The month's last day."""
    if date.month == 12:
        return date.replace(day=31)
    return date.replace(month=date.month + 1, day=1) - _dt.timedelta(days=1)


def market_hour_to_dt(current: _dt.datetime, hour_str: str) -> _dt.datetime:
    """'HH:MM' -> the day of ``current`` at that wall time."""
    t = _dt.datetime.strptime(hour_str, "%H:%M")
    return current.replace(hour=t.hour, minute=t.minute, second=0,
                           microsecond=0)


def forex_market_hours(current: _dt.datetime) -> Dict[str, _dt.datetime]:
    """The FX week: Sunday 17:00 to Friday 16:00."""
    start = current.replace(hour=17, minute=0, second=0, microsecond=0)
    start = start - _dt.timedelta(days=current.weekday() + 1)
    end = current.replace(hour=16, minute=0, second=0, microsecond=0)
    end = end + _dt.timedelta(days=-(current.weekday() - 4))
    return {"market_start": start, "market_end": end}


def stock_market_hours(
    current: _dt.datetime, market_day: Dict
) -> Dict[str, _dt.datetime]:
    """A Tradier-style calendar day as datetimes keyed
    ``{pre,post}market_{start,end}`` and ``market_{start,end}`` (the
    day's ``open`` entry is the ``market`` phase)."""
    hours: Dict[str, _dt.datetime] = {}
    for phase, key in (
        ("premarket", "premarket"),
        ("market", "open"),
        ("postmarket", "postmarket"),
    ):
        entry = market_day.get(key)
        if not entry:
            continue
        start, end = entry["start"], entry["end"]
        hours[f"{phase}_start"] = market_hour_to_dt(current, start)
        hours[f"{phase}_end"] = market_hour_to_dt(current, end)
    return hours
