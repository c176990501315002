"""Timestamp parsing and time zones for the serving path."""

from __future__ import annotations

import datetime as _dt

TS_FORMAT = "%Y-%m-%d %H:%M:%S"


def get_timezone(name: str):
    """A tzinfo for ``name``; UTC when the zone database is missing."""
    try:
        from zoneinfo import ZoneInfo

        return ZoneInfo(name)
    except Exception:  # noqa: BLE001 — no tzdata on disk
        return _dt.timezone.utc


def parse_ts(ts: str) -> _dt.datetime:
    """Parse a naive, exchange-local ``YYYY-MM-DD HH:MM:SS`` timestamp."""
    return _dt.datetime.strptime(ts, TS_FORMAT)
