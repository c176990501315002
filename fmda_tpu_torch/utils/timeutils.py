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
    """Parse a naive, exchange-local ``YYYY-MM-DD HH:MM:SS`` timestamp.

    Field slicing on the fixed layout (the staleness check parses one a
    signal, ~10x faster than ``strptime``); anything off the layout goes
    through ``strptime``, for the same errors on malformed input."""
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
