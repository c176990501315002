"""Write-ahead journal: warehouse-outage survival for the landing path,
as ``fmda_tpu.stream.journal`` defines it.

:class:`BufferedWarehouse` puts a bounded, durable write-ahead buffer in
front of a warehouse (anything with ``insert_rows``/``has_timestamp``):

- a failed ``insert_rows`` **spills** the rows to a local journal file
  (counted, never silent) and reports success to the engine: the row is
  durable on disk, the signal still fires, and serving skips the
  not-yet-landed row, counted;
- a **backfill** drain re-lands journaled rows once the store answers
  again, from the engine's step loop (idle ticks drain too) and from every
  ``insert_rows`` (journaled rows are older, so they go first);
- landing is **idempotent on timestamp**: a drained row is probed with
  ``has_timestamp`` before its insert, so a crash between the store's
  commit and the journal's compaction replays into a counted skip, never a
  duplicate row;
- the journal is **bounded**: overflow sheds the oldest rows, counted
  (``shed_rows``);
- a restart **recovers** the journal from disk; a torn trailing record
  from a kill mid-write is dropped, counted.

Each spill is flushed at once; compaction (after drains and sheds)
rewrites through ``tmp`` + ``os.replace``, so a crash mid-compact keeps the
previous journal.

Two record layouts (``fmt``, config ``[warehouse] journal_format``):

- ``jsonl`` (default): one JSON line a row, readable with ``tail -f``;
- ``binary``: each spilled batch one length-prefixed packed-column frame
  of :mod:`fmda_tpu_torch.stream.codec` (float columns as contiguous f64
  arrays, no text round trip).

Both write the reference's bytes for the same rows.  Recovery detects the
layout record by record, so a journal written under either setting (or a
mix, after a config change) always replays.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
from typing import Dict, List, Optional, Sequence

from fmda_tpu_torch.stream import codec

log = logging.getLogger("fmda_tpu_torch.stream")

#: binary journal records: 4-byte big-endian length + one codec frame
_JLEN = struct.Struct(">I")

JOURNAL_FORMATS = ("jsonl", "binary")


def _parse_journal(data: bytes) -> tuple:
    """``(rows, n_corrupt)`` from raw journal bytes, auto-detecting the
    per-record layout: a ``{`` byte starts a JSONL row line, anything
    else a length-prefixed binary frame (whose payload must carry the
    codec magic).  A record that fails to parse is dropped and counted;
    a torn length/payload (mid-write kill) ends the scan — everything
    before it already parsed."""
    rows: List[Dict[str, float]] = []
    corrupt = 0
    i, n = 0, len(data)
    while i < n:
        b = data[i]
        if b in (0x0A, 0x0D):  # blank separator
            i += 1
            continue
        if b == 0x7B:  # '{' — a JSONL row line
            end = data.find(b"\n", i)
            line = data[i:n if end < 0 else end]
            i = n if end < 0 else end + 1
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                corrupt += 1
            continue
        if i + _JLEN.size > n:
            corrupt += 1  # torn length prefix
            break
        (length,) = _JLEN.unpack_from(data, i)
        start = i + _JLEN.size
        if start + length > n:
            corrupt += 1  # torn trailing frame from a mid-write kill
            break
        payload = data[start:start + length]
        i = start + length
        try:
            rows.extend(codec.unpack_rows(codec.decode(payload)))
        except (codec.CodecError, KeyError, TypeError, ValueError):
            corrupt += 1
    return rows, corrupt


class BufferedWarehouse:
    """Warehouse proxy that journals the rows the backing store refuses.

    The whole warehouse surface passes through by delegation
    (``__getattr__``); the overrides below are the methods whose answers
    must count journaled, not yet landed rows, so that the engine's
    crash-replay dedupe stays exact across an outage.
    """

    def __init__(
        self,
        inner,
        journal_path: str,
        *,
        bound: int = 65536,
        fmt: str = "jsonl",
    ) -> None:
        if fmt not in JOURNAL_FORMATS:
            raise ValueError(
                f"journal format {fmt!r} not one of {JOURNAL_FORMATS}")
        self._inner = inner
        self._path = journal_path
        self._fmt = fmt
        self._bound = max(1, int(bound))
        # guards the pending list/set, the counters, and the file handle
        self._lock = threading.Lock()
        self._pending: List[Dict[str, float]] = []
        self._pending_ts: set = set()
        self._counters: Dict[str, int] = {
            "spilled_rows": 0,
            "backfilled_rows": 0,
            "shed_rows": 0,
            "dedupe_skipped": 0,
            "drain_failures": 0,
            "poison_rows": 0,
            "recovered_rows": 0,
            "corrupt_lines": 0,
        }
        self._fh = None
        with self._lock:
            self._recover_locked()

    # -- journal mechanics (callers hold self._lock) -------------------------

    def _recover_locked(self) -> None:
        """Load a journal left behind by a previous incarnation.
        Auto-detects the record layout byte by byte (JSONL lines start
        ``{``; binary records with a length prefix + codec magic), so a
        journal written under either ``journal_format`` — or a mix,
        after a config flip — always replays."""
        if not os.path.exists(self._path):
            return
        with open(self._path, "rb") as fh:
            data = fh.read()
        rows, corrupt = _parse_journal(data)
        # torn/corrupt records (a mid-write kill) are dropped, counted;
        # the rows re-land from bus replay through the dedupe
        self._counters["corrupt_lines"] += corrupt
        if len(rows) > self._bound:
            self._counters["shed_rows"] += len(rows) - self._bound
            rows = rows[-self._bound:]
        self._pending = rows
        self._pending_ts = {r.get("Timestamp") for r in rows}
        self._counters["recovered_rows"] += len(rows)
        if rows:
            log.warning(
                "recovered %d journaled row(s) from %s; backfill will "
                "drain them once the store answers", len(rows), self._path)
        # compact unconditionally: torn/shed lines must not survive on
        # disk to be re-parsed (and re-counted) by every incarnation
        self._rewrite_locked()

    def _handle_locked(self):
        if self._fh is None:
            self._fh = open(self._path, "ab")
        return self._fh

    def _encode_rows(self, rows: Sequence[Dict[str, float]]) -> bytes:
        """One durable journal record batch in the configured layout."""
        if self._fmt == "binary":
            payload = codec.encode(codec.pack_rows(rows))
            return _JLEN.pack(len(payload)) + payload
        return b"".join(
            (json.dumps(row) + "\n").encode("utf-8") for row in rows)

    def _rewrite_locked(self) -> None:
        """Compact the journal file to exactly the pending rows (tmp +
        atomic replace: a crash mid-compact keeps the previous file)."""
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        tmp = f"{self._path}.tmp"
        with open(tmp, "wb") as fh:
            if self._pending:
                fh.write(self._encode_rows(self._pending))
        os.replace(tmp, self._path)

    def _spill_locked(self, rows: Sequence[Dict[str, float]],
                      reason: str) -> int:
        fh = self._handle_locked()
        fh.write(self._encode_rows(rows))
        fh.flush()
        self._pending.extend(dict(r) for r in rows)
        self._pending_ts.update(r.get("Timestamp") for r in rows)
        self._counters["spilled_rows"] += len(rows)
        overflow = len(self._pending) - self._bound
        if overflow > 0:
            shed = self._pending[:overflow]
            self._pending = self._pending[overflow:]
            self._pending_ts = {
                r.get("Timestamp") for r in self._pending}
            self._counters["shed_rows"] += len(shed)
            log.warning(
                "journal overflow: shed %d oldest row(s) (bound %d)",
                len(shed), self._bound)
            self._rewrite_locked()
        log.warning(
            "warehouse append failed (%s): %d row(s) journaled to %s "
            "(%d pending)", reason, len(rows), self._path,
            len(self._pending))
        return len(rows)

    # -- the landing path ----------------------------------------------------

    def insert_rows(self, rows: Sequence[Dict[str, float]]) -> int:
        """Land rows, spilling to the journal when the store refuses.

        Returns the row count either way — from the engine's point of
        view the rows are durably accepted; whether they are in the
        store or the journal is visible in :meth:`journal_stats`, the
        ``warehouse_journal`` health check, and the logs, never in an
        exception on the landing hot path."""
        rows = list(rows)
        if not rows:
            return 0
        self.drain_journal()
        with self._lock:
            if self._pending:
                # the store is still down (drain left rows behind):
                # journal the new rows too, preserving landing order
                return self._spill_locked(rows, "store still down")
        try:
            return self._inner.insert_rows(rows)
        except (KeyError, ValueError, TypeError, IndexError):
            # programming-shaped failures (unknown columns, bad row
            # dicts) must stay loud — journaling them would retry a bug
            # forever
            raise
        except Exception as e:  # noqa: BLE001 — transport/store-shaped
            # failure (ConnectionError, sqlite3 errors, closed handles):
            # the outage the journal exists for
            with self._lock:
                return self._spill_locked(rows, repr(e))

    def drain_journal(self, max_rows: Optional[int] = None) -> int:
        """Re-land journaled rows; returns how many landed.

        Never raises: a store still down leaves the remaining rows in
        the journal (counted ``drain_failures``).  Each row is probed
        with the store's ``has_timestamp`` first, so replay after a
        crash between commit and compaction skips counted instead of
        double-landing.  A row the store rejects for a *data-shaped*
        reason (bad columns/values — rows spill before the store ever
        validated them) is dropped and counted (``poison_rows``) with
        an error log: retrying a poison row forever would wedge every
        future landing into the journal behind it.
        """
        with self._lock:
            if not self._pending:
                return 0
            batch = list(self._pending if max_rows is None
                         else self._pending[:max_rows])
        landed = 0
        skipped = 0
        poisoned = 0
        done = 0  # rows settled (landed/deduped/poisoned), in order
        failure = None
        for row in batch:
            ts = row.get("Timestamp")
            try:
                if ts is not None and self._inner.has_timestamp(ts):
                    skipped += 1
                elif self._inner.insert_rows([row]):
                    landed += 1
            except (KeyError, ValueError, TypeError, IndexError) as e:
                poisoned += 1
                log.error(
                    "journaled row %s is unlandable (%r): dropped "
                    "(poison_rows)", ts, e)
            except Exception as e:  # noqa: BLE001 — still down: this
                # row and every one after it stay in the journal, retried
                # at the next drain
                failure = e
                break
            done += 1
        with self._lock:
            self._pending = self._pending[done:]
            self._pending_ts = {
                r.get("Timestamp") for r in self._pending}
            self._counters["backfilled_rows"] += landed
            self._counters["dedupe_skipped"] += skipped
            self._counters["poison_rows"] += poisoned
            if failure is not None:
                self._counters["drain_failures"] += 1
            if done:
                self._rewrite_locked()
            remaining = len(self._pending)
        if failure is not None:
            log.warning(
                "journal drain stopped (%r): %d row(s) still pending",
                failure, remaining)
        if done:
            log.warning(
                "journal backfill: %d row(s) landed, %d deduped, %d "
                "poisoned, %d still pending", landed, skipped, poisoned,
                remaining)
        return landed

    # -- dedupe-exactness overrides ------------------------------------------

    def has_timestamp(self, ts: str) -> bool:
        """True when the row is in the store OR the journal — the
        engine's crash-replay dedupe must treat a journaled row as
        landed, or replay would spill a duplicate copy."""
        with self._lock:
            if ts in self._pending_ts:
                return True
        return bool(self._inner.has_timestamp(ts))

    def recent_timestamps(self, limit: int) -> List[str]:
        """Store tail plus the journal tail, so a restarted engine's
        landed-tick seed covers rows an outage left in the journal."""
        out = self._inner.recent_timestamps(limit)
        with self._lock:
            tail = [r.get("Timestamp") for r in self._pending[-limit:]]
        return out + [t for t in tail if t is not None]

    # -- observability -------------------------------------------------------

    def journal_stats(self) -> Dict[str, int]:
        """Counters + current backlog (the ``warehouse_journal`` health
        check and obs collector read this)."""
        with self._lock:
            return {**self._counters, "pending": len(self._pending)}

    @property
    def journal_pending(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- delegation ----------------------------------------------------------

    def __getattr__(self, name: str):
        return getattr(self._inner, name)

    def __len__(self) -> int:  # dunder lookups bypass __getattr__
        return len(self._inner)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
        self._inner.close()
