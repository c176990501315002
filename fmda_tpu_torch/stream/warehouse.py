"""Feature warehouse: the SQLite table ``fmda_tpu``'s ``Warehouse`` writes,
and its derived-feature views.

The DDL is generated from the feature config exactly as the JAX package
generates it, so both packages open the same file: one writes (ingest),
the other serves.  The derived views (moving averages, Bollinger,
stochastic, ATR, price change, the movement targets) are computed by
:mod:`fmda_tpu_torch.ops.indicators` over *timestamp order* and cached
until new rows land.  Reads speak 1-based row *positions* (dense ordinals
in ID order), which stay dense when autoincrement IDs have holes.
"""

from __future__ import annotations

import logging
import sqlite3
import threading
import time
from typing import (
    Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple,
)

import numpy as np

from fmda_tpu_torch.config import FeatureConfig, TARGET_COLUMNS, WarehouseConfig
from fmda_tpu_torch.ops.indicators import build_targets, derived_features

log = logging.getLogger("fmda_tpu_torch.stream")


def _quote(col: str) -> str:
    return f'"{col}"'


class Warehouse:
    """SQLite-backed joined feature table + in-memory derived views."""

    def __init__(
        self,
        features: FeatureConfig,
        config: Optional[WarehouseConfig] = None,
    ) -> None:
        self.features = features
        self.config = config or WarehouseConfig()
        if self.config.backend != "sqlite":
            raise NotImplementedError(
                f"backend {self.config.backend!r}; only 'sqlite' is ported")
        self.table = self.config.table_name
        self._columns: Tuple[str, ...] = self.features.table_columns()
        self._conn = sqlite3.connect(self.config.path, check_same_thread=False)
        # guards the connection and the derived caches (re-entrant: the
        # refresh calls __len__)
        self._lock = threading.RLock()
        self._create_table()
        # caches live in timestamp-sorted position space: _sorted_idx maps
        # sorted position -> row index, _rank row index -> sorted position
        self._cache_rows = 0
        self._matrix = np.empty((0, len(self._columns)), np.float64)
        self._ids = np.empty(0, np.int64)
        self._ts: List[str] = []
        self._sorted_idx = np.empty(0, np.int64)
        self._rank = np.empty(0, np.int64)
        self._derived: Dict[str, np.ndarray] = {
            c: np.empty(0, np.float64) for c in self.features.derived_columns()
        }
        self._targets = np.empty((0, len(TARGET_COLUMNS)), np.float64)
        # instruments of bind_metrics; None: not instrumented
        self._obs_write_hist = None
        self._obs_query_hist = None
        self._obs_rows_counter = None

    def bind_metrics(self, registry) -> None:
        """Report write and query latency and the rows landed through a
        :class:`~fmda_tpu_torch.obs.registry.MetricsRegistry`."""
        self._obs_write_hist = registry.histogram("warehouse_write_seconds")
        self._obs_query_hist = registry.histogram("warehouse_query_seconds")
        self._obs_rows_counter = registry.counter(
            "warehouse_rows_written_total")

    def healthy(self) -> bool:
        """Whether the store still takes writes: take (and release) a
        write lock.  False once the connection is closed or the file went
        read-only."""
        try:
            with self._lock:
                self._conn.execute("BEGIN IMMEDIATE")
                self._conn.execute("ROLLBACK")
            return True
        except Exception:  # noqa: BLE001 — any failure is the answer
            return False

    def _create_table(self) -> None:
        cols = ", ".join(f"{_quote(c)} REAL" for c in self._columns)
        ddl = (
            f"CREATE TABLE IF NOT EXISTS {self.table} "
            f"(ID INTEGER PRIMARY KEY AUTOINCREMENT, Timestamp TEXT, {cols})"
        )
        with self._lock:
            self._conn.execute(ddl)
            self._conn.execute(
                f"CREATE INDEX IF NOT EXISTS idx_{self.table}_ts "
                f"ON {self.table}(Timestamp)"
            )
            self._conn.commit()

    # -- writes --------------------------------------------------------------

    def insert_rows(self, rows: Sequence[Dict[str, float]]) -> int:
        """Append joined feature rows; unknown keys are rejected, missing
        keys stored as 0.  Each row dict carries 'Timestamp'."""
        if not rows:
            return 0
        cols = self._columns
        placeholders = ", ".join(["?"] * (1 + len(cols)))
        col_list = "Timestamp, " + ", ".join(_quote(c) for c in cols)
        known = frozenset(cols) | {"Timestamp"}
        values = []
        for row in rows:
            if not known.issuperset(row.keys()):
                raise KeyError(
                    f"unknown feature columns: {sorted(set(row) - known)}")
            get = row.get
            values.append(
                [get("Timestamp")] + [float(get(c) or 0.0) for c in cols])
        t0 = time.perf_counter() if self._obs_write_hist is not None else 0.0
        with self._lock:
            self._conn.executemany(
                f"INSERT INTO {self.table} ({col_list}) VALUES ({placeholders})",
                values,
            )
            self._conn.commit()
        if self._obs_write_hist is not None:
            self._obs_write_hist.observe(time.perf_counter() - t0)
            self._obs_rows_counter.inc(len(values))
        return len(values)

    # -- raw reads -----------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            (n,) = self._conn.execute(
                f"SELECT COUNT(ID) FROM {self.table}").fetchone()
        return int(n)

    def timestamps(self) -> List[str]:
        """Every row's timestamp, in row order."""
        with self._lock:
            rows = self._conn.execute(
                f"SELECT Timestamp FROM {self.table} ORDER BY ID"
            ).fetchall()
        return [r[0] for r in rows]

    def timestamps_after(self, position: int) -> List[Tuple[int, str]]:
        """``(position, timestamp)`` of the rows past ``position``, in row
        order: the tail-follow query of a serving daemon."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT pos, Timestamp FROM (SELECT ROW_NUMBER() OVER "
                f"(ORDER BY ID) AS pos, Timestamp FROM {self.table}) "
                "WHERE pos > ? ORDER BY pos",
                (max(0, int(position)),),
            ).fetchall()
        return [(int(r[0]), r[1]) for r in rows]

    def recent_timestamps(self, limit: int) -> List[str]:
        """Timestamps of the newest ``limit`` rows, newest first: the
        engine seeds its landed-tick dedupe set from them."""
        with self._lock:
            rows = self._conn.execute(
                f"SELECT Timestamp FROM {self.table} ORDER BY ID DESC "
                "LIMIT ?",
                (int(limit),),
            ).fetchall()
        return [r[0] for r in rows]

    def raw_rows_for(self, ts_list: Sequence[str]) -> Dict[str, Tuple]:
        """The raw landed values keyed by timestamp (the newest row of a
        timestamp), straight from SQL: no derived views, no caches."""
        ts_list = list(ts_list)
        if not ts_list:
            return {}
        cols = ", ".join(_quote(c) for c in self._columns)
        qmarks = ", ".join("?" * len(ts_list))
        with self._lock:
            rows = self._conn.execute(
                f"SELECT Timestamp, {cols} FROM {self.table} "
                f"WHERE Timestamp IN ({qmarks}) ORDER BY ID",
                ts_list,
            ).fetchall()
        return {r[0]: tuple(r[1:]) for r in rows}

    def has_timestamp(self, ts: str) -> bool:
        """Whether a row holds ``ts``: one point lookup on the index (the
        engine's dedupe needs membership, not the position)."""
        with self._lock:
            row = self._conn.execute(
                f"SELECT 1 FROM {self.table} WHERE Timestamp = ? LIMIT 1",
                (ts,),
            ).fetchone()
        return row is not None

    def id_for_timestamp(self, ts: str) -> Optional[int]:
        """1-based row position of a timestamp (the newest row holding it),
        in the space :meth:`fetch` indexes."""
        with self._lock:
            row = self._conn.execute(
                f"SELECT ID FROM {self.table} WHERE Timestamp = ? "
                "ORDER BY ID DESC LIMIT 1",
                (ts,),
            ).fetchone()
            if row is None:
                return None
            (pos,) = self._conn.execute(
                f"SELECT COUNT(*) FROM {self.table} WHERE ID <= ?",
                (int(row[0]),),
            ).fetchone()
            return int(pos)

    def ids_for_timestamps(
        self, ts_list: Sequence[str]
    ) -> List[Optional[int]]:
        """Batched :meth:`id_for_timestamp`: the positions of a whole
        flush of signal timestamps from ONE indexed query plus a sorted
        lookup in the row-ID cache.  Unknown timestamps map to None."""
        ts_list = list(ts_list)
        if not ts_list:
            return []
        qmarks = ", ".join("?" * len(ts_list))
        with self._lock:
            # the refresh makes _ids cover every committed row the query
            # can return (signals fire after commit)
            self._refresh_derived()
            rows = self._conn.execute(
                f"SELECT Timestamp, MAX(ID) FROM {self.table} "
                f"WHERE Timestamp IN ({qmarks}) GROUP BY Timestamp",
                ts_list,
            ).fetchall()
            by_ts = {r[0]: int(r[1]) for r in rows}
            # _ids is strictly increasing (insertion order), so an ID's
            # rank — its 1-based position, the space fetch() speaks — is
            # one searchsorted away
            return [
                int(np.searchsorted(self._ids, by_ts[ts])) + 1
                if ts in by_ts else None
                for ts in ts_list
            ]

    def fetch_windows(
        self, row_ids: Sequence[int], window: int
    ) -> np.ndarray:
        """Batched trailing-window gather: ``(B, window, F)`` feature
        windows ending at each 1-based position of ``row_ids``, from one
        cache refresh and one gather — bit-identical to stacking
        :meth:`fetch` windows (the same gather, the same NaN policy).
        Raises IndexError when a window would reach before row 1 or past
        the newest row."""
        t0 = time.perf_counter() if self._obs_query_hist is not None else 0.0
        try:
            if window < 1:
                raise ValueError(f"window must be >= 1, got {window}")
            pos = np.asarray(list(row_ids), np.int64)
            if pos.size == 0:
                return np.zeros((0, window, len(self.x_fields)), np.float32)
            flat = (pos[:, None]
                    - np.arange(window - 1, -1, -1)[None, :]).reshape(-1)
            return self._fetch(flat).reshape(len(pos), window, -1)
        finally:
            if self._obs_query_hist is not None:
                self._obs_query_hist.observe(time.perf_counter() - t0)

    def iter_row_chunks(
        self,
        start_ts: Optional[str] = None,
        end_ts: Optional[str] = None,
        chunk: int = 4096,
        *,
        follow: int = 0,
        poll_wait: Optional[Callable[[], Any]] = None,
    ) -> Iterator[Tuple[List[str], np.ndarray]]:
        """Bulk history reader: the landed table in ID order as
        ``(timestamps, (B, F) float64 matrix)`` chunks, one keyset-paged
        range query a chunk.

        Values are the raw landed columns, the bits
        ``fmda_tpu``'s warehouse hands back for the same rows.
        ``start_ts``/``end_ts`` bound the scan by the timestamp column
        (inclusive).  The lock is held per page, not across the scan, so
        rows keep landing while it reads; rows landing behind the cursor
        are picked up (a reader, not a snapshot).

        ``follow > 0`` makes it a bounded tail-follow (the continuous
        trainer's feed): a short page no longer ends the scan; on an
        empty page the reader calls ``poll_wait()`` (default: a 50 ms
        sleep) and issues the same keyset query again, and only
        ``follow`` consecutive empty polls end it.  The cursor survives
        the waits: rows landed between polls resume right after the last
        yielded ID, none read twice or skipped.  ``follow=0`` is the
        plain scan."""
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        cols = ", ".join(_quote(c) for c in self._columns)
        conds = ["ID > ?"]
        bounds: List[Any] = []
        if start_ts is not None:
            conds.append("Timestamp >= ?")
            bounds.append(start_ts)
        if end_ts is not None:
            conds.append("Timestamp <= ?")
            bounds.append(end_ts)
        where = " AND ".join(conds)
        last_id = 0
        idle = 0
        while True:
            with self._lock:
                rows = self._conn.execute(
                    f"SELECT ID, Timestamp, {cols} FROM {self.table} "
                    f"WHERE {where} ORDER BY ID LIMIT ?",
                    (last_id, *bounds, int(chunk)),
                ).fetchall()
            if not rows:
                if follow <= 0 or idle >= int(follow):
                    return
                idle += 1
                if poll_wait is not None:
                    poll_wait()
                else:
                    time.sleep(0.05)
                continue
            idle = 0
            last_id = int(rows[-1][0])
            matrix = np.asarray(
                [r[2:] for r in rows], np.float64
            ).reshape(len(rows), len(self._columns))
            yield [r[1] or "" for r in rows], matrix
            if len(rows) < chunk and follow <= 0:
                return

    def joined_row_transform(self):
        """A fresh stateful mapper from :meth:`iter_row_chunks`' raw
        chunks to the joined ``x_fields`` rows :meth:`fetch` serves (pass
        the bound method as a factory wherever a replay of this warehouse
        feeds a model sized to the joined view)."""
        from fmda_tpu_torch.ops.indicators import landed_row_transform

        return landed_row_transform(self._columns, self.features)

    def _fetch_rows_after(
        self, row_id: int
    ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
        cols = ", ".join(_quote(c) for c in self._columns)
        with self._lock:
            rows = self._conn.execute(
                f"SELECT ID, Timestamp, {cols} FROM {self.table} "
                "WHERE ID > ? ORDER BY ID",
                (row_id,),
            ).fetchall()
        ids = np.asarray([r[0] for r in rows], np.int64)
        matrix = np.asarray(
            [r[2:] for r in rows], np.float64
        ).reshape(len(rows), len(self._columns))
        return ids, matrix, [r[1] or "" for r in rows]

    # -- derived views -------------------------------------------------------

    def _refresh_derived(self) -> None:
        """Extend the derived-view caches over newly landed rows.

        Views follow timestamp order.  In-order arrivals recompute only the
        tail: trailing views need ``max_lookback - 1`` context rows, and the
        targets of the last ``max_lead`` cached rows can still change as
        LEAD rows arrive.  An out-of-order arrival recomputes everything
        over the sorted view.  Caller holds ``self._lock``."""
        n = len(self)
        old_n = self._cache_rows
        if n == old_n:
            return
        if n < old_n:  # table replaced or truncated: full rebuild
            old_n = 0
            self._matrix = self._matrix[:0]
            self._ids = self._ids[:0]
            self._ts = []
            self._sorted_idx = self._sorted_idx[:0]
            self._rank = self._rank[:0]
        last_id = int(self._ids[-1]) if len(self._ids) else 0
        new_ids, new_rows, new_ts = self._fetch_rows_after(last_id)
        self._matrix = np.concatenate([self._matrix, new_rows])
        self._ids = np.concatenate([self._ids, new_ids])
        self._ts.extend(new_ts)

        in_order = old_n == 0 or (
            len(self._sorted_idx)
            and min(new_ts) >= self._ts[self._sorted_idx[-1]]
        )
        new_order = old_n + np.lexsort(
            (np.arange(len(new_ts)), np.asarray(new_ts))
        )
        if in_order:
            recompute_start = max(0, old_n - self.features.max_lead)
            self._sorted_idx = np.concatenate([self._sorted_idx, new_order])
            new_rank = np.empty(len(new_ts), np.int64)
            new_rank[new_order - old_n] = np.arange(old_n, n)
            self._rank = np.concatenate([self._rank, new_rank])
        else:
            log.warning(
                "out-of-timestamp-order row landed (new min ts %s < cached "
                "max ts %s): full derived-view recompute over sorted order",
                min(new_ts), self._ts[self._sorted_idx[-1]],
            )
            recompute_start = 0
            self._sorted_idx = np.lexsort(
                (np.arange(n), np.asarray(self._ts))
            )
            self._rank = np.empty(n, np.int64)
            self._rank[self._sorted_idx] = np.arange(n)

        fc = self.features
        context_start = max(0, recompute_start - (fc.max_lookback - 1))
        rows = self._sorted_idx[context_start:n]
        table = {c: self._matrix[rows, i] for i, c in enumerate(self._columns)}
        derived = derived_features(table, fc)
        offset = recompute_start - context_start
        for c in self.features.derived_columns():
            self._derived[c] = np.concatenate(
                [self._derived[c][:recompute_start], derived[c][offset:]]
            )
        if self._has_ohlc():
            targets = build_targets(table, fc)
            self._targets = np.concatenate(
                [self._targets[:recompute_start], targets[offset:]]
            )
        self._cache_rows = n

    def _has_ohlc(self) -> bool:
        return {"2_high", "3_low", "4_close"} <= set(self._columns)

    # -- FeatureSource protocol ----------------------------------------------

    @property
    def x_fields(self) -> Tuple[str, ...]:
        """Joined column set: table columns, then derived views."""
        return self._columns + self.features.derived_columns()

    def _positions(self, ids: Sequence[int]) -> np.ndarray:
        """1-based row positions -> 0-based cache indices.  Caller holds the
        lock with refreshed caches."""
        idx = np.asarray(list(ids), np.int64) - 1
        n = self._cache_rows
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise IndexError(f"row positions out of range 1..{n}")
        return idx

    def fetch(self, ids: Sequence[int]) -> np.ndarray:
        """Feature rows (1-based positions), NaN -> 0, float32."""
        t0 = time.perf_counter() if self._obs_query_hist is not None else 0.0
        try:
            return self._fetch(ids)
        finally:
            if self._obs_query_hist is not None:
                self._obs_query_hist.observe(time.perf_counter() - t0)

    def _fetch(self, ids: Sequence[int]) -> np.ndarray:
        with self._lock:
            self._refresh_derived()
            idx = self._positions(ids)
            derived_cols = self.features.derived_columns()
            out = np.empty((len(idx), len(self.x_fields)), np.float64)
            out[:, : len(self._columns)] = self._matrix[idx]
            pos = self._rank[idx]
            for j, c in enumerate(derived_cols):
                out[:, len(self._columns) + j] = self._derived[c][pos]
        return np.nan_to_num(out, nan=0.0).astype(np.float32)

    def fetch_targets(self, ids: Sequence[int]) -> np.ndarray:
        if not self._has_ohlc():
            raise ValueError(
                "movement targets need the OHLCV feed: enable "
                "FeatureConfig.get_stock_volume")
        with self._lock:
            self._refresh_derived()
            idx = self._positions(ids)
            return np.asarray(self._targets[self._rank[idx]], np.float32)

    def close(self) -> None:
        self._conn.close()
