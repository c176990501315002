"""MariaDB/MySQL warehouse: the schema's SQL generated from the feature
config, and a client that runs it, as ``fmda_tpu.stream.mysql_warehouse``
defines them.

The embedded SQLite warehouse (:mod:`fmda_tpu_torch.stream.warehouse`) is
the default; this module is its MariaDB counterpart: the joined table's
DDL, every windowed-indicator VIEW, the target VIEW and the canonical
X-query (``join_statement``), each generated from the
:class:`~fmda_tpu_torch.config.FeatureConfig`, with the reference
schema's column names and window frames (the 15-row ``14 PRECEDING``
frames of the stochastic oscillator and ATR, the ``LEAD`` 8/15 targets).

The codegen is pure string construction, testable without a server;
:class:`MySQLWarehouse` executes it through ``mysql.connector``, which is
imported when one is built.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from fmda_tpu_torch.config import (
    COT_GROUPS,
    COT_VALUES,
    EVENT_VALUES,
    FeatureConfig,
    VOLUME_COLUMNS,
    WarehouseConfig,
)


# ---------------------------------------------------------------------------
# DDL codegen
# ---------------------------------------------------------------------------


def create_table_sql(fc: FeatureConfig, table: str) -> str:
    """Joined-table DDL with the reference's MySQL column types."""
    cols: List[str] = []
    for i in range(fc.bid_levels):
        cols.append(f"bid_{i}_size MEDIUMINT NOT NULL")
    for i in range(1, fc.bid_levels):
        cols.append(f"bid_{i} FLOAT(6,2) NOT NULL")
    for i in range(fc.ask_levels):
        cols.append(f"ask_{i}_size MEDIUMINT NOT NULL")
    for i in range(1, fc.ask_levels):
        cols.append(f"ask_{i} FLOAT(6,2) NOT NULL")
    cols += [
        "bids_ord_WA FLOAT(6,4)",
        "asks_ord_WA FLOAT(6,4) NOT NULL",
        "vol_imbalance FLOAT(7,4) NOT NULL",
        "delta MEDIUMINT NOT NULL",
        "micro_price FLOAT(7,2) NOT NULL",
        "spread FLOAT(7,4) NOT NULL",
        "session_start TINYINT NOT NULL",
    ]
    cols += [f"day_{d} TINYINT NOT NULL" for d in range(1, 5)]
    cols += [f"week_{w} TINYINT NOT NULL" for w in range(1, 5)]
    if fc.get_vix:
        cols.append("VIX FLOAT(5,2) NOT NULL")
    if fc.get_stock_volume:
        for c in VOLUME_COLUMNS:
            kind = (
                "INT NOT NULL" if c == "5_volume"
                else "FLOAT(6,4) NOT NULL" if c == "wick_prct"
                else "FLOAT(6,2) NOT NULL"
            )
            cols.append(f"`{c}` {kind}")
    if fc.get_cot:
        for g in COT_GROUPS:
            for v in COT_VALUES:
                kind = (
                    "MEDIUMINT NOT NULL" if v.endswith("pos")
                    else "FLOAT(6,1) NOT NULL" if v.endswith("change")
                    else "FLOAT(4,1) NOT NULL"
                )
                cols.append(f"{g}_{v} {kind}")
    for event in fc.event_list_repl:
        for value in EVENT_VALUES:
            cols.append(f"{event}_{value} FLOAT(8,3) NOT NULL")
    body = ", ".join(cols)
    return (
        f"CREATE TABLE IF NOT EXISTS {table} "
        f"(ID MEDIUMINT KEY AUTO_INCREMENT, Timestamp DATETIME, {body});"
    )


# ---------------------------------------------------------------------------
# View codegen
# ---------------------------------------------------------------------------


def _trailing_frame(preceding: int) -> str:
    return f"ROWS BETWEEN {preceding} PRECEDING AND CURRENT ROW"


def ma_view_sql(
    view: str, column: str, periods: Sequence[int], table: str, prefix: str
) -> str:
    """Moving-average view over a trailing ``period``-row frame."""
    selects = ", ".join(
        f"AVG(`{column}`) OVER (ORDER BY Timestamp {_trailing_frame(p - 1)}) "
        f"AS {prefix}{p}"
        for p in periods
    )
    names = ", ".join(f"{prefix}{p}" for p in periods)
    return (
        f"CREATE OR REPLACE VIEW {view}(Timestamp, {names}) AS "
        f"SELECT Timestamp, {selects} FROM {table};"
    )


def bollinger_view_sql(fc: FeatureConfig, table: str) -> str:
    n = fc.bollinger_std
    frame = _trailing_frame(fc.bollinger_period - 1)
    return (
        "CREATE OR REPLACE VIEW bollinger_bands"
        "(Timestamp, upper_BB_dist, lower_BB_dist) AS SELECT Timestamp, "
        f"(BB_avg + {n} * BB_std) - `4_close` AS upper_BB_dist, "
        f"`4_close` - (BB_avg - {n} * BB_std) AS lower_BB_dist "
        "FROM (SELECT Timestamp, `4_close`, "
        f"STD(`4_close`) OVER (ORDER BY Timestamp {frame}) AS BB_std, "
        f"AVG(`4_close`) OVER (ORDER BY Timestamp {frame}) AS BB_avg "
        f"FROM {table}) AS S;"
    )


def stochastic_view_sql(fc: FeatureConfig, table: str) -> str:
    frame = _trailing_frame(fc.stoch_preceding)
    return (
        "CREATE OR REPLACE VIEW stochastic_oscillator(Timestamp, stoch) AS "
        "SELECT Timestamp, ((`4_close` - mn) / (mx - mn)) AS stoch "
        "FROM (SELECT Timestamp, `4_close`, "
        f"MIN(`4_close`) OVER (ORDER BY Timestamp {frame}) AS mn, "
        f"MAX(`4_close`) OVER (ORDER BY Timestamp {frame}) AS mx "
        f"FROM {table}) AS S;"
    )


def price_change_view_sql(table: str) -> str:
    return (
        "CREATE OR REPLACE VIEW price_change(Timestamp, price_change) AS "
        "SELECT Timestamp, (`4_close` - LAG(`4_close`, 1) "
        f"OVER (ORDER BY Timestamp)) AS price_change FROM {table};"
    )


def atr_view_sql(fc: FeatureConfig, table: str) -> str:
    frame = _trailing_frame(fc.atr_preceding)
    return (
        "CREATE OR REPLACE VIEW ATR(Timestamp, ATR) AS SELECT Timestamp, "
        f"(AVG(`2_high` - `3_low`) OVER (ORDER BY Timestamp {frame})) AS ATR "
        f"FROM {table};"
    )


def target_view_sql(fc: FeatureConfig, table: str) -> str:
    n1, n2 = fc.target_n1, fc.target_n2
    l1, l2 = fc.target_lead1, fc.target_lead2
    return (
        "CREATE OR REPLACE VIEW target(Timestamp, ID, p0_close, "
        "p_lead1_close, p_lead2_close, ATR, up1, up2, down1, down2) AS "
        "SELECT Timestamp, ID, p0_close, p_lead1_close, p_lead2_close, ATR, "
        f"CASE WHEN p_lead1_close >= (p0_close + ({n1} * ATR)) THEN 1 ELSE 0 END AS up1, "
        f"CASE WHEN p_lead2_close >= (p0_close + ({n2} * ATR)) THEN 1 ELSE 0 END AS up2, "
        f"CASE WHEN p_lead1_close <= (p0_close - ({n1} * ATR)) THEN 1 ELSE 0 END AS down1, "
        f"CASE WHEN p_lead2_close <= (p0_close - ({n2} * ATR)) THEN 1 ELSE 0 END AS down2 "
        "FROM (SELECT sd.Timestamp, sd.ID, sd.`4_close` AS p0_close, ATR, "
        f"LEAD(sd.`4_close`, {l1}) OVER (ORDER BY Timestamp) AS p_lead1_close, "
        f"LEAD(sd.`4_close`, {l2}) OVER (ORDER BY Timestamp) AS p_lead2_close "
        f"FROM {table} sd JOIN ATR ON sd.Timestamp = ATR.Timestamp) AS T;"
    )


def all_view_sql(fc: FeatureConfig, table: str) -> List[str]:
    """Every view statement the schema needs, in dependency order."""
    out: List[str] = []
    has_ohlc = bool(fc.get_stock_volume)
    if has_ohlc and fc.volume_ma_periods:
        out.append(ma_view_sql("vol_MA", "5_volume", fc.volume_ma_periods,
                               table, "vol_MA"))
    if has_ohlc and fc.price_ma_periods:
        out.append(ma_view_sql("price_MA", "4_close", fc.price_ma_periods,
                               table, "price_MA"))
    if fc.delta_ma_periods:
        out.append(ma_view_sql("delta_MA", "delta", fc.delta_ma_periods,
                               table, "delta_MA"))
    if has_ohlc and fc.bollinger_period and fc.bollinger_std:
        out.append(bollinger_view_sql(fc, table))
    if has_ohlc and fc.stochastic_oscillator:
        out.append(stochastic_view_sql(fc, table))
    if has_ohlc:
        out.append(price_change_view_sql(table))
        out.append(atr_view_sql(fc, table))
        out.append(target_view_sql(fc, table))
    return out


def join_select_fields(fc: FeatureConfig) -> List[str]:
    """Select expressions of the canonical X-query, one per
    ``fc.x_fields()`` entry, in the same order."""
    has_ohlc = bool(fc.get_stock_volume)
    selects = [f"sd.`{c}`" for c in fc.table_columns()]
    if has_ohlc and fc.bollinger_period and fc.bollinger_std:
        selects += ["bb.upper_BB_dist", "bb.lower_BB_dist"]
    if has_ohlc and fc.volume_ma_periods:
        selects += [f"vol.vol_MA{p}" for p in fc.volume_ma_periods]
    if has_ohlc and fc.price_ma_periods:
        selects += [f"p.price_MA{p}" for p in fc.price_ma_periods]
    if fc.delta_ma_periods:
        selects += [f"d.delta_MA{p}" for p in fc.delta_ma_periods]
    if has_ohlc and fc.stochastic_oscillator:
        selects += ["so.stoch"]
    if has_ohlc:
        selects += ["ATR.ATR", "pc.price_change"]
    return selects


def join_from_clause(fc: FeatureConfig, table: str) -> str:
    """FROM + JOIN clause of the canonical X-query (no trailing ';')."""
    has_ohlc = bool(fc.get_stock_volume)
    joins = []
    if has_ohlc and fc.bollinger_period and fc.bollinger_std:
        joins.append("JOIN bollinger_bands bb ON sd.Timestamp = bb.Timestamp")
    if has_ohlc and fc.volume_ma_periods:
        joins.append("JOIN vol_MA vol ON sd.Timestamp = vol.Timestamp")
    if has_ohlc and fc.price_ma_periods:
        joins.append("JOIN price_MA p ON sd.Timestamp = p.Timestamp")
    if fc.delta_ma_periods:
        joins.append("JOIN delta_MA d ON sd.Timestamp = d.Timestamp")
    if has_ohlc and fc.stochastic_oscillator:
        joins.append(
            "JOIN stochastic_oscillator so ON sd.Timestamp = so.Timestamp")
    if has_ohlc:
        joins.append("JOIN ATR ON sd.Timestamp = ATR.Timestamp")
        joins.append("JOIN price_change pc ON sd.Timestamp = pc.Timestamp")
    return f"FROM {table} sd " + " ".join(joins)


def join_statement_sql(fc: FeatureConfig, table: str) -> str:
    """The canonical X-query selecting every table and view column,
    generated from the config."""
    return (
        "SELECT " + ", ".join(join_select_fields(fc)) + " "
        + join_from_clause(fc, table) + ";"
    )


def insert_sql(fc: FeatureConfig, table: str) -> str:
    """Parameterized landing INSERT over the config-generated column set
    (the write half of the config→schema property: the same
    ``table_columns()`` order the DDL and the embedded warehouse use, so
    the engine can land through either backend)."""
    cols = fc.table_columns()
    col_list = "Timestamp, " + ", ".join(f"`{c}`" for c in cols)
    placeholders = ", ".join(["%s"] * (1 + len(cols)))
    return f"INSERT INTO {table} ({col_list}) VALUES ({placeholders});"


# ---------------------------------------------------------------------------
# Gated client
# ---------------------------------------------------------------------------


class MySQLWarehouse:
    """MariaDB-backed warehouse implementing the FeatureSource protocol.

    Requires ``mysql.connector`` (not bundled); the constructor raises a
    clear error otherwise.  Uses the codegen above for bootstrap, and the
    join statement with ``IFNULL(...,0)`` for fetches
   .
    """

    def __init__(
        self, features: FeatureConfig, config: Optional[WarehouseConfig] = None
    ) -> None:
        try:
            import mysql.connector  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "MySQLWarehouse needs the 'mysql-connector-python' package; "
                "use the embedded SQLite Warehouse otherwise"
            ) from e
        self.features = features
        self.config = config or WarehouseConfig(backend="mysql")
        self._cnx = mysql.connector.connect(
            host=self.config.hostname,
            port=self.config.port,
            user=self.config.user,
            password=self.config.password,
        )
        cur = self._cnx.cursor()
        cur.execute(
            f"CREATE DATABASE IF NOT EXISTS {self.config.database_name}")
        cur.execute(f"USE {self.config.database_name}")
        cur.execute(create_table_sql(features, self.config.table_name))
        for stmt in all_view_sql(features, self.config.table_name):
            cur.execute(stmt)
        self._cursor = cur

    @property
    def x_fields(self) -> Tuple[str, ...]:
        return self.features.x_fields()

    def __len__(self) -> int:
        self._cursor.execute(
            f"SELECT COUNT(ID) FROM {self.config.table_name}")
        return int(self._cursor.fetchone()[0])

    def insert_rows(self, rows: Sequence[dict]) -> int:
        """Land joined feature rows — same contract as the embedded
        Warehouse (unknown keys rejected, missing keys stored as 0), so
        the engine and the write-ahead journal front either backend."""
        if not rows:
            return 0
        cols = self.features.table_columns()
        known = frozenset(cols) | {"Timestamp"}
        values = []
        for row in rows:
            if not known.issuperset(row.keys()):
                unknown = sorted(set(row) - known)
                raise KeyError(f"unknown feature columns: {unknown}")
            get = row.get
            values.append(
                [get("Timestamp")] + [float(get(c) or 0.0) for c in cols])
        self._cursor.executemany(
            insert_sql(self.features, self.config.table_name), values)
        self._cnx.commit()
        return len(values)

    def has_timestamp(self, ts: str) -> bool:
        """Point existence probe (the engine dedupe / journal-drain
        idempotency hook)."""
        self._cursor.execute(
            f"SELECT 1 FROM {self.config.table_name} "
            "WHERE Timestamp = %s LIMIT 1;", (ts,))
        return self._cursor.fetchone() is not None

    def recent_timestamps(self, limit: int) -> List[str]:
        """Newest ``limit`` timestamps (the engine's landed-dedupe seed)."""
        self._cursor.execute(
            f"SELECT Timestamp FROM {self.config.table_name} "
            "ORDER BY ID DESC LIMIT %s;", (int(limit),))
        return [r[0] for r in self._cursor.fetchall()]

    def ids_for_timestamps(
        self, timestamps: Sequence[str],
    ) -> List[Optional[int]]:
        """1-based landed positions for each timestamp (``None`` when it
        never landed) — same contract as the embedded Warehouse's.  IDs
        double as positions under the table's append-only AUTO_INCREMENT
        assumption (the same one :meth:`fetch` leans on); duplicate
        landings resolve to the newest row, like the embedded backend.
        """
        ts_list = [str(t) for t in timestamps]
        if not ts_list:
            return []
        placeholders = ", ".join(["%s"] * len(set(ts_list)))
        self._cursor.execute(
            f"SELECT Timestamp, MAX(ID) FROM {self.config.table_name} "
            f"WHERE Timestamp IN ({placeholders}) GROUP BY Timestamp;",
            sorted(set(ts_list)))
        by_ts = {str(r[0]): int(r[1]) for r in self._cursor.fetchall()}
        return [by_ts.get(t) for t in ts_list]

    def iter_row_chunks(
        self,
        start_ts: Optional[str] = None,
        end_ts: Optional[str] = None,
        chunk: int = 4096,
        *,
        follow: int = 0,
        poll_wait=None,
    ):
        """Bulk history reader — the embedded backend's contract
        (:meth:`fmda_tpu_torch.stream.warehouse.Warehouse.iter_row_chunks`)
        over a keyset-paginated MySQL ``SELECT``: ``WHERE ID > last``
        + ``ORDER BY ID LIMIT chunk`` per page, so a backfill over a
        large landed table never materialises an unbounded result set
        and never re-scans from offset 0 (OFFSET pagination is O(n²)
        over the scan).  Yields the raw landed columns as
        ``(timestamps, (B, F) float64)`` — bit-for-bit what the
        embedded backend yields for the same landed rows (tests
        assert parity through the fake server).

        ``follow > 0`` is the bounded tail-follow of the embedded
        contract: short pages keep scanning, empty pages wait
        (``poll_wait()``, injectable; default 50 ms sleep) and re-poll
        the same keyset cursor, and ``follow`` consecutive empty polls
        end the scan — identical stop/resume semantics on both
        backends, parity-tested."""
        import numpy as np

        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        cols = self.features.table_columns()
        col_list = ", ".join(f"`{c}`" for c in cols)
        conds = ["ID > %s"]
        bounds: list = []
        if start_ts is not None:
            conds.append("Timestamp >= %s")
            bounds.append(start_ts)
        if end_ts is not None:
            conds.append("Timestamp <= %s")
            bounds.append(end_ts)
        where = " AND ".join(conds)
        last_id = 0
        idle = 0
        while True:
            self._cursor.execute(
                f"SELECT ID, Timestamp, {col_list} "
                f"FROM {self.config.table_name} "
                f"WHERE {where} ORDER BY ID LIMIT %s;",
                (last_id, *bounds, int(chunk)),
            )
            rows = self._cursor.fetchall()
            if not rows:
                if follow <= 0 or idle >= int(follow):
                    return
                idle += 1
                if poll_wait is not None:
                    poll_wait()
                else:
                    import time as _time

                    _time.sleep(0.05)
                continue
            idle = 0
            last_id = int(rows[-1][0])
            matrix = np.asarray(
                [r[2:] for r in rows], np.float64
            ).reshape(len(rows), len(cols))
            yield [r[1] or "" for r in rows], matrix
            if len(rows) < chunk and follow <= 0:
                return

    def joined_row_transform(self):
        """Fresh stateful mapper from :meth:`iter_row_chunks`' raw landed
        chunks to the joined ``x_fields`` rows :meth:`fetch` serves —
        same contract as the embedded backend's method of the same name."""
        from fmda_tpu_torch.ops.indicators import landed_row_transform

        return landed_row_transform(
            self.features.table_columns(), self.features)

    def healthy(self) -> bool:
        """Probe that the server still answers — the ``/healthz``
        warehouse check, same contract as the embedded backend."""
        try:
            self._cursor.execute("SELECT 1;")
            self._cursor.fetchone()
            return True
        except Exception:  # noqa: BLE001 — loss-free: a health probe; any failure IS the "unhealthy" signal
            return False

    def fetch(self, ids: Sequence[int]):
        """Feature rows in the *requested id order* (multi-join row order is
        otherwise unspecified: scrambled training windows on a real
        server).  Raises on ids the warehouse doesn't have, like the
        embedded Warehouse.

        Index-space note: the embedded Warehouse speaks dense 1-based
        *positions* mapped to IDs internally; this adapter queries raw
        MariaDB autoincrement IDs, which equal positions under the
        deployment's append-only, no-rollback writer (a dataloader that
        indexes 1..COUNT(ID) makes the same assumption).  A burned rowid
        on a live server
        surfaces as the raise above, never as a silently shifted window."""
        import numpy as np

        ids = [int(i) for i in ids]
        fields = ", ".join(
            f"IFNULL({f}, 0)" for f in join_select_fields(self.features)
        )
        self._cursor.execute(
            f"SELECT sd.ID, {fields} "
            + join_from_clause(self.features, self.config.table_name)
            + f" WHERE sd.ID IN ({', '.join(map(str, set(ids)))})"
            " ORDER BY sd.ID;"
        )
        by_id = {int(r[0]): r[1:] for r in self._cursor.fetchall()}
        missing = [i for i in ids if i not in by_id]
        if missing:
            raise IndexError(
                f"warehouse has no rows for ids {missing[:10]}"
                f"{'...' if len(missing) > 10 else ''}"
            )
        return np.asarray([by_id[i] for i in ids], np.float32)

    def fetch_windows(self, row_ids: Sequence[int], window: int):
        """Batched trailing-window gather, ``(B, window, F)`` — the same
        contract as the embedded Warehouse's: one round-trip for the
        *union* of window ids (overlapping windows of a flush share most
        rows, and :meth:`fetch` already de-duplicates the IN list), then
        a host-side reshape per window.  Raises on any missing row, like
        :meth:`fetch`."""
        import numpy as np

        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        row_ids = [int(i) for i in row_ids]
        if not row_ids:
            return np.zeros(
                (0, window, len(self.features.x_fields())), np.float32)
        flat = [i - window + 1 + k for i in row_ids for k in range(window)]
        rows = self.fetch(flat)  # ONE IN-query over the de-duplicated ids
        return rows.reshape(len(row_ids), window, -1)

    def fetch_targets(self, ids: Sequence[int]):
        """Target labels in the requested id order (same contract as
        :meth:`fetch`)."""
        import numpy as np

        ids = [int(i) for i in ids]
        self._cursor.execute(
            "SELECT ID, up1, up2, down1, down2 FROM target WHERE ID IN "
            f"({', '.join(map(str, set(ids)))}) ORDER BY ID;"
        )
        by_id = {int(r[0]): r[1:] for r in self._cursor.fetchall()}
        missing = [i for i in ids if i not in by_id]
        if missing:
            raise IndexError(
                f"target view has no rows for ids {missing[:10]}"
                f"{'...' if len(missing) > 10 else ''}"
            )
        return np.asarray([by_id[i] for i in ids], np.float32)
