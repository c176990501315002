"""History sources for the replay driver, as ``fmda_tpu.replay.history``
defines them.

A history source is an iterable of :class:`ReplayBatch` *rounds* — the
unit the driver coalesces into one columnar tick block and one gateway
flush.  Iteration must be **deterministic and repeatable**: iterating
the same source twice yields bit-identical batches (the replay-vs-live
identity gate replays the same source into two gateways and compares
published probabilities byte for byte).

Two sources ship:

- :class:`SyntheticHistory` — the hermetic generator (seeded rng, no
  I/O): per-ticker random walks with per-ticker price scales, the same
  traffic shape as :func:`fmda_tpu_torch.runtime.loadgen.run_fleet_load`, but
  re-iterable and virtual-clock stamped.
- :class:`WarehouseHistory` — warehoused rows via the bulk chunked
  reader (``Warehouse.iter_row_chunks``, one keyset range query per
  chunk), fanned round-robin over the ticker universe.

The virtual clock is **data**, not a reading: epoch seconds derived
from the rows' own timestamps (synthetic sources compute them from
``start_epoch + round * step_s``).  Nothing in this module reads
the host clock.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime, timezone
from typing import Iterator, List, Optional, Tuple

import numpy as np

from fmda_tpu_torch.data.normalize import NormParams


@dataclass(frozen=True)
class ReplayBatch:
    """One replay round: the rows the virtual clock advances past in a
    single gateway flush."""

    #: Virtual time (epoch seconds) after this batch — the watermark.
    virtual_ts: float
    #: (B,) int ticker indices into the source's ticker universe.
    tickers: np.ndarray
    #: (B, F) float32 feature rows, parallel to ``tickers``.
    rows: np.ndarray
    #: Warehouse timestamp strings parallel to ``rows`` (the label-join
    #: key the quality evaluator resolves through ids_for_timestamps);
    #: None for sources without warehouse identity (synthetic).
    timestamps: Optional[Tuple[str, ...]] = None


def parse_epoch(ts: str, fallback: float = 0.0) -> float:
    """Warehouse timestamp string → epoch seconds, timezone-pinned to
    UTC so the virtual clock is host-independent (naive
    ``datetime.timestamp()`` would read the host zone — a wall-clock
    dependency in disguise)."""
    try:
        dt = datetime.fromisoformat(ts)
    except ValueError:
        return fallback
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.timestamp()


class SyntheticHistory:
    """Seeded synthetic history: N ticker random walks, one row per
    ticking session per round, virtual time advancing ``step_s`` per
    round.  ``duty`` < 1 makes rounds ragged (a deterministic subset of
    tickers skips — per-ticker lag becomes visible); the identity gate
    runs lockstep ``duty=1.0``, where flush composition is forced and
    live-vs-replay is bit-identical."""

    def __init__(
        self,
        n_tickers: int,
        n_rounds: int,
        n_features: int,
        *,
        seed: int = 0,
        duty: float = 1.0,
        start_epoch: float = 1577973000.0,  # 2020-01-02 13:30:00 UTC
        step_s: float = 60.0,
    ) -> None:
        if n_tickers < 1:
            raise ValueError(f"n_tickers must be >= 1, got {n_tickers}")
        if not 0.0 < duty <= 1.0:
            raise ValueError(f"duty must be in (0, 1], got {duty}")
        self.n_tickers = n_tickers
        self.n_rounds = n_rounds
        self.n_features = n_features
        self.seed = seed
        self.duty = duty
        self.start_epoch = float(start_epoch)
        self.step_s = float(step_s)
        # per-ticker price scales, from their own seeded stream so the
        # walk stream below replays identically however norms are used
        rng = np.random.default_rng(seed)
        mins = rng.normal(0.0, 1.0, size=(n_tickers, n_features)).astype(
            np.float32)
        maxs = mins + rng.uniform(
            1.0, 5.0, size=(n_tickers, n_features)).astype(np.float32)
        self._mins, self._maxs = mins, maxs
        self._walk0 = rng.normal(
            size=(n_tickers, n_features)).astype(np.float32)

    @property
    def norms(self) -> List[NormParams]:
        return [NormParams(self._mins[i], self._maxs[i])
                for i in range(self.n_tickers)]

    def __iter__(self) -> Iterator[ReplayBatch]:
        # fresh stream per iteration: the source is re-iterable and
        # every pass is bit-identical (the A/B identity contract)
        rng = np.random.default_rng((self.seed, 1))
        walk = self._walk0.copy()
        for r in range(self.n_rounds):
            if self.duty >= 1.0:
                ticking = np.arange(self.n_tickers)
            else:
                mask = rng.random(self.n_tickers) < self.duty
                ticking = np.flatnonzero(mask)
                if ticking.size == 0:
                    # virtual time still advances on an empty round
                    continue
            steps = rng.normal(
                scale=0.1,
                size=(self.n_tickers, self.n_features)).astype(np.float32)
            walk[ticking] += steps[ticking]
            yield ReplayBatch(
                virtual_ts=self.start_epoch + (r + 1) * self.step_s,
                tickers=ticking.astype(np.int32),
                rows=walk[ticking].copy(),
            )


class WarehouseHistory:
    """Warehoused history fanned over N ticker sessions: rows stream in
    landed (ID) order through ``iter_row_chunks`` — one keyset range
    query per chunk — and row *j* drives ticker ``j % n_tickers``, so a
    single-symbol warehouse exercises a whole fleet and every ticker
    advances through the same market history interleaved.

    ``row_transform`` maps a ``(B, W)`` float64 chunk of raw landed
    columns to the ``(B, F)`` float32 feature rows the pool expects;
    when omitted the landed width must already equal ``n_features``
    (anything else raises — silently truncating features would serve
    garbage bit-deterministically, the worst kind of wrong)."""

    def __init__(
        self,
        warehouse,
        n_tickers: int,
        *,
        n_features: Optional[int] = None,
        start_ts: Optional[str] = None,
        end_ts: Optional[str] = None,
        chunk: int = 4096,
        row_transform=None,
    ) -> None:
        if n_tickers < 1:
            raise ValueError(f"n_tickers must be >= 1, got {n_tickers}")
        self.warehouse = warehouse
        self.n_tickers = n_tickers
        self.n_features = n_features
        self.start_ts = start_ts
        self.end_ts = end_ts
        self.chunk = chunk
        self.row_transform = row_transform

    @property
    def norms(self) -> Optional[List[NormParams]]:
        return None  # identity normalization: landed rows serve as-is

    def __iter__(self) -> Iterator[ReplayBatch]:
        n = self.n_tickers
        pending_rows: List[np.ndarray] = []
        pending_ts: List[float] = []
        pending_raw: List[str] = []
        last_epoch = 0.0
        for ts_list, matrix in self.warehouse.iter_row_chunks(
                self.start_ts, self.end_ts, self.chunk):
            if self.row_transform is not None:
                feats = np.asarray(
                    self.row_transform(matrix), np.float32)
            else:
                feats = matrix.astype(np.float32)
                if (self.n_features is not None
                        and feats.shape[1] != self.n_features):
                    raise ValueError(
                        f"landed row width {feats.shape[1]} != "
                        f"n_features {self.n_features} — pass "
                        "row_transform to map landed columns to "
                        "feature rows")
            for i in range(feats.shape[0]):
                last_epoch = parse_epoch(ts_list[i], last_epoch)
                pending_rows.append(feats[i])
                pending_ts.append(last_epoch)
                pending_raw.append(str(ts_list[i]))
                if len(pending_rows) == n:
                    # row j drives ticker j % n, and full rounds consume
                    # exactly n rows — every round is tickers 0..n-1
                    yield ReplayBatch(
                        virtual_ts=max(pending_ts),
                        tickers=np.arange(n, dtype=np.int32),
                        rows=np.stack(pending_rows),
                        timestamps=tuple(pending_raw),
                    )
                    pending_rows, pending_ts, pending_raw = [], [], []
        if pending_rows:
            yield ReplayBatch(
                virtual_ts=max(pending_ts),
                tickers=np.arange(len(pending_rows), dtype=np.int32),
                rows=np.stack(pending_rows),
                timestamps=tuple(pending_raw),
            )
