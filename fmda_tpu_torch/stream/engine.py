"""Streaming feature engine: the five feeds in, joined feature rows out,
as ``fmda_tpu.stream.engine`` defines it.

Consumes the feed topics from the bus, aligns their timestamps, computes
the microstructure and candle features, interval-joins the feeds, lands
the joined rows in the warehouse and emits one ``predict_timestamp``
signal a row: a deterministic host-side micro-batch engine.

Semantics:

- timestamps floor to 5-minute buckets;
- inner interval join: a side-feed event matches a book tick iff their
  floors are equal AND the side timestamp lies within ``[deep_ts, deep_ts
  + join_tolerance_s]``;
- a 5-minute watermark bounds the state: a book tick with no match is
  dropped, counted, once a feed's watermark has passed its join horizon;
- missing values become 0;
- exactly one output row per book tick: the earliest match per feed is
  used, and a tick whose timestamp already landed is skipped;
- the signal is published strictly after the warehouse insert commits, so
  a consumer never sees a signal for a row it cannot read.

Tracing: a book tick that carries an in-band trace context passes it
onto its row's signal, and, while the process tracer is enabled, each
landed row gets three spans on that trace from the step that emitted it:
``join`` (stage ``engine``: the step's poll and match), ``land``
(``warehouse``: the insert) and ``signal`` (``bus``: the signal
publishes).  With tracing disabled a step pays one branch.

The join decisions come from the Python scheduler here or, with
``join_backend="native"``, from the C++ one
(:mod:`~fmda_tpu_torch.stream.native_join`), bit for bit the same; the
backend that runs is :attr:`StreamEngine.join_backend`.

Chaos: ``step`` is the injection point ``engine.step``
(:mod:`fmda_tpu_torch.chaos`); a kill window raises before the step
touches any state, like a process death between steps, and the harness
rebuilds the engine from its checkpoint.  Disabled, it costs one branch.
"""

from __future__ import annotations

import json
import logging
import os
import time as _time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from fmda_tpu_torch.chaos.inject import default_chaos
from fmda_tpu_torch.config import (
    COT_GROUPS,
    COT_VALUES,
    EVENT_VALUES,
    FeatureConfig,
    TOPIC_COT,
    TOPIC_DEEP,
    TOPIC_IND,
    TOPIC_PREDICT_TIMESTAMP,
    TOPIC_VIX,
    TOPIC_VOLUME,
)
from fmda_tpu_torch.obs.trace import default_tracer, now_ns
from fmda_tpu_torch.ops.microstructure import deep_features, wick_percentage
from fmda_tpu_torch.stream.bus import MessageBus
from fmda_tpu_torch.stream.warehouse import Warehouse
from fmda_tpu_torch.utils.timeutils import floor_epoch, parse_ts, to_epoch
from fmda_tpu_torch.utils.tracing import StageTimer

log = logging.getLogger("fmda_tpu_torch.stream")

#: chaos injection singleton, captured once at import (the tracer's
#: discipline: one guarded branch a step when disabled)
_CHAOS = default_chaos()


@dataclass
class _Event:
    ts: int  # epoch seconds
    ts_str: str
    payload: Dict[str, float]
    #: in-band trace context of the message that produced this event
    #: (deep/book events only — the book tick IS the traced entity);
    #: None when the producer wasn't tracing
    trace: Optional[str] = None
    #: True for a ghost event the engine synthesised for a stale side
    #: stream (degraded-mode join): the payload is that stream's
    #: last-known values (or empty — fillna 0 lands zeros).  A join
    #: consuming a ghost counts in ``degraded_rows``; real events are
    #: preferred over ghosts when both fall in a match window.
    degraded: bool = False


@dataclass
class _StreamBuffer:
    """Per-feed buffer with watermark tracking.

    Events are bucketed by floored timestamp so the join probe is an O(1)
    dict lookup plus a scan of one bucket (a handful of events), instead of
    a linear pass over everything buffered — the difference between O(rows)
    and O(rows^2) total work when replaying months of history through the
    engine (backtests, recovery)."""

    name: str
    floor_s: int
    buckets: Dict[int, List[_Event]] = field(default_factory=dict)
    max_ts: int = -1
    #: payload of the newest *real* event ever ingested — the
    #: "last-known values" a degraded-mode join falls back to while the
    #: feed is down; None until the stream first delivers
    last_payload: Optional[Dict[str, float]] = None

    def add(self, event: _Event) -> None:
        self.buckets.setdefault(
            floor_epoch(event.ts, self.floor_s), []).append(event)
        self.max_ts = max(self.max_ts, event.ts)
        if event.ts == self.max_ts:
            self.last_payload = event.payload

    def add_ghost(self, event: _Event) -> None:
        """Insert a degraded-mode ghost WITHOUT advancing ``max_ts`` (or
        ``last_payload``): the watermark tracks only what the feed really
        delivered, so recovery detection and eviction stay honest."""
        self.buckets.setdefault(
            floor_epoch(event.ts, self.floor_s), []).append(event)

    def watermark(self, delay_s: int) -> int:
        return self.max_ts - delay_s if self.max_ts >= 0 else -1

    def evict_before(self, ts: int) -> None:
        for fl in [f for f in self.buckets if f + self.floor_s <= ts]:
            del self.buckets[fl]
        boundary = floor_epoch(ts, self.floor_s)
        if boundary in self.buckets:  # partial bucket: filter exactly
            kept = [e for e in self.buckets[boundary] if e.ts >= ts]
            if kept:
                self.buckets[boundary] = kept
            else:
                del self.buckets[boundary]

    def match(self, deep_ts: int, tolerance_s: int) -> Optional[_Event]:
        """Earliest event with equal floor and ts in [deep_ts, deep_ts+tol].

        Real events beat ghosts regardless of timestamp: a feed that
        recovers inside a tick's match window should serve real values
        even though the ghost (minted at ``deep_ts``) sorts earliest."""
        best: Optional[_Event] = None
        for e in self.buckets.get(floor_epoch(deep_ts, self.floor_s), ()):
            if not (deep_ts <= e.ts <= deep_ts + tolerance_s):
                continue
            if (best is None or (best.degraded and not e.degraded)
                    or (best.degraded == e.degraded and e.ts < best.ts)):
                best = e
        return best

    @property
    def events(self) -> List[_Event]:
        """Flattened view (checkpointing and tests)."""
        return [e for fl in sorted(self.buckets) for e in self.buckets[fl]]


def _deep_key_table(bid_levels: int, ask_levels: int):
    """Precomputed per-level message keys — built once per engine, not
    per message (the f-strings were measurable in the replay profile)."""
    return (
        tuple((f"bids_{i}", f"bid_{i}", f"bid_{i}_size")
              for i in range(bid_levels)),
        tuple((f"asks_{i}", f"ask_{i}", f"ask_{i}_size")
              for i in range(ask_levels)),
    )


def _extract_deep_raw(value: dict, key_table) -> tuple:
    """Pull the raw book ladder out of one DEEP message (the producer's
    ``bids_i``/``asks_i`` level dicts).  Missing levels -> 0.  Returns (ts_str, bids, bid_sizes, asks, ask_sizes)
    as python lists — feature math happens batched in
    :func:`_parse_deep_batch`."""
    ts_str = value["Timestamp"]
    to_epoch(ts_str)  # validate the timestamp before accepting the message
    bid_keys, ask_keys = key_table
    bids, bid_sizes = [], []
    asks, ask_sizes = [], []
    get = value.get
    for level_key, px_key, size_key in bid_keys:
        lvl = get(level_key) or {}
        bids.append(float(lvl.get(px_key) or 0.0))
        bid_sizes.append(float(lvl.get(size_key) or 0.0))
    for level_key, px_key, size_key in ask_keys:
        lvl = get(level_key) or {}
        asks.append(float(lvl.get(px_key) or 0.0))
        ask_sizes.append(float(lvl.get(size_key) or 0.0))
    return ts_str, bids, bid_sizes, asks, ask_sizes


def _parse_deep_batch(raws) -> List[_Event]:
    """Feature-compute a whole poll's DEEP messages in one vectorized pass
    (one ``deep_features`` call for N rows, not N calls of batch 1 — the
    replay-throughput difference is ~5x)."""
    if not raws:
        return []
    ts_strs = [r[0] for r in raws]
    feats = deep_features(
        np.asarray([r[1] for r in raws]),
        np.asarray([r[2] for r in raws]),
        np.asarray([r[3] for r in raws]),
        np.asarray([r[4] for r in raws]),
        [parse_ts(t) for t in ts_strs],
    )
    # .tolist() already yields python floats — no per-value float() needed
    cols = {k: v.tolist() for k, v in feats.items()}
    items = list(cols.items())
    return [
        _Event(to_epoch(ts), ts, {k: v[i] for k, v in items})
        for i, ts in enumerate(ts_strs)
    ]


def _parse_vix(value: dict) -> _Event:
    ts_str = value["Timestamp"]
    return _Event(to_epoch(ts_str), ts_str, {"VIX": float(value.get("VIX") or 0.0)})


def _parse_volume(value: dict) -> _Event:
    """OHLCV bar + wick percentage."""
    ts_str = value["Timestamp"]
    payload = {
        k: float(value.get(k) or 0.0)
        for k in ("1_open", "2_high", "3_low", "4_close", "5_volume")
    }
    payload["wick_prct"] = float(
        wick_percentage(
            [payload["1_open"]],
            [payload["2_high"]],
            [payload["3_low"]],
            [payload["4_close"]],
        )[0]
    )
    return _Event(to_epoch(ts_str), ts_str, payload)


#: COT flattening keys, built once at import (same f-string-hoisting as
#: :func:`_deep_key_table`; the combined name is both the nested lookup
#: key and the payload key)
_COT_KEY_TABLE = tuple(
    (group, tuple(f"{group}_{v}" for v in COT_VALUES))
    for group in COT_GROUPS
)


def _parse_cot(value: dict) -> _Event:
    """Flatten the nested COT groups."""
    ts_str = value["Timestamp"]
    payload: Dict[str, float] = {}
    vget = value.get
    for group, keys in _COT_KEY_TABLE:
        nget = (vget(group) or {}).get
        for key in keys:
            payload[key] = float(nget(key) or 0.0)
    return _Event(to_epoch(ts_str), ts_str, payload)


def _ind_key_table(events: Tuple[str, ...]):
    """(event, ((payload_key, nested_key), ...)) — built once per engine
    (39 f-strings per message otherwise)."""
    return tuple(
        (event, tuple((f"{event}_{v}", v) for v in EVENT_VALUES))
        for event in events
    )


def _parse_ind(value: dict, key_table) -> _Event:
    """Flatten the indicator template message."""
    ts_str = value["Timestamp"]
    payload: Dict[str, float] = {}
    vget = value.get
    for event, pairs in key_table:
        nget = (vget(event) or {}).get
        for out_key, ev_val in pairs:
            payload[out_key] = float(nget(ev_val) or 0.0)
    return _Event(to_epoch(ts_str), ts_str, payload)


class StreamEngine:
    """Micro-batch join engine over the bus feeds."""

    #: in-memory landed-tick dedupe entries kept/seeded before falling
    #: back to indexed warehouse lookups for older ticks
    _LANDED_SEED_LIMIT = 5000

    def __init__(
        self,
        bus: MessageBus,
        warehouse: Warehouse,
        features: FeatureConfig,
        *,
        signal_topic: str = TOPIC_PREDICT_TIMESTAMP,
        checkpoint_path: Optional[str] = None,
        from_end: bool = False,
        checkpoint_every: int = 1,
        join_backend: str = "python",
        staleness_deadline_s: Optional[int] = None,
        metrics=None,
    ) -> None:
        self.bus = bus
        self.warehouse = warehouse
        self.features = features
        self.signal_topic = signal_topic
        self.checkpoint_path = checkpoint_path
        #: Degraded-mode join deadline (stream-time seconds): once a side
        #: stream's watermark trails the newest book tick by more than
        #: this, the engine stops stalling on it and joins with the
        #: stream's last-known (or absent) values instead — each such
        #: row counted per topic in ``degraded_rows``.  None (default)
        #: keeps the strict inner-join stall semantics.
        self.staleness_deadline_s = staleness_deadline_s
        #: Checkpoint cadence in steps.  1 = after every step (strongest
        #: durability, the default); N > 1 amortises the state write over
        #: replay/backtest churn — a crash then replays at most the last N
        #: steps' messages from the bus (offsets move back with the
        #: checkpoint), re-landing those rows in the warehouse.
        self.checkpoint_every = max(1, checkpoint_every)
        self._steps_since_ckpt = 0
        self._dirty = False

        floor_s = features.floor_s
        self._side_streams: Dict[str, _StreamBuffer] = {}
        self._consumers = {}
        self._consumers[TOPIC_DEEP] = bus.consumer(TOPIC_DEEP, from_end=from_end)
        if features.get_vix:
            self._side_streams[TOPIC_VIX] = _StreamBuffer(TOPIC_VIX, floor_s)
            self._consumers[TOPIC_VIX] = bus.consumer(TOPIC_VIX, from_end=from_end)
        if features.get_stock_volume:
            self._side_streams[TOPIC_VOLUME] = _StreamBuffer(TOPIC_VOLUME, floor_s)
            self._consumers[TOPIC_VOLUME] = bus.consumer(TOPIC_VOLUME, from_end=from_end)
        if features.get_cot:
            self._side_streams[TOPIC_COT] = _StreamBuffer(TOPIC_COT, floor_s)
            self._consumers[TOPIC_COT] = bus.consumer(TOPIC_COT, from_end=from_end)
        self._side_streams[TOPIC_IND] = _StreamBuffer(TOPIC_IND, floor_s)
        self._consumers[TOPIC_IND] = bus.consumer(TOPIC_IND, from_end=from_end)

        #: kept sorted by ts (insertion-sorted on ingest; feeds are nearly
        #: in order, so the bisect degenerates to an append)
        self._pending_deep: List[_Event] = []
        #: the C++ scheduler for the matching loop (join decisions only:
        #: the payloads stay in the Python buffers and pending list)
        self._core = None
        if join_backend == "native" and staleness_deadline_s is not None:
            # degraded-mode preference (a real event beats a ghost inside
            # a match window) lives in the python scheduler's match(); the
            # C++ core's earliest-ts rule would pick the ghost after a
            # feed recovers mid-window.  A loud fallback, as for an absent
            # toolchain: the python path makes the same decisions
            log.warning(
                "degraded-mode joins (staleness_deadline_s=%s) run on the "
                "python join scheduler; ignoring join_backend='native'",
                staleness_deadline_s)
            join_backend = "python"
        if join_backend == "native":
            from fmda_tpu_torch.stream.native_join import (
                NativeJoinCore,
                NativeJoinUnavailable,
            )

            try:
                self._stream_topics = list(self._side_streams)
                self._core = NativeJoinCore(
                    features.floor_s, features.join_tolerance_s,
                    features.watermark_s, len(self._stream_topics))
            # loss-free: loud fallback, like default_bus for the ring
            # bus — the python join path is bit-identical, just not C++
            except NativeJoinUnavailable as e:
                log.warning("native join scheduler unavailable (%s); using "
                            "the python join path", e)
                join_backend = "python"
        elif join_backend != "python":
            raise ValueError(
                f"join_backend {join_backend!r}; use 'python' or 'native'")
        #: the join scheduler that runs: "native" or "python" (after the
        #: fallbacks above)
        self.join_backend = join_backend
        self._deep_keys = _deep_key_table(
            features.bid_levels, features.ask_levels)
        self._side_parsers = {
            TOPIC_VIX: _parse_vix,
            TOPIC_VOLUME: _parse_volume,
            TOPIC_COT: _parse_cot,
            TOPIC_IND: (
                lambda v, _kt=_ind_key_table(features.event_list_repl):
                _parse_ind(v, _kt)
            ),
        }
        #: timestamps of landed ticks: the "exactly one output row per
        #: book tick" rule, which also makes crash-replay idempotent.  Seeded bounded from
        #: the warehouse tail at construction and pruned below the join
        #: watermark as the session runs; ticks older than the seed window
        #: fall back to an indexed warehouse lookup (deep replays stay
        #: exact without holding all history in memory).
        seed = warehouse.recent_timestamps(self._LANDED_SEED_LIMIT)
        self._landed_ts: set = set(seed)
        self._landed_seed_floor: Optional[str] = (
            min(seed) if len(seed) >= self._LANDED_SEED_LIMIT else None
        )
        self._emitted = 0
        self._dropped = 0
        #: malformed feed messages discarded at parse time: every discard
        #: is counted (a book tick that dies here was published but will
        #: never land), as the join's drops are
        self._bad_messages = 0
        #: degraded-mode accounting: rows emitted with ghost features,
        #: per side topic, plus the timestamps of those rows (pruned with
        #: the landed-dedupe set), so a comparison can leave them out
        self._degraded_rows: Dict[str, int] = {
            t: 0 for t in self._side_streams}
        self._degraded_ts: set = set()
        #: corrupt/truncated checkpoint files survived (counted fresh
        #: starts — see :meth:`restore`)
        self._checkpoint_corrupt = 0
        #: newest book-tick timestamp ingested (epoch s) — the stream-time
        #: "now" that watermark ages in :attr:`stats` are measured against
        self._max_deep_ts = -1
        #: first book-tick timestamp ever ingested: the degraded-mode
        #: reference for a side stream that has NEVER delivered (its
        #: watermark is undefined, so staleness is measured as how far
        #: book time has advanced since the session started)
        self._first_deep_ts = -1
        #: warehouse backfill hook (:mod:`fmda_tpu_torch.stream.journal`):
        #: drained
        #: once per step so a spilled journal recovers even on idle
        #: ticks; None for plain warehouses (one attribute read per step)
        self._wh_drain = getattr(warehouse, "drain_journal", None)
        #: per-stage wall clock: every step's ingest/join/land/signal time
        self.timer = StageTimer()
        #: optional metrics registry: one end-to-end latency histogram a
        #: step
        self._obs_step_hist = (
            metrics.histogram("engine_step_seconds")
            if metrics is not None else None
        )
        #: span recorder: the process-default tracer, captured once;
        #: disabled = one branch a step
        self._tracer = default_tracer()
        if checkpoint_path:
            tmp = f"{checkpoint_path}.tmp"
            if os.path.exists(tmp):
                # a kill mid-checkpoint() leaves the tmp behind
                # (os.replace never committed it); the durable file is
                # authoritative — a stale tmp must never be mistaken for
                # state or block the next atomic replace
                log.warning("removing leftover checkpoint tmp %s", tmp)
                os.remove(tmp)
            if os.path.exists(checkpoint_path):
                self.restore()

    # -- parsing -------------------------------------------------------------

    def _ingest(self) -> bool:
        """Poll every feed; returns True if anything new arrived."""
        import bisect

        fc = self.features
        polled_any = False
        raws = []
        wires = []  # in-band trace contexts, aligned with raws
        for rec in self._consumers[TOPIC_DEEP].poll():
            polled_any = True
            try:
                raw = _extract_deep_raw(rec.value, self._deep_keys)
            except (KeyError, ValueError, TypeError, AttributeError) as e:
                # AttributeError: a nested level that should be a dict is a
                # scalar — malformed producer output, not a crash
                self._bad_messages += 1
                log.warning("bad deep message at offset %d: %s", rec.offset, e)
                continue
            raws.append(raw)
            wires.append(rec.value.get("trace"))
        try:
            deep_events = _parse_deep_batch(raws)
            for event, wire in zip(deep_events, wires):
                event.trace = wire
        except (KeyError, ValueError, TypeError, AttributeError) as e:
            # one pathological message that survived extraction must not
            # abort the whole poll's batch — fall back to per-message
            # parsing and drop only the offender(s); the per-message
            # retry below counts each actual discard (loss-free here)
            log.warning(
                "batched deep parse failed (%s); retrying per-message", e)
            deep_events = []
            for raw, wire in zip(raws, wires):
                try:
                    parsed = _parse_deep_batch([raw])
                except (KeyError, ValueError, TypeError, AttributeError) as e2:
                    self._bad_messages += 1
                    log.warning("bad deep message %s dropped: %s", raw[0], e2)
                    continue
                for event in parsed:
                    event.trace = wire
                deep_events.extend(parsed)
        for event in deep_events:
            bisect.insort(self._pending_deep, event, key=lambda e: e.ts)
            if self._core is not None:
                self._core.add_deep(event.ts)
            self._max_deep_ts = max(self._max_deep_ts, event.ts)
            if self._first_deep_ts < 0:
                self._first_deep_ts = event.ts
        parsers = self._side_parsers
        for idx, (topic, buf) in enumerate(self._side_streams.items()):
            for rec in self._consumers[topic].poll():
                polled_any = True
                try:
                    event = parsers[topic](rec.value)
                except (KeyError, ValueError, TypeError, AttributeError) as e:
                    self._bad_messages += 1
                    log.warning(
                        "bad %s message at offset %d: %s", topic, rec.offset, e
                    )
                    continue
                buf.add(event)
                if self._core is not None:
                    self._core.add_side(idx, event.ts)
        return polled_any

    # -- degraded-mode joins -------------------------------------------------

    def degraded_streams(self) -> Tuple[str, ...]:
        """Side streams currently past the staleness deadline: their
        watermark trails the newest book tick by more than
        ``staleness_deadline_s`` (a stream that has never delivered is
        measured from the first book tick instead).  Empty when the
        feature is disabled or every feed is fresh — recovery is
        automatic the moment real events advance the watermark."""
        dl = self.staleness_deadline_s
        if dl is None or self._max_deep_ts < 0:
            return ()
        wm_s = self.features.watermark_s
        out = []
        for topic, buf in self._side_streams.items():
            wm = buf.watermark(wm_s)
            ref = wm if wm >= 0 else self._first_deep_ts - wm_s
            if self._max_deep_ts - ref > dl:
                out.append(topic)
        return tuple(out)

    def _apply_degraded_mode(self) -> None:
        """Mint ghost events so stale streams stop blocking the join:
        for every pending book tick with no real match in a degraded
        stream, a ghost carrying the stream's last-known payload (empty
        if it never delivered — fillna lands zeros) is inserted at the
        tick's own timestamp.  The join path then emits the row; the consumed ghost is what increments
        ``degraded_rows``.  Ghosts never advance watermarks, so the
        stream re-joins cleanly the moment it recovers."""
        degraded = self.degraded_streams()
        if not degraded:
            return
        tol = self.features.join_tolerance_s
        for topic in degraded:
            buf = self._side_streams[topic]
            for deep_ev in self._pending_deep:
                if buf.match(deep_ev.ts, tol) is not None:
                    continue
                ghost = _Event(
                    deep_ev.ts, deep_ev.ts_str,
                    dict(buf.last_payload or {}), degraded=True)
                buf.add_ghost(ghost)

    def _count_degraded(self, ts_str: str, topics) -> None:
        for topic in topics:
            self._degraded_rows[topic] += 1
        if topics:
            self._degraded_ts.add(ts_str)

    # -- join ----------------------------------------------------------------

    def step(self) -> int:
        """One micro-batch: poll, join what's ready, land + signal.

        Returns the number of rows emitted this step.
        """
        if _CHAOS.enabled:
            # a kill window here is the "engine process died mid-stream"
            # fault: raised before any state moves, the harness rebuilds
            # from the checkpoint via restore()
            _CHAOS.check("engine.step")
        if self._obs_step_hist is None:
            return self._step()
        t0 = _time.perf_counter()
        try:
            return self._step()
        finally:
            self._obs_step_hist.observe(_time.perf_counter() - t0)

    def _step(self) -> int:
        fc = self.features
        tr = self._tracer
        tracing = tr.enabled  # one branch; ns stamps only when tracing
        t_step0_ns = now_ns() if tracing else 0
        if self._wh_drain is not None:
            # backfill a spilled write-ahead journal before this step's
            # rows land (ordering: journaled rows are older); a no-op
            # when the journal is empty, swallowed-failure when the
            # store is still down (the journal keeps the rows)
            self._wh_drain()
        with self.timer.stage("ingest"):
            polled_any = self._ingest()
        if self.staleness_deadline_s is not None and self._pending_deep:
            self._apply_degraded_mode()
        emitted_rows: List[Dict[str, float]] = []
        still_pending: List[_Event] = []
        #: Timestamp -> in-band trace context for rows emitted this step
        row_traces: Dict[str, str] = {}
        #: Timestamp -> side topics joined via ghost (counted only for
        #: rows that actually land — a crash-replayed duplicate row must
        #: not double-count degradation)
        row_degraded: Dict[str, List[str]] = {}

        with self.timer.stage("join"):
            if self._core is not None:
                emitted_rows, still_pending = self._join_native(
                    row_traces, row_degraded)
            else:
                for deep_ev in self._pending_deep:  # insertion-sorted by ts
                    matches: Dict[str, _Event] = {}
                    expired = False  # some stream can provably never match
                    waiting = False  # some stream might still deliver one
                    for topic, buf in self._side_streams.items():
                        m = buf.match(deep_ev.ts, fc.join_tolerance_s)
                        if m is not None:
                            matches[topic] = m
                        elif (
                            buf.watermark(fc.watermark_s)
                            > deep_ev.ts + fc.join_tolerance_s
                        ):
                            expired = True
                        else:
                            waiting = True
                    if expired:
                        # inner join: one unmatched stream past its horizon
                        # kills the row
                        self._dropped += 1
                        log.warning(
                            "dropping unjoinable book row at %s (no side "
                            "match within tolerance)", deep_ev.ts_str,
                        )
                    elif waiting:
                        still_pending.append(deep_ev)
                    else:  # all side streams matched
                        row: Dict[str, float] = {"Timestamp": deep_ev.ts_str}
                        row.update(deep_ev.payload)
                        for m in matches.values():
                            row.update(m.payload)
                        emitted_rows.append(row)
                        ghosted = [t for t, m in matches.items()
                                   if m.degraded]
                        if ghosted:
                            row_degraded[deep_ev.ts_str] = ghosted
                        if deep_ev.trace is not None:
                            row_traces[deep_ev.ts_str] = deep_ev.trace

        self._pending_deep = still_pending
        t_join_ns = now_ns() if tracing else 0

        # one output row per book tick: a tick whose timestamp already
        # landed (a duplicate feed message, or a crash-replay after the
        # offsets rewound) is skipped, the warehouse untouched
        if emitted_rows:
            fresh, seen_now = [], set()
            for r in emitted_rows:
                ts = r["Timestamp"]
                if ts in self._landed_ts or ts in seen_now:
                    continue
                # older than the bounded in-memory seed (deep replay):
                # the warehouse itself is the source of truth
                if (
                    self._landed_seed_floor is not None
                    and ts < self._landed_seed_floor
                    and self._warehouse_has(ts)
                ):
                    continue
                seen_now.add(ts)
                fresh.append(r)
            if len(fresh) < len(emitted_rows):
                log.info(
                    "skipping %d row(s) for already-landed tick(s) "
                    "(duplicate feed message or resume replay)",
                    len(emitted_rows) - len(fresh),
                )
            emitted_rows = fresh
        if emitted_rows:
            t_land0_ns = now_ns() if tracing else 0
            with self.timer.stage("land"):
                self.warehouse.insert_rows(emitted_rows)
            t_land1_ns = now_ns() if tracing else 0
            # mark landed and signal AFTER the write commits: no phantom
            # dedupe entry on a failed insert, no signal for a row a
            # consumer cannot read yet
            with self.timer.stage("signal"):
                for row in emitted_rows:
                    self._landed_ts.add(row["Timestamp"])
                    self._count_degraded(
                        row["Timestamp"],
                        row_degraded.get(row["Timestamp"], ()))
                    msg: Dict[str, object] = {"Timestamp": row["Timestamp"]}
                    if row_traces:
                        # the book tick's trace context rides onto its
                        # signal
                        wire = row_traces.get(row["Timestamp"])
                        if wire is not None:
                            msg["trace"] = wire
                    self.bus.publish(self.signal_topic, msg)
            self._emitted += len(emitted_rows)
            if tracing and row_traces:
                # per landed row, on the book tick's trace: the step's
                # measured boundaries (join covers the poll and match of
                # the step that emitted the row)
                t_sig1_ns = now_ns()
                for row in emitted_rows:
                    wire = row_traces.get(row["Timestamp"])
                    if wire is None:
                        continue
                    tr.add_span_wire(
                        wire, "join", "engine", t_step0_ns, t_join_ns)
                    tr.add_span_wire(
                        wire, "land", "warehouse", t_land0_ns, t_land1_ns)
                    tr.add_span_wire(
                        wire, "signal", "bus", t_land1_ns, t_sig1_ns)

        # bound buffer state by the global watermark; a degraded stream's
        # stalled watermark is excluded from the min (its book ticks flow
        # through on ghosts, so a long feed outage must not pin every
        # OTHER buffer's memory at the outage start)
        degraded = set(self.degraded_streams())
        horizon = min(
            (b.watermark(fc.watermark_s)
             for t, b in self._side_streams.items() if t not in degraded),
            default=(
                self._max_deep_ts - fc.watermark_s
                if degraded else -1
            ),
        )
        if horizon > 0:
            for buf in self._side_streams.values():
                buf.evict_before(horizon - fc.join_tolerance_s)
            # ticks more than one tolerance below the eviction boundary
            # can never be emitted again (no surviving side event can fall
            # in their [ts, ts+tol] match window), so their dedupe entries
            # are dead weight — prune occasionally to bound the set
            if len(self._landed_ts) > 8192:
                cutoff = horizon - 2 * fc.join_tolerance_s
                self._landed_ts = {
                    t for t in self._landed_ts if to_epoch(t) >= cutoff
                }
                self._degraded_ts = {
                    t for t in self._degraded_ts if to_epoch(t) >= cutoff
                }

        if self.checkpoint_path:
            if polled_any or emitted_rows:
                self._dirty = True
            self._steps_since_ckpt += 1
            # write every N steps while busy, or once when the stream
            # quiesces (nothing polled, nothing emitted) with state still
            # unpersisted — a fully idle poll loop writes nothing
            quiesced = not polled_any and not emitted_rows
            if self._dirty and (
                self._steps_since_ckpt >= self.checkpoint_every or quiesced
            ):
                self.checkpoint()
        return len(emitted_rows)

    # -- observability -------------------------------------------------------

    def _find_side_event(self, topic: str, ts: int) -> _Event:
        """The side event the native scheduler matched (the first added
        at that timestamp, the C++ tie rule)."""
        buf = self._side_streams[topic]
        for e in buf.buckets.get(floor_epoch(ts, buf.floor_s), ()):
            if e.ts == ts:
                return e
        raise RuntimeError(
            f"native join matched {topic}@{ts} but the payload buffer has "
            "no such event (state divergence)")

    def _join_native(
        self,
        row_traces: Dict[str, str],
        row_degraded: Dict[str, List[str]],
    ) -> Tuple[List[Dict[str, float]], List[_Event]]:
        """The C++ scheduler's join decisions, the rows assembled here."""
        by_ts: Dict[int, List[_Event]] = defaultdict(list)
        for e in self._pending_deep:
            by_ts[e.ts].append(e)
        emitted, dropped = self._core.step()
        for ts in dropped:
            deep_ev = by_ts[ts].pop(0)
            self._dropped += 1
            log.warning("dropping unjoinable book row at %s (no side match "
                        "within tolerance)", deep_ev.ts_str)
        rows: List[Dict[str, float]] = []
        for tup in emitted:
            deep_ev = by_ts[tup[0]].pop(0)
            row: Dict[str, float] = {"Timestamp": deep_ev.ts_str}
            row.update(deep_ev.payload)
            ghost_topics = []
            for i, topic in enumerate(self._stream_topics):
                m = self._find_side_event(topic, tup[1 + i])
                row.update(m.payload)
                if m.degraded:
                    ghost_topics.append(topic)
            rows.append(row)
            if ghost_topics:
                row_degraded[deep_ev.ts_str] = ghost_topics
            if deep_ev.trace is not None:
                row_traces[deep_ev.ts_str] = deep_ev.trace
        still_pending = [e for e in self._pending_deep
                         if any(kept is e for kept in by_ts[e.ts])]
        return rows, still_pending

    @property
    def stats(self) -> Dict[str, object]:
        """Counters plus the lag and watermark observability:

        - ``consumer_lag``: per-topic published-but-unpolled message
          count (``bus.end_offset - consumer.offset``) — a growing lag
          means the engine step loop is falling behind its producers;
        - ``watermark_age_s``: per side stream, how far that stream's
          join watermark trails the newest ingested book tick (stream
          time, not wall time — replay-safe).  A large age means the
          feed has gone quiet while book ticks keep arriving, so joins
          are waiting on it; None until both sides have seen data.
        """
        lag = {
            topic: self.bus.end_offset(topic) - c.offset
            for topic, c in self._consumers.items()
        }
        ages: Dict[str, Optional[int]] = {}
        for topic, buf in self._side_streams.items():
            wm = buf.watermark(self.features.watermark_s)
            ages[topic] = (
                self._max_deep_ts - wm
                if wm >= 0 and self._max_deep_ts >= 0 else None
            )
        return {
            "emitted": self._emitted,
            "dropped": self._dropped,
            "bad_messages": self._bad_messages,
            "pending": len(self._pending_deep),
            "consumer_lag": lag,
            "watermark_age_s": ages,
            "degraded_rows": dict(self._degraded_rows),
            "degraded_streams": list(self.degraded_streams()),
            "checkpoint_corrupt": self._checkpoint_corrupt,
        }

    @property
    def degraded_row_timestamps(self) -> Tuple[str, ...]:
        """Timestamps of rows that landed with ghost features (bounded:
        pruned with the landed-dedupe set).  Chaos harnesses use this to
        exclude degraded rows from bit-identity comparisons; operators
        use it to audit what a feed outage actually touched."""
        return tuple(sorted(self._degraded_ts))

    # -- checkpoint / resume -------------------------------------------------

    def _warehouse_has(self, ts: str) -> bool:
        """Indexed membership probe for the deep-replay dedupe: prefer the
        warehouse's point ``has_timestamp`` (O(log n)); fall back to the
        positional lookup for sources that only expose that."""
        has = getattr(self.warehouse, "has_timestamp", None)
        if has is not None:
            return bool(has(ts))
        return self.warehouse.id_for_timestamp(ts) is not None

    def checkpoint(self) -> None:
        """Persist the engine's durable state: consumer offsets *plus* all
        polled-but-unjoined events (pending book rows and side-stream
        buffers).  Offsets alone would silently lose any row still waiting
        for a join match across a restart."""

        def dump_event(e: _Event) -> dict:
            d = {"ts": e.ts, "ts_str": e.ts_str, "payload": e.payload}
            if e.trace is not None:  # keep checkpoints small when untraced
                d["trace"] = e.trace
            if e.degraded:
                d["degraded"] = True
            return d

        state = {
            "offsets": {t: c.offset for t, c in self._consumers.items()},
            "emitted": self._emitted,
            "dropped": self._dropped,
            "bad_messages": self._bad_messages,
            "max_deep_ts": self._max_deep_ts,
            "first_deep_ts": self._first_deep_ts,
            "degraded_rows": self._degraded_rows,
            "degraded_ts": sorted(self._degraded_ts),
            "pending_deep": [dump_event(e) for e in self._pending_deep],
            "buffers": {
                t: {
                    "max_ts": b.max_ts,
                    "last_payload": b.last_payload,
                    "events": [dump_event(e) for e in b.events],
                }
                for t, b in self._side_streams.items()
            },
        }
        tmp = f"{self.checkpoint_path}.tmp"
        with open(tmp, "w") as fh:
            json.dump(state, fh)
        os.replace(tmp, self.checkpoint_path)
        self._steps_since_ckpt = 0
        self._dirty = False

    def restore(self) -> None:
        """Rebuild engine state from the checkpoint file.

        A corrupt or truncated checkpoint (a kill mid-write on a
        filesystem without atomic replace, disk trouble, a foreign
        writer) is survived as a *counted fresh start*: the bad file is
        moved aside to ``<path>.corrupt`` (forensics), the
        ``checkpoint_corrupt`` counter increments, and the engine keeps
        its fresh construction-time state — consumers replay from offset
        0 and the landed-tick dedupe makes the re-landing idempotent, so
        the cost is replay work, never duplicated rows.  The state dict
        is parsed *fully* before any of it is applied: a checkpoint that
        fails halfway through validation cannot leave the engine
        half-restored (offsets moved, buffers not).
        """

        def load_event(d: dict) -> _Event:
            return _Event(int(d["ts"]), d["ts_str"], dict(d["payload"]),
                          trace=d.get("trace"),
                          degraded=bool(d.get("degraded", False)))

        try:
            with open(self.checkpoint_path) as fh:
                state = json.load(fh)
            offsets = {t: int(o) for t, o in state["offsets"].items()}
            pending = [load_event(d)
                       for d in state.get("pending_deep", [])]
            buffers = {
                topic: (int(dump["max_ts"]), dump.get("last_payload"),
                        [load_event(d) for d in dump["events"]])
                for topic, dump in state.get("buffers", {}).items()
            }
        except (OSError, json.JSONDecodeError, KeyError, TypeError,
                ValueError, AttributeError) as e:
            self._checkpoint_corrupt += 1
            log.warning(
                "corrupt/truncated checkpoint %s (%s): counted fresh "
                "start — bus replay + landed-tick dedupe make this "
                "exact, not lossy", self.checkpoint_path, e)
            try:
                os.replace(self.checkpoint_path,
                           f"{self.checkpoint_path}.corrupt")
            except OSError:  # loss-free: the .corrupt copy is forensics only; the counted fresh start already happened
                pass  # already gone / unwritable dir: nothing to keep
            return

        for topic, offset in offsets.items():
            if topic in self._consumers:
                self._consumers[topic].seek(offset)
        self._emitted = state.get("emitted", 0)
        self._dropped = state.get("dropped", 0)
        self._bad_messages = state.get("bad_messages", 0)
        for topic, n in state.get("degraded_rows", {}).items():
            if topic in self._degraded_rows:
                self._degraded_rows[topic] = int(n)
        self._degraded_ts = set(state.get("degraded_ts", ()))
        self._pending_deep = pending
        # the join loop trusts sorted order; make the invariant
        # self-establishing for checkpoints from any writer
        self._pending_deep.sort(key=lambda e: e.ts)
        # stream-time "now" for watermark ages, persisted exactly (a
        # checkpoint taken after all ticks joined would otherwise restore
        # with no age signal until the next tick); a checkpoint without
        # it falls back to the newest still-pending tick
        self._max_deep_ts = state.get("max_deep_ts", self._max_deep_ts)
        self._first_deep_ts = state.get(
            "first_deep_ts", self._first_deep_ts)
        if self._pending_deep:
            self._max_deep_ts = max(
                self._max_deep_ts, self._pending_deep[-1].ts)
        for topic, (max_ts, last_payload, events) in buffers.items():
            if topic in self._side_streams:
                buf = self._side_streams[topic]
                buf.buckets = {}
                for e in events:
                    if e.degraded:  # ghosts must not touch the watermark
                        buf.add_ghost(e)
                    else:
                        buf.add(e)
                # the watermark can be ahead of any buffered event (post-
                # eviction); restore it exactly.  Same for last_payload —
                # the newest real event may long be evicted (older
                # checkpoints lack the field: keep what add() derived).
                buf.max_ts = max_ts
                if last_payload is not None:
                    buf.last_payload = last_payload
        if self._core is not None:
            # mirror the restored state into a fresh C++ scheduler (the
            # Python side was reset above; appending to a used core would
            # duplicate its state)
            from fmda_tpu_torch.stream.native_join import NativeJoinCore

            fc = self.features
            self._core = NativeJoinCore(
                fc.floor_s, fc.join_tolerance_s, fc.watermark_s,
                len(self._stream_topics))
            for idx, (topic, buf) in enumerate(self._side_streams.items()):
                for e in buf.events:
                    self._core.add_side(idx, e.ts)
                if buf.max_ts >= 0:
                    self._core.force_max_ts(idx, buf.max_ts)
            for e in self._pending_deep:
                self._core.add_deep(e.ts)
