"""Batched Predictor serving: the window-re-scan path on the fleet runtime,
as ``fmda_tpu.runtime.predictor_pool`` defines it.

The Predictor is stateless per request, so the micro-batcher serves it
directly: no slot pool, no carried state, just bucketed
``(B, window, F)`` forwards.

- :class:`PredictorPool` — the batched forward.  It runs the *same*
  :func:`~fmda_tpu_torch.serve.predictor.make_batched_forward` the solo
  Predictor runs (normalization included, norm stats as tensors on the
  device), so a bucket-1 flush is the solo path's computation, bit for
  bit.  With ``use_ring=True`` it also keeps a **device-resident window
  ring** of the stream's newest ``window`` feature rows: when a flush's
  signals continue the stream (consecutive row positions), only the
  ``B`` new rows cross to the card and the ``(B, window, F)`` windows are
  gathered there by indexing.  The windows feed the same forward, so ring
  flushes are bit-identical to fetch flushes; a gap (a skipped or missing
  signal) falls back to the batched warehouse gather and re-seeds the
  ring, counted (``ring_hits``/``ring_misses``).

- :class:`PredictorGateway` — the serving loop: consume
  ``predict_timestamp`` signals (stale filter, the solo Predictor's
  semantics), coalesce them through the
  :class:`~fmda_tpu_torch.runtime.batcher.MicroBatcher`, replace B
  per-signal SQL lookups and window fetches with ONE
  :meth:`~fmda_tpu_torch.stream.warehouse.Warehouse.ids_for_timestamps`
  and :meth:`~fmda_tpu_torch.stream.warehouse.Warehouse.fetch_windows` per
  flush, run the batched forward through the one-deep in-flight pipeline
  (``pipeline_depth=0`` = the bit-identical serial A/B reference; the
  probabilities come home by a non-blocking copy whose event alone
  ``_complete`` waits on), and publish every flush with one
  ``publish_many``.  Missing-row and short-history signals are skipped
  with the solo path's warnings, plus counters (``missing_rows``,
  ``short_history``).  Where the reference counts compiles per bucket,
  the gateway counts kernel launches per bucket
  (:attr:`PredictorGateway.kernel_launches_by_bucket`), as the fleet
  gateway does.  Per-signal trace spans (queued/gather/dispatch/device/
  publish) tile the signal's journey when the process tracer is on; a
  signal arriving with in-band trace context gets them under a ``serve``
  span on *its* trace (the engine → serve journey), a bare sampled signal
  a ``predict`` root of its own.

:class:`~fmda_tpu_torch.runtime.metrics.RuntimeMetrics` instruments the
whole path (the ``gather`` stage prices the batched warehouse read).
"""

from __future__ import annotations

import datetime as _dt
import logging
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from fmda_tpu_torch.config import (
    DEFAULT_QUEUE_BOUND,
    TARGET_COLUMNS,
    TOPIC_PREDICT_TIMESTAMP,
    TOPIC_PREDICTION,
    ModelConfig,
)
from fmda_tpu_torch.data.normalize import NormParams
from fmda_tpu_torch.device import DeviceLike, PinnedStaging, resolve_device
from fmda_tpu_torch.obs.trace import TraceRef, default_tracer, now_ns, parse_wire
from fmda_tpu_torch.ops import thread_launches
from fmda_tpu_torch.runtime.batcher import BatcherConfig, MicroBatcher, Tick
from fmda_tpu_torch.runtime.metrics import RuntimeMetrics
from fmda_tpu_torch.runtime.session_pool import SessionHandle
from fmda_tpu_torch.serve.predictor import (
    Prediction,
    labels_over_threshold,
    load_model,
    make_batched_forward,
    prediction_message,
)
from fmda_tpu_torch.utils.timeutils import get_timezone, parse_ts

log = logging.getLogger("fmda_tpu_torch.runtime")

Tensor = torch.Tensor

#: Queued predictor requests carry no feature row (the window is gathered
#: per flush, not per submit) — one shared placeholder, never read.
_NO_ROW = np.empty(0, np.float32)


class PredictorPool:
    """The batched window-re-scan forward (+ optional device window ring).

    Stateless per request: one ``(B, window, F) -> (B, n_classes)``
    forward, run at each micro-batch bucket.  It is the solo Predictor's
    own (:func:`make_batched_forward`), so bucket-1 flushes are
    bit-identical to solo serving.
    """

    def __init__(
        self,
        model_cfg: ModelConfig,
        params: Mapping[str, Tensor],
        norm_params: NormParams,
        *,
        window: int,
        use_ring: bool = False,
        device: DeviceLike = None,
    ) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.window = window
        self.n_features = int(np.asarray(norm_params.x_min).shape[0])
        self._x_min = torch.as_tensor(
            np.asarray(norm_params.x_min, np.float32), device=self.device)
        self._x_range = torch.as_tensor(
            np.asarray(norm_params.x_max - norm_params.x_min, np.float32),
            device=self.device)
        self.model = load_model(model_cfg, params, self.device)
        # the ONE shared forward (serve/predictor.py): the solo Predictor
        # runs the same function on a (1, window, F) batch
        self._forward = make_batched_forward(self.model)
        # host -> card copies through pinned buffers
        self._staging = PinnedStaging()

        #: Device-resident window ring (``use_ring``): the newest
        #: ``window`` feature rows of the served stream, kept on the
        #: device between flushes.
        self.use_ring = use_ring
        self._ring: Optional[Tensor] = None  # (window, F) once seeded
        #: warehouse position (1-based) of the ring's newest row; 0 =
        #: unseeded (the next flush takes the fetch path and seeds it)
        self.ring_pos = 0

    def _to_device(self, key: str, x: np.ndarray) -> Tensor:
        """``x`` as float32 on the pool's device (on a card by one pinned,
        non-blocking copy into the device buffer of ``key``, which the next
        call with that key rewrites); the caller may reuse ``x`` once this
        returns."""
        return self._staging.to_device(
            key, (np.asarray(x, np.float32),), self.device)[0]

    # -- the hot path -------------------------------------------------------

    def forward_device(self, x) -> Tensor:
        """One bucketed flush, without waiting for the card: ``x``
        (B, window, F) → the (B, n_classes) sigmoid probabilities as a
        device tensor.  Padded lanes compute garbage the caller slices
        off."""
        if not isinstance(x, Tensor):
            x = self._to_device("windows", x)
        return self._forward(self._x_min, self._x_range, x)

    def forward(self, x) -> np.ndarray:
        """Blocking :meth:`forward_device` (direct callers and tests)."""
        return self.forward_device(x).float().cpu().numpy()

    # -- the device window ring ---------------------------------------------

    def seed_ring(self, last_window: np.ndarray, row_id: int) -> None:
        """(Re-)seed the ring from a host-fetched window ending at
        warehouse position ``row_id`` — the fetch path does this on every
        flush so the *next* consecutive flush can take the ring path."""
        self._ring = self._to_device(
            "ring", np.array(last_window, np.float32))
        self.ring_pos = int(row_id)

    def ring_forward_device(
        self, rows: np.ndarray, n_valid: int, last_row_id: int
    ) -> Tensor:
        """Ring-path flush: append ``n_valid`` consecutive new rows
        (``rows`` is bucket-padded, padding zeroed), gather the windows on
        the device, and run the same forward the fetch path runs: the same
        row values, the same bits.

        Lane i's window is rows ``i+1 .. i+window`` of ring ++ rows
        (garbage for padded lanes, sliced off by the caller); the new ring
        is the last ``window`` *real* rows, so padding never enters it."""
        if self._ring is None:
            raise RuntimeError("ring not seeded; take the fetch path first")
        with torch.inference_mode():
            buf = torch.cat([self._ring, self._to_device("rows", rows)])
            bucket, w = rows.shape[0], self.window
            idx = (torch.arange(1, w + 1, device=self.device)[None, :]
                   + torch.arange(bucket, device=self.device)[:, None])
            x = buf[idx]  # (bucket, window, F)
            self._ring = buf[n_valid:n_valid + w].clone()
        self.ring_pos = int(last_row_id)
        return self.forward_device(x)


@dataclass
class _InFlight:
    """A dispatched-but-unconsumed flush: the handle to its probabilities'
    copy plus what ``_complete`` needs to publish them."""

    live: List[Tick]
    probs: object  # PinnedStaging.to_host's handle
    #: perf_counter_ns stamps of the dispatch window (0 when untraced)
    t_gather_ns: int = 0
    t_dispatch_ns: int = 0
    t_dispatched_ns: int = 0


class PredictorGateway:
    """Multiplexes predict-timestamp signals onto bucketed batched
    forwards — the window-re-scan Predictor as a fleet citizen."""

    #: Log every Nth shed (counter is the source of truth).
    SHED_LOG_EVERY = 1000

    def __init__(
        self,
        pool: PredictorPool,
        bus,
        warehouse,
        *,
        batcher_config: Optional[BatcherConfig] = None,
        queue_bound: int = DEFAULT_QUEUE_BOUND,
        metrics: Optional[RuntimeMetrics] = None,
        clock: Callable[[], float] = time.monotonic,
        signal_topic: str = TOPIC_PREDICT_TIMESTAMP,
        prediction_topic: str = TOPIC_PREDICTION,
        threshold: float = 0.5,
        y_fields: Tuple[str, ...] = TARGET_COLUMNS,
        from_end: bool = True,
        max_staleness_s: Optional[int] = 4 * 60,
        timezone: str = "US/Eastern",
        now_fn: Optional[Callable[[], _dt.datetime]] = None,
        pipeline_depth: int = 1,
    ) -> None:
        if queue_bound < 1:
            raise ValueError(f"queue_bound must be >= 1, got {queue_bound}")
        if pipeline_depth not in (0, 1):
            raise ValueError(
                f"pipeline_depth must be 0 (serial) or 1 (one-deep "
                f"overlap), got {pipeline_depth}")
        if bus is not None and prediction_topic not in bus.topics():
            # fail at construction, not mid-flush (a publish KeyError
            # after dispatch would lose the whole flush's results)
            raise ValueError(
                f"bus has no topic {prediction_topic!r} (configured: "
                f"{sorted(bus.topics())})")
        self.pool = pool
        self.bus = bus
        self.warehouse = warehouse
        self.queue_bound = queue_bound
        self.metrics = metrics or RuntimeMetrics()
        self.clock = clock
        self.prediction_topic = prediction_topic
        self.threshold = threshold
        self.y_fields = tuple(y_fields)
        self.max_staleness_s = max_staleness_s
        #: 1 = one-deep overlap pipeline; 0 = strictly serial flushes
        #: (the bit-identical A/B reference, CLI ``--serial``).
        self.pipeline_depth = pipeline_depth
        # staleness clock: exchange-local, exactly the solo Predictor's
        # (signal timestamps are naive exchange-local strings)
        if now_fn is None:
            tz = get_timezone(timezone)

            def now_fn():
                return _dt.datetime.now(tz).replace(tzinfo=None)

        self.now_fn = now_fn
        self._consumer = (
            bus.consumer(signal_topic, from_end=from_end)
            if bus is not None else None)
        self.batcher = MicroBatcher(batcher_config, clock=clock)
        # signals are stateless one-shots: every request is its own
        # "session" for the batcher's bookkeeping, keyed by a
        # monotonically increasing synthetic slot (no two requests ever
        # collide, so every flush takes the lockstep fast path)
        self._next_slot = 0
        # per-bucket staging, two (windows, rows) pairs a bucket
        # alternating (a one-deep pipeline has at most one earlier flush
        # in flight)
        self._staging: Dict[int, list] = {}
        self._staging_idx: Dict[int, int] = {}
        self._to_host = PinnedStaging()
        #: kernel launches by flush bucket (the port's counterpart of the
        #: reference's compiles per bucket; 0 on the CPU, where the
        #: kernels' plain versions run)
        self.kernel_launches_by_bucket: Dict[int, int] = {}
        self._publish_many = (
            getattr(bus, "publish_many", None) if bus is not None else None)
        #: the cross-pump in-flight flush (None when pipeline_depth == 0)
        self._inflight: Optional[_InFlight] = None
        self._ids_for = getattr(warehouse, "ids_for_timestamps", None)
        self._fetch_windows = getattr(warehouse, "fetch_windows", None)
        #: span recorder: the process-default tracer, captured once
        self._tracer = default_tracer()

    # -- the request path ---------------------------------------------------

    def _is_stale(self, ts_str: str) -> bool:
        if self.max_staleness_s is None:
            return False
        age = (self.now_fn() - parse_ts(ts_str)).total_seconds()
        return age > self.max_staleness_s

    def submit(self, ts_str: str, wire: Optional[str] = None) -> None:
        """Enqueue a predict-timestamp signal.  ``wire`` is the signal's
        in-band trace context, carried onto the prediction message and
        used as the span parent.  Overload sheds the oldest queued signal (counted + heartbeat-
        logged) — stale market signals are the cheapest thing to lose."""
        while len(self.batcher) >= self.queue_bound:
            shed = self.batcher.shed_oldest()
            self.metrics.count("shed_oldest")
            n = self.metrics.counters["shed_oldest"]
            if n == 1 or n % self.SHED_LOG_EVERY == 0:
                log.warning(
                    "signal queue full (bound=%d): shed oldest (%s); "
                    "%d shed so far",
                    self.queue_bound, shed.handle.session_id, n)
        ref = None
        if self._tracer.enabled:  # one branch when tracing is off
            if wire is None:
                # a bare signal may become its own sampled root
                ref = self._tracer.maybe_trace()
            else:
                ctx = parse_wire(wire)
                if ctx is not None:
                    # ride the signal's journey: serve spans parent on
                    # the publisher's span, t0 stamps the serve start
                    ref = TraceRef(ctx[0], ctx[1], now_ns())
        slot, self._next_slot = self._next_slot, self._next_slot + 1
        self.batcher.add(Tick(
            handle=SessionHandle(ts_str, slot, 0), row=_NO_ROW,
            t_enqueue=self.clock(), trace=ref, wire=wire))
        self.metrics.gauge("queue_depth", len(self.batcher))

    @property
    def saturated(self) -> bool:
        """Backpressure signal: the next submit will shed."""
        return len(self.batcher) >= self.queue_bound

    # -- the serving loop ---------------------------------------------------

    def poll(self) -> List[Prediction]:
        """Serve every new signal on the bus: stale-filter (solo
        semantics, plus a ``stale_signals`` counter), batch, flush.
        Returns the predictions made — the solo :meth:`Predictor.poll`'s
        contract."""
        for rec in self._consumer.poll():
            ts = rec.value.get("Timestamp")
            if not ts:
                log.warning(
                    "signal without Timestamp at offset %d", rec.offset)
                continue
            if self._is_stale(ts):
                log.warning("dropping stale signal %s", ts)
                self.metrics.count("stale_signals")
                continue
            self.submit(ts, wire=rec.value.get("trace"))
        return self.pump(force=True)

    def pump(self, *, force: bool = False) -> List[Prediction]:
        """Flush ready micro-batches (all pending when ``force``).
        Consecutive flushes run through the one-deep overlap pipeline —
        flush k+1's gather and launches run while flush k's probabilities
        come home and publish — persisting across calls exactly like the
        fleet gateway's (``pump`` returns predictions *completed* this
        call; ``force`` completes everything)."""
        results: List[Prediction] = []
        dispatched_any = False
        try:
            while True:
                if force:
                    if not len(self.batcher):
                        break
                elif not self.batcher.ready(self.clock()):
                    break
                ticks = self.batcher.take_batch()
                if not ticks:
                    break
                nxt = self._dispatch(ticks)
                if nxt is not None:
                    dispatched_any = True
                # hand the previous flush off BEFORE completing it, so a
                # completion failure can never strand the new dispatch
                prev, self._inflight = self._inflight, nxt
                if prev is not None:
                    if nxt is not None:
                        self.metrics.count("overlapped_flushes")
                    results.extend(self._complete_counted(prev))
                if self.pipeline_depth == 0 and self._inflight is not None:
                    prev, self._inflight = self._inflight, None
                    results.extend(self._complete_counted(prev))
            if self._inflight is not None and (force or not dispatched_any):
                prev, self._inflight = self._inflight, None
                results.extend(self._complete_counted(prev))
        except BaseException:
            # an in-flight flush's results must still publish on unwind
            # (and a second failure is counted, never silent)
            if self._inflight is not None:
                prev, self._inflight = self._inflight, None
                try:
                    self._complete_counted(prev)
                except Exception:  # noqa: BLE001 — loss-free: double
                    # fault while unwinding; the flush's signals were
                    # counted lost by _complete_counted, and the original
                    # failure is re-raised below
                    log.exception(
                        "in-flight flush lost while unwinding pump failure")
            raise
        finally:
            self.metrics.gauge("queue_depth", len(self.batcher))
        return results

    def drain(self) -> List[Prediction]:
        """Serve everything still queued (shutdown / end of load)."""
        return self.pump(force=True)

    def _complete_counted(self, inflight: _InFlight) -> List[Prediction]:
        try:
            return self._complete(inflight)
        except Exception:
            self.metrics.count("flush_results_lost", len(inflight.live))
            raise

    # -- flush stages -------------------------------------------------------

    def _staging_for(self, bucket: int):
        """The next (windows, rows, parity) staging for ``bucket`` —
        allocated once, alternating between two parities."""
        bufs = self._staging.get(bucket)
        if bufs is None:
            w, f = self.pool.window, self.pool.n_features
            bufs = [
                (np.zeros((bucket, w, f), np.float32),
                 np.zeros((bucket, f), np.float32))
                for _ in range(2)
            ]
            self._staging[bucket] = bufs
            self._staging_idx[bucket] = 0
        idx = self._staging_idx[bucket]
        self._staging_idx[bucket] = 1 - idx
        return (*bufs[idx], idx)

    def _lookup_ids(self, ts_list: List[str]) -> List[Optional[int]]:
        if self._ids_for is not None:
            return self._ids_for(ts_list)  # ONE query for the flush
        # a warehouse without the batched API: the per-signal path still
        # works, without the batching win
        return [self.warehouse.id_for_timestamp(ts) for ts in ts_list]

    def _gather_ids(
        self, ticks: List[Tick], window: int
    ) -> Tuple[List[Tick], List[int]]:
        """Batched id lookup + the solo path's skip semantics: unknown
        timestamps and short-history rows are warned and counted, never
        fatal to the flush's other signals."""
        ts_list = [t.handle.session_id for t in ticks]
        row_ids = self._lookup_ids(ts_list)
        live: List[Tick] = []
        live_ids: List[int] = []
        for tick, rid in zip(ticks, row_ids):
            if rid is None:
                log.warning("no warehouse row for signal %s",
                            tick.handle.session_id)
                self.metrics.count("missing_rows")
            elif rid < window:
                log.warning(
                    "row %d at %s has <%d rows of history; skipping",
                    rid, tick.handle.session_id, window)
                self.metrics.count("short_history")
            else:
                live.append(tick)
                live_ids.append(rid)
        return live, live_ids

    def _gather_rows(
        self, live_ids: List[int], windows_staging, rows_staging,
        window: int,
    ) -> bool:
        """Fill the flush's staging: the ring path (the flush continues
        the stream — consecutive positions right after the ring's newest
        row; fetch only the B new rows) or the batched full-window gather
        (which (re-)seeds the ring).  Returns whether the ring path was
        taken."""
        n = len(live_ids)
        ring_hit = (
            self.pool.use_ring
            and self.pool.ring_pos == live_ids[0] - 1
            and live_ids == list(range(live_ids[0], live_ids[0] + n))
        )
        if ring_hit:
            rows_staging[:n] = self.warehouse.fetch(
                range(live_ids[0], live_ids[-1] + 1))
            rows_staging[n:] = 0.0
            self.metrics.count("ring_hits")
        else:
            windows = (
                self._fetch_windows(live_ids, window)
                if self._fetch_windows is not None
                else np.stack([
                    self.warehouse.fetch(range(rid - window + 1, rid + 1))
                    for rid in live_ids
                ]))
            windows_staging[:n] = windows
            if self.pool.use_ring:
                self.pool.seed_ring(windows[-1], live_ids[-1])
                self.metrics.count("ring_misses")
        return ring_hit

    def _dispatch(self, ticks: List[Tick]) -> Optional[_InFlight]:
        """Stage 1 of a flush: batched id lookup + window gather (or the
        device-ring append), then the bucketed forward on the card and
        its probabilities' copy home.  Returns None when every signal was
        skipped (missing row/short history — the solo path's warnings,
        plus counters) or when the warehouse read failed (the batched
        analogue of the solo poll()'s per-signal error isolation: the
        flush's signals are dropped, counted, and serving goes on)."""
        tracing = self._tracer.enabled
        t_gather = self.clock()
        t_gather_ns = now_ns() if tracing else 0
        window = self.pool.window
        with self.metrics.timer.stage("gather"):
            try:
                live, live_ids = self._gather_ids(ticks, window)
                if not live:
                    return None
                bucket = self.batcher.bucket_for(len(live))
                windows_staging, rows_staging, parity = self._staging_for(
                    bucket)
                n = len(live)
                ring_hit = self._gather_rows(
                    live_ids, windows_staging, rows_staging, window)
            except Exception:  # noqa: BLE001 — a warehouse failure
                # mid-flush must not abort the poll/pump loop (a batched
                # read cannot name the failing signal)
                self.metrics.count("gather_errors")
                self.metrics.count("signals_dropped_on_error", len(ticks))
                log.exception(
                    "batched warehouse gather failed; dropping %d "
                    "queued signal(s) and continuing", len(ticks))
                return None
        t_dispatch = self.clock()
        t_dispatch_ns = now_ns() if tracing else 0
        with self.metrics.timer.stage("dispatch"):
            launched = thread_launches()
            if ring_hit:
                probs_dev = self.pool.ring_forward_device(
                    rows_staging, n, live_ids[-1])
            else:
                probs_dev = self.pool.forward_device(windows_staging)
            probs = self._to_host.to_host(probs_dev.float(), (bucket, parity))
            self.kernel_launches_by_bucket[bucket] = (
                self.kernel_launches_by_bucket.get(bucket, 0)
                + thread_launches() - launched)
        t_dispatched = self.clock()
        t_dispatched_ns = now_ns() if tracing else 0

        m = self.metrics
        m.count("flushes")
        m.count(f"flushes_bucket_{bucket}")
        m.count("padded_lanes", bucket - n)
        m.observe("gather", t_dispatch - t_gather)
        m.observe("dispatch", t_dispatched - t_dispatch)
        for tick in live:
            m.observe("enqueue_to_dispatch", t_gather - tick.t_enqueue)
        return _InFlight(
            live=live, probs=probs, t_gather_ns=t_gather_ns,
            t_dispatch_ns=t_dispatch_ns, t_dispatched_ns=t_dispatched_ns)

    def _complete(self, inflight: _InFlight) -> List[Prediction]:
        """Stage 2: wait for the probabilities' copy, threshold labels,
        publish the whole flush in one batched bus call."""
        tracing = self._tracer.enabled
        t_synced = self.clock()
        with self.metrics.timer.stage("device"):
            probs = PinnedStaging.wait(inflight.probs)
        t_device = self.clock()
        t_device_ns = now_ns() if tracing else 0

        results: List[Prediction] = []
        messages = [] if self.bus is not None else None
        t_pub0_ns = 0
        with self.metrics.timer.stage("publish"):
            for i, tick in enumerate(inflight.live):
                p = probs[i]
                idx, labels = labels_over_threshold(
                    p, self.threshold, self.y_fields)
                pred = Prediction(
                    timestamp=tick.handle.session_id,
                    probabilities=tuple(float(v) for v in p),
                    threshold=self.threshold,
                    labels=labels,
                    label_indices=idx,
                )
                results.append(pred)
                if messages is not None:
                    # in-band context propagates onward: the signal's own
                    # wire when it arrived with one, this tick's sampled
                    # root otherwise
                    wire = tick.wire if tick.wire is not None else (
                        tick.trace.wire if tick.trace is not None else None)
                    messages.append(prediction_message(pred, wire))
            if messages:
                t_pub0_ns = now_ns() if tracing else 0
                if self._publish_many is not None:
                    self._publish_many(self.prediction_topic, messages)
                else:
                    for msg in messages:
                        self.bus.publish(self.prediction_topic, msg)
        t_publish = self.clock()

        m = self.metrics
        m.count("signals_served", len(results))
        m.observe("device", t_device - t_synced)
        m.observe("publish", t_publish - t_device)
        for tick in inflight.live:
            m.observe("total", t_publish - tick.t_enqueue)
        if tracing:
            self._record_flush_spans(inflight, t_device_ns, t_pub0_ns)
        return results

    def _record_flush_spans(
        self, inflight: _InFlight, t_device_ns: int, t_pub0_ns: int
    ) -> None:
        """Close every traced signal in a completed flush: queued /
        gather / dispatch / device / publish children tiling the serve
        journey.  Signals with in-band context get the children under a
        ``serve`` span on their own trace; bare sampled signals get their
        own root, closed via ``finish_root`` so they feed
        ``e2e_tick_seconds``."""
        if not inflight.t_gather_ns:
            return  # dispatched before tracing was enabled
        tr = self._tracer
        t_publish_ns = now_ns()
        for tick in inflight.live:
            ref = tick.trace
            if ref is None:
                continue
            tid = ref.trace_id
            if tick.wire is not None:
                parent = tr.add_span(tid, ref.span_id, "serve", "serve",
                                     ref.t0_ns, t_publish_ns)
            else:
                parent = ref.span_id
            tr.add_span(tid, parent, "queued", "gateway",
                        ref.t0_ns, inflight.t_gather_ns)
            tr.add_span(tid, parent, "gather", "warehouse",
                        inflight.t_gather_ns, inflight.t_dispatch_ns)
            tr.add_span(tid, parent, "dispatch", "gateway",
                        inflight.t_dispatch_ns, inflight.t_dispatched_ns)
            tr.add_span(tid, parent, "device", "pool",
                        inflight.t_dispatched_ns, t_device_ns)
            pub = tr.add_span(tid, parent, "publish", "publish",
                              t_device_ns, t_publish_ns)
            if t_pub0_ns:
                tr.add_span(tid, pub, "bus_publish", "bus",
                            t_pub0_ns, t_publish_ns)
            if tick.wire is None:
                tr.finish_root(ref, "predict", "serve", t_publish_ns)
