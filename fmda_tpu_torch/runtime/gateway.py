"""Admission-control front door: bounded queue → micro-batcher → pool → bus,
as ``fmda_tpu.runtime.gateway`` defines it.

One :class:`FleetGateway` owns the serving loop for a fleet of sessions:

- ``open_session``/``close_session`` — admission control against the
  slot pool (a full pool **rejects loudly**, it never queues forever);
- ``submit`` — enqueue a session's newest row behind a **bounded** queue;
  overload sheds the *oldest* queued tick with a counted metric
  (``shed_oldest``) — stale market data is the cheapest thing to lose,
  and an unbounded queue is how serving systems die;
- ``pump`` — flush micro-batches whenever the batcher says so
  (batch-full or deadline), run the one pool step, and publish each
  session's result on the bus (``fleet_prediction`` topic, ``session``
  field keying per-session consumption).

**The overlap pipeline.**  Dispatching a flush and consuming its results
are split into :meth:`FleetGateway._dispatch` (stale filter, staging
assembly, ``SessionPool.step_device`` on the card's stream, and a
non-blocking copy of the probabilities into pinned host memory with an
event recorded behind it) and :meth:`FleetGateway._complete` (a wait on
that event alone, label thresholding, one batched bus publish).  ``pump``
runs them one flush apart: while flush k's probabilities come home and
fan out to the bus, flush k+1 is already queued on the card.  The
pipeline persists across ``pump`` calls, so ``pump`` returns every result
*completed* this call; the trailing flush's results arrive on the next
``pump`` (an idle pump flushes the pipeline) or on :meth:`drain`.
``pipeline_depth=0`` forces strictly serial same-call results, the
bit-identical A/B reference.  Batch assembly writes into per-bucket
staging buffers, two of each (a one-deep pipeline has at most one earlier
flush whose buffers may still be in use), and so does the host side of
the probabilities' copy.

Every tick's journey is measured (enqueue→dispatch→device→publish
histograms in :class:`~fmda_tpu_torch.runtime.metrics.RuntimeMetrics`);
every loss path is a counter, never a silent drop.  Under overlap,
``device`` measures the time ``_complete`` spends *blocked* on the copy:
device work that overlapped hides inside the preceding ``dispatch`` and
``publish`` wall clock, which is the point.

**Swaps from another thread.**  :meth:`FleetGateway.hot_swap` may be
called from another thread than the one that pumps (the continuous
trainer publishes from its own): one lock serialises it against
:meth:`FleetGateway.pump`, so a flush is completed and published exactly
once, whichever thread completes it, and the version a result carries
never goes down.

**Tracing.**  When the process tracer (:mod:`fmda_tpu_torch.obs.trace`)
is enabled, a sampled tick gets a root span begun at :meth:`submit` and
four children that tile it: ``queued`` (submit to dispatch), ``dispatch``
(assembly and the card's enqueue), ``device`` (the wait for the copy
home) and ``publish`` (with the bus publish under it), closed at publish;
the result message carries the tick's ``trace`` context in-band.  A tick
that arrives with a context (``wire``) gets its children under a
``serve`` span on that trace instead.  With tracing off, :meth:`submit`
and a flush pay one attribute check each.  ``annotate_device_steps``
wraps each flush's pool step in a numbered ``pool_flush`` range for
:func:`fmda_tpu_torch.utils.tracing.device_trace`.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from fmda_tpu_torch.config import (
    DEFAULT_QUEUE_BOUND,
    TARGET_COLUMNS,
    TOPIC_FLEET_PREDICTION,
)
from fmda_tpu_torch.data.normalize import NormParams
from fmda_tpu_torch.device import PinnedStaging
from fmda_tpu_torch.obs.trace import TraceRef, default_tracer, now_ns, parse_wire
from fmda_tpu_torch.ops import thread_launches
from fmda_tpu_torch.runtime.batcher import BatcherConfig, MicroBatcher, Tick
from fmda_tpu_torch.runtime.metrics import RuntimeMetrics
from fmda_tpu_torch.runtime.session_pool import (
    PoolExhausted,
    SessionHandle,
    SessionPool,
)
from fmda_tpu_torch.serve.predictor import labels_over_threshold
from fmda_tpu_torch.stream import codec

log = logging.getLogger("fmda_tpu_torch.runtime")


@dataclass(frozen=True)
class FleetResult:
    """One served tick: the probabilities for one session's newest row."""

    session_id: str
    seq: int
    probabilities: np.ndarray
    labels: Tuple[str, ...]
    #: checkpoint generation that served this tick — None before the
    #: first hot swap
    weights_version: Optional[int] = None


@dataclass
class _InFlight:
    """A dispatched-but-unconsumed flush: the handle to its probabilities'
    copy plus everything ``_complete`` needs to publish them."""

    live: List[Tick]
    probs: object  # PinnedStaging.to_host's handle
    #: perf_counter_ns stamps of the dispatch window (0 when untraced):
    #: the queued/dispatch span boundaries of this flush's traced ticks
    t_dispatch_ns: int = 0
    t_dispatched_ns: int = 0


class FleetGateway:
    """Multiplexes many ticker sessions onto one batched serving step."""

    #: Log every Nth shed (the counter is the source of truth; the log is
    #: a human-visible heartbeat that shedding is happening).
    SHED_LOG_EVERY = 1000

    def __init__(
        self,
        pool: SessionPool,
        bus=None,
        *,
        batcher_config: Optional[BatcherConfig] = None,
        queue_bound: int = DEFAULT_QUEUE_BOUND,
        metrics: Optional[RuntimeMetrics] = None,
        clock: Callable[[], float] = time.monotonic,
        prediction_topic: str = TOPIC_FLEET_PREDICTION,
        threshold: float = 0.5,
        y_fields: Tuple[str, ...] = TARGET_COLUMNS,
        pipeline_depth: int = 1,
    ) -> None:
        if queue_bound < 1:
            raise ValueError(f"queue_bound must be >= 1, got {queue_bound}")
        if pipeline_depth not in (0, 1):
            raise ValueError(
                f"pipeline_depth must be 0 (serial) or 1 (one-deep "
                f"overlap), got {pipeline_depth}")
        if bus is not None and prediction_topic not in bus.topics():
            # fail at construction, not mid-flush: a publish KeyError
            # after the pool step would lose results whose state advance
            # is irreversible
            raise ValueError(
                f"bus has no topic {prediction_topic!r} (configured: "
                f"{sorted(bus.topics())}); add it to bus.topics — the "
                "default layout includes it as TOPIC_FLEET_PREDICTION")
        self.pool = pool
        self.bus = bus
        self.queue_bound = queue_bound
        self.metrics = metrics or RuntimeMetrics()
        self.clock = clock
        self.prediction_topic = prediction_topic
        self.threshold = threshold
        self.y_fields = tuple(y_fields)
        #: 1 = one-deep overlap pipeline (default); 0 = serial flushes
        #: (the A/B reference the bit-identity checks compare against).
        self.pipeline_depth = pipeline_depth
        self.batcher = MicroBatcher(batcher_config, clock=clock)
        self._seq: Dict[str, int] = {}
        #: per-session tenant labels (None entries never stored); rides
        #: export/import so a migrated session keeps its class
        self._tenant: Dict[str, str] = {}
        #: per-tenant QoS policy (anything with ``classify``, ``quota``
        #: and ``pick_victim``); None = global oldest-drop shedding
        self.qos = None
        #: queued ticks per priority class, kept only while a policy is
        #: attached
        self._queued_by_class: Dict[str, int] = {}
        # per-bucket staging for batch assembly, two (slots, rows) pairs
        # a bucket alternating: with a one-deep pipeline at most one
        # earlier flush can be in flight, and its completion always
        # precedes reusing the same parity
        self._staging: Dict[int, list] = {}
        self._staging_idx: Dict[int, int] = {}
        self._to_host = PinnedStaging()
        self._publish_many = (
            getattr(bus, "publish_many", None) if bus is not None else None)
        #: the cross-pump in-flight flush (the persistent one-deep
        #: pipeline; always None when pipeline_depth == 0)
        self._inflight: Optional[_InFlight] = None
        #: publish whole flushes as columnar ``result_block`` messages
        #: (:func:`fmda_tpu_torch.stream.codec.pack_results`) instead of
        #: per-tick dicts.  Off by default: only a consumer that
        #: understands blocks may turn this on.
        self.result_blocks = False
        #: checkpoint generation serving the pool — None until the first
        #: :meth:`hot_swap`; stamped into every result afterwards
        self.weights_version: Optional[int] = None
        #: results completed by a hot-swap barrier outside pump — handed
        #: to the caller on the next pump/drain
        self._barrier_results: List[FleetResult] = []
        #: served-tick counts keyed by the weights_version that served
        #: them (0 = pre-swap)
        self._version_ticks: Dict[int, int] = {}
        #: kernel launches by flush bucket (the port's counterpart of the
        #: reference's compiles per bucket; 0 on the CPU, where the
        #: kernels' plain versions run): the dispatching thread's own, so
        #: a trainer launching from another thread books none here
        self.kernel_launches_by_bucket: Dict[int, int] = {}
        #: serialises pump and hot_swap: a swap may come from another
        #: thread than the pumping one
        self._lock = threading.RLock()
        #: span recorder: the process-default tracer, captured once;
        #: disabled = one branch a submit and a flush
        self._tracer = default_tracer()
        #: wrap each flush's pool step in a numbered ``pool_flush`` range
        #: (``serve-fleet --jax-profile``)
        self.annotate_device_steps = False
        self._flush_idx = 0

    # -- admission ----------------------------------------------------------

    def open_session(
        self, session_id: str, norm: Optional[NormParams] = None,
        *, seq: int = 0, tenant: Optional[str] = None,
    ) -> SessionHandle:
        """Admit a session (raises :class:`PoolExhausted` when the fleet
        is full — counted, so rejected admissions show on dashboards).
        ``seq`` starts the session's result sequence above 0; ``tenant``
        is the session's priority-class label."""
        try:
            handle = self.pool.alloc(session_id, norm)
        except PoolExhausted:
            # only capacity rejections count here — a duplicate-id
            # ValueError is a client bug, not a fleet-is-full signal
            self.metrics.count("rejected_sessions")
            raise
        if seq:
            self._seq[session_id] = int(seq)
        if tenant is not None:
            self._tenant[session_id] = str(tenant)
        self._sessions_changed()
        return handle

    def close_session(self, session_id: str) -> None:
        handle = self.pool.handle_for(session_id)
        if handle is None:
            raise KeyError(f"no open session {session_id!r}")
        self.pool.free(handle)
        self._seq.pop(session_id, None)
        self._tenant.pop(session_id, None)
        self._sessions_changed()

    def session_tenant(self, session_id: str) -> Optional[str]:
        """The session's tenant label (None when opened unlabeled)."""
        return self._tenant.get(session_id)

    # -- control-plane hooks ------------------------------------------------

    def attach_qos(self, policy) -> None:
        """Install a per-tenant QoS policy: admission bookkeeping turns on
        and overload shedding becomes fair-share + quota based (see
        :meth:`submit`).  Detach with ``None`` to restore global
        oldest-drop."""
        self.qos = policy
        self._queued_by_class = {}

    def retune(
        self, *, max_linger_ms: Optional[float] = None,
        bucket_cap: Optional[int] = None,
    ) -> None:
        """Swap the batching knobs at runtime: the frozen config is
        replaced at once, and the bucket cap only ever selects a
        configured bucket."""
        if max_linger_ms is not None:
            self.batcher.config = dataclasses.replace(
                self.batcher.config, max_linger_s=max_linger_ms / 1e3)
        self.batcher.bucket_cap = bucket_cap
        self.metrics.count("retunes_applied")

    @property
    def version_ticks(self) -> Dict[int, int]:
        """Served ticks per weights_version (0 = pre-swap)."""
        return dict(self._version_ticks)

    def hot_swap(self, params, *, version: Optional[int] = None) -> int:
        """Land a new checkpoint into the live pool with no session
        dropped.

        The one ordering obligation is the **swap barrier**: a flush
        dispatched under the old weights must publish before the version
        flips, or an old-weights result would carry the new stamp.  So
        the in-flight flush (if any) is completed here, its results
        published under the old version; everything still queued in the
        batcher dispatches after the rebind and is served by the new
        weights.  Returns the new ``weights_version`` (``version`` when
        given, else bumped from 1).  Safe from any thread: it waits for a
        pump in progress to return."""
        with self._lock:
            if self._inflight is not None:
                prev, self._inflight = self._inflight, None
                self._barrier_results.extend(self._complete_counted(prev))
            self.pool.swap_weights(params)
            self.weights_version = (
                int(version) if version is not None
                else (self.weights_version or 0) + 1)
            self.metrics.count("hot_swaps_applied")
            self.metrics.gauge("weights_version",
                               float(self.weights_version))
            return self.weights_version

    def _sessions_changed(self) -> None:
        self.metrics.gauge("active_sessions", self.pool.n_active)
        # when every active session is already pending a flush cannot
        # grow — tell the batcher so small fleets don't wait out the
        # linger on every steady-state flush
        self.batcher.full_target = self.pool.n_active

    # -- session migration --------------------------------------------------

    def export_session(self, session_id: str) -> dict:
        """Snapshot a session for migration: its pooled carried state
        (:meth:`SessionPool.export_slot`) plus the gateway's per-session
        sequence counter, so the new owner's results continue the same
        ``seq`` stream.  Caller contract: the session's queued ticks are
        already flushed (``drain``)."""
        handle = self.pool.handle_for(session_id)
        if handle is None:
            raise KeyError(f"no open session {session_id!r}")
        state = self.pool.export_slot(handle)
        state["seq"] = self._seq.get(session_id, 0)
        tenant = self._tenant.get(session_id)
        if tenant is not None:
            state["tenant"] = tenant
        return state

    def session_seq(self, session_id: str) -> int:
        """The next result sequence number of an open session."""
        if self.pool.handle_for(session_id) is None:
            raise KeyError(f"no open session {session_id!r}")
        return self._seq.get(session_id, 0)

    def resync_seq(self, session_id: str, seq: int) -> None:
        """Jump a session's sequence counter (after ticks were lost in
        transit the streams diverge by the loss count); the caller counts
        the divergence."""
        if self.pool.handle_for(session_id) is None:
            raise KeyError(f"no open session {session_id!r}")
        self._seq[session_id] = int(seq)

    def import_session(self, session_id: str, state: dict) -> SessionHandle:
        """Open a session from an :meth:`export_session` snapshot:
        allocates a slot, loads the carried state bit-exact, and resumes
        the sequence counter."""
        handle = self.open_session(session_id, tenant=state.get("tenant"))
        try:
            self.pool.import_slot(handle, state)
        except Exception:
            # a malformed snapshot must not leak the slot it claimed
            self.pool.free(handle)
            self._tenant.pop(session_id, None)
            self._sessions_changed()
            raise
        self._seq[session_id] = int(state.get("seq", 0))
        return handle

    # -- the request path ---------------------------------------------------

    def submit(
        self, session_id: str, row: np.ndarray,
        wire: Optional[str] = None,
    ) -> int:
        """Enqueue a session's newest feature row; returns the tick's
        per-session sequence number.  Overload sheds the oldest queued
        tick (counted + heartbeat-logged), never blocks, never grows the
        queue past ``queue_bound``.  ``wire`` is in-band trace context,
        carried onto the published result; with tracing on, the flush's
        spans go under a ``serve`` span on that trace instead of a root of
        their own."""
        handle = self.pool.handle_for(session_id)
        if handle is None:
            raise KeyError(f"no open session {session_id!r}")
        row = np.array(row, np.float32)  # copy: the queue must own rows
        if row.shape != (self.pool.cfg.n_features,):
            # reject at the submitter — a malformed row reaching a flush
            # would throw there and lose the batch's other ticks
            raise ValueError(
                f"row shape {row.shape} != ({self.pool.cfg.n_features},) "
                f"for session {session_id!r}")
        cls = None
        if self.qos is not None:
            # per-tenant quota: a class at its queue-share budget sheds
            # its own oldest tick to admit the new one
            cls = self.qos.classify(self._tenant.get(session_id))
            quota = self.qos.quota(cls, self.queue_bound)
            while self._queued_by_class.get(cls, 0) >= quota:
                shed = self.batcher.shed_matching(
                    lambda t: self._class_of(t) == cls)
                if shed is None:
                    break
                self.metrics.count("quota_shed")
                self.metrics.count(f"shed_class_{cls}")
                self._class_dec(cls)
        while len(self.batcher) >= self.queue_bound:
            shed = None
            if self.qos is not None:
                # fair-share shedding: the class furthest over its
                # weighted share loses its oldest tick
                vcls = self.qos.pick_victim(self._queued_by_class)
                if vcls is not None:
                    shed = self.batcher.shed_matching(
                        lambda t: self._class_of(t) == vcls)
            if shed is None:
                shed = self.batcher.shed_oldest()
            self.metrics.count("shed_oldest")
            if self.qos is not None and shed is not None:
                scls = self._class_of(shed)
                self.metrics.count(f"shed_class_{scls}")
                self._class_dec(scls)
            n = self.metrics.counters["shed_oldest"]
            if n == 1 or n % self.SHED_LOG_EVERY == 0:
                log.warning(
                    "queue full (bound=%d): shed oldest tick (session %s, "
                    "seq %d); %d shed so far",
                    self.queue_bound, shed.handle.session_id, shed.seq, n)
        seq = self._seq.get(session_id, 0)
        self._seq[session_id] = seq + 1
        ref = None
        if self._tracer.enabled:  # one branch when tracing is off
            if wire is None:
                # sampled: this tick's trace root, closed at publish
                ref = self._tracer.maybe_trace()
            else:
                ctx = parse_wire(wire)
                if ctx is not None:
                    # ride the sender's journey: flush spans parent on
                    # its span, t0 stamps the serve stage's start
                    ref = TraceRef(ctx[0], ctx[1], now_ns())
        self.batcher.add(Tick(
            handle=handle, row=row, t_enqueue=self.clock(), seq=seq,
            trace=ref, wire=wire))
        if self.qos is not None:
            self._queued_by_class[cls] = \
                self._queued_by_class.get(cls, 0) + 1
            self.metrics.count(f"admitted_class_{cls}")
        self.metrics.gauge("queue_depth", len(self.batcher))
        return seq

    def _class_of(self, tick: Tick) -> str:
        """A queued tick's priority class under the attached policy."""
        return self.qos.classify(self._tenant.get(tick.handle.session_id))

    def _class_dec(self, cls: str) -> None:
        n = self._queued_by_class.get(cls, 0) - 1
        if n <= 0:
            self._queued_by_class.pop(cls, None)
        else:
            self._queued_by_class[cls] = n

    @property
    def saturated(self) -> bool:
        """Backpressure signal: the next submit will shed.  Well-behaved
        producers check this and slow down instead of racing the shedder."""
        return len(self.batcher) >= self.queue_bound

    # -- the serving loop ---------------------------------------------------

    def pump(self, *, force: bool = False) -> List[FleetResult]:
        """Flush ready micro-batches (all pending ones when ``force`` —
        the drain path).  Returns every result *completed* this call;
        each is also published on the bus when one is attached.

        Consecutive flushes run through the one-deep overlap pipeline:
        flush k+1 is assembled and queued on the card *before* flush k's
        probabilities are waited for and published.  The last flush this
        call dispatches stays in flight, to be completed right after the
        *next* call's first dispatch.  A pump that dispatches nothing
        completes the pending flush, ``force`` completes everything, and
        ``pipeline_depth=0`` keeps the strictly serial same-call contract.
        """
        with self._lock:
            return self._pump_locked(force)

    def _pump_locked(self, force: bool) -> List[FleetResult]:
        results: List[FleetResult] = []
        if self._barrier_results:
            # old-weights results completed by a hot-swap barrier since
            # the last pump — already published; hand them to the caller
            results, self._barrier_results = self._barrier_results, []
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
                if self.qos is not None:
                    # ticks leave the queue only here or via shed —
                    # both decrement, so class counts stay exact
                    for t in ticks:
                        self._class_dec(self._class_of(t))
                nxt = self._dispatch(ticks)
                if nxt is not None:
                    dispatched_any = True
                # hand the previous flush off BEFORE completing it, so a
                # completion failure can never strand the just-dispatched
                # one (its state advance is already irreversible)
                prev, self._inflight = self._inflight, nxt
                if prev is not None:
                    if nxt is not None:
                        self.metrics.count("overlapped_flushes")
                    results.extend(self._complete_counted(prev))
                if self.pipeline_depth == 0 and self._inflight is not None:
                    prev, self._inflight = self._inflight, None
                    results.extend(self._complete_counted(prev))
            if self._inflight is not None and (force or not dispatched_any):
                # force-drain, or an idle pump with a leftover in-flight
                # flush from a previous call: flush the pipeline now
                prev, self._inflight = self._inflight, None
                results.extend(self._complete_counted(prev))
        except BaseException:
            # unwinding with a live in-flight flush: its pool-state
            # advance already happened, so its results must still be
            # published — and if even that fails, _complete_counted made
            # the loss a counter, never silence
            if self._inflight is not None:
                prev, self._inflight = self._inflight, None
                try:
                    self._complete_counted(prev)
                except Exception:  # noqa: BLE001 — double fault while
                    # unwinding; _complete_counted already counted the
                    # flush's ticks lost, and the original failure is
                    # re-raised below
                    log.exception(
                        "in-flight flush lost while unwinding pump failure")
            raise
        finally:
            self.metrics.gauge("queue_depth", len(self.batcher))
        return results

    def _complete_counted(self, inflight: _InFlight) -> List[FleetResult]:
        """:meth:`_complete` with the loss path counted: a completion
        failure marks its ticks ``flush_results_lost`` before
        propagating."""
        try:
            return self._complete(inflight)
        except Exception:
            self.metrics.count("flush_results_lost", len(inflight.live))
            raise

    def drain(self) -> List[FleetResult]:
        """Serve everything still queued, deadline or not (shutdown/end
        of load)."""
        return self.pump(force=True)

    def _staging_for(self, bucket: int):
        """The next (slots, rows, parity) staging for ``bucket`` —
        allocated once per bucket, alternating between two parities."""
        bufs = self._staging.get(bucket)
        if bufs is None:
            bufs = [
                (np.full(bucket, self.pool.padding_slot, np.int32),
                 np.zeros((bucket, self.pool.cfg.n_features), np.float32))
                for _ in range(2)
            ]
            self._staging[bucket] = bufs
            self._staging_idx[bucket] = 0
        idx = self._staging_idx[bucket]
        self._staging_idx[bucket] = 1 - idx
        return (*bufs[idx], idx)

    def _dispatch(self, ticks: List[Tick]) -> Optional[_InFlight]:
        """Stage 1 of a flush: stale-filter, assemble into the bucket's
        staging buffers, queue the pool step and the probabilities' copy
        home on the card.  Returns the in-flight record (None if every
        tick went stale in queue)."""
        t_dispatch = self.clock()
        tracing = self._tracer.enabled
        t_dispatch_ns = now_ns() if tracing else 0
        live = []
        for tick in ticks:
            # a session freed while its tick was queued: drop, visibly
            if self.pool.is_live(tick.handle):
                live.append(tick)
            else:
                self.metrics.count("stale_dropped")
        if not live:
            return None
        bucket = self.batcher.bucket_for(len(live))
        slots, rows, parity = self._staging_for(bucket)
        for i, tick in enumerate(live):
            slots[i] = tick.handle.slot
            rows[i] = tick.row
        # lanes past len(live) keep stale rows from the buffer's last use
        # — harmless (they compute into the padding slot, state nothing
        # reads) — but their slot entries MUST point at the padding lane
        slots[len(live):] = self.pool.padding_slot
        with self.metrics.timer.stage("dispatch"):
            launched = thread_launches()
            if self.annotate_device_steps:
                from fmda_tpu_torch.utils.tracing import step_annotation

                self._flush_idx += 1
                with step_annotation("pool_flush", self._flush_idx):
                    step = self.pool.step_device(slots, rows)
            else:
                step = self.pool.step_device(slots, rows)
            probs = self._to_host.to_host(step.float(), (bucket, parity))
            self.kernel_launches_by_bucket[bucket] = (
                self.kernel_launches_by_bucket.get(bucket, 0)
                + thread_launches() - launched)
        t_dispatched = self.clock()
        t_dispatched_ns = now_ns() if tracing else 0

        m = self.metrics
        m.count("flushes")
        m.count(f"flushes_bucket_{bucket}")
        m.count("padded_lanes", bucket - len(live))
        m.observe("dispatch", t_dispatched - t_dispatch)
        for tick in live:
            m.observe("enqueue_to_dispatch", t_dispatch - tick.t_enqueue)
        return _InFlight(live=live, probs=probs,
                         t_dispatch_ns=t_dispatch_ns,
                         t_dispatched_ns=t_dispatched_ns)

    def _complete(self, inflight: _InFlight) -> List[FleetResult]:
        """Stage 2 of a flush: wait for the probabilities' copy, threshold
        labels, publish the whole flush in one batched bus call."""
        tracing = self._tracer.enabled
        t_synced = self.clock()
        with self.metrics.timer.stage("device"):
            probs = PinnedStaging.wait(inflight.probs)
        t_device = self.clock()
        t_device_ns = now_ns() if tracing else 0

        results = []
        messages = [] if self.bus is not None else None
        t_pub0_ns = 0
        with self.metrics.timer.stage("publish"):
            for i, tick in enumerate(inflight.live):
                # the persistent pipeline lets close_session (and a
                # same-id reopen, which restarts seq at 0) run between
                # dispatch and completion — publishing the dead
                # incarnation's result would interleave a colliding
                # (session, seq) into the new stream
                if not self.pool.is_live(tick.handle):
                    self.metrics.count("stale_results_dropped")
                    continue
                p = probs[i]
                _, labels = labels_over_threshold(
                    p, self.threshold, self.y_fields)
                results.append(FleetResult(
                    tick.handle.session_id, tick.seq, p, labels,
                    self.weights_version))
                if messages is not None:
                    msg = {
                        "session": tick.handle.session_id,
                        "seq": tick.seq,
                        "probabilities": [float(v) for v in p],
                        "pred_labels": list(labels),
                        "prob_threshold": self.threshold,
                    }
                    if self.weights_version is not None:
                        msg["weights_version"] = self.weights_version
                    # the tick's context in-band, so downstream consumers
                    # stitch into the same trace; an incoming wire is
                    # forwarded even when this process's tracer is off
                    wire = tick.wire if tick.wire is not None else (
                        tick.trace.wire if tick.trace is not None
                        else None)
                    if wire is not None:
                        msg["trace"] = wire
                    messages.append(msg)
            if messages:
                wire_msgs = messages
                if self.result_blocks and len(messages) > 1:
                    # the whole flush as ONE columnar block, bit-identical
                    # on decode; an unpackable flush (a >63-label
                    # vocabulary, a mixed threshold) degrades to the
                    # per-tick dialect, counted — packing must never be
                    # the reason results are lost
                    try:
                        wire_msgs = [
                            codec.pack_results(messages, self.y_fields)]
                    except codec.CodecError as e:
                        self.metrics.count("result_pack_errors")
                        log.warning(
                            "result-block packing failed (%s) — "
                            "publishing the per-tick dialect", e)
                t_pub0_ns = now_ns() if tracing else 0
                try:
                    if self._publish_many is not None:
                        self._publish_many(self.prediction_topic, wire_msgs)
                    else:
                        for msg in wire_msgs:
                            self.bus.publish(self.prediction_topic, msg)
                except Exception:
                    # the transport failed AFTER the state advance —
                    # _complete_counted marks the ticks lost; this
                    # counter splits "bus down" from "copy failed"
                    self.metrics.count("publish_errors")
                    raise
        t_publish = self.clock()

        m = self.metrics
        m.count("ticks_served", len(results))
        if results:
            v = (self.weights_version
                 if self.weights_version is not None else 0)
            self._version_ticks[v] = (
                self._version_ticks.get(v, 0) + len(results))
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
        """Close the trace of every sampled tick in a completed flush.

        The four children tile the root: queued [submit → dispatch
        start], dispatch [assembly + the card's enqueue], device [enqueue
        return → probabilities on the host; under the overlap pipeline
        the hidden device and pipeline wait lives here], publish
        [thresholding + the batched bus publish], so a trace's stages sum
        to its e2e duration by construction."""
        if not inflight.t_dispatch_ns:
            return  # dispatched before tracing was enabled: no timeline
        tr = self._tracer
        t_publish_ns = now_ns()
        for tick in inflight.live:
            ref = tick.trace
            if ref is None:
                continue
            tid = ref.trace_id
            if tick.wire is not None:
                # the tick arrived with a sender's context: this
                # process's stage spans go under one "serve" span on the
                # sender's trace (no second root, no double e2e count)
                root = tr.add_span(tid, ref.span_id, "serve", "serve",
                                   ref.t0_ns, t_publish_ns)
            else:
                root = ref.span_id
            tr.add_span(tid, root, "queued", "gateway",
                        ref.t0_ns, inflight.t_dispatch_ns)
            tr.add_span(tid, root, "dispatch", "gateway",
                        inflight.t_dispatch_ns, inflight.t_dispatched_ns)
            tr.add_span(tid, root, "device", "engine",
                        inflight.t_dispatched_ns, t_device_ns)
            pub = tr.add_span(tid, root, "publish", "publish",
                              t_device_ns, t_publish_ns)
            if t_pub0_ns:
                tr.add_span(tid, pub, "bus_publish", "bus",
                            t_pub0_ns, t_publish_ns)
            if tick.wire is None:
                tr.finish_root(ref, "tick", "ingest", t_publish_ns)
