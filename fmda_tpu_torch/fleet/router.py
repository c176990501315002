"""The fleet router: session → owner routing, membership, live migration,
as ``fmda_tpu.fleet.router`` defines it.

One :class:`FleetRouter` fronts N worker processes.  It owns the
session registry and the versioned :class:`~fmda_tpu_torch.fleet.hashring
.OwnershipTable`; every session's ticks flow to its owner's inbox topic
in submission order, and results come back on the prediction topic.
The router is deliberately **model-free**: it never touches torch, numpy
math, or checkpoints — a bus-only host runs it (a clean-interpreter
probe in ``tests/test_torch_isolation.py`` keeps torch off this import
path).

Data-plane topology
-------------------

The control plane (membership, migrated state) is one topic on the
router's bus.  The data plane (ticks in, results out) has two shapes:

- **shared bus** — every worker reads/writes the router's own bus (an
  in-process topology, or one external broker/Kafka).  Simple, but one
  broker serializes the whole fleet's hot path;
- **worker-hosted** — each worker serves its *own* bus (inbox + results)
  and announces its address in every heartbeat; the router connects a
  :class:`~fmda_tpu_torch.fleet.wire.SocketBus` per worker and exchanges each
  pump's traffic in one batched round trip per worker.  The worker's
  serving loop then never crosses a socket, and data-plane capacity
  scales with the worker count — the partitions-move-with-their-owner
  shape (``serve-fleet --role worker`` does this by default).

Ordering and the migration protocol
-----------------------------------

Per-session tick order is preserved end to end by *in-band* sequencing,
never by timestamps:

1. the router is single-threaded per pump, so a session's ticks enter
   its owner's **FIFO inbox topic** in submission order;
2. the worker consumes its inbox in offset order and its embedded
   :class:`~fmda_tpu_torch.runtime.gateway.FleetGateway` preserves per-session
   order through micro-batching (one row per session per flush);
3. migration markers ride the same inbox: a ``drain_session`` message
   enqueued *after* a session's last routed tick is necessarily
   processed after it.

Migrating session S from worker A to worker B (ownership-table change):

- the router stops routing S (new ticks **buffer** at the router,
  bounded + counted) and enqueues ``drain_session`` on A's inbox;
- A serves everything queued for S, exports S's carried state +
  sequence counter (bit-exact codec, :mod:`fmda_tpu_torch.fleet.state`),
  publishes it on the control topic, and frees the slot;
- the router receives the state, enqueues ``open`` (with state) on B's
  inbox followed by the buffered ticks in order, and resumes routing.

No tick is dropped (buffered, not discarded), none is reordered (every
hop is FIFO), and none is duplicated (each tick is routed exactly once;
the state transfer carries the sequence counter so B continues A's
``seq`` stream).  A worker that dies *without* draining loses carried
state by definition — its sessions are reopened fresh on the new owner
(``sessions_lost_state`` counted) and ticks already in its inbox age
out as ``results_missing``: counted degradation, never silence.
"""

from __future__ import annotations

import itertools
import logging
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from fmda_tpu_torch.chaos.inject import default_chaos
from fmda_tpu_torch.config import (
    FleetTopologyConfig,
    TOPIC_FLEET_CONTROL,
    TOPIC_FLEET_PREDICTION,
    fleet_worker_topic,
)
from fmda_tpu_torch.stream import codec
from fmda_tpu_torch.fleet.hashring import OwnershipTable
from fmda_tpu_torch.fleet.membership import GOODBYE, HEARTBEAT, HELLO, MembershipView
from fmda_tpu_torch.fleet.state import (
    encode_norm,
    encode_param_tree,
    encode_row,
    to_legacy_msgs,
)
from fmda_tpu_torch.obs.trace import default_tracer, now_ns
from fmda_tpu_torch.runtime.metrics import RuntimeMetrics

log = logging.getLogger("fmda_tpu_torch.fleet")

#: chaos injection (fmda_tpu_torch.chaos): disabled = one branch per pump/link
_CHAOS = default_chaos()


class NoLiveWorkers(RuntimeError):
    """open_session on a fleet with an empty membership."""


@dataclass(frozen=True)
class FleetResult:
    """One served tick as observed at the router (mirrors the worker
    gateway's result, decoded off the prediction topic)."""

    session_id: str
    seq: int
    probabilities: np.ndarray
    labels: Tuple[str, ...]
    #: the serving weights that produced it (None before any hot swap
    #: — docs/replay.md "Hot swap"); the quality plane's join key.
    weights_version: Optional[int] = None


@dataclass
class _Session:
    """Router-side registry entry for one session."""

    session_id: str
    #: current owner worker id (None while orphaned — no live workers)
    owner: Optional[str]
    norm_wire: Optional[dict]
    #: next router-side sequence number (stays in lockstep with the
    #: owning gateway's ``seq`` because ticks are routed exactly once)
    next_seq: int = 0
    #: "active" = ticks route; "migrating" = ticks buffer until the
    #: pending open lands on the new owner
    status: str = "active"
    #: current migration id (stale session_state messages are ignored)
    mig: Optional[str] = None
    #: ticks buffered while migrating/orphaned, in submission order
    buffer: Deque[dict] = field(default_factory=deque)
    #: exported state that arrived while no worker could host it
    pending_state: Optional[dict] = None
    #: tenant / priority-class label (fmda_tpu.control QoS); rides every
    #: open so the owning gateway classifies the session's ticks
    tenant: Optional[str] = None


@dataclass
class _WorkerLink:
    """The router's data-plane connection to one worker's own bus."""

    address: str
    bus: object
    #: next fleet_prediction offset to read off this worker's bus
    results_offset: int = 0


class FleetRouter:
    """Routes a session space over live workers; drives migration."""

    def __init__(
        self,
        bus,
        config: Optional[FleetTopologyConfig] = None,
        *,
        n_features: int,
        metrics: Optional[RuntimeMetrics] = None,
        clock: Callable[[], float] = time.monotonic,
        control_topic: str = TOPIC_FLEET_CONTROL,
        prediction_topic: str = TOPIC_FLEET_PREDICTION,
        connect_fn: Optional[Callable[[str], object]] = None,
        from_end: bool = False,
    ) -> None:
        self.cfg = config or FleetTopologyConfig()
        self.bus = bus
        self.n_features = n_features
        self.metrics = metrics or RuntimeMetrics()
        self.clock = clock
        self.control_topic = control_topic
        self.prediction_topic = prediction_topic
        self.membership = MembershipView(
            self.cfg.heartbeat_timeout_s, clock=clock)
        self.table = OwnershipTable(0, (), self.cfg.hash_space)
        self._sessions: Dict[str, _Session] = {}
        #: lazy per-worker owned-session counts (None = recompute);
        #: invalidated at every registry/owner mutation
        self._owned_cache: Optional[Dict[str, int]] = None
        #: ids of every session whose carried state this router ever
        #: lost (owner died undrained → fresh reopen).  The chaos
        #: soak's bit-identity gate excludes exactly these — loss is
        #: judged by observation, not by which faults were planned (a
        #: falsely-reaped worker's sessions lose state just as really)
        self.lost_state_sessions: set = set()
        #: session ids whose status != "active" (migrating/orphaned) —
        #: maintained at every status transition so saturation checks
        #: and drain's are-we-done test never scan the whole registry
        self._migrating: set = set()
        #: leaving workers already sent their stop (idempotence; the
        #: leave mark itself stays until the goodbye arrives, so the
        #: stopping worker is never re-added to live())
        self._stops_sent: set = set()
        #: per-worker outgoing message batch, flushed each pump with one
        #: publish_many (one JSON pass + one transport call per worker)
        self._outgoing: Dict[str, List[dict]] = {}
        #: data-plane links to worker-hosted buses (absent for workers
        #: sharing this router's bus)
        self._links: Dict[str, _WorkerLink] = {}
        #: worker ids that ever announced a data-plane address: their
        #: outgoing traffic must never fall through to the shared bus
        #: while a link is down (their inbox lives on THEIR bus)
        self._linked_ever: set = set()
        #: worker ids whose outgoing batch sat out a link outage — their
        #: next delivery re-checks ticks against the in-flight table
        #: (aged ones are already counted lost and must not be served)
        self._held_outgoing: set = set()
        #: (worker_id, address) -> results_offset saved when a link
        #: drops on a TRANSIENT error: the worker's bus (and its
        #: retained results) are still there, so the re-link must
        #: resume where it left off — restarting at 0 would re-deliver
        #: every retained result as a duplicate.  A fresh incarnation
        #: announces itself with a hello, which purges these (its new
        #: bus restarts at offset 0).
        self._link_resume: Dict[Tuple[str, str], int] = {}
        #: (session, seq) -> (t_submit, trace_ref) for latency + loss
        #: accounting; insertion-ordered, aged out at result_timeout_s
        self._inflight: "OrderedDict[Tuple[str, int], tuple]" = OrderedDict()
        #: workers we asked for a session report (takeover) whose answer
        #: is still outstanding — one request in flight per worker
        self._report_pending: set = set()
        #: wire-dialect capability per worker, from the ``wire`` field
        #: its liveness messages carry (absent = pre-v2): decides per
        #: consumer whether outgoing payloads use columnar blocks/raw
        #: arrays or the pre-v2 shapes — on a shared broker the
        #: router's own link format says nothing about the consumer
        self._peer_wire: Dict[str, int] = {}
        #: last hot-swap version this router broadcast (bumped per
        #: broadcast unless the caller pins one)
        self._swap_version = 0
        #: worker -> weights_version it last acked (``weights_swapped``
        #: control messages) — the fleet's mixed-version window is the
        #: spread of these values, surfaced in :meth:`summary`
        self._worker_weights: Dict[str, int] = {}
        #: ``from_end=True`` is the RESTART posture (router failover,
        #: docs/chaos.md): skip the control topic's history — replaying
        #: hours-old hellos would resurrect dead workers at receipt-time
        #: liveness — and re-learn membership from the next beats; the
        #: session registry is rebuilt from worker session reports
        self._control = bus.consumer(control_topic, from_end=from_end)
        self._results = bus.consumer(prediction_topic, from_end=from_end)
        self._mig_ids = itertools.count(1)
        self._tracer = default_tracer()
        #: set while the whole topology is being stopped: membership
        #: churn then triggers NO migrations/reopens (every worker is
        #: exiting — moving sessions between them is wasted motion)
        self._stopping = False
        #: how to reach a worker-announced data-plane address
        if connect_fn is None:
            from fmda_tpu_torch.fleet.wire import SocketBus

            wire_format = self.cfg.wire_format
            connect_fn = lambda addr: SocketBus.connect(  # noqa: E731
                addr, timeout_s=30.0, wire_format=wire_format)
        self._connect_fn = connect_fn

    # -- membership bootstrap ------------------------------------------------

    def wait_for_workers(
        self,
        n: int,
        *,
        timeout_s: float = 60.0,
        sleep_fn: Callable[[float], None] = time.sleep,
    ) -> List[str]:
        """Pump the control topic until ``n`` workers are live (the
        launcher calls this before admitting sessions, so bootstrap
        joins never trigger migrations)."""
        deadline = self.clock() + timeout_s
        while True:
            self._drain_control()
            if len(self.membership) >= n:
                return self.membership.live()
            if self.clock() >= deadline:
                raise RuntimeError(
                    f"only {self.membership.live()} of {n} workers "
                    f"joined within {timeout_s:.0f}s")
            sleep_fn(0.01)

    # -- session admission ---------------------------------------------------

    def open_session(
        self, session_id: str, norm=None, *,
        tenant: Optional[str] = None,
    ) -> None:
        """Admit a session: register it and route an ``open`` to its
        owner.  Raises :class:`NoLiveWorkers` when the fleet is empty —
        admission control stays loud, like the gateway's.

        ``tenant`` labels the session with its QoS priority class
        (fmda_tpu.control); the label follows the session through every
        migration and failover reopen."""
        if session_id in self._sessions:
            raise ValueError(f"session {session_id!r} already open")
        owner = self.table.owner_of(session_id)
        if owner is None:
            self.metrics.count("rejected_sessions")
            raise NoLiveWorkers(
                "no live workers to own sessions (did the fleet start? "
                "wait_for_workers bootstraps membership)")
        sess = _Session(session_id, owner, encode_norm(norm),
                        tenant=tenant)
        self._sessions[session_id] = sess
        self._enqueue(owner, self._open_msg(sess))
        self.metrics.count("sessions_opened")
        self._sessions_changed()

    def close_session(self, session_id: str) -> None:
        sess = self._sessions.pop(session_id, None)
        if sess is None:
            raise KeyError(f"no open session {session_id!r}")
        if sess.owner is not None and sess.status == "active":
            self._enqueue(
                sess.owner, {"kind": "close", "session": session_id})
        # stop tracking the dead incarnation's in-flight ticks NOW: a
        # reopen restarts seq at 0, and a stale (session, seq) key would
        # collide with the new stream's tracking
        stale = [k for k in self._inflight if k[0] == session_id]
        for k in stale:
            del self._inflight[k]
        if stale:
            self.metrics.count("inflight_dropped_on_close", len(stale))
        self._migrating.discard(session_id)
        self.metrics.count("sessions_closed")
        self._sessions_changed()

    def _open_msg(self, sess: _Session, state: Optional[dict] = None) -> dict:
        msg = {
            "kind": "open",
            "session": sess.session_id,
            "norm": sess.norm_wire,
            "seq": int(state["seq"]) if state is not None else sess.next_seq,
            # v2 requester: the worker may answer with columnar result
            # blocks (and raw-array state) — absent (a pre-v2 router),
            # it keeps the per-tick result dicts
            "wire": 2,
        }
        if state is not None:
            msg["state"] = state
        if sess.mig is not None:
            msg["mig"] = sess.mig
        if sess.tenant is not None:
            msg["tenant"] = sess.tenant
        return msg

    def session_tenant(self, session_id: str) -> Optional[str]:
        """An open session's tenant label (None when unlabeled)."""
        sess = self._sessions.get(session_id)
        if sess is None:
            raise KeyError(f"no open session {session_id!r}")
        return sess.tenant

    def _sessions_changed(self) -> None:
        self.metrics.gauge("active_sessions", len(self._sessions))
        self._owned_cache = None

    def _owned_counts(self) -> Dict[str, int]:
        """Per-worker owned-session counts, cached between registry
        mutations: takeover detection reads this on essentially every
        heartbeat, and a scan of the whole registry per beat would put
        O(sessions × workers / heartbeat_interval) on the pump loop."""
        counts = self._owned_cache
        if counts is None:
            counts = {}
            for s in self._sessions.values():
                if s.owner is not None:
                    counts[s.owner] = counts.get(s.owner, 0) + 1
            self._owned_cache = counts
        return counts

    # -- the request path ----------------------------------------------------

    def submit(self, session_id: str, row: np.ndarray) -> int:
        """Route one tick; returns its per-session sequence number.
        Migrating/orphaned sessions buffer (bounded + counted) instead
        of racing their state transfer."""
        sess = self._sessions.get(session_id)
        if sess is None:
            raise KeyError(f"no open session {session_id!r}")
        row = np.asarray(row, np.float32)
        if row.shape != (self.n_features,):
            raise ValueError(
                f"row shape {row.shape} != ({self.n_features},) for "
                f"session {session_id!r}")
        seq = sess.next_seq
        sess.next_seq = seq + 1
        msg = {
            "kind": "tick",
            "session": session_id,
            "row": encode_row(row),
            "seq": seq,
        }
        ref = self._tracer.maybe_trace()
        if ref is not None:
            msg["trace"] = ref.wire
        self._inflight[(session_id, seq)] = (self.clock(), ref)
        self.metrics.count("routed_ticks")
        if sess.status == "active" and sess.owner is not None:
            self._enqueue(sess.owner, msg)
        else:
            sess.buffer.append(msg)
            self.metrics.count("buffered_ticks")
            while len(sess.buffer) > self.cfg.migration_buffer_bound:
                shed = sess.buffer.popleft()
                self._inflight.pop(
                    (session_id, shed["seq"]), None)
                self.metrics.count("migration_buffer_shed")
        return seq

    @property
    def saturated(self) -> bool:
        """Router-side backpressure: too many unanswered ticks in
        flight (the fleet is behind — an unbounded inbox backlog would
        eventually outrun bus retention), or a migration buffer at its
        bound.  Well-behaved producers pump-and-wait instead of racing
        either limit.  O(migrating sessions), not O(all sessions) —
        this sits in front of every submit."""
        if len(self._inflight) >= self.cfg.max_inflight_ticks:
            return True
        if not self._migrating:
            return False
        bound = self.cfg.migration_buffer_bound
        return any(
            len(self._sessions[sid].buffer) >= bound
            for sid in self._migrating
            if sid in self._sessions
        )

    def _set_status(self, sess: _Session, status: str) -> None:
        # every owner handoff passes through here right after the
        # assignment (migration complete, reopen) — drop the cache with it
        self._owned_cache = None
        sess.status = status
        if status == "active":
            self._migrating.discard(sess.session_id)
        else:
            self._migrating.add(sess.session_id)
        self.metrics.gauge("migrating_sessions", len(self._migrating))

    def _enqueue(self, worker_id: str, msg: dict) -> None:
        self._outgoing.setdefault(worker_id, []).append(msg)

    # -- the serving loop ----------------------------------------------------

    def pump(self, *, force: bool = False) -> List[FleetResult]:
        """One router cycle: fold control messages (membership, migrated
        state), reap silent workers, exchange data with every worker
        (outgoing batch + results, one round trip per linked worker),
        and return the results that arrived.  ``force`` is accepted for
        gateway-API compatibility (the router has no deferred flushes —
        every pump flushes)."""
        del force
        if _CHAOS.enabled:
            # injection point "router.pump": delay/hang windows stall
            # the control loop (the slow-router shape)
            _CHAOS.check("router.pump")
        try:
            self._drain_control()
        except (ConnectionError, OSError) as e:
            # the control bus is down (broker blip): the router keeps
            # pumping its data links — membership just ages until the
            # bus returns.  Counted degradation, never abort.
            self.metrics.count("bus_errors")
            log.warning("control-plane poll failed: %s", e)
        dead = self.membership.reap()
        if dead:
            self.metrics.count("workers_dead", len(dead))
            for wid in dead:
                # resume=True: a falsely-reaped worker (long stall, not
                # death) re-joins via its next beat and must not re-read
                # its retained results from 0; a truly dead worker's
                # replacement hellos, which purges the saved position
                self._close_link(wid, resume=True)
                self._stops_sent.discard(wid)
                self._drop_outgoing(wid)
                self._report_pending.discard(wid)
            self._rebalance(f"worker death: {sorted(dead)}")
        # a migration completed this pump may have emptied a leaving
        # worker — release it now, not on the next membership change
        self._maybe_release_leaving()
        results = self._exchange_data()
        self._age_inflight()
        self.metrics.gauge("inflight_ticks", len(self._inflight))
        return results

    def drain(
        self,
        *,
        timeout_s: float = 60.0,
        sleep_fn: Callable[[float], None] = time.sleep,
    ) -> List[FleetResult]:
        """Pump until every routed tick has answered (or aged out) and
        no migration is mid-flight — the end-of-load / shutdown path.
        Bounded by ``timeout_s`` of *stall* (no progress), not of total
        wall clock: a busy fleet draining a deep backlog keeps going as
        long as results keep arriving."""
        results: List[FleetResult] = []
        last_progress = self.clock()
        outstanding = len(self._inflight)
        while True:
            got = self.pump()
            results.extend(got)
            if not self._inflight and not self._migrating:
                return results
            now = self.clock()
            if len(self._inflight) != outstanding or got:
                outstanding = len(self._inflight)
                last_progress = now
            elif now - last_progress > timeout_s:
                self.metrics.count("drain_stalled")
                log.warning(
                    "drain stalled: %d ticks unanswered after %.0fs "
                    "without progress", len(self._inflight), timeout_s)
                return results
            sleep_fn(0.002)

    # -- data-plane exchange -------------------------------------------------

    def _exchange_data(self) -> List[FleetResult]:
        """Flush every per-worker outgoing batch and collect results.

        Linked (worker-hosted-bus) workers get ONE round trip each:
        their tick batch and their results read share a batched frame —
        on high-syscall-latency hosts the round-trip count is the
        router's throughput ceiling (fmda_tpu_torch.fleet.wire).  Workers on
        the shared bus are published/polled through it as a group.
        """
        outgoing, self._outgoing = self._outgoing, {}
        tracing = self._tracer.enabled
        rows: List[tuple] = []
        for wid, link in list(self._links.items()):
            msgs = outgoing.pop(wid, [])
            if wid in self._held_outgoing:
                # this batch sat out a link outage: ticks that aged into
                # results_missing while held must not be delivered now —
                # serving a written-off tick would count it twice
                self._held_outgoing.discard(wid)
                msgs = self._drop_aged_ticks(wid, msgs)
            t0_ns = now_ns() if tracing else 0
            t0 = self.clock()
            try:
                if _CHAOS.enabled:
                    # injection point "link:<wid>": a partition window
                    # raises here and exercises the REAL link-failure
                    # machinery below (drop, count, heartbeat re-link)
                    _CHAOS.check("link:" + wid)
                with self.metrics.timer.stage("route"):
                    batch = getattr(link.bus, "batch", None)
                    read_op = {
                        "op": "read",
                        "topic": self.prediction_topic,
                        "offset": link.results_offset,
                        "max_records": None,
                    }
                    # runs of consecutive ticks leave as columnar
                    # blocks: one contiguous (B, F) f32 array + one
                    # i64 seq column per run instead of B dicts —
                    # encoded once, at the link's negotiated format
                    # (fmda_tpu_torch.stream.codec).  A link that negotiated
                    # down to JSON instead gets the full pre-v2
                    # payload shapes (bare-base64 rows, enveloped
                    # arrays), so a genuinely old peer still parses.
                    # Error/requeue paths keep the per-tick `msgs`.
                    wire_msgs = self._lower_for(
                        wid, link.bus, msgs, direct=True)
                    if batch is not None:
                        ops = []
                        if wire_msgs:
                            ops.append({
                                "op": "publish_many",
                                "topic": fleet_worker_topic(wid),
                                "values": wire_msgs,
                            })
                        ops.append(read_op)
                        resps = link.bus.batch(ops)
                        for op, resp in zip(ops[:-1], resps[:-1]):
                            if "err" in resp:
                                self.metrics.count(
                                    "routed_publish_errors", len(msgs))
                                log.error(
                                    "router: publish to %s failed: %s",
                                    wid, resp["err"])
                        link_rows = link.bus.unwrap_op(read_op, resps[-1])
                    else:
                        if wire_msgs:
                            link.bus.publish_many(
                                fleet_worker_topic(wid), wire_msgs)
                        link_rows = [
                            (r.offset, r.value) for r in link.bus.read(
                                self.prediction_topic,
                                link.results_offset)]
            except (ConnectionError, OSError) as e:
                # the worker's bus went away mid-exchange: drop the
                # link (a live worker's next heartbeat re-links it —
                # every beat carries the address; a dead worker's
                # silence confirms the death by timeout).  Ticks in the
                # failed frame are at-most-once — re-sending could
                # double-advance a recurrence — so they are counted
                # lost (any that actually landed still answer and are
                # matched; the rest age into results_missing).  Control
                # messages ARE idempotent (a duplicate open replaces
                # with identical state, a duplicate close/drain is
                # counted unknown), so they re-queue ahead of newer
                # traffic and ride the re-link: a transient blip can no
                # longer strand a migration on a lost drain marker.
                self.metrics.count("link_errors")
                keep = [m for m in msgs if m.get("kind") != "tick"]
                n_ticks = len(msgs) - len(keep)
                if n_ticks:
                    # lint: ignore[counted-loss] pre-count: these ticks stay in _inflight and age into results_missing, which the gate sums — summing both would double count
                    self.metrics.count("routed_ticks_lost", n_ticks)
                if keep:
                    self.metrics.count("control_requeued", len(keep))
                    self._outgoing[wid] = keep + self._outgoing.get(wid, [])
                log.warning("data link to %s failed: %s", wid, e)
                self._close_link(wid, resume=True)
                continue
            if msgs:
                self.metrics.observe("route", self.clock() - t0)
                if tracing:
                    t1_ns = now_ns()
                    for msg in msgs:
                        wire = msg.get("trace")
                        if wire is not None:
                            self._tracer.add_span_wire(
                                wire, "route", "bus", t0_ns, t1_ns)
            if link_rows:
                link.results_offset = int(link_rows[-1][0]) + 1
                rows.extend(link_rows)
        # whatever remains targets shared-bus workers (or stale ids
        # whose topic still exists on the shared bus)
        if outgoing:
            publish_many = getattr(self.bus, "publish_many", None)
            for wid, msgs in outgoing.items():
                if wid in self._linked_ever and wid not in self._links:
                    # a worker-hosted worker whose link is down: its
                    # inbox lives on ITS bus, not the shared one —
                    # hold the batch for the heartbeat-driven re-link
                    # (dropped + counted if the worker is declared
                    # dead instead).  Ticks that aged out of the
                    # in-flight table while held are dropped NOW: they
                    # are already counted results_missing, so late
                    # delivery would serve a tick the accounting wrote
                    # off (counted twice) — and keeping them would let
                    # a long partition grow the hold without bound,
                    # where dropping caps it at max_inflight_ticks.
                    held = self._drop_aged_ticks(wid, msgs)
                    if held:
                        self._held_outgoing.add(wid)
                        self._outgoing[wid] = \
                            held + self._outgoing.get(wid, [])
                    continue
                t0_ns = now_ns() if tracing else 0
                t0 = self.clock()
                try:
                    with self.metrics.timer.stage("route"):
                        topic = fleet_worker_topic(wid)
                        wire_msgs = self._lower_for(
                            wid, self.bus, msgs, direct=False)
                        if publish_many is not None:
                            publish_many(topic, wire_msgs)
                        else:
                            for msg in wire_msgs:
                                self.bus.publish(topic, msg)
                except KeyError:
                    self.metrics.count("routed_publish_errors", len(msgs))
                    log.error(
                        "router: no inbox topic for %s on the shared "
                        "bus", wid)
                    continue
                except (ConnectionError, OSError) as e:
                    # shared broker down: counted, the pump survives —
                    # the same contract as a link failure, including the
                    # requeue: ticks are at-most-once (counted lost, the
                    # unanswered ones age into results_missing), but
                    # idempotent control messages ride the broker's
                    # recovery — a blip must not strand a migration on a
                    # dropped drain marker or leave a reopen dark
                    self.metrics.count("bus_errors")
                    keep = [m for m in msgs if m.get("kind") != "tick"]
                    n_ticks = len(msgs) - len(keep)
                    if n_ticks:
                        # lint: ignore[counted-loss] pre-count: these ticks age into results_missing, the summed term (see the link-failure twin above)
                        self.metrics.count("routed_ticks_lost", n_ticks)
                    if keep:
                        self.metrics.count("control_requeued", len(keep))
                        self._outgoing[wid] = \
                            keep + self._outgoing.get(wid, [])
                    log.warning(
                        "router: shared-bus publish for %s failed: %s",
                        wid, e)
                    continue
                self.metrics.observe("route", self.clock() - t0)
                if tracing:
                    t1_ns = now_ns()
                    for msg in msgs:
                        wire = msg.get("trace")
                        if wire is not None:
                            self._tracer.add_span_wire(
                                wire, "route", "bus", t0_ns, t1_ns)
        # shared-bus results: skip the poll only when every live worker
        # is linked (then nothing ever lands on the shared topic)
        if (not self._links
                or any(wid not in self._links
                       for wid in self.membership.workers)):
            try:
                rows.extend(
                    (r.offset, r.value) for r in self._results.poll())
            except (ConnectionError, OSError) as e:
                self.metrics.count("bus_errors")
                log.warning("shared-bus results poll failed: %s", e)
        return self._fold_results(rows)

    def _lower_for(
        self, worker_id: str, bus, msgs: List[dict], *, direct: bool,
    ) -> List[dict]:
        """Outgoing batch in the consuming WORKER's wire dialect:
        columnar tick blocks + raw arrays for v2 peers, the full pre-v2
        payload shapes (bare-base64 rows, enveloped arrays) otherwise.
        A JSON-negotiated link always lowers (the ``wire_format=json``
        rollback must roll the dialect back too, and a pre-v2 direct
        peer can only ever be on a JSON link).  On a ``direct`` link the
        transport terminates at the worker, so a binary negotiation
        proves a v2 peer; on the shared bus the router's own broker
        link says nothing about the consumer, so the worker's declared
        capability decides (the ``wire`` field its liveness messages
        carry — absent means pre-v2)."""
        if not msgs:
            return msgs
        legacy = getattr(bus, "negotiated_format", None) == "json"
        if not direct:
            legacy = legacy or self._peer_wire.get(worker_id, 1) < 2
        return to_legacy_msgs(msgs) if legacy else codec.coalesce_ticks(msgs)

    def _ensure_link(self, worker_id: str, address: Optional[str]) -> None:
        """(Re)connect the data-plane link a worker announces."""
        if not address:
            return
        link = self._links.get(worker_id)
        if link is not None and link.address == address:
            return
        if link is not None:
            self._close_link(worker_id)
        try:
            bus = self._connect_fn(address)
        except (OSError, ConnectionError) as e:
            self.metrics.count("link_errors")
            log.error("cannot connect %s data bus at %s: %s",
                      worker_id, address, e)
            return
        resume = self._link_resume.pop((worker_id, address), None)
        if resume is None:
            # start at the bus's END, not 0: a fresh worker's bus is
            # empty (end == 0, identical), but a TAKEOVER (this router
            # restarted while the worker kept serving) must not re-read
            # every result the dead router already consumed — those
            # ticks were never routed by this incarnation and would
            # only flood results_unmatched
            resume = 0
            end = getattr(bus, "end_offset", None)
            if end is not None:
                try:
                    resume = int(end(self.prediction_topic))
                # loss-free: probe fallback — resuming from 0 re-reads results (harmless duplicates, counted unmatched), never drops any
                except (ConnectionError, OSError, RuntimeError, KeyError):
                    resume = 0
        self._links[worker_id] = _WorkerLink(
            address=address, bus=bus, results_offset=resume)
        self._linked_ever.add(worker_id)
        log.info("data link to %s at %s (results from %d)",
                 worker_id, address, resume)

    def _close_link(self, worker_id: str, *, resume: bool = False) -> None:
        """Drop a worker's data link.  ``resume`` (transient link error:
        the worker's bus survives) saves the results read position so the
        heartbeat-driven re-link picks up where this one stopped; the
        default (leave/death/goodbye/shutdown — the process is gone)
        forgets it, because a replacement's bus restarts at offset 0."""
        link = self._links.pop(worker_id, None)
        if resume and link is not None:
            self._link_resume[(worker_id, link.address)] = \
                link.results_offset
        elif not resume:
            for key in [k for k in self._link_resume if k[0] == worker_id]:
                del self._link_resume[key]
        if link is not None:
            close = getattr(link.bus, "close", None)
            if close is not None:
                try:
                    close()
                except OSError:  # loss-free: teardown of a dead link
                    pass

    def _drop_aged_ticks(self, worker_id: str, msgs: List[dict]) -> List[dict]:
        """Filter ticks that aged out of the in-flight table from a
        batch held across a link outage: they are already counted
        ``results_missing``, so delivering them late would serve a tick
        the accounting wrote off (counted twice) — and dropping them
        caps a long partition's hold at ``max_inflight_ticks`` instead
        of letting it grow without bound.  Control messages always
        survive the hold (a migration must not strand on a dropped
        drain marker)."""
        now = self.clock()
        timeout = self.cfg.result_timeout_s
        kept = []
        for m in msgs:
            if m.get("kind") == "tick":
                entry = self._inflight.get((m["session"], m["seq"]))
                # expired-but-unswept ticks are dropped too: the sweep
                # at the end of this pump will count them, and a re-link
                # landing in the same pump must not deliver them first
                if entry is None or now - entry[0] > timeout:
                    continue
            kept.append(m)
        aged = len(msgs) - len(kept)
        if aged:
            # lint: ignore[counted-loss] these ticks already aged (or are aging this pump) into results_missing — this series is the diagnostic view, not the identity term
            self.metrics.count("routed_ticks_lost", aged)
            log.warning(
                "dropped %d held ticks for %s that aged out awaiting a "
                "re-link", aged, worker_id)
        return kept

    def _drop_outgoing(self, worker_id: str) -> None:
        """Discard a departed worker's pending batch (held for a
        re-link that will never happen) — counted, never silent; its
        sessions are reopened elsewhere by the same rebalance."""
        self._held_outgoing.discard(worker_id)
        msgs = self._outgoing.pop(worker_id, None)
        if not msgs:
            return
        n_ticks = sum(1 for m in msgs if m.get("kind") == "tick")
        if n_ticks:
            # lint: ignore[counted-loss] pre-count: the dropped ticks stay in _inflight and age into results_missing, the summed term
            self.metrics.count("routed_ticks_lost", n_ticks)
        # lint: ignore[counted-loss] counts MESSAGES (opens/closes/markers too), not ticks — the tick portion is accounted via results_missing above
        self.metrics.count("outgoing_dropped", len(msgs))
        log.warning(
            "dropped %d pending messages for departed worker %s "
            "(%d ticks)", len(msgs), worker_id, n_ticks)

    def _fold_results(self, rows) -> List[FleetResult]:
        results: List[FleetResult] = []
        flat: List[dict] = []
        for _offset, v in rows:
            if v.get("kind") == "result_block":
                # a columnar run (fmda_tpu_torch.stream.codec.pack_results):
                # one (B, C) probability array + dictionary-encoded ids
                # expands back to per-result messages, bit-identical to
                # the per-tick dialect
                try:
                    flat.extend(codec.iter_results(v))
                except (KeyError, ValueError, TypeError):
                    self.metrics.count("results_undecodable")
                continue
            flat.append(v)
        for v in flat:
            sid, seq = v.get("session"), v.get("seq")
            if sid is None or seq is None:
                # not a result at all (a corrupted/foreign record on
                # the results topic) — count it, never crash on it
                self.metrics.count("results_undecodable")
                continue
            entry = self._inflight.pop((sid, seq), None)
            if entry is not None:
                t_submit, ref = entry
                self.metrics.observe("total", self.clock() - t_submit)
                if ref is not None:
                    self._tracer.finish_root(ref, "tick", "ingest", now_ns())
            else:
                # a result this router never routed (restart, foreign
                # producer, tick that aged out) — visible, not fatal
                self.metrics.count("results_unmatched")
            version = v.get("weights_version")
            results.append(FleetResult(
                sid, seq,
                np.asarray(v.get("probabilities", ()), np.float32),
                tuple(v.get("pred_labels", ())),
                int(version) if version is not None else None,
            ))
        self.metrics.count("results_received", len(results))
        return results

    def _age_inflight(self) -> None:
        now = self.clock()
        timeout = self.cfg.result_timeout_s
        while self._inflight:
            key = next(iter(self._inflight))
            t_submit, _ref = self._inflight[key]
            if now - t_submit <= timeout:
                break
            del self._inflight[key]
            self.metrics.count("results_missing")
            log.warning(
                "tick (%s, %d) unanswered after %.0fs — counted lost",
                key[0], key[1], timeout)

    # -- control plane -------------------------------------------------------

    def _drain_control(self) -> None:
        for rec in self._control.poll():
            self._handle_control(rec.value)

    def _handle_control(self, msg: dict) -> None:
        kind = msg.get("kind")
        if kind in (HELLO, HEARTBEAT, GOODBYE):
            wid = msg.get("worker")
            if wid:
                self._peer_wire[wid] = int(msg.get("wire", 1))
            if kind == HELLO:
                # a session-LESS hello is a fresh process whose data bus
                # restarts at offset 0 — purge any saved resume position.
                # A hello WITH sessions is the SAME incarnation re-dialing
                # the control plane (its data bus kept serving the whole
                # time): save the results read position so the re-link
                # resumes where this one stopped instead of jumping to
                # end and skipping unread results
                self._close_link(wid, resume=bool(msg.get("sessions")))
                if not msg.get("address"):
                    # a shared-bus incarnation of a previously linked id
                    self._linked_ever.discard(wid)
                if wid in self.membership.workers \
                        and not msg.get("sessions"):
                    # a session-less hello of a LIVE id: the process was
                    # killed and revived inside the heartbeat timeout —
                    # membership never noticed, but the carried state
                    # died with the old incarnation.  Same consequence
                    # as a detected death: reopen its sessions fresh,
                    # counted.  (A hello WITH sessions is the other
                    # direction — a control-plane reconnect of the same
                    # incarnation — and adopts below instead.)
                    self.metrics.count("worker_restarts")
                    self._drop_outgoing(wid)
                    self._reopen_for_restart(wid)
            if kind != GOODBYE:
                # link before rebalance: a join's first drain markers
                # and opens must have somewhere to land
                if msg.get("address"):
                    self._ensure_link(wid, msg["address"])
                else:
                    # shared-bus worker: its inbox rides THIS bus, and
                    # the launch-time topic set only covers the initial
                    # fleet — admit the topic so a late joiner is
                    # routable (ROADMAP (c); idempotent on all backends)
                    add = getattr(self.bus, "add_topic", None)
                    if add is not None:
                        add(fleet_worker_topic(wid))
            adopted = 0
            if kind == HELLO and msg.get("sessions"):
                # router failover: the hello of a worker that was
                # already serving (this router restarted, or the worker
                # re-dialed a new router) carries its open-session map;
                # the registry is rebuilt from it — the workers own the
                # truth about what is being served (docs/chaos.md)
                adopted = self._adopt_sessions(wid, msg["sessions"])
            event = self.membership.observe(msg)
            if event == "join":
                self.metrics.count("workers_joined")
                self._stops_sent.discard(wid)
                self._rebalance(f"worker join: {wid}")
            elif adopted:
                # adopted sessions on a non-join hello still need their
                # hash-table placement checked (migrations if the table
                # maps them elsewhere)
                self._rebalance(f"adopted {adopted} sessions from {wid}")
            if event == "leave":
                self.metrics.count("workers_left")
                # drop the link before the next pump would error on it
                self._close_link(wid)
                self._stops_sent.discard(wid)
                self._report_pending.discard(wid)
                self._drop_outgoing(wid)
                self._rebalance(f"worker leave: {wid}")
            elif kind == GOODBYE:
                # a released leaving worker's goodbye: already out of
                # live(), nothing to rebalance — just drop its link
                self._close_link(wid)
                self._stops_sent.discard(wid)
                self._report_pending.discard(wid)
                self._drop_outgoing(wid)
            else:
                # takeover detection: a beating worker serving more
                # sessions than this router's registry credits it with
                # means the registry predates us (we restarted) — ask
                # for the authoritative session map via its inbox
                self._maybe_request_report(wid, msg.get("stats"))
        elif kind == "session_state":
            self._on_session_state(msg)
        elif kind == "session_report":
            wid = msg.get("worker")
            self._report_pending.discard(wid)
            adopted = self._adopt_sessions(wid, msg.get("sessions"))
            if adopted:
                self._rebalance(f"adopted {adopted} sessions from {wid}")
        elif kind == "weights_swapped":
            # hot-swap ack: the worker's gateway is now serving this
            # version — the spread across workers IS the fleet's
            # mixed-version window (summary surfaces min/max)
            wid = msg.get("worker")
            if wid:
                self._worker_weights[wid] = int(msg.get("version", 0))
            self.metrics.count("hot_swaps_acked")
        elif kind == "leaving":
            self.request_leave(msg.get("worker"))
        elif kind == "open_failed":
            self.metrics.count("open_failures")
            log.error(
                "worker %s could not open session %s: %s",
                msg.get("worker"), msg.get("session"), msg.get("error"))
        # "ownership" announcements are our own — ignored on re-read

    def _adopt_sessions(
        self, worker_id: Optional[str], sessions: Optional[dict]
    ) -> int:
        """Fold a worker's authoritative session report into the
        registry (router failover, docs/chaos.md): sessions this router
        never heard of are registered with the reporter as owner, the
        reported ``seq`` continuing the result stream with no gap or
        collision, and the reported norm stats kept so a LATER owner
        death can still reopen the session fresh.  Sessions the
        registry already tracks are left alone — this router's view is
        authoritative for everything it actually routed."""
        if not worker_id or not sessions:
            return 0
        adopted = 0
        for sid, info in sessions.items():
            sess = self._sessions.get(sid)
            if sess is not None:
                if sess.owner != worker_id and sess.status == "active":
                    # two live workers claim one session (a protocol
                    # breach upstream): the registry wins — visible,
                    # and the reporter is told to drop its copy
                    self.metrics.count("adoption_conflicts")
                    self._enqueue(worker_id,
                                  {"kind": "close", "session": sid})
                    log.warning(
                        "session %s reported by %s but owned by %s — "
                        "close sent to the reporter",
                        sid, worker_id, sess.owner)
                continue
            self._sessions[sid] = _Session(
                sid, worker_id, info.get("norm"),
                next_seq=int(info.get("seq", 0)),
                tenant=info.get("tenant"))
            adopted += 1
        if adopted:
            self.metrics.count("sessions_adopted", adopted)
            self._sessions_changed()
            log.info(
                "adopted %d sessions from %s (registry rebuilt from "
                "worker state)", adopted, worker_id)
        return adopted

    def _maybe_request_report(
        self, worker_id: Optional[str], stats: Optional[dict]
    ) -> None:
        """Ask a worker for its session map when its heartbeat shows it
        serving more sessions than the registry credits it with — the
        restarted-router takeover path.  One request in flight per
        worker; the reply (``session_report``) clears it."""
        if not worker_id or worker_id in self._report_pending:
            return
        if not isinstance(stats, dict):
            return
        active = int(stats.get("active_sessions") or 0)
        if not active:
            return
        owned = self._owned_counts().get(worker_id, 0)
        if active <= owned:
            return
        self._report_pending.add(worker_id)
        self._enqueue(worker_id, {"kind": "report_sessions", "wire": 2})
        self.metrics.count("session_reports_requested")

    def request_leave(self, worker_id: Optional[str]) -> bool:
        """Gracefully drain a worker out of the fleet: it keeps serving
        while its sessions migrate off one ``drain_session`` at a time,
        and is stopped once it owns nothing.  True when the drain was
        actually initiated (the autoscaler's scale-down branches on
        this — a worker already leaving, or unknown, is not a move)."""
        if worker_id and self.membership.mark_leaving(worker_id):
            self.metrics.count("workers_leaving")
            self._rebalance(f"graceful leave: {worker_id}")
            return True
        return False

    def broadcast_retune(
        self, *, max_linger_ms: Optional[float] = None,
        bucket_cap: Optional[int] = None,
    ) -> int:
        """Push new batching knobs to every live worker's gateway (the
        batching controller's fleet-wide actuation).  Returns how many
        workers were told; each applies via ``FleetGateway.retune`` —
        bucket caps only ever select configured buckets."""
        live = self.membership.live()
        for wid in live:
            self._enqueue(wid, {
                "kind": "retune",
                "max_linger_ms": max_linger_ms,
                "bucket_cap": bucket_cap,
                "wire": 2,
            })
        if live:
            self.metrics.count("retunes_broadcast")
        return len(live)

    def broadcast_hot_swap(
        self, params, *, version: Optional[int] = None,
        require_eval=None,
    ) -> int:
        """Land a new checkpoint into every live worker's gateway —
        zero dropped sessions fleet-wide (docs/replay.md "Hot swap").

        ``params`` is the checkpoint tree (numpy/array leaves; this
        process never imports torch — the worker casts on arrival).  The
        version is pinned here so every worker lands the SAME stamp:
        FIFO inbox ordering then bounds each worker's mixed-version
        window to the one flush in flight when the swap message lands,
        and each acks with a ``weights_swapped`` control message the
        fleet summary aggregates.  Returns how many workers were told.

        ``require_eval`` is the quality guardrail: a callable
        ``params -> (ok, detail)`` — typically a
        :class:`fmda_tpu_torch.eval.shadow.ShadowEvaluator`, injected so this
        torch-free role never builds a serving stack itself.  A candidate
        it rejects is **refused**: counted (``hot_swaps_refused``),
        announced on the control topic for operators, zero workers
        told, the fleet keeps serving the incumbent.
        """
        if require_eval is not None:
            ok, detail = require_eval(params)
            if not ok:
                self.metrics.count("hot_swaps_refused")
                try:
                    # lint: ignore[wire-protocol] deliberately consumer-less: the refusal announcement is observability for operators tailing the control topic, not protocol (workers never branch on it)
                    self.bus.publish(self.control_topic, {
                        "kind": "hot_swap_refused",
                        "detail": dict(detail or {}),
                    })
                except (ConnectionError, OSError) as e:
                    # the announcement is observability, not protocol —
                    # a down control bus must not turn a refusal (local
                    # state only) into a crash
                    self.metrics.count("bus_errors")
                    log.warning("hot-swap refusal announcement "
                                "failed: %s", e)
                log.warning("hot swap REFUSED by quality guardrail: %s",
                            detail)
                return 0
        tree = encode_param_tree(params)
        self._swap_version = (version if version is not None
                              else self._swap_version + 1)
        live = self.membership.live()
        for wid in live:
            self._enqueue(wid, {
                "kind": "hot_swap",
                "params": tree,
                "version": int(self._swap_version),
                "wire": 2,
            })
        if live:
            self.metrics.count("hot_swaps_broadcast")
            self.metrics.gauge("weights_version", float(self._swap_version))
        return len(live)

    def _maybe_release_leaving(self) -> None:
        """Stop a leaving worker once no session is assigned to it any
        more (its drains are all complete).  The leave mark is NOT
        cleared here — the worker stays out of live() until its goodbye
        actually arrives, so a join rebalance in the stop→goodbye
        window can never route sessions (or migrated state) into the
        stopping worker's inbox."""
        for wid in sorted(self.membership.leaving - self._stops_sent):
            if self._owned_counts().get(wid):
                continue
            self._enqueue(wid, {"kind": "stop"})
            self._stops_sent.add(wid)

    def _rebalance(self, reason: str) -> None:
        """Re-derive the ownership table from the live set and move (or
        reopen) every session whose range changed hands."""
        live = self.membership.live()
        self.table = OwnershipTable.derive(
            self.table.version + 1, live, self.cfg.hash_space)
        self.metrics.count("rebalances")
        self.metrics.gauge("n_workers", len(live))
        self.metrics.gauge("table_version", self.table.version)
        if self._stopping:
            # the whole topology is exiting: goodbyes must not cascade
            # into pointless migrations between dying workers
            return
        try:
            # lint: ignore[wire-protocol] deliberately consumer-less: the announcement is observability for operators tailing the control topic, not protocol (workers never branch on it)
            self.bus.publish(self.control_topic, {
                "kind": "ownership", "table": self.table.to_wire(),
                "reason": reason,
            })
        except (ConnectionError, OSError) as e:
            # the announcement is observability, not protocol (workers
            # never consume it) — a down control bus must not abort a
            # rebalance that only touches local state + worker inboxes
            self.metrics.count("bus_errors")
            log.warning("ownership announcement failed: %s", e)
        log.info(
            "ownership v%d over %s (%s)", self.table.version, live, reason)
        # "present" = still alive and serving its inbox, even if leaving
        # (a leaving worker is out of live() — it gets no NEW sessions —
        # but it gracefully drains the ones it has)
        present = set(self.membership.workers)
        for sess in self._sessions.values():
            new_owner = self.table.owner_of(sess.session_id)
            if sess.status != "active":
                # migration already in flight: if the exporter died
                # before its state got out (or never existed), the state
                # is gone — reopen fresh; otherwise the state message is
                # still coming and will be routed against the new table
                if sess.owner not in present and sess.pending_state is None:
                    if sess.mig is not None:
                        self.metrics.count("migrations_aborted")
                    self._reopen_lost(sess, new_owner)
                elif sess.pending_state is not None and new_owner is not None:
                    self._complete_migration(sess, new_owner,
                                             sess.pending_state)
                continue
            if new_owner == sess.owner:
                continue
            if sess.owner not in present:
                # owner died with the carried state on board
                self._reopen_lost(sess, new_owner)
            else:
                self._start_migration(sess)
        self._maybe_release_leaving()

    def _start_migration(self, sess: _Session) -> None:
        self._set_status(sess, "migrating")
        sess.mig = f"m{next(self._mig_ids)}"
        self._enqueue(sess.owner, {
            "kind": "drain_session",
            "session": sess.session_id,
            "mig": sess.mig,
            # v2 requester: the worker may export raw-array state;
            # absent (a pre-v2 router), it lowers to base64 envelopes
            "wire": 2,
        })
        self.metrics.count("migrations_started")

    def _on_session_state(self, msg: dict) -> None:
        sess = self._sessions.get(msg.get("session"))
        if sess is None or sess.mig != msg.get("mig"):
            self.metrics.count("stale_session_state")
            return
        # state stays in wire form end to end — the router never decodes
        # the arrays, it only forwards them to the new owner
        new_owner = self.table.owner_of(sess.session_id)
        if new_owner is None:
            # every worker left between export and now: hold the state
            # until one joins (the next rebalance re-enters here)
            sess.pending_state = msg["state"]
            sess.owner = None
            self._owned_cache = None
            return
        self._complete_migration(sess, new_owner, msg["state"])

    def _complete_migration(
        self, sess: _Session, new_owner: str, state: dict
    ) -> None:
        self._enqueue(new_owner, self._open_msg(sess, state=state))
        replayed = len(sess.buffer)
        while sess.buffer:
            self._enqueue(new_owner, sess.buffer.popleft())
        sess.owner = new_owner
        self._set_status(sess, "active")
        sess.mig = None
        sess.pending_state = None
        self.metrics.count("migrations_completed")
        self.metrics.count("migration_replayed_ticks", replayed)
        log.info(
            "session %s migrated to %s (%d buffered ticks replayed)",
            sess.session_id, new_owner, replayed)

    def _reopen_for_restart(self, worker_id: str) -> None:
        """A live worker id came back as a fresh process (revive inside
        the heartbeat window): every session it hosted lost its carried
        state.  Reopen them fresh on their table owner — usually the
        same id, now the new incarnation — through the same counted
        path a detected death takes."""
        for sess in list(self._sessions.values()):
            if sess.owner != worker_id:
                continue
            if sess.mig is not None:
                self.metrics.count("migrations_aborted")
            self._reopen_lost(sess, self.table.owner_of(sess.session_id))

    def _reopen_lost(self, sess: _Session, new_owner: Optional[str]) -> None:
        """The owner died with the session's carried state: reopen fresh
        on the new owner (state restarts from zero — counted, documented
        in the failure matrix) and forward any buffered ticks so the
        stream keeps flowing."""
        if sess.owner is not None:
            # an ownerless session was already counted lost when its
            # owner died; re-entering here on a later rebalance (a
            # worker finally joined) is placement, not a second loss
            # lint: ignore[counted-loss] counts lost SESSION STATE, not ticks — the identity gate uses it to exclude these sessions from bit-identity, never as a summed term
            self.metrics.count("sessions_lost_state")
            self.lost_state_sessions.add(sess.session_id)
        sess.mig = None
        sess.pending_state = None
        if new_owner is None:
            # no workers at all: buffer until one joins
            sess.owner = None
            self._set_status(sess, "migrating")
            return
        # resume the seq stream at the first tick the new owner will
        # actually serve, so (session, seq) never collides
        resume_seq = (sess.buffer[0]["seq"] if sess.buffer
                      else sess.next_seq)
        sess.owner = new_owner
        self._set_status(sess, "active")
        self._enqueue(new_owner, {
            "kind": "open",
            "session": sess.session_id,
            "norm": sess.norm_wire,
            "seq": resume_seq,
            "wire": 2,
        })
        while sess.buffer:
            self._enqueue(new_owner, sess.buffer.popleft())
        log.warning(
            "session %s reopened on %s with FRESH state (previous owner "
            "died undrained)", sess.session_id, new_owner)

    # -- shutdown / introspection -------------------------------------------

    def stop_workers(self, *, graceful: bool = True) -> None:
        """Tell every live worker to exit: ``graceful`` serves every
        queued tick before exiting (final stats arrive with the
        goodbye; carried state is NOT exported — a topology stop ends
        the streams); otherwise a bare stop."""
        self._stopping = True
        kind = "drain_all" if graceful else "stop"
        for wid in sorted(self.membership.workers):  # leaving ones too
            self._enqueue(wid, {"kind": kind})
        self._exchange_data()

    def close(self) -> None:
        """Release every data-plane link (shutdown)."""
        for wid in list(self._links):
            self._close_link(wid)

    @property
    def outstanding_ticks(self) -> int:
        """Routed ticks not yet answered (or aged into a counter)."""
        return len(self._inflight)

    @property
    def migrating_sessions(self) -> int:
        """Sessions whose ticks are buffering (a migration or orphaned
        reopen in flight) — the chaos soak's recovery barrier keys on
        this reaching zero before it probes post-chaos serving."""
        return len(self._migrating)

    def open_session_ids(self) -> List[str]:
        """Ids of every registered session (chaos-soak introspection)."""
        return list(self._sessions)

    def worker_stats(self) -> Dict[str, dict]:
        """Latest heartbeat-carried stats per worker (live + departed)."""
        out = {}
        for wid, info in {**self.membership.departed,
                          **self.membership.workers}.items():
            out[wid] = dict(info.stats)
        return out

    def summary(self) -> Dict[str, object]:
        out = {
            **self.metrics.summary(),
            "table_version": self.table.version,
            "workers": self.membership.live(),
            "worker_stats": self.worker_stats(),
        }
        if self._worker_weights:
            versions = [self._worker_weights.get(w, 0)
                        for w in self.membership.live()]
            out["weights_versions"] = dict(self._worker_weights)
            # 0 spread = no mixed-version window open anywhere
            out["weights_version_spread"] = (
                (max(versions) - min(versions)) if versions else 0)
        return out
