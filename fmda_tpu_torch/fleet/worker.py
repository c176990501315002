"""A fleet worker process: one FleetGateway/SessionPool behind an inbox, as
``fmda_tpu.fleet.worker`` defines it.

The worker is the single-process fleet runtime embedded unchanged —
the same :class:`~fmda_tpu_torch.runtime.gateway.FleetGateway` admission/
batching/publish path, the same :class:`~fmda_tpu_torch.runtime.session_pool
.SessionPool` carried state — driven by its **inbox topic** instead of
direct calls.  Everything the router sends (opens, ticks, closes,
migration drains) arrives on one FIFO topic and is applied in offset
order, which is the whole ordering argument (see
:mod:`fmda_tpu_torch.fleet.router`); results flow back on the shared
prediction topic exactly as in-process serving publishes them.

This module is worker-role code: torch (via the runtime) is imported
freely.  The pool runs on the card unless ``device="cpu"`` is given.

**No compile counters.**  The reference's heartbeat carries
``compile_count``, ``recompiles_after_warmup`` and ``compile_seconds``
(XLA compiles one program per bucket, and a compile after warm-up is an
alert).  The port compiles nothing per shape: every kernel is built once
by ``nvcc`` and takes every bucket.  So the heartbeat carries
``kernel_launches_by_bucket`` (the gateway's per-bucket kernel launches,
the counterpart of compiles per bucket) where the reference carries
``compile_count``, and the two other keys are dropped; the ``recompile``
SLO objective has no signal in the port (:mod:`fmda_tpu_torch.obs.slo`).
Beside it, ``kernel_launches`` names the kernels: each kernel's launches
in the worker's process since its warm-up.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional

import numpy as np

from fmda_tpu_torch.chaos.inject import default_chaos
from fmda_tpu_torch.config import (
    FleetTopologyConfig,
    RuntimeConfig,
    TOPIC_FLEET_CONTROL,
    fleet_worker_topic,
)
from fmda_tpu_torch.stream import codec
from fmda_tpu_torch.fleet.membership import Heartbeater
from fmda_tpu_torch.fleet.state import (
    decode_norm,
    decode_param_tree,
    decode_row,
    decode_session_state,
    encode_array,
    encode_session_state,
    to_legacy,
)
from fmda_tpu_torch.ops import launch_counts
from fmda_tpu_torch.runtime.batcher import BatcherConfig
from fmda_tpu_torch.runtime.gateway import FleetGateway
from fmda_tpu_torch.runtime.session_pool import PoolExhausted, SessionPool

log = logging.getLogger("fmda_tpu_torch.fleet")

#: chaos injection (fmda_tpu_torch.chaos): disabled = one branch per step
_CHAOS = default_chaos()


class FleetWorker:
    """Owns one slot-range of the session space; serves its inbox."""

    def __init__(
        self,
        worker_id: str,
        bus,
        model_cfg,
        params,
        *,
        config: Optional[FleetTopologyConfig] = None,
        runtime: Optional[RuntimeConfig] = None,
        capacity: Optional[int] = None,
        control_topic: str = TOPIC_FLEET_CONTROL,
        clock: Callable[[], float] = time.monotonic,
        precompile: bool = True,
        gateway_kwargs: Optional[dict] = None,
        data_bus=None,
        data_address: Optional[str] = None,
        reconnect_fn: Optional[Callable[[], object]] = None,
        device=None,
        qos=None,
    ) -> None:
        self.worker_id = worker_id
        self.bus = bus
        #: the worker's data plane: its inbox + its results.  Defaults
        #: to the control bus (one shared broker).  The scaling shape is
        #: a **worker-hosted** data bus (``data_bus`` = a local bus this
        #: process serves to the router via BusServer, ``data_address``
        #: announced in every heartbeat): the serving hot path then
        #: never crosses a socket — only the router's pump does, once
        #: per worker — so adding workers adds data-plane capacity
        #: instead of contending for one broker.
        self.data_bus = data_bus if data_bus is not None else bus
        self._split = self.data_bus is not bus
        self.cfg = config or FleetTopologyConfig()
        rc = runtime or RuntimeConfig()
        capacity = capacity if capacity is not None else rc.capacity
        self.pool = SessionPool(
            model_cfg, params, capacity=capacity, window=rc.window,
            device=device)
        kwargs = dict(
            batcher_config=BatcherConfig(
                bucket_sizes=tuple(rc.bucket_sizes),
                max_linger_s=rc.max_linger_ms / 1e3),
            queue_bound=rc.queue_bound,
            pipeline_depth=rc.pipeline_depth,
        )
        kwargs.update(gateway_kwargs or {})
        # on a shared SocketBus, everything this worker publishes
        # (results, heartbeats, migration state) buffers and rides the
        # step's ONE batched frame together with the inbox read — round
        # trips, not bytes, are the transport's cost (fmda_tpu_torch.fleet
        # .wire).  With a worker-hosted data bus, publishes are local
        # and only the rare control messages cross the socket.
        self._batch_bus = (
            bus if not self._split and hasattr(bus, "batch") else None)
        if self._batch_bus is not None:
            from fmda_tpu_torch.fleet.wire import BufferedPublisher

            self._pub = BufferedPublisher(bus)
        else:
            self._pub = bus  # control messages go straight out
        # dynamic topic creation (ROADMAP (c)): a worker joining beyond
        # the bus's launch-time topic set brings its own inbox (and the
        # shared results topic) with it — NativeBus/InProcessBus/KafkaBus
        # and the wire transport all speak add_topic; buses without it
        # keep the old contract (topics pre-created at construction)
        from fmda_tpu_torch.config import TOPIC_FLEET_PREDICTION

        add_topic = getattr(self.data_bus, "add_topic", None)
        if add_topic is not None:
            for topic in (fleet_worker_topic(worker_id),
                          TOPIC_FLEET_PREDICTION):
                if topic not in self.data_bus.topics():
                    add_topic(topic)
        self.gateway = FleetGateway(
            self.pool,
            self.data_bus if self._split else self._pub,
            **kwargs)
        self.metrics = self.gateway.metrics
        if qos is not None:
            # per-tenant QoS policy (fmda_tpu_torch.control.qos): overload
            # shedding at this gateway becomes class-aware; sessions
            # arrive labeled through the router's open messages
            self.gateway.attach_qos(qos)
        self._inbox = self.data_bus.consumer(fleet_worker_topic(worker_id))
        announce = {"address": data_address} if data_address else None
        self.heartbeater = Heartbeater(
            self._pub, worker_id, control_topic=control_topic,
            interval_s=self.cfg.heartbeat_interval_s,
            capacity=capacity, clock=clock, announce=announce)
        self.control_topic = control_topic
        self.clock = clock
        self.stopped = False
        #: next inbox offset we expect (gap ⇒ records evicted unread)
        self._next_offset: Optional[int] = None
        #: rebuilds the control-bus connection after a transport failure
        #: (the CLI passes a SocketBus re-dial); None = no reconnect
        self._reconnect_fn = reconnect_fn
        #: control plane currently unreachable (beats failing) — the
        #: worker keeps serving its local data plane and re-dials on a
        #: cadence; a reconnect re-hellos WITH the session report, which
        #: is how a restarted router adopts this worker's sessions
        self._control_down = False
        #: migrations whose exported state never left this process
        #: (control publish failed): session -> (mig id, requester wire
        #: capability), re-drained and re-exported once the control
        #: plane answers again — without this the router would wait on
        #: a ``session_state`` that is never coming and the session
        #: would buffer forever
        self._failed_drains: Dict[str, tuple] = {}
        self._last_reconnect: float = float("-inf")
        self._first_bus_error: Optional[float] = None
        if precompile:
            # one padding-only flush per bucket, outside the gateway (its
            # launch counters book none of it): the first builds the
            # kernels (nvcc, once per source hash), and each primes the
            # caching allocator for its bucket before the first real tick
            feats = model_cfg.n_features
            for b in self.gateway.batcher.config.bucket_sizes:
                self.pool.step(
                    np.full(b, self.pool.padding_slot, np.int32),
                    np.zeros((b, feats), np.float32))
        #: every kernel's launches in this process once warm-up is done;
        #: ``stats()["kernel_launches"]`` is the change since, by kernel
        #: (the process's own count: one worker a process, as the
        #: launcher runs them)
        self._launches_at_start = launch_counts()
        # device memory attribution: this pool's live tensors, sampled
        # on the worker loop at the monitor's cadence (one clock read per
        # step when not due)
        from fmda_tpu_torch.obs.device import (
            default_ledger,
            default_memory_monitor,
        )

        self._ledger = default_ledger()
        self._memory = default_memory_monitor()
        self._memory.register_owner(
            f"session_pool:{worker_id}", self.pool.live_tree)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Announce membership (the router rebalances on the hello).
        The hello carries this worker's open-session report, so a
        router that restarted while we kept serving rebuilds its
        registry from the re-hello alone (failover, docs/chaos.md)."""
        self._hello_with_report()
        if self._batch_bus is not None:
            self._pub.flush()  # the hello must not wait for a step

    def _hello_with_report(self) -> None:
        """Hello carrying the open-session report — the router-failover
        handshake (start, shared-bus retry, and control re-dial all
        announce this worker the same way; a new or restarted router
        rebuilds its registry from exactly this message)."""
        report = self.session_report()
        self.heartbeater.hello(
            self.stats(), extra={"sessions": report} if report else None)

    def _control_is_json(self) -> bool:
        """Did the control link negotiate down to the JSON fallback?
        Then array payloads this worker exports (session reports,
        migrated state) are lowered to the pre-v2 base64 envelopes too
        — the peer may genuinely predate the raw-array shapes.  In-
        process buses have no negotiation: same-code peers, full v2.
        Router-originated requests additionally declare their own
        capability in a ``wire`` field (broker-mediated topologies:
        this link's format says nothing about the router's age) — the
        request handlers check both signals."""
        return getattr(self.bus, "negotiated_format", None) == "json"

    def session_report(
        self, *, legacy: Optional[bool] = None
    ) -> Dict[str, dict]:
        """Authoritative open-session map: id → next result ``seq`` +
        normalization stats (wire form).  This is what router failover
        rebuilds the session registry from — the workers, not the dead
        router, own the truth about what is being served."""
        out: Dict[str, dict] = {}
        for sid in self.pool.session_ids():
            handle = self.pool.handle_for(sid)
            x_min, x_range = self.pool.slot_norm(handle)
            out[sid] = {
                "seq": self.gateway.session_seq(sid),
                "norm": {
                    "x_min": encode_array(x_min),
                    "x_max": encode_array(x_min + x_range),
                },
            }
            tenant = self.gateway.session_tenant(sid)
            if tenant is not None:
                # the QoS class survives router failover with the rest
                # of the session truth this report rebuilds
                out[sid]["tenant"] = tenant
            if self.gateway.weights_version is not None:
                # which checkpoint generation served this session last —
                # makes mixed-version windows visible in the report a
                # failover rebuilds from (pre-swap reports stay
                # byte-identical: the key only appears after a swap)
                out[sid]["weights_version"] = self.gateway.weights_version
        if legacy is None:
            legacy = self._control_is_json()
        if out and legacy:
            out = to_legacy(out)
        return out

    def stats(self) -> Dict[str, object]:
        """The serving stats every heartbeat carries."""
        c = self.metrics.counters
        out = {
            "active_sessions": self.pool.n_active,
            "ticks_served": c.get("ticks_served", 0),
            "flushes": c.get("flushes", 0),
            "shed_oldest": c.get("shed_oldest", 0),
            # rides the beat so the router (and the bench's zero-loss
            # gate) can see a worker-side inbox overrun — the counter
            # lives in this process, not the router's
            "inbox_records_lost": c.get("inbox_records_lost", 0),
            # where the reference carries compile_count: kernel launches
            # per flush bucket (keys as strings: the stats stay JSON and
            # wire clean)
            "kernel_launches_by_bucket": {
                str(b): n for b, n in sorted(
                    self.gateway.kernel_launches_by_bucket.items())},
            # and by kernel: which kernels those launches were
            "kernel_launches": {
                k: n - self._launches_at_start[k]
                for k, n in launch_counts().items()},
            "queue_depth": len(self.gateway.batcher),
            # device telemetry (fmda_tpu_torch.obs.device): the beat
            # carries the memory truth so the router-side SLO engine can
            # alert fleet-wide without scraping
            "live_bytes": self._memory.doc()["owners_bytes"],
            "memory_watermark_bytes": self._memory.watermark_bytes,
            "memory_leak_suspected": (
                1 if self._memory.leak_suspected else 0),
            "device_mfu": self._ledger.mfu(),
        }
        if self.gateway.weights_version is not None:
            # the beat carries the serving checkpoint generation, so
            # the router-side summary can report the fleet's version
            # spread without an extra round trip
            out["weights_version"] = self.gateway.weights_version
        version_ticks = self.gateway.version_ticks
        if version_ticks:
            # per-checkpoint serving attribution (quality plane): which
            # version served how many of this worker's ticks — keys as
            # strings so the stats dict stays JSON/wire-clean
            out["version_ticks"] = {
                str(v): n for v, n in sorted(version_ticks.items())}
        # per-class admit/shed attribution (fmda_tpu_torch.control QoS): the
        # gateway counts these in this process; the beat carries them so
        # the control plane can fold fleet-wide per-tenant rates
        tenant_counters = {
            k: v for k, v in c.items()
            if k.startswith(("admitted_class_", "shed_class_"))}
        if tenant_counters:
            out["tenant_counters"] = tenant_counters
        return out

    def step(self) -> int:
        """One worker cycle: apply a bounded slice of the inbox, pump
        the gateway, heartbeat if due.  Returns an activity count
        (inbox records applied + results published) — zero means idle,
        which the run loop's poll backoff keys on."""
        if _CHAOS.enabled:
            # injection point "worker.step": delay/hang stalls the loop
            # (the false-reap / late-heartbeat shape); kill raises a
            # ConnectionError the run loop's hardening absorbs
            _CHAOS.check("worker.step")
        # beat first: a long pump last cycle must not push two beats
        # more than one step duration apart
        self._beat_counted()
        # device memory cadence: one clock read per step when not due
        self._memory.maybe_sample()
        if self._failed_drains and not self._control_down:
            self._retry_failed_drains()
        processed = 0
        for rec in self._poll_inbox():
            processed += 1
            if self._next_offset is not None and rec.offset > self._next_offset:
                # records fell off the inbox's retention before we read
                # them (backlog outran the bus arena) — the contract is
                # counted degradation, never a silent skip
                lost = rec.offset - self._next_offset
                self.metrics.count("inbox_records_lost", lost)
                log.error(
                    "worker %s: %d inbox records evicted unread "
                    "(offsets %d..%d) — raise the bus arena or slow "
                    "the producer", self.worker_id, lost,
                    self._next_offset, rec.offset - 1)
            self._next_offset = rec.offset + 1
            self._apply(rec.value)
            if self.stopped:
                break
        served = len(self.gateway.pump())
        return processed + served

    def _beat_counted(self) -> None:
        """Heartbeat with the control plane's failure absorbed: a worker
        whose router (or broker) vanished keeps serving its local data
        plane — counted degradation, never abort.  While down, the
        control bus is re-dialed on a cadence; success re-hellos with
        the session report (a restarted router adopts us from it)."""
        try:
            if self._control_down:
                self._maybe_reconnect_control()
                return
            self.heartbeater.beat(self.stats())
        except (ConnectionError, OSError) as e:
            self.metrics.count("control_errors")
            if not self._control_down:
                log.warning(
                    "worker %s: control plane unreachable (%s) — serving "
                    "continues, re-dialing%s", self.worker_id, e,
                    "" if self._reconnect_fn else " on the same bus")
            self._control_down = True

    def _maybe_reconnect_control(self) -> None:
        now = self.clock()
        if now - self._last_reconnect < self.cfg.control_retry_s:
            return
        self._last_reconnect = now
        if self._reconnect_fn is None:
            # no transport to rebuild (shared-broker worker): retry the
            # SAME bus on the cadence — one transient publish error must
            # not mute a healthy worker's heartbeats forever (the router
            # would falsely reap it and lose real carried state).  The
            # re-hello carries the session report, same as a re-dial.
            try:
                self._hello_with_report()
            except (ConnectionError, OSError):
                self.metrics.count("control_reconnect_failures")
                return
            self._control_down = False
            self.metrics.count("control_reconnects")
            log.info(
                "worker %s: control plane recovered", self.worker_id)
            return
        try:
            new_bus = self._reconnect_fn()
        except (ConnectionError, OSError):
            self.metrics.count("control_reconnect_failures")
            return
        old = self.bus
        self.bus = new_bus
        # reconnect is a split-topology feature (the data plane is local,
        # only control traffic rides this bus); a shared-bus worker that
        # lost its one broker exits after the grace instead (run loop)
        self._pub = new_bus
        self.heartbeater.bus = new_bus
        # re-bind the obs series to the LIVE link: without this the
        # registry's wire collector keeps sampling the dead SocketBus
        # (frozen frames_*_total, stale wire_format_binary) and the new
        # link's publishes go uncounted
        registry = getattr(old, "metrics_registry", None)
        if registry is not None:
            bind = getattr(new_bus, "bind_metrics", None)
            if bind is not None:
                try:
                    bind(registry)
                # loss-free: metrics re-binding must never turn a
                # reconnect fatal; the stale collector only skews obs
                except (ConnectionError, OSError):
                    pass
        self._control_down = False
        self.metrics.count("control_reconnects")
        log.info("worker %s: control plane reconnected", self.worker_id)
        close = getattr(old, "close", None)
        if close is not None:
            try:
                close()
            except OSError:  # loss-free: teardown of the dead control bus
                pass
        # re-hello with the session report: a NEW router on the other
        # end rebuilds its registry from exactly this message
        self._hello_with_report()

    def _poll_inbox(self):
        """Inbox records for this step.  Over a batched SocketBus, one
        frame carries every buffered publish (last pump's results,
        heartbeats, migration state — in publish order) AND the inbox
        read; otherwise a plain consumer poll."""
        if self._batch_bus is None:
            return self._inbox.poll(
                max_records=self.cfg.worker_poll_max_records)
        bus = self._batch_bus
        ops = self._pub.take_ops()
        read_op = {
            "op": "read",
            "topic": self._inbox.topic,
            "offset": self._inbox.offset,
            "max_records": self.cfg.worker_poll_max_records,
        }
        ops.append(read_op)
        resps = bus.batch(ops)
        for op, resp in zip(ops[:-1], resps[:-1]):
            if "err" in resp:
                # a failed publish loses results — counted, never silent
                self.metrics.count(
                    "publish_errors", len(op.get("values", ())))
                log.error("worker %s: batched publish to %r failed: %s",
                          self.worker_id, op.get("topic"), resp["err"])
        rows = bus.unwrap_op(read_op, resps[-1])
        from fmda_tpu_torch.stream.bus import Record

        records = [Record(self._inbox.topic, int(o), v) for o, v in rows]
        if records:
            self._inbox.offset = records[-1].offset + 1
        return records

    def run(
        self,
        *,
        poll_interval_s: float = 0.0005,
        duration_s: Optional[float] = None,
        should_stop: Optional[Callable[[], bool]] = None,
        sleep_fn: Callable[[float], None] = time.sleep,
    ) -> Dict[str, object]:
        """Serve until a ``stop``/``drain_all`` arrives (or the optional
        duration/should_stop safety valves fire); returns final stats."""
        self.start()
        deadline = (self.clock() + duration_s
                    if duration_s is not None else None)
        idle_sleep = poll_interval_s
        while not self.stopped:
            if should_stop is not None and should_stop():
                self._shutdown()
                break
            if deadline is not None and self.clock() >= deadline:
                log.warning(
                    "worker %s exiting on duration safety valve",
                    self.worker_id)
                self._shutdown()
                break
            try:
                activity = self.step()
            except (ConnectionError, OSError) as e:
                # the shared bus (inbox + results in one broker) went
                # away mid-step: counted, retried under a grace window,
                # and — if the broker never returns — a CLEAN exit, not
                # a crash (the never-abort contract; a split-topology
                # worker instead keeps serving through _beat_counted)
                self.metrics.count("bus_errors")
                now = self.clock()
                if self._first_bus_error is None:
                    self._first_bus_error = now
                    log.warning(
                        "worker %s: bus transport failed (%s); retrying "
                        "for %.0fs", self.worker_id, e,
                        self.cfg.bus_error_grace_s)
                if now - self._first_bus_error > self.cfg.bus_error_grace_s:
                    lost = len(self.gateway.batcher)
                    if lost:
                        self.metrics.count("ticks_lost_on_exit", lost)
                    log.error(
                        "worker %s: bus unreachable for %.0fs — exiting "
                        "cleanly (%d queued ticks lost, counted)",
                        self.worker_id, now - self._first_bus_error, lost)
                    self.stopped = True
                    break
                sleep_fn(min(0.5, poll_interval_s * 50 + 0.05))
                continue
            self._first_bus_error = None
            if activity:
                idle_sleep = poll_interval_s
            else:
                # adaptive idle backoff: an idle worker polling flat-out
                # is pure load on the broker (N workers × empty reads);
                # back off to a few ms, snap back on the first record
                idle_sleep = min(idle_sleep * 2, 0.005)
                sleep_fn(idle_sleep)
        return self.stats()

    def _shutdown(self) -> None:
        """Serve everything queued, say goodbye with final stats, stop.
        The goodbye is best-effort: a router that sends ``stop`` and
        tears its bus server down immediately (or died outright) must
        not turn this worker's clean exit into a crash."""
        self.gateway.drain()
        try:
            self.heartbeater.goodbye(self.stats())
            if self._batch_bus is not None:
                self._pub.flush()  # last results + goodbye actually leave
        except (ConnectionError, OSError) as e:
            self.metrics.count("goodbye_failed")
            log.warning(
                "worker %s: goodbye publish failed (%s) — router gone; "
                "exiting anyway", self.worker_id, e)
        self.stopped = True

    # -- inbox handlers ------------------------------------------------------

    def _apply(self, msg: dict) -> None:
        kind = msg.get("kind")
        wire_v = int(msg.get("wire", 0))
        if kind == "tick_block" or wire_v >= 2:
            # v2 evidence: only a v2 router sends columnar tick blocks
            # or stamps ``wire: 2`` into its control messages — results
            # may flow back as columnar blocks from here on (a pre-v2
            # router, which could not parse them, never shows either
            # signal, so it keeps getting per-tick dicts)
            self.gateway.result_blocks = True
        elif wire_v < 2 and kind in (
                "open", "drain_session", "report_sessions"):
            # DOWNGRADE evidence: these are exactly the kinds a v2
            # router always stamps, so their absence means the live
            # router is pre-v2 — a takeover by an older binary while
            # this worker kept serving (docs/chaos.md) must roll the
            # result dialect back or every multi-tick flush would be
            # dropped as foreign records on the other end
            self.gateway.result_blocks = False
        if kind == "tick":
            self._on_tick(msg)
        elif kind == "tick_block":
            self._on_tick_block(msg)
        elif kind == "open":
            self._on_open(msg)
        elif kind == "close":
            self._on_close(msg)
        elif kind == "drain_session":
            self._on_drain_session(msg)
        elif kind == "report_sessions":
            # a router that restarted mid-serve asks for the session map
            # it lost; the reply is the same shape the hello carries —
            # lowered to pre-v2 envelopes unless the REQUEST declared a
            # v2 requester (the link format only describes the broker)
            self._publish_control_counted({
                "kind": "session_report",
                "worker": self.worker_id,
                "sessions": self.session_report(
                    legacy=(self._control_is_json()
                            or int(msg.get("wire", 1)) < 2)),
            })
            self.metrics.count("session_reports")
        elif kind == "retune":
            # batching-controller actuation (fmda_tpu.control): swap the
            # gateway's linger/bucket knobs in place — never a compile,
            # never a dropped tick, applies between two pump cycles
            linger = msg.get("max_linger_ms")
            cap = msg.get("bucket_cap")
            self.gateway.retune(
                max_linger_ms=float(linger) if linger is not None else None,
                bucket_cap=int(cap) if cap is not None else None)
        elif kind == "hot_swap":
            self._on_hot_swap(msg)
        # lint: ignore[wire-protocol] operator entry point: published by hand (or tooling) onto a worker inbox — nothing in the package produces it by design
        elif kind == "leave":
            # operator-initiated graceful leave: tell the router, which
            # migrates our sessions off and stops us when none remain
            self._publish_control_counted({
                "kind": "leaving", "worker": self.worker_id})
            self.metrics.count("leave_requested")
        elif kind in ("drain_all", "stop"):
            self._shutdown()
        else:
            self.metrics.count("unknown_inbox_messages")
            log.warning(
                "worker %s: unknown inbox message kind %r",
                self.worker_id, kind)

    def _on_hot_swap(self, msg: dict) -> None:
        """Land a router-broadcast checkpoint into the live gateway.

        The gateway's swap barrier publishes every old-weights result
        before the version flips, and FIFO inbox ordering means every
        tick already queued behind this message is served by the new
        weights — the worker's mixed-version window is exactly the one
        flush in flight at swap time.  A refused checkpoint (structure
        or shape drift) is counted and logged, never fatal: serving the
        old weights beats serving nothing."""
        try:
            params = decode_param_tree(msg["params"])
            version = self.gateway.hot_swap(
                params, version=msg.get("version"))
        except Exception as e:  # noqa: BLE001 — loss-free: a bad
            # checkpoint must degrade to "swap refused, old weights
            # keep serving", visibly, never crash the serving loop
            self.metrics.count("hot_swap_errors")
            log.error(
                "worker %s: hot swap refused: %s", self.worker_id, e)
            return
        self._publish_control_counted({
            "kind": "weights_swapped",
            "worker": self.worker_id,
            "version": int(version),
        })

    def _publish_control_counted(self, msg: dict) -> bool:
        """Control-topic publish with the transport failure absorbed
        (counted ``control_errors``); returns whether it landed.  The
        chaos contract: losing a control message degrades the fleet
        visibly — it must never crash the serving loop."""
        try:
            self._pub.publish(self.control_topic, msg)
            return True
        except (ConnectionError, OSError) as e:
            self.metrics.count("control_errors")
            self._control_down = True
            log.warning(
                "worker %s: control publish (%s) failed: %s",
                self.worker_id, msg.get("kind"), e)
            return False

    def _on_open(self, msg: dict) -> None:
        sid = msg["session"]
        if self.pool.handle_for(sid) is not None:
            state = msg.get("state")
            if (state is not None
                    and self.gateway.session_seq(sid) > int(state["seq"])):
                # a requeued duplicate of an open this session already
                # served past (the original frame landed but its response
                # read failed): re-importing the snapshot would silently
                # roll the carried state back — keep the newer state
                self.metrics.count("duplicate_opens_stale")
                log.warning(
                    "worker %s: stale duplicate open(+state) for %s "
                    "(snapshot seq %d < live seq %d) — ignored",
                    self.worker_id, sid, int(state["seq"]),
                    self.gateway.session_seq(sid))
                return
            # a duplicate open is a protocol violation upstream; recover
            # by replacing (the router's registry is authoritative)
            self.metrics.count("duplicate_opens")
            log.warning(
                "worker %s: duplicate open for %s — replacing",
                self.worker_id, sid)
            self.gateway.close_session(sid)
        try:
            if msg.get("state") is not None:
                state = decode_session_state(msg["state"])
                if msg.get("tenant") is not None:
                    # the router's registry label wins when the exporting
                    # gateway never learned the class (an adopted session)
                    state.setdefault("tenant", msg["tenant"])
                self.gateway.import_session(sid, state)
                self.metrics.count("sessions_migrated_in")
            else:
                self.gateway.open_session(
                    sid, decode_norm(msg.get("norm")),
                    seq=int(msg.get("seq", 0)),
                    tenant=msg.get("tenant"))
        except PoolExhausted:
            # counted at the gateway too (rejected_sessions); tell the
            # router so the failure is visible fleet-wide
            self._publish_control_counted({
                "kind": "open_failed",
                "worker": self.worker_id,
                "session": sid,
                "error": f"pool exhausted ({self.pool.capacity} slots)",
            })

    def _on_tick(self, msg: dict) -> None:
        self._submit_tick(
            msg["session"], msg["row"], msg.get("seq"), msg.get("trace"))

    def _on_tick_block(self, msg: dict) -> None:
        """A columnar run of ticks (fmda_tpu_torch.stream.codec): the rows
        arrive as ONE contiguous (B, F) float32 array — on a binary
        link a zero-copy view into the received frame — and each tick's
        staging copy in :meth:`FleetGateway.submit` is the first copy
        the row ever pays on this host."""
        for sid, row, seq, trace in codec.iter_ticks(msg):
            self._submit_tick(sid, row, seq, trace)

    def _submit_tick(self, sid: str, row_wire, seq, trace) -> None:
        if self.pool.handle_for(sid) is None:
            # close/tick race or an open that failed: visible skip
            self.metrics.count("ticks_for_unknown_session")
            return
        row = decode_row(row_wire, self.pool.cfg.n_features)
        if self.gateway.saturated:
            # well-behaved consumer: serve the backlog instead of
            # racing the gateway's shedder (no tick is ever dropped on
            # the floor by the worker itself)
            self.gateway.pump(force=True)
            self.metrics.count("forced_pumps")
        if (seq is not None
                and self.gateway.session_seq(sid) != seq):
            # the streams diverged — ticks were lost in transit (a
            # partitioned link's frame, counted router-side).  Resync
            # to the router's counter: without this, every later
            # result would match the WRONG in-flight tick forever;
            # with it, exactly the lost ticks age out as
            # results_missing and the stream re-aligns.  Counted —
            # divergence is a failure event, never silent.
            self.metrics.count("seq_resyncs")
            self.gateway.resync_seq(sid, int(seq))
        self.gateway.submit(sid, row, wire=trace)

    def _on_close(self, msg: dict) -> None:
        sid = msg["session"]
        if self.pool.handle_for(sid) is None:
            self.metrics.count("close_for_unknown_session")
            return
        self.gateway.close_session(sid)

    def _on_drain_session(self, msg: dict) -> None:
        """Migration source side: serve everything queued, export the
        session bit-exact, hand the state to the router via the control
        topic, release the slot."""
        sid = msg["session"]
        self._failed_drains.pop(sid, None)
        if self.pool.handle_for(sid) is None:
            self.metrics.count("drain_for_unknown_session")
            log.warning(
                "worker %s: drain_session for unknown %s",
                self.worker_id, sid)
            return
        # drain the WHOLE gateway: the batcher may hold this session's
        # ticks behind other sessions', and a flush is all-or-nothing —
        # serving everything queued guarantees the exported state is
        # current and every pre-drain result is published
        self.gateway.drain()
        state = encode_session_state(self.gateway.export_session(sid))
        if self._control_is_json() or int(msg.get("wire", 1)) < 2:
            state = to_legacy(state)  # pre-v2 envelopes for an old peer
        # buffered AFTER the drained results, so the broker lands every
        # pre-drain result before the state (the router's ordering
        # argument leans on exactly this)
        landed = self._publish_control_counted({
            "kind": "session_state",
            "worker": self.worker_id,
            "session": sid,
            "mig": msg.get("mig"),
            "state": state,
        })
        if landed and self._batch_bus is not None:
            # over a batched SocketBus the publish above only QUEUED the
            # state in the BufferedPublisher — push the frame out now
            # and find out whether it actually landed.  Closing the
            # session on a buffered-but-unsent export would destroy the
            # only copy the moment the next batch frame failed.
            landed = self._flush_control_batched()
        if not landed:
            # the exported state never left this process: closing the
            # session now would destroy the only copy.  Keep serving it
            # and retry from the step loop once the control plane is
            # back (a retry re-drains and re-exports, so the state is
            # current; the stale mig id on any late duplicate is
            # ignored router-side)
            self.metrics.count("drain_export_failed")
            self._failed_drains[sid] = (
                msg.get("mig"), int(msg.get("wire", 1)))
            return
        self.gateway.close_session(sid)
        self.metrics.count("sessions_migrated_out")

    def _flush_control_batched(self) -> bool:
        """Flush the BufferedPublisher in one batched frame and report
        whether every control-topic op landed.  Values in failed ops are
        lost — counted exactly like ``_poll_inbox``'s batched-publish
        failures (the dropped results age into ``results_missing``
        router-side)."""
        ops = self._pub.take_ops()
        if not ops:
            return True
        try:
            resps = self._batch_bus.batch(ops)
        except (ConnectionError, OSError) as e:
            self.metrics.count("control_errors")
            self.metrics.count(
                "publish_errors",
                sum(len(op.get("values", ())) for op in ops))
            log.warning(
                "worker %s: control flush failed: %s", self.worker_id, e)
            return False
        ok = True
        for op, resp in zip(ops, resps):
            if "err" in resp:
                self.metrics.count(
                    "publish_errors", len(op.get("values", ())))
                log.error(
                    "worker %s: batched publish to %r failed: %s",
                    self.worker_id, op.get("topic"), resp["err"])
                if op.get("topic") == self.control_topic:
                    ok = False
        return ok

    def _retry_failed_drains(self) -> None:
        """Re-run the drain for every migration whose state export
        failed, now that the control plane answers again.  Each retry
        re-exports fresh state (the session kept serving meanwhile), so
        the router never imports a stale snapshot."""
        for sid, (mig, wire) in list(self._failed_drains.items()):
            if self.pool.handle_for(sid) is None:
                self._failed_drains.pop(sid, None)  # closed meanwhile
                continue
            self.metrics.count("drain_export_retries")
            self._on_drain_session(
                {"session": sid, "mig": mig, "wire": wire})
            if sid in self._failed_drains:
                return  # control plane still down — keep the rest queued
