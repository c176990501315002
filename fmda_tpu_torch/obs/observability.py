"""The application-facing observability handle, as
``fmda_tpu.obs.observability`` defines it.

One :class:`Observability` object owns a
:class:`~fmda_tpu_torch.obs.registry.MetricsRegistry`, an
:class:`~fmda_tpu_torch.obs.events.EventLog`, the optional scrape endpoint
(:class:`~fmda_tpu_torch.obs.server.MetricsServer`), and the health checks
``/healthz`` answers from:

- ``bus``: the bus answers (topics reachable);
- ``warehouse``: the warehouse accepts work (probe query commits);
- ``feed_degraded``: no side feed is past its staleness deadline;
- ``warehouse_journal``: the write-ahead journal holds no backlog;
- ``last_tick``: wall-clock age of the newest completed app tick is under
  ``max_tick_age_s`` (healthy until the first tick);
- ``fleet_queue`` / ``predictor_queue``: the attached gateway is not
  saturated (its next submit would shed).

``track_app`` (duck-typed: anything with ``engine``, ``warehouse`` and
``bus``, as the reference's ``Application`` has), ``track_fleet`` and
``track_predictor_fleet`` register scrape-time collectors that translate
the engine's counters, lag and watermarks, its
:class:`~fmda_tpu_torch.utils.tracing.StageTimer`, and a gateway's
:class:`~fmda_tpu_torch.runtime.metrics.RuntimeMetrics` into registry
samples: zero hot-loop cost, sampled only when someone looks.  The tracer,
the kernel ledger and the device memory monitor ride every scrape too, and
so does the chaos runtime (:mod:`fmda_tpu_torch.chaos`): its injected-fault
counters, a ``chaos_fault`` event a fault window's first fire, and the
``chaos`` health check, which names a running drill and never degrades
health for it.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

from fmda_tpu_torch.obs.events import EventLog
from fmda_tpu_torch.obs.registry import (
    MetricsRegistry,
    Sample,
    Snapshot,
    default_registry,
)

#: A health check: () -> (ok, detail).  Exceptions count as failures.
HealthCheck = Callable[[], Tuple[bool, object]]


def stage_timer_families(prefix: str, timer) -> Snapshot:
    """:class:`StageTimer` summary -> registry samples
    (``<prefix>_seconds_total{stage=...}`` + ``<prefix>_count{stage=...}``)."""
    counters = []
    for stage, s in timer.summary().items():
        counters.append({
            "name": f"{prefix}_seconds_total",
            "labels": {"stage": stage},
            "value": s["total_s"],
        })
        counters.append({
            "name": f"{prefix}_count",
            "labels": {"stage": stage},
            "value": s["count"],
        })
    return {"counters": counters}


def runtime_families(metrics, prefix: str = "runtime") -> Snapshot:
    """:class:`RuntimeMetrics` -> registry samples under ``<prefix>_``:
    per-stage latency summaries, every counter as a ``_total``, every
    gauge verbatim, the host StageTimer as stage counters.  The fleet
    gateway exports under the default ``runtime`` prefix; the batched
    Predictor gateway under ``predictor`` (two gateways in one process
    must not collide on series names)."""
    histograms = []
    for stage, h in metrics.histograms.items():
        if not h.n:
            continue
        s: Sample = h.sample()
        s["name"] = f"{prefix}_latency_seconds"
        s["labels"] = {"stage": stage}
        histograms.append(s)
    # dict() first: the gateway hot path inserts keys (count()/gauge()
    # create on first touch) while this runs on the scrape thread, and a
    # bare .items() iteration racing an insert raises RuntimeError.  The
    # C-level copy is atomic under the GIL; the histograms dict is
    # fixed-key from construction, so it needs no copy.
    counters = [
        {"name": f"{prefix}_{name}_total", "labels": {}, "value": value}
        for name, value in dict(metrics.counters).items()
    ]
    gauges = [
        {"name": f"{prefix}_{name}", "labels": {}, "value": value}
        for name, value in dict(metrics.gauges).items()
    ]
    out = stage_timer_families(f"{prefix}_stage", metrics.timer)
    out["counters"] = counters + out.get("counters", [])
    out["gauges"] = gauges
    out["histograms"] = histograms
    return out


def engine_families(engine) -> Snapshot:
    """:class:`StreamEngine` stats + StageTimer -> registry samples."""
    st = engine.stats
    counters = [
        {"name": "engine_emitted_total", "labels": {},
         "value": st["emitted"]},
        {"name": "engine_dropped_total", "labels": {},
         "value": st["dropped"]},
        {"name": "engine_checkpoint_corrupt_total", "labels": {},
         "value": st.get("checkpoint_corrupt", 0)},
    ]
    for topic, n in st.get("degraded_rows", {}).items():
        counters.append({
            "name": "engine_degraded_rows_total",
            "labels": {"topic": topic},
            "value": n,
        })
    gauges = [
        {"name": "engine_pending_joins", "labels": {},
         "value": st["pending"]},
        {"name": "engine_degraded_streams", "labels": {},
         "value": len(st.get("degraded_streams", ()))},
    ]
    for topic, lag in st["consumer_lag"].items():
        gauges.append({
            "name": "engine_consumer_lag",
            "labels": {"topic": topic},
            "value": lag,
        })
    for topic, age in st["watermark_age_s"].items():
        if age is not None:
            gauges.append({
                "name": "engine_watermark_age_seconds",
                "labels": {"stream": topic},
                "value": age,
            })
    out = stage_timer_families("engine_stage", engine.timer)
    out["counters"] = counters + out.get("counters", [])
    out["gauges"] = gauges
    return out


def journal_families(warehouse) -> Snapshot:
    """Write-ahead-journal stats (fmda_tpu_torch.stream.journal) -> registry
    samples: spill/backfill/shed counters + the pending-backlog gauge
    an operator watches through a warehouse outage."""
    stats = warehouse.journal_stats()
    pending = stats.pop("pending", 0)
    return {
        "counters": [
            {"name": f"warehouse_journal_{name}_total", "labels": {},
             "value": value}
            for name, value in sorted(stats.items())
        ],
        "gauges": [
            {"name": "warehouse_journal_pending", "labels": {},
             "value": pending},
        ],
    }


class Observability:
    """Registry + events + health + scrape endpoint for one application."""

    def __init__(
        self,
        config=None,
        *,
        registry: Optional[MetricsRegistry] = None,
        clock=time.monotonic,
        process: Optional[str] = None,
    ) -> None:
        # deferred import: config imports nothing from obs, but keep the
        # dependency one-way regardless
        from fmda_tpu_torch.config import ObservabilityConfig

        self.config = config or ObservabilityConfig()
        enabled = self.config.enabled
        self.registry = (
            registry if registry is not None
            else MetricsRegistry(enabled=enabled)
        )
        if process is not None:
            # fleet worker processes label every exported series with
            # their worker id, so a multi-process scrape never collides
            self.registry.set_process(process)
        if enabled:
            # module-level instrumentation (ingest transports, trainer)
            # reports to the process-default registry; fold it in so one
            # scrape covers the whole process
            self.registry.include(default_registry())
        self.events = EventLog(
            capacity=self.config.events_capacity,
            path=self.config.events_path,
        )
        if self.registry.enabled:
            # the tracer's e2e_tick_seconds histogram + per-stage
            # attribution table ride every /snapshot and `status` (empty
            # while tracing is disabled — the collector is scrape-time
            # only, zero hot-loop cost)
            from fmda_tpu_torch.obs.trace import default_tracer, tracer_families

            tracer = default_tracer()
            self.registry.register_collector(
                "tracing", lambda: tracer_families(tracer))
            # injected-fault accounting (fmda_tpu_torch.chaos): empty
            # while chaos is off; under a fault plan every triggered
            # effect is a counted series and the first fire of each
            # window lands in the event log
            from fmda_tpu_torch.chaos.inject import (
                chaos_families,
                default_chaos,
            )

            chaos = default_chaos()
            self.registry.register_collector(
                "chaos", lambda: chaos_families(chaos))
            # latest instance wins (the fleet telemetry's recorder hooks
            # the same observer, fmda_tpu_torch.obs.aggregate): a
            # first-one-wins guard would pin a discarded instance's event
            # log for the process lifetime.  ("fault", not "kind": the
            # latter is emit()'s positional.)
            chaos.on_fault = (
                lambda point, kind, step: self.events.emit(
                    "chaos_fault", point=point, fault=kind, step=step))
            # device telemetry (fmda_tpu_torch.obs.device): the kernel
            # ledger's launches and sampled device time, MFU, and the
            # memory monitor (sampled here at its cadence) ride every
            # scrape
            from fmda_tpu_torch.obs.device import (
                default_ledger,
                default_memory_monitor,
            )

            ledger = default_ledger()
            memory = default_memory_monitor()

            def device_families() -> Snapshot:
                memory.maybe_sample()
                fams = ledger.families()
                mem = memory.families()
                for kind in mem:
                    fams.setdefault(kind, []).extend(mem[kind])
                return fams

            self.registry.register_collector("device", device_families)
        self.clock = clock
        self.checks: Dict[str, HealthCheck] = {}
        if self.registry.enabled:
            # on /healthz so an operator can tell a chaos drill from a
            # real incident; injected faults never flip health to
            # degraded (the drill is the healthy state)
            def check_chaos():
                from fmda_tpu_torch.chaos.inject import default_chaos

                c = default_chaos()
                if not c.enabled:
                    return True, "disabled"
                return True, (
                    f"ACTIVE step={c.step} injected={c.injected_total()}")

            self.checks["chaos"] = check_chaos
        self.server = None
        self._last_tick: Optional[float] = None

    # -- wiring ---------------------------------------------------------------

    def track_app(self, app) -> None:
        """Register collectors + health checks for an application's bus,
        engine, and warehouse (anything with those three attributes)."""
        if not self.registry.enabled:
            return
        # pre-declare the module-level vocabulary (ingest transports,
        # trainer) in the process-default registry: a scrape must show
        # the full series set at zero, not grow names as code paths run
        from fmda_tpu_torch.ingest.transport import (
            INGEST_COUNTER_NAMES,
            INGEST_HISTOGRAM_NAMES,
        )

        dreg = default_registry()
        for name in INGEST_COUNTER_NAMES:
            dreg.counter(name)
        for name in INGEST_HISTOGRAM_NAMES:
            dreg.histogram(name)
        engine, warehouse, bus = app.engine, app.warehouse, app.bus
        self.registry.register_collector(
            "engine", lambda: engine_families(engine))
        self.registry.register_collector(
            "warehouse",
            lambda: {"gauges": [{
                "name": "warehouse_rows",
                "labels": {},
                "value": len(warehouse),
            }]},
        )
        bind = getattr(bus, "bind_metrics", None)
        if bind is not None:
            bind(self.registry)
        bind_wh = getattr(warehouse, "bind_metrics", None)
        if bind_wh is not None:
            bind_wh(self.registry)

        journal_stats = getattr(warehouse, "journal_stats", None)
        if journal_stats is not None:
            self.registry.register_collector(
                "warehouse_journal", lambda: journal_families(warehouse))

        def check_bus() -> Tuple[bool, object]:
            topics = bus.topics()
            return bool(topics), f"{len(topics)} topics"

        def check_warehouse() -> Tuple[bool, object]:
            healthy = getattr(warehouse, "healthy", None)
            if healthy is not None:
                return bool(healthy()), "probe write"
            return True, "no probe (non-sqlite backend)"

        def check_feed_degraded() -> Tuple[bool, object]:
            # flips degraded while any side stream is past its staleness
            # deadline (rows are flowing with last-known features —
            # counted degradation an operator must see), recovers the
            # moment the feed's watermark catches back up
            stale = engine.degraded_streams()
            if not stale:
                return True, "all feeds fresh"
            rows = engine.stats["degraded_rows"]
            return False, {
                t: f"{rows.get(t, 0)} degraded rows" for t in stale}

        self.checks["bus"] = check_bus
        self.checks["warehouse"] = check_warehouse
        self.checks["feed_degraded"] = check_feed_degraded
        if journal_stats is not None:
            def check_journal() -> Tuple[bool, object]:
                stats = journal_stats()
                pending = stats["pending"]
                if pending == 0:
                    return True, (
                        f"empty ({stats['backfilled_rows']} backfilled, "
                        f"{stats['shed_rows']} shed lifetime)")
                return False, (
                    f"{pending} rows awaiting backfill "
                    f"({stats['spilled_rows']} spilled, "
                    f"{stats['drain_failures']} drain failures)")

            self.checks["warehouse_journal"] = check_journal
        self.checks["last_tick"] = self._check_last_tick

    def track_fleet(self, gateway) -> None:
        """Register the fleet gateway's RuntimeMetrics + saturation check,
        and its pool's tensors with the device memory monitor
        (re-attaching replaces)."""
        if not self.registry.enabled:
            return
        self._track_pool_memory("session_pool", gateway.pool)
        metrics = gateway.metrics
        self.registry.register_collector(
            "runtime", lambda: runtime_families(metrics))

        def check_fleet() -> Tuple[bool, object]:
            depth = len(gateway.batcher)
            return (not gateway.saturated,
                    f"queue depth {depth}/{gateway.queue_bound}")

        self.checks["fleet_queue"] = check_fleet
        self.events.emit(
            "fleet.attached",
            capacity=gateway.pool.capacity,
            queue_bound=gateway.queue_bound,
        )

    def track_predictor_fleet(self, gateway) -> None:
        """Register a batched-Predictor gateway's RuntimeMetrics (under
        the ``predictor_`` series prefix — a carried-state fleet may
        coexist in the same process) + saturation check (re-attaching
        replaces)."""
        if not self.registry.enabled:
            return
        self._track_pool_memory("predictor_pool", gateway.pool)
        metrics = gateway.metrics
        self.registry.register_collector(
            "predictor_runtime",
            lambda: runtime_families(metrics, prefix="predictor"))

        def check_predictor() -> Tuple[bool, object]:
            depth = len(gateway.batcher)
            return (not gateway.saturated,
                    f"queue depth {depth}/{gateway.queue_bound}")

        self.checks["predictor_queue"] = check_predictor
        self.events.emit(
            "predictor_fleet.attached",
            window=gateway.pool.window,
            queue_bound=gateway.queue_bound,
            ring=gateway.pool.use_ring,
        )

    def _track_pool_memory(self, name: str, pool) -> None:
        tensors = getattr(pool, "live_tree", None)
        if tensors is not None:
            from fmda_tpu_torch.obs.device import default_memory_monitor

            default_memory_monitor().register_owner(name, tensors)

    # -- ticks / health -------------------------------------------------------

    def tick(self) -> None:
        """Stamp a completed application tick (drives ``last_tick``)."""
        self._last_tick = self.clock()

    def _check_last_tick(self) -> Tuple[bool, object]:
        if self._last_tick is None:
            return True, "no ticks yet"
        age = self.clock() - self._last_tick
        return (age <= self.config.max_tick_age_s,
                f"age {age:.1f}s (max {self.config.max_tick_age_s:.0f}s)")

    def health(self) -> dict:
        """Run every check; ``status`` is ``"ok"`` iff all pass.  A check
        raising counts as failed (a health probe must never take the
        endpoint down with it)."""
        checks = {}
        ok = True
        for name, fn in sorted(self.checks.items()):
            try:
                passed, detail = fn()
            except Exception as e:  # noqa: BLE001 — loss-free: failure IS the signal — it flips the health verdict it was asked for
                passed, detail = False, f"check raised: {e!r}"
            checks[name] = {"ok": bool(passed), "detail": str(detail)}
            ok = ok and passed
        return {"status": "ok" if ok else "degraded", "checks": checks}

    # -- export ---------------------------------------------------------------

    def snapshot(self) -> Snapshot:
        return self.registry.snapshot()

    def start_server(
        self, *, host: Optional[str] = None, port: Optional[int] = None
    ):
        """Start (or return the already-running) scrape endpoint."""
        import logging

        from fmda_tpu_torch.obs.server import MetricsServer
        from fmda_tpu_torch.obs.trace import default_tracer

        if self.server is not None:
            requested = port if port is not None else self.config.port
            if port is not None and requested != self.server.port:
                logging.getLogger("fmda_tpu_torch.obs").warning(
                    "metrics endpoint already serving on %s; ignoring "
                    "requested port %d", self.server.url, requested)
            return self.server
        from fmda_tpu_torch.obs.device import device_report
        from fmda_tpu_torch.obs.pyprof import default_profiler

        self.server = MetricsServer(
            self.registry,
            host=host if host is not None else self.config.host,
            port=port if port is not None else self.config.port,
            health_fn=self.health,
            events=self.events,
            tracer=default_tracer(),
            profile_fn=lambda: default_profiler().folded(),
            device_fn=device_report,
        ).start()
        self.events.emit("obs.server_started", url=self.server.url)
        return self.server

    def stop_server(self) -> None:
        if self.server is not None:
            self.server.stop()
            self.server = None

    def close(self) -> None:
        self.stop_server()
        self.events.close()
