"""Router-side fleet aggregation: one telemetry plane for N workers, as
``fmda_tpu.obs.aggregate`` defines it.

Per-process observability answers "how is *this* worker";
nothing answered "how is the *fleet*" — yet the heartbeats already carry
every worker's serving counters to the router, and every worker with a
``--metrics-port`` serves a ``/snapshot``.  This module folds both into
the :class:`~fmda_tpu_torch.obs.tsdb.TimeSeriesStore`, labeled ``process=``:

- :class:`FleetAggregator` — the pure fold: router RuntimeMetrics
  (routed/served/lost counters, the end-to-end ``total`` histogram
  snapshot), heartbeat-carried per-worker stats, and scraped registry
  snapshots, each into bounded fixed-interval series;
- :class:`FleetTelemetry` — the composition root a router role owns:
  store + aggregator + :class:`~fmda_tpu_torch.obs.slo.SLOEngine` +
  (optional) :class:`~fmda_tpu_torch.obs.recorder.FlightRecorder`, behind one
  cadence-gated :meth:`FleetTelemetry.maybe_collect` call from the
  router loop (one clock read when not due — the aggregation path
  stays off the tick hot path; everything else is scrape-time work).

Fleet-level series exposed on the router's own MetricsServer
(``/query?series=&window=`` + ``/alerts``): ``fleet_ticks_per_s``,
``fleet_e2e_p99_ms``, ``fleet_e2e_seconds`` (the histogram itself),
per-worker ``worker_ticks_served_total`` / ``worker_queue_depth`` /
``worker_inbox_records_lost_total``, loss counters, and everything a
worker snapshot carries (``process=``-labeled).

torch-free: this runs in the router process (bus-only host).
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional

from fmda_tpu_torch.obs.events import EventLog
from fmda_tpu_torch.obs.registry import MetricsRegistry, Snapshot
from fmda_tpu_torch.obs.slo import (
    SERIES_E2E,
    SERIES_LOSS,
    SERIES_TICKS,
    SLOEngine,
)
from fmda_tpu_torch.obs.tsdb import TimeSeriesStore

log = logging.getLogger("fmda_tpu_torch.obs")

#: router-side counters whose sum is the fleet's counted tick loss
#: (mirrors the chaos soak's accounting identity — fmda_tpu.chaos.soak)
ROUTER_LOSS_COUNTERS = (
    "results_missing",
    "migration_buffer_shed",
    "inflight_dropped_on_close",
)

#: gateway-side counters whose sum is an in-process fleet's tick loss
GATEWAY_LOSS_COUNTERS = (
    "shed_oldest",
    "stale_dropped",
    "flush_results_lost",
    # a close/reopen between dispatch and completion drops the dead
    # incarnation's result counted — submitted, state advanced, never
    # served: it belongs in the loss sum (the counted-loss lint rule's
    # vocabulary cross-check caught its absence)
    "stale_results_dropped",
    # per-tenant QoS (fmda_tpu.control): a class at its queue-share
    # quota sheds its own oldest tick to admit the newer one — a
    # counted loss distinct from the global shed_oldest overflow path
    # (each shed increments exactly one of the two, never both)
    "quota_shed",
)

#: quality-plane counters whose sum closes the label-join conservation
#: identity (fmda_tpu_torch.obs.quality: captured == joined + expired + shed
#: + pending) — a prediction leaves the capture ring exactly one way:
#: joined, aged out counted, or evicted counted
QUALITY_LOSS_COUNTERS = (
    "quality_captures_shed",
    "quality_join_expired",
)

#: heartbeat-stats fields folded per worker: stat key -> (series, kind)
WORKER_STAT_SERIES = {
    "ticks_served": ("worker_ticks_served_total", "counter"),
    "queue_depth": ("worker_queue_depth", "gauge"),
    "active_sessions": ("worker_sessions", "gauge"),
    "inbox_records_lost": ("worker_inbox_records_lost_total", "counter"),
    "shed_oldest": ("worker_shed_oldest_total", "counter"),
    # device telemetry (fmda_tpu_torch.obs.device) — the leak gauge feeds
    # the [slo] `memory_leak` objective (fmda_tpu_torch.obs.slo SERIES_LEAK
    # names it; keep them in sync).  The reference's two compile keys
    # have no counterpart: a port worker's beat does not carry them
    # (fmda_tpu_torch.fleet.worker)
    "live_bytes": ("worker_live_bytes", "gauge"),
    "memory_watermark_bytes": ("worker_memory_watermark_bytes", "gauge"),
    "memory_leak_suspected": ("worker_memory_leak_suspected", "gauge"),
    "device_mfu": ("worker_device_mfu", "gauge"),
}


class FleetAggregator:
    """Folds router/worker telemetry into a time-series store."""

    def __init__(
        self,
        store: TimeSeriesStore,
        *,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.store = store
        self.clock = clock
        self.scrape_errors = 0

    # -- folds (called on the aggregation cadence, never per tick) ----------

    def observe_runtime(
        self,
        metrics,
        *,
        now: Optional[float] = None,
        served_counter: str = "ticks_served",
        loss_counters=GATEWAY_LOSS_COUNTERS,
    ) -> None:
        """Fold one :class:`~fmda_tpu_torch.runtime.metrics.RuntimeMetrics`
        into the fleet series: the end-to-end ``total`` histogram
        snapshot (stored whole — window quantiles stay exact), the
        served-tick counter, and the summed loss counters."""
        now = self.clock() if now is None else now
        counters = dict(metrics.counters)  # GIL-atomic copy vs hot path
        self.store.record_histogram(
            SERIES_E2E, metrics.histograms["total"].snapshot(), t=now)
        self.store.record_counter(
            SERIES_TICKS, counters.get(served_counter, 0), t=now)
        self.store.record_counter(
            SERIES_LOSS,
            sum(counters.get(k, 0) for k in loss_counters), t=now)

    def observe_router(self, router, now: Optional[float] = None) -> None:
        """Fold a :class:`~fmda_tpu_torch.fleet.router.FleetRouter`: its own
        metrics (served = results matched at the router) plus the
        heartbeat-carried per-worker stats and the membership gauge."""
        now = self.clock() if now is None else now
        self.observe_runtime(
            router.metrics, now=now,
            served_counter="results_received",
            loss_counters=ROUTER_LOSS_COUNTERS)
        gauges = dict(router.metrics.gauges)
        self.store.record_gauge(
            "fleet_inflight_ticks", gauges.get("inflight_ticks", 0), t=now)
        self.store.record_gauge(
            "fleet_sessions", gauges.get("active_sessions", 0), t=now)
        self.store.record_gauge(
            "fleet_workers_live", len(router.membership), t=now)
        for wid, stats in router.worker_stats().items():
            for key, (series, kind) in WORKER_STAT_SERIES.items():
                value = stats.get(key)
                if value is None:
                    continue
                if kind == "counter":
                    self.store.record_counter(
                        series, float(value), t=now, process=wid)
                else:
                    self.store.record_gauge(
                        series, float(value), t=now, process=wid)
            # per-checkpoint serving attribution: the beat carries each
            # worker's {weights_version: ticks} breakdown so the quality
            # plane can show which version served what share of traffic
            for version, ticks in (stats.get("version_ticks")
                                   or {}).items():
                self.store.record_counter(
                    "worker_version_ticks_total", float(ticks),
                    t=now, process=wid, version=str(version))

    def observe_snapshot(
        self,
        process: str,
        snapshot: Snapshot,
        now: Optional[float] = None,
    ) -> None:
        """Fold one registry ``/snapshot`` document (a scraped worker's,
        or an in-process registry's) under ``process=`` labels.
        Histogram samples carry their raw bin counts
        (``counts`` in :meth:`LatencyHistogram.sample`), so windows stay
        mergeable across workers; samples without them (an old peer)
        degrade to their summary gauges."""
        now = self.clock() if now is None else now

        def labels_of(sample) -> Dict[str, str]:
            labels = {str(k): str(v)
                      for k, v in (sample.get("labels") or {}).items()}
            labels.setdefault("process", process)
            return labels

        for s in snapshot.get("counters", ()):
            self.store.record_counter(
                str(s["name"]), float(s["value"]), t=now, **labels_of(s))
        for s in snapshot.get("gauges", ()):
            self.store.record_gauge(
                str(s["name"]), float(s["value"]), t=now, **labels_of(s))
        for s in snapshot.get("histograms", ()):
            counts = s.get("counts")
            if counts:
                snap = {"counts": list(counts), "n": s["count"],
                        "total_s": s["sum_s"], "max_s": s["max_s"]}
                self.store.record_histogram(
                    str(s["name"]), snap, t=now, **labels_of(s))
            else:
                self.store.record_gauge(
                    f"{s['name']}_p99_seconds", float(s.get("p99_s", 0.0)),
                    t=now, **labels_of(s))

    def scrape(self, process: str, url: str,
               now: Optional[float] = None,
               timeout_s: float = 2.0) -> bool:
        """GET one worker's ``/snapshot`` and fold it; failures are
        counted (``scrape_errors``), never raised — a dead worker's
        endpoint is a degraded scrape, not a router crash."""
        base = (url if "://" in url else f"http://{url}").rstrip("/")
        try:
            with urllib.request.urlopen(
                    base + "/snapshot", timeout=timeout_s) as r:
                snapshot = json.loads(r.read())
        except Exception as e:  # noqa: BLE001 — any failure is the same
            # degraded-scrape outcome (URLError, timeout, bad JSON)
            self.scrape_errors += 1
            log.warning("fleet scrape of %s (%s) failed: %s",
                        process, base, e)
            return False
        self.observe_snapshot(process, snapshot, now=now)
        return True


class FleetTelemetry:
    """Store + aggregator + SLO engine + flight recorder, one handle.

    The router loop calls :meth:`maybe_collect` every pump; everything
    inside is cadence-gated (one clock read when not due).  Export goes
    through :meth:`families` (a registry collector), :meth:`query` (the
    ``/query`` endpoint), :meth:`alerts` (``/alerts``), and
    :meth:`health` (``/healthz`` — degraded while an alert fires, which
    is the ``status`` exit-code integration).
    """

    def __init__(
        self,
        config=None,
        *,
        clock: Callable[[], float] = time.monotonic,
        events: Optional[EventLog] = None,
        scrape_fn: Optional[Callable[[str, str], bool]] = None,
    ) -> None:
        from fmda_tpu_torch.config import SLOConfig

        self.cfg = config or SLOConfig()
        self.clock = clock
        self.events = events if events is not None else EventLog()
        self.store = TimeSeriesStore(
            interval_s=self.cfg.interval_s,
            capacity=max(2, int(self.cfg.retention_s / self.cfg.interval_s)),
            clock=clock)
        self.aggregator = FleetAggregator(self.store, clock=clock)
        self._scrape_fn = scrape_fn
        self.recorder = None
        if self.cfg.postmortem_dir:
            from fmda_tpu_torch.obs.device import device_report
            from fmda_tpu_torch.obs.pyprof import default_profiler
            from fmda_tpu_torch.obs.recorder import FlightRecorder
            from fmda_tpu_torch.obs.trace import default_tracer

            self.recorder = FlightRecorder(
                self.cfg.postmortem_dir,
                keep=self.cfg.postmortem_keep,
                min_interval_s=self.cfg.postmortem_min_interval_s,
                window_s=self.cfg.slow_window_s,
                clock=clock,
                store=self.store,
                events=self.events,
                tracer=default_tracer(),
                snapshot_fn=self._registry_snapshot,
                workers_fn=self._workers_doc,
                # an SLO breach freezes where the host was (folded
                # stacks) and what the device side looked like (kernel
                # ledger + memory watermarks) alongside traces/tsdb
                profile_fn=lambda: default_profiler().folded(),
                device_fn=device_report,
                # self.quality answers {"enabled": False} until an
                # evaluator is attached — the bundle always has the file
                quality_fn=self.quality,
            )
        self.slo = SLOEngine(
            self.cfg, self.store, events=self.events, clock=clock,
            on_fire=self._on_alert_fire)
        self._router = None
        self._registry: Optional[MetricsRegistry] = None
        #: attached ControlPlane (fmda_tpu_torch.control) — powers /control
        self._controller = None
        #: attached QualityEvaluator (fmda_tpu_torch.obs.quality) — powers
        #: /quality and the quality SLO series
        self._quality = None
        self._last_collect: Optional[float] = None
        self._last_scrape: Optional[float] = None
        #: the in-flight background scrape round (HTTP must never run
        #: on the caller's thread — see _scrape_workers)
        self._scrape_thread: Optional[threading.Thread] = None
        self.scrape_rounds_skipped = 0
        # injected chaos is a postmortem trigger too: a fault window
        # opening logs the fault and freezes the evidence the later gate
        # verdict will need (held until close(); the latest instance
        # built wins, the same discipline as Observability's event
        # wiring — fmda_tpu_torch.obs.observability)
        if self.recorder is not None:
            from fmda_tpu_torch.chaos.inject import default_chaos

            default_chaos().on_fault = self._on_chaos_fault

    # -- collection cadence -------------------------------------------------

    def maybe_collect(self, router, now: Optional[float] = None) -> bool:
        """Fold telemetry when a full interval elapsed; returns whether
        a collection ran.  One clock read on the not-due path."""
        now = self.clock() if now is None else now
        if (self._last_collect is not None
                and now - self._last_collect < self.cfg.interval_s):
            return False
        self.collect(router, now=now)
        return True

    def collect(self, router, now: Optional[float] = None) -> None:
        """One unconditional fold + SLO evaluation (+ worker scrapes on
        their own, slower cadence)."""
        now = self.clock() if now is None else now
        self._last_collect = now
        self._router = router
        self.aggregator.observe_router(router, now=now)
        if (self._last_scrape is None
                or now - self._last_scrape >= self.cfg.scrape_interval_s):
            self._last_scrape = now
            self._scrape_workers(router, now)
        if self._quality is not None:
            self._quality.maybe_join(now=now)
        self.slo.evaluate(now)

    def _scrape_workers(self, router, now: float) -> None:
        """Scrape every live worker whose heartbeat announces a metrics
        address (``--metrics-port`` workers; others fold heartbeat
        stats only).

        The default HTTP path runs on a **background daemon thread**:
        the caller is the router's pump loop, and N dead endpoints at a
        2 s connect timeout each would otherwise stall routing (and
        heartbeat processing — a false-reap risk) for seconds per
        round.  The store is lock-guarded, so cross-thread folds are
        safe; a round still in flight when the next is due is skipped,
        counted.  An *injected* ``scrape_fn`` runs inline — its
        blocking behavior is the injector's contract (tests rely on
        the synchronous fold)."""
        targets = [
            (wid, info.metrics)
            for wid, info in list(router.membership.workers.items())
            if getattr(info, "metrics", None)
        ]
        if not targets:
            return
        if self._scrape_fn is not None:
            for wid, url in targets:
                try:
                    self._scrape_fn(wid, url)
                except Exception:  # noqa: BLE001 — injected scrapers
                    # get the same never-crash contract as the default
                    self.aggregator.scrape_errors += 1
                    log.exception("injected scrape_fn failed for %s", wid)
            return
        if (self._scrape_thread is not None
                and self._scrape_thread.is_alive()):
            self.scrape_rounds_skipped += 1
            return

        def run() -> None:
            for wid, url in targets:
                self.aggregator.scrape(wid, url, now=now)

        self._scrape_thread = threading.Thread(
            target=run, name="fmda-fleet-scrape", daemon=True)
        self._scrape_thread.start()

    # -- in-process fold (single-process fleets, benches, tests) ------------

    def collect_gateway(self, gateway, now: Optional[float] = None) -> None:
        """Fold an in-process :class:`FleetGateway`'s metrics + evaluate
        — the single-process entry point (the ``obs_aggregate_overhead``
        bench and the deterministic telemetry soak drive this)."""
        now = self.clock() if now is None else now
        self._last_collect = now
        self.aggregator.observe_runtime(gateway.metrics, now=now)
        if self._quality is not None:
            self._quality.maybe_join(now=now)
        self.slo.evaluate(now)

    # -- alert / chaos hooks ------------------------------------------------

    def _on_alert_fire(self, objective: str, alert: dict) -> None:
        if self.recorder is not None:
            self.recorder.trigger(
                f"slo-{objective}",
                {"alert": alert, "firing": self.slo.firing()})

    def _on_chaos_fault(self, point: str, kind: str, step: int) -> None:
        self.events.emit(
            "chaos_fault", point=point, fault=kind, step=step)
        if self.recorder is not None:
            self.recorder.trigger(
                f"chaos-{kind}-{point}", {"step": step})

    def close(self) -> None:
        """Detach from the process-global chaos singleton (if this
        instance still owns the hook).  Without this a finished run's
        recorder keeps firing — and keeps the whole telemetry object
        alive — for every later chaos run in the process."""
        from fmda_tpu_torch.chaos.inject import default_chaos

        chaos = default_chaos()
        if chaos.on_fault == self._on_chaos_fault:
            chaos.on_fault = None

    # -- export -------------------------------------------------------------

    def fleet_gauges(self) -> List[dict]:
        """Point-in-time fleet gauges derived from the recent window:
        ``fleet_ticks_per_s`` (summed counter rate) and
        ``fleet_e2e_p99_ms`` (fast-window exact p99)."""
        now = self.clock()
        recent = self.cfg.interval_s * 3
        rates = self.store.rate_timeline(
            SERIES_TICKS, window_s=recent, now=now)
        hist = self.store.window_histogram(
            SERIES_E2E, window_s=self.cfg.fast_window_s, now=now)
        return [
            {"name": "fleet_ticks_per_s", "labels": {},
             "value": rates[-1][1] if rates else 0.0},
            {"name": "fleet_e2e_p99_ms", "labels": {},
             "value": hist.percentile(99) * 1e3},
            {"name": "fleet_tsdb_series", "labels": {},
             "value": len(self.store.series())},
            {"name": "fleet_scrape_errors_total", "labels": {},
             "value": self.aggregator.scrape_errors},
        ]

    def families(self) -> Snapshot:
        """Registry collector: fleet gauges + SLO burn gauges + quality
        families (when attached) + (when a router has been observed)
        its RuntimeMetrics families."""
        out: Snapshot = {"counters": [], "gauges": [], "histograms": []}
        out["gauges"].extend(self.fleet_gauges())
        slo_part = self.slo.families()
        out["gauges"].extend(slo_part.get("gauges", ()))
        if self._quality is not None:
            quality_part = self._quality.families()
            for kind in out:
                out[kind].extend(quality_part.get(kind, ()))
        router = self._router
        if router is not None:
            from fmda_tpu_torch.obs.observability import runtime_families

            part = runtime_families(router.metrics, prefix="router")
            for kind in out:
                out[kind].extend(part.get(kind, ()))
        return out

    #: derived series ``/query`` understands beyond the raw store names
    DERIVED_SERIES = ("fleet_ticks_per_s", "fleet_e2e_p99_ms")

    def query(self, series: str, window_s: Optional[float] = None) -> dict:
        """The ``/query?series=&window=`` range document."""
        now = self.clock()
        if series == "fleet_ticks_per_s":
            values = [[t, v] for t, v in self.store.rate_timeline(
                SERIES_TICKS, window_s=window_s, now=now)]
            return {"series": series, "window_s": window_s,
                    "kind": "derived",
                    "points": [{"labels": {}, "values": values}]}
        if series == "fleet_e2e_p99_ms":
            values = [
                [t, summ["p99_ms"]]
                for t, summ in self.store.histogram_timeline(
                    SERIES_E2E, window_s=window_s, now=now)]
            return {"series": series, "window_s": window_s,
                    "kind": "derived",
                    "points": [{"labels": {}, "values": values}]}
        return self.store.query(series, window_s=window_s, now=now)

    def alerts(self) -> dict:
        return self.slo.alerts()

    def health(self) -> dict:
        """``/healthz`` document: degraded while any SLO alert fires
        (``status --endpoint`` exit codes key on exactly this)."""
        ok, detail = self.slo.health_check()
        checks = {
            "slo_alerts": {"ok": bool(ok), "detail": str(detail)},
            # informational: a dead worker endpoint already degrades its
            # series (they go stale); it must not flip the fleet red
            "fleet_scrapes": {
                "ok": True,
                "detail": f"{self.aggregator.scrape_errors} scrape errors",
            },
        }
        return {"status": "ok" if ok else "degraded", "checks": checks}

    # -- server / bundle plumbing -------------------------------------------

    def _registry_snapshot(self) -> Snapshot:
        if self._registry is not None:
            return self._registry.snapshot()
        return self.families()

    def _workers_doc(self) -> dict:
        router = self._router
        if router is None:
            return {}
        return {
            "worker_stats": router.worker_stats(),
            "workers_live": router.membership.live(),
            "router_counters": dict(router.metrics.counters),
        }

    def attach_controller(self, controller) -> None:
        """Attach the :class:`~fmda_tpu_torch.control.plane.ControlPlane` so
        its loop state serves on ``/control`` next to the alerts it
        reacts to (and ``python -m fmda_tpu_torch status`` can read it)."""
        self._controller = controller

    def control(self) -> dict:
        """The ``/control`` document: the attached control plane's
        status, or an explicit disabled stub when none is attached."""
        if self._controller is None:
            return {"enabled": False}
        return self._controller.status()

    def attach_quality(self, evaluator) -> None:
        """Attach a :class:`~fmda_tpu_torch.obs.quality.QualityEvaluator`: it
        records into this telemetry's store (so the quality SLO
        objectives see its series), joins on the collection cadence,
        exports through :meth:`families`, and serves ``/quality``."""
        evaluator.store = self.store
        self._quality = evaluator

    def quality(self) -> dict:
        """The ``/quality`` document: the attached evaluator's summary,
        or an explicit disabled stub when none is attached."""
        if self._quality is None:
            return {"enabled": False}
        return self._quality.summary()

    def start_server(self, *, host: str = "127.0.0.1", port: int = 0):
        """A MetricsServer over this telemetry: ``/metrics``,
        ``/healthz`` (SLO-aware), ``/snapshot``, ``/events``, ``/trace``
        plus the range endpoints ``/query``, ``/alerts``, ``/quality``,
        ``/profile``, and ``/device``.  ``/control`` serves an attached
        control plane's document (``serve-fleet --role router|local``
        attach one unless ``--no-controller``); with none attached it
        answers 404."""
        from fmda_tpu_torch.obs.device import device_report
        from fmda_tpu_torch.obs.pyprof import default_profiler
        from fmda_tpu_torch.obs.server import MetricsServer
        from fmda_tpu_torch.obs.trace import default_tracer

        registry = MetricsRegistry()
        registry.register_collector("fleet_telemetry", self.families)
        self._registry = registry
        return MetricsServer(
            registry,
            host=host,
            port=port,
            health_fn=self.health,
            events=self.events,
            tracer=default_tracer(),
            query_fn=self.query,
            alerts_fn=self.alerts,
            control_fn=(self.control if self._controller is not None
                        else None),
            quality_fn=self.quality,
            profile_fn=lambda: default_profiler().folded(),
            device_fn=device_report,
        ).start()
