"""ControlPlane: the closed-loop composition root beside the router, as
``fmda_tpu.control.plane`` defines it.

One object owns the control loops and their cadence: it reads the
telemetry plane (``FleetTelemetry``'s windowed p99 + SLO burn rates),
runs the :class:`~fmda_tpu_torch.control.controller.BatchingController` and
:class:`~fmda_tpu_torch.control.autoscale.Autoscaler` decisions, and applies
them — batching retunes broadcast to every worker through the router
(``{"kind": "retune"}`` inbox messages; an in-process gateway is tuned
directly), scaling through the actuator.  Every decision lands in a
bounded ring surfaced by ``/control`` and ``python -m fmda_tpu_torch
status``
plus the shared EventLog, so the loop's history reads back next to the
faults and alerts it reacted to.

The plane is deliberately *advisory-only on the hot path*: the serving
loop calls :meth:`maybe_tick` (one clock read when not due, exactly the
telemetry cadence discipline) and nothing here ever blocks a tick.
Router-role code, no torch: float compares, dict plumbing, inbox
messages.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional

from fmda_tpu_torch.control.autoscale import Autoscaler
from fmda_tpu_torch.control.controller import BatchingController
from fmda_tpu_torch.control.qos import QosPolicy

#: counter prefixes the per-tenant status section aggregates from
#: worker heartbeat stats / gateway metrics (dynamic per-class names —
#: the conservation vocabularies carry the aggregate counters instead)
TENANT_COUNTER_PREFIXES = ("admitted_class_", "shed_class_")


class ControlPlane:
    """Batching + autoscale loops on one cadence, one decision ring."""

    def __init__(
        self,
        cfg,
        *,
        telemetry=None,
        router=None,
        gateway=None,
        actuator=None,
        slo_cfg=None,
        initial_linger_ms: Optional[float] = None,
        bucket_sizes=(),
        signals_fn: Optional[Callable[[float], dict]] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.cfg = cfg
        self.telemetry = telemetry
        self.router = router
        self.gateway = gateway
        self.clock = clock
        self._signals_fn = signals_fn
        self._last_tick: Optional[float] = None
        self.decisions = deque(maxlen=max(1, cfg.decisions_keep))
        events = telemetry.events if telemetry is not None else None

        target = cfg.target_p99_ms
        if target is None and slo_cfg is not None:
            target = slo_cfg.latency_p99_ms
        if target is None and telemetry is not None:
            target = telemetry.cfg.latency_p99_ms
        #: resolved p99 objective (ms); falls back to the SLOConfig
        #: default when nothing is configured — the loop must not run
        #: targetless
        self.target_p99_ms = float(target) if target else 250.0

        self.qos = QosPolicy.from_config(cfg)
        self.batching: Optional[BatchingController] = None
        if cfg.batching:
            self.batching = BatchingController(
                target_p99_ms=self.target_p99_ms,
                linger_ms=(initial_linger_ms if initial_linger_ms
                           is not None else cfg.max_linger_ms / 2.0),
                bucket_sizes=tuple(bucket_sizes),
                hysteresis=cfg.hysteresis,
                linger_step_ms=cfg.linger_step_ms,
                min_linger_ms=cfg.min_linger_ms,
                max_linger_ms=cfg.max_linger_ms,
                events=events,
            )
        self.autoscaler: Optional[Autoscaler] = None
        if cfg.autoscale and actuator is not None:
            self.autoscaler = Autoscaler(
                actuator,
                min_workers=cfg.min_workers,
                max_workers=cfg.max_workers,
                target_p99_ms=self.target_p99_ms,
                scale_up_burn=cfg.scale_up_burn,
                up_sustain_s=cfg.up_sustain_s,
                scale_down_frac=cfg.scale_down_frac,
                down_sustain_s=cfg.down_sustain_s,
                cooldown_s=cfg.cooldown_s,
                events=events,
            )
        if self.qos is not None and gateway is not None:
            gateway.attach_qos(self.qos)

    # -- cadence ------------------------------------------------------------

    def maybe_tick(self, now: Optional[float] = None) -> bool:
        """Run the loops when a full interval elapsed; one clock read
        otherwise — safe to call every pump."""
        now = self.clock() if now is None else now
        if (self._last_tick is not None
                and now - self._last_tick < self.cfg.interval_s):
            return False
        self.tick(now)
        return True

    def tick(self, now: Optional[float] = None) -> list:
        """One unconditional control evaluation; returns the decisions
        made (possibly empty)."""
        now = self.clock() if now is None else now
        self._last_tick = now
        signals = self.signals(now)
        made = []
        if self.batching is not None:
            decision = self.batching.decide(signals.get("p99_ms"), now)
            if decision is not None:
                self._apply_retune()
                made.append(decision)
        if self.autoscaler is not None:
            decision = self.autoscaler.decide(signals, now)
            if decision is not None:
                made.append(decision)
        self.decisions.extend(made)
        return made

    # -- signals ------------------------------------------------------------

    def signals(self, now: Optional[float] = None) -> dict:
        """The loops' inputs: fast-window p99 (None while idle) and the
        latency objective's fast burn rate.  An injected ``signals_fn``
        replaces the telemetry read (deterministic tests)."""
        now = self.clock() if now is None else now
        if self._signals_fn is not None:
            return self._signals_fn(now)
        if self.telemetry is None:
            return {"p99_ms": None, "burn_fast": 0.0}
        from fmda_tpu_torch.obs.slo import SERIES_E2E

        hist = self.telemetry.store.window_histogram(
            SERIES_E2E, window_s=self.telemetry.cfg.fast_window_s, now=now)
        p99_ms = hist.percentile(99) * 1e3 if hist.n else None
        alert = self.telemetry.slo.alerts()["alerts"].get("latency_p99")
        burn = alert["burn_fast"] if alert else 0.0
        return {"p99_ms": p99_ms, "burn_fast": burn}

    # -- actuation ----------------------------------------------------------

    def _apply_retune(self) -> None:
        """Push the batching controller's knobs at the fleet: a retune
        broadcast through the router (each worker swaps its batcher
        config — frozen configs make the swap atomic), and/or a direct
        swap on an in-process gateway."""
        ctrl = self.batching
        if ctrl is None:
            return
        if self.router is not None:
            self.router.broadcast_retune(
                max_linger_ms=ctrl.linger_ms, bucket_cap=ctrl.bucket_cap)
        if self.gateway is not None:
            self.gateway.retune(
                max_linger_ms=ctrl.linger_ms, bucket_cap=ctrl.bucket_cap)

    # -- export -------------------------------------------------------------

    def status(self) -> dict:
        """The ``/control`` document: loop modes, knobs, worker count,
        per-tenant admit/shed aggregates, and the last-N decisions."""
        doc: dict = {
            "enabled": True,
            "interval_s": self.cfg.interval_s,
            "target_p99_ms": self.target_p99_ms,
            "decisions": list(self.decisions),
        }
        if self.batching is not None:
            doc["batching"] = self.batching.status()
        if self.autoscaler is not None:
            doc["autoscale"] = self.autoscaler.status()
        if self.qos is not None:
            doc["qos"] = self.qos.snapshot()
            tenants = self._tenant_counters()
            if tenants:
                doc["tenants"] = tenants
        return doc

    def _tenant_counters(self) -> dict:
        """Per-class admit/shed totals, summed across the fleet: from
        worker heartbeat stats (multi-host) and/or the in-process
        gateway's counters."""
        total: dict = {}

        def fold(counters) -> None:
            for name, value in counters.items():
                if name.startswith(TENANT_COUNTER_PREFIXES):
                    total[name] = total.get(name, 0) + int(value)

        if self.router is not None:
            for stats in self.router.worker_stats().values():
                fold(stats.get("tenant_counters", {}))
        if self.gateway is not None:
            fold(self.gateway.metrics.counters)
        return total
