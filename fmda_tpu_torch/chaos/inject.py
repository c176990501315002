"""The process-default chaos runtime: injected faults at named points, as
``fmda_tpu.chaos.inject`` defines it.

Mirrors the tracer's discipline exactly (:mod:`fmda_tpu_torch.obs.trace`):
instrumented modules capture the singleton once at import
(``_CHAOS = default_chaos()``), every call site is guarded by a single
``if _CHAOS.enabled:`` branch, and :func:`configure_chaos` mutates the
singleton in place so those captures stay live.  **Disabled chaos costs
one attribute read and one branch per injection point — no allocation,
no call**.

An active fault at a point either raises :class:`ChaosFault` — a
``ConnectionError`` subclass, so every transport-failure path the
framework already hardens (link drop → re-link, goodbye-best-effort,
counted batch loss) handles it without knowing chaos exists — or sleeps
(``delay``/``hang``).  Every triggered effect is counted
(``chaos_injected_total{point, kind}`` via :func:`chaos_families`) and
optionally reported through ``on_fault`` (the process's
:class:`~fmda_tpu_torch.obs.observability.Observability` wires it to its
event log, the fleet telemetry,
:class:`~fmda_tpu_torch.obs.aggregate.FleetTelemetry`, to its event log
and flight recorder; the latest built wins): injected chaos is itself
counted degradation, never silence.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Tuple

from fmda_tpu_torch.chaos.plan import FaultEvent, FaultPlan

log = logging.getLogger("fmda_tpu_torch.chaos")


class ChaosFault(ConnectionError):
    """An injected transport-shaped failure (kill/partition)."""


class ChaosRuntime:
    """Evaluates a :class:`FaultPlan` against a virtual step counter."""

    def __init__(self) -> None:
        self.enabled = False
        self.plan: Optional[FaultPlan] = None
        #: (point, kind) -> times the effect actually fired
        self.counters: Dict[Tuple[str, str], int] = {}
        #: optional observer called as ``on_fault(point, kind, step)``
        #: the first step each fault window fires (obs event series)
        self.on_fault: Optional[Callable[[str, str, int], None]] = None
        self._step = 0
        self._by_target: Dict[str, Tuple[FaultEvent, ...]] = {}
        self._fired: set = set()
        self._sleep = time.sleep

    # -- configuration -------------------------------------------------------

    def configure(
        self,
        *,
        enabled: Optional[bool] = None,
        plan: Optional[FaultPlan] = None,
        sleep_fn: Optional[Callable[[float], None]] = None,
    ) -> "ChaosRuntime":
        if plan is not None:
            self.plan = plan
            by_target: Dict[str, List[FaultEvent]] = {}
            for e in plan.events:
                by_target.setdefault(e.target, []).append(e)
            self._by_target = {
                t: tuple(evs) for t, evs in by_target.items()}
            self._step = 0
            self._fired = set()
            self.counters = {}
        if sleep_fn is not None:
            self._sleep = sleep_fn
        if enabled is not None:
            self.enabled = bool(enabled)
        return self

    @property
    def step(self) -> int:
        return self._step

    def advance(self, step: Optional[int] = None) -> None:
        """Move the virtual clock (the chaos driver calls this once per
        round; injected points are evaluated against the current step)."""
        self._step = self._step + 1 if step is None else int(step)

    # -- injection surface ---------------------------------------------------

    def active(self, point: str) -> Optional[FaultEvent]:
        """The fault (if any) active at ``point`` right now."""
        events = self._by_target.get(point)
        if not events:
            return None
        step = self._step
        for e in events:
            if e.active_at(step):
                return e
        return None

    def check(self, point: str) -> None:
        """Apply the active fault at ``point``: raise for
        kill/partition, sleep for delay/hang, no-op otherwise.  Call
        ONLY under an ``if chaos.enabled:`` guard — the disabled hot
        path must never enter here."""
        e = self.active(point)
        if e is None:
            return
        first = (point, e.step) not in self._fired
        self._record(point, e)
        if e.kind in ("kill", "partition"):
            raise ChaosFault(
                f"chaos: {e.kind} injected at {point} "
                f"(step {self._step}, window {e.step}+{e.duration})")
        if e.kind == "delay":
            self._sleep(e.delay_s)
        elif e.kind == "hang" and first:
            # hang stalls once when the window opens, not per op
            self._sleep(e.delay_s)

    def corrupt_value(self, point: str, value: dict) -> dict:
        """Mangle ``value`` when a ``corrupt`` fault is active at
        ``point``: the payload becomes a marker dict receivers must
        *count* (unknown kind / unmatched result), never crash on."""
        e = self.active(point)
        if e is None or e.kind != "corrupt":
            return value
        self._record(point, e)
        return {"chaos_corrupted": True, "step": self._step}

    # -- accounting ----------------------------------------------------------

    def _record(self, point: str, e: FaultEvent) -> None:
        key = (point, e.kind)
        self.counters[key] = self.counters.get(key, 0) + 1
        window = (point, e.step)
        if window not in self._fired:
            self._fired.add(window)
            log.warning(
                "chaos: %s active at %s (step %d, %d step window)",
                e.kind, point, self._step, e.duration)
            if self.on_fault is not None:
                try:
                    self.on_fault(point, e.kind, self._step)
                except Exception:  # noqa: BLE001 — loss-free: an
                    # observer failure loses telemetry only; it must
                    # never turn an injected fault into a real crash
                    log.exception("chaos on_fault observer raised")

    def injected_total(self) -> int:
        return sum(self.counters.values())

    def summary(self) -> Dict[str, int]:
        return {
            f"{kind}:{point}": n
            for (point, kind), n in sorted(self.counters.items())
        }


#: The process-default runtime — **disabled** until the soak (or
#: ``serve-fleet --chaos-plan``) configures it.  Instrumented modules
#: capture this singleton at import; ``configure_chaos`` mutates it in
#: place so those captures stay live.
_DEFAULT = ChaosRuntime()


def default_chaos() -> ChaosRuntime:
    return _DEFAULT


def configure_chaos(
    *,
    enabled: Optional[bool] = None,
    plan: Optional[FaultPlan] = None,
    sleep_fn: Optional[Callable[[float], None]] = None,
) -> ChaosRuntime:
    """Configure the process-default chaos runtime (in place)."""
    return _DEFAULT.configure(enabled=enabled, plan=plan, sleep_fn=sleep_fn)


def chaos_families(chaos: Optional[ChaosRuntime] = None) -> dict:
    """Scrape-time collector: injected-fault counters + the active-fault
    gauge, in the registry's snapshot shape (fmda_tpu_torch.obs)."""
    c = chaos if chaos is not None else _DEFAULT
    counters = [
        {
            "name": "chaos_injected_total",
            "labels": {"point": point, "kind": kind},
            "value": n,
        }
        for (point, kind), n in sorted(c.counters.items())
    ]
    active = 0
    if c.enabled and c.plan is not None:
        active = len(c.plan.active(c.step))
    gauges = [
        {"name": "chaos_enabled", "labels": {}, "value": int(c.enabled)},
        {"name": "chaos_active_faults", "labels": {}, "value": active},
        {"name": "chaos_step", "labels": {}, "value": c.step},
    ]
    return {"counters": counters, "gauges": gauges}
