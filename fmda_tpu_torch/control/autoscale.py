"""Elastic autoscaler: worker count follows sustained burn, loses nothing,
as ``fmda_tpu.control.autoscale`` defines it.

The scaling *decision* is ordinary control theory — scale up when the
latency objective's fast burn rate holds above threshold for a sustained
window, scale down when the fleet idles well under target for longer,
with a cooldown so the two never chatter.  What makes it safe is the
*actuation*: joins ride the fleet's ordinary hello→rebalance path (a new
worker is indistinguishable from a chaos revive), and retirement is
:meth:`FleetRouter.request_leave` — the drain → export → replay live
migration, so a scale-down moves every session bit-exactly and loses
zero ticks (the elastic soak's never-abort gates hold this).

The **actuator protocol** keeps the loop topology-agnostic — anything
with these three methods can be scaled:

- ``n_workers() -> int`` — live, non-leaving worker count;
- ``spawn_worker() -> Optional[str]`` — add one (None = can't);
- ``retire_worker() -> Optional[str]`` — begin one graceful leave.

:class:`LocalFleetActuator` drives the local launcher topology
(``fmda_tpu_torch.fleet.launcher``); the tests drive in-process workers with
a ~20-line actuator.  Router-role code: no torch.
"""

from __future__ import annotations

from typing import Optional


class LocalFleetActuator:
    """Actuator over a :class:`~fmda_tpu_torch.fleet.launcher.LocalFleet`:
    spawn = launch one more worker process into the topology, retire =
    ask the router for a graceful leave of the highest-numbered live
    worker (deterministic; the migration machinery makes any choice
    safe)."""

    def __init__(self, topo) -> None:
        self.topo = topo
        #: spawned but not yet in membership — counted toward
        #: ``n_workers`` so a slow join (process start + accelerator
        #: init) can't make the loop spawn the same capacity twice
        self._pending: list = []

    def n_workers(self) -> int:
        # live() already excludes leaving workers: a worker mid-retire
        # must not count, or the loop would retire a second one
        live = self.topo.router.membership.live()
        self._pending = [w for w in self._pending if w not in live]
        return len(live) + len(self._pending)

    def spawn_worker(self) -> Optional[str]:
        wid = self.topo.add_worker()
        if wid is not None:
            self._pending.append(wid)
        return wid

    def retire_worker(self) -> Optional[str]:
        live = self.topo.router.membership.live()
        if len(live) < 2:
            # never drain the last live worker — its sessions would
            # orphan with nowhere to migrate
            return None
        wid = live[-1]
        if not self.topo.router.request_leave(wid):
            return None
        return wid


class Autoscaler:
    """Sustained-signal worker-count loop with cooldown hysteresis."""

    def __init__(
        self,
        actuator,
        *,
        min_workers: int = 1,
        max_workers: int = 8,
        target_p99_ms: float = 250.0,
        scale_up_burn: float = 1.0,
        up_sustain_s: float = 3.0,
        scale_down_frac: float = 0.3,
        down_sustain_s: float = 10.0,
        cooldown_s: float = 5.0,
        events=None,
    ) -> None:
        if min_workers < 1 or max_workers < min_workers:
            raise ValueError(
                f"need 1 <= min_workers <= max_workers, got "
                f"{min_workers}/{max_workers}")
        self.actuator = actuator
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.target_p99_ms = float(target_p99_ms)
        self.scale_up_burn = float(scale_up_burn)
        self.up_sustain_s = float(up_sustain_s)
        self.scale_down_frac = float(scale_down_frac)
        self.down_sustain_s = float(down_sustain_s)
        self.cooldown_s = float(cooldown_s)
        self.events = events
        self.mode = "hold"
        #: first instant the pressure signal went (and stayed) high/low;
        #: None while the signal sits in between — sustain windows
        #: restart whenever the signal leaves its regime
        self._high_since: Optional[float] = None
        self._low_since: Optional[float] = None
        self._last_move: Optional[float] = None

    # -- the decision -------------------------------------------------------

    def decide(self, signals: dict, now: float) -> Optional[dict]:
        """One evaluation over the telemetry signals — ``burn_fast``
        (latency objective, fast window) and ``p99_ms`` (None = idle).
        Returns the decision record when a scaling move happened."""
        burn = float(signals.get("burn_fast", 0.0) or 0.0)
        p99_ms = signals.get("p99_ms")
        high = burn >= self.scale_up_burn
        low = (not high) and (
            p99_ms is None
            or p99_ms < self.scale_down_frac * self.target_p99_ms)
        self._high_since = (
            (self._high_since if self._high_since is not None else now)
            if high else None)
        self._low_since = (
            (self._low_since if self._low_since is not None else now)
            if low else None)
        self.mode = "high" if high else ("low" if low else "hold")

        if self._cooling(now):
            return None
        n = self.actuator.n_workers()
        if (high and n < self.max_workers
                and now - self._high_since >= self.up_sustain_s):
            wid = self.actuator.spawn_worker()
            if wid is None:
                return None
            return self._moved("scale_up", wid, now, burn, p99_ms)
        if (low and n > self.min_workers
                and now - self._low_since >= self.down_sustain_s):
            wid = self.actuator.retire_worker()
            if wid is None:
                return None
            return self._moved("scale_down", wid, now, burn, p99_ms)
        return None

    def _cooling(self, now: float) -> bool:
        return (self._last_move is not None
                and now - self._last_move < self.cooldown_s)

    def _moved(self, action: str, wid: str, now: float,
               burn: float, p99_ms) -> dict:
        self._last_move = now
        # both sustain windows restart: the fleet the signal measured
        # no longer exists
        self._high_since = None
        self._low_since = None
        decision = {
            "t": now,
            "loop": "autoscale",
            "action": action,
            "worker": wid,
            "n_workers": self.actuator.n_workers(),
            "burn_fast": round(burn, 4),
            "p99_ms": None if p99_ms is None else round(p99_ms, 3),
        }
        if self.events is not None:
            self.events.emit("control.autoscale", **decision)
        return decision

    # -- export -------------------------------------------------------------

    def status(self) -> dict:
        return {
            "mode": self.mode,
            "workers": self.actuator.n_workers(),
            "min_workers": self.min_workers,
            "max_workers": self.max_workers,
            "scale_up_burn": self.scale_up_burn,
            "cooldown_s": self.cooldown_s,
        }
