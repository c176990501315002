"""Heartbeat-based fleet membership over the control topic, as
``fmda_tpu.fleet.membership`` defines it.

Workers announce themselves (``hello``), prove liveness on a cadence
(``heartbeat``), and leave gracefully (``goodbye``); the router folds
those into a live set and declares a worker dead after
``heartbeat_timeout_s`` of silence.  Two disciplines keep this honest
across processes:

- **Receipt-time clocks.**  Liveness is judged on the *router's* clock
  at message receipt, never on the sender's timestamp — cross-process
  clock skew can therefore delay a death verdict but never mis-kill a
  healthy worker (and tests drive the whole protocol with a fake clock).
- **Stats ride the heartbeat.**  Every beat carries the worker's
  serving counters (active sessions, ticks served, kernel launches), so
  the router — and ``status`` — always has a fleet-wide view without a
  second RPC surface.

No torch: membership is router-role code (a bus-only host).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

log = logging.getLogger("fmda_tpu_torch.fleet")

#: control-message kinds a worker emits
HELLO = "hello"
HEARTBEAT = "heartbeat"
GOODBYE = "goodbye"


@dataclass
class WorkerInfo:
    """What the router knows about one worker."""

    worker_id: str
    #: router-clock stamp of the last message received from it
    last_seen: float
    #: router-clock stamp of the hello (join time)
    joined_at: float
    #: advertised session capacity (admission headroom planning)
    capacity: int = 0
    #: the newest stats dict its heartbeat carried
    stats: Dict[str, object] = field(default_factory=dict)
    #: the worker's announced metrics endpoint (``host:port`` of its
    #: /snapshot scrape surface), when it runs one — the fleet
    #: aggregator (fmda_tpu_torch.obs.aggregate) scrapes exactly these
    metrics: Optional[str] = None


class MembershipView:
    """The router's fold over control-topic worker messages."""

    def __init__(
        self,
        timeout_s: float,
        *,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.timeout_s = timeout_s
        self.clock = clock
        self.workers: Dict[str, WorkerInfo] = {}
        #: last known info of departed workers (goodbye or timeout) —
        #: their final stats stay inspectable after the process exits
        self.departed: Dict[str, WorkerInfo] = {}
        #: workers gracefully draining out: still heartbeating (and
        #: still addressable — they serve their drain markers) but
        #: excluded from :meth:`live`, so ownership derivation stops
        #: assigning them sessions
        self.leaving: set = set()

    def observe(self, msg: dict, now: Optional[float] = None) -> Optional[str]:
        """Fold one control message; returns ``"join"``/``"leave"`` when
        the live set changed, else None.  Unknown kinds are ignored (the
        control topic also carries ownership announcements and migrated
        session state)."""
        kind = msg.get("kind")
        wid = msg.get("worker")
        if kind not in (HELLO, HEARTBEAT, GOODBYE) or not wid:
            return None
        now = self.clock() if now is None else now
        if kind == GOODBYE:
            info = self.workers.pop(wid, None)
            was_leaving = wid in self.leaving
            self.leaving.discard(wid)
            if info is None:
                return None
            info.last_seen = now
            if isinstance(msg.get("stats"), dict):
                info.stats = msg["stats"]
            self.departed[wid] = info
            log.info("worker %s left the fleet (goodbye)", wid)
            # a leaving worker was already out of live(); its goodbye
            # changes nothing the router must react to
            return None if was_leaving else "leave"
        info = self.workers.get(wid)
        joined = info is None
        rejoined = False
        if kind == HELLO:
            # an explicit (re)hello cancels a pending leave — and
            # cancelling re-enters live(), which the router must treat
            # exactly like a join (rebalance), or the worker is left in
            # the live set owning no hash range forever
            rejoined = wid in self.leaving
            self.leaving.discard(wid)
        if joined:
            info = self.workers[wid] = WorkerInfo(
                worker_id=wid, last_seen=now, joined_at=now)
            self.departed.pop(wid, None)
            log.info("worker %s joined the fleet (%s)", wid, kind)
        info.last_seen = now
        if "capacity" in msg:
            info.capacity = int(msg["capacity"])
        if isinstance(msg.get("stats"), dict):
            info.stats = msg["stats"]
        if kind == HELLO:
            # a (re)hello defines the incarnation's announce outright: a
            # replacement started WITHOUT a metrics endpoint must clear
            # the dead incarnation's URL, or the aggregator scrapes a
            # dead address forever
            info.metrics = (str(msg["metrics"])
                            if msg.get("metrics") else None)
        elif msg.get("metrics"):
            info.metrics = str(msg["metrics"])
        return "join" if joined or rejoined else None

    def reap(self, now: Optional[float] = None) -> List[str]:
        """Declare-and-remove every worker silent past the timeout;
        returns their ids (the router rebalances when non-empty)."""
        now = self.clock() if now is None else now
        dead = [
            wid for wid, info in self.workers.items()
            if now - info.last_seen > self.timeout_s
        ]
        for wid in dead:
            info = self.workers.pop(wid)
            self.leaving.discard(wid)
            self.departed[wid] = info
            log.warning(
                "worker %s declared dead (last heartbeat %.1fs ago)",
                wid, now - info.last_seen)
        return dead

    def mark_leaving(self, worker_id: str) -> bool:
        """Exclude a worker from live() while it drains out; returns
        whether anything changed."""
        if worker_id not in self.workers or worker_id in self.leaving:
            return False
        self.leaving.add(worker_id)
        return True

    def live(self) -> List[str]:
        return sorted(set(self.workers) - self.leaving)

    def __len__(self) -> int:
        return len(self.live())


class Heartbeater:
    """Worker-side liveness announcer (hello → heartbeats → goodbye)."""

    def __init__(
        self,
        bus,
        worker_id: str,
        *,
        control_topic: str,
        interval_s: float,
        capacity: int = 0,
        clock: Callable[[], float] = time.monotonic,
        announce: Optional[dict] = None,
    ) -> None:
        self.bus = bus
        self.worker_id = worker_id
        self.control_topic = control_topic
        self.interval_s = interval_s
        self.capacity = capacity
        self.clock = clock
        #: extra fields stamped into EVERY liveness message — the
        #: worker's data-plane address rides here, and it must ride the
        #: heartbeats too (a reaped worker re-joins via its next beat,
        #: and the router must be able to re-link it)
        self.announce = dict(announce or {})
        self._last_beat: Optional[float] = None

    def _publish(
        self, kind: str, stats: Optional[dict],
        extra: Optional[dict] = None,
    ) -> None:
        msg = {
            "kind": kind,
            "worker": self.worker_id,
            "capacity": self.capacity,
            # wire-dialect capability (docs/multihost.md "Wire format
            # v2"): in broker-mediated topologies the router cannot see
            # the consumer's age from its own broker link, so every
            # liveness message declares it — absent (pre-v2 senders)
            # means v1, and the router lowers that worker's payloads
            "wire": 2,
            **self.announce,
        }
        if stats is not None:
            msg["stats"] = stats
        if extra:
            msg.update(extra)
        self.bus.publish(self.control_topic, msg)

    def hello(
        self, stats: Optional[dict] = None,
        extra: Optional[dict] = None,
    ) -> None:
        """Announce membership.  ``extra`` fields ride the hello only —
        the worker's open-session report (id → seq + norm) goes here, so
        a router restarted mid-serve rebuilds its registry from the
        re-hello without a second RPC surface (router failover,
        docs/chaos.md)."""
        self._last_beat = self.clock()
        self._publish(HELLO, stats, extra)

    def beat(
        self, stats: Optional[dict] = None, *, force: bool = False
    ) -> bool:
        """Publish a heartbeat when one is due (or ``force``); returns
        whether one was sent.  Call from the worker loop every step —
        the cadence check is one clock read."""
        now = self.clock()
        if (not force and self._last_beat is not None
                and now - self._last_beat < self.interval_s):
            return False
        self._last_beat = now
        self._publish(HEARTBEAT, stats)
        return True

    def goodbye(self, stats: Optional[dict] = None) -> None:
        self._publish(GOODBYE, stats)
