"""Deterministic, seeded fault plans, as ``fmda_tpu.chaos.plan`` defines
them: from one seed, the reference's plan, JSON-equal.

A :class:`FaultPlan` is a *schedule*: a tuple of :class:`FaultEvent`\\ s
keyed on **virtual step** (the chaos driver's round counter, never wall
clock), each naming a target and a fault kind.  Determinism is the whole
point — the same seed produces the same plan, the same plan produces the
same injected-event sequence, so a chaos run that found a bug is a
reproduction recipe, not an anecdote.

Two target families share the schedule:

- **injection points** — named call sites compiled into the serving
  code: the fleet tier's ``wire.request``, ``router.pump``,
  ``worker.step``, ``link:<wid>`` and the data plane's ``engine.step``
  (the join engine), ``warehouse.append`` (the landing path) and
  ``feed:<topic>`` (one ingest feed) — plus the opt-in wrappers
  (``bus``, ``warehouse``; the wrappers wait for ROADMAP queue 1, item
  7c).  The process-default :class:`~fmda_tpu_torch.chaos.inject.ChaosRuntime`
  evaluates these;
- **orchestrated targets** — whole processes (``worker:<wid>``,
  ``router``) that a soak driver kills and revives for real (the
  reference's ``fmda_tpu.chaos.soak``; its port waits for item 7c).

Fault kinds: ``kill`` (target dead/unreachable for ``duration`` steps),
``partition`` (link-level connection errors — same effect as ``kill``,
kept distinct so reports read honestly), ``delay`` (every op during the
window sleeps ``delay_s``), ``hang`` (one long stall when the window
opens), ``corrupt`` (payloads replaced with a marker the receiver must
count, not crash on).

Stdlib only: chaos runs on router-role (bus-only) hosts.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

#: Fault kinds a plan may schedule.
FAULT_KINDS = ("kill", "partition", "delay", "hang", "corrupt")

#: Kinds that make an injected point raise (transport-shaped failure).
_RAISING = ("kill", "partition")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: ``kind`` against ``target`` for the virtual
    steps ``[step, step + duration)``."""

    step: int
    kind: str
    target: str
    duration: int = 1
    #: per-op sleep for ``delay``, one-shot stall for ``hang`` (seconds)
    delay_s: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        if self.step < 0 or self.duration < 1:
            raise ValueError(
                f"fault needs step >= 0 and duration >= 1, got "
                f"step={self.step} duration={self.duration}")

    def active_at(self, step: int) -> bool:
        return self.step <= step < self.step + self.duration

    def to_wire(self) -> dict:
        return {
            "step": self.step,
            "kind": self.kind,
            "target": self.target,
            "duration": self.duration,
            "delay_s": self.delay_s,
        }

    @classmethod
    def from_wire(cls, d: dict) -> "FaultEvent":
        return cls(
            step=int(d["step"]),
            kind=str(d["kind"]),
            target=str(d["target"]),
            duration=int(d.get("duration", 1)),
            delay_s=float(d.get("delay_s", 0.0)),
        )


@dataclass(frozen=True)
class FaultPlan:
    """An immutable schedule of faults over ``n_steps`` virtual steps."""

    n_steps: int
    events: Tuple[FaultEvent, ...] = ()
    #: the seed :meth:`generate` derived the schedule from (0 for
    #: hand-written plans) — carried so reports cite the reproduction key
    seed: int = 0

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "events",
            tuple(sorted(self.events, key=lambda e: (e.step, e.target))))

    def active(self, step: int) -> List[FaultEvent]:
        """Every fault active at ``step`` (schedule order)."""
        return [e for e in self.events if e.active_at(step)]

    def starting(self, step: int) -> List[FaultEvent]:
        """Faults whose window *opens* at ``step`` (the soak driver keys
        process kills on exactly these)."""
        return [e for e in self.events if e.step == step]

    def for_target(self, target: str) -> Tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.target == target)

    @property
    def targets(self) -> Tuple[str, ...]:
        return tuple(sorted({e.target for e in self.events}))

    # -- wire / file form ---------------------------------------------------

    def to_wire(self) -> dict:
        return {
            "n_steps": self.n_steps,
            "seed": self.seed,
            "events": [e.to_wire() for e in self.events],
        }

    @classmethod
    def from_wire(cls, d: dict) -> "FaultPlan":
        return cls(
            n_steps=int(d["n_steps"]),
            seed=int(d.get("seed", 0)),
            events=tuple(
                FaultEvent.from_wire(e) for e in d.get("events", ())),
        )

    def save(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.to_wire(), fh, indent=2)
            fh.write("\n")
        return path

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as fh:
            return cls.from_wire(json.load(fh))

    # -- seeded generation ---------------------------------------------------

    @classmethod
    def generate(
        cls,
        seed: int,
        n_steps: int,
        *,
        workers: Sequence[str] = (),
        worker_kills: int = 1,
        revive_after: int = 8,
        router_restarts: int = 1,
        link_partitions: int = 1,
        partition_steps: int = 2,
        bus_blips: int = 1,
        blip_steps: int = 2,
        delays: int = 2,
        delay_s: float = 0.02,
        corrupts: int = 0,
        warehouse_kills: int = 0,
        warehouse_outage_steps: Optional[int] = None,
        engine_kills: int = 0,
        engine_kill_steps: int = 2,
        feed_outages: int = 0,
        feed_topics: Sequence[str] = (),
        feed_outage_steps: int = 6,
        settle_steps: int = 5,
    ) -> "FaultPlan":
        """Derive a schedule from one seed — pure function of its
        arguments, so any observer re-derives the identical plan.

        Events land in ``[settle_steps, n_steps - settle_steps)`` (the
        fleet gets a clean warm-up and a post-chaos window — the
        "post-chaos ticks served" gate needs fault-free trailing steps),
        and **no two fault windows overlap** (one-step gap between any
        pair): a router takeover must never coincide with a dead control
        bus, and kill/revive cycles of distinct targets must not
        compound — generated plans stay reproducible fault by fault.
        Worker-kill victims are distinct; an event the schedule has no
        room left for is dropped (``summary()`` reports what was
        actually placed, never the requested counts).
        """
        rng = random.Random(seed)
        lo = settle_steps
        hi = max(lo + 1, n_steps - settle_steps)
        occupied: List[Tuple[int, int]] = []  # placed [start, end)

        def place(width: int) -> Optional[int]:
            """A start step whose ``[start, start+width)`` window keeps
            a one-step gap from every placed window: random draws first,
            then the first free slot, then give up (plan is full)."""
            span = max(lo + 1, hi - width)

            def free(s: int) -> bool:
                return all(s + width + 1 <= a or b + 1 <= s
                           for a, b in occupied)

            start = None
            for _ in range(64):
                candidate = rng.randrange(lo, span)
                if free(candidate):
                    start = candidate
                    break
            if start is None:
                start = next(
                    (s for s in range(lo, span) if free(s)), None)
            if start is not None:
                occupied.append((start, start + width))
            return start

        events: List[FaultEvent] = []

        def add(kind: str, target: str, width: int,
                delay: float = 0.0) -> None:
            start = place(width)
            if start is not None:
                events.append(FaultEvent(
                    start, kind, target, duration=width, delay_s=delay))

        victims = list(workers)
        for _ in range(worker_kills):
            if not victims:
                break
            wid = victims.pop(rng.randrange(len(victims)))
            add("kill", f"worker:{wid}", revive_after)
        for _ in range(router_restarts):
            add("kill", "router", 1)
        for _ in range(link_partitions):
            if not workers:
                break
            wid = workers[rng.randrange(len(workers))]
            add("partition", f"link:{wid}", partition_steps)
        for _ in range(bus_blips):
            add("kill", "bus", blip_steps)
        # feed outages carry the widest windows of the data-plane set —
        # place them before the narrower warehouse/engine events so the
        # schedule packs (a window the plan has no room for is dropped)
        feed_victims = list(feed_topics)
        for _ in range(feed_outages):
            if not feed_victims:
                break
            topic = feed_victims.pop(rng.randrange(len(feed_victims)))
            add("kill", f"feed:{topic}", feed_outage_steps)
        for _ in range(warehouse_kills):
            # the compiled-in landing point (stream/warehouse.py): every
            # insert in the window raises, the write-ahead journal spills
            add("kill", "warehouse.append",
                warehouse_outage_steps
                if warehouse_outage_steps is not None else blip_steps)
        for _ in range(engine_kills):
            # the join engine "process dies": steps raise for the whole
            # window, the driver restores from the checkpoint after it
            add("kill", "engine.step", engine_kill_steps)
        for _ in range(delays):
            # only points the soak driver's own process evaluates:
            # "worker.step" lives in the spawned worker processes, whose
            # chaos runtime stays disabled — scheduling it here would
            # silently under-inject (in-process harnesses that enable
            # chaos in the serving process target it directly)
            point = rng.choice(("router.pump", "wire.request"))
            add("delay", point, 1, delay=delay_s)
        for _ in range(corrupts):
            add("corrupt", "bus", 1)
        return cls(n_steps=n_steps, events=tuple(events), seed=seed)

    def summary(self) -> Dict[str, int]:
        """Event count per ``kind:target`` — the report-friendly shape."""
        out: Dict[str, int] = {}
        for e in self.events:
            key = f"{e.kind}:{e.target}"
            out[key] = out.get(key, 0) + 1
        return out


def plan_from_config(cfg, workers: Sequence[str], n_steps: int,
                     plan_path: Optional[str] = None) -> "FaultPlan":
    """A plan from the ``chaos`` config section: an explicit plan file
    wins; otherwise the section's rate knobs seed :meth:`generate`."""
    if plan_path:
        return FaultPlan.load(plan_path)
    return FaultPlan.generate(
        cfg.seed, n_steps,
        workers=workers,
        worker_kills=cfg.worker_kills,
        revive_after=cfg.revive_after,
        router_restarts=cfg.router_restarts,
        link_partitions=cfg.link_partitions,
        bus_blips=cfg.bus_blips,
        delays=cfg.delays,
        delay_s=cfg.delay_s,
        settle_steps=cfg.settle_steps,
    )
