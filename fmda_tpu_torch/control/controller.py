"""SLO-feedback batching controller: steer linger/bucket toward the p99,
as ``fmda_tpu.control.controller`` defines it.

The micro-batcher trades latency for device efficiency with two knobs —
``max_linger_s`` (how long the oldest tick may wait for company) and
the effective bucket cap (how large a flush may grow).  Static values
are wrong twice a day: at the open they burn the latency budget, at the
close they pad half-empty buckets.  This loop closes them against the
live ``fleet_e2e_p99_ms`` (the telemetry plane's fast-window exact p99)
vs the ``[slo]`` latency objective:

- p99 **above** the deadband → latency is burning: cut linger by one
  bounded step; at the linger floor, halve the bucket cap (smaller
  flushes leave the queue sooner).
- p99 **below** the deadband → latency budget to spend: restore the
  bucket cap first (throughput is cheaper than waiting), then grow
  linger one step.
- inside the deadband (``hysteresis`` × target, both sides) → hold.
  The deadband plus bounded steps is what keeps the loop from
  oscillating: a move changes p99 by roughly one step's worth, which
  lands inside the band instead of overshooting to the other wall.

Every move is an EventLog record (``control.batching``) and a decision
dict in the plane's ring — a controller that can't show its work is
untrustable at 3am.  Router-role code, no torch: decisions are float
compares on telemetry reads.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple


class BatchingController:
    """Hysteresis + bounded-step feedback from p99 to batching knobs."""

    def __init__(
        self,
        *,
        target_p99_ms: float,
        linger_ms: float,
        bucket_sizes: Tuple[int, ...] = (),
        hysteresis: float = 0.25,
        linger_step_ms: float = 0.25,
        min_linger_ms: float = 0.0,
        max_linger_ms: float = 8.0,
        events=None,
    ) -> None:
        if target_p99_ms <= 0:
            raise ValueError(f"target_p99_ms must be > 0: {target_p99_ms}")
        self.target_p99_ms = float(target_p99_ms)
        self.hysteresis = float(hysteresis)
        self.linger_step_ms = float(linger_step_ms)
        self.min_linger_ms = float(min_linger_ms)
        self.max_linger_ms = float(max_linger_ms)
        #: ascending configured bucket set; the cap only ever selects a
        #: member (the gateway's warm-up primed exactly these sizes)
        self.bucket_sizes = tuple(bucket_sizes)
        self.linger_ms = min(max(float(linger_ms), self.min_linger_ms),
                             self.max_linger_ms)
        #: None = uncapped (largest bucket); otherwise one of
        #: ``bucket_sizes``
        self.bucket_cap: Optional[int] = None
        self.mode = "hold"
        self.events = events

    # -- the decision -------------------------------------------------------

    def decide(self, p99_ms: Optional[float], now: float) -> Optional[dict]:
        """One evaluation: returns the decision record for a move, None
        for hold/idle.  ``p99_ms`` None means no served ticks in the
        window — an idle fleet must not creep its knobs around."""
        if p99_ms is None:
            self.mode = "idle"
            return None
        hi = self.target_p99_ms * (1.0 + self.hysteresis)
        lo = self.target_p99_ms * (1.0 - self.hysteresis)
        action = None
        if p99_ms > hi:
            self.mode = "shrink"
            action = self._shrink()
        elif p99_ms < lo:
            self.mode = "grow"
            action = self._grow()
        else:
            self.mode = "hold"
        if action is None:
            return None
        decision = {
            "t": now,
            "loop": "batching",
            "action": action,
            "p99_ms": round(p99_ms, 3),
            "target_p99_ms": self.target_p99_ms,
            "linger_ms": round(self.linger_ms, 4),
            "bucket_cap": self.bucket_cap,
        }
        if self.events is not None:
            self.events.emit("control.batching", **decision)
        return decision

    def _shrink(self) -> Optional[str]:
        """Over target: linger down one step, then bucket cap down."""
        if self.linger_ms > self.min_linger_ms:
            self.linger_ms = max(
                self.min_linger_ms, self.linger_ms - self.linger_step_ms)
            return "linger_down"
        smaller = self._cap_neighbor(-1)
        if smaller is not None:
            self.bucket_cap = smaller
            return "bucket_down"
        return None  # pinned at the floor: nothing left to give

    def _grow(self) -> Optional[str]:
        """Under target: bucket cap back up first, then linger up."""
        larger = self._cap_neighbor(+1)
        if larger is not None:
            self.bucket_cap = (
                None if larger == self.bucket_sizes[-1] else larger)
            return "bucket_up"
        if self.linger_ms < self.max_linger_ms:
            self.linger_ms = min(
                self.max_linger_ms, self.linger_ms + self.linger_step_ms)
            return "linger_up"
        return None  # pinned at the ceiling

    def _cap_neighbor(self, step: int) -> Optional[int]:
        """The next bucket size in ``step`` direction from the current
        cap; None at the end of the ladder (or with no ladder at all)."""
        if not self.bucket_sizes:
            return None
        cur = (self.bucket_cap if self.bucket_cap is not None
               else self.bucket_sizes[-1])
        try:
            idx = self.bucket_sizes.index(cur)
        except ValueError:
            return None
        idx += step
        if idx < 0 or idx >= len(self.bucket_sizes):
            return None
        return self.bucket_sizes[idx]

    # -- export -------------------------------------------------------------

    def status(self) -> dict:
        return {
            "mode": self.mode,
            "target_p99_ms": self.target_p99_ms,
            "linger_ms": round(self.linger_ms, 4),
            "bucket_cap": self.bucket_cap,
            "deadband_ms": [
                round(self.target_p99_ms * (1.0 - self.hysteresis), 3),
                round(self.target_p99_ms * (1.0 + self.hysteresis), 3),
            ],
        }
