"""Deadline-aware micro-batcher: coalesce tick requests into bucketed
flushes, as ``fmda_tpu.runtime.batcher`` defines it.

The card wants one big batched step, the client wants its answer *now* —
the micro-batcher sits between them (the same trade every batching
inference server makes).  Requests accumulate until either

- **batch-full**: as many distinct sessions are pending as the largest
  bucket holds (waiting longer cannot grow the flush), or
- **deadline**: the oldest pending request has lingered ``max_linger_s``
  (waiting longer only buys latency).

Flush sizes are then padded *up* to a small fixed set of ``bucket_sizes``,
so the card sees a few fixed shapes (the kernels' launch configurations
and the staging buffers are per bucket) whatever the arrival pattern.

Per-session ordering: a session's ticks advance a recurrence, so two rows
from one session can never share a flush (the scatter would race).  The
batcher takes the *first* pending row per session per flush; the rest
keep their arrival order for the next one.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np

from fmda_tpu_torch.config import DEFAULT_BUCKET_SIZES, DEFAULT_MAX_LINGER_S
from fmda_tpu_torch.runtime.session_pool import SessionHandle


@dataclass(frozen=True)
class BatcherConfig:
    """Tuning knobs."""

    #: Ascending padded batch sizes; each flush runs at the smallest
    #: bucket that fits.  The default is config.DEFAULT_BUCKET_SIZES,
    #: the same constant RuntimeConfig uses (64 included so the default
    #: fleet size doesn't pad 2x).
    bucket_sizes: Tuple[int, ...] = DEFAULT_BUCKET_SIZES
    #: Max time the oldest request may wait before a flush is forced.
    max_linger_s: float = DEFAULT_MAX_LINGER_S

    def __post_init__(self) -> None:
        if not self.bucket_sizes:
            raise ValueError("bucket_sizes must be non-empty")
        if tuple(sorted(self.bucket_sizes)) != tuple(self.bucket_sizes):
            raise ValueError(
                f"bucket_sizes must be ascending: {self.bucket_sizes}")
        if self.max_linger_s < 0:
            raise ValueError("max_linger_s must be >= 0")


@dataclass
class Tick:
    """One queued tick request: a session's newest feature row."""

    handle: SessionHandle
    row: np.ndarray
    t_enqueue: float
    seq: int = 0
    #: sampled trace root (:class:`fmda_tpu_torch.obs.trace.TraceRef`)
    #: begun at submit; None when tracing is off or the tick unsampled
    trace: Optional[object] = None
    #: in-band trace context (``"trace_id:span_id"``) the request arrived
    #: with; carried onto the published result untouched, and the parent
    #: of the gateway's spans when tracing is on
    wire: Optional[str] = None


class MicroBatcher:
    """FIFO of pending ticks with deadline/batch-full flush decisions."""

    def __init__(
        self,
        config: Optional[BatcherConfig] = None,
        *,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.config = config or BatcherConfig()
        self.clock = clock
        self._pending: Deque[Tick] = deque()
        #: distinct sessions currently pending (slot, generation) -> count
        self._per_session: dict = {}
        #: Upper bound on distinct sessions that can possibly be pending
        #: (the gateway keeps this at the pool's active-session count).
        #: When every possible session is already pending, a flush cannot
        #: grow — waiting out the linger would buy pure latency, so
        #: ``ready`` fires early.  None = only the largest bucket counts
        #: as batch-full.
        self.full_target: Optional[int] = None
        #: Soft cap on the flush size a controller can lower at runtime
        #: (:meth:`FleetGateway.retune`): flushes stop growing past the
        #: largest *configured* bucket at or under the cap, so only the
        #: configured shapes are ever selected.  None = uncapped.
        self.bucket_cap: Optional[int] = None

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def distinct_sessions(self) -> int:
        return len(self._per_session)

    def add(self, tick: Tick) -> None:
        self._pending.append(tick)
        key = (tick.handle.slot, tick.handle.generation)
        self._per_session[key] = self._per_session.get(key, 0) + 1

    def shed_oldest(self) -> Optional[Tick]:
        """Drop (and return) the oldest pending tick — the gateway's
        load-shedding primitive.  Never silent: the caller counts it."""
        if not self._pending:
            return None
        tick = self._pending.popleft()
        self._dec(tick)
        return tick

    def shed_matching(self, pred: Callable[[Tick], bool]) -> Optional[Tick]:
        """Drop (and return) the *oldest* pending tick satisfying
        ``pred`` — the per-tenant QoS shed (an attached policy picks the
        victim class; this removes its oldest tick).  None when nothing
        matches; the caller counts every drop, never silent.  O(queue)
        scan, but only ever on the contended-shed path."""
        for i, tick in enumerate(self._pending):
            if pred(tick):
                del self._pending[i]
                self._dec(tick)
                return tick
        return None

    def effective_cap(self) -> int:
        """The flush-size ceiling: the largest configured bucket at or
        under ``bucket_cap`` (smallest bucket when the cap undercuts
        them all; the largest when uncapped)."""
        sizes = self.config.bucket_sizes
        if self.bucket_cap is None:
            return sizes[-1]
        for b in reversed(sizes):
            if b <= self.bucket_cap:
                return b
        return sizes[0]

    def _dec(self, tick: Tick) -> None:
        key = (tick.handle.slot, tick.handle.generation)
        n = self._per_session.get(key, 0) - 1
        if n <= 0:
            self._per_session.pop(key, None)
        else:
            self._per_session[key] = n

    def oldest_age(self, now: Optional[float] = None) -> float:
        if not self._pending:
            return 0.0
        return (now if now is not None else self.clock()) \
            - self._pending[0].t_enqueue

    def ready(self, now: Optional[float] = None) -> bool:
        """Flush now?  Batch-full (distinct sessions fill the largest
        bucket, or every session that COULD tick is already pending —
        ``full_target``) or deadline (oldest tick lingered past the
        budget)."""
        if not self._pending:
            return False
        target = self.effective_cap()
        if self.full_target is not None:
            target = min(target, max(self.full_target, 1))
        if self.distinct_sessions >= target:
            return True
        return self.oldest_age(now) >= self.config.max_linger_s

    def take_batch(self) -> List[Tick]:
        """Pop the next flush: first pending row per session, FIFO, up to
        the largest bucket.  Later rows of the same session stay queued
        (their recurrence needs this flush's result first)."""
        cap = self.effective_cap()
        # fast path for the common lockstep flush: when no session has a
        # second row queued and everything fits one flush, the whole
        # queue is the batch — no per-tick set hashing or re-queueing
        if (len(self._pending) <= cap
                and len(self._per_session) == len(self._pending)):
            taken = list(self._pending)
            self._pending.clear()
            self._per_session.clear()
            return taken
        taken: List[Tick] = []
        seen = set()
        leftover: List[Tick] = []
        while self._pending and len(taken) < cap:
            tick = self._pending.popleft()
            key = (tick.handle.slot, tick.handle.generation)
            if key in seen:
                leftover.append(tick)
                continue
            seen.add(key)
            self._dec(tick)
            taken.append(tick)
        # deferred same-session rows go back to the FRONT (still the
        # oldest work; per-session order is preserved exactly)
        self._pending.extendleft(reversed(leftover))
        return taken

    def bucket_for(self, n: int) -> int:
        """Smallest configured bucket holding ``n`` requests."""
        for b in self.config.bucket_sizes:
            if n <= b:
                return b
        raise ValueError(
            f"batch of {n} exceeds the largest bucket "
            f"{self.config.bucket_sizes[-1]} (take_batch caps at it)")
