"""Host wall clock per named pipeline stage, as
``fmda_tpu.utils.tracing`` defines it.

Only :class:`StageTimer` is ported so far; the reference's device-trace
helpers wrap the JAX profiler and have no counterpart yet.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator

log = logging.getLogger("fmda_tpu_torch")


class StageTimer:
    """Accumulates wall-clock per named stage; cheap enough for hot loops.

    Thread-safe: one lock around the accumulator writes and the summary
    read, so a reader's ``summary()`` never iterates a dict another
    thread is growing.  The stage body itself runs outside the lock —
    only the two dict updates are serialised.
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            with self._lock:
                self.totals[name] += elapsed
                self.counts[name] += 1

    def observe(self, name: str, seconds: float) -> None:
        """Record an already-measured duration (callers that time with
        their own clock, e.g. the gateway's multi-point flush path)."""
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "total_s": total,
                    "count": self.counts[name],
                    "mean_s": total / max(self.counts[name], 1),
                }
                for name, total in self.totals.items()
            }

    def log_summary(self, level: int = logging.INFO) -> None:
        for name, stats in sorted(self.summary().items()):
            log.log(
                level,
                "stage %-24s total=%.4fs count=%d mean=%.6fs",
                name,
                stats["total_s"],
                int(stats["count"]),
                stats["mean_s"],
            )
