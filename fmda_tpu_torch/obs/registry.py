"""The observability plane's latency histogram, as
``fmda_tpu.obs.registry`` defines it.

Only :class:`LatencyHistogram` is ported so far: the fleet runtime's
per-stage latencies (:mod:`fmda_tpu_torch.runtime.metrics`) are built on
it.  The metrics registry, its exporters and the rest of the plane are
still to come.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional

__all__ = ["LatencyHistogram"]


class LatencyHistogram:
    """Fixed log-spaced latency histogram (1 µs .. ~100 s).

    O(1) observe, percentile estimates from bin edges — accurate to one
    bin width (10 bins/decade), which is plenty for p50/p99 serving
    dashboards and costs no per-observation allocation.  Thread-safe:
    one lock around observe/read, plus :meth:`snapshot`/:meth:`merge`
    so per-thread instances can be aggregated without sharing the lock
    on the hot path.
    """

    #: 10 bins per decade over 8 decades starting at 1 µs.
    BINS_PER_DECADE = 10
    N_BINS = 8 * BINS_PER_DECADE
    _LO_EXP = -6  # 1e-6 s

    def __init__(
        self, name: str = "", labels: Optional[Dict[str, str]] = None
    ) -> None:
        self.name = name
        self.labels = dict(labels or {})
        self.counts = [0] * self.N_BINS
        self.n = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self._lock = threading.Lock()

    def _bin(self, seconds: float) -> int:
        if seconds <= 1e-6:
            return 0
        b = int((math.log10(seconds) - self._LO_EXP) * self.BINS_PER_DECADE)
        return min(max(b, 0), self.N_BINS - 1)

    @classmethod
    def bin_upper_edge(cls, b: int) -> float:
        """Upper edge (seconds) of bin ``b``."""
        return 10.0 ** (cls._LO_EXP + (b + 1) / cls.BINS_PER_DECADE)

    def observe(self, seconds: float) -> None:
        b = self._bin(seconds)
        with self._lock:
            self.counts[b] += 1
            self.n += 1
            self.total_s += seconds
            if seconds > self.max_s:
                self.max_s = seconds

    def percentile(self, p: float) -> float:
        """Upper edge of the bin holding the p-th percentile (seconds),
        clamped to the true observed max (the top bin's edge can
        otherwise overshoot it)."""
        with self._lock:
            return self._percentile_locked(p)

    def _percentile_locked(self, p: float) -> float:
        if self.n == 0:
            return 0.0
        target = p / 100.0 * self.n
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                edge = 10.0 ** (
                    self._LO_EXP + (i + 1) / self.BINS_PER_DECADE)
                return min(edge, self.max_s)
        return self.max_s

    def summary(self) -> Dict[str, float]:
        with self._lock:
            return {
                "count": self.n,
                "mean_ms": (
                    round(self.total_s / self.n * 1e3, 4) if self.n else 0.0
                ),
                "p50_ms": round(self._percentile_locked(50) * 1e3, 4),
                "p99_ms": round(self._percentile_locked(99) * 1e3, 4),
                "max_ms": round(self.max_s * 1e3, 4),
            }

    # -- cross-thread aggregation -------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """Consistent copy of the raw state (bin counts + moments) — the
        mergeable form.  Taken under the lock, so a snapshot mid-observe
        never tears (count present in ``counts`` but missing from ``n``)."""
        with self._lock:
            return {
                "counts": list(self.counts),
                "n": self.n,
                "total_s": self.total_s,
                "max_s": self.max_s,
            }

    def merge(self, other) -> "LatencyHistogram":
        """Fold another histogram (or a :meth:`snapshot` dict) into this
        one.  Exact — bin layouts are identical by construction — so N
        per-thread histograms merge into one distribution with no loss
        beyond the shared bin resolution."""
        snap = other.snapshot() if isinstance(other, LatencyHistogram) else other
        if len(snap["counts"]) != self.N_BINS:
            raise ValueError(
                f"cannot merge: {len(snap['counts'])} bins != {self.N_BINS}")
        with self._lock:
            self.counts = [
                a + b for a, b in zip(self.counts, snap["counts"])
            ]
            self.n += snap["n"]
            self.total_s += snap["total_s"]
            self.max_s = max(self.max_s, snap["max_s"])
        return self

    def sample(self) -> Dict[str, object]:
        with self._lock:
            return {
                "name": self.name,
                "labels": self.labels,
                "count": self.n,
                "sum_s": self.total_s,
                "max_s": self.max_s,
                "p50_s": self._percentile_locked(50),
                "p99_s": self._percentile_locked(99),
                # raw bin counts ride the sample so it stays mergeable:
                # the summary quantiles above cannot be merged after the
                # fact
                "counts": list(self.counts),
            }
