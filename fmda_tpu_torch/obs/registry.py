"""Process-wide metrics registry, as ``fmda_tpu.obs.registry`` defines
it: one vocabulary for the instruments of the port.

A :class:`MetricsRegistry` holds every instrument under one namespace:

- :class:`Counter`: monotonic totals (training epochs, continuous rounds,
  hot swaps by outcome);
- :class:`Gauge`: last-observed values;
- :class:`LatencyHistogram`: a fixed log-spaced latency distribution
  (the fleet runtime's per-stage latencies are built on it), thread-safe
  with ``snapshot()``/``merge()`` for cross-thread aggregation.

Instruments are cheap enough for hot loops (one lock acquisition per
update).  The exporters (the Prometheus text, the ``/snapshot``
endpoint, ``status``) are not ported yet; they read
:meth:`MetricsRegistry.snapshot`.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "LatencyHistogram", "MetricsRegistry",
           "default_registry"]

#: snapshot sample: {"name": str, "labels": {k: v}, ...value fields}
Sample = Dict[str, object]
#: snapshot: {"counters": [Sample], "gauges": [Sample], "histograms": [Sample]}
Snapshot = Dict[str, List[Sample]]

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter (float deltas allowed, e.g. seconds waited)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: Dict[str, str]) -> None:
        self.name = name
        self.labels = dict(labels)
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, delta: float = 1.0) -> None:
        with self._lock:
            self._value += delta

    @property
    def value(self) -> float:
        # a GIL-atomic float read: pollers tolerate skew
        return self._value

    def sample(self) -> Sample:
        with self._lock:  # a scrape must not tear against inc()
            return {"name": self.name, "labels": self.labels,
                    "value": self._value}


class Gauge:
    """Last-observed value."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: Dict[str, str]) -> None:
        self.name = name
        self.labels = dict(labels)
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        return self._value

    def sample(self) -> Sample:
        with self._lock:
            return {"name": self.name, "labels": self.labels,
                    "value": self._value}


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


class MetricsRegistry:
    """Get-or-create instrument store.

    ``counter``/``gauge``/``histogram`` return the same instrument for the
    same ``(name, labels)``: callers keep the handle and update it on the
    hot path.  The reference's switch-off (``enabled=False``), collectors,
    ``include`` and ``set_process`` serve its exporters and are not ported
    with them (ROADMAP queue 1 item 5)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, _LabelKey], Counter] = {}
        self._gauges: Dict[Tuple[str, _LabelKey], Gauge] = {}
        self._histograms: Dict[Tuple[str, _LabelKey], LatencyHistogram] = {}

    def _get(self, store: dict, cls, name: str, labels: Dict[str, str]):
        key = (name, _label_key(labels))
        with self._lock:
            inst = store.get(key)
            if inst is None:
                inst = store[key] = cls(name, labels)
        return inst

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get(self._counters, Counter, name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get(self._gauges, Gauge, name, labels)

    def histogram(self, name: str, **labels: str) -> LatencyHistogram:
        return self._get(self._histograms, LatencyHistogram, name, labels)

    def snapshot(self) -> Snapshot:
        """Every instrument's samples.  Each instrument is consistent
        under its own lock; skew across instruments is inherent to any
        scrape."""
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            histograms = list(self._histograms.values())
        return {"counters": [c.sample() for c in counters],
                "gauges": [g.sample() for g in gauges],
                "histograms": [h.sample() for h in histograms]}


#: The process-default registry: instrumentation with no other registry
#: handed to it (the trainer, the continuous loop) reports here.
_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT
