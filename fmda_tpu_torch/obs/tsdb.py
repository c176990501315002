"""Bounded in-memory time-series store: the fleet's short-term memory, as
``fmda_tpu.obs.tsdb`` defines it.

The obs plane so far is *point-in-time*: ``/snapshot`` answers "what are
the counters right now", and nothing in the system holds history,
computes rates, or can say "p99 over the last five minutes" — which is
exactly the currency an SLO engine (:mod:`fmda_tpu_torch.obs.slo`), an
adaptive controller, or an autoscaler trades in.  This module is the
smallest store that closes that gap:

- **fixed-interval rings** — every series is a bounded ring of
  ``(bin, value)`` samples on a fixed ``interval_s`` grid; the newest
  write in an interval wins, old bins fall off the end, and a
  long-running daemon's memory is capped by construction
  (``capacity`` bins × ``max_series`` series);
- **counters are differentiated at read time** — the store keeps raw
  cumulative totals and :meth:`TimeSeriesStore.points` returns rates,
  with negative deltas clamped to zero (a process restart resets its
  counters; the rate must read 0 across the reset, never negative);
- **histograms are stored whole** — each sample is a full
  :meth:`~fmda_tpu_torch.obs.registry.LatencyHistogram.snapshot` (bin counts
  + moments), so a window's distribution is the *difference* of two
  cumulative snapshots and quantiles are exact per window (to the
  shared bin resolution), and windows **merge across workers** through
  the existing :meth:`~fmda_tpu_torch.obs.registry.LatencyHistogram.merge`
  algebra;
- **pull-based** — nothing here runs on a tick hot path.  The
  :class:`~fmda_tpu_torch.obs.aggregate.FleetAggregator` folds worker
  heartbeat stats and scrape snapshots in on a cadence; queries run at
  scrape/alert-evaluation time.

torch-free, numpy-free: this runs in the router process (bus-only
host).  The documents are the reference's (``fmda_tpu.obs.tsdb``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from fmda_tpu_torch.obs.registry import LatencyHistogram, _label_key

_LabelKey = Tuple[Tuple[str, str], ...]

#: series kinds the store understands
KINDS = ("gauge", "counter", "histogram")


def _empty_snap() -> Dict[str, object]:
    return {"counts": [0] * LatencyHistogram.N_BINS, "n": 0,
            "total_s": 0.0, "max_s": 0.0}


def diff_snaps(newer: dict, older: Optional[dict]) -> dict:
    """The window delta between two cumulative histogram snapshots.

    A decrease in any bin (or in ``n``) means the source instrument was
    reset (process restart): the newer snapshot then IS the delta —
    everything it holds was observed since the restart, and nothing
    before it can be recovered.  Mirrors the counter-rate clamp."""
    if older is None:
        return {
            "counts": list(newer["counts"]),
            "n": newer["n"],
            "total_s": newer["total_s"],
            "max_s": newer["max_s"],
        }
    if newer["n"] < older["n"] or any(
            a < b for a, b in zip(newer["counts"], older["counts"])):
        return diff_snaps(newer, None)
    return {
        "counts": [a - b for a, b in zip(newer["counts"], older["counts"])],
        "n": newer["n"] - older["n"],
        "total_s": max(0.0, newer["total_s"] - older["total_s"]),
        # the window's true max is unrecoverable from cumulative
        # moments; the cumulative max is the safe upper bound
        "max_s": newer["max_s"],
    }


def snap_to_histogram(snap: dict) -> LatencyHistogram:
    """A standalone :class:`LatencyHistogram` carrying ``snap``'s
    distribution (for ``percentile``/``summary`` on window deltas)."""
    h = LatencyHistogram()
    h.merge(snap)
    return h


class _Series:
    __slots__ = ("name", "labels", "kind", "bins")

    def __init__(self, name: str, labels: Dict[str, str], kind: str,
                 capacity: int) -> None:
        self.name = name
        self.labels = dict(labels)
        self.kind = kind
        #: ring of [bin_index, value] — value is a float for gauges and
        #: counters (cumulative), a snapshot dict for histograms
        self.bins: deque = deque(maxlen=capacity)


class TimeSeriesStore:
    """Fixed-interval bounded rings, one per ``(name, labels)`` series."""

    def __init__(
        self,
        *,
        interval_s: float = 5.0,
        capacity: int = 720,
        max_series: int = 4096,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        self.max_series = int(max_series)
        self.clock = clock
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, _LabelKey], _Series] = {}
        #: series rejected at the max_series bound (counted, never silent)
        self.dropped_series = 0

    # -- write side (aggregation cadence, never a tick hot path) -----------

    def _record(self, name: str, value, kind: str, labels: Dict[str, str],
                t: Optional[float]) -> None:
        t = self.clock() if t is None else t
        b = int(t // self.interval_s)
        key = (name, _label_key(labels))
        with self._lock:
            series = self._series.get(key)
            if series is None:
                if len(self._series) >= self.max_series:
                    self.dropped_series += 1
                    return
                series = self._series[key] = _Series(
                    name, labels, kind, self.capacity)
            bins = series.bins
            if bins and bins[-1][0] >= b:
                # same interval (newest write wins) or an out-of-order
                # stamp (clock skew): fold into the newest bin — the
                # grid stays monotonic by construction
                bins[-1][1] = value
            else:
                bins.append([b, value])

    def record_gauge(self, name: str, value: float,
                     t: Optional[float] = None, **labels: str) -> None:
        self._record(name, float(value), "gauge", labels, t)

    def record_counter(self, name: str, total: float,
                       t: Optional[float] = None, **labels: str) -> None:
        """``total`` is the raw cumulative counter value; rates are
        derived at read time (reset-clamped)."""
        self._record(name, float(total), "counter", labels, t)

    def record_histogram(self, name: str, snapshot: dict,
                         t: Optional[float] = None, **labels: str) -> None:
        """``snapshot`` is a cumulative
        :meth:`LatencyHistogram.snapshot` dict, stored whole."""
        self._record(name, dict(snapshot), "histogram", labels, t)

    # -- introspection ------------------------------------------------------

    def series(self) -> List[Dict[str, object]]:
        with self._lock:
            return [
                {"name": s.name, "labels": dict(s.labels), "kind": s.kind,
                 "n_bins": len(s.bins)}
                for s in self._series.values()
            ]

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted({s.name for s in self._series.values()})

    def _variants(self, name: str) -> List[_Series]:
        """Every label variant of ``name`` (snapshot copies of the bins
        so readers never race the write cadence)."""
        with self._lock:
            out = []
            for s in self._series.values():
                if s.name == name:
                    clone = _Series(s.name, s.labels, s.kind, self.capacity)
                    clone.bins = deque(
                        [list(b) for b in s.bins], maxlen=self.capacity)
                    out.append(clone)
            return out

    def _window_start_bin(self, window_s: Optional[float],
                          now: Optional[float]) -> int:
        now = self.clock() if now is None else now
        if window_s is None:
            return -(1 << 62)
        return int((now - window_s) // self.interval_s)

    # -- read side ----------------------------------------------------------

    def points(
        self,
        name: str,
        *,
        window_s: Optional[float] = None,
        now: Optional[float] = None,
        labels: Optional[Dict[str, str]] = None,
    ) -> List[Tuple[float, float]]:
        """``(t, value)`` points of one series inside the window —
        gauges verbatim, counters differentiated into per-second rates
        with negative deltas clamped to 0 (counter reset ⇒ rate 0,
        never negative).  ``t`` is the bin's start stamp."""
        want = _label_key(labels or {})
        lo = self._window_start_bin(window_s, now)
        for s in self._variants(name):
            if _label_key(s.labels) != want:
                continue
            if s.kind == "counter":
                return self._rates(s, lo)
            return [(b * self.interval_s, v) for b, v in s.bins
                    if b >= lo and s.kind == "gauge"]
        return []

    def _rates(self, s: _Series, lo: int) -> List[Tuple[float, float]]:
        out: List[Tuple[float, float]] = []
        prev = None
        for b, v in s.bins:
            if prev is not None and b >= lo:
                pb, pv = prev
                dt = (b - pb) * self.interval_s
                out.append((b * self.interval_s, max(0.0, v - pv) / dt))
            prev = (b, v)
        return out

    def rate_timeline(
        self,
        name: str,
        *,
        window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> List[Tuple[float, float]]:
        """Per-interval rates of a counter series SUMMED across every
        label variant (the fleet-level rate of a per-worker counter),
        aligned on the shared bin grid."""
        acc: Dict[int, float] = {}
        lo = self._window_start_bin(window_s, now)
        for s in self._variants(name):
            if s.kind != "counter":
                continue
            prev = None
            for b, v in s.bins:
                if prev is not None and b >= lo:
                    pb, pv = prev
                    dt = (b - pb) * self.interval_s
                    acc[b] = acc.get(b, 0.0) + max(0.0, v - pv) / dt
                prev = (b, v)
        return [(b * self.interval_s, acc[b]) for b in sorted(acc)]

    def window_total(
        self,
        name: str,
        *,
        window_s: float,
        now: Optional[float] = None,
    ) -> float:
        """Total counter increase inside the window, summed across label
        variants — per-step positive deltas, so a mid-window reset
        contributes its post-restart growth and never a negative."""
        lo = self._window_start_bin(window_s, now)
        total = 0.0
        for s in self._variants(name):
            if s.kind != "counter":
                continue
            prev_v = None
            for b, v in s.bins:
                if prev_v is not None and b >= lo:
                    total += max(0.0, v - prev_v)
                prev_v = v
        return total

    def window_histogram(
        self,
        name: str,
        *,
        window_s: float,
        now: Optional[float] = None,
    ) -> LatencyHistogram:
        """The window's exact distribution, merged across every label
        variant of ``name``: per variant, the delta between the newest
        in-window snapshot and the last snapshot before the window
        (reset-clamped — see :func:`diff_snaps`), folded together with
        the shared merge algebra."""
        lo = self._window_start_bin(window_s, now)
        merged = LatencyHistogram()
        for s in self._variants(name):
            if s.kind != "histogram" or not s.bins:
                continue
            base = None
            newest = None
            for b, v in s.bins:
                if b < lo:
                    base = v
                else:
                    newest = v
            if newest is None:
                continue
            merged.merge(diff_snaps(newest, base))
        return merged

    def histogram_timeline(
        self,
        name: str,
        *,
        window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> List[Tuple[float, Dict[str, float]]]:
        """Per-interval distribution summaries of a histogram series,
        merged across label variants: consecutive-snapshot deltas per
        variant, summed on the shared bin grid, each bin summarised
        (count/mean/p50/p99/max ms) — the "did p99 breach and when"
        view the flight recorder dumps."""
        lo = self._window_start_bin(window_s, now)
        acc: Dict[int, dict] = {}
        for s in self._variants(name):
            if s.kind != "histogram":
                continue
            prev = None
            for b, v in s.bins:
                if prev is not None and b >= lo:
                    delta = diff_snaps(v, prev)
                    if delta["n"]:
                        cur = acc.get(b)
                        if cur is None:
                            acc[b] = delta
                        else:
                            h = snap_to_histogram(cur)
                            h.merge(delta)
                            acc[b] = h.snapshot()
                prev = v
        return [
            (b * self.interval_s, snap_to_histogram(acc[b]).summary())
            for b in sorted(acc)
        ]

    # -- export -------------------------------------------------------------

    def query(
        self,
        name: str,
        *,
        window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Dict[str, object]:
        """The ``/query?series=&window=`` document: every label variant
        of ``name`` with its in-window values — gauges verbatim,
        counters as rates, histograms as per-interval summaries."""
        variants = self._variants(name)
        if not variants:
            return {"series": name, "window_s": window_s, "kind": None,
                    "points": []}
        kind = variants[0].kind
        lo = self._window_start_bin(window_s, now)
        points = []
        for s in variants:
            if s.kind == "counter":
                values = [[t, v] for t, v in self._rates(s, lo)]
            elif s.kind == "gauge":
                values = [[b * self.interval_s, v] for b, v in s.bins
                          if b >= lo]
            else:
                values = []
                prev = None
                for b, v in s.bins:
                    if prev is not None and b >= lo:
                        delta = diff_snaps(v, prev)
                        if delta["n"]:
                            values.append([
                                b * self.interval_s,
                                snap_to_histogram(delta).summary()])
                    prev = v
            points.append({"labels": dict(s.labels), "values": values})
        return {"series": name, "window_s": window_s, "kind": kind,
                "points": points}

    def dump(
        self,
        *,
        window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Dict[str, object]:
        """Every series' in-window points as one JSON-safe document (the
        flight recorder's ``tsdb.json``)."""
        return {
            "interval_s": self.interval_s,
            "capacity": self.capacity,
            # lock-free: GIL-atomic int read; a scrape tolerates skew
            "dropped_series": self.dropped_series,
            "series": [
                self.query(name, window_s=window_s, now=now)
                for name in self.series_names()
            ],
        }
