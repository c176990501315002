"""Online model quality, the label-join evaluator, as
``fmda_tpu.obs.quality`` defines it.

The serving tier publishes per-tick probabilities it never scores: the
ATR-scaled movement targets a prediction is *about* only become
computable once ``FeatureConfig.max_lead`` further rows land in the
warehouse (the last ``max_lead`` rows' targets are still provisional).
:class:`QualityEvaluator` closes the loop without touching the tick hot
path:

- **capture** (cheap, per published result): the prediction lands in a
  bounded ring keyed ``(ticker, timestamp, weights_version)``, so the
  hot-swap version stamps give per-checkpoint attribution for free.
  Overflow evicts the oldest entry, counted (``quality_captures_shed``).
- **join** (cadence-gated): pending timestamps resolve to warehouse row
  positions in one batched ``ids_for_timestamps`` query; a row's targets
  are final once ``position + max_lead <= len(warehouse)``, and final
  rows join via ``fetch_targets`` into the streaming metric vocabulary
  (:mod:`fmda_tpu_torch.eval.metrics`) **per weights_version and per
  label**.  A prediction that stays unjoinable for ``max_join_attempts``
  consecutive join rounds ages out as a counted ``quality_join_expired``
  loss (round-counted, not wall-clocked, so replays expire
  deterministically).

Conservation identity (visible in ``summary()``): ``captured == joined +
expired + shed + pending``.

A :class:`~fmda_tpu_torch.eval.drift.DriftMonitor` rides along: feature
rows and thresholded predictions are buffered at capture and PSI-scored at
join time against the training-time reference profile saved beside the
checkpoint.

Everything exports three ways: series into a store with
``record_counter``/``record_gauge`` when one is attached (the fleet
telemetry's time-series store: :meth:`~fmda_tpu_torch.obs.aggregate.
FleetTelemetry.attach_quality` attaches it; the ``[slo]`` quality
objectives read those series), registry families
for ``/metrics`` scrapes, and the ``/quality`` JSON document.  Host only:
a captured probability may be a card tensor, converted at join time.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from fmda_tpu_torch.config import TARGET_COLUMNS
from fmda_tpu_torch.eval.metrics import StreamingCounts, threshold_probs
from fmda_tpu_torch.runtime.metrics import RuntimeMetrics

log = logging.getLogger("fmda_tpu_torch.obs")

#: label a capture carries before any hot swap stamped a version
UNVERSIONED = 0


def _host(values, dtype=np.float32) -> np.ndarray:
    """A captured array on the host: a card tensor is copied here, at
    join time, never at capture."""
    if hasattr(values, "detach"):
        values = values.detach().float().cpu().numpy()
    return np.asarray(values, dtype)


class _Capture:
    __slots__ = ("ticker", "ts", "probs", "version", "misses")

    def __init__(self, ticker: str, ts: str, probs: np.ndarray,
                 version: int) -> None:
        self.ticker = ticker
        self.ts = ts
        self.probs = probs
        self.version = version
        self.misses = 0


class QualityEvaluator:
    """Bounded capture ring + cadence-gated label join + drift monitor.

    Thread-safe: captures arrive from the serving/pump thread, joins
    run on the telemetry cadence (possibly another thread), readers
    (``/quality``, ``families()``) from the server thread.
    """

    def __init__(
        self,
        config=None,
        *,
        warehouse=None,
        max_lead: Optional[int] = None,
        labels: Sequence[str] = TARGET_COLUMNS,
        metrics: Optional[RuntimeMetrics] = None,
        store=None,
        drift=None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        from fmda_tpu_torch.config import FeatureConfig, QualityConfig

        self.cfg = config or QualityConfig()
        self.labels = tuple(labels)
        self.metrics = metrics if metrics is not None else RuntimeMetrics()
        self.store = store
        self.drift = drift
        self.clock = clock
        self.warehouse = warehouse
        self.max_lead = (int(max_lead) if max_lead is not None
                         else FeatureConfig().max_lead)
        self._lock = threading.RLock()
        #: (ticker, ts, version) -> _Capture, oldest first
        self._ring: "OrderedDict[Tuple[str, str, int], _Capture]" = (
            OrderedDict())
        #: per-version streaming counts + the exact overall aggregate
        self._by_version: Dict[int, StreamingCounts] = {}
        self._overall = StreamingCounts(len(self.labels))
        self._captured = 0
        self._joined = 0
        self._expired = 0
        self._shed = 0
        self._join_errors = 0
        self._last_join: Optional[float] = None
        #: drift sampling buffers, flushed (and bounded) at join time
        self._feature_buf: List[np.ndarray] = []
        self._pred_buf: List[np.ndarray] = []

    # -- capture (per published result; O(1), no warehouse I/O) -------------

    def capture(
        self,
        ticker: str,
        timestamp: str,
        probabilities,
        *,
        weights_version: Optional[int] = None,
        features=None,
    ) -> None:
        """Record one published prediction for later label join.

        ``probabilities`` is stored AS GIVEN: it may be a card tensor,
        and forcing it to host here would put a copy on the tick path;
        conversion happens at join time."""
        version = (int(weights_version) if weights_version is not None
                   else UNVERSIONED)
        key = (str(ticker), str(timestamp), version)
        with self._lock:
            self._captured += 1
            self.metrics.count("quality_captured")
            if key in self._ring:
                # a duplicate key replaces the earlier capture, which
                # can now never join on its own — counted shed, or the
                # conservation identity would silently leak
                self._shed += 1
                self.metrics.count("quality_captures_shed")
            self._ring[key] = _Capture(key[0], key[1], probabilities,
                                       version)
            self._ring.move_to_end(key)
            while len(self._ring) > self.cfg.capture_capacity:
                self._ring.popitem(last=False)
                self._shed += 1
                self.metrics.count("quality_captures_shed")
            if self.drift is not None:
                # bounded sampling buffers of RAW references: the
                # monitor needs a sample, not every row — once full,
                # later rows this round are simply not sampled
                # (conversion + digitizing happen at join time, off
                # the tick path)
                if (features is not None
                        and len(self._feature_buf) < self.cfg.capture_capacity):
                    self._feature_buf.append(features)
                if len(self._pred_buf) < self.cfg.capture_capacity:
                    self._pred_buf.append(probabilities)

    # -- join (cadence-gated; one batched warehouse query per round) --------

    def maybe_join(self, now: Optional[float] = None) -> int:
        """Join when a full interval elapsed; one clock read otherwise.
        ``now`` may be a replay's virtual clock — cadence is whatever
        clock the caller advances."""
        now = self.clock() if now is None else now
        with self._lock:
            if (self._last_join is not None
                    and now - self._last_join < self.cfg.join_interval_s):
                return 0
        return self.join(now=now)

    def join(self, now: Optional[float] = None) -> int:
        """One unconditional join round; returns predictions joined."""
        now = self.clock() if now is None else now
        with self._lock:
            self._last_join = now
            joined = self._join_locked()
            self._flush_drift_locked()
            self._publish_locked(now)
            return joined

    def _join_locked(self) -> int:
        if self.warehouse is None or not self._ring:
            return 0
        entries = list(self._ring.values())
        ts_list = sorted({e.ts for e in entries})
        try:
            positions = dict(zip(
                ts_list, self.warehouse.ids_for_timestamps(ts_list)))
            n_rows = len(self.warehouse)
        except Exception:  # noqa: BLE001 — a flaky backend degrades the
            # join round, never the caller; counted + retried next round
            self._join_errors += 1
            self.metrics.count("quality_join_errors")
            log.warning("quality join round failed", exc_info=True)
            return 0
        ready: List[_Capture] = []
        ready_pos: List[int] = []
        for e in entries:
            pos = positions.get(e.ts)
            if pos is not None and pos + self.max_lead <= n_rows:
                ready.append(e)
                ready_pos.append(pos)
            else:
                e.misses += 1
                if e.misses >= self.cfg.max_join_attempts:
                    del self._ring[(e.ticker, e.ts, e.version)]
                    self._expired += 1
                    self.metrics.count("quality_join_expired")
        if not ready:
            return 0
        try:
            targets = self.warehouse.fetch_targets(ready_pos) > 0.5
        except Exception:  # noqa: BLE001 — same degraded-round contract
            # as above; entries stay pending (their misses were not
            # bumped, so nothing expires early from a backend blip)
            self._join_errors += 1
            self.metrics.count("quality_join_errors")
            log.warning("quality target fetch failed", exc_info=True)
            return 0
        for e, target in zip(ready, targets):
            del self._ring[(e.ticker, e.ts, e.version)]
            probs = _host(e.probs)
            pred = threshold_probs(probs, self.cfg.prob_threshold)[None, :]
            counts = self._by_version.get(e.version)
            if counts is None:
                counts = self._by_version[e.version] = StreamingCounts(
                    len(self.labels))
            counts.update(pred, target[None, :])
            self._overall.update(pred, target[None, :])
            self._joined += 1
            self.metrics.count("quality_joined")
        return len(ready)

    def _flush_drift_locked(self) -> None:
        if self.drift is None:
            return
        if self._feature_buf:
            self.drift.observe_features(np.stack([
                _host(f, np.float64).reshape(-1)
                for f in self._feature_buf]))
            self._feature_buf = []
        if self._pred_buf:
            self.drift.observe_predictions(np.stack([
                threshold_probs(_host(p), self.cfg.prob_threshold)
                for p in self._pred_buf]))
            self._pred_buf = []

    # -- export -------------------------------------------------------------

    def _publish_locked(self, now: float) -> None:
        """Record the SLO-facing series into the tsdb (when attached)."""
        store = self.store
        if store is None:
            return
        store.record_counter("quality_joined_total", self._joined, t=now)
        store.record_counter(
            "quality_exact_total", self._overall.exact, t=now)
        store.record_counter("quality_captured_total", self._captured, t=now)
        store.record_counter(
            "quality_captures_shed_total", self._shed, t=now)
        store.record_counter(
            "quality_join_expired_total", self._expired, t=now)
        store.record_gauge("quality_pending", len(self._ring), t=now)
        for version, counts in self._by_version.items():
            v = str(version)
            store.record_gauge(
                "quality_subset_accuracy", counts.subset_accuracy,
                t=now, version=v)
            store.record_gauge(
                "quality_hamming_loss", counts.hamming_loss,
                t=now, version=v)
            for name, score in zip(self.labels,
                                   counts.fbeta(self.cfg.fbeta)):
                store.record_gauge(
                    "quality_fbeta", float(score),
                    t=now, version=v, label=name)
        if self.drift is not None:
            scores = self.drift.scores()
            if scores is not None:
                store.record_gauge(
                    "quality_drift_score", scores["max_psi"], t=now)
                for j, score in enumerate(scores["feature_psi"]):
                    store.record_gauge(
                        "quality_drift_psi", float(score),
                        t=now, feature=str(j))

    def families(self) -> dict:
        """Registry collector (snapshot shape): the quality plane on
        ``/metrics`` next to the fleet/SLO families."""
        with self._lock:
            counters = [
                {"name": "quality_captured_total", "labels": {},
                 "value": self._captured},
                {"name": "quality_joined_total", "labels": {},
                 "value": self._joined},
                {"name": "quality_captures_shed_total", "labels": {},
                 "value": self._shed},
                {"name": "quality_join_expired_total", "labels": {},
                 "value": self._expired},
            ]
            gauges = [
                {"name": "quality_pending", "labels": {},
                 "value": len(self._ring)},
            ]
            for version, counts in sorted(self._by_version.items()):
                v = str(version)
                gauges.append(
                    {"name": "quality_subset_accuracy",
                     "labels": {"version": v},
                     "value": counts.subset_accuracy})
                gauges.append(
                    {"name": "quality_hamming_loss",
                     "labels": {"version": v},
                     "value": counts.hamming_loss})
                for name, score in zip(self.labels,
                                       counts.fbeta(self.cfg.fbeta)):
                    gauges.append(
                        {"name": "quality_fbeta",
                         "labels": {"version": v, "label": name},
                         "value": float(score)})
            if self.drift is not None:
                scores = self.drift.scores()
                if scores is not None:
                    gauges.append(
                        {"name": "quality_drift_score", "labels": {},
                         "value": scores["max_psi"]})
            return {"counters": counters, "gauges": gauges, "histograms": []}

    def conservation(self) -> Dict[str, int]:
        """The accounting identity the conservation checks hold:
        ``captured == joined + expired + shed + pending``."""
        with self._lock:
            return {
                "captured": self._captured,
                "joined": self._joined,
                "expired": self._expired,
                "shed": self._shed,
                "pending": len(self._ring),
            }

    def summary(self) -> dict:
        """The ``/quality`` JSON document."""
        with self._lock:
            versions = {
                str(v): counts.summary(self.cfg.fbeta)
                for v, counts in sorted(self._by_version.items())
            }
            doc = {
                "enabled": bool(self.cfg.enabled),
                "labels": list(self.labels),
                "threshold": self.cfg.prob_threshold,
                "beta": self.cfg.fbeta,
                "max_lead": self.max_lead,
                "conservation": {
                    "captured": self._captured,
                    "joined": self._joined,
                    "expired": self._expired,
                    "shed": self._shed,
                    "pending": len(self._ring),
                },
                "join_errors": self._join_errors,
                "overall": self._overall.summary(self.cfg.fbeta),
                "versions": versions,
                "drift": (self.drift.scores()
                          if self.drift is not None else None),
            }
            return doc
