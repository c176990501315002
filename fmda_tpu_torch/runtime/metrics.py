"""Serving-runtime observability: per-stage latency histograms and
counters, as ``fmda_tpu.runtime.metrics`` defines them.

The runtime's contract is "overload degrades visibly": queue depth,
shed/reject counters, and enqueue→dispatch→device→publish latency
histograms are first-class state, not log lines.  Host-side stage wall
clock rides :class:`~fmda_tpu_torch.utils.tracing.StageTimer`.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Tuple

from fmda_tpu_torch.obs.registry import LatencyHistogram
from fmda_tpu_torch.utils.tracing import StageTimer

__all__ = ["LatencyHistogram", "RuntimeMetrics", "STAGES"]

#: The pipeline stages every tick moves through (gateway.submit →
#: batcher flush → device step → bus publish).  Keys of
#: :attr:`RuntimeMetrics.histograms`.
STAGES: Tuple[str, ...] = (
    "enqueue_to_dispatch",  # time spent queued/lingering before a flush
    "gather",               # batched warehouse window gather (the
                            # predictor gateway's id lookup + fetch;
                            # unused — and therefore unreported — by the
                            # carried-state fleet gateway)
    "route",                # multi-host router: submit -> tick batch
                            # on the owner's inbox (unused in-process)
    "dispatch",             # stale filter + staging assembly + the
                            # flush's launches on the card's stream
    "device",               # wait in _complete on the flush's copy of
                            # its probabilities to the host; under the
                            # overlap pipeline the card computes during
                            # the previous flush's publish, so this is
                            # the *unhidden* remainder
    "publish",              # per-flush batched bus publish
    "total",                # submit -> result published
)


class RuntimeMetrics:
    """All the runtime's instruments in one place.

    - :attr:`histograms` — per-stage :class:`LatencyHistogram` (STAGES);
    - :attr:`counters` — monotonic counts (ticks_served, flushes,
      shed_oldest, rejected_sessions, stale_dropped, ...);
    - :attr:`gauges` — last-observed values (queue_depth, active_sessions);
      ``queue_depth_peak`` is tracked as a counter-style high-water mark;
    - :attr:`timer` — host wall clock per runtime stage (StageTimer).
    """

    def __init__(self) -> None:
        self.histograms: Dict[str, LatencyHistogram] = {
            s: LatencyHistogram(s) for s in STAGES
        }
        self.counters: Dict[str, int] = defaultdict(int)
        self.gauges: Dict[str, float] = {}
        self.timer = StageTimer()

    def observe(self, stage: str, seconds: float) -> None:
        self.histograms[stage].observe(seconds)

    def count(self, name: str, delta: int = 1) -> None:
        self.counters[name] += delta

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value
        peak = f"{name}_peak"
        if value > self.gauges.get(peak, float("-inf")):
            self.gauges[peak] = value

    def summary(self) -> Dict[str, object]:
        return {
            "latency": {
                s: h.summary() for s, h in self.histograms.items() if h.n
            },
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "host_stages": self.timer.summary(),
        }

