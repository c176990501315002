"""fmda_tpu_torch.obs: the observability plane.  So far the metrics
registry (:mod:`fmda_tpu_torch.obs.registry`): counters, gauges and the
latency histogram the fleet runtime reports through."""

from fmda_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    LatencyHistogram,
    MetricsRegistry,
    default_registry,
)

__all__ = ["Counter", "Gauge", "LatencyHistogram", "MetricsRegistry",
           "default_registry"]
