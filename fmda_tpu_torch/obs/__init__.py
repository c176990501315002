"""fmda_tpu_torch.obs: the observability plane, as ``fmda_tpu.obs``
defines it.

One metrics vocabulary and one export surface for the whole port:

- :mod:`~fmda_tpu_torch.obs.registry`: :class:`MetricsRegistry`
  (counters, gauges, :class:`LatencyHistogram`), scrape-time collectors,
  a process-default registry for module-level instrumentation;
- :mod:`~fmda_tpu_torch.obs.prometheus`: the text-exposition renderer;
- :mod:`~fmda_tpu_torch.obs.events`: a bounded JSONL event ring;
- :mod:`~fmda_tpu_torch.obs.server`: a stdlib HTTP thread serving
  ``/metrics``, ``/healthz``, ``/snapshot``, ``/events``, ``/trace``,
  ``/device``, ``/profile`` and ``/quality``;
- :mod:`~fmda_tpu_torch.obs.trace`: end-to-end tick tracing
  (:class:`Tracer`, in-band bus trace context, Perfetto export);
- :mod:`~fmda_tpu_torch.obs.device`: the device plane on the card: the
  :class:`KernelLedger` (launches, sampled CUDA-event device time, FLOPs
  and bytes per launch, MFU) and the :class:`DeviceMemoryMonitor` over
  the caching allocator;
- :mod:`~fmda_tpu_torch.obs.pyprof`: the continuous host sampling
  profiler (folded stacks at ``/profile``);
- :mod:`~fmda_tpu_torch.obs.quality`: the label-join evaluator
  (imported from its module, as in the reference);
- :mod:`~fmda_tpu_torch.obs.observability`: the :class:`Observability`
  handle (collectors, health checks, endpoint lifecycle).

The reference's fleet aggregation, time-series store, SLO engine and
flight recorder serve its multi-process fleet and wait with it (ROADMAP
queue 1, item 7).
"""

from fmda_tpu_torch.obs.device import (
    DeviceMemoryMonitor,
    KernelLedger,
    configure_device_obs,
    default_ledger,
    default_memory_monitor,
    device_report,
)
from fmda_tpu_torch.obs.events import EventLog
from fmda_tpu_torch.obs.observability import (
    Observability,
    engine_families,
    journal_families,
    runtime_families,
    stage_timer_families,
)
from fmda_tpu_torch.obs.prometheus import render_prometheus
from fmda_tpu_torch.obs.pyprof import HostProfiler, default_profiler
from fmda_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    LatencyHistogram,
    MetricsRegistry,
    default_registry,
)
from fmda_tpu_torch.obs.server import MetricsServer
from fmda_tpu_torch.obs.trace import (
    Span,
    TraceRef,
    Tracer,
    configure_tracing,
    default_tracer,
    tracer_families,
)

__all__ = [
    "Counter",
    "DeviceMemoryMonitor",
    "EventLog",
    "Gauge",
    "HostProfiler",
    "KernelLedger",
    "LatencyHistogram",
    "MetricsRegistry",
    "MetricsServer",
    "Observability",
    "Span",
    "TraceRef",
    "Tracer",
    "configure_device_obs",
    "configure_tracing",
    "default_ledger",
    "default_memory_monitor",
    "default_profiler",
    "default_registry",
    "default_tracer",
    "device_report",
    "engine_families",
    "journal_families",
    "render_prometheus",
    "runtime_families",
    "stage_timer_families",
    "tracer_families",
]
