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
  handle (collectors, health checks, endpoint lifecycle);
- the fleet telemetry of the multi-process fleet:
  :mod:`~fmda_tpu_torch.obs.tsdb` (the :class:`TimeSeriesStore`),
  :mod:`~fmda_tpu_torch.obs.slo` (the :class:`SLOEngine`'s burn-rate
  alerts), :mod:`~fmda_tpu_torch.obs.recorder` (the
  :class:`FlightRecorder`'s postmortem bundles) and
  :mod:`~fmda_tpu_torch.obs.aggregate` (:class:`FleetAggregator` and
  :class:`FleetTelemetry`, the router's fold over its workers).

Exports resolve lazily (PEP 562): the device plane pulls in torch, and
the router imports the torch-free submodules (registry, events, trace,
the fleet telemetry) on a host with no card.
"""

from fmda_tpu_torch._lazy import lazy_exports

#: public name -> defining submodule; resolved on first attribute access
_EXPORTS = {
    "DeviceMemoryMonitor": "fmda_tpu_torch.obs.device",
    "KernelLedger": "fmda_tpu_torch.obs.device",
    "configure_device_obs": "fmda_tpu_torch.obs.device",
    "default_ledger": "fmda_tpu_torch.obs.device",
    "default_memory_monitor": "fmda_tpu_torch.obs.device",
    "device_report": "fmda_tpu_torch.obs.device",
    "EventLog": "fmda_tpu_torch.obs.events",
    "Observability": "fmda_tpu_torch.obs.observability",
    "engine_families": "fmda_tpu_torch.obs.observability",
    "journal_families": "fmda_tpu_torch.obs.observability",
    "runtime_families": "fmda_tpu_torch.obs.observability",
    "stage_timer_families": "fmda_tpu_torch.obs.observability",
    "render_prometheus": "fmda_tpu_torch.obs.prometheus",
    "HostProfiler": "fmda_tpu_torch.obs.pyprof",
    "default_profiler": "fmda_tpu_torch.obs.pyprof",
    "Counter": "fmda_tpu_torch.obs.registry",
    "Gauge": "fmda_tpu_torch.obs.registry",
    "LatencyHistogram": "fmda_tpu_torch.obs.registry",
    "MetricsRegistry": "fmda_tpu_torch.obs.registry",
    "default_registry": "fmda_tpu_torch.obs.registry",
    "MetricsServer": "fmda_tpu_torch.obs.server",
    "Span": "fmda_tpu_torch.obs.trace",
    "TraceRef": "fmda_tpu_torch.obs.trace",
    "Tracer": "fmda_tpu_torch.obs.trace",
    "configure_tracing": "fmda_tpu_torch.obs.trace",
    "default_tracer": "fmda_tpu_torch.obs.trace",
    "tracer_families": "fmda_tpu_torch.obs.trace",
    "FleetAggregator": "fmda_tpu_torch.obs.aggregate",
    "FleetTelemetry": "fmda_tpu_torch.obs.aggregate",
    "FlightRecorder": "fmda_tpu_torch.obs.recorder",
    "SLOEngine": "fmda_tpu_torch.obs.slo",
    "TimeSeriesStore": "fmda_tpu_torch.obs.tsdb",
}

__all__ = sorted(_EXPORTS)


__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
