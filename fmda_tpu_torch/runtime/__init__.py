"""fmda_tpu_torch.runtime: the dynamic micro-batching serving runtime.

A slot-pool session manager packs many carried streaming states into one
set of pooled tensors (:mod:`~fmda_tpu_torch.runtime.session_pool`), a
deadline-aware micro-batcher coalesces tick requests into a few padded
bucket sizes (:mod:`~fmda_tpu_torch.runtime.batcher`), and an
admission-controlled gateway with bounded queueing and counted load
shedding serves results back per session over the bus
(:mod:`~fmda_tpu_torch.runtime.gateway`).  The window-re-scan Predictor
rides the same batcher (:mod:`~fmda_tpu_torch.runtime.predictor_pool`).
``python -m fmda_tpu_torch serve-fleet --role solo`` runs either against a
synthetic load (:mod:`~fmda_tpu_torch.runtime.loadgen`).

Exports resolve lazily (PEP 562): the pool and the gateway pull in
torch, and the multi-host router (:mod:`fmda_tpu_torch.fleet`) imports
the torch-free submodules (``runtime.metrics``) on a host with no card.
"""

from fmda_tpu_torch._lazy import lazy_exports

#: public name -> defining submodule; resolved on first attribute access
_EXPORTS = {
    "BatcherConfig": "fmda_tpu_torch.runtime.batcher",
    "MicroBatcher": "fmda_tpu_torch.runtime.batcher",
    "Tick": "fmda_tpu_torch.runtime.batcher",
    "FleetGateway": "fmda_tpu_torch.runtime.gateway",
    "FleetResult": "fmda_tpu_torch.runtime.gateway",
    "FleetLoadConfig": "fmda_tpu_torch.runtime.loadgen",
    "PredictorLoadConfig": "fmda_tpu_torch.runtime.loadgen",
    "run_fleet_load": "fmda_tpu_torch.runtime.loadgen",
    "run_predictor_load": "fmda_tpu_torch.runtime.loadgen",
    "LatencyHistogram": "fmda_tpu_torch.runtime.metrics",
    "RuntimeMetrics": "fmda_tpu_torch.runtime.metrics",
    "PredictorGateway": "fmda_tpu_torch.runtime.predictor_pool",
    "PredictorPool": "fmda_tpu_torch.runtime.predictor_pool",
    "PoolExhausted": "fmda_tpu_torch.runtime.session_pool",
    "SessionHandle": "fmda_tpu_torch.runtime.session_pool",
    "SessionPool": "fmda_tpu_torch.runtime.session_pool",
    "StaleSessionError": "fmda_tpu_torch.runtime.session_pool",
}

__all__ = sorted(_EXPORTS)


__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
