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
"""

from fmda_tpu_torch.runtime.batcher import BatcherConfig, MicroBatcher, Tick
from fmda_tpu_torch.runtime.gateway import FleetGateway, FleetResult
from fmda_tpu_torch.runtime.loadgen import (
    FleetLoadConfig,
    PredictorLoadConfig,
    run_fleet_load,
    run_predictor_load,
)
from fmda_tpu_torch.runtime.metrics import LatencyHistogram, RuntimeMetrics
from fmda_tpu_torch.runtime.predictor_pool import (
    PredictorGateway,
    PredictorPool,
)
from fmda_tpu_torch.runtime.session_pool import (
    PoolExhausted,
    SessionHandle,
    SessionPool,
    StaleSessionError,
)

__all__ = [
    "BatcherConfig", "FleetGateway", "FleetLoadConfig", "FleetResult",
    "LatencyHistogram", "MicroBatcher", "PoolExhausted",
    "PredictorGateway", "PredictorLoadConfig", "PredictorPool",
    "RuntimeMetrics", "SessionHandle", "SessionPool", "StaleSessionError",
    "Tick", "run_fleet_load", "run_predictor_load",
]
