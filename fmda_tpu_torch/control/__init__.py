"""fmda_tpu_torch.control — the adaptive control plane beside the router, as
``fmda_tpu.control`` defines it.

Three closed loops read the telemetry plane (``FleetTelemetry``'s
windowed exact p99s and SLO burn rates) and act on the serving fleet:

- :class:`~fmda_tpu_torch.control.controller.BatchingController` steers
  the gateway's linger/bucket knobs toward the ``[slo]`` p99 objective
  (hysteresis deadband + bounded steps; retunes broadcast through the
  router's inbox protocol);
- :class:`~fmda_tpu_torch.control.qos.QosPolicy` makes admission
  weighted: sessions carry a tenant class, and under overload the gateway
  sheds by WFQ fair share with per-class quotas (counted ``quota_shed``)
  instead of global oldest-drop;
- :class:`~fmda_tpu_torch.control.autoscale.Autoscaler` grows the fleet
  on sustained burn and shrinks it on idle through the zero-loss live
  migration (``FleetRouter.request_leave``).

:class:`~fmda_tpu_torch.control.plane.ControlPlane` composes them on one
cadence with a decision ring (``/control``, ``python -m fmda_tpu_torch
status``); :mod:`~fmda_tpu_torch.control.capacity` sweeps sessions ×
arrival rate into the capacity-model artifact, and
:mod:`~fmda_tpu_torch.control.elastic` gates a market-open spike through
the autoscaler under the chaos soak's never-abort contract.

Router-role code throughout: numpy + stdlib, no torch on this import path
(``tests/test_torch_isolation.py`` pins it); the soak entry points resolve
lazily.
"""

from fmda_tpu_torch._lazy import lazy_exports
from fmda_tpu_torch.control.autoscale import Autoscaler, LocalFleetActuator
from fmda_tpu_torch.control.controller import BatchingController
from fmda_tpu_torch.control.plane import ControlPlane
from fmda_tpu_torch.control.qos import QosPolicy

#: the soak and capacity-model entry points load on first use
_LAZY = {
    "run_elastic_soak": "fmda_tpu_torch.control.elastic",
    "run_capacity_model": "fmda_tpu_torch.control.capacity",
    "CAPACITY_SCHEMA": "fmda_tpu_torch.control.capacity",
}

__all__ = sorted([
    "Autoscaler",
    "BatchingController",
    "ControlPlane",
    "LocalFleetActuator",
    "QosPolicy",
    *_LAZY,
])


__getattr__, __dir__ = lazy_exports(__name__, _LAZY)
