"""fmda_tpu_torch.runtime: the fleet-serving runtime's state store, the
slot-pool session manager that multiplexes many carried streaming states
onto one device (:mod:`~fmda_tpu_torch.runtime.session_pool`)."""

from fmda_tpu_torch.runtime.session_pool import (
    PoolExhausted,
    SessionHandle,
    SessionPool,
    StaleSessionError,
)

__all__ = ["PoolExhausted", "SessionHandle", "SessionPool",
           "StaleSessionError"]
