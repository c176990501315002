"""fmda_tpu_torch.chaos: deterministic fault injection for the serving
stack, as ``fmda_tpu.chaos`` defines it.

A seeded :class:`~fmda_tpu_torch.chaos.plan.FaultPlan` schedules
kill/partition/delay/hang/corrupt events on a virtual step clock; the
process-default :class:`~fmda_tpu_torch.chaos.inject.ChaosRuntime`
applies them at named injection points in the fleet transport and
serving loops (one guarded branch when disabled).  The reference's bus
and warehouse wrappers, its pipeline soak and its fleet soak wait for
ROADMAP queue 1, item 7c.

Router-role code: nothing here imports torch.
"""

from fmda_tpu_torch.chaos.inject import (
    ChaosFault,
    ChaosRuntime,
    chaos_families,
    configure_chaos,
    default_chaos,
)
from fmda_tpu_torch.chaos.plan import (
    FAULT_KINDS,
    FaultEvent,
    FaultPlan,
    plan_from_config,
)

__all__ = [
    "FAULT_KINDS",
    "ChaosFault",
    "ChaosRuntime",
    "FaultEvent",
    "FaultPlan",
    "chaos_families",
    "configure_chaos",
    "default_chaos",
    "plan_from_config",
]
