"""fmda_tpu_torch.chaos: deterministic fault injection for the serving
stack, as ``fmda_tpu.chaos`` defines it.

A seeded :class:`~fmda_tpu_torch.chaos.plan.FaultPlan` schedules
kill/partition/delay/hang/corrupt events on a virtual step clock; the
process-default :class:`~fmda_tpu_torch.chaos.inject.ChaosRuntime`
applies them at named injection points in the fleet transport, the
serving loops and the data plane (one guarded branch when disabled),
:mod:`~fmda_tpu_torch.chaos.wrap` wraps a bus or warehouse opt-in,
:mod:`~fmda_tpu_torch.chaos.soak` drives the whole local multi-host
topology under a plan and :mod:`~fmda_tpu_torch.chaos.pipeline` the data
plane (feeds, engine, journaled warehouse, Predictor), each hard-gating
the "counted degradation, never abort" contract end to end
(``serve-fleet --role local --chaos-plan``, ``chaos-pipeline``).

Everything but the soaks' workers and the pipeline soak's Predictor is
router-role code: nothing on this import path imports torch.  The
wrappers and the soaks resolve lazily.
"""

from fmda_tpu_torch._lazy import lazy_exports
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

#: the wrappers and the soak entry points load on first use
_LAZY = {
    "ChaosBus": "fmda_tpu_torch.chaos.wrap",
    "ChaosWarehouse": "fmda_tpu_torch.chaos.wrap",
    "run_chaos_soak": "fmda_tpu_torch.chaos.soak",
    "run_pipeline_soak": "fmda_tpu_torch.chaos.pipeline",
    "generate_pipeline_plan": "fmda_tpu_torch.chaos.pipeline",
}

__all__ = sorted([
    "FAULT_KINDS",
    "ChaosFault",
    "ChaosRuntime",
    "FaultEvent",
    "FaultPlan",
    "chaos_families",
    "configure_chaos",
    "default_chaos",
    "plan_from_config",
    *_LAZY,
])


__getattr__, __dir__ = lazy_exports(__name__, _LAZY)
