"""fmda_tpu_torch.chaos against fmda_tpu.chaos, on the CPU.

A fault plan is a pure function of its seed: from the same seed and
counts the port generates the reference's plan, JSON-equal, and each
package loads the other's file.  One plan driven through both runtimes
with one probe schedule observes the same raise/sleep/pass sequence, the
same counters and the same metric families; a disabled runtime is inert;
bad events are refused with the reference's messages.
"""

import json

import pytest

from fmda_tpu.chaos import ChaosFault as JaxChaosFault
from fmda_tpu.chaos import ChaosRuntime as JaxChaosRuntime
from fmda_tpu.chaos import FaultEvent as JaxFaultEvent
from fmda_tpu.chaos import FaultPlan as JaxFaultPlan
from fmda_tpu.chaos import chaos_families as jax_chaos_families
from fmda_tpu.chaos import plan_from_config as jax_plan_from_config
from fmda_tpu.config import ChaosConfig as JaxChaosConfig

from fmda_tpu_torch.chaos import (
    ChaosFault,
    ChaosRuntime,
    FaultEvent,
    FaultPlan,
    chaos_families,
    default_chaos,
    plan_from_config,
)
from fmda_tpu_torch.config import ChaosConfig

SEEDS = [0, 3, 7, 11, 29]
GEN_KW = dict(workers=["w0", "w1", "w2"], worker_kills=2, revive_after=6,
              router_restarts=1, link_partitions=2, bus_blips=1, delays=3,
              corrupts=1)
POINTS = ("wire.request", "router.pump", "worker.step", "bus", "link:w0",
          "link:w1")


@pytest.mark.parametrize("seed", SEEDS)
def test_generated_plan_is_json_equal_to_the_reference(seed):
    port = FaultPlan.generate(seed, 60, **GEN_KW)
    ref = JaxFaultPlan.generate(seed, 60, **GEN_KW)
    assert json.dumps(port.to_wire(), sort_keys=True) == json.dumps(
        ref.to_wire(), sort_keys=True)
    assert port == FaultPlan.generate(seed, 60, **GEN_KW)


@pytest.mark.parametrize("seed", SEEDS)
def test_plan_from_config_matches_the_reference(seed):
    fields = dict(enabled=True, seed=seed, worker_kills=1, revive_after=5,
                  router_restarts=1, link_partitions=2, bus_blips=1,
                  delays=2, delay_s=0.01, settle_steps=4)
    port = plan_from_config(ChaosConfig(**fields), ["w0", "w1"], n_steps=48)
    ref = jax_plan_from_config(JaxChaosConfig(**fields), ["w0", "w1"],
                               n_steps=48)
    assert port.to_wire() == ref.to_wire()


def test_each_package_loads_the_others_plan_file(tmp_path):
    ref = JaxFaultPlan.generate(3, 40, workers=["w0"], corrupts=1,
                                warehouse_kills=1)
    ref.save(str(tmp_path / "ref.json"))
    assert FaultPlan.load(str(tmp_path / "ref.json")).to_wire() == \
        ref.to_wire()
    port = FaultPlan.generate(5, 40, workers=["w0", "w1"], corrupts=1)
    port.save(str(tmp_path / "port.json"))
    assert JaxFaultPlan.load(str(tmp_path / "port.json")).to_wire() == \
        port.to_wire()
    with open(tmp_path / "ref.json") as a, open(tmp_path / "port.json") as b:
        assert json.load(a) == ref.to_wire() and json.load(b) == \
            port.to_wire()


@pytest.mark.parametrize("event,match", [
    ((0, "meteor", "bus"), "unknown fault kind"),
    ((1, "kill", "bus", 0), "duration"),
])
def test_bad_events_refused_like_the_reference(event, match):
    with pytest.raises(ValueError, match=match):
        JaxFaultEvent(*event)
    with pytest.raises(ValueError, match=match):
        FaultEvent(*event)


def _observe(runtime_cls, fault_cls, plan):
    seq, sleeps = [], []
    rt = runtime_cls().configure(enabled=True, plan=plan,
                                 sleep_fn=sleeps.append)
    for step in range(plan.n_steps):
        rt.advance(step)
        for point in POINTS:
            try:
                rt.check(point)
                seq.append((step, point, "pass"))
            except fault_cls:
                seq.append((step, point, "raise"))
    return seq, sleeps, dict(rt.counters), rt


@pytest.mark.parametrize("seed", [11, 12])
def test_one_plan_observes_the_reference_sequence(seed):
    kw = dict(workers=["w0", "w1"], worker_kills=0, router_restarts=0,
              link_partitions=2, bus_blips=2, delays=3, corrupts=1)
    port_plan = FaultPlan.generate(seed, 30, **kw)
    ref_plan = JaxFaultPlan.generate(seed, 30, **kw)
    port = _observe(ChaosRuntime, ChaosFault, port_plan)
    ref = _observe(JaxChaosRuntime, JaxChaosFault, ref_plan)
    assert port[:3] == ref[:3]
    assert any(kind != "pass" for _, _, kind in port[0]) or port[1]
    assert chaos_families(port[3]) == jax_chaos_families(ref[3])


def test_default_runtime_is_inert_when_disabled():
    """Every injection point is guarded by ``if _CHAOS.enabled:``: the
    process default starts disabled, and disabling an armed runtime turns
    every guarded point back into a plain pass."""
    rt = default_chaos()
    assert rt is default_chaos() and not rt.enabled and rt.counters == {}
    armed = ChaosRuntime().configure(
        enabled=True,
        plan=FaultPlan(5, (FaultEvent(0, "kill", "bus", duration=5),)))
    armed.configure(enabled=False)
    armed.advance(0)
    for point in POINTS:
        if armed.enabled:
            armed.check(point)
    assert armed.counters == {}
    assert chaos_families(armed) == jax_chaos_families(
        JaxChaosRuntime().configure(enabled=False))
