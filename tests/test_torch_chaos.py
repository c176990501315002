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


# ---------------------------------------------------------------------------
# the wrappers, the data-plane points and the fleet soak
# ---------------------------------------------------------------------------

#: a bus plan: a kill window and a corrupt window on "bus", a warehouse
#: kill window on "warehouse"
WRAP_EVENTS = (("kill", "bus", 1, 2), ("corrupt", "bus", 4, 2),
               ("kill", "warehouse", 2, 2))


def _wrap_plan(plan_cls, event_cls):
    return plan_cls(8, tuple(event_cls(s, k, t, duration=d)
                             for k, t, s, d in WRAP_EVENTS))


def _drive_wrappers(chaos_pkg, bus_cls, wh_cls, fc_cls, wc_cls, plan):
    """Every ChaosBus and ChaosWarehouse op a step, under one plan: what
    each returned or that it raised."""
    rt = chaos_pkg.ChaosRuntime().configure(enabled=True, plan=plan)
    bus = chaos_pkg.ChaosBus(bus_cls(("a", "b"), capacity=64), chaos=rt)
    wh = chaos_pkg.ChaosWarehouse(wh_cls(fc_cls(), wc_cls(path=":memory:")),
                                  chaos=rt)
    row = {"Timestamp": "2020-01-06 09:30:00"}
    seq = []
    for step in range(plan.n_steps):
        rt.advance(step)
        ops = [
            ("publish", lambda: bus.publish("a", {"i": step})),
            ("publish_many", lambda: bus.publish_many(
                "b", [{"i": step}, {"j": step}])),
            ("read", lambda: [r.value for r in bus.read("a", 0)]),
            ("end_offset", lambda: bus.end_offset("b")),
            ("base_offset", lambda: bus.base_offset("a")),
            ("topics", lambda: list(bus.topics())),
            ("consumer", lambda: [r.value for r in
                                  bus.consumer("b").poll()]),
            ("len", lambda: len(wh)),
            ("insert", lambda: wh.insert_rows(
                [dict(row, Timestamp=f"2020-01-06 {10 + step}:00:00")])),
            ("timestamps", lambda: wh.timestamps()),
        ]
        for name, op in ops:
            try:
                seq.append((step, name, op()))
            except chaos_pkg.ChaosFault:
                seq.append((step, name, "raise"))
    return seq, dict(rt.counters)


def test_chaos_wrappers_match_the_reference():
    import fmda_tpu.chaos as jax_chaos_pkg
    from fmda_tpu.config import FeatureConfig as JaxFeatureConfig
    from fmda_tpu.config import WarehouseConfig as JaxWarehouseConfig
    from fmda_tpu.stream import InProcessBus as JaxBus
    from fmda_tpu.stream import Warehouse as JaxWarehouse

    import fmda_tpu_torch.chaos as chaos_pkg
    from fmda_tpu_torch.config import FeatureConfig, WarehouseConfig
    from fmda_tpu_torch.stream import InProcessBus, Warehouse

    got = _drive_wrappers(chaos_pkg, InProcessBus, Warehouse, FeatureConfig,
                          WarehouseConfig, _wrap_plan(FaultPlan, FaultEvent))
    ref = _drive_wrappers(jax_chaos_pkg, JaxBus, JaxWarehouse,
                          JaxFeatureConfig, JaxWarehouseConfig,
                          _wrap_plan(JaxFaultPlan, JaxFaultEvent))
    assert got == ref
    outcomes = {(s, name): v for s, name, v in got[0]}
    assert outcomes[(1, "publish")] == "raise"
    assert outcomes[(1, "topics")] == ["a", "b"]  # introspection ungated
    assert outcomes[(2, "insert")] == "raise" and outcomes[(2, "len")] == \
        "raise"
    assert got[1]  # corrupt and kill both counted


@pytest.fixture
def armed_default_chaos():
    """Arm both packages' process-default runtimes (the compiled-in points
    read them) and disarm them after, whatever the test did."""
    import fmda_tpu.chaos as jax_chaos_pkg

    import fmda_tpu_torch.chaos as chaos_pkg

    def arm(port_plan, ref_plan):
        chaos_pkg.configure_chaos(enabled=True, plan=port_plan)
        jax_chaos_pkg.configure_chaos(enabled=True, plan=ref_plan)
        return chaos_pkg.default_chaos(), jax_chaos_pkg.default_chaos()

    try:
        yield arm
    finally:
        chaos_pkg.configure_chaos(enabled=False)
        jax_chaos_pkg.configure_chaos(enabled=False)


def test_data_plane_points_fire_like_the_reference(armed_default_chaos):
    """``feed:<topic>`` (a session day with the VIX feed down),
    ``warehouse.append`` and ``engine.step``: the same published feeds,
    the same raises, the same counters."""
    from test_torch_ingest import _day

    import fmda_tpu.ingest as jax_ingest
    from fmda_tpu.config import FeatureConfig as JaxFeatureConfig
    from fmda_tpu.config import SessionConfig as JaxSessionConfig
    from fmda_tpu.config import WarehouseConfig as JaxWarehouseConfig
    from fmda_tpu.stream import InProcessBus as JaxBus
    from fmda_tpu.stream import StreamEngine as JaxEngine
    from fmda_tpu.stream import Warehouse as JaxWarehouse

    import fmda_tpu_torch.ingest as ingest
    from fmda_tpu_torch.config import (
        DEFAULT_TOPICS,
        FeatureConfig,
        SessionConfig,
        WarehouseConfig,
    )
    from fmda_tpu_torch.stream import InProcessBus, StreamEngine, Warehouse

    events = (("feed:vix", 0, 1), ("warehouse.append", 1, 1),
              ("engine.step", 2, 1))
    port_rt, ref_rt = armed_default_chaos(
        FaultPlan(4, tuple(FaultEvent(s, "kill", t, duration=d)
                           for t, s, d in events)),
        JaxFaultPlan(4, tuple(JaxFaultEvent(s, "kill", t, duration=d)
                              for t, s, d in events)))
    pkgs = {
        "port": (ingest, FeatureConfig, SessionConfig, WarehouseConfig,
                 InProcessBus, Warehouse, StreamEngine),
        "ref": (jax_ingest, JaxFeatureConfig, JaxSessionConfig,
                JaxWarehouseConfig, JaxBus, JaxWarehouse, JaxEngine),
    }
    days = {}
    for name, pkg in pkgs.items():
        (port_rt if name == "port" else ref_rt).advance(0)
        ticks, published, wh, stats = _day(pkg)
        days[name] = (ticks, published, len(wh))
    assert days["port"] == days["ref"]
    assert days["port"][1]["vix"] == [] and days["port"][1]["deep"]
    faults = {"port": ChaosFault, "ref": JaxChaosFault}
    seen = {}
    for name, (_, fc, _, wc, bus_cls, wh_cls, eng_cls) in pkgs.items():
        rt = port_rt if name == "port" else ref_rt
        wh = wh_cls(fc(), wc(path=":memory:"))
        eng = eng_cls(bus_cls(DEFAULT_TOPICS), wh, fc())
        out = []
        for step in range(4):
            rt.advance(step)
            for call in (lambda: wh.insert_rows([]), eng.step):
                try:
                    out.append(call())
                except faults[name]:
                    out.append("raise")
        seen[name] = (out, sorted(rt.counters.items()))
    assert seen["port"] == seen["ref"]
    assert seen["port"][0] == [0, 0, "raise", 0, 0, "raise", 0, 0]


#: the small fleet soak's plan (2 workers, every fault kind the soak
#: orchestrates)
SOAK_PLAN_KW = dict(workers=["w0", "w1"], worker_kills=1, revive_after=8,
                    router_restarts=1, link_partitions=1, bus_blips=1,
                    delays=2, delay_s=0.02, settle_steps=8)


def test_fleet_chaos_soak_gates_hold_on_the_cpu(monkeypatch):
    """``run_chaos_soak`` with two spawned CPU workers (gru, H 8, window
    8, 8 sessions) under a 36-step plan: a worker killed and revived, a
    router takeover, a bus blip, a link partition, delays.  The plan is
    the reference's, JSON-equal; every gate holds, the clean sessions
    bit-identical to the unfaulted run."""
    from fmda_tpu_torch.chaos import run_chaos_soak

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    plan = FaultPlan.generate(0, 36, **SOAK_PLAN_KW)
    assert json.dumps(plan.to_wire(), sort_keys=True) == json.dumps(
        JaxFaultPlan.generate(0, 36, **SOAK_PLAN_KW).to_wire(),
        sort_keys=True)
    report = run_chaos_soak(plan, n_workers=2, n_sessions=8, device="cpu",
                            wait_timeout_s=120.0)
    assert report["gates_ok"], json.dumps(
        {k: report[k] for k in ("gates", "losses", "recovery", "takeovers")},
        default=str)
    assert report["unaccounted"] == 0
    assert report["identity"]["clean_sessions"] > 0
    assert report["takeovers"] and report["recompiles_after_warmup"] == 0
    assert set(report["gates"]) == {
        "exit_ok", "unaccounted_zero", "no_unexpected_results",
        "post_chaos_all_served", "failover_ok", "recovery_ok",
        "no_recompiles_after_warmup", "identity_ok"}
    assert not default_chaos().enabled  # the soak disarms what it armed


def test_fleet_soaks_need_a_card_by_default(monkeypatch):
    """Both spawned soaks run their workers on the card unless told
    otherwise: with no card visible a worker exits before it joins, and
    the soak raises naming ``device='cpu'`` (never a silent CPU run)."""
    from fmda_tpu_torch.chaos import run_chaos_soak
    from fmda_tpu_torch.control import run_elastic_soak

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_chaos_soak(FaultPlan(n_steps=4), n_workers=1, n_sessions=2,
                       wait_timeout_s=60.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_elastic_soak(n_sessions=2, wait_timeout_s=60.0)
    assert not default_chaos().enabled
