"""fmda_tpu_torch.control against fmda_tpu.control, on the CPU.

- The loops: the same seeded signal and time sequences through both
  packages' ``BatchingController``, ``QosPolicy``, ``Autoscaler`` and
  ``ControlPlane`` give JSON-equal decision lists and ``status()``
  documents, and the reference's own expectations hold on the port.
- ``ControlConfig``: the same dicts load, the same bad ones are refused
  with the same messages, each package reads the other's file.
- The capacity model: the reference's schema, keys and cells, the A/B,
  and a real-pool sweep on the CPU that conserves every tick.
- The gateway under the same overload: the port's ``FleetGateway`` with
  the port's ``QosPolicy`` against the reference's gateway (JAX
  ``SessionPool`` on the CPU, weights carried across by
  ``interop.params_from_flax``): the same admits and sheds per class,
  probabilities within 1e-5.
- The fleet wiring: the retune broadcast reaches every worker's gateway,
  worker reports carry tenants and class counters, the in-process elastic
  loop scales up and down losslessly (the reference's decisions, bit for
  bit the never-scaled run), ``/control`` serves the plane's document.
- The CLI: ``--tenant-mix`` parsing and ``status``'s control section as
  the reference's, the serve-fleet argv that exited 2 before the control
  plane was ported now passing the refusal gate, the router and the local
  topology (spawned) with the controller attached.
"""

import dataclasses
import io
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from argparse import Namespace
from contextlib import redirect_stdout
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fmda_tpu.cli as jax_cli
import fmda_tpu.config as jax_config
import fmda_tpu.control as jax_control
import fmda_tpu.control.capacity as jax_capacity
from fmda_tpu.data.normalize import NormParams as JaxNormParams
from fmda_tpu.models import build_model as jax_build_model
from fmda_tpu.runtime import BatcherConfig as JaxBatcherConfig
from fmda_tpu.runtime import FleetGateway as JaxFleetGateway
from fmda_tpu.runtime import SessionPool as JaxSessionPool
from fmda_tpu.runtime.loadgen import FleetLoadConfig as JaxLoadConfig
from fmda_tpu.runtime.loadgen import run_fleet_load as jax_run_fleet_load
from fmda_tpu.runtime.metrics import RuntimeMetrics as JaxRuntimeMetrics

import fmda_tpu_torch.config as port_config
import fmda_tpu_torch.control as port_control
import fmda_tpu_torch.control.capacity as port_capacity
from fmda_tpu_torch.__main__ import main as port_main
from fmda_tpu_torch.data.normalize import NormParams
from fmda_tpu_torch.interop import params_from_flax
from fmda_tpu_torch.runtime import BatcherConfig, FleetGateway, SessionPool
from fmda_tpu_torch.runtime.loadgen import FleetLoadConfig, run_fleet_load
from fmda_tpu_torch.runtime.metrics import RuntimeMetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
FEATS, HIDDEN, WINDOW = 6, 5, 4


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


#: each package's control names, so one scenario runs on either
SIDES = {
    "jax": SimpleNamespace(
        control=jax_control, capacity=jax_capacity, config=jax_config,
        Metrics=JaxRuntimeMetrics, Batcher=JaxBatcherConfig),
    "port": SimpleNamespace(
        control=port_control, capacity=port_capacity, config=port_config,
        Metrics=RuntimeMetrics, Batcher=BatcherConfig),
}


def both(scenario):
    """``scenario(side)`` on the reference and on the port, JSON-equal;
    returns the port's result."""
    ref = scenario(SIDES["jax"])
    got = scenario(SIDES["port"])
    assert json.dumps(got, sort_keys=True, default=str) == json.dumps(
        ref, sort_keys=True, default=str)
    return got


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def test_control_config_defaults_and_cross_package_round_trip(tmp_path):
    cfg = port_config.FrameworkConfig()
    assert cfg.control == port_config.ControlConfig()
    assert dataclasses.asdict(cfg.control) == dataclasses.asdict(
        jax_config.FrameworkConfig().control)
    tuned = dict(target_p99_ms=42.0, hysteresis=0.1,
                 tenant_classes=("gold", "standard"),
                 tenant_weights=(3.0, 1.0), tenant_quota_frac=(1.0, 0.5),
                 max_workers=4, cooldown_s=2.5)
    ref = dataclasses.replace(
        jax_config.FrameworkConfig(),
        control=jax_config.ControlConfig(**tuned))
    path = jax_config.save_config(ref, str(tmp_path / "ref.json"))
    loaded = port_config.load_config(path)
    assert loaded.control == port_config.ControlConfig(**tuned)
    back = port_config.save_config(loaded, str(tmp_path / "port.json"))
    assert jax_config.load_config(back).control == ref.control


@pytest.mark.parametrize("fields", [
    dict(tenant_classes=("a", "b"), tenant_weights=(1.0,),
         tenant_quota_frac=(1.0, 1.0)),
    dict(tenant_classes=("a",), tenant_weights=(0.0,),
         tenant_quota_frac=(1.0,)),
    dict(min_workers=0),
    dict(min_workers=4, max_workers=2),
    dict(min_linger_ms=-1.0),
    dict(min_linger_ms=5.0, max_linger_ms=2.0),
])
def test_control_config_refuses_like_the_reference(fields):
    with pytest.raises(ValueError) as ref:
        jax_config.config_from_dict({"control": fields})
    with pytest.raises(ValueError) as got:
        port_config.config_from_dict({"control": fields})
    assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# BatchingController
# ---------------------------------------------------------------------------


def _controller(side, **kw):
    kw.setdefault("target_p99_ms", 10.0)
    kw.setdefault("linger_ms", 0.75)
    kw.setdefault("bucket_sizes", (8, 16))
    kw.setdefault("hysteresis", 0.25)
    kw.setdefault("linger_step_ms", 0.25)
    kw.setdefault("min_linger_ms", 0.0)
    kw.setdefault("max_linger_ms", 1.5)
    return side.control.BatchingController(**kw)


def _drive_controller(ctrl, signals):
    out = []
    for t, p99 in signals:
        out.append(ctrl.decide(p99, float(t)))
        out.append(ctrl.status())
    return out


#: (controller kwargs, (t, p99) sequence, what the reference expects)
BATCHING = {
    "shrink_ladder": ({}, [(t, 100.0) for t in range(6)]),
    "grow_ladder": ({}, [(t, 100.0) for t in range(4)]
                    + [(10 + t, 1.0) for t in range(6)]),
    "deadband_and_idle": ({}, [(0, 7.6), (0, 10.0), (0, 12.4), (1, None)]),
    "bounded_step": ({"linger_ms": 1.0}, [(0, 1000.0)]),
    "record_shape": ({}, [(3.25, 50.0)]),
    "seeded_walk": ({"bucket_sizes": (1, 4, 16, 64)}, [
        (t, float(p)) for t, p in enumerate(
            np.random.default_rng(3).lognormal(2.3, 0.8, 60))]),
}


@pytest.mark.parametrize("name", sorted(BATCHING))
def test_batching_controller_matches_the_reference(name):
    kw, signals = BATCHING[name]
    got = both(lambda side: _drive_controller(_controller(side, **kw),
                                              signals))
    actions = [d["action"] if d else None for d in got[::2]]
    if name == "shrink_ladder":
        assert actions == ["linger_down"] * 3 + ["bucket_down", None, None]
        assert got[-1]["bucket_cap"] == 8 and got[-1]["linger_ms"] == 0.0
    elif name == "grow_ladder":
        assert actions[4] == "bucket_up" and actions[5:] == ["linger_up"] * 5
        assert got[-1]["linger_ms"] == pytest.approx(1.25)
    elif name == "deadband_and_idle":
        assert actions == [None] * 4 and got[-1]["mode"] == "idle"
    elif name == "bounded_step":
        assert actions == ["linger_down"] and got[1]["linger_ms"] == 0.75
    elif name == "record_shape":
        assert got[0]["loop"] == "batching" and got[0]["t"] == 3.25
        assert got[1]["deadband_ms"] == [7.5, 12.5]


def test_batching_rejects_nonpositive_target_like_the_reference():
    msgs = []
    for side in SIDES.values():
        with pytest.raises(ValueError) as err:
            _controller(side, target_p99_ms=0.0)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# QosPolicy
# ---------------------------------------------------------------------------


def _policy(side):
    return side.control.QosPolicy(("gold", "standard", "bronze"),
                                  (3.0, 2.0, 1.0), (1.0, 0.75, 0.5))


def test_qos_classify_quota_and_snapshot_match_the_reference():
    def scenario(side):
        pol = _policy(side)
        solo = side.control.QosPolicy(("gold",), (3.0,), (1.0,))
        return {
            "classify": [pol.classify(t)
                         for t in ("gold", None, "unheard-of", "bronze")],
            "quota": [pol.quota(c, b) for c in pol.classes
                      for b in (1, 4, 100)],
            "solo": [solo.classes, solo.classify(None),
                     solo.quota("standard", 10)],
            "snapshot": [pol.snapshot(), solo.snapshot()],
        }

    got = both(scenario)
    assert got["classify"] == ["gold", "standard", "standard", "bronze"]
    assert tuple(got["solo"][0]) == ("gold", "standard")


def test_qos_victims_match_the_reference_and_never_starve():
    """The WFQ victim of 300 seeded queue states: the reference's pick
    each time, and never a class at or under its share while another sits
    over it."""
    rng = np.random.default_rng(7)
    states = [{c: int(n) for c, n in zip(("gold", "standard", "bronze"),
                                         rng.integers(0, 12, size=3))}
              for _ in range(300)] + [{"gold": 3, "bronze": 1}, {},
                                      {"gold": 0}]
    victims = both(lambda side: [_policy(side).pick_victim(q)
                                 for q in states])
    pol = _policy(SIDES["port"])
    for queued, victim in zip(states, victims):
        if victim is None:
            assert all(n <= 0 for n in queued.values())
            continue
        share = queued[victim] / pol.weight(victim)
        assert all(share >= n / pol.weight(c) - 1e-12
                   for c, n in queued.items() if n > 0)
    assert victims[-3:] == ["bronze", None, None]


@pytest.mark.parametrize("args", [
    (("a", "b"), (1.0,), (1.0, 1.0)),
    ((), (), ()),
    (("a", "a"), (1.0, 1.0), (1.0, 1.0)),
    (("a",), (0.0,), (1.0,)),
    (("a",), (1.0,), (0.0,)),
])
def test_qos_refuses_like_the_reference(args):
    msgs = []
    for side in SIDES.values():
        with pytest.raises(ValueError) as err:
            side.control.QosPolicy(*args)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_qos_from_config_matches_the_reference():
    def scenario(side):
        cc = side.config.ControlConfig
        assert side.control.QosPolicy.from_config(cc()) is None
        pol = side.control.QosPolicy.from_config(cc(
            tenant_classes=("gold",), tenant_weights=(2.0,),
            tenant_quota_frac=(1.0,), default_class="bronze"))
        return pol.snapshot()

    got = both(scenario)
    assert got["default_class"] == "bronze"


# ---------------------------------------------------------------------------
# Autoscaler
# ---------------------------------------------------------------------------


class FakeActuator:
    """The reference tests' ~20-line in-memory actuator."""

    def __init__(self, n=1, can_spawn=True):
        self.n = n
        self.can_spawn = can_spawn

    def n_workers(self):
        return self.n

    def spawn_worker(self):
        if not self.can_spawn:
            return None
        self.n += 1
        return f"w{self.n - 1}"

    def retire_worker(self):
        if self.n <= 1:
            return None
        self.n -= 1
        return f"w{self.n}"


HIGH = {"burn_fast": 2.0, "p99_ms": 400.0}
MID = {"burn_fast": 0.0, "p99_ms": 50.0}
LOW = {"burn_fast": 0.0, "p99_ms": 5.0}
IDLE = {"burn_fast": 0.0, "p99_ms": None}

#: (initial workers, (t, signals) sequence, spawn allowed from step k)
AUTOSCALE = {
    "sustained_burn": (1, [(0.0, HIGH), (2.9, HIGH), (3.0, HIGH)], 0),
    "cooldown": (1, [(0.0, HIGH), (3.0, HIGH), (3.5, HIGH), (7.9, HIGH),
                     (8.5, HIGH)], 0),
    "regime_exit": (1, [(0.0, HIGH), (2.0, MID), (2.5, HIGH), (5.0, HIGH),
                        (5.5, HIGH)], 0),
    "idle_down_to_min": (2, [(0.0, IDLE), (9.9, LOW), (10.0, IDLE),
                             (16.0, IDLE), (30.0, IDLE), (60.0, IDLE)], 0),
    "max_bound": (3, [(0.0, HIGH), (10.0, HIGH)], 0),
    "failed_spawn": (1, [(0.0, HIGH), (3.0, HIGH), (3.5, HIGH)], 2),
    "seeded_walk": (2, [(0.5 * i, [HIGH, MID, LOW, IDLE][k]) for i, k in
                        enumerate(np.random.default_rng(11).integers(
                            0, 4, 120))], 0),
}


def _drive_autoscaler(side, n0, signals, spawn_from):
    act = FakeActuator(n=n0, can_spawn=spawn_from == 0)
    sc = side.control.Autoscaler(
        act, min_workers=1, max_workers=3, target_p99_ms=100.0,
        scale_up_burn=1.0, up_sustain_s=3.0, scale_down_frac=0.3,
        down_sustain_s=10.0, cooldown_s=5.0)
    out = []
    for i, (t, sig) in enumerate(signals):
        if i == spawn_from:
            act.can_spawn = True
        out.append(sc.decide(sig, t))
        out.append(sc.status())
    return out


@pytest.mark.parametrize("name", sorted(AUTOSCALE))
def test_autoscaler_matches_the_reference(name):
    got = both(lambda side: _drive_autoscaler(side, *AUTOSCALE[name]))
    actions = [d["action"] if d else None for d in got[::2]]
    if name == "sustained_burn":
        assert actions == [None, None, "scale_up"]
        assert got[4]["worker"] == "w1"
    elif name == "cooldown":
        assert actions == [None, "scale_up", None, None, "scale_up"]
    elif name == "regime_exit":
        assert actions == [None, None, None, None, "scale_up"]
    elif name == "idle_down_to_min":
        assert actions == [None, None, "scale_down", None, None, None]
        assert got[-1]["workers"] == 1
    elif name == "max_bound":
        assert actions == [None, None]
    elif name == "failed_spawn":
        assert actions == [None, None, "scale_up"]


def test_autoscaler_refuses_bad_bounds_like_the_reference():
    for kw in (dict(min_workers=0), dict(min_workers=4, max_workers=2)):
        msgs = []
        for side in SIDES.values():
            with pytest.raises(ValueError) as err:
                side.control.Autoscaler(FakeActuator(), **kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# ControlPlane
# ---------------------------------------------------------------------------


class FakeRouter:
    def __init__(self, stats=None):
        self.retunes = []
        self._stats = stats or {}

    def broadcast_retune(self, **kw):
        self.retunes.append(kw)
        return 1

    def worker_stats(self):
        return self._stats


def _plane_cfg(side, **kw):
    kw.setdefault("interval_s", 1.0)
    kw.setdefault("target_p99_ms", 10.0)
    kw.setdefault("autoscale", False)
    return side.config.ControlConfig(**kw)


def test_plane_cadence_and_retune_broadcast_match_the_reference():
    def scenario(side):
        clock = FakeClock()
        router = FakeRouter()
        plane = side.control.ControlPlane(
            _plane_cfg(side), router=router, initial_linger_ms=1.0,
            bucket_sizes=(8, 16),
            signals_fn=lambda now: {"p99_ms": 100.0, "burn_fast": 0.0},
            clock=clock)
        ticks = [plane.maybe_tick(), plane.maybe_tick()]
        clock.advance(0.5)
        ticks.append(plane.maybe_tick())
        clock.advance(0.6)
        ticks.append(plane.maybe_tick())
        return {"ticks": ticks, "retunes": router.retunes,
                "status": plane.status()}

    got = both(scenario)
    assert got["ticks"] == [True, False, False, True]
    assert len(got["retunes"]) == 2 and len(got["status"]["decisions"]) == 2
    assert got["retunes"][-1] == {
        "max_linger_ms": got["status"]["batching"]["linger_ms"],
        "bucket_cap": got["status"]["batching"]["bucket_cap"]}


def test_plane_target_chain_and_bounded_ring_match_the_reference():
    def scenario(side):
        slo = SimpleNamespace(latency_p99_ms=120.0)
        targets = [side.control.ControlPlane(
            _plane_cfg(side, target_p99_ms=t), slo_cfg=s).target_p99_ms
            for t, s in ((None, slo), (33.0, slo), (None, None))]
        clock = FakeClock()
        plane = side.control.ControlPlane(
            _plane_cfg(side, decisions_keep=4, interval_s=0.0),
            initial_linger_ms=8.0, bucket_sizes=(),
            signals_fn=lambda now: {"p99_ms": 1000.0, "burn_fast": 0.0},
            clock=clock)
        for _ in range(40):
            clock.advance(1.0)
            plane.tick()
        return {"targets": targets, "status": plane.status()}

    got = both(scenario)
    assert got["targets"] == [120.0, 33.0, 250.0]
    assert len(got["status"]["decisions"]) == 4


def test_plane_status_folds_tenant_counters_like_the_reference():
    stats = {"w0": {"tenant_counters": {"admitted_class_gold": 3,
                                        "shed_class_bronze": 1}},
             "w1": {"tenant_counters": {"admitted_class_gold": 2}},
             "w2": {}}

    def scenario(side):
        return side.control.ControlPlane(
            _plane_cfg(side, tenant_classes=("gold", "bronze"),
                       tenant_weights=(3.0, 1.0),
                       tenant_quota_frac=(1.0, 0.5)),
            router=FakeRouter(stats)).status()

    got = both(scenario)
    assert got["tenants"] == {"admitted_class_gold": 5,
                              "shed_class_bronze": 1}
    assert got["qos"]["default_class"] == "standard"


def test_plane_reads_fleet_telemetry_like_the_reference():
    """Signals off a real ``FleetTelemetry``'s store and SLO engine, with
    no injected ``signals_fn``: the same p99, burn and decisions."""
    def scenario(side):
        from importlib import import_module

        root = side.config.__name__.rsplit(".", 1)[0]
        aggregate = import_module(f"{root}.obs.aggregate")
        clock = FakeClock()
        tele = aggregate.FleetTelemetry(side.config.SLOConfig(
            latency_p99_ms=10.0), clock=clock)
        plane = side.control.ControlPlane(
            _plane_cfg(side, target_p99_ms=None), telemetry=tele,
            initial_linger_ms=2.0, bucket_sizes=(8, 32), clock=clock)
        out = []
        rng = np.random.default_rng(2)
        metrics = side.Metrics()
        for step in range(12):
            clock.advance(1.0)
            for v in rng.lognormal(-4.0 - 0.2 * step, 1.0, 50):
                metrics.observe("total", float(v))
            tele.aggregator.observe_runtime(metrics, now=clock())
            tele.slo.maybe_evaluate()
            out.append(plane.tick())
        sig = plane.signals()
        return {"made": out, "status": plane.status(),
                "signals": [round(sig["p99_ms"], 9), sig["burn_fast"]]}

    got = both(scenario)
    assert got["status"]["target_p99_ms"] == 10.0
    assert sum(map(len, got["made"])) > 0 and got["signals"][1] > 0


# ---------------------------------------------------------------------------
# capacity model
# ---------------------------------------------------------------------------


class FakeCapGateway:
    """Latency = base + linger (the reference tests' fake): retuning the
    linger down cuts p99, so the A/B verdict is deterministic."""

    n_features = 4

    def __init__(self, side, base_ms=1.0, shed_over=None):
        self.metrics = side.Metrics()
        self.batcher = SimpleNamespace(config=side.Batcher(
            bucket_sizes=(4, 8), max_linger_s=0.002))
        self.linger_ms = 2.0
        self.base_ms = base_ms
        self.shed_over = shed_over
        self._queued = 0

    def open_session(self, sid, *a, **k):
        pass

    def close_session(self, sid):
        pass

    def submit(self, sid, row):
        if self.shed_over is not None and self._queued >= self.shed_over:
            self.metrics.count("shed_oldest")
            return
        self._queued += 1
        self.metrics.count("ticks_served")
        self.metrics.observe("total", (self.base_ms + self.linger_ms) / 1e3)

    def pump(self):
        self._queued = 0
        return []

    def drain(self):
        return []

    def retune(self, *, max_linger_ms=None, bucket_cap=None):
        if max_linger_ms is not None:
            self.linger_ms = max_linger_ms


def _timeless(artifact):
    """The artifact without its wall-clock rates (and the best cell,
    picked by them)."""
    out = json.loads(json.dumps(artifact))
    for cell in out["grid"]:
        cell.pop("ticks_per_s")
    out.pop("max_sustainable")
    return out


CAPACITY = {
    "schema": (dict(slo_p99_ms=10.0, session_grid=(2, 4),
                    duty_grid=(0.5, 1.0), rounds=10), {}),
    "controller_ab": (dict(slo_p99_ms=10.0, session_grid=(2, 4),
                           duty_grid=(1.0,), rounds=20), {}),
    "unsustainable": (dict(slo_p99_ms=10.0, session_grid=(4,),
                           duty_grid=(1.0,), rounds=5, controller_ab=False),
                      {"shed_over": 1}),
}


@pytest.mark.parametrize("name", sorted(CAPACITY))
def test_capacity_model_matches_the_reference(name):
    kw, gw_kw = CAPACITY[name]
    ref = jax_capacity.run_capacity_model(
        lambda n: FakeCapGateway(SIDES["jax"], **gw_kw), **kw)
    got = port_capacity.run_capacity_model(
        lambda n: FakeCapGateway(SIDES["port"], **gw_kw), **kw)
    assert _timeless(got) == _timeless(ref)
    assert port_capacity.CAPACITY_SCHEMA == jax_capacity.CAPACITY_SCHEMA
    assert tuple(got) == jax_capacity.CAPACITY_KEYS
    assert port_capacity.CAPACITY_KEYS == jax_capacity.CAPACITY_KEYS
    assert port_capacity.CELL_KEYS == jax_capacity.CELL_KEYS
    for cell in got["grid"]:
        assert tuple(cell) == jax_capacity.CELL_KEYS
        assert cell["served"] + cell["shed"] == cell["submitted"]
    if name == "controller_ab":
        ab = got["controller_ab"]
        assert ab["fixed_p99_ms"] == pytest.approx(3.0)
        assert ab["improved"] and ab["converged"]["linger_ms"] < 2.0
    elif name == "unsustainable":
        assert not got["grid"][0]["ok"] and got["max_sustainable"] is None


def test_capacity_model_over_real_pools_conserves_every_tick():
    """``pool_gateway_factory`` on the CPU (ssm, buckets 8/32, one pool a
    cell): the reference's keys, served + shed = submitted in every cell,
    every bucket warmed before its cell."""
    cfg = port_config.ModelConfig(hidden_size=8, n_features=FEATS,
                                  bidirectional=False, dropout=0.0,
                                  cell="ssm")
    from fmda_tpu_torch.models import build_model
    import torch

    state = build_model(cfg, generator=torch.Generator().manual_seed(0)
                        ).state_dict()
    pools = []
    factory = port_capacity.pool_gateway_factory(
        cfg, state, window=WINDOW, bucket_sizes=(8, 32), max_linger_ms=2.0,
        device="cpu", pools=pools)
    out = port_capacity.run_capacity_model(
        factory, slo_p99_ms=50.0, session_grid=(8, 16), duty_grid=(0.5, 1.0),
        rounds=6)
    assert tuple(out) == jax_capacity.CAPACITY_KEYS
    assert len(pools) == 4 + 3  # the grid, then the A/B's three gateways
    for cell in out["grid"]:
        assert tuple(cell) == jax_capacity.CELL_KEYS
        assert cell["served"] + cell["shed"] == cell["submitted"] > 0
    assert all(p.capacity == n for p, n in zip(pools, (8, 8, 16, 16)))


def test_pool_gateway_factory_needs_a_card_by_default(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config.ModelConfig(hidden_size=4, n_features=3,
                                  bidirectional=False, dropout=0.0)
    factory = port_capacity.pool_gateway_factory(cfg, {}, window=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        factory(4)


# ---------------------------------------------------------------------------
# the gateway under overload: the port against the reference
# ---------------------------------------------------------------------------


def _weights(cell="gru", seed=0, feats=FEATS):
    fields = dict(hidden_size=HIDDEN, n_features=feats, output_size=4,
                  dropout=0.0, bidirectional=False, cell=cell)
    jax_cfg = jax_config.ModelConfig(use_pallas=False, **fields)
    params = jax.device_get(jax_build_model(jax_cfg).init(
        {"params": jax.random.PRNGKey(seed)},
        jnp.zeros((1, WINDOW, feats)))["params"])
    return ((jax_cfg, params),
            (port_config.ModelConfig(**fields), params_from_flax(params)))


def _qos_gateways(queue_bound=4, cell="gru", capacity=8):
    (jcfg, jparams), (pcfg, pstate) = _weights(cell)
    buckets = dict(bucket_sizes=(1, 2, 4, 8), max_linger_s=10.0)
    ref = JaxFleetGateway(
        JaxSessionPool(jcfg, jparams, capacity=capacity, window=WINDOW),
        None, batcher_config=JaxBatcherConfig(**buckets),
        queue_bound=queue_bound, pipeline_depth=0)
    ref.attach_qos(jax_control.QosPolicy(("gold", "bronze"), (3.0, 1.0),
                                         (1.0, 0.5)))
    got = FleetGateway(
        SessionPool(pcfg, pstate, capacity=capacity, window=WINDOW,
                    device="cpu"),
        None, batcher_config=BatcherConfig(**buckets),
        queue_bound=queue_bound, pipeline_depth=0)
    got.attach_qos(port_control.QosPolicy(("gold", "bronze"), (3.0, 1.0),
                                          (1.0, 0.5)))
    return ref, got


def _overload(gw, norm_cls, script, seed=0):
    """Open the sessions, run ``script`` (session ids to submit, or
    "pump"/"drain"), return the counters, the class bookkeeping and the
    results in order."""
    rng = np.random.default_rng(seed)
    tenants = {"s0": "gold", "s1": "gold", "s2": "bronze", "s3": "bronze",
               "s4": None}
    for sid, ten in tenants.items():
        mn = rng.normal(size=FEATS).astype(np.float32)
        gw.open_session(sid, norm_cls(mn, mn + 2.0), tenant=ten)
    results = []
    queued = []
    for op in script:
        if op in ("pump", "drain"):
            results += getattr(gw, op)()
        else:
            gw.submit(op, rng.normal(size=FEATS).astype(np.float32))
        queued.append(dict(gw._queued_by_class))
    results += gw.drain()
    return (dict(gw.metrics.counters), queued,
            [(r.session_id, r.seq, np.asarray(r.probabilities))
             for r in results])


OVERLOADS = {
    # bronze's quota is 2 of 4: its third tick sheds its own oldest
    "quota_shed": (4, ["s2", "s3", "s2"]),
    # bronze first, gold fills the bound, the overflow's victim is WFQ's
    "wfq_victim": (4, ["s2", "s3", "s0", "s1", "s0"]),
    # a long seeded mix with pumps: every admit/shed counted per class
    "seeded_mix": (6, [str(x) for x in np.random.default_rng(4).choice(
        ["s0", "s1", "s2", "s3", "s4", "pump"], 80,
        p=[0.2, 0.1, 0.3, 0.25, 0.05, 0.1])]),
    "drain": (64, ["s0", "s2"] * 5 + ["drain"]),
}


@pytest.mark.parametrize("name", sorted(OVERLOADS))
def test_gateway_qos_under_overload_matches_the_reference(name):
    bound, script = OVERLOADS[name]
    ref_gw, gw = _qos_gateways(queue_bound=bound)
    ref = _overload(ref_gw, JaxNormParams, script)
    got = _overload(gw, NormParams, script)
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert [r[:2] for r in got[2]] == [r[:2] for r in ref[2]]
    for (_, _, a), (_, _, b) in zip(got[2], ref[2]):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    counters = got[0]
    if name == "quota_shed":
        assert counters["quota_shed"] == 1
        assert counters["shed_class_bronze"] == 1
        assert "shed_class_gold" not in counters
    elif name == "wfq_victim":
        assert counters["shed_oldest"] == 1
        assert counters["shed_class_bronze"] == 1
        assert got[1][-1] == {"bronze": 1, "gold": 3}
    assert got[1][-1] == {} or name != "drain"
    for cls in ("gold", "bronze", "standard"):
        admitted = counters.get(f"admitted_class_{cls}", 0)
        shed = counters.get(f"shed_class_{cls}", 0)
        served = sum(1 for sid, _, _ in got[2]
                     if {"s0": "gold", "s1": "gold", "s2": "bronze",
                         "s3": "bronze"}.get(sid, "standard") == cls)
        assert admitted - shed == served


def test_gateway_tenant_export_import_and_retune_match_the_reference():
    ref_gw, gw = _qos_gateways()
    out = []
    for g in (ref_gw, gw):
        g.open_session("s", tenant="bronze")
        state = g.export_session("s")
        g.close_session("s")
        dropped = g.session_tenant("s")
        g.import_session("s", state)
        g.retune(max_linger_ms=2.5, bucket_cap=3)
        caps = [g.batcher.effective_cap(), g.batcher.config.max_linger_s]
        g.retune(bucket_cap=None)
        caps.append(g.batcher.effective_cap())
        out.append([state["tenant"], dropped, g.session_tenant("s"), caps,
                    g.metrics.counters["retunes_applied"]])
    assert out[0] == out[1]
    assert out[1] == ["bronze", None, "bronze", [2, 0.0025, 8], 2]


def test_run_fleet_load_tenant_mix_matches_the_reference():
    (jcfg, jparams), (pcfg, pstate) = _weights()
    kw = dict(n_sessions=6, n_ticks=5, duty=1.0, seed=3,
              tenant_classes=("gold", "standard"), tenant_weights=(1.0, 1.0))
    outs = []
    for gw, load, run in (
            (JaxFleetGateway(JaxSessionPool(jcfg, jparams, capacity=8,
                                            window=WINDOW), None,
                             batcher_config=JaxBatcherConfig(
                                 bucket_sizes=(1, 8), max_linger_s=0.0),
                             pipeline_depth=0),
             JaxLoadConfig, jax_run_fleet_load),
            (FleetGateway(SessionPool(pcfg, pstate, capacity=8,
                                      window=WINDOW, device="cpu"), None,
                          batcher_config=BatcherConfig(
                              bucket_sizes=(1, 8), max_linger_s=0.0),
                          pipeline_depth=0),
             FleetLoadConfig, run_fleet_load)):
        out = run(gw, load(**kw))
        outs.append((out["submitted_by_class"], out["ticks_served"],
                     [gw.session_tenant(f"T{i:04d}") for i in range(6)]))
    assert outs[0] == outs[1]
    assert sum(outs[1][0].values()) == outs[1][1] == 30


# ---------------------------------------------------------------------------
# the fleet wiring (in-process, fake clock)
# ---------------------------------------------------------------------------


def _mini_topology(worker_ids, *, all_ids=None, qos=None, bucket_sizes=(1,),
                   state=None):
    from fmda_tpu_torch.config import (
        DEFAULT_TOPICS,
        FleetTopologyConfig,
        RuntimeConfig,
        fleet_topics,
    )
    from fmda_tpu_torch.fleet.router import FleetRouter
    from fmda_tpu_torch.fleet.worker import FleetWorker
    from fmda_tpu_torch.stream.bus import InProcessBus

    (_, _), (cfg, params) = _weights() if state is None else state
    clock = FakeClock()
    bus = InProcessBus(tuple(DEFAULT_TOPICS)
                       + fleet_topics(all_ids or worker_ids))
    fleet_cfg = FleetTopologyConfig(heartbeat_interval_s=0.0,
                                    heartbeat_timeout_s=50.0)
    rc = RuntimeConfig(capacity=8, window=WINDOW, bucket_sizes=bucket_sizes,
                       max_linger_ms=0.0, pipeline_depth=0)

    def make(w, **kw):
        return FleetWorker(w, bus, cfg, params, config=fleet_cfg, runtime=rc,
                           clock=clock, precompile=False, device="cpu", **kw)

    workers = {w: make(w, qos=qos) for w in worker_ids}
    router = FleetRouter(bus, fleet_cfg, n_features=FEATS, clock=clock)
    for w in workers.values():
        w.start()
    router.pump()
    return router, workers, clock, make


def _cycle(router, workers, got):
    router.pump()
    for w in workers:
        if not w.stopped:
            w.step()
    for res in router.pump():
        got.setdefault(res.session_id, []).append(res)


def test_retune_broadcast_reaches_every_worker_gateway():
    router, workers, _, _ = _mini_topology(["w0", "w1"], bucket_sizes=(1, 4))
    assert router.broadcast_retune(max_linger_ms=3.0, bucket_cap=1) == 2
    router.pump()
    for w in workers.values():
        w.step()
    for w in workers.values():
        assert w.gateway.batcher.config.max_linger_s == pytest.approx(0.003)
        assert w.gateway.batcher.effective_cap() == 1
    assert router.metrics.counters["retunes_broadcast"] == 1


def test_worker_qos_reports_carry_tenant_and_class_counters():
    qos = port_control.QosPolicy(("gold", "bronze"), (3.0, 1.0), (1.0, 0.5))
    router, workers, _, _ = _mini_topology(["w0"], qos=qos)
    router.open_session("S0", tenant="gold")
    router.open_session("S1")
    rng = np.random.default_rng(0)
    got = {}
    for _ in range(3):
        router.submit("S0", rng.normal(size=FEATS).astype(np.float32))
        _cycle(router, workers.values(), got)
    w = workers["w0"]
    assert w.gateway.qos is qos
    report = w.session_report()
    assert report["S0"]["tenant"] == "gold" and "tenant" not in report["S1"]
    assert w.stats()["tenant_counters"]["admitted_class_gold"] == 3
    _cycle(router, workers.values(), got)
    assert router.worker_stats()["w0"]["tenant_counters"][
        "admitted_class_gold"] == 3
    # the plane folds the heartbeat-carried counters fleet-wide
    plane = port_control.ControlPlane(
        port_config.ControlConfig(tenant_classes=("gold",),
                                  tenant_weights=(3.0,),
                                  tenant_quota_frac=(1.0,)),
        router=router)
    assert plane.status()["tenants"] == {"admitted_class_gold": 3}


def _elastic_decisions_reference():
    """The reference's in-process elastic loop on the same schedule: its
    decisions and its results, for the port to match."""
    from fmda_tpu.config import (
        DEFAULT_TOPICS,
        FleetTopologyConfig,
        RuntimeConfig,
        fleet_topics,
    )
    from fmda_tpu.fleet.router import FleetRouter
    from fmda_tpu.fleet.worker import FleetWorker
    from fmda_tpu.stream.bus import InProcessBus

    (cfg, params), _ = _weights()
    clock = FakeClock()
    bus = InProcessBus(tuple(DEFAULT_TOPICS) + fleet_topics(["w0", "w1"]))
    fleet_cfg = FleetTopologyConfig(heartbeat_interval_s=0.0,
                                    heartbeat_timeout_s=50.0)
    rc = RuntimeConfig(capacity=8, window=WINDOW, bucket_sizes=(1,),
                       max_linger_ms=0.0, pipeline_depth=0)

    def make(w):
        return FleetWorker(w, bus, cfg, params, config=fleet_cfg, runtime=rc,
                           clock=clock, precompile=False)

    workers = {"w0": make("w0")}
    router = FleetRouter(bus, fleet_cfg, n_features=FEATS, clock=clock)
    workers["w0"].start()
    router.pump()
    return _elastic_run(jax_control, jax_config, JaxNormParams, router,
                        workers, clock, make)


def _elastic_run(control, config, norm_cls, router, workers, clock, make):
    n_rounds = 12
    tenants = {"E0": "gold", "E1": "standard", "E2": "bronze", "E3": "gold"}
    rng = np.random.default_rng(5)
    norms, rows = {}, {}
    for sid in tenants:
        mn = rng.normal(size=FEATS).astype(np.float32)
        norms[sid] = (mn, mn + 2.0)
        rows[sid] = rng.normal(size=(n_rounds, FEATS)).astype(np.float32)
    live = list(workers.values())

    class InProcessActuator:
        def n_workers(self):
            return len(router.membership.live())

        def spawn_worker(self):
            workers["w1"] = make("w1")
            live.append(workers["w1"])
            workers["w1"].start()
            return "w1"

        def retire_worker(self):
            alive = router.membership.live()
            if len(alive) < 2:
                return None
            return alive[-1] if router.request_leave(alive[-1]) else None

    signal = {"p99_ms": None, "burn_fast": 0.0}
    plane = control.ControlPlane(
        config.ControlConfig(batching=False, autoscale=True,
                             target_p99_ms=100.0, min_workers=1,
                             max_workers=2, scale_up_burn=1.0,
                             up_sustain_s=0.5, scale_down_frac=0.5,
                             down_sustain_s=1.0, cooldown_s=0.5,
                             interval_s=0.0),
        router=router, actuator=InProcessActuator(),
        signals_fn=lambda now: dict(signal), clock=clock)
    got = {}
    for sid in tenants:
        router.open_session(sid, norm_cls(*norms[sid]), tenant=tenants[sid])
    for r in range(n_rounds):
        if r == 4:
            signal.update(p99_ms=400.0, burn_fast=4.0)
        if r == 8:
            signal.update(p99_ms=5.0, burn_fast=0.0)
        for sid in tenants:
            router.submit(sid, rows[sid][r])
        for _ in range(4):
            _cycle(router, live, got)
        clock.advance(0.4)
        plane.tick()
    for _ in range(10):
        _cycle(router, live, got)
        clock.advance(0.4)
        plane.tick()
    return {
        "decisions": list(plane.decisions),
        "live": router.membership.live(),
        "retired": workers["w1"].stopped if "w1" in workers else None,
        "lost": router.metrics.counters.get("sessions_lost_state", 0),
        "migrated": router.metrics.counters.get("migrations_completed", 0),
        "tenants": {sid: router.session_tenant(sid) for sid in tenants},
        "seqs": {sid: [r_.seq for r_ in got[sid]] for sid in tenants},
        "probs": {sid: np.stack([np.asarray(r_.probabilities)
                                 for r_ in got[sid]]) for sid in tenants},
        "rows": rows, "norms": norms,
    }


def test_inprocess_elastic_loop_scales_up_and_down_losslessly():
    """A forced latency spike drives the plane's autoscaler to spawn a
    second in-process worker (sessions rebalance onto it by live
    migration), sustained idle retires it through ``request_leave``: the
    reference's decisions; every tick served once, in order, bit for bit
    the port's never-scaled gateway and within 1e-5 of the reference."""
    ref = _elastic_decisions_reference()
    router, workers, clock, make = _mini_topology(["w0"],
                                                  all_ids=["w0", "w1"])
    got = _elastic_run(port_control, port_config, NormParams, router,
                       workers, clock, make)
    assert got["decisions"] == ref["decisions"]
    actions = [d["action"] for d in got["decisions"]]
    assert "scale_up" in actions and "scale_down" in actions
    assert got["retired"] and got["live"] == ["w0"]
    assert got["lost"] == 0 and got["migrated"] >= 1
    assert got["tenants"] == ref["tenants"] == {
        "E0": "gold", "E1": "standard", "E2": "bronze", "E3": "gold"}
    (_, _), (cfg, state) = _weights()
    solo = FleetGateway(
        SessionPool(cfg, state, capacity=8, window=WINDOW, device="cpu"),
        None, batcher_config=BatcherConfig(bucket_sizes=(1,),
                                           max_linger_s=0.0),
        pipeline_depth=0)
    for sid, (mn, mx) in got["norms"].items():
        solo.open_session(sid, NormParams(mn, mx))
    unscaled = {sid: [] for sid in got["norms"]}
    for r in range(12):
        for sid in got["norms"]:
            solo.submit(sid, got["rows"][sid][r])
            for res in solo.drain():
                unscaled[res.session_id].append(res.probabilities)
    for sid in got["norms"]:
        assert got["seqs"][sid] == ref["seqs"][sid] == list(range(12))
        np.testing.assert_array_equal(got["probs"][sid],
                                      np.stack(unscaled[sid]))
        np.testing.assert_allclose(got["probs"][sid], ref["probs"][sid],
                                   atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# the observability surface
# ---------------------------------------------------------------------------


def test_control_endpoint_serves_the_plane_document():
    from fmda_tpu_torch.obs.aggregate import FleetTelemetry
    from fmda_tpu_torch.obs.registry import MetricsRegistry
    from fmda_tpu_torch.obs.server import MetricsServer

    side = SIDES["port"]
    plane = port_control.ControlPlane(_plane_cfg(side))
    server = MetricsServer(MetricsRegistry(), control_fn=plane.status).start()
    try:
        with urllib.request.urlopen(f"{server.url}/control") as resp:
            doc = json.loads(resp.read())
    finally:
        server.stop()
    assert doc == json.loads(json.dumps(jax_control.ControlPlane(
        _plane_cfg(SIDES["jax"])).status()))
    telemetry = FleetTelemetry(port_config.FrameworkConfig().slo)
    assert telemetry.control() == {"enabled": False}
    telemetry.attach_controller(plane)
    tele_server = telemetry.start_server()
    try:
        with urllib.request.urlopen(f"{tele_server.url}/control") as resp:
            assert json.loads(resp.read())["target_p99_ms"] == 10.0
    finally:
        tele_server.stop()
        telemetry.close()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "gold:3,standard:1,bronze", None, "", "gold", " gold : 2 ,x:0.5",
    "gold:three", ":1", "gold:1,,standard:2",
])
def test_tenant_mix_parses_like_the_reference(spec):
    from fmda_tpu_torch.__main__ import _tenant_mix

    def parse(fn):
        try:
            return fn(Namespace(tenant_mix=spec))
        except SystemExit as e:
            return ("exit", str(e))

    got = parse(_tenant_mix)
    assert got == parse(jax_cli._tenant_mix)
    if spec == "gold:3,standard:1,bronze":
        assert got == (("gold", "standard", "bronze"), (3.0, 1.0, 1.0))


def test_status_control_section_prints_the_reference_text():
    from fmda_tpu_torch.obs.report import print_control

    stats = {"w0": {"tenant_counters": {"admitted_class_gold": 5,
                                        "shed_class_gold": 1}}}
    texts = []
    for side, printer in ((SIDES["jax"], jax_cli._print_control),
                          (SIDES["port"], print_control)):
        plane = side.control.ControlPlane(
            _plane_cfg(side, tenant_classes=("gold",), tenant_weights=(2.0,),
                       tenant_quota_frac=(1.0,), autoscale=True),
            router=FakeRouter(stats), actuator=FakeActuator(2),
            initial_linger_ms=1.0, bucket_sizes=(8,),
            signals_fn=lambda now: {"p99_ms": 100.0, "burn_fast": 0.0})
        for t in range(7):
            plane.tick(now=float(t))
        buf = io.StringIO()
        with redirect_stdout(buf):
            printer(plane.status())
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    assert "target p99" in texts[1] and "admitted_class_gold" in texts[1]


#: the serve-fleet command lines that exited 2 before the control plane and
#: the chaos soaks were ported (each test file's own argument prefix): each
#: now passes the refusal gate, as on the reference, which refuses none
_RT = ["serve-fleet", "--hidden", "4", "--window", "3", "--seed", "0",
       "--device", "cpu"]
_MH = ["--hidden", "8", "--window", "4", "--device", "cpu"]
NOW_RUN = [
    _RT + ["--role", "broker", "--tenant-mix", "gold:1"],
    _RT + ["--role", "router"],
    _RT + ["--role", "worker", "--chaos-plan", "p.json"],
    _RT + ["--role", "local"],
    _RT + ["--role", "router", "--listen", "9000"],
    _RT + ["--role", "router", "--connect", "h:9000"],
    _RT + ["--role", "local", "--duration-s", "5"],
    _RT + ["--role", "local", "--no-controller", "--chaos-no-reference"],
    _RT + ["--role", "local", "--trace-dir", "d"],
    _RT + ["--role", "router", "--postmortem-dir", "d"],
    _RT + ["--chaos-plan", "p.json"],
    _RT + ["--role", "router", "--wire-format", "json"],
    _RT + ["--role", "local", "--workers", "2"],
    _RT + ["--tenant-mix", "gold:1"],
    ["serve-fleet", "--role", "router"] + _MH,
    ["serve-fleet", "--role", "local"] + _MH,
    ["serve-fleet", "--role", "local", "--no-controller", "--tenant-mix",
     "gold:1"] + _MH,
    ["serve-fleet", "--role", "local", "--no-controller", "--chaos-plan",
     "generate"] + _MH,
    ["serve-fleet", "--role", "local", "--no-controller",
     "--chaos-no-reference"] + _MH,
    ["serve-fleet", "--role", "worker", "--worker-id", "w0", "--connect",
     "127.0.0.1:1", "--config", "TENANTS"] + _MH,
    ["serve-fleet", "--role", "local", "--trace-dir", "TMP", "--device",
     "cpu"],
    ["serve-fleet", "--role", "local", "--postmortem-dir", "TMP", "--device",
     "cpu"],
]


@pytest.mark.parametrize("argv", NOW_RUN, ids=lambda a: " ".join(a[1:]))
def test_serve_fleet_argv_that_waited_now_passes_the_gate(argv, tmp_path):
    from fmda_tpu_torch.__main__ import (
        _config,
        _control_plane,
        _fleet_flag_conflict,
        _fleet_telemetry,
        _fleet_wire_override,
        _unported_fleet_flag,
        _worker_qos,
        build_parser,
    )
    from fmda_tpu_torch.control import ControlPlane

    cfg_path = tmp_path / "tenants.json"
    cfg_path.write_text(json.dumps({"control": {
        "tenant_classes": ["gold"], "tenant_weights": [1.0],
        "tenant_quota_frac": [1.0]}}))
    argv = [{"TENANTS": str(cfg_path), "TMP": str(tmp_path)}.get(a, a)
            for a in argv]
    args = build_parser().parse_args(argv)
    ref_args = jax_cli.build_parser().parse_args(
        [a for a in argv if a not in ("--device", "cpu")])
    assert _unported_fleet_flag(args) == "" and _fleet_flag_conflict(
        args) == ""
    for dest in ("tenant_mix", "chaos_plan", "chaos_no_reference",
                 "no_controller", "role"):
        assert getattr(args, dest) == getattr(ref_args, dest)
    cfg = _fleet_wire_override(args, _config(args))
    if args.role in ("router", "local"):
        telemetry = _fleet_telemetry(args, cfg)
        try:
            plane = _control_plane(args, cfg, telemetry)
            assert (plane is None) == args.no_controller
            assert plane is None or (
                isinstance(plane, ControlPlane)
                and telemetry.control() == plane.status())
        finally:
            telemetry.close()
    qos = _worker_qos(cfg)
    assert (qos is None) == (not cfg.control.tenant_classes)
    if qos is not None:
        assert qos.classify("gold") == "gold"


def test_router_role_runs_its_control_plane(capsys):
    assert port_main(["serve-fleet", "--role", "router", "--listen", "0",
                      "--duration-s", "0.3"]) == 0
    out = json.loads(capsys.readouterr().out)
    control = out["control"]
    assert control["enabled"] and control["target_p99_ms"] == 250.0
    # no actuator on a bare router: the autoscale loop stays off
    assert "batching" in control and "autoscale" not in control


def test_local_role_with_controller_and_tenant_mix(tmp_path):
    """The reference's control-plane drive, spawned on the CPU: one
    worker, 8 sessions x 200 ticks, gold:1,standard:3 with the classes
    configured and the telemetry and control cadences at 50 ms (so the
    loop decides inside the load); the report's control section carries
    the loops, the decisions ring and the per-class admits folded off the
    heartbeats, split exactly by the mix."""
    cfg = tmp_path / "qos.json"
    cfg.write_text(json.dumps({
        "control": {"tenant_classes": ["gold", "standard"],
                    "tenant_weights": [3.0, 1.0],
                    "tenant_quota_frac": [1.0, 1.0], "interval_s": 0.05},
        # telemetry folds and control decisions inside a short load
        "slo": {"interval_s": 0.05}}))
    proc = subprocess.run(
        [sys.executable, "-m", "fmda_tpu_torch", "serve-fleet", "--role",
         "local", "--workers", "1", "--sessions", "8", "--ticks", "200",
         "--hidden", "4", "--window", "4", "--tenant-mix",
         "gold:1,standard:3", "--config", str(cfg), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=180,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout)
    control = out["control"]
    assert {"enabled", "batching", "autoscale", "decisions",
            "qos"} <= set(control)
    assert control["decisions"] and control["interval_s"] == 0.05
    tenants = control["tenants"]
    admitted = {k: v for k, v in tenants.items()
                if k.startswith("admitted_class_")}
    assert admitted == {"admitted_class_gold": 400,
                        "admitted_class_standard": 1200}
    assert out["ticks_submitted"] == 1600
    assert out["ticks_served"] == out["ticks_submitted"]
