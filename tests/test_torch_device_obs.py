"""fmda_tpu_torch's device plane on the CPU: the kernel ledger's pinned
schema, its booking through the wrappers' seam, sampled timing on stand-in
events, MFU between scrapes, and a CPU fleet run booking nothing (CPU
calls launch nothing); the cost formulas against hand-counted small
shapes; the memory monitor's owner attribution (each storage once), its
cadence gate, leak heuristic and missing allocator figures without a
card; ``configure_device_obs``, ``device_report`` and the ``perf``
command."""

import json

import numpy as np
import pytest
import torch

from fmda_tpu_torch import ops
from fmda_tpu_torch.__main__ import main as port_main
from fmda_tpu_torch.config import ModelConfig, ProfilingConfig
from fmda_tpu_torch.models import build_model
from fmda_tpu_torch.obs import device as device_mod
from fmda_tpu_torch.obs.device import (
    KERNEL_SCHEMA,
    LEDGER_SCHEMA,
    REPORT_SCHEMA,
    DeviceMemoryMonitor,
    KernelLedger,
    configure_device_obs,
    device_report,
)
from fmda_tpu_torch.obs.pyprof import default_profiler
from fmda_tpu_torch.ops import cost
from fmda_tpu_torch.runtime import (
    BatcherConfig,
    FleetGateway,
    FleetLoadConfig,
    SessionPool,
    run_fleet_load,
)


class FakeEvent:
    """A stand-in CUDA event: completes after ``lag`` queries, then reads
    its recording order in ms."""

    clock = 0

    def __init__(self, lag=0):
        self.lag = lag

    def record(self):
        FakeEvent.clock += 1
        self.t = FakeEvent.clock

    def query(self):
        self.lag -= 1
        return self.lag < 0

    def elapsed_time(self, end):
        return float(end.t - self.t) * 0.5


@pytest.fixture
def attached():
    """A fresh ledger attached to the wrappers' seam for one test."""
    led = KernelLedger(sample_every=2, event=FakeEvent)
    ops.attach_ledger(led)
    yield led
    ops.attach_ledger(None)


# ---------------------------------------------------------------------------
# the cost formulas
# ---------------------------------------------------------------------------


def test_scan_cost_counts_by_hand():
    # B=2, T=3, H=4, f32, masked: xp 2*3*12, hs 2*3*4, h0+h_last 2*2*4,
    # W_hh 12*4, b_hh 12 values of 4 bytes, plus the mask's 6 bytes
    c = cost.scan_cost(2, 3, 4, 4, True, gates=3, states=1, elementwise=10)
    assert c.bytes_moved == 4 * (72 + 24 + 16 + 48 + 12) + 6
    assert c.product_flops == 2 * 2 * 3 * 12 * 4
    assert c.elementwise_flops == 10 * 2 * 3 * 4
    assert c.flops == c.product_flops + c.elementwise_flops
    lstm = cost.scan_cost(1, 1, 2, 2, False, gates=4, states=2,
                          elementwise=14)
    assert lstm.bytes_moved == 2 * (8 + 4 + 8 + 16 + 8)
    bwd = cost.scan_bwd_cost(1, 2, 2, 4, False, gates=3, states=1,
                             elementwise=30)
    # xp, hs, dhs, dxp over B*T; h0, W_hh, b_hh in; dh_last/dh0, dW, db
    assert bwd.bytes_moved == 4 * (2 * (6 + 2 + 2 + 6) + 2 + 12 + 6) + 4 * (
        4 + 12 + 6)
    assert bwd.product_flops == 6 * 3 * 2 * 2 * 2


def test_ssm_tick_and_flash_costs_by_hand():
    c = cost.ssm_cost(2, 3, 4)
    assert c == cost.Cost(4 * (10 * 6 + 12), 0, 19 * 6 + 6, 4)
    t = cost.tick_cost(1, 1, 2, 1, 1, 4)
    # rows, slots, 2 norm rows; weights 3*2 + 7 + 1*(3+1); state in+out;
    # pos in+out; probabilities
    assert t.bytes_moved == 8 + 4 + 16 + 4 * 17 + 2 * 4 * 3 + 16 + 4
    assert t.product_flops == 2 * (3 * 2 + 3)
    assert t.elementwise_flops == 19 + 4 + 2 + 2
    c = dict(batch=1, heads=2, seq=3, d=4)
    assert cost.flash_dense_pairs(1, 2, 3, False) == 18
    assert cost.flash_dense_pairs(1, 2, 3, True) == 12
    fwd = cost.flash_cost("flash_fwd", c, 2, 18, False)
    assert fwd == cost.Cost(2 * 4 * 24 + 4 * 6, 4 * 4 * 18, 0, 2)
    bwd = cost.flash_cost("flash_bwd", c, 4, 12, True)
    assert bwd == cost.Cost(4 * 7 * 24 + 8 * 6 + 3, 10 * 4 * 12, 0, 4)


def test_roofline_and_launch_costs():
    ms, by = cost.roofline_ms(cost.PEAK_BYTES_PER_S / 1e3, 0, 0, 4)
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = cost.roofline_ms(0, cost.PEAK_F32_FLOP_PER_S / 1e3, 0, 4)
    assert ms == pytest.approx(1.0) and by == "operations"
    ms, _ = cost.roofline_ms(0, cost.PEAK_BF16_TC_FLOP_PER_S / 1e3, 0, 2)
    assert ms == pytest.approx(1.0)
    assert set(cost.LAUNCH_COSTS) == set(ops.LAUNCH_COUNTERS)
    sig = {"ssm_tick": (64, 1, 108, 32, 4, 4),
           "ssm_step": (64, 32, 4), "scan_dw": (2, 3, 4),
           **{k: (8, 30, 32, 4, False) for k in (
               "gru_scan_fwd", "gru_scan_bwd", "lstm_scan_fwd",
               "lstm_scan_bwd")},
           **{k: (2, 4, 30, 8, 4, True, False) for k in cost.FLASH_FLOPS},
           **{f"{c}_wide_fwd": (8, 32, 4, False) for c in ("gru", "lstm")},
           **{f"{c}_wide_bwd": (8, 32, 4, False, True, True)
              for c in ("gru", "lstm")},
           **{k: (8, 30, 32, 4, False) for k in (
               "lstm_persist_fwd", "lstm_persist_bwd")},
           "gru_wide_step_fwd": (8, 64, 2, False),
           "gru_wide_bwd_step": (8, 64, 2, False, True)}
    for kernel, fn in cost.LAUNCH_COSTS.items():
        assert isinstance(fn(sig[kernel]), cost.Cost)
    assert cost.LAUNCH_COSTS["ssm_tick"](sig["ssm_tick"]) == cost.tick_cost(
        64, 1, 108, 32, 4, 4)
    assert cost.LAUNCH_COSTS["scan_dw"](sig["scan_dw"]).flops == 0


# ---------------------------------------------------------------------------
# the kernel ledger
# ---------------------------------------------------------------------------


def test_ledger_dump_schema_is_pinned(attached):
    doc = attached.dump()
    assert tuple(doc) == LEDGER_SCHEMA
    assert doc["launches_total"] == 0 and doc["kernels"] == []
    ops.launch_done(ops.book_launch("ssm_tick", (8, 1, 108, 32, 4, 4)))
    doc = attached.dump()
    assert [tuple(k) for k in doc["kernels"]] == [KERNEL_SCHEMA]
    assert json.loads(json.dumps(doc)) == doc


def test_ledger_books_launches_costs_and_sampled_time(attached):
    sig = (64, 1, 108, 32, 4, 4)
    for _ in range(5):
        ops.launch_done(ops.book_launch("ssm_tick", sig))
    ops.launch_done(ops.book_launch("flash_bwd", (2, 4, 30, 8, 4, False,
                                                  False)),
                    ("flash_dkv", "flash_dq"))
    assert attached.launches() == {"ssm_tick": 5, "flash_dkv": 1,
                                   "flash_dq": 1}
    totals = attached.kernel_totals()
    one = cost.tick_cost(*sig)
    assert totals["ssm_tick"]["flops"] == 5 * one.flops
    assert totals["ssm_tick"]["bytes_moved"] == 5 * one.bytes_moved
    # every 2nd launch is timed: 2 of 5, each pair 0.5 ms apart
    assert totals["ssm_tick"]["sampled"] == 2
    assert totals["ssm_tick"]["device_ms_mean"] == 0.5
    assert totals["ssm_tick"]["device_ms_min"] == 0.5
    assert totals["flash_dkv"]["device_ms_min"] is None
    doc = attached.dump()
    assert doc["sampled_launches_total"] == 2
    assert doc["device_ms_sampled_total"] == 1.0
    attached.reset()
    assert attached.launches() == {} and attached.dump()["kernels"] == []


def test_call_booked_books_around_the_c_call_alone(attached):
    calls = []

    def c_entry(*args):
        calls.append((args, attached.launches().get("ssm_step", 0)))
        return 0

    sig = (8, 32, 4)
    assert ops.call_booked("ssm_step", sig, c_entry, (1, 2, 3)) == 0
    assert calls == [((1, 2, 3), 0)]  # booked once the call returned
    fused = [0]
    ops.call_booked("flash_bwd", (2, 4, 30, 8, 4, False, False), c_entry,
                    (), kernels=lambda: None if fused[0]
                    else ("flash_dkv", "flash_dq"))
    assert attached.launches() == {"ssm_step": 1, "flash_dkv": 1,
                                   "flash_dq": 1}
    ops.attach_ledger(None)
    assert ops.call_booked("ssm_step", sig, c_entry, (4,)) == 0
    assert attached.launches()["ssm_step"] == 1


def test_ledger_keeps_the_tightest_sampled_time():
    spans = iter([3.0, 0.25, 1.0])

    class Timed(FakeEvent):
        def elapsed_time(self, end):
            return next(spans)

    led = KernelLedger(sample_every=1, event=Timed)
    for _ in range(3):
        led.end(led.begin("ssm_tick", (64, 1, 108, 32, 4, 4)))
    (entry,) = led.dump()["kernels"]
    assert entry["device_ms_min"] == 0.25
    assert entry["device_ms_mean"] == pytest.approx(4.25 / 3)


def test_ledger_reads_only_completed_pairs():
    led = KernelLedger(sample_every=1, event=lambda: FakeEvent(lag=2))
    ops.attach_ledger(led)
    try:
        ops.launch_done(ops.book_launch("ssm_step", (8, 32, 4)))
    finally:
        ops.attach_ledger(None)
    assert led.dump()["pending_samples"] == 1  # not done: no wait
    assert led.dump()["pending_samples"] == 1
    assert led.dump()["sampled_launches_total"] == 1  # done on 3rd query


def test_ledger_mfu_between_scrapes(attached, monkeypatch):
    sig = (256, 30, 32, 4, False)
    now = [100.0]
    monkeypatch.setattr(device_mod.time, "monotonic", lambda: now[0])
    attached.families()  # the first scrape sets the baseline
    for _ in range(10):
        ops.launch_done(ops.book_launch("gru_scan_fwd", sig))
    now[0] += 2.0
    fams = attached.families()
    c = cost.LAUNCH_COSTS["gru_scan_fwd"](sig)
    want = 10 * c.flops / 2.0 / cost.PEAK_F32_FLOP_PER_S
    gauges = {g["name"]: g["value"] for g in fams["gauges"]}
    assert gauges["device_mfu"] == pytest.approx(want)
    assert gauges["device_arithmetic_intensity"] == pytest.approx(
        c.flops / c.bytes_moved)
    assert 0 < attached.mfu() < 1
    counters = {(s["name"], s["labels"].get("kernel")): s["value"]
                for s in fams["counters"]}
    assert counters[("kernel_launches_total", "gru_scan_fwd")] == 10


def test_detached_or_disabled_ledger_books_nothing():
    assert ops.book_launch("ssm_tick", (1,)) is None
    ops.launch_done(None)
    led = KernelLedger(enabled=False)
    ops.attach_ledger(led)
    try:
        assert ops.book_launch("ssm_tick", (1,)) is None
    finally:
        ops.attach_ledger(None)
    assert led.launches() == {}


@pytest.mark.parametrize("cell", ["gru", "ssm"])
def test_cpu_fleet_run_books_no_launch(attached, cell):
    cfg = ModelConfig(hidden_size=8, n_features=6, output_size=4,
                      dropout=0.0, bidirectional=False, cell=cell)
    state = build_model(cfg, generator=torch.Generator().manual_seed(0)
                        ).state_dict()
    pool = SessionPool(cfg, state, capacity=8, window=4, device="cpu")
    gw = FleetGateway(pool, batcher_config=BatcherConfig(
        bucket_sizes=(8,), max_linger_s=0.0))
    out = run_fleet_load(gw, FleetLoadConfig(n_sessions=8, n_ticks=3))
    assert out["ticks_served"] == 24
    doc = attached.dump()
    assert doc["launches_total"] == 0 and doc["device_ms_sampled_total"] == 0


# ---------------------------------------------------------------------------
# device memory
# ---------------------------------------------------------------------------


def test_memory_monitor_attributes_each_storage_once():
    base = torch.zeros(10, 4)
    params = {"w": torch.ones(3, 5, dtype=torch.float64), "b": torch.ones(7)}
    mon = DeviceMemoryMonitor()
    # views of one tensor count once; a nest of tuples and dicts
    mon.register_owner("pool", lambda: (base, base[2:], (base[0],), {}))
    mon.register_owner("model", lambda: params)
    mon.register_owner("both", lambda: [base, params])
    mon.register_owner("broken", lambda: 1 / 0)
    doc = mon.sample()
    assert doc["by_owner"] == {"pool": 160.0, "model": 148.0,
                               "both": 308.0, "broken": 0.0}
    assert doc["owners_bytes"] == 308.0
    if not torch.cuda.is_available():  # no allocator figures without one
        assert doc["allocated_bytes"] is None
        assert doc["reserved_bytes"] is None
        assert doc["watermark_bytes"] == 308.0
    names = {g["name"] for g in mon.families()["gauges"]}
    assert {"device_live_bytes", "device_memory_watermark_bytes",
            "device_memory_leak_suspected"} <= names


def test_memory_monitor_cadence_and_leak_heuristic():
    grow = [torch.zeros(1)]
    mon = DeviceMemoryMonitor(interval_s=5.0, leak_window=3)
    mon.register_owner("grower", lambda: grow)
    assert mon.maybe_sample(now=0.0)
    assert not mon.maybe_sample(now=4.9)  # not due: one clock read
    for i, now in enumerate((5.0, 10.0)):
        grow.append(torch.zeros(4 * (i + 1)))
        assert mon.maybe_sample(now=now)
    assert mon.leak_suspected  # three strictly growing samples
    grow.append(torch.zeros(1))
    grow.pop(0)
    grow.pop(0)  # shrinks
    mon.sample()
    assert not mon.leak_suspected
    assert mon.doc()["samples"] == 4
    assert mon.watermark_bytes >= 4 * (1 + 4 + 8)
    mon.enabled = False
    assert not mon.maybe_sample(now=100.0)


def test_configure_device_obs_and_report():
    prof = default_profiler()
    try:
        configure_device_obs(ProfilingConfig(
            host_profiler=True, profile_interval_ms=5.0,
            memory_interval_s=1.5, memory_leak_window=4))
        assert ops._ledger is device_mod.default_ledger()
        assert prof.running and prof.interval_ms == 5.0
        mon = device_mod.default_memory_monitor()
        assert mon.interval_s == 1.5 and mon.leak_window == 4
        configure_device_obs(ProfilingConfig(enabled=False))
        assert ops._ledger is None and not prof.running
    finally:
        configure_device_obs(ProfilingConfig(enabled=False))
        device_mod.default_ledger().enabled = True
        device_mod.default_memory_monitor().enabled = True
        prof.stop()
    report = device_report()
    assert tuple(report) == REPORT_SCHEMA
    assert tuple(report["ledger"]) == LEDGER_SCHEMA


def test_perf_command_renders_a_saved_report(attached, tmp_path, capsys):
    for _ in range(3):
        ops.launch_done(ops.book_launch("ssm_tick", (64, 1, 108, 32, 4, 4)))
    mon = DeviceMemoryMonitor()
    mon.register_owner("session_pool", lambda: [torch.zeros(64, 32)])
    mon.sample()
    doc = device_report(ledger=attached, memory=mon)
    path = tmp_path / "device.json"
    path.write_text(json.dumps(doc))
    (tmp_path / "p.folded").write_text(
        "MainThread;a:f;b:g;c:h 7\nfmda-batch;x:y 2\n")
    assert port_main(["perf", "--input", str(path), "--profile",
                      str(tmp_path / "p.folded")]) == 0
    text = capsys.readouterr().out
    assert "kernel ledger" in text and "ssm_tick" in text
    assert "session_pool" in text and "hottest host stacks (9" in text
    (tmp_path / "ledger.json").write_text(json.dumps(doc["ledger"]))
    assert port_main(["perf", "--input", str(tmp_path / "ledger.json"),
                      "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["ledger"] == doc["ledger"]
    assert port_main(["perf"]) == 2
    assert np.isfinite(doc["mfu"])
