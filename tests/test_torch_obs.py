"""fmda_tpu_torch's observability plane against ``fmda_tpu.obs`` on the
CPU: the registry (collectors, ``include``, ``set_process``, the null
instruments of a disabled registry) and the Prometheus text, byte for
byte, for the same samples; the event log; the scrape endpoint's routes
over ``127.0.0.1:0``; the ``Observability`` handle's health checks,
collectors and ``track_fleet``; the host profiler's folded stacks; the
config sections; and the ``status`` command and the ``serve-fleet`` flags
that wait for later items."""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fmda_tpu.config import ObservabilityConfig as JaxObservabilityConfig
from fmda_tpu.config import ProfilingConfig as JaxProfilingConfig
from fmda_tpu.config import TracingConfig as JaxTracingConfig
from fmda_tpu.obs import events as jax_events
from fmda_tpu.obs import observability as jax_observability
from fmda_tpu.obs import prometheus as jax_prometheus
from fmda_tpu.obs import pyprof as jax_pyprof
from fmda_tpu.obs import registry as jax_registry
from fmda_tpu.obs import trace as jax_trace

from fmda_tpu_torch.__main__ import main as port_main
from fmda_tpu_torch.config import (
    DEFAULT_TOPICS,
    FeatureConfig,
    ModelConfig,
    ObservabilityConfig,
    ProfilingConfig,
    TracingConfig,
    WarehouseConfig,
    config_from_dict,
)
from fmda_tpu_torch.models import build_model
from fmda_tpu_torch.obs import (
    EventLog,
    MetricsRegistry,
    MetricsServer,
    Observability,
    events,
    observability,
    prometheus,
    pyprof,
    registry,
    trace,
)
from fmda_tpu_torch.obs.device import default_memory_monitor
from fmda_tpu_torch.runtime import (
    BatcherConfig,
    FleetGateway,
    RuntimeMetrics,
    SessionPool,
)
from fmda_tpu_torch.stream import InProcessBus, StreamEngine, Warehouse

from test_stream import _session_messages

PKG = {"port": (registry, prometheus, events, pyprof, observability, trace),
       "ref": (jax_registry, jax_prometheus, jax_events, jax_pyprof,
               jax_observability, jax_trace)}


def _fill(reg_mod, *, process=None, broken=True):
    """The same instruments, collectors and included registry in one
    package's registry."""
    reg = reg_mod.MetricsRegistry()
    if process:
        reg.set_process(process)
    reg.counter("rows_total").inc(3)
    reg.counter("req_total", topic='a"b\\c\nd').inc(2.5)
    reg.gauge("depth", queue="q1").set(7)
    reg.gauge("ratio").set(float("nan"))
    reg.gauge("inf").set(float("inf"))
    h = reg.histogram("lat_seconds", stage="x")
    for v in (1e-7, 3e-4, 2e-3, 2e-3, 0.5):
        h.observe(v)
    reg.histogram("empty_seconds")
    reg.register_collector("c1", lambda: {
        "counters": [{"name": "coll_total", "labels": {}, "value": 1}],
        "gauges": [{"name": "coll_g", "labels": {"k": "v"}, "value": 0.25}]})
    reg.register_collector("c1", lambda: {  # replaces the first
        "counters": [{"name": "coll_total", "labels": {}, "value": 2}]})
    if broken:
        reg.register_collector("dead", lambda: 1 / 0)
    other = reg_mod.MetricsRegistry()
    other.counter("included_total").inc()
    reg.include(other)
    reg.include(other)  # once
    reg.include(reg)  # never itself
    return reg


@pytest.mark.parametrize("process", [None, "worker-0"])
def test_registry_snapshot_equals_the_reference(process):
    ours = _fill(registry, process=process).snapshot()
    ref = _fill(jax_registry, process=process).snapshot()
    assert json.dumps(ours, sort_keys=True, default=str) == json.dumps(
        ref, sort_keys=True, default=str)
    names = {s["name"] for s in ours["counters"]}
    assert {"rows_total", "coll_total", "included_total"} <= names
    assert [s["value"] for s in ours["counters"]
            if s["name"] == "coll_total"] == [2]
    if process:
        assert all(s["labels"]["process"] == process
                   for kind in ours for s in ours[kind])


def test_disabled_registry_hands_out_null_instruments():
    reg = MetricsRegistry(enabled=False)
    c, g, h = reg.counter("a"), reg.gauge("b"), reg.histogram("c")
    assert c is g is h
    c.inc()
    g.set(3)
    h.observe(1.0)
    assert h.percentile(50) == 0.0 and h.summary() == {}
    reg.register_collector("x", lambda: {"counters": [{"name": "z"}]})
    reg.include(MetricsRegistry())
    assert reg.snapshot() == {"counters": [], "gauges": [], "histograms": []}


def _traced_snapshot(mod):
    """A tracer's families with the e2e histogram and its exemplars, from
    the same calls in either package."""
    tr = mod.Tracer(enabled=True)
    ids = iter(f"{i:016x}" for i in range(1000))
    for i, dur in enumerate((1_000, 2_000_000, 40_000_000)):
        ref = mod.TraceRef(next(ids), next(ids), 10)
        tr.finish_root(ref, "tick", "ingest", 10 + dur)
        tr.add_span(ref.trace_id, ref.span_id, "queued", "gateway", 10, 20)
    return tr.families()


@pytest.mark.parametrize("exemplars", [False, True])
def test_prometheus_text_is_byte_equal(exemplars):
    for reg_mod, prom_mod, *_, trace_mod in PKG.values():
        snap = _fill(reg_mod, process="p", broken=False).snapshot()
        fams = _traced_snapshot(trace_mod)
        for kind in fams:
            snap[kind] = snap[kind] + fams[kind]
        text = prom_mod.render_prometheus(snap, exemplars=exemplars)
        if prom_mod is prometheus:
            ours = text
        else:
            ref = text
    assert ours == ref
    assert ('# {trace_id=' in ours) == exemplars
    assert "fmda_lat_seconds{process=\"p\",stage=\"x\",quantile=\"0.99\"}" \
        in ours
    assert prometheus.render_prometheus({}) == ""


def test_event_log_equals_the_reference(tmp_path):
    out = {}
    for name, (_, _, ev_mod, *_rest, trace_mod) in PKG.items():
        clock = iter(float(i) for i in range(100))
        path = tmp_path / f"{name}.jsonl"
        log = ev_mod.EventLog(capacity=3, path=str(path),
                              clock=lambda: next(clock))
        tr = trace_mod.Tracer(enabled=True)
        log.emit("fleet.attached", capacity=4)
        with tr.root("session_tick"):
            traced = log.emit("app.tick_error", error="x")
        log.emit("obs.server_started", url="http://h", trace_id="given")
        log.emit("a.b", n=1)
        with pytest.raises(TypeError):
            log.emit("bad", payload=object())
        log.close()
        tid = traced["trace_id"]
        out[name] = ([{k: v for k, v in e.items() if k != "trace_id"}
                      for e in log.tail()], log.emitted, len(log),
                     log.tail(1)[0]["kind"],
                     [e["kind"] for e in log.tail(trace_id=tid)],
                     len(path.read_text().splitlines()))
    assert out["port"] == out["ref"]
    assert out["port"][1] == 4 and out["port"][2] == 3
    with pytest.raises(ValueError):
        EventLog(capacity=0)


def test_host_profiler_folded_stacks_equal_the_reference():
    text = ("MainThread;mod:run;mod:step 12\nfmda-batch;x:y 3\n"
            "fmda-batch;x:y 2\n\n  \nbad\n")
    assert pyprof.HostProfiler.parse_folded(text) == \
        jax_pyprof.HostProfiler.parse_folded(text)
    assert pyprof.THREAD_STAGES == jax_pyprof.THREAD_STAGES
    prof = pyprof.HostProfiler(max_stacks=1)
    stop = threading.Event()
    worker = threading.Thread(target=stop.wait, name="fmda-batch-test")
    worker.start()
    try:
        assert prof.sample_once() >= 1
        prof.sample_once()
    finally:
        stop.set()
        worker.join()
    folded = prof.folded()
    counts = pyprof.HostProfiler.parse_folded(folded)
    assert sum(counts.values()) == sum(prof.stage_summary().values())
    assert prof.stage_summary().get("gateway", 0) >= 1
    if len(counts) > 1:
        assert pyprof.OTHER_BUCKET in counts
    fams = prof.families()
    assert fams["counters"][0]["value"] == 2
    prof.start()
    assert prof.running
    prof.stop()
    assert not prof.running


# ---------------------------------------------------------------------------
# the Observability handle
# ---------------------------------------------------------------------------


def _small_gateway(cell="gru", bus=None):
    cfg = ModelConfig(hidden_size=8, n_features=6, output_size=4,
                      dropout=0.0, bidirectional=False, cell=cell)
    state = build_model(cfg, generator=torch.Generator().manual_seed(0)
                        ).state_dict()
    pool = SessionPool(cfg, state, capacity=4, window=4, device="cpu")
    gw = FleetGateway(pool, bus, batcher_config=BatcherConfig(
        bucket_sizes=(4,), max_linger_s=0.0), queue_bound=2)
    for i in range(4):
        gw.open_session(f"T{i}")
    return gw


def test_collector_functions_equal_the_reference():
    metrics = RuntimeMetrics()
    metrics.count("flushes", 3)
    metrics.gauge("queue_depth", 2)
    metrics.observe("total", 0.004)
    with metrics.timer.stage("dispatch"):
        pass
    for prefix in ("runtime", "predictor"):
        ours = observability.runtime_families(metrics, prefix=prefix)
        ref = jax_observability.runtime_families(metrics, prefix=prefix)
        assert ours == ref
    fc = FeatureConfig(bid_levels=2, ask_levels=2, event_list=("Core CPI",),
                       get_cot=False)
    bus = InProcessBus(DEFAULT_TOPICS)
    wh = Warehouse(fc, WarehouseConfig(path=":memory:"))
    eng = StreamEngine(bus, wh, fc)
    for topic, msg in _session_messages(4):
        bus.publish(topic, msg)
    eng.step()
    assert observability.engine_families(eng) == \
        jax_observability.engine_families(eng)
    assert observability.stage_timer_families("e", eng.timer) == \
        jax_observability.stage_timer_families("e", eng.timer)

    class Journaled:
        def journal_stats(self):
            return {"pending": 4, "spilled_rows": 9, "backfilled_rows": 5}

    assert observability.journal_families(Journaled()) == \
        jax_observability.journal_families(Journaled())


def test_health_checks_and_app_tracking():
    clock = [0.0]
    obs = Observability(ObservabilityConfig(max_tick_age_s=10.0),
                        clock=lambda: clock[0])
    fc = FeatureConfig(bid_levels=2, ask_levels=2, event_list=("Core CPI",),
                       get_cot=False)
    app = type("App", (), {})()
    app.bus = InProcessBus(DEFAULT_TOPICS)
    app.warehouse = Warehouse(fc, WarehouseConfig(path=":memory:"))
    app.engine = StreamEngine(app.bus, app.warehouse, fc)
    obs.track_app(app)
    health = obs.health()
    assert health["status"] == "ok"
    assert set(health["checks"]) == {"bus", "warehouse", "feed_degraded",
                                     "last_tick"}
    obs.tick()
    clock[0] = 11.0
    assert obs.health()["status"] == "degraded"
    assert not obs.health()["checks"]["last_tick"]["ok"]
    obs.checks["raises"] = lambda: 1 / 0
    assert "check raised" in obs.health()["checks"]["raises"]["detail"]
    snap = obs.snapshot()
    names = {s["name"] for kind in snap for s in snap[kind]}
    assert {"engine_emitted_total", "warehouse_rows",
            "ingest_requests_total", "device_mfu",
            "device_memory_watermark_bytes"} <= names
    obs.close()


def test_track_fleet_reports_runtime_and_saturation():
    obs = Observability()
    gw = _small_gateway()
    obs.track_fleet(gw)
    assert obs.events.tail()[-1]["kind"] == "fleet.attached"
    assert obs.health()["checks"]["fleet_queue"]["ok"]
    rng = np.random.default_rng(0)
    for i in range(3):  # past the queue bound of 2: the next would shed
        gw.submit(f"T{i}", rng.normal(size=6))
    assert not obs.health()["checks"]["fleet_queue"]["ok"]
    gw.drain()
    snap = obs.snapshot()
    names = {s["name"] for kind in snap for s in snap[kind]}
    assert {"runtime_flushes_total", "runtime_latency_seconds",
            "runtime_shed_oldest_total"} <= names
    mon = default_memory_monitor()
    doc = mon.sample()
    assert doc["by_owner"]["session_pool"] > 0
    obs.close()
    disabled = Observability(ObservabilityConfig(enabled=False))
    disabled.track_fleet(gw)
    assert disabled.snapshot() == {"counters": [], "gauges": [],
                                   "histograms": []}
    assert "fleet_queue" not in disabled.checks


# ---------------------------------------------------------------------------
# the endpoint
# ---------------------------------------------------------------------------


def _get(url, accept=None):
    req = urllib.request.Request(url, headers={"Accept": accept} if accept
                                 else {})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_endpoint_routes():
    tracer = trace.Tracer(enabled=True)
    with tracer.root("session_tick"):
        tid = trace.current_trace_id()
    reg = _fill(registry, broken=False)
    log = EventLog()
    log.emit("x", trace_id=tid)
    log.emit("y")
    state = {"ok": True}
    server = MetricsServer(
        reg, host="127.0.0.1", port=0,
        health_fn=lambda: {"status": "ok" if state["ok"] else "degraded",
                           "checks": {}},
        events=log, tracer=tracer, profile_fn=lambda: "a;b 3\n",
        device_fn=lambda: {"ledger": {}}, quality_fn=lambda: {"q": 1})
    server.start()
    try:
        base = server.url
        assert base.startswith("http://127.0.0.1:")
        status, ctype, body = _get(base + "/metrics")
        assert status == 200 and "0.0.4" in ctype
        assert body.decode() == prometheus.render_prometheus(reg.snapshot())
        status, ctype, body = _get(base + "/metrics",
                                   accept="application/openmetrics-text")
        assert "openmetrics" in ctype and body.endswith(b"# EOF\n")
        assert _get(base + "/healthz")[0] == 200
        state["ok"] = False
        status, _, body = _get(base + "/healthz")
        assert status == 503 and json.loads(body)["status"] == "degraded"
        assert json.loads(_get(base + "/snapshot")[2]) == json.loads(
            json.dumps(reg.snapshot()))
        lines = _get(base + f"/events?trace_id={tid}")[2].decode()
        assert [json.loads(x)["kind"] for x in lines.splitlines()] == ["x"]
        doc = json.loads(_get(base + "/trace")[2])
        assert doc == json.loads(json.dumps(tracer.chrome()))
        assert _get(base + "/profile")[2] == b"a;b 3\n"
        assert json.loads(_get(base + "/device")[2]) == {"ledger": {}}
        assert json.loads(_get(base + "/quality")[2]) == {"q": 1}
        for path in ("/query?series=x", "/alerts", "/control", "/nope"):
            assert _get(base + path)[0] == 404
        reg.register_collector("boom", lambda: 1 / 0)
        assert _get(base + "/snapshot")[0] == 200  # a dead collector skips
        server.device_fn = lambda: 1 / 0
        status, ctype, body = _get(base + "/device")
        assert status == 500 and "ZeroDivisionError" in json.loads(
            body)["error"]
        assert server.start() is server
    finally:
        server.stop()
    server.stop()  # twice: a no-op


def test_status_command_over_a_live_endpoint(capsys):
    obs = Observability()
    gw = _small_gateway()
    obs.track_fleet(gw)
    rng = np.random.default_rng(1)
    for i in range(2):
        gw.submit(f"T{i}", rng.normal(size=6))
    gw.drain()
    server = obs.start_server(host="127.0.0.1", port=0)
    assert obs.start_server() is server
    try:
        endpoint = f"127.0.0.1:{server.port}"
        assert port_main(["status", "--endpoint", endpoint]) == 0
        text = capsys.readouterr().out
        assert "status: ok" in text and "fleet_queue" in text
        assert "runtime_flushes_total" in text and "perf: mfu" in text
        assert port_main(["perf", "--endpoint", endpoint]) == 0
        assert "kernel ledger" in capsys.readouterr().out
        assert port_main(["trace", "--endpoint", endpoint]) == 1  # none
        down = "127.0.0.1:1"
        assert port_main(["status", "--endpoint", endpoint, down]) == 1
        text = capsys.readouterr().out
        assert "unreachable" in text and "aggregate: degraded (1/2" in text
        assert port_main(["status", "--endpoint", down]) == 2
    finally:
        obs.close()
    assert obs.server is None


def test_status_prints_non_finite_gauges(capsys):
    from fmda_tpu_torch.obs.report import print_status

    snap = _fill(registry, broken=False).snapshot()
    print_status(snap, {"status": "ok", "checks": {}})
    text = capsys.readouterr().out
    assert "nan" in text and "inf" in text and "depth{queue=q1}" in text


def test_status_without_an_endpoint_names_its_item(capsys, tmp_path):
    """Without ``--endpoint``, ``status`` builds a local Application over
    the warehouse (ROADMAP queue 1, item 6 is done) and prints its
    snapshot and health, exit 0 while healthy."""
    assert port_main(["status", "--warehouse",
                      str(tmp_path / "w.sqlite")]) == 0
    text = capsys.readouterr().out
    assert text.startswith("status: ok")
    for series in ("engine_emitted_total", "warehouse_rows",
                   "bus_published_total{topic=deep}"):
        assert series in text


@pytest.mark.parametrize("flag", ["--trace-dir", "--postmortem-dir"])
def test_waiting_serve_fleet_flags_name_item_7(flag, tmp_path, capsys):
    # the flags themselves are ported; the local role they serve still
    # waits for the control plane it attaches by default (item 7c)
    assert port_main(["serve-fleet", "--role", "local", flag, str(tmp_path),
                      "--device", "cpu"]) == 2
    assert "item 7" in capsys.readouterr().err


def test_serve_fleet_serves_its_endpoint_during_the_load(capsys):
    assert port_main(["serve-fleet", "--role", "solo", "--metrics-port", "0",
                      "--sessions", "4", "--ticks", "3", "--device",
                      "cpu"]) == 0
    captured = capsys.readouterr()
    out = json.loads(captured.out)
    assert out["ticks_served"] == 12
    assert "metrics endpoint: http://127.0.0.1:" in captured.err


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def test_config_sections_equal_the_reference():
    assert dataclasses.asdict(ObservabilityConfig()) == dataclasses.asdict(
        JaxObservabilityConfig())
    assert dataclasses.asdict(TracingConfig()) == dataclasses.asdict(
        JaxTracingConfig())
    ref = dataclasses.asdict(JaxProfilingConfig())
    assert ref.pop("cost_analysis") is True  # accepted, not read
    assert dataclasses.asdict(ProfilingConfig()) == ref
    cfg = config_from_dict({
        "observability": {"port": 0, "events_capacity": 8},
        "tracing": {"enabled": True, "sample_rate": 0.01},
        "profiling": {"cost_analysis": False, "memory_interval_s": 1.0}})
    assert cfg.observability.port == 0 and cfg.observability.events_capacity == 8
    assert cfg.tracing == TracingConfig(enabled=True, sample_rate=0.01)
    assert cfg.profiling.memory_interval_s == 1.0
    with pytest.raises(ValueError, match="unknown keys"):
        config_from_dict({"tracing": {"rate": 1}})
