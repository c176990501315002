"""The port's fleet telemetry against fmda_tpu.obs's, on the CPU: the
time-series store, the SLO engine, the fleet aggregator and the flight
recorder.

The same sample sequence on the same fake clock goes into both packages;
the store's query and dump documents, the SLO alert documents and the
aggregator's fleet gauges are equal, and so are ``/query`` and
``/alerts`` served over HTTP.  The one documented difference: the
reference's ``recompile`` objective reads XLA recompiles, which the port
does not have (it compiles nothing per shape), so the port's alert
document has every objective but that one.  The recorder writes the
reference's file set; ``status --endpoint`` reads ``/alerts`` and exits
1 while one fires; an attached quality evaluator records into the
telemetry's store.
"""

import json
import os
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import fmda_tpu.chaos.inject as jax_chaos
import fmda_tpu.config as jax_config
import fmda_tpu.obs.aggregate as jax_aggregate
import fmda_tpu.obs.recorder as jax_recorder
import fmda_tpu.obs.slo as jax_slo
import fmda_tpu.obs.tsdb as jax_tsdb
from fmda_tpu.obs.events import EventLog as JaxEventLog
from fmda_tpu.obs.registry import LatencyHistogram as JaxHistogram
from fmda_tpu.runtime.metrics import RuntimeMetrics as JaxRuntimeMetrics

import fmda_tpu_torch.chaos.inject as port_chaos
import fmda_tpu_torch.config as port_config
import fmda_tpu_torch.obs.aggregate as port_aggregate
import fmda_tpu_torch.obs.recorder as port_recorder
import fmda_tpu_torch.obs.slo as port_slo
import fmda_tpu_torch.obs.tsdb as port_tsdb
from fmda_tpu_torch.__main__ import main as port_main
from fmda_tpu_torch.obs.events import EventLog
from fmda_tpu_torch.obs.registry import LatencyHistogram
from fmda_tpu_torch.runtime.metrics import RuntimeMetrics

#: objectives the port leaves out (no signal: nothing compiles per shape)
NO_SIGNAL = ("recompile",)

PKG = {
    "jax": SimpleNamespace(
        cfg=jax_config, tsdb=jax_tsdb, slo=jax_slo, agg=jax_aggregate,
        rec=jax_recorder, events=JaxEventLog, hist=JaxHistogram,
        metrics=JaxRuntimeMetrics, chaos=jax_chaos),
    "port": SimpleNamespace(
        cfg=port_config, tsdb=port_tsdb, slo=port_slo, agg=port_aggregate,
        rec=port_recorder, events=EventLog, hist=LatencyHistogram,
        metrics=RuntimeMetrics, chaos=port_chaos),
}


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class FakeMembership:
    def __init__(self):
        self.workers = {}

    def __len__(self):
        return len(self.workers)

    def live(self):
        return sorted(self.workers)


class FakeRouter:
    """The FleetRouter surface the aggregator reads."""

    def __init__(self, pkg):
        self.metrics = pkg.metrics()
        self.membership = FakeMembership()
        self.stats = {}

    def worker_stats(self):
        return self.stats


def _slo_cfg(pkg, **over):
    base = dict(
        interval_s=1.0, retention_s=600.0, scrape_interval_s=1.0,
        fast_window_s=8.0, slow_window_s=24.0, burn_threshold=2.0,
        latency_p99_ms=100.0, latency_budget=0.05, loss_budget=0.01,
        journal_depth=100, journal_budget=0.1,
        degraded_feed_budget_minutes=0.05)
    base.update(over)
    return pkg.cfg.SLOConfig(**base)


def _without_no_signal(doc):
    """An alert document (or alert map) without the objectives the port
    has no signal for."""
    doc = json.loads(json.dumps(doc))
    alerts = doc.get("alerts", doc)
    for name in NO_SIGNAL:
        alerts.pop(name, None)
    return doc


# -- the store ----------------------------------------------------------------


def _store_script(pkg):
    """Gauges, counters (a reset and a gap), and per-worker histograms
    into one store; every read document."""
    clock = FakeClock()
    store = pkg.tsdb.TimeSeriesStore(interval_s=1.0, capacity=16,
                                     clock=clock, max_series=12)
    rng = np.random.default_rng(0)
    total = 0.0
    for step in range(40):
        clock.t = step * 0.7
        store.record_gauge("depth", float(step % 5), process="w0")
        store.record_gauge("depth", float(step % 3), process="w1")
        total = 0.0 if step == 20 else total + float(rng.integers(1, 9))
        if step % 6 != 3:  # a gap every few bins
            store.record_counter("served_total", total, process="w0")
        for proc in ("w0", "w1"):
            h = pkg.hist("lat")
            for v in rng.exponential(0.02, size=8):
                h.observe(float(v))
            store.record_histogram("lat", h.snapshot(), process=proc)
        store.record_gauge(f"many_{step % 20}", 1.0)  # past max_series
    now = clock.t
    out = {
        "series": store.series(),
        "dump": store.dump(),
        "dropped": store.dropped_series,
    }
    for name in ("depth", "served_total", "lat", "absent"):
        for window in (None, 5.0, 60.0):
            out[f"query:{name}:{window}"] = store.query(
                name, window_s=window, now=now)
    out["rate"] = store.rate_timeline("served_total", window_s=20.0, now=now)
    out["total"] = store.window_total("served_total", window_s=9.0, now=now)
    hist = store.window_histogram("lat", window_s=6.0, now=now)
    out["hist"] = (hist.n, hist.percentile(50), hist.percentile(99))
    return json.loads(json.dumps(out))


def test_store_documents_equal_the_reference():
    assert _store_script(PKG["port"]) == _store_script(PKG["jax"])


# -- the SLO engine -----------------------------------------------------------


def _slo_script(pkg):
    """Latency, loss, journal, degraded-feed, leak and quality series
    through a breach and a recovery; every alert document."""
    clock = FakeClock()
    store = pkg.tsdb.TimeSeriesStore(interval_s=1.0, capacity=64,
                                     clock=clock)
    events = pkg.events()
    slo = pkg.slo.SLOEngine(_slo_cfg(pkg), store, events=events,
                            clock=clock)
    docs, ticks, losses, joined, exact = [], 0.0, 0.0, 0.0, 0.0
    hist = pkg.hist("total")
    for step in range(60):
        clock.t = float(step)
        breach = 15 <= step < 30
        ticks += 100
        losses += 10 if breach else 0
        store.record_counter(pkg.slo.SERIES_TICKS, ticks)
        store.record_counter(pkg.slo.SERIES_LOSS, losses)
        for _ in range(20):
            hist.observe(0.5 if breach else 0.01)
        store.record_histogram(pkg.slo.SERIES_E2E, hist.snapshot())
        store.record_gauge("warehouse_journal_pending",
                           5000 if breach else 0, process="w0")
        store.record_gauge("engine_degraded_streams", 1 if breach else 0)
        store.record_gauge("worker_memory_leak_suspected", 0,
                           process="w0")
        joined += 10
        exact += 2 if breach else 9
        store.record_counter("quality_joined_total", joined)
        store.record_counter("quality_exact_total", exact)
        store.record_gauge("quality_fbeta", 0.01 if breach else 0.5,
                           version="1", label="up1")
        store.record_gauge("quality_drift_score", 0.1)
        slo.evaluate()
        docs.append(_without_no_signal(slo.alerts()))
    kinds = [(e["kind"], e.get("objective")) for e in events.tail()]
    ok, detail = slo.health_check()
    return docs, slo.firing(), kinds, (ok, detail.split(" ", 1)[1])


def test_slo_alert_documents_equal_the_reference():
    port_docs, port_firing, port_kinds, port_health = _slo_script(
        PKG["port"])
    ref_docs, ref_firing, ref_kinds, ref_health = _slo_script(PKG["jax"])
    assert port_docs == ref_docs
    assert port_firing == ref_firing
    assert port_kinds == [k for k in ref_kinds if k[1] not in NO_SIGNAL]
    assert port_health == ref_health  # "N objectives within budget"
    fired = {name for doc in port_docs for name, a in doc["alerts"].items()
             if a["state"] == "firing"}
    assert {"latency_p99", "loss_ratio", "journal_depth"} <= fired
    assert port_docs[-1]["firing"] == []  # every alert cleared
    assert set(port_docs[0]["alerts"]) == (
        set(ref_docs[0]["alerts"]))
    assert "recompile" not in port_docs[0]["alerts"]


def test_no_data_means_no_alert():
    clock = FakeClock()
    slo = port_slo.SLOEngine(_slo_cfg(PKG["port"]), port_tsdb.TimeSeriesStore(
        interval_s=1.0, capacity=8, clock=clock), clock=clock)
    assert all(a["state"] == "ok" for a in slo.evaluate().values())
    assert slo.health_check()[0]


# -- the aggregator and the telemetry root ------------------------------------


def _fleet_script(pkg, tmp_path=None):
    """A router's counters and latencies, its workers' heartbeat stats
    and a scraped worker snapshot, folded on the collection cadence."""
    clock = FakeClock()
    cfg = _slo_cfg(pkg, postmortem_dir=(str(tmp_path) if tmp_path
                                        else None))
    telemetry = pkg.agg.FleetTelemetry(cfg, clock=clock,
                                       scrape_fn=lambda wid, url: False)
    router = FakeRouter(pkg)
    router.stats = {w: {"ticks_served": 0, "queue_depth": 2,
                        "active_sessions": 3, "inbox_records_lost": 0,
                        "shed_oldest": 0, "live_bytes": 1024,
                        "memory_watermark_bytes": 2048,
                        "memory_leak_suspected": 0, "device_mfu": 0.0}
                    for w in ("w0", "w1")}
    for w in ("w0", "w1"):
        router.membership.workers[w] = SimpleNamespace(metrics=None)
    h = pkg.hist("lat")
    gauges = []
    for step in range(30):
        clock.t = float(step)
        slow = 10 <= step < 20
        router.metrics.count("results_received", 50)
        if slow:
            router.metrics.count("results_missing", 5)
        for _ in range(10):
            router.metrics.observe("total", 0.4 if slow else 0.01)
        router.metrics.gauge("inflight_ticks", step % 7)
        for w in ("w0", "w1"):
            router.stats[w]["ticks_served"] += 25
        h.observe(0.002 * (step + 1))
        telemetry.aggregator.observe_snapshot("w0", {
            "counters": [{"name": "served_total", "labels": {},
                          "value": step * 10}],
            "gauges": [{"name": "depth", "labels": {}, "value": step % 4}],
            "histograms": [h.sample()]}, now=clock.t)
        telemetry.maybe_collect(router)
        gauges.append(telemetry.fleet_gauges())
    queries = {name: telemetry.query(name, window_s=w)
               for name in ("fleet_ticks_per_s", "fleet_e2e_p99_ms",
                            "fleet_e2e_seconds",
                            "worker_ticks_served_total", "depth", "lat")
               for w in (None, 10.0)}
    out = {"gauges": gauges, "queries": queries,
           "alerts": _without_no_signal(telemetry.alerts()),
           "health": _without_no_signal(telemetry.health())}
    telemetry.close()
    return json.loads(json.dumps(out, default=str))


def test_fleet_telemetry_documents_equal_the_reference():
    port = _fleet_script(PKG["port"])
    ref = _fleet_script(PKG["jax"])
    assert port["queries"] == ref["queries"]
    assert port["gauges"] == ref["gauges"]
    assert port["alerts"] == ref["alerts"]
    assert port["health"]["status"] == ref["health"]["status"]
    assert port["alerts"]["alerts"]["latency_p99"]["state"] in ("ok",
                                                               "firing")


def test_heartbeat_compile_keys_have_no_series_in_the_port():
    assert "compile_count" not in port_aggregate.WORKER_STAT_SERIES
    assert "recompiles_after_warmup" not in port_aggregate.WORKER_STAT_SERIES
    assert "compile_seconds" not in port_aggregate.WORKER_STAT_SERIES
    assert {k: v for k, v in jax_aggregate.WORKER_STAT_SERIES.items()
            if k not in ("recompiles_after_warmup", "compile_seconds")} \
        == port_aggregate.WORKER_STAT_SERIES


def test_maybe_collect_is_cadence_gated_like_the_reference():
    def script(pkg):
        clock, scraped = FakeClock(), []
        telemetry = pkg.agg.FleetTelemetry(
            _slo_cfg(pkg, interval_s=1.0, scrape_interval_s=3.0),
            clock=clock,
            scrape_fn=lambda wid, url: scraped.append((wid, url)))
        router = FakeRouter(pkg)
        router.membership.workers["w0"] = SimpleNamespace(
            metrics="http://127.0.0.1:1")
        seen = []
        for dt in (0.0, 0.0, 0.5, 0.6, 3.1, 0.2):
            clock.t += dt
            seen.append(telemetry.maybe_collect(router))
        telemetry.close()
        return seen, scraped

    assert script(PKG["port"]) == script(PKG["jax"])


def test_scrape_failure_is_counted_never_raised():
    clock = FakeClock()
    agg = port_aggregate.FleetAggregator(
        port_tsdb.TimeSeriesStore(interval_s=1.0, capacity=8, clock=clock),
        clock=clock)
    assert agg.scrape("w0", "127.0.0.1:1", timeout_s=0.05) is False
    assert agg.scrape_errors == 1


def _chaos_fault_script(pkg, root):
    """A kill window at ``router.pump`` through the package's default
    chaos runtime while a telemetry root with a recorder is built: its
    ``on_fault`` observer logs each window's first fire and freezes a
    postmortem bundle; ``close()`` detaches it."""
    telemetry = pkg.agg.FleetTelemetry(
        _slo_cfg(pkg, postmortem_dir=str(root)), clock=FakeClock(),
        scrape_fn=lambda wid, url: False)
    chaos = pkg.chaos.default_chaos()
    owned = chaos.on_fault == telemetry._on_chaos_fault
    chaos.configure(enabled=True, plan=pkg.chaos.FaultPlan(6, (
        pkg.chaos.FaultEvent(1, "kill", "router.pump", duration=2),
        pkg.chaos.FaultEvent(4, "kill", "router.pump"))))
    raised = []
    try:
        for step in range(6):
            chaos.advance(step)
            try:
                chaos.check("router.pump")
                raised.append(False)
            except ConnectionError:
                raised.append(True)
        counters = dict(chaos.counters)
    finally:
        chaos.configure(enabled=False, plan=pkg.chaos.FaultPlan(0))
        telemetry.close()
    events = [{k: v for k, v in e.items() if k != "ts"}
              for e in telemetry.events.tail() if e["kind"] == "chaos_fault"]
    bundles = sorted(os.listdir(root))
    return {"owned": owned, "raised": raised, "counters": counters,
            "events": events, "bundles": bundles,
            "files": sorted(os.listdir(root / bundles[0])),
            "detached": chaos.on_fault is None}


def test_chaos_fault_observer_logs_and_freezes_like_the_reference(tmp_path):
    port = _chaos_fault_script(PKG["port"], tmp_path / "port")
    ref = _chaos_fault_script(PKG["jax"], tmp_path / "ref")
    assert port == ref
    assert port["owned"] and port["detached"]
    assert port["raised"] == [False, True, True, False, True, False]
    assert [e["step"] for e in port["events"]] == [1, 4]


# -- /query and /alerts over HTTP ---------------------------------------------


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def _served_docs(pkg):
    clock = FakeClock()
    telemetry = pkg.agg.FleetTelemetry(_slo_cfg(pkg), clock=clock)
    router = FakeRouter(pkg)
    for step in range(6):
        clock.t = float(step)
        router.metrics.count("results_received", 7)
        router.metrics.observe("total", 0.02)
        telemetry.collect(router)
    server = telemetry.start_server(port=0)
    try:
        docs = {q: _get(f"{server.url}/query?{q}") for q in (
            "series=fleet_ticks_per_s&window=60",
            "series=fleet_e2e_p99_ms&window=60",
            "series=fleet_e2e_seconds")}
        docs["alerts"] = _without_no_signal(_get(f"{server.url}/alerts"))
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(server.url + "/query", timeout=10)
        docs["missing_series"] = e.value.code
        with urllib.request.urlopen(server.url + "/metrics",
                                    timeout=10) as r:
            text = r.read().decode()
        docs["exposition"] = ("fmda_fleet_ticks_per_s" in text,
                              "fmda_slo_alerts_active" in text)
    finally:
        server.stop()
        telemetry.close()
    return docs


def test_query_and_alerts_endpoints_serve_the_references_documents():
    port = _served_docs(PKG["port"])
    assert port == _served_docs(PKG["jax"])
    assert port["missing_series"] == 400
    assert port["exposition"] == (True, True)
    assert port["alerts"]["firing"] == []


def test_control_answers_404_without_a_control_plane():
    telemetry = port_aggregate.FleetTelemetry(_slo_cfg(PKG["port"]),
                                              clock=FakeClock())
    server = telemetry.start_server(port=0)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(server.url + "/control", timeout=10)
        assert e.value.code == 404
        telemetry.attach_controller(SimpleNamespace(
            status=lambda: {"enabled": True}))
    finally:
        server.stop()
    server = telemetry.start_server(port=0)
    try:
        assert _get(server.url + "/control") == {"enabled": True}
    finally:
        server.stop()
        telemetry.close()


def test_status_endpoint_reads_alerts_and_exits_1_while_one_fires(capsys):
    clock = FakeClock()
    telemetry = port_aggregate.FleetTelemetry(_slo_cfg(PKG["port"]),
                                              clock=clock)
    server = telemetry.start_server(port=0)
    try:
        endpoint = server.url.replace("http://", "")
        assert port_main(["status", "--endpoint", endpoint]) == 0
        assert "status: ok" in capsys.readouterr().out
        telemetry.slo._alerts["latency_p99"] = {
            "objective": "latency_p99", "state": "firing",
            "burn_fast": 9.0, "burn_slow": 9.0, "burn_threshold": 2.0,
            "budget": 0.05, "detail": "x", "since": 0.0}
        assert port_main(["status", "--endpoint", endpoint]) == 1
        out = capsys.readouterr().out
        assert "slo alerts (burn threshold 2.0x):" in out
        assert "FIRE latency_p99" in out
        assert telemetry.health()["status"] == "degraded"
    finally:
        server.stop()
        telemetry.close()


# -- the flight recorder ------------------------------------------------------


def _bundle(pkg, root):
    clock = FakeClock()
    store = pkg.tsdb.TimeSeriesStore(interval_s=1.0, capacity=8, clock=clock)
    store.record_gauge("g", 1.0, t=0.0)
    events = pkg.events()
    events.emit("unit.test", x=1)
    rec = pkg.rec.FlightRecorder(
        str(root), keep=2, min_interval_s=5.0, clock=clock, store=store,
        events=events,
        snapshot_fn=lambda: {"counters": [], "gauges": [],
                             "histograms": []},
        workers_fn=lambda: {"worker_stats": {"w0": {"ticks_served": 1}}},
        profile_fn=lambda: "a;b 1\n", device_fn=lambda: {"ledger": {}},
        quality_fn=lambda: {"enabled": False})
    first = rec.trigger("slo-latency_p99", {"alert": {"state": "firing"}})
    files = sorted(os.listdir(first))
    meta = json.load(open(os.path.join(first, "meta.json")))
    tsdb = json.load(open(os.path.join(first, "tsdb.json")))
    debounced = rec.trigger("slo-latency_p99")
    other = rec.trigger("chaos-delay")
    clock.t += 10.0
    third = rec.trigger("slo-latency_p99")
    return {
        "files": files,
        "bundles": len(rec.bundles()),
        "debounced": (debounced, rec.debounced_total),
        "triggered": rec.triggered_total,
        "written": [p is not None for p in (other, third)],
        "meta": sorted(meta), "reason": meta["reason"],
        "tsdb": tsdb,
    }


def test_recorder_bundle_has_the_references_file_set(tmp_path):
    port = _bundle(PKG["port"], tmp_path / "port")
    ref = _bundle(PKG["jax"], tmp_path / "ref")
    assert port == ref
    assert {"meta.json", "snapshot.json", "tsdb.json", "events.jsonl",
            "workers.json"} <= set(port["files"])


def test_telemetry_postmortem_bundle_on_alert_fire(tmp_path):
    """A firing alert dumps a bundle with the reference's file set through
    the telemetry root's own sources."""
    names = {}
    for name in ("port", "jax"):
        _fleet_script(PKG[name], tmp_path / name)
        bundles = sorted(os.listdir(tmp_path / name))
        assert bundles, name
        names[name] = sorted(os.listdir(tmp_path / name / bundles[0]))
    assert names["port"] == names["jax"]


def test_attached_quality_evaluator_records_into_the_store():
    from fmda_tpu_torch.config import FeatureConfig, QualityConfig
    from fmda_tpu_torch.config import WarehouseConfig
    from fmda_tpu_torch.data.synthetic import random_walk_rows
    from fmda_tpu_torch.obs.quality import QualityEvaluator
    from fmda_tpu_torch.stream import Warehouse

    clock = FakeClock()
    telemetry = port_aggregate.FleetTelemetry(_slo_cfg(PKG["port"]),
                                              clock=clock)
    wh = Warehouse(FeatureConfig(), WarehouseConfig(path=":memory:"))
    rows = random_walk_rows(FeatureConfig().table_columns(), 60, seed=1)
    wh.insert_rows(rows)
    ev = QualityEvaluator(QualityConfig(join_interval_s=1.0), warehouse=wh,
                          max_lead=15, clock=clock)
    telemetry.attach_quality(ev)
    assert ev.store is telemetry.store
    rng = np.random.default_rng(0)
    for row in rows[:20]:
        ev.capture("T0", row["Timestamp"],
                   rng.uniform(size=4).astype(np.float32))
    clock.t = 5.0
    ev.maybe_join()
    names = telemetry.store.series_names()
    assert "quality_joined_total" in names
    assert telemetry.query("quality_joined_total")["points"]
    assert telemetry.quality()["conservation"]["captured"] == 20
    wh.close()
    telemetry.close()
