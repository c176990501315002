"""fmda_tpu_torch's tracing against ``fmda_tpu.obs.trace`` on the CPU.

The tracer and its exports run the same calls through both packages under
the same clock, sampling draws and ids, and must record the same spans
and write the same documents.  The instrumented components (FleetGateway,
PredictorGateway, StreamEngine, MessageBus, Predictor, StreamingPredictor,
SessionDriver, the live transport) are run on the same seeded load in
both packages; trace ids are random there, so the traces are compared by
structure: each trace's spans as (name, stage, parent's name), and the
count of traces.  With tracing off they record nothing.  The CLI's
``trace --input`` prints the reference's text for the same file, and
``serve-fleet --trace-out`` writes a file it reads."""

import datetime as dt
import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fmda_tpu.ingest as jax_ingest
import fmda_tpu.obs.trace as jax_trace
from fmda_tpu.cli import main as jax_main
from fmda_tpu.config import DEFAULT_TOPICS as JAX_TOPICS
from fmda_tpu.config import FeatureConfig as JaxFeatureConfig
from fmda_tpu.config import ModelConfig as JaxModelConfig
from fmda_tpu.config import SessionConfig as JaxSessionConfig
from fmda_tpu.config import WarehouseConfig as JaxWarehouseConfig
from fmda_tpu.data.normalize import NormParams as JaxNormParams
from fmda_tpu.models import build_model as jax_build_model
from fmda_tpu.runtime import BatcherConfig as JaxBatcherConfig
from fmda_tpu.runtime import FleetGateway as JaxFleetGateway
from fmda_tpu.runtime import PredictorGateway as JaxPredictorGateway
from fmda_tpu.runtime import PredictorPool as JaxPredictorPool
from fmda_tpu.runtime import SessionPool as JaxSessionPool
from fmda_tpu.serve import Predictor as JaxPredictor
from fmda_tpu.serve.streaming import StreamingBiGRU as JaxStreamingBiGRU
from fmda_tpu.serve.streaming import StreamingPredictor as JaxStreamingPredictor
from fmda_tpu.stream import InProcessBus as JaxBus
from fmda_tpu.stream import StreamEngine as JaxEngine
from fmda_tpu.stream import Warehouse as JaxWarehouse

import fmda_tpu_torch.ingest as ingest
import fmda_tpu_torch.obs.trace as trace
from fmda_tpu_torch.__main__ import main as port_main
from fmda_tpu_torch.config import (
    DEFAULT_TOPICS,
    TOPIC_FLEET_PREDICTION,
    TOPIC_PREDICTION,
    FeatureConfig,
    ModelConfig,
    SessionConfig,
    WarehouseConfig,
)
from fmda_tpu_torch.data.normalize import NormParams
from fmda_tpu_torch.interop import params_from_flax
from fmda_tpu_torch.runtime import (
    BatcherConfig,
    FleetGateway,
    PredictorGateway,
    PredictorPool,
    SessionPool,
)
from fmda_tpu_torch.serve import Predictor, StreamingBiGRU, StreamingPredictor
from fmda_tpu_torch.stream import InProcessBus, StreamEngine, Warehouse

from test_stream import _session_messages
from test_torch_ingest import _fixtures

FEATS, HIDDEN, WINDOW = 8, 8, 6
PACKAGES = ("port", "ref")
TRACE = {"port": trace, "ref": jax_trace}


@pytest.fixture
def tracers():
    """Both packages' process tracers on at 100% for one test, seeded
    alike, and off and empty after it."""
    out = {}
    for name, mod in TRACE.items():
        tr = mod.configure_tracing(enabled=True, sample_rate=1.0,
                                   capacity=1 << 16)
        tr.clear()
        tr._rng = random.Random(7)
        out[name] = tr
    yield out
    for tr in out.values():
        tr.configure(enabled=False, sample_rate=1.0)
        tr.clear()


def structure(spans):
    """Each trace's spans as sorted (name, stage, parent's name) rows
    (``<remote>`` for a parent the ring does not hold), all traces
    sorted: ids and times left out."""
    by_id = {s.span_id: s for s in spans}
    traces = {}
    for s in spans:
        parent = (None if s.parent_id is None else
                  by_id[s.parent_id].name if s.parent_id in by_id
                  else "<remote>")
        traces.setdefault(s.trace_id, []).append((s.name, s.stage, parent))
    return sorted(sorted(rows) for rows in traces.values())


def _model(cell="gru", feats=FEATS, hidden=HIDDEN, bidirectional=False,
           seed=0):
    fields = dict(hidden_size=hidden, n_features=feats, output_size=4,
                  dropout=0.0, bidirectional=bidirectional, cell=cell)
    jax_cfg = JaxModelConfig(use_pallas=False, **fields)
    params = jax.device_get(jax_build_model(jax_cfg).init(
        {"params": jax.random.PRNGKey(seed)},
        jnp.zeros((1, WINDOW, feats)))["params"])
    return jax_cfg, params, ModelConfig(**fields), params_from_flax(params)


# ---------------------------------------------------------------------------
# the tracer and its exports
# ---------------------------------------------------------------------------


def _fake_clock(monkeypatch):
    """One ns counter for both trace modules, and their ids from one seed
    each, so the two record identical spans."""
    for mod in TRACE.values():
        ticks = iter(range(10_000, 10_000_000, 1_000))
        monkeypatch.setattr(mod, "now_ns", lambda ticks=ticks: next(ticks))
        monkeypatch.setattr(mod, "_ID_RNG", random.Random(11))


def _script(mod, tracer):
    """Every recording call of the tracer API."""
    for i in range(12):
        ref = tracer.maybe_trace()
        if ref is not None:
            span = tracer.add_span(ref.trace_id, ref.span_id, "queued",
                                   "gateway", ref.t0_ns, ref.t0_ns + 50 * i)
            tracer.add_span(ref.trace_id, span, "dispatch", "gateway",
                            ref.t0_ns + 50 * i, ref.t0_ns + 90 * i)
            tracer.finish_root(ref, "tick", "ingest", ref.t0_ns + 100 * i)
        with tracer.root("session_tick", "ingest"):
            with tracer.span("http_get", "ingest"):
                pass
            wire = mod.stamp_message({"Timestamp": str(i)}).get("trace")
            with tracer.span("bus_publish", "bus"):
                pass
        if wire is not None:
            tracer.add_span_wire(wire, "join", "engine", 5, 9)
        tracer.add_span_wire("junk", "join", "engine", 5, 9)  # ignored
    with tracer.span("orphan", "bus"):  # no active trace: nothing
        pass


@pytest.mark.parametrize("rate", [1.0, 0.5, 0.0])
def test_tracer_records_the_references_spans(monkeypatch, rate):
    _fake_clock(monkeypatch)
    out = {}
    for name, mod in TRACE.items():
        tr = mod.Tracer(enabled=True, sample_rate=rate, capacity=64)
        tr._rng = random.Random(3)
        # stamp_message reads the process tracer's switch
        monkeypatch.setattr(mod._DEFAULT, "enabled", True)
        _script(mod, tr)
        out[name] = tr
    port, ref = out["port"], out["ref"]
    assert [s.to_dict() for s in port.spans()] == [
        s.to_dict() for s in ref.spans()]
    assert (port.recorded, port.traces_started, port.traces_finished) == (
        ref.recorded, ref.traces_started, ref.traces_finished)
    assert port.families() == ref.families()
    assert port.e2e.summary() == ref.e2e.summary()
    assert port.chrome() == ref.chrome()
    assert len(port.spans()) <= 64  # the ring keeps the newest
    if rate == 0.0:
        assert port.spans() == [] and port.traces_started == 0


def test_tracer_configure_clear_and_defaults():
    for mod in TRACE.values():
        tr = mod.Tracer()
        assert not tr.enabled and tr.capacity == 16384
        tr.configure(enabled=True, capacity=4)
        for _ in range(6):
            with tr.root("r", "ingest"):
                pass
        assert len(tr.spans()) == 4 and tr.recorded == 6
        tr.clear()
        assert tr.spans() == [] and tr.recorded == 0
    assert trace.STAGE_LANES == jax_trace.STAGE_LANES
    assert trace.parse_wire("a:b") == ("a", "b")
    for bad in ("ab", ":b", "a:", None, 3):
        assert trace.parse_wire(bad) is None
    assert trace.TraceRef("t", "s", 0).wire == "t:s"


def _span_sets():
    """Spans of two processes' traces, in each package's Span class: a
    shared journey with a skewed clock, a cross-process child, an unknown
    stage, a childless root."""
    rows = [
        ("t1", "r1", None, "tick", "ingest", 1_000_000, 9_000_000),
        ("t1", "a", "r1", "queued", "gateway", 1_000_000, 2_000_000),
        ("t1", "b", "r1", "device", "engine", 3_000_000, 4_000_000),
        ("t1", "c", "b", "bus_publish", "bus", 3_500_000, 100_000),
        ("t2", "r2", None, "session_tick", "ingest", 5_000_000, 1_000_000),
        ("t2", "d", "r2", "custom", "mystery", 5_100_000, 2_000_000),
        ("t3", "r3", None, "predict", "serve", 7_000_000, 0),
    ]
    other = [
        ("t1", "e", "r1", "serve", "serve", 51_000_000, 3_000_000),
        ("t4", "r4", None, "tick", "ingest", 60_000_000, 500_000),
    ]
    return {name: ([mod.Span(*r) for r in rows],
                   [mod.Span(*r) for r in other])
            for name, mod in TRACE.items()}


@pytest.mark.parametrize("export", [
    "chrome_trace", "group_chrome_traces", "merge_chrome_traces",
    "format_trace", "merge_unshared"])
def test_exports_equal_the_reference(export):
    out = {}
    for name, (spans, other) in _span_sets().items():
        mod = TRACE[name]
        doc, doc2 = mod.chrome_trace(spans), mod.chrome_trace(other)
        if export == "chrome_trace":
            out[name] = doc
        elif export == "group_chrome_traces":
            out[name] = mod.group_chrome_traces(doc)
        elif export == "merge_chrome_traces":
            merged = mod.merge_chrome_traces([doc, doc2])
            out[name] = (merged, mod.group_chrome_traces(merged))
        elif export == "merge_unshared":
            lone = mod.chrome_trace([other[1]])
            out[name] = mod.merge_chrome_traces([doc, lone])
        else:
            out[name] = "\n".join(
                mod.format_trace(t) for t in mod.group_chrome_traces(doc))
    assert out["port"] == out["ref"]
    assert out["port"]


def test_stamps_and_families_with_the_process_tracer(tracers):
    for name, mod in TRACE.items():
        tr = tracers[name]
        assert mod.stamp_message({"a": 1}) == {"a": 1}  # no active trace
        values = [{"a": 1}, {"a": 2, "trace": "x:y"}]
        assert mod.stamp_messages(values) is values
        with tr.root("r", "ingest"):
            stamped = mod.stamp_message({"a": 1})
            batch = mod.stamp_messages(values)
            assert mod.current_trace_id() == stamped["trace"].split(":")[0]
        assert batch[1]["trace"] == "x:y"
        assert batch[0]["trace"] == stamped["trace"]
        fams = mod.tracer_families()
        assert {c["name"] for c in fams["counters"]} >= {
            "trace_spans_total", "traces_started_total"}
    tracers["port"].configure(enabled=False)
    assert trace.stamp_message({"a": 1}) == {"a": 1}
    assert trace.tracer_families()["counters"] == []


def test_disabled_tracer_hands_out_shared_singletons():
    tr = trace.Tracer(enabled=False)
    assert tr.maybe_trace() is None
    assert tr.root("a") is tr.root("b") is tr.span("c", "bus")
    with tr.root("a"):
        pass
    assert tr.spans() == [] and tr.traces_started == 0


# ---------------------------------------------------------------------------
# the instrumented components, port against reference
# ---------------------------------------------------------------------------


def _fleet_pair(cell, bus_pair):
    jax_cfg, params, cfg, state = _model(cell)
    rng = np.random.default_rng(1)
    norms = []
    for _ in range(6):
        mn = rng.normal(size=FEATS).astype(np.float32)
        norms.append((mn, mn + 2.0))
    jax_gw = JaxFleetGateway(
        JaxSessionPool(jax_cfg, params, capacity=6, window=WINDOW),
        bus_pair[1], batcher_config=JaxBatcherConfig(
            bucket_sizes=(2, 4, 8), max_linger_s=0.0))
    gw = FleetGateway(
        SessionPool(cfg, state, capacity=6, window=WINDOW, device="cpu"),
        bus_pair[0], batcher_config=BatcherConfig(
            bucket_sizes=(2, 4, 8), max_linger_s=0.0))
    for i in range(6):
        jax_gw.open_session(f"T{i}", JaxNormParams(*norms[i]))
        gw.open_session(f"T{i}", NormParams(*norms[i]))
    return gw, jax_gw


def _fleet_load(gw, rounds=5, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for r in range(rounds):
        for i in range(6):
            if (i + r) % 3:
                # one tick in a few arrives with a sender's context
                wire = f"sender{r}:{i}" if (r, i) == (2, 2) else None
                gw.submit(f"T{i}", rng.normal(size=FEATS).astype(np.float32),
                          wire=wire)
        out += gw.pump()
    return out + gw.drain()


@pytest.mark.parametrize("cell,rate", [("gru", 1.0), ("ssm", 1.0),
                                       ("gru", 0.5)])
def test_fleet_gateway_records_the_references_spans(tracers, cell, rate):
    for tr in tracers.values():
        tr.configure(sample_rate=rate)
    buses = (InProcessBus(DEFAULT_TOPICS), JaxBus(JAX_TOPICS))
    gw, jax_gw = _fleet_pair(cell, buses)
    got, want = _fleet_load(gw), _fleet_load(jax_gw)
    assert len(got) == len(want)
    ours, ref = tracers["port"], tracers["ref"]
    assert structure(ours.spans()) == structure(ref.spans())
    assert ours.traces_finished == ref.traces_finished > 0
    assert ours.e2e.n == ref.e2e.n
    # the traced ticks are the same (session, seq)s, and each result
    # message carries its tick's own trace
    for bus, tr in zip(buses, (ours, ref)):
        msgs = [r.value for r in bus.read(TOPIC_FLEET_PREDICTION, 0)]
        traced = {m["trace"].split(":")[0] for m in msgs if "trace" in m}
        assert traced == {s.trace_id for s in tr.spans()} | {"sender2"}
    key = [((m["session"], m["seq"]), "trace" in m) for m in
           (r.value for r in buses[0].read(TOPIC_FLEET_PREDICTION, 0))]
    ref_key = [((m["session"], m["seq"]), "trace" in m) for m in
               (r.value for r in buses[1].read(TOPIC_FLEET_PREDICTION, 0))]
    assert sorted(key) == sorted(ref_key)
    # a sampled root's four children tile it
    for spans in ours.traces().values():
        root = next((s for s in spans if s.parent_id is None), None)
        if root is None:
            continue
        kids = [s for s in spans if s.parent_id == root.span_id]
        assert [s.name for s in kids] == ["queued", "dispatch", "device",
                                          "publish"]
        assert abs(sum(s.dur_ns for s in kids) - root.dur_ns) <= 10


#: the reference engine tests' narrow schema
SMALL = dict(bid_levels=2, ask_levels=2, event_list=("Core CPI",),
             volume_ma_periods=(3,), price_ma_periods=(3,),
             delta_ma_periods=(2,), bollinger_period=3, stoch_preceding=2,
             atr_preceding=2, target_lead1=2, target_lead2=3, get_cot=False)


def _engine_stack(pkg):
    if pkg == "port":
        fc = FeatureConfig(**SMALL)
        bus = InProcessBus(DEFAULT_TOPICS)
        wh = Warehouse(fc, WarehouseConfig(path=":memory:"))
        return fc, bus, wh, StreamEngine(bus, wh, fc)
    fc = JaxFeatureConfig(**SMALL)
    bus = JaxBus(JAX_TOPICS)
    wh = JaxWarehouse(fc, JaxWarehouseConfig(path=":memory:"))
    return fc, bus, wh, JaxEngine(bus, wh, fc)


def _predictor_gateway(pkg, wh, bus):
    jax_cfg, params, cfg, state = _model("gru", feats=len(wh.x_fields),
                                         hidden=4)
    norm = (np.zeros(len(wh.x_fields), np.float32),
            np.ones(len(wh.x_fields), np.float32))
    kw = dict(from_end=False, max_staleness_s=None)
    if pkg == "port":
        pool = PredictorPool(cfg, state, NormParams(*norm), window=3,
                             device="cpu")
        return PredictorGateway(pool, bus, wh, batcher_config=BatcherConfig(
            bucket_sizes=(8,), max_linger_s=0.0), **kw)
    pool = JaxPredictorPool(jax_cfg, params, JaxNormParams(*norm), window=3)
    return JaxPredictorGateway(pool, bus, wh, batcher_config=JaxBatcherConfig(
        bucket_sizes=(8,), max_linger_s=0.0), **kw)


@pytest.mark.parametrize("signals", ["from_engine", "bare"])
def test_engine_and_predictor_gateway_record_the_references_spans(
        tracers, signals):
    out = {}
    for pkg in PACKAGES:
        fc, bus, wh, eng = _engine_stack(pkg)
        tr = tracers[pkg]
        gw = _predictor_gateway(pkg, wh, bus)
        for topic, msg in _session_messages(5):
            if signals == "from_engine":
                # each feed message inside its own root: the book tick's
                # context rides the join onto its signal
                with tr.root("session_tick", "ingest"):
                    bus.publish(topic, msg)
            else:
                bus.publish(topic, msg)
        assert eng.step() == 5
        preds = gw.poll()
        out[pkg] = (structure(tr.spans()), len(preds),
                    [r.value.get("trace") is not None
                     for r in bus.read(TOPIC_PREDICTION, 0)],
                    tr.traces_finished)
    assert out["port"] == out["ref"]
    rows = [r for t in out["port"][0] for r in t]
    names = {r[0] for r in rows}
    if signals == "from_engine":
        assert {"join", "land", "signal", "serve", "gather"} <= names
    else:
        assert "predict" in names and "join" not in names


def _live_day(pkg, tr):
    """A narrow live day: feeds through the bus and engine, each bar's
    messages inside a session_tick root, served by the Predictor and a
    StreamingPredictor."""
    fc, bus, wh, eng = _engine_stack(pkg)
    msgs = _session_messages(12)
    per_bar = len(msgs) // 12
    jax_cfg, params, cfg, state = _model("gru", feats=len(wh.x_fields),
                                         hidden=4, bidirectional=True)
    sj_cfg, s_params, s_cfg, s_state = _model("gru", feats=len(wh.x_fields),
                                              hidden=4, seed=1)
    norm = (np.zeros(len(wh.x_fields), np.float32),
            np.ones(len(wh.x_fields), np.float32))
    kw = dict(window=3, from_end=False, max_staleness_s=None)
    if pkg == "port":
        pred = Predictor(bus, wh, cfg, state, NormParams(*norm),
                         device="cpu", **kw)
        stream = StreamingPredictor(bus, wh, StreamingBiGRU(
            s_cfg, s_state, NormParams(*norm), window=3, device="cpu"),
            from_end=False)
    else:
        pred = JaxPredictor(bus, wh, jax_cfg, params, JaxNormParams(*norm),
                            **kw)
        stream = JaxStreamingPredictor(bus, wh, JaxStreamingBiGRU(
            sj_cfg, s_params, JaxNormParams(*norm), window=3),
            from_end=False)
    served = 0
    for b in range(12):
        with tr.root("session_tick", "ingest"):
            for topic, msg in msgs[b * per_bar:(b + 1) * per_bar]:
                bus.publish(topic, msg)
        eng.step()
        served += len(pred.poll()) + len(stream.poll())
    return served


def test_live_day_records_the_references_spans(tracers):
    out = {pkg: (_live_day(pkg, tracers[pkg]),
                 structure(tracers[pkg].spans())) for pkg in PACKAGES}
    assert out["port"] == out["ref"]
    served, traces = out["port"]
    assert served > 0
    full = [[r[0] for r in t] for t in traces
            if ("serve", "serve", "session_tick") in t]
    assert full
    for names in full:
        assert {"session_tick", "bus_publish", "join", "land",
                "signal"} <= set(names)
    # past the window's first rows both the Predictor and the stream serve
    assert sum(names.count("serve") == 2 for names in full) >= 6


def _driver_day(pkg, tr, n_ticks=4):
    if pkg == "port":
        mod, fc, sc, bus = ingest, FeatureConfig(), SessionConfig, \
            InProcessBus(DEFAULT_TOPICS)
    else:
        mod, fc, sc, bus = jax_ingest, JaxFeatureConfig(), \
            JaxSessionConfig, JaxBus(JAX_TOPICS)
    t = mod.ReplayTransport(_fixtures())
    clock = {"now": dt.datetime(2020, 2, 7, 9, 30, 0)}
    driver = mod.SessionDriver(
        bus, sc(freq_s=300), iex=mod.IEXClient("tok", t),
        alpha_vantage=mod.AlphaVantageClient("tok", t),
        calendar=mod.TradierCalendarClient("tok", t),
        vix_scraper=mod.VIXScraper(t),
        now_fn=lambda: clock["now"])
    results = []
    for _ in range(n_ticks):
        results.append(driver.run_tick())
        clock["now"] += dt.timedelta(minutes=5)
    stamped = [r.value.get("trace") is not None
               for topic in bus.topics() for r in bus.read(topic, 0)]
    return results, stamped, structure(tr.spans())


def test_session_driver_records_the_references_spans(tracers):
    port, ref = (_driver_day(pkg, tracers[pkg]) for pkg in PACKAGES)
    assert port == ref
    results, stamped, traces = port
    assert len(traces) == 4 and all(stamped) and stamped
    assert all(("session_tick", "ingest", None) in t for t in traces)


def test_live_transport_get_is_an_http_get_span(tracers, monkeypatch):
    import urllib.request

    class Response:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def read(self):
            return b"body"

    monkeypatch.setattr(urllib.request, "urlopen",
                        lambda request, timeout: Response())
    out = {}
    for pkg, mod in (("port", ingest), ("ref", jax_ingest)):
        tr = tracers[pkg]
        t = mod.UrllibTransport()
        assert t.get("http://feed/x") == b"body"  # outside a trace: none
        with tr.root("session_tick", "ingest"):
            assert t.get("http://feed/x") == b"body"
        out[pkg] = structure(tr.spans())
    assert out["port"] == out["ref"] == [[
        ("http_get", "ingest", "session_tick"),
        ("session_tick", "ingest", None)]]


def test_tracing_off_records_nothing():
    for mod in TRACE.values():
        mod.configure_tracing(enabled=False)
        mod.default_tracer().clear()
    tr = trace.default_tracer()
    bus = InProcessBus(DEFAULT_TOPICS)
    gw, _ = _fleet_pair("gru", (bus, JaxBus(JAX_TOPICS)))
    _fleet_load(gw)
    fc, ebus, wh, eng = _engine_stack("port")
    for topic, msg in _session_messages(5):
        ebus.publish(topic, msg)
    eng.step()
    _predictor_gateway("port", wh, ebus).poll()
    with tr.root("session_tick", "ingest"):
        ebus.publish("vix", {"VIX": 1.0})
    _driver_day("port", tr, n_ticks=2)
    assert tr.spans() == [] and tr.recorded == 0
    assert tr.traces_started == 0
    # only the context a tick arrived with is forwarded
    assert [r.value["trace"] for r in bus.read(TOPIC_FLEET_PREDICTION, 0)
            if "trace" in r.value] == ["sender2:2"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_trace_cli_prints_the_references_text(tmp_path, capsys):
    spans, other = _span_sets()["port"]
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace.chrome_trace(spans)))
    (tmp_path / "o.json").write_text(json.dumps(trace.chrome_trace(other)))
    for argv in (["--input", str(path)],
                 ["--input", str(path), "--slowest", "1"],
                 ["--input", str(path), "--min-ms", "5", "--json"],
                 ["--merge", str(tmp_path)]):
        assert port_main(["trace", *argv]) == 0
        ours = capsys.readouterr().out
        assert jax_main(["trace", *argv]) == 0
        assert ours == capsys.readouterr().out
        assert ours
    merged = tmp_path / "m.json"
    assert port_main(["trace", "--merge", str(path), str(tmp_path / "o.json"),
                      "--out", str(merged)]) == 0
    assert len(trace.group_chrome_traces(json.loads(merged.read_text()))) == 4
    assert port_main(["trace"]) == 2
    assert port_main(["trace", "--input", str(tmp_path / "none.json")]) == 2


def test_serve_fleet_trace_out_reads_back(tmp_path, capsys):
    out = tmp_path / "fleet.json"
    try:
        assert port_main(["serve-fleet", "--role", "solo", "--trace",
                          "--trace-out", str(out), "--sessions", "8",
                          "--ticks", "4", "--device", "cpu"]) == 0
    finally:
        trace.configure_tracing(enabled=False)
        trace.default_tracer().clear()
    result = json.loads(capsys.readouterr().out)
    assert result["tracing"]["traces_finished"] == result["ticks_served"]
    assert result["tracing"]["file"] == str(out)
    assert port_main(["trace", "--input", str(out), "--last", "3"]) == 0
    text = capsys.readouterr().out
    assert text.count("root=tick") == 3
    for stage in ("queued", "dispatch", "device", "publish"):
        assert stage in text
