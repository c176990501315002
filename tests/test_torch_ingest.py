"""fmda_tpu_torch's acquisition layer against ``fmda_tpu.ingest`` on
``ReplayTransport`` fixtures (the reference tests' own pages and payloads):
the clients, the scrapers, the transports (replay, session replay, retry,
rate limit, circuit breaker, recording) with their counters, and a whole
``SessionDriver`` day into both packages' bus and engine, which land equal
warehouses."""

import datetime as dt
import json
import random

import numpy as np
import pytest

import fmda_tpu.ingest as jax_ingest
from fmda_tpu.config import FeatureConfig as JaxFeatureConfig
from fmda_tpu.config import SessionConfig as JaxSessionConfig
from fmda_tpu.config import WarehouseConfig as JaxWarehouseConfig
from fmda_tpu.ingest import scrapers as jax_scrapers
from fmda_tpu.ingest import transport as jax_transport
from fmda_tpu.obs.registry import MetricsRegistry as JaxRegistry
from fmda_tpu.stream import InProcessBus as JaxBus
from fmda_tpu.stream import StreamEngine as JaxEngine
from fmda_tpu.stream import Warehouse as JaxWarehouse

import fmda_tpu_torch.ingest as ingest
from fmda_tpu_torch.config import (
    DEFAULT_TOPICS,
    TOPIC_COT,
    TOPIC_DEEP,
    TOPIC_IND,
    TOPIC_VIX,
    TOPIC_VOLUME,
    FeatureConfig,
    SessionConfig,
    WarehouseConfig,
)
from fmda_tpu_torch.ingest import scrapers, transport
from fmda_tpu_torch.obs.registry import MetricsRegistry
from fmda_tpu_torch.stream import InProcessBus, StreamEngine, Warehouse

from test_ingest import (
    CALENDAR_HTML,
    COT_INDEX_HTML,
    COT_REPORT_HTML,
    NOW,
    VIX_HTML,
)

DEEP = {"SPY": {"bids": [{"price": 332.28, "size": 500},
                         {"price": 332.25, "size": 400}],
                "asks": [{"price": 332.33, "size": 300}]}}
SERIES = {
    "2020-02-07 09:25:00": {"1. open": "333.80", "2. high": "334.00",
                            "3. low": "333.60", "4. close": "333.95",
                            "5. volume": "1061578"},
    "2020-02-07 09:30:00": {"1. open": "334.02", "2. high": "334.11",
                            "3. low": "333.91", "4. close": "333.96",
                            "5. volume": "90211"},
}
CALENDAR = {"calendar": {"days": {"day": [
    {"date": "2020-02-07", "status": "open",
     "open": {"start": "09:30", "end": "16:00"},
     "premarket": {"start": "04:00", "end": "09:30"},
     "postmarket": {"start": "16:00", "end": "20:00"}},
    {"date": "2020-02-08", "status": "closed"}]}}}


def _fixtures():
    return {
        r"deep/book": json.dumps(DEEP),
        r"alphavantage": json.dumps({"Meta Data": {},
                                     "Time Series (5min)": SERIES}),
        r"markets/calendar": json.dumps(CALENDAR),
        r"economic-calendar": CALENDAR_HTML,
        r"cnbc": VIX_HTML,
        r"tradingster.com/cot$": COT_INDEX_HTML,
        r"/cot/tff/13874A": COT_REPORT_HTML,
    }


def _pair():
    """The same fixtures behind each package's ReplayTransport."""
    return (ingest.ReplayTransport(_fixtures()),
            jax_ingest.ReplayTransport(_fixtures()))


def test_exports_are_the_reference():
    assert set(jax_ingest.__all__) <= set(ingest.__all__)
    assert transport.INGEST_COUNTER_NAMES == jax_transport.INGEST_COUNTER_NAMES
    assert (transport.INGEST_HISTOGRAM_NAMES
            == jax_transport.INGEST_HISTOGRAM_NAMES)


def test_clients_equal_the_reference(caplog):
    ours, ref = _pair()
    for mod, t in ((ingest, ours), (jax_ingest, ref)):
        t.out = [
            mod.IEXClient("tok", t).get_deep_book("spy", NOW),
            mod.AlphaVantageClient("tok", t).get_latest_bar("SPY", NOW),
            mod.AlphaVantageClient("tok", t).get_latest_bar(
                "EURUSD", NOW, function="FX_INTRADAY", interval="15min"),
            mod.TradierCalendarClient("tok", t).get_market_calendar(),
        ]
        with caplog.at_level("WARNING"):  # a delayed bar is accepted
            t.out.append(mod.AlphaVantageClient("tok", t).get_latest_bar(
                "SPY", NOW + dt.timedelta(hours=2)))
    assert ours.out == ref.out
    assert ours.requests == ref.requests
    assert ours.out[0]["bids_1"] == {"bid_1": 332.25, "bid_1_size": 400}
    assert sum("DELAYED" in r.message for r in caplog.records) == 2
    for mod in (ingest, jax_ingest):
        bad = mod.ReplayTransport(
            {r"alphavantage": json.dumps({"Error Message": "bad key"})})
        with pytest.raises(ValueError, match="bad key"):
            mod.AlphaVantageClient("tok", bad).get_latest_bar("SPY", NOW)


def test_scrapers_equal_the_reference(tmp_path):
    ours, ref = _pair()
    out = {}
    for name, mod, smod, fc, t in (
            ("port", ingest, scrapers, FeatureConfig(), ours),
            ("ref", jax_ingest, jax_scrapers, JaxFeatureConfig(), ref)):
        registry = smod.SentItemsRegistry(str(tmp_path / f"{name}.json"))
        cal = mod.EconomicCalendarScraper(fc, transport=t, registry=registry)
        cot = mod.COTScraper("S&P 500 STOCK INDEX", t)
        out[name] = [
            cal.parse(CALENDAR_HTML, NOW), cal.scrape(NOW), cal.scrape(NOW),
            mod.VIXScraper(t).scrape(NOW), cot.scrape(NOW),
            mod.COTScraper("GOLD", t).scrape(NOW),
        ]
        out[name].append((tmp_path / f"{name}.json").read_text())
    assert out["port"] == out["ref"]
    assert {i["Event"] for i in out["port"][0]} == {
        "Nonfarm_Payrolls", "Unemployment_Rate"}
    assert out["port"][1]["Nonfarm_Payrolls"]["Actual"] == 225.0
    assert out["port"][2]["Nonfarm_Payrolls"]["Actual"] == 0  # deduped
    assert out["port"][4]["Asset"]["Asset_long_pos"] == 304136
    assert out["port"][5] is None


def test_html_dom_equals_the_reference():
    from fmda_tpu.ingest.htmldom import parse_html as jax_parse

    from fmda_tpu_torch.ingest.htmldom import parse_html

    for page in (CALENDAR_HTML, COT_REPORT_HTML, VIX_HTML, b"<p>x<br>y</p>"):
        ours, ref = parse_html(page), jax_parse(page)
        walk = [(e.tag, e.attrs, e.own_text) for e in ours.iter()]
        assert walk == [(e.tag, e.attrs, e.own_text) for e in ref.iter()]
        assert ours.text == ref.text


def test_session_replay_transport_masks_credentials():
    recorded = {
        "https://x/q?symbols=spy&token=REAL1": [b"a", b"b"],
        "https://x/av?apikey=REAL2&datatype=json": b"c",
    }
    for mod in (ingest, jax_ingest):
        t = mod.SessionReplayTransport(recorded)
        assert [t.get("https://x/q?symbols=spy&token=fake")
                for _ in range(3)] == [b"a", b"b", b"b"]
        assert t.get("https://x/av?apikey=other&datatype=json") == b"c"
        with pytest.raises(mod.TransportError if mod is ingest
                           else jax_transport.TransportError):
            t.get("https://x/missing?token=1")
        assert t.misses == ["https://x/missing?token=*"]


def _failing(mod, n, status=None, retry_after=None):
    """An inner transport failing ``n`` times, then answering."""
    error = (transport if mod is ingest else jax_transport).TransportError

    class Inner:
        calls = 0

        def get(self, url, headers=None):
            Inner.calls += 1
            if Inner.calls <= n:
                raise error("down", status=status, retry_after_s=retry_after)
            return b"ok"

    return Inner()


@pytest.mark.parametrize("status,retry_after,jitter", [
    (None, None, True), (None, None, False), (429, 2.5, True),
    (503, 100.0, False)])
def test_retry_schedule_and_counter_equal_the_reference(status, retry_after,
                                                        jitter):
    out = {}
    for mod, reg in ((ingest, MetricsRegistry()), (jax_ingest, JaxRegistry())):
        sleeps = []
        t = mod.RetryTransport(
            _failing(mod, 2, status, retry_after), attempts=3,
            backoff_s=1.5, sleep_fn=sleeps.append, jitter=jitter,
            rng=random.Random(7), metrics=reg)
        body = t.get("https://x/q")
        sleeps2 = []
        t2 = mod.RetryTransport(_failing(mod, 5), attempts=3, backoff_s=1.5,
                                sleep_fn=sleeps2.append, jitter=jitter,
                                rng=random.Random(7), metrics=reg)
        with pytest.raises(Exception, match="after 3 attempts"):
            t2.get("https://x/q")
        out[mod] = (body, sleeps, sleeps2,
                    reg.counter("ingest_retries_total").value)
    assert out[ingest] == out[jax_ingest]
    assert out[ingest][3] == 4


def test_rate_limit_and_circuit_breaker_equal_the_reference():
    out = {}
    for mod, reg in ((ingest, MetricsRegistry()), (jax_ingest, JaxRegistry())):
        clock = {"t": 0.0}

        def sleep(s, clock=clock):
            clock["t"] += s

        limited = mod.RateLimitTransport(
            mod.ReplayTransport({r".": b"x"}), min_interval_s=2.0,
            clock=lambda: clock["t"], sleep_fn=sleep, metrics=reg)
        times = []
        for url in ("https://a/1", "https://a/2", "https://b/1",
                    "https://a/3"):
            limited.get(url)
            times.append(clock["t"])
        inner = _failing(mod, 4)
        breaker = (transport if mod is ingest
                   else jax_transport).CircuitBreakerTransport(
            inner, failure_threshold=2, reset_timeout_s=10.0,
            clock=lambda: clock["t"], metrics=reg)
        states = []
        for step in range(8):
            try:
                breaker.get("https://feed/x")
                states.append(("ok", breaker.state("https://feed/x")))
            except Exception as e:  # noqa: BLE001 — recorded, compared
                states.append((type(e).__name__,
                               breaker.state("https://feed/x")))
            clock["t"] += 6.0
        out[mod] = (times, states, inner.calls, {
            name: reg.counter(name).value for name in (
                "ingest_ratelimit_waits_total",
                "ingest_ratelimit_wait_seconds_total",
                "ingest_circuit_open_total",
                "ingest_circuit_shortcircuit_total")})
    assert out[ingest] == out[jax_ingest]
    assert out[ingest][0] == [0.0, 2.0, 2.0, 4.0]
    assert ("CircuitOpenError", "open") in out[ingest][1]
    assert out[ingest][1][-1] == ("ok", "closed")


def test_counters_go_to_the_process_registry():
    from fmda_tpu_torch.obs.registry import default_registry

    before = default_registry().counter("ingest_retries_total").value
    t = ingest.RetryTransport(_failing(ingest, 1), sleep_fn=lambda s: None)
    assert t.get("https://x/q") == b"ok"
    assert default_registry().counter("ingest_retries_total").value == (
        before + 1)
    live = ingest.live_transport()
    assert isinstance(live, transport.CircuitBreakerTransport)
    assert isinstance(live.inner.inner.inner, transport.UrllibTransport)


def test_recording_files_equal_the_reference(tmp_path):
    binary = bytes(range(256)) * 2
    for mod, name in ((ingest, "port"), (jax_ingest, "ref")):
        inner = mod.ReplayTransport({r"binary": binary,
                                     r"quote": [b"t1", b"t2"]})
        with mod.RecordingTransport(inner, str(tmp_path / name),
                                    flush_every=2) as rec:
            rec.get("https://x/binary")
            rec.get("https://x/quote")
            rec.get("https://x/quote")
    assert (tmp_path / "port").read_bytes() == (tmp_path / "ref").read_bytes()
    fixtures = ingest.RecordingTransport.load_fixtures(str(tmp_path / "ref"))
    assert fixtures == jax_ingest.RecordingTransport.load_fixtures(
        str(tmp_path / "port"))
    replay = ingest.ReplayTransport(fixtures)
    assert replay.get("https://x/binary") == binary
    assert [replay.get("https://x/quote") for _ in range(3)] == [
        b"t1", b"t2", b"t2"]


def _day(pkg):
    """A whole session day through ``pkg``'s driver, bus and engine."""
    mod, fc_cls, sc_cls, wc_cls, bus_cls, wh_cls, eng_cls = pkg
    t = mod.ReplayTransport(_fixtures())
    fc = fc_cls()
    bus = bus_cls(DEFAULT_TOPICS)
    clock = {"now": dt.datetime(2020, 2, 7, 9, 30, 0)}

    def sleep(s):
        clock["now"] += dt.timedelta(seconds=s)

    driver = mod.SessionDriver(
        bus, sc_cls(freq_s=300),
        iex=mod.IEXClient("tok", t),
        alpha_vantage=mod.AlphaVantageClient("tok", t),
        calendar=mod.TradierCalendarClient("tok", t),
        indicator_scraper=mod.EconomicCalendarScraper(fc, transport=t),
        vix_scraper=mod.VIXScraper(t),
        cot_scraper=mod.COTScraper("S&P 500 STOCK INDEX", t),
        now_fn=lambda: clock["now"], sleep_fn=lambda s: sleep(300))
    ticks = driver.run_session()
    wh = wh_cls(fc, wc_cls(path=":memory:"))
    eng = eng_cls(bus, wh, fc)
    eng.step()
    published = {topic: [r.value for r in bus.read(topic, 0)]
                 for topic in (TOPIC_DEEP, TOPIC_VOLUME, TOPIC_VIX,
                               TOPIC_IND, TOPIC_COT)}
    return ticks, published, wh, eng.stats


def test_session_driver_day_lands_equal_warehouses():
    ticks, published, wh, stats = _day(
        (ingest, FeatureConfig, SessionConfig, WarehouseConfig,
         InProcessBus, Warehouse, StreamEngine))
    ref_ticks, ref_published, ref_wh, ref_stats = _day(
        (jax_ingest, JaxFeatureConfig, JaxSessionConfig, JaxWarehouseConfig,
         JaxBus, JaxWarehouse, JaxEngine))
    assert ticks == ref_ticks == 79  # 09:30 to 16:00 inclusive
    assert published == ref_published
    assert stats == ref_stats and stats["dropped"] == 0
    n = len(ref_wh)
    assert len(wh) == n == 79
    assert wh.timestamps() == ref_wh.timestamps()
    np.testing.assert_array_equal(wh.fetch(range(1, n + 1)),
                                  ref_wh.fetch(range(1, n + 1)))
    np.testing.assert_array_equal(wh.fetch_targets(range(1, n + 1)),
                                  ref_wh.fetch_targets(range(1, n + 1)))


def test_session_driver_gates_and_isolates_feeds(caplog):
    closed = ingest.ReplayTransport({r"markets/calendar": json.dumps(CALENDAR)})
    driver = ingest.SessionDriver(
        InProcessBus(DEFAULT_TOPICS), SessionConfig(),
        calendar=ingest.TradierCalendarClient("tok", closed),
        now_fn=lambda: dt.datetime(2020, 2, 8, 10, 0, 0))
    assert driver.run_session() == 0
    fixtures = _fixtures()
    del fixtures[r"cnbc"]  # the VIX feed fails
    t = ingest.ReplayTransport(fixtures)
    bus = InProcessBus(DEFAULT_TOPICS)
    driver = ingest.SessionDriver(
        bus, SessionConfig(), iex=ingest.IEXClient("tok", t),
        vix_scraper=ingest.VIXScraper(t),
        indicator_scraper=ingest.EconomicCalendarScraper(
            FeatureConfig(), transport=t),
        now_fn=lambda: NOW)
    with caplog.at_level("WARNING"):
        results = driver.run_tick()
    assert results == {"deep": True, "ind": True, "vix": False}
    assert bus.end_offset(TOPIC_DEEP) == 1 and bus.end_offset(TOPIC_VIX) == 0
    fx = ingest.SessionDriver(InProcessBus(DEFAULT_TOPICS),
                              SessionConfig(source="FX"),
                              now_fn=lambda: NOW)
    assert fx.market_hours_today()["market_end"].weekday() == 4
