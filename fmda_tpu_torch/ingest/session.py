"""Ingestion session driver: market gating and the cadence loop -> bus,
as ``fmda_tpu.ingest.session`` defines it.

Every ``freq_s`` seconds while the market is open, pull the order book and
the OHLCV bar, run the three scrapers, and publish everything onto the feed
topics.  Clock and sleep are injectable, so a whole trading day replays in
milliseconds; one feed failing logs a warning and the tick goes on.

While the process tracer is enabled, a sampled tick runs inside a
``session_tick`` root span (stage ``ingest``): every transport GET becomes
a child span, and every feed message published in the tick carries the
tick's trace context in-band, so the engine, the warehouse land and
serving stitch their stages into the same trace.

Chaos: each feed's fetch is the injection point ``feed:<topic>``
(:mod:`fmda_tpu_torch.chaos`); an injected outage is a failed fetch,
counted like any dead endpoint.  Disabled, it costs one branch.
"""

from __future__ import annotations

import datetime as _dt
import logging
import time as _time
from typing import Callable, Dict, Optional

from fmda_tpu_torch.chaos.inject import default_chaos
from fmda_tpu_torch.config import (
    SessionConfig,
    TOPIC_COT,
    TOPIC_DEEP,
    TOPIC_IND,
    TOPIC_VIX,
    TOPIC_VOLUME,
)
from fmda_tpu_torch.ingest.clients import AlphaVantageClient, IEXClient, TradierCalendarClient
from fmda_tpu_torch.ingest.scrapers import COTScraper, EconomicCalendarScraper, VIXScraper
from fmda_tpu_torch.obs.trace import default_tracer
from fmda_tpu_torch.stream.bus import MessageBus
from fmda_tpu_torch.utils.timeutils import forex_market_hours, get_timezone, stock_market_hours

log = logging.getLogger("fmda_tpu_torch.ingest")

#: chaos injection singleton, captured once at import
_CHAOS = default_chaos()


class SessionDriver:
    """One trading day's acquisition session."""

    def __init__(
        self,
        bus: MessageBus,
        config: SessionConfig,
        *,
        iex: Optional[IEXClient] = None,
        alpha_vantage: Optional[AlphaVantageClient] = None,
        calendar: Optional[TradierCalendarClient] = None,
        indicator_scraper: Optional[EconomicCalendarScraper] = None,
        vix_scraper: Optional[VIXScraper] = None,
        cot_scraper: Optional[COTScraper] = None,
        now_fn: Optional[Callable[[], _dt.datetime]] = None,
        sleep_fn: Callable[[float], None] = _time.sleep,
    ) -> None:
        self.bus = bus
        self.config = config
        self.iex = iex
        self.alpha_vantage = alpha_vantage
        self.calendar = calendar
        self.indicator_scraper = indicator_scraper
        self.vix_scraper = vix_scraper
        self.cot_scraper = cot_scraper
        tz = get_timezone(config.timezone)
        self.now_fn = now_fn or (lambda: _dt.datetime.now(tz).replace(tzinfo=None))
        self.sleep_fn = sleep_fn
        self.ticks = 0
        #: the process-default tracer, captured once
        self._tracer = default_tracer()

    # -- market gating -------------------------------------------------------

    def market_hours_today(self) -> Optional[Dict[str, _dt.datetime]]:
        """Today's market window, or None if closed."""
        now = self.now_fn()
        if self.config.source == "IEX":
            if self.calendar is None:
                raise ValueError("stock sessions need a calendar client")
            days = self.calendar.get_market_calendar()
            today = now.date().strftime("%Y-%m-%d")
            match = [d for d in days if d.get("date") == today]
            if not match or match[0].get("status") != "open":
                log.warning("market closed today (%s)", today)
                return None
            return stock_market_hours(now, match[0])
        return forex_market_hours(now)

    # -- one tick ------------------------------------------------------------

    def run_tick(self) -> Dict[str, bool]:
        """Fetch + publish every enabled feed once; returns per-feed
        success.  A sampled tick runs inside a ``session_tick`` root
        span."""
        with self._tracer.root("session_tick", "ingest"):
            return self._run_tick()

    def _run_tick(self) -> Dict[str, bool]:
        now = self.now_fn()
        results: Dict[str, bool] = {}

        def attempt(name: str, fn: Callable[[], Optional[Dict]], topic: str) -> None:
            try:
                if _CHAOS.enabled:
                    # an injected feed outage is a failed fetch: the
                    # except below counts it like any dead endpoint
                    _CHAOS.check("feed:" + topic)
                message = fn()
                if message is not None:
                    self.bus.publish(topic, message)
                    results[name] = True
                else:
                    results[name] = False
            except Exception as e:  # noqa: BLE001 — feed isolation
                log.warning("%s feed failed this tick: %s", name, e)
                results[name] = False

        if self.iex is not None:
            attempt(
                "deep",
                lambda: self.iex.get_deep_book(self.config.symbol, now),
                TOPIC_DEEP,
            )
        if self.alpha_vantage is not None:
            interval = f"{self.config.freq_s // 60:d}min"
            if interval in ("1min", "5min", "15min", "30min", "60min"):
                attempt(
                    "volume",
                    lambda: self.alpha_vantage.get_latest_bar(
                        self.config.symbol.upper(), now, interval=interval
                    ),
                    TOPIC_VOLUME,
                )
            else:
                log.warning("%r interval is not supported", interval)
        if self.indicator_scraper is not None:
            attempt("ind", lambda: self.indicator_scraper.scrape(now), TOPIC_IND)
        if self.cot_scraper is not None:
            attempt("cot", lambda: self.cot_scraper.scrape(now), TOPIC_COT)
        if self.vix_scraper is not None:
            attempt("vix", lambda: self.vix_scraper.scrape(now), TOPIC_VIX)

        self.ticks += 1
        return results

    # -- the session loop ------------------------------------------------------

    def run_session(self, max_ticks: Optional[int] = None) -> int:
        """Tick every ``freq_s`` seconds while the market is open; returns
        the number of ticks executed."""
        hours = self.market_hours_today()
        if hours is None:
            return 0
        if self.indicator_scraper is not None:
            # a fresh dedup registry every session
            self.indicator_scraper.registry.reset()
        executed = 0
        while True:
            now = self.now_fn()
            if not (hours["market_start"] <= now <= hours["market_end"]):
                log.warning("market closed at %s; session over", now)
                break
            start = _time.perf_counter()
            self.run_tick()
            executed += 1
            if max_ticks is not None and executed >= max_ticks:
                break
            elapsed = _time.perf_counter() - start
            self.sleep_fn(max(self.config.freq_s - elapsed, 0.0))
        return executed
