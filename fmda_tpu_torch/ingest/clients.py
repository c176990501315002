"""Market-data API clients (IEX DEEP, Alpha Vantage, the Tradier
calendar) over an injectable transport, as ``fmda_tpu.ingest.clients``
defines them: the DEEP book reshaped into per-level ``bids_i``/``asks_i``
dicts, an Alpha Vantage response reduced to its latest bar with sanitised
keys (a delayed bar is accepted with a warning, not dropped), and the
market calendar that gates the session.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
from typing import Dict, List, Optional

from fmda_tpu_torch.ingest.transport import Transport, live_transport
from fmda_tpu_torch.utils.jsonutils import change_keys, values_to_numbers
from fmda_tpu_torch.utils.timeutils import TS_FORMAT

log = logging.getLogger("fmda_tpu_torch.ingest")


class IEXClient:
    """IEX Cloud client: the DEEP book endpoint."""

    def __init__(
        self,
        token: str,
        transport: Optional[Transport] = None,
        base_url: str = "https://cloud.iexapis.com/v1",
    ) -> None:
        self.token = token
        self.transport = transport or live_transport()
        self.base_url = base_url

    def get_deep_book(self, symbol: str, timestamp: _dt.datetime) -> Dict:
        """Order-book snapshot -> flat bus message keyed bids_i/asks_i."""
        url = (
            f"{self.base_url}/deep/book?symbols={symbol}&"
            f"token={self.token}&format=json"
        )
        raw = json.loads(self.transport.get(url))
        message: Dict = {"Timestamp": timestamp.strftime(TS_FORMAT)}
        # response shape: {SYMBOL: {"bids": [{price, size}...], "asks": [...]}}
        book = raw.get(symbol.upper()) or raw.get(symbol) or {}
        for i, level in enumerate(book.get("bids", [])):
            message[f"bids_{i}"] = {
                f"bid_{i}": level.get("price"),
                f"bid_{i}_size": level.get("size"),
            }
        for i, level in enumerate(book.get("asks", [])):
            message[f"asks_{i}"] = {
                f"ask_{i}": level.get("price"),
                f"ask_{i}_size": level.get("size"),
            }
        return message


class AlphaVantageClient:
    """Alpha Vantage intraday client (stocks + FX)."""

    def __init__(
        self,
        token: str,
        transport: Optional[Transport] = None,
        base_url: str = "https://www.alphavantage.co/query",
        staleness_warn_s: int = 4 * 60,
    ) -> None:
        self.token = token
        self.transport = transport or live_transport()
        self.base_url = base_url
        self.staleness_warn_s = staleness_warn_s

    def _url(self, function: str, symbol: str, interval: Optional[str]) -> str:
        if function.startswith("FX_"):
            from_sym, to_sym = symbol[:3], symbol[3:]
            url = (
                f"{self.base_url}?function={function}&from_symbol={from_sym}"
                f"&to_symbol={to_sym}"
            )
        else:
            url = f"{self.base_url}?function={function}&symbol={symbol}"
        if interval:
            url += f"&interval={interval}"
        return url + f"&apikey={self.token}&datatype=json"

    def get_latest_bar(
        self,
        symbol: str,
        timestamp: _dt.datetime,
        function: str = "TIME_SERIES_INTRADAY",
        interval: str = "5min",
    ) -> Dict:
        """Latest OHLCV bar with sanitised keys and the ingestion
        timestamp.  A delayed bar is accepted with a warning: a late bar
        beats a gap."""
        raw = json.loads(self.transport.get(self._url(function, symbol, interval)))
        if not raw:
            raise ValueError("Alpha Vantage returned an empty response")
        if "Error Message" in raw:
            raise ValueError(raw["Error Message"])
        series_keys = [k for k in raw if k != "Meta Data"]
        if not series_keys:
            raise ValueError(f"no time series in response: {list(raw)}")
        series = raw[series_keys[0]]
        last_dt_str = max(series)  # keys are 'YYYY-MM-DD HH:MM:SS'
        last_dt = _dt.datetime.strptime(last_dt_str, TS_FORMAT)
        if last_dt < timestamp.replace(tzinfo=None) - _dt.timedelta(
            seconds=self.staleness_warn_s
        ):
            log.warning(
                "RETURNED DATA IS DELAYED (bar %s vs now %s) — using anyway",
                last_dt_str, timestamp.strftime(TS_FORMAT),
            )
        bar = change_keys(series[last_dt_str], ". ", "_")
        bar = values_to_numbers(bar)
        bar["Timestamp"] = timestamp.strftime(TS_FORMAT)
        return bar


class TradierCalendarClient:
    """The market calendar that gates a session."""

    def __init__(
        self,
        token: str,
        transport: Optional[Transport] = None,
        base_url: str = "https://api.tradier.com/v1",
    ) -> None:
        self.token = token
        self.transport = transport or live_transport()
        self.base_url = base_url

    def get_market_calendar(self) -> List[Dict]:
        body = self.transport.get(
            f"{self.base_url}/markets/calendar",
            headers={
                "Authorization": f"Bearer {self.token}",
                "Accept": "application/json",
            },
        )
        return json.loads(body)["calendar"]["days"]["day"]
