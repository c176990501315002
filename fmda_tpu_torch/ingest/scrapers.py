"""Web scrapers: the economic calendar, the VIX spot quote and the COT
reports, as ``fmda_tpu.ingest.scrapers`` defines them.  Each is a plain
object: fetch the page(s) through the injectable transport, parse with the
stdlib DOM (:mod:`.htmldom`), return the bus message.

The parsers target the pages' structures:

- the Investing.com economic calendar's rows (``tr[id*=eventRowId]`` with
  ``data-event-datetime``, the country in ``td/span/@title``, the
  importance in ``data-img_key``, the actual/previous/forecast cells);
- the cnbc.com VIX quote (``span.last``);
- the tradingster.com COT index, then the report's table (the Asset
  Manager, Leveraged Funds and Managed Money rows).
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import os
import re
from typing import Dict, List, Optional, Sequence

from fmda_tpu_torch.config import FeatureConfig
from fmda_tpu_torch.ingest.htmldom import Element, parse_html
from fmda_tpu_torch.ingest.transport import Transport, live_transport
from fmda_tpu_torch.utils.jsonutils import to_number
from fmda_tpu_torch.utils.timeutils import TS_FORMAT

log = logging.getLogger("fmda_tpu_torch.ingest")


class SentItemsRegistry:
    """Dedup registry of already-published calendar items: a JSON file,
    rewritten on every mark and reset every session."""

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path
        self._seen: Dict[str, bool] = {}
        if path and os.path.exists(path):
            with open(path) as fh:
                self._seen = json.load(fh)

    @staticmethod
    def _key(schedule_dt: str, event: str) -> str:
        return f"{schedule_dt}|{event}"

    def is_new(self, schedule_dt: str, event: str) -> bool:
        return self._key(schedule_dt, event) not in self._seen

    def mark_sent(self, schedule_dt: str, event: str) -> None:
        self._seen[self._key(schedule_dt, event)] = True
        if self.path:
            with open(self.path, "w") as fh:
                json.dump(self._seen, fh)

    def reset(self) -> None:
        self._seen = {}
        if self.path:
            with open(self.path, "w") as fh:
                json.dump(self._seen, fh)


def _clean_metric(raw: Optional[str]) -> Optional[str]:
    if raw is None:
        return None
    return raw.strip().strip("%MBK ")


class EconomicCalendarScraper:
    """Scrapes released economic indicators and merges them into the
    zero-filled template message (:meth:`FeatureConfig.empty_ind_message`)."""

    URL = "https://www.investing.com/economic-calendar/"

    def __init__(
        self,
        features: FeatureConfig,
        countries: Sequence[str] = ("United States",),
        importance: Sequence[str] = ("1", "2", "3"),
        transport: Optional[Transport] = None,
        registry: Optional[SentItemsRegistry] = None,
    ) -> None:
        self.features = features
        self.countries = tuple(countries)
        self.importance = tuple("bull" + i for i in importance)
        self.transport = transport or live_transport()
        self.registry = registry or SentItemsRegistry()

    def parse(self, html: str, current_dt: _dt.datetime) -> List[Dict]:
        """Extract released (past, matching) indicator items from the page."""
        root = parse_html(html)
        items: List[Dict] = []
        for row in root.find_all("tr"):
            if "eventRowId" not in (row.attrs.get("id") or ""):
                continue
            dt_str = row.attrs.get("data-event-datetime")
            if not dt_str:
                continue
            event_dt = _dt.datetime.strptime(dt_str, "%Y/%m/%d %H:%M:%S")
            if current_dt < event_dt:
                continue  # only events that already released

            country_el = row.find("span", title="")
            country = None
            for span in row.find_all("span"):
                if "title" in span.attrs:
                    country = span.attrs["title"]
                    break
            importance_el = None
            for td in row.find_all("td"):
                if "data-img_key" in td.attrs:
                    importance_el = td.attrs["data-img_key"]
                    break
            if country not in self.countries or importance_el not in self.importance:
                continue

            event_cell = row.find("td", class_="event")
            if event_cell is None:
                continue
            link = event_cell.find("a")
            event_name = (link.text if link else event_cell.text).strip(" \r\n\t")
            # strip trailing period qualifiers like "(Jan)"
            m = re.findall(r"(.*?)(?=.\([a-zA-Z]{3}\))", event_name)
            if m:
                event_name = m[0].strip()
            if event_name not in self.features.event_list:
                continue

            actual = previous = forecast = None
            for td in row.find_all("td"):
                td_id = td.attrs.get("id") or ""
                if "eventActual" in td_id:
                    actual = _clean_metric(td.own_text)
                elif "eventPrevious" in td_id:
                    span = td.find("span")
                    previous = _clean_metric(span.text if span else td.text)
                elif "eventForecast" in td_id:
                    forecast = _clean_metric(td.own_text)
            if not actual or actual == "\xa0":
                continue  # not yet released

            actual_f = float(actual)
            prev_diff = float(previous) - actual_f if previous and previous != "\xa0" else 0.0
            forc_diff = (
                float(forecast) - actual_f if forecast and forecast != "\xa0" else None
            )
            items.append(
                {
                    "Timestamp": current_dt.strftime(TS_FORMAT),
                    "Schedule_datetime": dt_str,
                    "Event": event_name.replace(" ", "_"),
                    event_name.replace(" ", "_"): {
                        "Actual": actual_f,
                        "Prev_actual_diff": prev_diff,
                        "Forc_actual_diff": forc_diff,
                    },
                }
            )
        return items

    def scrape(self, current_dt: _dt.datetime) -> Dict:
        """Fetch + parse + dedup; returns ONE merged template message (new
        items replace zeros; everything else stays 0)."""
        html = self.transport.get(self.URL).decode("utf-8", "replace")
        items = self.parse(html, current_dt)
        message = self.features.empty_ind_message()
        message["Timestamp"] = current_dt.strftime(TS_FORMAT)
        for item in items:
            if not self.registry.is_new(item["Schedule_datetime"], item["Event"]):
                continue
            self.registry.mark_sent(item["Schedule_datetime"], item["Event"])
            event_key = item["Event"]
            payload = dict(item[event_key])
            if payload.get("Forc_actual_diff") is None:
                payload["Forc_actual_diff"] = 0
            message[event_key] = payload
        return message


class VIXScraper:
    """Spot VIX from cnbc.com."""

    URL = "https://www.cnbc.com/quotes/?symbol=.VIX"

    def __init__(self, transport: Optional[Transport] = None) -> None:
        self.transport = transport or live_transport()

    def parse(self, html: str) -> float:
        root = parse_html(html)
        span = root.find("span", class_="last")
        if span is None:
            raise ValueError("VIX quote element not found")
        return float(span.text.replace(",", "").strip())

    def scrape(self, current_dt: _dt.datetime) -> Dict:
        html = self.transport.get(self.URL).decode("utf-8", "replace")
        return {
            "VIX": self.parse(html),
            "Timestamp": current_dt.strftime(TS_FORMAT),
        }


class COTScraper:
    """Commitment-of-Traders positioning: a two-hop crawl (the index,
    then the subject's report)."""

    INDEX_URL = "https://www.tradingster.com/cot"

    def __init__(
        self,
        report_subject: str,
        transport: Optional[Transport] = None,
        index_url: Optional[str] = None,
    ) -> None:
        self.report_subject = report_subject
        self.transport = transport or live_transport()
        self.index_url = index_url or self.INDEX_URL

    def find_report_url(self, index_html: str) -> Optional[str]:
        root = parse_html(index_html)
        for row in root.find_all("tr"):
            cells = row.find_all("td")
            if not cells:
                continue
            if cells[0].text.strip() != self.report_subject:
                continue
            if len(cells) >= 3:
                link = cells[2].find("a")
                if link is not None and "href" in link.attrs:
                    return link.attrs["href"]
        return None

    def parse_report(self, html: str, current_dt: _dt.datetime) -> Dict:
        root = parse_html(html)
        message: Dict = {"Timestamp": current_dt.strftime(TS_FORMAT)}
        for row in root.find_all("tr"):
            strong = row.find("strong")
            if strong is None:
                continue
            name = strong.text.strip(" /")
            if not any(g in name for g in ("Asset Manager", "Leveraged", "Managed Money")):
                continue
            group = name.split()[0]
            cells = row.find_all("td")
            if len(cells) < 6:
                continue

            def cell_value(cell: Element) -> str:
                return cell.own_text.strip().strip(" %").replace(",", "")

            def cell_change(cell: Element) -> str:
                span = cell.find("span")
                return (span.text if span else "0").replace(",", "").strip()

            message[group] = {
                f"{group}_long_pos": to_number(cell_value(cells[1])),
                f"{group}_long_pos_change": to_number(cell_change(cells[1])),
                f"{group}_long_open_int": to_number(cell_value(cells[2])),
                f"{group}_short_pos": to_number(cell_value(cells[4])),
                f"{group}_short_pos_change": to_number(cell_change(cells[4])),
                f"{group}_short_open_int": to_number(cell_value(cells[5])),
            }
        return message

    def scrape(self, current_dt: _dt.datetime) -> Optional[Dict]:
        index_html = self.transport.get(self.index_url).decode("utf-8", "replace")
        report_url = self.find_report_url(index_html)
        if report_url is None:
            log.warning("COT report for %r not found", self.report_subject)
            return None
        if report_url.startswith("/"):
            from urllib.parse import urljoin

            report_url = urljoin(self.index_url, report_url)
        report_html = self.transport.get(report_url).decode("utf-8", "replace")
        return self.parse_report(report_html, current_dt)
