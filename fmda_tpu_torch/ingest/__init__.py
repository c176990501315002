"""The acquisition layer: transports with record and replay, the market
data clients, the web scrapers and the session driver that publishes the
five feeds onto the bus."""

from fmda_tpu_torch.ingest.transport import (
    CircuitBreakerTransport,
    RateLimitTransport,
    RecordingTransport,
    ReplayTransport,
    RetryTransport,
    SessionReplayTransport,
    Transport,
    TransportError,
    UrllibTransport,
    live_transport,
)
from fmda_tpu_torch.ingest.clients import (
    AlphaVantageClient, IEXClient, TradierCalendarClient)
from fmda_tpu_torch.ingest.scrapers import (
    COTScraper,
    EconomicCalendarScraper,
    VIXScraper,
)
from fmda_tpu_torch.ingest.session import SessionDriver

__all__ = [
    "Transport",
    "TransportError",
    "UrllibTransport",
    "ReplayTransport",
    "RecordingTransport",
    "SessionReplayTransport",
    "RetryTransport",
    "RateLimitTransport",
    "CircuitBreakerTransport",
    "live_transport",
    "IEXClient",
    "AlphaVantageClient",
    "TradierCalendarClient",
    "EconomicCalendarScraper",
    "VIXScraper",
    "COTScraper",
    "SessionDriver",
]
