"""Scrape endpoint, as ``fmda_tpu.obs.server`` serves it: a stdlib
``http.server`` thread serving the plane.

No web framework: fixed routes on a daemonised
:class:`~http.server.ThreadingHTTPServer`:

- ``/metrics``: Prometheus text exposition of the registry snapshot
  (OpenMetrics, with the tracer's exemplars, to a client that asks for
  it);
- ``/healthz``: JSON health verdict; HTTP 200 when every check passes,
  503 when any fails;
- ``/snapshot``: the raw registry snapshot as JSON (what ``python -m
  fmda_tpu_torch status --endpoint`` reads);
- ``/events``: the event ring as JSONL (newest last); ``?trace_id=...``
  narrows it to one trace's events;
- ``/trace``: the span ring as Chrome/Perfetto ``trace_event`` JSON (what
  ``trace --endpoint`` reads);
- ``/profile``: the host profiler's folded stacks as text, when one is
  attached;
- ``/device``: the kernel ledger and device memory report as JSON
  (:mod:`fmda_tpu_torch.obs.device`, when attached; what ``perf
  --endpoint`` reads);
- ``/quality``: the label-join evaluator's document, when one is attached
  (what ``quality --endpoint`` reads);
- ``/query``: time-series range queries (``?series=&window=``) when a
  fleet telemetry handle is attached (:mod:`fmda_tpu_torch.obs.aggregate`);
- ``/alerts``: the SLO engine's alert document
  (:mod:`fmda_tpu_torch.obs.slo`; what ``status --endpoint`` reads);
- ``/control``: the control plane's document, when one is attached
  (:mod:`fmda_tpu_torch.control`; what ``status --endpoint`` prints as
  its control section); 404 otherwise.

A handler exception yields an HTTP 500 with a JSON ``{"error": ...}``
body, never a half-written response, and the serving thread survives.
Bind with ``port=0`` for an ephemeral port (tests); :attr:`port` reports
the bound one.  Request logging goes to the ``fmda_tpu_torch.obs`` logger
at DEBUG, never to stderr.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs

from fmda_tpu_torch.obs.events import EventLog
from fmda_tpu_torch.obs.prometheus import render_prometheus
from fmda_tpu_torch.obs.registry import MetricsRegistry
from fmda_tpu_torch.obs.trace import Tracer

log = logging.getLogger("fmda_tpu_torch.obs")


class MetricsServer:
    """Background scrape server over a registry (+ health fn + events)."""

    def __init__(
        self,
        registry: MetricsRegistry,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        health_fn: Optional[Callable[[], dict]] = None,
        events: Optional[EventLog] = None,
        tracer: Optional[Tracer] = None,
        quality_fn: Optional[Callable[[], dict]] = None,
        profile_fn: Optional[Callable[[], str]] = None,
        device_fn: Optional[Callable[[], dict]] = None,
        query_fn: Optional[Callable[..., dict]] = None,
        alerts_fn: Optional[Callable[[], dict]] = None,
        control_fn: Optional[Callable[[], dict]] = None,
    ) -> None:
        self.registry = registry
        self.health_fn = health_fn
        self.events = events
        self.tracer = tracer
        self.quality_fn = quality_fn
        self.profile_fn = profile_fn
        self.device_fn = device_fn
        self.query_fn = query_fn
        self.alerts_fn = alerts_fn
        self.control_fn = control_fn
        server = self

        class Handler(BaseHTTPRequestHandler):
            def _send(
                self, status: int, body: bytes, content_type: str
            ) -> None:
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:  # noqa: N802 — http.server API
                path, _, query = self.path.partition("?")
                try:
                    if path == "/metrics":
                        # exemplar syntax is OpenMetrics-only — the
                        # 0.0.4 text parser fails the WHOLE scrape on
                        # the '# {...}' suffix — so emit it (and the
                        # matching content type + EOF terminator) only
                        # for clients that negotiated OpenMetrics
                        om = "openmetrics" in (
                            self.headers.get("Accept") or "")
                        text = render_prometheus(
                            server.registry.snapshot(), exemplars=om)
                        if om:
                            self._send(
                                200, (text + "# EOF\n").encode(),
                                "application/openmetrics-text; "
                                "version=1.0.0; charset=utf-8")
                        else:
                            self._send(
                                200, text.encode(),
                                "text/plain; version=0.0.4; "
                                "charset=utf-8")
                    elif path == "/healthz":
                        health = (
                            server.health_fn()
                            if server.health_fn is not None
                            else {"status": "ok", "checks": {}}
                        )
                        status = 200 if health.get("status") == "ok" else 503
                        self._send(
                            status,
                            json.dumps(health, indent=2).encode(),
                            "application/json",
                        )
                    elif path == "/snapshot":
                        self._send(
                            200,
                            json.dumps(server.registry.snapshot()).encode(),
                            "application/json",
                        )
                    elif path == "/events" and server.events is not None:
                        params = parse_qs(query)
                        trace_id = params.get("trace_id", [None])[0]
                        self._send(
                            200,
                            server.events.to_jsonl(
                                trace_id=trace_id).encode(),
                            "application/x-ndjson")
                    elif path == "/query" and server.query_fn is not None:
                        params = parse_qs(query)
                        series = params.get("series", [None])[0]
                        if not series:
                            self._send(
                                400,
                                json.dumps({
                                    "error": "missing ?series=",
                                    "path": self.path}).encode(),
                                "application/json")
                            return
                        window = params.get("window", [None])[0]
                        doc = server.query_fn(
                            series, float(window) if window else None)
                        self._send(200, json.dumps(doc).encode(),
                                   "application/json")
                    elif path == "/alerts" and server.alerts_fn is not None:
                        self._send(
                            200,
                            json.dumps(server.alerts_fn(), indent=2).encode(),
                            "application/json")
                    elif path == "/control" \
                            and server.control_fn is not None:
                        self._send(
                            200,
                            json.dumps(server.control_fn(),
                                       indent=2).encode(),
                            "application/json")
                    elif path == "/quality" \
                            and server.quality_fn is not None:
                        self._send(
                            200,
                            json.dumps(server.quality_fn(),
                                       indent=2).encode(),
                            "application/json")
                    elif path == "/profile" \
                            and server.profile_fn is not None:
                        self._send(
                            200, server.profile_fn().encode(),
                            "text/plain; charset=utf-8")
                    elif path == "/device" \
                            and server.device_fn is not None:
                        self._send(
                            200,
                            json.dumps(server.device_fn(),
                                       indent=2).encode(),
                            "application/json")
                    elif path == "/trace":
                        doc = (
                            server.tracer.chrome()
                            if server.tracer is not None
                            else {"traceEvents": []}
                        )
                        self._send(
                            200, json.dumps(doc).encode(),
                            "application/json")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except Exception as e:  # noqa: BLE001 — loss-free: a
                    # broken scrape answers HTTP 500, never kills the
                    # serving thread; the client gets
                    # a well-formed JSON error body (the body is built
                    # BEFORE any byte is sent, so a collector blowing up
                    # can never leave a half-written response on the wire)
                    log.exception("scrape handler failed for %s", self.path)
                    try:
                        body = json.dumps(
                            {"error": repr(e), "path": self.path}).encode()
                        self._send(500, body, "application/json")
                    except Exception:  # noqa: BLE001 — loss-free: the client went away mid-500; nothing to answer
                        pass

            def log_message(self, fmt: str, *args) -> None:
                log.debug("%s %s", self.address_string(), fmt % args)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def start(self) -> "MetricsServer":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="fmda-obs-server",
            daemon=True,
        )
        self._thread.start()
        log.info("observability endpoint serving on %s", self.url)
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._httpd.shutdown()
        self._thread.join(timeout=5.0)
        self._httpd.server_close()
        self._thread = None
