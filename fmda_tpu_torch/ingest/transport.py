"""HTTP transports with record and replay, as ``fmda_tpu.ingest.transport``
defines them.

Every network touch of the acquisition layer goes through a
:class:`Transport`, so the whole layer runs against recorded fixtures in
tests and air-gapped deployments.  The live stack
(:func:`live_transport`) is stdlib HTTP behind per-host rate limiting,
jittered exponential-backoff retries and a per-host circuit breaker; its
counters and the request-latency histogram go to the process registry
(:func:`fmda_tpu_torch.obs.registry.default_registry`) under the
reference's names (:data:`INGEST_COUNTER_NAMES`).  A live request made
inside an active trace is an ``http_get`` span (stage ``ingest``) of it.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time as _time
from typing import Dict, List, Optional, Protocol

from fmda_tpu_torch.obs.registry import default_registry
from fmda_tpu_torch.obs.trace import default_tracer

log = logging.getLogger("fmda_tpu_torch.ingest")

#: The ingest layer's metric vocabulary, in one place (a transport adding
#: a metric adds its name here).
INGEST_COUNTER_NAMES = (
    "ingest_requests_total",
    "ingest_request_failures_total",
    "ingest_retries_total",
    "ingest_ratelimit_waits_total",
    "ingest_ratelimit_wait_seconds_total",
    "ingest_circuit_open_total",
    "ingest_circuit_shortcircuit_total",
)
INGEST_HISTOGRAM_NAMES = ("ingest_request_seconds",)


class TransportError(Exception):
    """Network failure or non-2xx response.

    ``status`` carries the HTTP status when one was received (None for
    connection-level failures); ``retry_after_s`` carries a parsed
    ``Retry-After`` header in seconds when the server sent one — the
    retry layer honors it on 429/503 instead of guessing."""

    def __init__(
        self,
        message: str,
        *,
        status: Optional[int] = None,
        retry_after_s: Optional[float] = None,
    ) -> None:
        super().__init__(message)
        self.status = status
        self.retry_after_s = retry_after_s


def _parse_retry_after(value) -> Optional[float]:
    """Seconds form of a ``Retry-After`` header value (the HTTP-date
    form is rare on rate limiters and a wrong clock would turn it into
    a pathological sleep — unparseable values are simply ignored)."""
    if value is None:
        return None
    try:
        out = float(str(value).strip())
    except ValueError:
        return None
    return out if out >= 0 else None


def _url_host(url: str) -> str:
    from urllib.parse import urlparse

    return urlparse(url).netloc or url


class Transport(Protocol):
    def get(self, url: str, headers: Optional[Dict[str, str]] = None) -> bytes:
        """Fetch a URL; returns the response body, raises TransportError."""
        ...


class UrllibTransport:
    """Live stdlib transport (no third-party HTTP dependency).

    Every request reports its latency and the request and failure counts
    to the metrics registry (``metrics``, default the process registry;
    tests pass their own).
    """

    def __init__(
        self,
        timeout_s: float = 20.0,
        user_agent: str = "fmda-tpu/0.1",
        *,
        metrics=None,
    ):
        self.timeout_s = timeout_s
        self.user_agent = user_agent
        reg = metrics if metrics is not None else default_registry()
        self._m_requests = reg.counter("ingest_requests_total")
        self._m_failures = reg.counter("ingest_request_failures_total")
        self._m_latency = reg.histogram("ingest_request_seconds")
        self._tracer = default_tracer()

    def get(self, url: str, headers: Optional[Dict[str, str]] = None) -> bytes:
        import urllib.error
        import urllib.request

        req_headers = {"User-Agent": self.user_agent}
        if headers:
            req_headers.update(headers)
        request = urllib.request.Request(url, headers=req_headers)
        self._m_requests.inc()
        t0 = _time.perf_counter()
        try:
            # span() is the shared no-op singleton when tracing is off or
            # no trace is active (a one-shot fetch outside a tick)
            with self._tracer.span("http_get", "ingest"):
                with urllib.request.urlopen(
                        request, timeout=self.timeout_s) as resp:
                    return resp.read()
        except urllib.error.HTTPError as e:  # pragma: no cover - live only
            # carry the status + Retry-After so the retry layer can obey
            # a rate limiter / recovering feed instead of hammering it
            self._m_failures.inc()
            retry_after = _parse_retry_after(
                e.headers.get("Retry-After") if e.headers else None)
            raise TransportError(
                f"GET {url} failed: {e}",
                status=int(e.code), retry_after_s=retry_after) from e
        except urllib.error.URLError as e:  # pragma: no cover - live only
            self._m_failures.inc()
            raise TransportError(f"GET {url} failed: {e}") from e
        except Exception:  # pragma: no cover - live only (e.g. a body
            # read dying mid-stream raises IncompleteRead, not URLError;
            # count it so failure-rate dashboards see the outage, but
            # keep the exception itself untranslated as before)
            self._m_failures.inc()
            raise
        finally:
            self._m_latency.observe(_time.perf_counter() - t0)


class ReplayTransport:
    """Serve responses from recorded (url-pattern -> body) fixtures.

    A fixture value may be one body, or a *sequence* of bodies replayed in
    request order (a live session hits the same URL repeatedly with
    evolving responses — the sequential form reproduces the whole day;
    after the recorded responses run out, the last one repeats).
    """

    def __init__(self, fixtures: Dict[str, object]) -> None:
        #: regex pattern -> body or list of bodies; exact strings work too
        #: (re.escape not required for urls without regex metacharacters).
        def coerce(v) -> List[bytes]:
            if isinstance(v, (list, tuple)):
                if not v:
                    raise ValueError(
                        "empty fixture sequence (a url with zero recorded "
                        "bodies can never be served)"
                    )
                return [b if isinstance(b, bytes) else str(b).encode()
                        for b in v]
            return [v if isinstance(v, bytes) else str(v).encode()]

        self.fixtures = {k: coerce(v) for k, v in fixtures.items()}
        self._cursor: Dict[str, int] = {}
        self.requests: List[str] = []

    def _serve(self, key: str) -> bytes:
        return _serve_sequential(self.fixtures, self._cursor, key)

    def get(self, url: str, headers: Optional[Dict[str, str]] = None) -> bytes:
        self.requests.append(url)
        if url in self.fixtures:
            return self._serve(url)
        for pattern in self.fixtures:
            if re.search(pattern, url):
                return self._serve(pattern)
        raise TransportError(f"no fixture for {url}")


def _serve_sequential(
    bodies_map: Dict[str, List[bytes]], cursor: Dict[str, int], key: str
) -> bytes:
    """Shared sequential-replay semantics: bodies in recorded order, the
    last one repeating once exhausted."""
    bodies = bodies_map[key]
    i = cursor.get(key, 0)
    cursor[key] = i + 1
    return bodies[min(i, len(bodies) - 1)]


def _mask_credentials(url: str) -> str:
    return re.sub(r"(token|apikey)=[^&]+", r"\1=*", url)


class SessionReplayTransport:
    """Replay a recorded session with credentials masked out of the URL
    match, so fixtures recorded with real tokens serve clients constructed
    with placeholders.  Exact (masked) URL matching — recorded keys are
    literal URLs full of regex metacharacters, so the pattern matching of
    :class:`ReplayTransport` does not apply.  Unmatched requests are
    remembered in :attr:`misses` so a replay under a mismatched config
    (different feeds/cadence than recorded) can be diagnosed."""

    def __init__(self, fixtures: Dict[str, List[bytes]]) -> None:
        self._bodies: Dict[str, List[bytes]] = {}
        for url, bodies in fixtures.items():
            if not bodies:
                raise ValueError(f"empty fixture sequence for {url}")
            self._bodies.setdefault(_mask_credentials(url), []).extend(
                b if isinstance(b, bytes) else str(b).encode()
                for b in (bodies if isinstance(bodies, (list, tuple))
                          else [bodies])
            )
        self._cursor: Dict[str, int] = {}
        self.misses: List[str] = []

    def get(self, url: str, headers: Optional[Dict[str, str]] = None) -> bytes:
        key = _mask_credentials(url)
        if key not in self._bodies:
            self.misses.append(key)
            raise TransportError(f"no recorded response for {url}")
        return _serve_sequential(self._bodies, self._cursor, key)


class RetryTransport:
    """Retry-with-backoff wrapper: exponential-backoff retries with a log
    line an attempt.

    Backoff uses **full jitter** (delay drawn uniformly from
    ``[0, backoff_s * 2^attempt]``): the session drivers all tick on the
    same cadence, so un-jittered backoff retries every feed's clients in
    lockstep against a recovering host — the classic thundering-herd
    shape.  ``jitter=False`` restores the deterministic schedule (and
    ``rng`` injects a seeded source for tests).  A 429/503 response
    carrying ``Retry-After`` overrides the computed delay — the server
    knows its own recovery better than our schedule — capped at the
    schedule's largest backoff (``backoff_s * 2^(attempts-1)``) so a
    pathological header can never park the cadence loop.
    """

    def __init__(
        self,
        inner: Transport,
        attempts: int = 3,
        backoff_s: float = 1.0,
        sleep_fn=None,
        *,
        jitter: bool = True,
        rng=None,
        metrics=None,
    ) -> None:
        import random
        import time

        self.inner = inner
        self.attempts = attempts
        self.backoff_s = backoff_s
        self.sleep_fn = sleep_fn or time.sleep
        self.jitter = jitter
        self._rng = rng if rng is not None else random.Random()
        reg = metrics if metrics is not None else default_registry()
        self._m_retries = reg.counter("ingest_retries_total")

    def _delay(self, attempt: int, error: TransportError) -> float:
        cap = self.backoff_s * (2 ** attempt)
        if (error.status in (429, 503)
                and error.retry_after_s is not None):
            budget = self.backoff_s * (2 ** (self.attempts - 1))
            return min(error.retry_after_s, budget)
        return self._rng.uniform(0.0, cap) if self.jitter else cap

    def get(self, url: str, headers: Optional[Dict[str, str]] = None) -> bytes:
        last: Optional[Exception] = None
        for attempt in range(self.attempts):
            try:
                return self.inner.get(url, headers)
            except TransportError as e:
                last = e
                if attempt < self.attempts - 1:
                    delay = self._delay(attempt, e)
                    log.warning(
                        "GET %s failed (attempt %d/%d): %s; retrying in %.1fs",
                        url, attempt + 1, self.attempts, e, delay,
                    )
                    self._m_retries.inc()
                    self.sleep_fn(delay)
        raise TransportError(
            f"GET {url} failed after {self.attempts} attempts"
        ) from last


class CircuitOpenError(TransportError):
    """Short-circuited request: the host's breaker is open (the feed has
    been failing consecutively and its probe timer has not elapsed)."""


class CircuitBreakerTransport:
    """Per-host circuit breaker.

    The hardened transport stack bounds one GET at ~69 s worst case
    (attempts × timeout + backoff) — survivable once, but a *dead* feed
    pays that wall on every cadence tick, starving the other feeds' slot
    in the tick loop.  The breaker makes a dead host fail in
    microseconds instead: ``failure_threshold`` consecutive failures
    trip the host **open** (counted, logged); while open every request
    short-circuits with :class:`CircuitOpenError` (a ``TransportError``
    — the session driver's per-feed isolation handles it unchanged);
    after ``reset_timeout_s`` the next request is let through as a
    **half-open probe** — success closes the breaker, failure re-opens
    it for another timer period.  State is per *host*, so one dead feed
    never opens the breaker for the rest.
    """

    def __init__(
        self,
        inner: Transport,
        *,
        failure_threshold: int = 3,
        reset_timeout_s: float = 120.0,
        clock=None,
        metrics=None,
    ) -> None:
        import time

        self.inner = inner
        self.failure_threshold = max(1, int(failure_threshold))
        self.reset_timeout_s = reset_timeout_s
        self.clock = clock or time.monotonic
        self._lock = threading.Lock()
        #: host -> {"failures", "state", "opened_at"} where state is
        #: "closed" | "open" | "probe" (one half-open probe in flight)
        self._hosts: Dict[str, Dict[str, object]] = {}
        reg = metrics if metrics is not None else default_registry()
        self._m_trips = reg.counter("ingest_circuit_open_total")
        self._m_short = reg.counter("ingest_circuit_shortcircuit_total")

    def state(self, url_or_host: str) -> str:
        """Current breaker state for a host (monitoring/tests)."""
        host = _url_host(url_or_host)
        with self._lock:
            entry = self._hosts.get(host)
            return str(entry["state"]) if entry else "closed"

    def _admit(self, host: str) -> None:
        """Decide whether this request may pass (raises when open)."""
        with self._lock:
            entry = self._hosts.get(host)
            if entry is None or entry["state"] == "closed":
                return
            if entry["state"] == "open" and (
                    self.clock() - entry["opened_at"]
                    >= self.reset_timeout_s):
                # timer elapsed: this request becomes the half-open probe
                entry["state"] = "probe"
                log.warning(
                    "circuit for %s half-open: probing with this request",
                    host)
                return
            # open (timer running) or another probe already in flight
            self._m_short.inc()
            raise CircuitOpenError(
                f"circuit open for {host}: {entry['failures']} consecutive "
                f"failures; next probe in <= {self.reset_timeout_s:.0f}s")

    def _record(self, host: str, ok: bool) -> None:
        with self._lock:
            entry = self._hosts.setdefault(
                host, {"failures": 0, "state": "closed", "opened_at": 0.0})
            if ok:
                if entry["state"] != "closed" or entry["failures"]:
                    log.warning("circuit for %s closed (probe succeeded)",
                                host)
                entry.update(failures=0, state="closed")
                return
            entry["failures"] = int(entry["failures"]) + 1
            tripped = (entry["state"] == "probe"
                       or entry["failures"] >= self.failure_threshold)
            if tripped and entry["state"] != "open":
                entry.update(state="open", opened_at=self.clock())
                self._m_trips.inc()
                log.warning(
                    "circuit for %s OPEN after %d consecutive failure(s); "
                    "probing again in %.0fs", host, entry["failures"],
                    self.reset_timeout_s)

    def get(self, url: str, headers: Optional[Dict[str, str]] = None) -> bytes:
        host = _url_host(url)
        self._admit(host)
        try:
            body = self.inner.get(url, headers)
        except TransportError:
            self._record(host, ok=False)
            raise
        self._record(host, ok=True)
        return body


#: Process-wide per-host last-request map shared by every
#: :class:`RateLimitTransport` on the real clock: two components each
#: defaulting to ``live_transport()`` against the same host are spaced
#: jointly (a global throttle, not one per client).
_SHARED_LAST: Dict[str, float] = {}
_SHARED_LAST_LOCK = threading.Lock()


class RateLimitTransport:
    """Per-host request spacing.  Requests to the same host are spaced at
    least ``min_interval_s`` apart; different hosts never block each
    other, so one slow feed cannot starve the rest of a tick.

    Instances on the real clock share one process-wide per-host map
    under a lock (every client and scraper builds its own
    ``live_transport()``, so per-instance state would not space them
    jointly, and a threaded driver needs the lock anyway).  Tests that
    inject a ``clock`` get private state, so fake time never mixes with
    real-clock entries.

    Shared-state semantics (``_SHARED_LAST``): the map is global
    throttle state — it is never pruned, and instances with *different*
    ``min_interval_s`` against the same host interact (each request
    stamps the host's slot, so the next requester waits by its OWN
    interval from whoever went last: a global throttle, not per-client
    budgets).  Tests that
    touch real-clock instances must call :meth:`_reset_shared_state`
    (e.g. in a ``finally:``) so entries never leak across tests.
    """

    @staticmethod
    def _reset_shared_state() -> None:
        """Clear the process-wide per-host throttle map (test hygiene)."""
        with _SHARED_LAST_LOCK:
            _SHARED_LAST.clear()

    def __init__(
        self,
        inner: Transport,
        min_interval_s: float = 1.0,
        *,
        clock=None,
        sleep_fn=None,
        shared: Optional[bool] = None,
        metrics=None,
    ) -> None:
        import time

        self.inner = inner
        self.min_interval_s = min_interval_s
        if shared is None:
            shared = clock is None
        self.clock = clock or time.monotonic
        self.sleep_fn = sleep_fn or time.sleep
        reg = metrics if metrics is not None else default_registry()
        self._m_waits = reg.counter("ingest_ratelimit_waits_total")
        self._m_wait_s = reg.counter("ingest_ratelimit_wait_seconds_total")
        if shared:
            self._last = _SHARED_LAST
            self._lock = _SHARED_LAST_LOCK
        else:
            self._last: Dict[str, float] = {}
            self._lock = threading.Lock()

    @staticmethod
    def _host(url: str) -> str:
        from urllib.parse import urlparse

        return urlparse(url).netloc or url

    def get(self, url: str, headers: Optional[Dict[str, str]] = None) -> bytes:
        host = self._host(url)
        # claim-then-sleep loop: the slot timestamp is written under the
        # lock, the sleep happens outside it (a 1 s wait must not block
        # other hosts' requests through the shared map), and the claim is
        # re-checked after sleeping in case another thread took it.  The
        # iteration bound only guards against a test double whose
        # sleep_fn never advances its clock.
        for _ in range(1000):
            with self._lock:
                now = self.clock()
                last = self._last.get(host)
                wait = (
                    0.0 if last is None
                    else self.min_interval_s - (now - last)
                )
                if wait <= 0:
                    self._last[host] = now
                    break
            self._m_waits.inc()
            self._m_wait_s.inc(wait)
            self.sleep_fn(wait)
        else:
            with self._lock:
                self._last[host] = self.clock()
        return self.inner.get(url, headers)


def live_transport(
    timeout_s: float = 20.0,
    user_agent: str = "fmda-tpu/0.1",
    *,
    attempts: int = 3,
    backoff_s: float = 1.0,
    min_interval_s: float = 1.0,
    breaker_threshold: int = 3,
    breaker_reset_s: float = 120.0,
) -> Transport:
    """The hardened default for live operation: stdlib HTTP behind
    per-host rate limiting behind jittered exponential-backoff retries
    behind a per-host circuit breaker.

    Worst-case wall per GET is bounded (attempts x timeout plus up to
    ``backoff_s * (2^attempts - 1)`` of sleep — ~69 s at the defaults),
    so a dead feed degrades to a logged :class:`TransportError` the
    session driver isolates per feed (:mod:`.session`), never a stuck
    tick loop — and after ``breaker_threshold`` consecutive dead ticks
    the breaker stops paying even that wall: the host fails instantly
    until its half-open probe succeeds.  Clients and scrapers construct
    this when not handed an explicit transport (tests inject
    replay/recording transports).
    """
    return CircuitBreakerTransport(
        RetryTransport(
            RateLimitTransport(
                UrllibTransport(timeout_s, user_agent),
                min_interval_s=min_interval_s,
            ),
            attempts=attempts,
            backoff_s=backoff_s,
        ),
        failure_threshold=breaker_threshold,
        reset_timeout_s=breaker_reset_s,
    )


class RecordingTransport:
    """Wrap a live transport and persist every response for later replay.

    Every response is kept, *in request order per URL* — a live session
    hits the same endpoints each tick with evolving bodies, and replaying
    the full sequence through :class:`ReplayTransport` reproduces the
    whole day.  Bodies are stored base64-encoded so binary/gzip responses
    survive the round-trip bit-exact.  The fixture file is rewritten every
    ``flush_every`` requests (and on :meth:`flush`/``close``/context exit),
    so a crash mid-session loses at most the last ``flush_every - 1``
    responses, not the whole recording.
    """

    def __init__(
        self, inner: Transport, path: str, flush_every: int = 25
    ) -> None:
        self.inner = inner
        self.path = path
        self.flush_every = max(1, flush_every)
        self.recorded: Dict[str, List[bytes]] = {}
        self._since_flush = 0

    def get(self, url: str, headers: Optional[Dict[str, str]] = None) -> bytes:
        body = self.inner.get(url, headers)
        self.recorded.setdefault(url, []).append(body)
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self.flush()
        return body

    def flush(self) -> None:
        # atomic tmp+replace: a crash inside a flush must never destroy
        # the previously flushed recording (the whole point of flushing
        # periodically). Full rewrite per flush is fine at session scale
        # (~400 requests a day at a 5-minute cadence).
        import base64

        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(
                {
                    u: [base64.b64encode(b).decode("ascii") for b in bodies]
                    for u, bodies in self.recorded.items()
                },
                fh,
            )
        os.replace(tmp, self.path)
        self._since_flush = 0

    close = flush

    def __enter__(self) -> "RecordingTransport":
        return self

    def __exit__(self, *exc) -> None:
        self.flush()

    @staticmethod
    def load_fixtures(path: str) -> Dict[str, List[bytes]]:
        """Read a recorded fixture file back into ReplayTransport form.

        Accepts both the sequential format this class writes and the
        legacy one-body-per-url form.
        """
        import base64

        with open(path) as fh:
            raw = json.load(fh)
        return {
            u: (
                [base64.b64decode(x) for x in s]
                if isinstance(s, list)
                else [base64.b64decode(s)]
            )
            for u, s in raw.items()
        }
