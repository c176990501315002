"""Cross-process bus transport: a MessageBus served over TCP, as
``fmda_tpu.fleet.wire`` defines it.

The framework's local bus backends live inside one process (InProcessBus
is Python objects, NativeBus a C++ arena in process memory); Kafka is
the cross-process answer in production but demands an external broker.
This module is the framework-owned middle: the fleet **router** hosts
its bus (NativeBus when buildable, InProcessBus otherwise) and serves it
on a socket with :class:`BusServer`; every worker connects a
:class:`SocketBus` — the same :class:`~fmda_tpu_torch.stream.bus.MessageBus`
contract, so gateways/engines/consumers run unchanged over it.

Framing: every request and response is one length-prefixed frame —
4-byte big-endian length, then that many bytes of payload.  Since wire
format v2 (docs/multihost.md) a payload is either UTF-8 JSON **or** a
binary codec frame (:mod:`fmda_tpu_torch.stream.codec` — magic-byte-first, so
every receiver auto-detects per frame); clients negotiate the binary
format with a ``hello`` op at connect and fall back to JSON against a
server that does not (or is configured not to) speak it, so old and new
peers interoperate and ``wire_format=json`` is the rollback switch.  A
connection's requests are strictly serialized by the client (one lock
around request→response), and the server handles each connection on its
own thread against the thread-safe backing bus — so two processes
publishing concurrently can interleave *records* (fine: offsets stay
monotonic, each process's order is preserved) but never *frames* (a
torn frame would corrupt every later message on the connection; the
router↔worker transport contract test asserts both properties).

Error taxonomy (symmetric across formats): **transport** errors —
socket failures, EOF mid-frame, a length prefix past the frame limit —
kill the connection (``ConnectionError``); **decode** errors — a
well-framed payload that is not valid JSON or a valid codec frame —
surface as :class:`FrameDecodeError`, are counted
(``frames_malformed_total``), and leave the connection usable: the
frame was fully consumed, so framing alignment is intact and one
confused peer's message can no longer kill the link.

No torch anywhere near this module: a router host is a bus-only host.
Each side of a link may be this package or the reference's
(``fmda_tpu.fleet.wire``): the frames are the same.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from fmda_tpu_torch.chaos.inject import default_chaos
from fmda_tpu_torch.stream import codec
from fmda_tpu_torch.obs.trace import default_tracer, stamp_message, stamp_messages
from fmda_tpu_torch.stream.bus import Consumer, Record

log = logging.getLogger("fmda_tpu_torch.fleet")

_TRACER = default_tracer()
#: chaos injection (fmda_tpu_torch.chaos): disabled = one branch per request
_CHAOS = default_chaos()

#: Frame-size ceiling (4-byte length prefix allows 4 GiB; a frame this
#: large is a bug, not a batch).
MAX_FRAME_BYTES = 64 * 1024 * 1024

#: ``wire_format`` knob values (config ``[fleet] wire_format``):
#: ``auto`` negotiates binary and falls back, ``binary`` insists (still
#: falls back, loudly), ``json`` never negotiates — the rollback and
#: debug format.
WIRE_FORMATS = ("auto", "binary", "json")

_LEN = struct.Struct(">I")


class FrameDecodeError(RuntimeError):
    """A well-framed payload that failed to decode (not JSON, not a
    valid codec frame).  The frame was consumed whole, so the
    connection's framing alignment is intact — callers treat this as a
    lost *message* (counted), never a lost *link*."""


def _check_wire_format(wire_format: str) -> str:
    if wire_format not in WIRE_FORMATS:
        raise ValueError(
            f"wire_format {wire_format!r} not one of {WIRE_FORMATS}")
    return wire_format


class _FrameIO:
    """Buffered length-prefixed framing over one socket.

    Receives into a process-side buffer with large ``recv`` calls, so a
    frame costs O(frame/1MB) syscalls instead of one per header/body —
    where a syscall is slow, syscall count is the transport's latency
    budget.  One ``sendall`` per outgoing frame.

    Payloads are JSON text or binary codec frames; ``recv_frame``
    auto-detects per frame (``last_binary`` reports which) and
    ``counts`` tracks per-format frame totals plus malformed payloads.
    """

    __slots__ = ("sock", "_buf", "counts", "last_binary")

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self._buf = bytearray()
        self.counts: Dict[str, int] = {
            "binary": 0, "json": 0, "malformed": 0}
        #: format of the most recently decoded incoming frame
        self.last_binary = False

    def send_frame(self, obj: object, *, binary: bool = False) -> None:
        payload = codec.encode_payload(obj, binary=binary)
        if len(payload) > MAX_FRAME_BYTES:
            raise RuntimeError(
                f"frame of {len(payload)}B exceeds the {MAX_FRAME_BYTES}B "
                "transport limit")
        self.counts["binary" if binary else "json"] += 1
        self.sock.sendall(_LEN.pack(len(payload)) + payload)

    def _fill(self, need: int) -> bool:
        """Grow the buffer to ``need`` bytes; False on clean EOF with an
        empty buffer, raises on EOF mid-frame."""
        while len(self._buf) < need:
            chunk = self.sock.recv(1 << 20)
            if not chunk:
                if not self._buf:
                    return False
                raise ConnectionError(
                    f"peer closed mid-frame ({len(self._buf)}/{need} "
                    "bytes)")
            self._buf += chunk
        return True

    def recv_frame(self) -> Optional[object]:
        if not self._fill(_LEN.size):
            return None
        (length,) = _LEN.unpack(self._buf[:_LEN.size])
        if length > MAX_FRAME_BYTES:
            # transport-level: the framing itself cannot be trusted
            # past this point, so unlike a payload decode error this
            # DOES kill the connection
            raise ConnectionError(
                f"peer announced a {length}B frame (> {MAX_FRAME_BYTES}B "
                "limit) — stream corrupt or not speaking this protocol")
        total = _LEN.size + length
        if not self._fill(total):
            raise ConnectionError("peer closed between header and body")
        body = bytes(self._buf[_LEN.size:total])
        del self._buf[:total]
        # the frame is consumed whole BEFORE decoding: a malformed
        # payload costs one message, never the connection's alignment
        try:
            obj, was_binary = codec.decode_payload(body)
        except codec.CodecError as e:
            self.counts["malformed"] += 1
            raise FrameDecodeError(
                f"malformed {length}B frame: {e}") from e
        self.last_binary = was_binary
        self.counts["binary" if was_binary else "json"] += 1
        return obj


def parse_address(address: str) -> Tuple[str, int]:
    """``"host:port"`` -> (host, port); bare ``":port"`` means localhost."""
    host, sep, port = address.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(
            f"bus address {address!r} is not of the form host:port")
    return host or "127.0.0.1", int(port)


class BusServer:
    """Serves a backing MessageBus to SocketBus clients.

    One accept-loop thread plus one thread per connection; every op maps
    1:1 onto the backing bus's method, so the server adds transport, not
    semantics.  Op errors travel back as ``{"err", "kind"}`` frames and
    re-raise client-side; transport errors drop only the one connection;
    decode errors (a malformed frame from a confused peer) are counted
    and answered with an error frame — the connection survives.

    Responses mirror the request's format (a binary request gets a
    binary response) unless ``wire_format="json"`` pins everything to
    JSON; the ``hello`` op tells negotiating clients which formats this
    server will answer in.
    """

    def __init__(
        self, bus, *, host: str = "127.0.0.1", port: int = 0,
        wire_format: str = "auto",
    ) -> None:
        self.bus = bus
        self._host = host
        self._requested_port = port
        self._wire_format = _check_wire_format(wire_format)
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: set = set()
        self._ios: set = set()
        self._lock = threading.Lock()
        self._closing = False
        #: frame totals folded in from closed connections
        self._frame_totals: Dict[str, int] = {
            "binary": 0, "json": 0, "malformed": 0}

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "BusServer":
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((self._host, self._requested_port))
        listener.listen(64)
        self._listener = listener
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fmda-bus-server", daemon=True)
        self._accept_thread.start()
        log.info("bus server listening on %s:%d", self._host, self.port)
        return self

    @property
    def port(self) -> int:
        if self._listener is None:
            raise RuntimeError("server not started")
        return self._listener.getsockname()[1]

    @property
    def address(self) -> str:
        return f"{self._host}:{self.port}"

    def stop(self) -> None:
        self._closing = True
        if self._listener is not None:
            # shutdown BEFORE close: on Linux, closing an fd does not
            # wake a thread blocked in accept() on it (stop() used to
            # eat the full 5s join timeout per server — multiplied
            # across every test teardown and topology shutdown);
            # shutdown interrupts the accept with an error immediately
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:  # loss-free: teardown; close() follows
                pass  # some platforms refuse shutdown on a listener
            try:
                self._listener.close()
            except OSError:  # loss-free: teardown of a dead listener
                pass
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:  # loss-free: teardown; close() follows
                pass
            try:
                conn.close()
            except OSError:  # loss-free: teardown of a dying connection
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)

    def frame_stats(self) -> Dict[str, int]:
        """Frame totals across every connection this server ever had
        (live connections sampled in place) — ``binary``/``json``/
        ``malformed``, the server side of the obs counters."""
        with self._lock:
            out = dict(self._frame_totals)
            ios = list(self._ios)
        for io in ios:
            for k, v in io.counts.items():
                out[k] += v
        return out

    # -- the serve loops ----------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _addr = self._listener.accept()
            # loss-free: the listener died or stop() closed it — no
            # frame was in flight on the not-yet-accepted connection
            except OSError:
                return  # listener closed (stop)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.add(conn)
            threading.Thread(
                target=self._serve_client, args=(conn,),
                name="fmda-bus-client", daemon=True).start()

    def _serve_client(self, conn: socket.socket) -> None:
        io = _FrameIO(conn)
        with self._lock:
            self._ios.add(io)
        try:
            while True:
                try:
                    req = io.recv_frame()
                except FrameDecodeError as e:
                    # one malformed frame from a confused peer used to
                    # kill the whole link (it was caught with the
                    # transport errors); decode errors are now counted
                    # and answered — the connection survives
                    log.warning("malformed frame (connection kept): %s", e)
                    try:
                        io.send_frame({"err": str(e),
                                       "kind": "FrameDecodeError"})
                    # loss-free: the error answer failed — the peer is
                    # gone; the malformed frame itself was already
                    # counted (frames_malformed_total) in recv_frame
                    except (OSError, RuntimeError):
                        return
                    continue
                # loss-free: transport death ends the connection; every
                # client hardens against it (link_errors / bus_errors
                # are counted by the owner that loses the link)
                except (ConnectionError, OSError):
                    return
                if req is None:
                    return  # clean disconnect
                # respond in the request's format: binary for binary
                # peers, JSON for JSON peers and hand-crafted debug
                # frames — unless this server is pinned to JSON
                binary = io.last_binary and self._wire_format != "json"
                resp = self._respond(req)
                try:
                    io.send_frame(resp, binary=binary)
                except codec.CodecError:
                    # a response value the negotiated format cannot
                    # carry — answer with an error frame instead of
                    # killing the link
                    try:
                        io.send_frame({"err": "unencodable response",
                                       "kind": "FrameDecodeError"})
                    # loss-free: peer gone mid-apology — the op already
                    # executed; the client re-counts on its side
                    except (OSError, RuntimeError):
                        return
                # loss-free: transport death; the client's request
                # raises ConnectionError and its owner counts the loss
                except (OSError, RuntimeError):
                    return
        finally:
            with self._lock:
                self._conns.discard(conn)
                self._ios.discard(io)
                for k, v in io.counts.items():
                    self._frame_totals[k] += v
            try:
                conn.close()
            except OSError:  # loss-free: teardown of a finished connection
                pass

    def _respond(self, req: dict) -> dict:
        try:
            return {"ok": self._dispatch(req)}
        # loss-free: nothing is swallowed by either handler — the
        # failure is converted to an err frame and re-raised client-side
        # by SocketBus._unwrap
        except KeyError as e:
            return {"err": str(e), "kind": "KeyError"}
        except Exception as e:  # noqa: BLE001 — loss-free: op failure is
            # the client's problem (re-raised there); the connection
            # stays usable
            return {"err": f"{e!r}", "kind": type(e).__name__}

    def _dispatch(self, req: dict) -> object:
        op = req.get("op")
        bus = self.bus
        if op == "batch":
            # several ops, one frame, one round trip: on high-syscall-
            # latency hosts the RT count — not bytes or CPU — is the
            # throughput ceiling, so router pumps and worker steps ride
            # one frame each.  Sub-ops run in order; each fails alone.
            return [self._respond(sub) for sub in req["ops"]]
        if op == "publish":
            return bus.publish(req["topic"], req["value"])
        if op == "publish_many":
            return bus.publish_many(req["topic"], req["values"])
        if op == "read":
            records = bus.read(
                req["topic"], int(req["offset"]), req.get("max_records"))
            return [[r.offset, r.value] for r in records]
        if op == "end_offset":
            return bus.end_offset(req["topic"])
        if op == "add_topic":
            add = getattr(bus, "add_topic", None)
            if add is None:
                raise RuntimeError(
                    f"backing bus {type(bus).__name__} cannot create "
                    f"topic {req['topic']!r} dynamically")
            add(req["topic"])
            return True
        if op == "base_offset":
            base = getattr(bus, "base_offset", None)
            return base(req["topic"]) if base is not None else 0
        if op == "topics":
            return list(bus.topics())
        if op == "ping":
            return "pong"
        if op == "hello":
            # wire-format negotiation (v2): the client lists the formats
            # it speaks; the server picks.  Old servers answer this op
            # with an unknown-op error, which the client reads as "JSON
            # only" — old and new peers interoperate either way.
            formats = req.get("formats") or ()
            chosen = ("binary" if self._wire_format != "json"
                      and "binary" in formats else "json")
            return {"format": chosen, "version": codec.CODEC_VERSION}
        raise RuntimeError(f"unknown bus op {op!r}")


class SocketBus:
    """MessageBus client over one BusServer connection.

    Same contract as InProcessBus/NativeBus/KafkaBus — topics, monotonic
    offsets, independent consumers — with each call one request/response
    round trip (reads are batched server-side, so a backlogged consumer
    drains hundreds of records per round trip).  Thread-safe: a lock
    serializes frames on the connection.  No auto-reconnect — a broken
    connection raises, and the owner (worker loop) decides whether that
    is fatal (it is: a worker that lost its router must stop serving).

    ``wire_format`` selects the frame encoding: ``auto`` (default)
    negotiates the binary codec via a ``hello`` op and falls back to
    JSON against a server that does not offer it; ``binary`` does the
    same but logs the fallback as a warning; ``json`` skips negotiation
    entirely (the rollback switch — docs/multihost.md "Wire format v2").
    ``negotiated_format`` reports the outcome.
    """

    def __init__(
        self, host: str, port: int, *, timeout_s: Optional[float] = 60.0,
        wire_format: str = "auto",
    ) -> None:
        wire_format = _check_wire_format(wire_format)
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._io = _FrameIO(self._sock)
        self._lock = threading.Lock()
        self._topics: Optional[Tuple[str, ...]] = None
        self._publish_counters = None
        self._consumed_cb = None
        self.address = f"{host}:{port}"
        self._binary = False
        self.negotiated_format = "json"
        if wire_format != "json":
            self._negotiate(wire_format)

    @classmethod
    def connect(cls, address: str, **kwargs) -> "SocketBus":
        host, port = parse_address(address)
        return cls(host, port, **kwargs)

    def _negotiate(self, wire_format: str) -> None:
        """One ``hello`` round trip at connect: switch the connection to
        binary frames when the server offers them, JSON otherwise.
        Transport failures propagate (the connection is unusable); an
        op-level error means an old server — fall back silently on
        ``auto``, loudly on ``binary``."""
        try:
            resp = self._request({
                "op": "hello",
                "formats": ["binary", "json"],
                "version": codec.CODEC_VERSION,
            })
        except (ConnectionError, OSError):
            raise
        # loss-free: negotiation fallback — the connection continues on
        # JSON frames, no message existed yet to lose
        except (RuntimeError, KeyError):
            resp = None  # pre-v2 server: unknown op
        if isinstance(resp, dict) and resp.get("format") == "binary":
            self._binary = True
            self.negotiated_format = "binary"
        elif wire_format == "binary":
            log.warning(
                "bus server at %s does not speak the binary wire format "
                "— falling back to JSON frames", self.address)

    def close(self) -> None:
        with self._lock:
            try:
                self._sock.close()
            except OSError:  # loss-free: teardown of a dead socket
                pass

    def __enter__(self) -> "SocketBus":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def frame_stats(self) -> Dict[str, int]:
        """This connection's ``binary``/``json``/``malformed`` frame
        totals (the client side of the obs counters)."""
        return dict(self._io.counts)

    def bind_metrics(self, registry) -> None:
        """Same per-topic publish/consume counters as the other
        backends, counted client-side, plus the wire-format series:
        ``frames_binary_total``/``frames_json_total``/
        ``frames_malformed_total`` and the negotiated-format gauge
        ``wire_format_binary`` (1 = binary frames on this link)."""
        #: remembered so the owner can re-bind a REPLACEMENT connection
        #: to the same registry (worker control re-dial): the "wire"
        #: collector registration replaces the old one by name, so the
        #: series follow the live link instead of freezing on the dead
        self.metrics_registry = registry
        topics = self.topics()
        self._publish_counters = {
            t: registry.counter("bus_published_total", topic=t)
            for t in topics
        }
        consume_counters = {
            t: registry.counter("bus_consumed_total", topic=t)
            for t in topics
        }
        self._consumed_cb = (
            lambda topic, n: consume_counters[topic].inc(n)
        )

        def wire_families():
            counts = self.frame_stats()
            return {
                "counters": [
                    {"name": "frames_binary_total", "labels": {},
                     "value": counts["binary"]},
                    {"name": "frames_json_total", "labels": {},
                     "value": counts["json"]},
                    {"name": "frames_malformed_total", "labels": {},
                     "value": counts["malformed"]},
                ],
                "gauges": [
                    {"name": "wire_format_binary", "labels": {},
                     "value": 1.0 if self._binary else 0.0},
                ],
            }

        registry.register_collector("wire", wire_families)

    # -- request plumbing ---------------------------------------------------

    def _request(self, req: dict) -> object:
        if _CHAOS.enabled:
            # injection point "wire.request": a kill/partition window
            # raises ChaosFault (a ConnectionError — exactly the failure
            # every caller already hardens against); delay windows sleep
            _CHAOS.check("wire.request")
        with self._lock:
            try:
                self._io.send_frame(req, binary=self._binary)
                resp = self._io.recv_frame()
            except OSError as e:
                raise ConnectionError(
                    f"bus connection to {self.address} failed: {e}") from e
        if resp is None:
            raise ConnectionError(
                f"bus server at {self.address} closed the connection")
        return self._unwrap(req, resp)

    @staticmethod
    def _unwrap(req: dict, resp: dict) -> object:
        if "err" in resp:
            if resp.get("kind") == "KeyError":
                raise KeyError(resp["err"])
            raise RuntimeError(
                f"bus op {req.get('op')!r} failed remotely: {resp['err']}")
        return resp["ok"]

    def batch(self, ops: List[dict]) -> List[dict]:
        """Execute several ops in order in ONE round trip; returns the
        raw per-op ``{"ok": ...}`` / ``{"err", "kind"}`` dicts (each op
        fails alone — callers unwrap with :meth:`unwrap_op`).  The
        round-trip count is the transport's real cost on high-syscall-
        latency hosts, so hot loops bundle their whole cycle here."""
        if not ops:
            return []
        return self._request({"op": "batch", "ops": ops})

    def unwrap_op(self, op: dict, resp: dict) -> object:
        return self._unwrap(op, resp)

    # -- MessageBus ---------------------------------------------------------

    def publish(self, topic: str, value: dict) -> int:
        if _TRACER.enabled:  # in-band trace context, like every backend
            value = stamp_message(value)
        offset = self._request(
            {"op": "publish", "topic": topic, "value": value})
        if self._publish_counters is not None:
            counter = self._publish_counters.get(topic)
            if counter is not None:
                counter.inc()
        return int(offset)

    def publish_many(self, topic: str, values) -> List[int]:
        values = list(values)
        if not values:
            return []
        if _TRACER.enabled:
            values = stamp_messages(values)
        offsets = self._request(
            {"op": "publish_many", "topic": topic, "values": values})
        if self._publish_counters is not None and offsets:
            counter = self._publish_counters.get(topic)
            if counter is not None:
                counter.inc(len(offsets))
        return [int(o) for o in offsets]

    def read(
        self, topic: str, offset: int, max_records: Optional[int] = None
    ) -> List[Record]:
        rows = self._request({
            "op": "read", "topic": topic, "offset": int(offset),
            "max_records": max_records,
        })
        return [Record(topic, int(o), v) for o, v in rows]

    def end_offset(self, topic: str) -> int:
        return int(self._request({"op": "end_offset", "topic": topic}))

    def base_offset(self, topic: str) -> int:
        return int(self._request({"op": "base_offset", "topic": topic}))

    def add_topic(self, topic: str) -> None:
        """Create a topic on the served bus (idempotent; raises if the
        backing bus cannot create topics dynamically)."""
        self._request({"op": "add_topic", "topic": topic})
        self._topics = None  # the cached layout just changed

    def topics(self) -> Sequence[str]:
        if self._topics is None:
            self._topics = tuple(self._request({"op": "topics"}))
        return self._topics

    def consumer(self, topic: str, *, from_end: bool = False) -> Consumer:
        c = Consumer(self, topic)
        if from_end:
            c.seek_to_end()
        return c

    def ping(self) -> bool:
        return self._request({"op": "ping"}) == "pong"


class BufferedPublisher:
    """A publish-only bus front that coalesces into batch ops.

    The fleet worker's gateway publishes one ``publish_many`` per flush
    and its heartbeater one ``publish`` per beat; over a SocketBus each
    would be its own round trip.  This buffer queues them (preserving
    call order) and the worker's step flushes everything — plus its
    inbox read — in one batched frame.  Same ``publish``/
    ``publish_many``/``topics`` surface the gateway already speaks, so
    it drops in unchanged.  Values are queued as-is — pre-encoded
    column blocks and raw arrays included — and encoded exactly once,
    when the batched frame leaves on the negotiated wire format.
    """

    def __init__(self, bus: SocketBus) -> None:
        self._bus = bus
        #: (topic, [values]) in call order — order across topics is
        #: preserved (the migration protocol publishes results BEFORE
        #: the exported state; the broker must apply them that way)
        self._pending: List[Tuple[str, List[dict]]] = []

    def topics(self) -> Sequence[str]:
        return self._bus.topics()

    def publish(self, topic: str, value: dict) -> None:
        if _TRACER.enabled:
            value = stamp_message(value)
        self._pending.append((topic, [value]))

    def publish_many(self, topic: str, values) -> None:
        values = list(values)
        if not values:
            return
        if _TRACER.enabled:
            values = stamp_messages(values)
        self._pending.append((topic, values))

    @property
    def pending(self) -> int:
        return sum(len(v) for _, v in self._pending)

    def take_ops(self) -> List[dict]:
        """Drain the buffer into batch ops (coalescing consecutive
        same-topic entries into one publish_many)."""
        ops: List[dict] = []
        for topic, values in self._pending:
            if ops and ops[-1]["topic"] == topic:
                ops[-1]["values"].extend(values)
            else:
                ops.append({"op": "publish_many", "topic": topic,
                            "values": list(values)})
        self._pending.clear()
        return ops

    def flush(self) -> None:
        """Publish everything buffered in one round trip (shutdown and
        migration-export paths call this directly)."""
        ops = self.take_ops()
        for op, resp in zip(ops, self._bus.batch(ops)):
            self._bus.unwrap_op(op, resp)
