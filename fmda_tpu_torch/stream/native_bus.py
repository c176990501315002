"""The native C++ ring-buffer bus (``native/ringbus.cpp``) through ctypes,
as ``fmda_tpu.stream.native_bus`` binds it.

:class:`NativeBus` keeps the :class:`~fmda_tpu_torch.stream.bus.MessageBus`
contract of :class:`~fmda_tpu_torch.stream.bus.InProcessBus`: topics,
monotonic offsets, independent consumers, bounded retention (by record
count and by arena bytes), ``add_topic``.  The C++ log stores opaque
length-prefixed blobs: a value that carries an array is a binary codec
frame, any other value JSON text; a reader tells them apart by the
codec's magic byte.  The library builds on demand
(:mod:`fmda_tpu_torch.stream._native`); without a compiler
:func:`native_available` is False and callers fall back to the Python bus.
"""

from __future__ import annotations

import ctypes
from typing import Iterable, List, Optional, Sequence

from fmda_tpu_torch.obs.trace import (
    default_tracer,
    stamp_message,
    stamp_messages,
)
from fmda_tpu_torch.stream import codec
from fmda_tpu_torch.stream._native import build_and_load
from fmda_tpu_torch.stream.bus import Consumer, Record, consume_counter

_TRACER = default_tracer()


class NativeBusUnavailable(RuntimeError):
    pass


def _load_library() -> ctypes.CDLL:
    lib = build_and_load("libringbus.so", NativeBusUnavailable)
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    lib.rb_topic.restype = ctypes.c_int64
    lib.rb_topic.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rb_publish.restype = ctypes.c_int64
    lib.rb_publish.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
    ]
    lib.rb_read.restype = ctypes.c_int64
    lib.rb_read.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int64,
    ]
    lib.rb_end_offset.restype = ctypes.c_int64
    lib.rb_end_offset.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.rb_base_offset.restype = ctypes.c_int64
    lib.rb_base_offset.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    return lib


_lib: Optional[ctypes.CDLL] = None


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _load_library()
    return _lib


def native_available() -> bool:
    """Whether the ring bus builds and loads here (a capability probe)."""
    try:
        _get_lib()
        return True
    except NativeBusUnavailable:  # loss-free: a capability probe
        return False


class NativeBus:
    """MessageBus over the C++ topic log."""

    READ_CHUNK = 256
    READ_BUF_BYTES = 1 << 20

    def __init__(self, topics: Iterable[str], arena_bytes: int = 1 << 22,
                 max_records: int = 1 << 16) -> None:
        self._lib = _get_lib()
        self._handle = self._lib.rb_create(arena_bytes, max_records)
        if not self._handle:
            raise NativeBusUnavailable("rb_create failed")
        self._topic_ids = {}
        for name in topics:
            self._register(name)
        #: publish counters and the consume callback, set by
        #: :meth:`bind_metrics`; the C++ log itself counts nothing
        self._publish_counters = None
        self._consumed_cb = None
        self._metrics_registry = None

    def _register(self, topic: str) -> None:
        tid = self._lib.rb_topic(self._handle, topic.encode())
        if tid < 0:
            raise NativeBusUnavailable(f"rb_topic({topic!r}) failed")
        self._topic_ids[topic] = tid

    def add_topic(self, topic: str) -> None:
        """Create a topic after construction; an existing topic keeps its
        log and offsets (the C++ side registers or looks up under its own
        mutex)."""
        if topic in self._topic_ids:
            return
        self._register(topic)
        if self._publish_counters is not None:
            self._publish_counters[topic] = self._metrics_registry.counter(
                "bus_published_total", topic=topic)

    def bind_metrics(self, registry) -> None:
        """The per-topic ``bus_published_total`` and ``bus_consumed_total``
        counters of :meth:`InProcessBus.bind_metrics`, counted in this
        wrapper: writers through another handle are not seen."""
        self._metrics_registry = registry
        self._publish_counters = {
            t: registry.counter("bus_published_total", topic=t)
            for t in self._topic_ids}
        self._consumed_cb = consume_counter(registry, self._topic_ids)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.rb_destroy(handle)
            self._handle = None

    def _tid(self, topic: str) -> int:
        if topic not in self._topic_ids:
            raise KeyError(
                f"unknown topic {topic!r}; configured: "
                f"{sorted(self._topic_ids)}")
        return self._topic_ids[topic]

    # -- MessageBus ----------------------------------------------------------

    def _publish_one(self, tid: int, topic: str, value: dict) -> int:
        """Encode, size-check and append one record (the counter bumps
        stay with the callers, so a batch counts once)."""
        payload = codec.encode_payload(
            value, binary=codec.contains_array(value))
        if len(payload) > self.READ_BUF_BYTES:
            # a record the read buffer can never return would wedge its
            # consumers: refuse it at the door
            raise RuntimeError(
                f"record of {len(payload)}B exceeds the bus record limit "
                f"({self.READ_BUF_BYTES}B)")
        buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
        offset = self._lib.rb_publish(self._handle, tid, buf, len(payload))
        if offset < 0:
            raise RuntimeError(
                f"publish to {topic!r} failed (record {len(payload)}B too "
                "large for the arena?)")
        return offset

    def publish(self, topic: str, value: dict) -> int:
        """Append a message; returns its offset."""
        if _TRACER.enabled:  # the in-band trace context
            value = stamp_message(value)
        offset = self._publish_one(self._tid(topic), topic, value)
        if self._publish_counters is not None:
            self._publish_counters[topic].inc()
        return offset

    def publish_many(self, topic: str, values: Sequence[dict]) -> List[int]:
        """Append a batch in order; returns the offsets.  A message that
        carries its own ``trace`` keeps it; the others inherit the active
        context."""
        if _TRACER.enabled:
            values = stamp_messages(values)
        tid = self._tid(topic)
        offsets = [self._publish_one(tid, topic, v) for v in values]
        if self._publish_counters is not None and offsets:
            self._publish_counters[topic].inc(len(offsets))
        return offsets

    def read(self, topic: str, offset: int,
             max_records: Optional[int] = None) -> List[Record]:
        """Records with offsets >= ``offset`` (bounded by retention)."""
        tid = self._tid(topic)
        out: List[Record] = []
        remaining = max_records
        cursor = max(offset, 0)
        buf = (ctypes.c_uint8 * self.READ_BUF_BYTES)()
        offsets = (ctypes.c_uint64 * self.READ_CHUNK)()
        lengths = (ctypes.c_uint32 * self.READ_CHUNK)()
        while True:
            chunk = self.READ_CHUNK if remaining is None else min(
                self.READ_CHUNK, remaining)
            if chunk <= 0:
                break
            # the end snapshot comes BEFORE the read: when the read then
            # returns nothing while a retained record sits at the cursor,
            # that record predates the read and did not fit the buffer
            end_snapshot = self.end_offset(topic)
            n = self._lib.rb_read(self._handle, tid, cursor, buf,
                                  self.READ_BUF_BYTES, offsets, lengths,
                                  chunk)
            if n < 0:
                raise RuntimeError(f"rb_read failed on {topic!r}")
            if n == 0:
                if cursor < end_snapshot and cursor >= self.base_offset(topic):
                    raise RuntimeError(
                        f"record at {topic!r} offset {cursor} exceeds the "
                        f"read buffer ({self.READ_BUF_BYTES}B)")
                break
            pos = 0
            for i in range(n):
                raw = bytes(buf[pos:pos + lengths[i]])
                pos += lengths[i]
                out.append(Record(topic, int(offsets[i]),
                                  codec.decode_payload(raw)[0]))
            cursor = int(offsets[n - 1]) + 1
            if remaining is not None:
                remaining -= n
                if remaining <= 0:
                    break
            # n < chunk is not the log's end: the read also stops when the
            # byte buffer fills, so loop until a read returns nothing
        return out

    def end_offset(self, topic: str) -> int:
        """The offset one past the last published record."""
        return int(self._lib.rb_end_offset(self._handle, self._tid(topic)))

    def base_offset(self, topic: str) -> int:
        """The oldest retained record's offset."""
        return int(self._lib.rb_base_offset(self._handle, self._tid(topic)))

    def topics(self) -> Sequence[str]:
        return tuple(self._topic_ids)

    def consumer(self, topic: str, *, from_end: bool = False) -> Consumer:
        c = Consumer(self, topic)
        if from_end:
            c.seek_to_end()
        return c
