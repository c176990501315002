"""A minimal in-process message bus: append-only topics, monotonically
increasing offsets, independent consumer positions, and per-topic ring
retention.  Values are copied on publish (:func:`~fmda_tpu_torch.stream.
codec.wire_copy`: containers copied, arrays passed through as immutable),
as a broker would decouple them from the caller, and a value the wire
could not carry is refused.

When the process tracer (:mod:`fmda_tpu_torch.obs.trace`) is enabled, a
publish under an active trace stamps the message with the trace's
in-band ``trace`` field and records a ``bus_publish`` span; consumers
read the context back from ``record.value.get("trace")``.  With tracing
disabled the publish path pays one branch.  :meth:`InProcessBus.
bind_metrics` counts publishes and consumer reads per topic.

The other backends keep the same contract: the C++ ring bus
(:mod:`~fmda_tpu_torch.stream.native_bus`) and the Kafka adapter
(:mod:`~fmda_tpu_torch.stream.kafka_bus`)."""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Protocol, Sequence

from fmda_tpu_torch.obs.trace import (
    default_tracer,
    stamp_message,
    stamp_messages,
)
from fmda_tpu_torch.stream import codec

#: Captured once: configure_tracing mutates this singleton in place.
_TRACER = default_tracer()


@dataclass(frozen=True)
class Record:
    """One message on a topic."""

    topic: str
    offset: int
    value: dict


class Consumer:
    """A positioned reader of one topic."""

    def __init__(self, bus: "MessageBus", topic: str, offset: int = 0) -> None:
        self._bus = bus
        self.topic = topic
        self.offset = offset

    def poll(self, max_records: Optional[int] = None) -> List[Record]:
        records = self._bus.read(self.topic, self.offset, max_records)
        if records:
            self.offset = records[-1].offset + 1
            # consume accounting on a bus with bound metrics
            consumed = getattr(self._bus, "_consumed_cb", None)
            if consumed is not None:
                consumed(self.topic, len(records))
        return records

    def seek(self, offset: int) -> None:
        self.offset = offset

    def seek_to_end(self) -> None:
        self.offset = self._bus.end_offset(self.topic)


def consume_counter(registry, topics: Iterable[str]):
    """The ``consumed(topic, n)`` callback a bus's consumers report to:
    ``bus_consumed_total`` per topic in ``registry``, a topic added later
    counted from its first read."""
    counters = {t: registry.counter("bus_consumed_total", topic=t)
                for t in topics}

    def consumed(topic: str, n: int) -> None:
        counter = counters.get(topic)
        if counter is None:
            counter = counters[topic] = registry.counter(
                "bus_consumed_total", topic=topic)
        counter.inc(n)

    return consumed


class MessageBus(Protocol):
    """The topic transport contract every bus backend keeps."""

    def publish(self, topic: str, value: dict) -> int:
        """Append a message; returns its offset."""
        ...

    def publish_many(self, topic: str, values: Sequence[dict]) -> List[int]:
        """Append a batch of messages in order; returns their offsets."""
        ...

    def read(self, topic: str, offset: int,
             max_records: Optional[int] = None) -> List[Record]:
        """Records with offsets >= ``offset`` (bounded by retention)."""
        ...

    def end_offset(self, topic: str) -> int:
        """The offset one past the last published record."""
        ...

    def topics(self) -> Sequence[str]:
        ...

    def consumer(self, topic: str, *, from_end: bool = False) -> Consumer:
        ...


class InProcessBus:
    """Thread-safe in-process bus with per-topic ring retention."""

    def __init__(self, topics: Iterable[str], capacity: int = 1 << 16) -> None:
        self._capacity = capacity
        self._lock = threading.Lock()
        self._logs: Dict[str, List[Record]] = {t: [] for t in topics}
        self._base: Dict[str, int] = {t: 0 for t in self._logs}
        self._next: Dict[str, int] = {t: 0 for t in self._logs}
        #: per-topic publish counters and the consume callback, set by
        #: :meth:`bind_metrics`; None: uncounted
        self._publish_counters = None
        self._consumed_cb = None
        self._metrics_registry = None

    def bind_metrics(self, registry) -> None:
        """Count publishes and consumer reads per topic in ``registry``
        (``bus_published_total``, ``bus_consumed_total``).  The counters
        are made here, once; a topic added later gets its own on first
        touch."""
        self._metrics_registry = registry
        with self._lock:
            topics = tuple(self._logs)
        self._publish_counters = {
            t: registry.counter("bus_published_total", topic=t)
            for t in topics}
        self._consumed_cb = consume_counter(registry, topics)

    def _count_published(self, topic: str, n: int) -> None:
        counters = self._publish_counters
        if counters is None:
            return
        counter = counters.get(topic)
        if counter is None:
            counter = counters[topic] = self._metrics_registry.counter(
                "bus_published_total", topic=topic)
        counter.inc(n)

    def _check_topic_locked(self, topic: str) -> None:
        """Caller holds ``self._lock``."""
        if topic not in self._logs:
            raise KeyError(
                f"unknown topic {topic!r}; configured: {sorted(self._logs)}")

    def topics(self) -> List[str]:
        """The configured topics."""
        with self._lock:
            return list(self._logs)

    def add_topic(self, topic: str) -> None:
        """Create a topic after construction; an existing topic keeps its
        log and offsets."""
        with self._lock:
            if topic not in self._logs:
                self._logs[topic] = []
                self._base[topic] = 0
                self._next[topic] = 0

    def publish(self, topic: str, value: dict) -> int:
        """Append a message; returns its offset."""
        if _TRACER.enabled:  # in-band trace context + a bus-stage span
            value = stamp_message(value)
            with _TRACER.span("bus_publish", "bus"):
                return self._append(topic, [codec.wire_copy(value)])[0]
        return self._append(topic, [codec.wire_copy(value)])[0]

    def publish_many(self, topic: str, values: Sequence[dict]) -> List[int]:
        """Append a batch of messages in order under one lock; returns
        their offsets (``[publish(topic, v) for v in values]``, once).
        A message that carries its own ``trace`` keeps it; the others
        inherit the active context."""
        if _TRACER.enabled:
            values = stamp_messages(values)
        values = [codec.wire_copy(v) for v in values]
        return self._append(topic, values) if values else []

    def _append(self, topic: str, values: List[dict]) -> List[int]:
        with self._lock:
            self._check_topic_locked(topic)
            log = self._logs[topic]
            first = self._next[topic]
            log.extend(Record(topic, first + i, value)
                       for i, value in enumerate(values))
            self._next[topic] = first + len(values)
            if len(log) > self._capacity:  # retention: drop the oldest
                drop = len(log) - self._capacity
                del log[:drop]
                self._base[topic] += drop
        self._count_published(topic, len(values))
        return list(range(first, first + len(values)))

    def read(self, topic: str, offset: int,
             max_records: Optional[int] = None) -> List[Record]:
        """Records with offsets >= ``offset`` (bounded by retention)."""
        with self._lock:
            self._check_topic_locked(topic)
            start = max(offset - self._base[topic], 0)
            log = self._logs[topic]
            stop = len(log) if max_records is None else start + max_records
            return log[start:stop]

    def end_offset(self, topic: str) -> int:
        with self._lock:
            self._check_topic_locked(topic)
            return self._next[topic]

    def consumer(self, topic: str, *, from_end: bool = False) -> Consumer:
        c = Consumer(self, topic)
        if from_end:
            c.seek_to_end()
        return c
