"""Kafka adapter: the port's engine and serving over real brokers, as
``fmda_tpu.stream.kafka_bus`` runs them.

``kafka-python`` is imported when a :class:`KafkaBus` is built, never at
import; without it the constructor raises and names the other buses.
Offsets are Kafka's own, partition 0 of each topic.  The wire stays JSON
text (the broker ecosystem's tools read text): arrays in a value ride as
the codec's tagged base64 and decode back to arrays on read, so the value
model is the other backends'.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

from fmda_tpu_torch.obs.trace import (
    default_tracer,
    stamp_message,
    stamp_messages,
)
from fmda_tpu_torch.stream import codec
from fmda_tpu_torch.stream.bus import Consumer, Record

_TRACER = default_tracer()


class KafkaBus:
    """MessageBus over kafka-python producers and consumers."""

    def __init__(self, topics: Iterable[str],
                 servers: Sequence[str] = ("localhost:9092",)) -> None:
        try:
            from kafka import (  # type: ignore
                KafkaConsumer,
                KafkaProducer,
                TopicPartition,
            )
        except ImportError as e:
            raise RuntimeError(
                "KafkaBus needs the 'kafka-python' package; use "
                "InProcessBus or NativeBus otherwise") from e
        self._TopicPartition = TopicPartition
        self._KafkaConsumer = KafkaConsumer
        self._topics = tuple(topics)
        self._servers = list(servers)
        self._producer = KafkaProducer(bootstrap_servers=self._servers,
                                       value_serializer=codec.dumps)
        # one metadata consumer, reused for offset queries
        self._meta = KafkaConsumer(bootstrap_servers=self._servers,
                                   group_id=None, enable_auto_commit=False)

    @classmethod
    def from_config(cls, bus_config) -> "KafkaBus":
        """A bus over ``bus_config.topics`` on ``bus_config.servers``."""
        return cls(bus_config.topics, servers=bus_config.servers)

    def _check(self, topic: str) -> None:
        if topic not in self._topics:
            raise KeyError(
                f"unknown topic {topic!r}; configured: {sorted(self._topics)}")

    def add_topic(self, topic: str) -> None:
        """Admit a topic after construction.  Brokers create a topic on
        its first produce, so this only widens the configured set."""
        if topic not in self._topics:
            self._topics = self._topics + (topic,)

    def publish(self, topic: str, value: dict) -> int:
        """Append a message; returns its offset (after the broker's ack)."""
        self._check(topic)
        if _TRACER.enabled:  # the in-band trace context
            value = stamp_message(value)
        return self._producer.send(topic, value=value).get(timeout=30).offset

    def publish_many(self, topic: str, values: Sequence[dict]) -> List[int]:
        """Append a batch: every send enters the producer's buffer before
        any ack is awaited, so the batch pays the round trip once.  A
        message without its own ``trace`` inherits the active context."""
        self._check(topic)
        if _TRACER.enabled:
            values = stamp_messages(values)
        futures = [self._producer.send(topic, value=v) for v in values]
        return [f.get(timeout=30).offset for f in futures]

    def read(self, topic: str, offset: int,
             max_records: Optional[int] = None) -> List[Record]:
        """Records with offsets >= ``offset``, read by a fresh consumer
        assigned to partition 0."""
        self._check(topic)
        tp = self._TopicPartition(topic, 0)
        consumer = self._KafkaConsumer(
            bootstrap_servers=self._servers, group_id=None,
            enable_auto_commit=False, value_deserializer=codec.loads)
        try:
            consumer.assign([tp])
            consumer.seek(tp, max(offset, 0))
            out: List[Record] = []
            while max_records is None or len(out) < max_records:
                records = consumer.poll(timeout_ms=500).get(tp, [])
                if not records:
                    break
                for r in records:
                    out.append(Record(topic, r.offset, r.value))
                    if max_records is not None and len(out) >= max_records:
                        break
            return out
        finally:
            consumer.close()

    def end_offset(self, topic: str) -> int:
        """The offset one past the last published record."""
        self._check(topic)
        tp = self._TopicPartition(topic, 0)
        return self._meta.end_offsets([tp])[tp]

    def topics(self) -> Sequence[str]:
        return self._topics

    def consumer(self, topic: str, *, from_end: bool = False) -> Consumer:
        c = Consumer(self, topic)
        if from_end:
            c.seek_to_end()
        return c
