"""A minimal in-process message bus: append-only topics, monotonically
increasing offsets, independent consumer positions, and per-topic ring
retention.  Values are copied on publish, as a broker would decouple them
from the caller."""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional


@dataclass(frozen=True)
class Record:
    """One message on a topic."""

    topic: str
    offset: int
    value: dict


class Consumer:
    """A positioned reader of one topic."""

    def __init__(self, bus: "InProcessBus", topic: str, offset: int = 0) -> None:
        self._bus = bus
        self.topic = topic
        self.offset = offset

    def poll(self, max_records: Optional[int] = None) -> List[Record]:
        records = self._bus.read(self.topic, self.offset, max_records)
        if records:
            self.offset = records[-1].offset + 1
        return records

    def seek_to_end(self) -> None:
        self.offset = self._bus.end_offset(self.topic)


class InProcessBus:
    """Thread-safe in-process bus with per-topic ring retention."""

    def __init__(self, topics: Iterable[str], capacity: int = 1 << 16) -> None:
        self._capacity = capacity
        self._lock = threading.Lock()
        self._logs: Dict[str, List[Record]] = {t: [] for t in topics}
        self._base: Dict[str, int] = {t: 0 for t in self._logs}
        self._next: Dict[str, int] = {t: 0 for t in self._logs}

    def _check_topic(self, topic: str) -> None:
        if topic not in self._logs:
            raise KeyError(
                f"unknown topic {topic!r}; configured: {sorted(self._logs)}")

    def publish(self, topic: str, value: dict) -> int:
        """Append a message; returns its offset."""
        value = copy.deepcopy(value)
        with self._lock:
            self._check_topic(topic)
            offset = self._next[topic]
            self._next[topic] = offset + 1
            log = self._logs[topic]
            log.append(Record(topic, offset, value))
            if len(log) > self._capacity:  # retention: drop the oldest
                drop = len(log) - self._capacity
                del log[:drop]
                self._base[topic] += drop
        return offset

    def read(self, topic: str, offset: int,
             max_records: Optional[int] = None) -> List[Record]:
        """Records with offsets >= ``offset`` (bounded by retention)."""
        with self._lock:
            self._check_topic(topic)
            start = max(offset - self._base[topic], 0)
            log = self._logs[topic]
            stop = len(log) if max_records is None else start + max_records
            return log[start:stop]

    def end_offset(self, topic: str) -> int:
        with self._lock:
            self._check_topic(topic)
            return self._next[topic]

    def consumer(self, topic: str, *, from_end: bool = False) -> Consumer:
        c = Consumer(self, topic)
        if from_end:
            c.seek_to_end()
        return c
