"""Opt-in chaos proxies for the bus and warehouse, as
``fmda_tpu.chaos.wrap`` defines them.

Unlike the compiled-in injection points (which pay one guarded branch
everywhere, forever), these wrappers exist only when a chaos harness
constructs them around a component — production code never sees them,
so the disabled-cost question doesn't even arise.

:class:`ChaosBus` keeps the full :class:`~fmda_tpu_torch.stream.bus.MessageBus`
contract (a gateway/engine/router runs over it unchanged); every op
first consults the runtime for the wrapper's target (default ``bus``) —
a ``kill`` window makes the bus raise :class:`~fmda_tpu_torch.chaos.inject
.ChaosFault` (a ``ConnectionError``), a ``corrupt`` window replaces
published payloads with a marker dict the consumer must count.
:class:`ChaosWarehouse` guards every public method of a warehouse the
same way (the batched Predictor's gather path is the consumer that must
degrade counted, not abort).

Router-role code: no torch.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from fmda_tpu_torch.chaos.inject import ChaosRuntime, default_chaos
from fmda_tpu_torch.stream.bus import Consumer, Record


class ChaosBus:
    """MessageBus proxy evaluating the chaos runtime on every op."""

    def __init__(
        self, bus, point: str = "bus",
        chaos: Optional[ChaosRuntime] = None,
    ) -> None:
        self._bus = bus
        self._point = point
        self._chaos = chaos if chaos is not None else default_chaos()

    def _gate(self) -> None:
        c = self._chaos
        if c.enabled:
            c.check(self._point)

    # -- MessageBus ---------------------------------------------------------

    def publish(self, topic: str, value: dict) -> int:
        c = self._chaos
        if c.enabled:
            c.check(self._point)
            value = c.corrupt_value(self._point, value)
        return self._bus.publish(topic, value)

    def publish_many(self, topic: str, values) -> List[int]:
        c = self._chaos
        if c.enabled:
            c.check(self._point)
            values = [c.corrupt_value(self._point, v) for v in values]
        return self._bus.publish_many(topic, values)

    def read(
        self, topic: str, offset: int, max_records: Optional[int] = None
    ) -> List[Record]:
        self._gate()
        return self._bus.read(topic, offset, max_records)

    def end_offset(self, topic: str) -> int:
        self._gate()
        return self._bus.end_offset(topic)

    def base_offset(self, topic: str) -> int:
        self._gate()
        base = getattr(self._bus, "base_offset", None)
        return base(topic) if base is not None else 0

    def add_topic(self, topic: str) -> None:
        self._gate()
        add = getattr(self._bus, "add_topic", None)
        if add is None:
            raise KeyError(
                f"backing bus {type(self._bus).__name__} cannot create "
                f"topic {topic!r} dynamically")
        add(topic)

    def topics(self) -> Sequence[str]:
        # deliberately ungated: topology introspection (health checks,
        # gateway construction) should see the configured layout even
        # while the data path is down
        return self._bus.topics()

    def consumer(self, topic: str, *, from_end: bool = False) -> Consumer:
        c = Consumer(self, topic)
        if from_end:
            c.seek_to_end()
        return c


class ChaosWarehouse:
    """Warehouse proxy: every public method gated on the chaos runtime.

    ``__getattr__`` delegation keeps this in lockstep with whatever
    surface the backing warehouse grows; dunder lookups (``len``) bypass
    ``__getattr__``, so the ones consumers use are forwarded explicitly.
    """

    def __init__(
        self, warehouse, point: str = "warehouse",
        chaos: Optional[ChaosRuntime] = None,
    ) -> None:
        self._warehouse = warehouse
        self._point = point
        self._chaos = chaos if chaos is not None else default_chaos()

    def __getattr__(self, name: str):
        attr = getattr(self._warehouse, name)
        if name.startswith("_") or not callable(attr):
            return attr
        chaos, point = self._chaos, self._point

        def guarded(*args, **kwargs):
            if chaos.enabled:
                chaos.check(point)
            return attr(*args, **kwargs)

        return guarded

    def __len__(self) -> int:
        if self._chaos.enabled:
            self._chaos.check(self._point)
        return len(self._warehouse)
