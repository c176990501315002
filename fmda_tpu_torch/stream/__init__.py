"""fmda_tpu_torch.stream: the bus, the streaming engine and the
warehouse.

Exports resolve lazily (PEP 562), so the torch-free bus and codec import
without the engine's stack (the multi-host router's path).
"""

from fmda_tpu_torch._lazy import lazy_exports

#: public name -> defining submodule; resolved on first attribute access
_EXPORTS = {
    "BufferedWarehouse": "fmda_tpu_torch.stream.journal",
    "Consumer": "fmda_tpu_torch.stream.bus",
    "InProcessBus": "fmda_tpu_torch.stream.bus",
    "MessageBus": "fmda_tpu_torch.stream.bus",
    "Record": "fmda_tpu_torch.stream.bus",
    "StreamEngine": "fmda_tpu_torch.stream.engine",
    "Warehouse": "fmda_tpu_torch.stream.warehouse",
}

__all__ = sorted(_EXPORTS)


__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
