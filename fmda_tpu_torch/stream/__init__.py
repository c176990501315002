from fmda_tpu_torch.stream.bus import Consumer, InProcessBus, Record
from fmda_tpu_torch.stream.warehouse import Warehouse

__all__ = ["Consumer", "InProcessBus", "Record", "Warehouse"]
