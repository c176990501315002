from fmda_tpu_torch.stream.bus import (
    Consumer, InProcessBus, MessageBus, Record)
from fmda_tpu_torch.stream.engine import StreamEngine
from fmda_tpu_torch.stream.journal import BufferedWarehouse
from fmda_tpu_torch.stream.warehouse import Warehouse

__all__ = ["BufferedWarehouse", "Consumer", "InProcessBus", "MessageBus",
           "Record", "StreamEngine", "Warehouse"]
