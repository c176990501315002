"""Fleet-scale historical replay, as ``fmda_tpu.replay`` defines it.

Warehoused (or seeded synthetic) history for N tickers streams through
the unmodified FleetGateway and SessionPool serving path at full speed.
A deterministic virtual clock advances with the rows themselves, so the
pipeline is the only speed limit, and the same row sequence gives the
same probabilities, bit for bit, whether it arrives as a cadence-paced
live feed (:func:`run_live_reference`) or a full-throttle backfill
(:class:`ReplayDriver`): a backtest through the driver is also a replica
of what live serving would have published.
"""

from fmda_tpu_torch.replay.driver import ReplayDriver
from fmda_tpu_torch.replay.history import (
    ReplayBatch,
    SyntheticHistory,
    WarehouseHistory,
)
from fmda_tpu_torch.replay.reference import run_live_reference

__all__ = [
    "ReplayBatch",
    "ReplayDriver",
    "SyntheticHistory",
    "WarehouseHistory",
    "run_live_reference",
]
