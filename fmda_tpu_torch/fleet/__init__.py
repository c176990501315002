"""fmda_tpu_torch.fleet — the multi-host distributed serving tier, as
``fmda_tpu.fleet`` defines it.

N worker processes (each embedding the single-process fleet runtime:
:class:`~fmda_tpu_torch.runtime.gateway.FleetGateway` +
:class:`~fmda_tpu_torch.runtime.session_pool.SessionPool`) each own a
contiguous slot-range of the session hash space
(:mod:`~fmda_tpu_torch.fleet.hashring`), fronted by a
:class:`~fmda_tpu_torch.fleet.router.FleetRouter` that hashes session → owner
over the cross-process bus (:mod:`~fmda_tpu_torch.fleet.wire` serves the
router's NativeBus/InProcessBus to SocketBus workers; KafkaBus slots in
for prod), with heartbeat membership (:mod:`~fmda_tpu_torch.fleet.membership`)
and live session migration that never drops, duplicates, or reorders a
tick (:mod:`~fmda_tpu_torch.fleet.state` carries the state bit-exact).
``python -m fmda_tpu_torch serve-fleet --role broker|router|worker|local``
runs the topology.  Architecture: docs/multihost.md (the reference's).

Router-role names import **without torch** — a router is a bus-only host
with no card; ``tests/test_torch_isolation.py`` pins that.  :class:`FleetWorker` and the local
launcher (which builds worker models) resolve lazily.
"""

from fmda_tpu_torch._lazy import lazy_exports
from fmda_tpu_torch.fleet.hashring import OwnershipTable, hash_session
from fmda_tpu_torch.fleet.membership import Heartbeater, MembershipView
from fmda_tpu_torch.fleet.router import FleetRouter, NoLiveWorkers
from fmda_tpu_torch.fleet.wire import BusServer, SocketBus

#: worker/launcher names — lazy: the worker pulls torch via the runtime
_LAZY = {
    "FleetWorker": "fmda_tpu_torch.fleet.worker",
    "LocalFleet": "fmda_tpu_torch.fleet.launcher",
    "launch_local_fleet": "fmda_tpu_torch.fleet.launcher",
    "spawn_supported": "fmda_tpu_torch.fleet.launcher",
}

__all__ = sorted([
    "OwnershipTable",
    "hash_session",
    "Heartbeater",
    "MembershipView",
    "FleetRouter",
    "NoLiveWorkers",
    "BusServer",
    "SocketBus",
    *_LAZY,
])


__getattr__, __dir__ = lazy_exports(__name__, _LAZY)
