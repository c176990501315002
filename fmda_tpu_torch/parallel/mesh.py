"""The (dp, sp) grid of ranks and the descriptions of what each axis
splits, as ``fmda_tpu.parallel.mesh`` lays out a device mesh.

Axes:

- ``dp``, data parallel: each rank holds a block of the batch's rows, and
  the gradients are summed over the axis;
- ``sp``, sequence parallel: each rank holds a block of a long window's
  time steps; the recurrent carry, or attention's K/V blocks, cross the
  axis between neighbours (:mod:`fmda_tpu_torch.parallel.seq_parallel`,
  :mod:`fmda_tpu_torch.parallel.ring_attention`).

A :class:`Mesh` comes in two kinds.  Built from the process group
(``devices=None``), it is this rank's view of the world: the grid, this
rank's coordinates and device, and a process group for each axis.  Built
from a list of local devices, it is one process's grid of devices, which
only the sharded session pool uses (each device a block of slots).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from fmda_tpu_torch.config import MeshConfig
from fmda_tpu_torch.device import DeviceLike, resolve_device


class Axis(NamedTuple):
    """One axis of a process mesh as this rank sees it: ``size`` ranks,
    their global ranks in axis order, this rank's ``index`` among them,
    and the process group the collectives over the axis use (None when
    the axis has one rank: every collective is then the identity)."""

    name: str
    size: int
    index: int
    ranks: Tuple[int, ...]
    group: Optional[object]


@dataclass
class Mesh:
    """A (dp, sp) grid.  ``shape`` maps each axis name to its size, as a
    jax ``Mesh.shape`` does.

    A process mesh has ``rank`` (this process's global rank), ``coords``
    (its (dp, sp) position), ``device`` (its card, or the CPU) and
    :meth:`axis`.  A local mesh (:attr:`local`) has ``devices``, the grid
    of one process's devices in row-major (dp, sp) order."""

    dp: int
    sp: int
    dp_axis: str = "dp"
    sp_axis: str = "sp"
    rank: Optional[int] = None
    coords: Optional[Tuple[int, int]] = None
    device: Optional[torch.device] = None
    devices: Tuple[torch.device, ...] = ()
    #: Hosts the world spans (``MeshConfig.processes``).
    hosts: int = 1
    _axes: Dict[str, Axis] = field(default_factory=dict, repr=False)

    @property
    def local(self) -> bool:
        """A grid of one process's devices (no process group)."""
        return self.rank is None

    @property
    def shape(self) -> Dict[str, int]:
        return {self.dp_axis: self.dp, self.sp_axis: self.sp}

    @property
    def axis_names(self) -> Tuple[str, str]:
        return (self.dp_axis, self.sp_axis)

    @property
    def size(self) -> int:
        return self.dp * self.sp

    def axis(self, name: str) -> Axis:
        """This rank's view of the axis ``name`` of a process mesh."""
        if self.local:
            raise ValueError(
                "a local mesh has no process groups: its axes are devices "
                "of one process")
        if name not in self._axes:
            raise KeyError(f"mesh axes are {self.axis_names}, not {name!r}")
        return self._axes[name]


def _world() -> Tuple[int, int]:
    """(world size, this rank) of the default process group; (1, 0) when
    none is initialised (a world of one process)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _grid(cfg: MeshConfig, n: int, per_host: int) -> Tuple[int, int]:
    """The (dp, sp) sizes for ``n`` ranks or devices, with
    ``fmda_tpu.parallel.mesh.build_mesh``'s checks and messages."""
    sp = cfg.sp
    if sp <= 0 or n % sp != 0 and cfg.dp == -1:
        raise ValueError(f"sp={sp} does not divide device count {n}")
    if cfg.processes > 1 and per_host % sp != 0:
        # ranks are host-major, so sp-sized contiguous blocks stay inside
        # one host only when sp divides the ranks a host runs: otherwise
        # the recurrent carry would cross hosts
        raise ValueError(
            f"sp={sp} must divide the per-host device count {per_host} so "
            "the sequence carry stays on one host")
    dp = (n // sp) if cfg.dp == -1 else cfg.dp
    needed = dp * sp
    if needed > n:
        raise ValueError(f"mesh {dp}x{sp} needs {needed} devices, have {n}")
    return dp, sp


def build_mesh(
    cfg: Optional[MeshConfig] = None,
    devices: Optional[Sequence[DeviceLike]] = None,
    *,
    device: DeviceLike = None,
) -> Mesh:
    """Build a (dp, sp) mesh.

    With ``devices``, a local mesh over that list (one process; a device
    may repeat, standing in for several), its first ``dp * sp`` entries
    used.  Without, this rank's view of the world the default process
    group spans (:func:`fmda_tpu_torch.parallel.initialize`; a world of one
    process gives the 1 x 1 mesh, with no process group).  Every rank of
    the world calls it, in the same order: the axes' groups are made
    collectively.  ``cfg.dp == -1`` means every rank not used by sp; a
    process mesh must use the whole world.  ``device`` is the device type
    of a process mesh's ranks: None means what
    :func:`~fmda_tpu_torch.parallel.initialize` was given, else the card,
    each rank on ``cuda:(local_rank % device_count)``; ``"cpu"`` runs on
    the CPU."""
    cfg = cfg or MeshConfig()
    if devices is not None:
        devices = tuple(resolve_device(d) for d in devices)
        dp, sp = _grid(cfg, len(devices), len(devices))
        return Mesh(dp, sp, cfg.dp_axis, cfg.sp_axis,
                    devices=devices[:dp * sp])
    world, rank = _world()
    if world % cfg.processes != 0 or (cfg.processes > 1 and world == 1):
        raise ValueError(
            f"MeshConfig.processes={cfg.processes} but this job runs "
            f"{world} rank(s) — call fmda_tpu_torch.parallel.initialize "
            "on every rank first, with as many ranks on every host")
    per_host = world // cfg.processes
    dp, sp = _grid(cfg, world, per_host)
    if dp * sp != world:
        raise ValueError(
            f"mesh {dp}x{sp} uses {dp * sp} of {world} ranks: a rank is a "
            "process, so start exactly dp * sp of them")
    if device is None and world > 1:
        from fmda_tpu_torch.parallel.distributed import layout

        device = layout.get("device")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", (rank % per_host)
                           % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = Mesh(dp, sp, cfg.dp_axis, cfg.sp_axis, rank=rank,
                coords=divmod(rank, sp), device=dev, hosts=cfg.processes)
    sp_ranks = [tuple(d * sp + s for s in range(sp)) for d in range(dp)]
    dp_ranks = [tuple(d * sp + s for d in range(dp)) for s in range(sp)]
    groups = {}
    if world > 1:
        import torch.distributed as dist

        # every rank makes every group, in one order
        for ranks in sp_ranks + dp_ranks:
            group = dist.new_group(list(ranks)) if len(ranks) > 1 else None
            if rank in ranks:
                groups[ranks] = group
    d, s = mesh.coords
    for name, ranks, index in ((cfg.sp_axis, sp_ranks[d], s),
                               (cfg.dp_axis, dp_ranks[s], d)):
        mesh._axes[name] = Axis(name, len(ranks), index, ranks,
                                groups.get(ranks))
    return mesh


class Sharding(NamedTuple):
    """Which mesh axis splits which leading dimension of a tensor, as a
    ``PartitionSpec`` says it (None: not split).  On a process mesh
    :meth:`local` cuts this rank's block out of a global array."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    def local_slices(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        """This rank's block of a global array of ``shape``: each split
        dimension in equal blocks, one a rank along its axis."""
        out = []
        for dim, name in enumerate(self.spec):
            if name is None:
                out.append(slice(None))
                continue
            axis = self.mesh.axis(name)
            if shape[dim] % axis.size != 0:
                raise ValueError(
                    f"dimension {dim} of {tuple(shape)} does not split "
                    f"into {axis.size} equal blocks over {name!r}")
            block = shape[dim] // axis.size
            out.append(slice(axis.index * block, (axis.index + 1) * block))
        return tuple(out)

    def local(self, array):
        """This rank's block of ``array`` (numpy or torch)."""
        return array[self.local_slices(array.shape)]


def batch_sharding(mesh: Mesh, dp_axis: str = "dp") -> Sharding:
    """The leading (batch) dimension split over dp; the rest whole."""
    return Sharding(mesh, (dp_axis,))


def sequence_sharding(mesh: Mesh, dp_axis: str = "dp",
                      sp_axis: str = "sp") -> Sharding:
    """(batch, time, ...) split over (dp, sp)."""
    return Sharding(mesh, (dp_axis, sp_axis))


def replicated_sharding(mesh: Mesh) -> Sharding:
    """Whole on every rank."""
    return Sharding(mesh, ())


def slot_sharding(mesh: Mesh, dp_axis: str = "dp") -> Sharding:
    """The session pool's slot axis split over dp: each device holds an
    equal block of sessions' state
    (:class:`~fmda_tpu_torch.runtime.SessionPool`).  Structurally
    :func:`batch_sharding`; named apart because slots are persistent
    state, not a step's batch."""
    return Sharding(mesh, (dp_axis,))
