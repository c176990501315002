"""Starting a world of ranks, and placing each rank's part of the global
inputs, as ``fmda_tpu.parallel.distributed`` joins hosts into one job.

- :func:`initialize` joins this process to the job as one rank
  (``torch.distributed.init_process_group``), choosing the backend from
  the layout: nccl where each rank has a card of its own, gloo where ranks
  share a card or run on the CPU.
- :func:`place_local_batch`, :func:`make_global_batch` and
  :func:`shard_train_inputs_multihost` cut this rank's block out of the
  global inputs, as the reference's process-local placement does.
- :func:`place_replicated` makes the params identical on every rank.
- :func:`launch_world` starts a world of rank processes on this host and
  joins them under a time limit.
"""

from __future__ import annotations

import logging
import os
import subprocess
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from fmda_tpu_torch.device import DeviceLike, resolve_device
from fmda_tpu_torch.parallel.mesh import (
    Mesh,
    Sharding,
    batch_sharding,
)

log = logging.getLogger("fmda_tpu_torch.parallel")

#: What :func:`initialize` chose for this process's world: ``device`` (the
#: ranks' device type), ``backend``, ``per_host`` (ranks a host runs).
layout: Dict[str, object] = {}


def init_method(coordinator_address: str) -> str:
    """``file://PATH`` and ``tcp://HOST:PORT`` as they are; the reference's
    ``HOST:PORT`` as ``tcp://HOST:PORT``."""
    if coordinator_address.startswith(("file://", "tcp://")):
        return coordinator_address
    return f"tcp://{coordinator_address}"


def choose_backend(device: torch.device, ranks_per_host: int,
                   cards: int) -> str:
    """nccl where each rank of a host has a card of its own; gloo where
    ranks share a card (nccl refuses two ranks on one device) or run on the
    CPU."""
    if device.type == "cpu" or ranks_per_host > cards:
        return "gloo"
    return "nccl"


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    *,
    local_device_ids: Optional[Tuple[int, ...]] = None,
    ranks_per_host: Optional[int] = None,
    device: DeviceLike = None,
) -> None:
    """Join this process to the job as rank ``process_id`` of
    ``num_processes`` (idempotent).

    ``coordinator_address`` is ``file://PATH`` (a store file every rank
    can reach), ``tcp://HOST:PORT`` or ``HOST:PORT``.  ``device`` is the
    ranks' device type: None means the card, ``"cpu"`` the CPU.
    ``ranks_per_host`` (default: every rank on this host) and the cards
    this host's ranks share (``local_device_ids``, default every visible
    card) choose the backend (:func:`choose_backend`), which is logged.
    Afterwards :func:`~fmda_tpu_torch.parallel.build_mesh` builds each
    rank's view of the mesh."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    dev = resolve_device(device)
    per_host = ranks_per_host or num_processes
    cards = (len(local_device_ids) if local_device_ids is not None
             else torch.cuda.device_count() if dev.type == "cuda" else 0)
    backend = choose_backend(dev, per_host, cards)
    log.info("rank %d of %d: backend %s (%d rank(s) a host, %d card(s), "
             "device %s)", process_id, num_processes, backend, per_host,
             cards, dev.type)
    dist.init_process_group(backend, init_method=init_method(
        coordinator_address), world_size=num_processes, rank=process_id)
    layout.update(device=dev.type, backend=backend, per_host=per_host)


def _to_device(a, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(np.ascontiguousarray(a)) if isinstance(
        a, np.ndarray) else a
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def make_global_batch(mesh: Mesh, array, spec: Sequence[Optional[str]]
                      ) -> torch.Tensor:
    """This rank's block of the global ``array`` (laid out per ``spec``,
    the axis that splits each leading dimension) on the rank's device."""
    return _to_device(Sharding(mesh, tuple(spec)).local(array), mesh.device)


def place_local_batch(mesh: Mesh, batch, dp_axis: str = "dp"):
    """This rank's rows of a global training ``Batch`` (x, y, mask), on its
    device: the Trainer's placement under a mesh."""
    from fmda_tpu_torch.data.pipeline import Batch

    rows = batch_sharding(mesh, dp_axis)
    return Batch(*(_to_device(rows.local(a), mesh.device) for a in batch))


def place_replicated(mesh: Mesh, tree):
    """The same params on every rank: ``tree`` (a ``state_dict``-like
    mapping, copied onto the rank's device, or a module, in place) with
    every tensor broadcast from rank 0 of the world.  A world of one rank
    only copies."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
        out = tree
    else:
        out = {k: torch.as_tensor(v).to(mesh.device, copy=True)
               for k, v in tree.items()}
        tensors = list(out.values())
    if world > 1:
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data, src=0)
    return out


def shard_train_inputs_multihost(
    mesh: Mesh,
    x_host,
    y_host,
    params: Mapping[str, torch.Tensor],
    *,
    dp_axis: str = "dp",
    sp_axis: str = "sp",
) -> Tuple:
    """The multi-host form of
    :func:`~fmda_tpu_torch.parallel.sp_train.shard_train_inputs`: ``x_host``
    and ``y_host`` are this host's rows of the global batch (hosts in rank
    order, ``mesh.hosts`` of them); each rank takes its (dp, sp) block of
    them (the mesh's own axes lay the blocks out; ``dp_axis`` and
    ``sp_axis`` name them as the reference does).  Returns (x, y, params)
    on the rank's device, the params a copy broadcast from rank 0."""
    hosts = mesh.hosts
    per_host_dp = mesh.dp // hosts
    d, s = mesh.coords
    first = (d // per_host_dp) * per_host_dp  # the host's first dp index
    rows = np.asarray(x_host).shape[0] // per_host_dp
    r0 = (d - first) * rows
    t = np.asarray(x_host).shape[1] // mesh.sp
    x = np.asarray(x_host)[r0:r0 + rows, s * t:(s + 1) * t]
    y = np.asarray(y_host)[r0:r0 + rows]
    return (_to_device(x, mesh.device), _to_device(y, mesh.device),
            place_replicated(mesh, params))


@dataclass
class RankResult:
    """One rank process's end: its exit code and what it printed."""

    rank: int
    returncode: int
    stdout: str
    stderr: str


def launch_world(
    argv: Callable[[int], List[str]],
    world: int,
    *,
    timeout: float,
    env: Optional[Mapping[str, str]] = None,
    cwd: Optional[str] = None,
) -> List[RankResult]:
    """Start ``world`` rank processes on this host, ``argv(rank)`` each, and
    join them all within ``timeout`` seconds.  On the limit every rank
    still running is killed and ``TimeoutError`` raised, naming them;
    nothing is left running either way.  Output goes through files, so a
    rank that prints much never blocks on a pipe."""
    results: List[RankResult] = []
    timed_out: List[int] = []
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        try:
            for rank in range(world):
                out = open(os.path.join(tmp, f"{rank}.out"), "w+")
                err = open(os.path.join(tmp, f"{rank}.err"), "w+")
                procs.append((subprocess.Popen(
                    argv(rank), env=None if env is None else dict(env),
                    cwd=cwd, stdout=out, stderr=err), out, err))
            deadline = time.monotonic() + timeout
            for proc, _, _ in procs:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.0))
        except subprocess.TimeoutExpired:
            timed_out = [r for r, (p, _, _) in enumerate(procs)
                         if p.poll() is None]
        finally:
            for rank, (proc, out, err) in enumerate(procs):
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
                out.seek(0)
                err.seek(0)
                results.append(RankResult(rank, proc.returncode, out.read(),
                                          err.read()))
                out.close()
                err.close()
    if timed_out:
        tails = "\n".join(f"rank {r.rank}: {r.stderr[-800:]}"
                          for r in results)
        raise TimeoutError(f"ranks {timed_out} of {world} still running "
                           f"after {timeout} s: killed\n{tails}")
    return results
