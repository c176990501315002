"""fmda_tpu_torch.parallel: data and sequence parallelism on
``torch.distributed``, the counterpart of ``fmda_tpu.parallel``.

**One process a rank.**  The reference runs one controller a host, which
drives a ``Mesh`` of its local devices under ``shard_map``; here each rank
is a process of its own and runs only its own part (MPMD).

- :func:`build_mesh` returns a :class:`Mesh`: the (dp, sp) grid of ranks,
  this rank's coordinates and device (``cuda:(local_rank %
  device_count)``, or the CPU when asked), and a process group for each
  axis, with ``MeshConfig``'s checks and messages.  ``MeshConfig.processes``
  counts hosts, as in the reference: each runs ``world / processes``
  ranks, and sp must divide that, so a carry never crosses hosts.  A world
  of one process gives the 1 x 1 mesh, with no process group and every
  collective the identity.
- :func:`initialize` joins a process to the world and picks the backend
  from the layout, explicitly, and logs it: nccl where each rank has a
  card of its own, gloo where ranks share a card (NCCL refuses two ranks
  on one device) or run on the CPU.  gloo takes a card's tensors for
  ``all_reduce`` and ``broadcast`` but not for ``send``/``recv`` or
  ``all_gather``: those go through pinned host buffers
  (:mod:`~fmda_tpu_torch.parallel.collectives`), chosen by the group's
  backend and the tensor's device, the compute staying on the card.
- The collectives are differentiable, each backward its adjoint (JAX's
  ``ppermute`` transposes; ``torch.distributed.send`` does not).
- :mod:`~fmda_tpu_torch.parallel.seq_parallel`: the time-sharded BiGRU,
  each rank scanning its block with the GRU kernel pair once it has its
  carry; :mod:`~fmda_tpu_torch.parallel.ring_attention`: K/V blocks
  around the ring, each folded by the flash kernels;
  :mod:`~fmda_tpu_torch.parallel.sp_train`: the training step over both.
- ``Trainer(mesh=)`` is data parallel over dp; ``SessionPool(mesh=)``
  splits its slots over a *local* mesh (``build_mesh(cfg,
  devices=[...])``, one process, a device a block; a list may repeat one
  device): the one single-process part.
"""

from fmda_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce_mean,
    all_reduce_sum,
    ring_shift,
    shift_left,
    shift_right,
)
from fmda_tpu_torch.parallel.distributed import (
    initialize,
    launch_world,
    make_global_batch,
    place_local_batch,
    place_replicated,
    shard_train_inputs_multihost,
)
from fmda_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    build_mesh,
    replicated_sharding,
    sequence_sharding,
    slot_sharding,
)
from fmda_tpu_torch.parallel.ring_attention import (
    make_attn_sp_forward,
    make_ring_attention,
    ring_attention,
    sp_attn_apply,
)
from fmda_tpu_torch.parallel.seq_parallel import (
    make_sp_forward,
    sp_bigru_apply,
    sp_bigru_layer,
    sp_bigru_layer_dirs,
    sp_gru_scan,
    sp_gru_scan_pipelined,
)
from fmda_tpu_torch.parallel.sp_train import (
    ClippedAdam,
    make_sp_grad_fn,
    make_sp_train_step,
    place_fresh_copy,
    shard_train_inputs,
)

__all__ = [
    "ClippedAdam",
    "Mesh",
    "build_mesh",
    "batch_sharding",
    "replicated_sharding",
    "sequence_sharding",
    "slot_sharding",
    "all_reduce_sum",
    "all_reduce_mean",
    "all_gather",
    "ring_shift",
    "shift_left",
    "shift_right",
    "initialize",
    "launch_world",
    "make_global_batch",
    "place_local_batch",
    "place_replicated",
    "shard_train_inputs_multihost",
    "make_sp_forward",
    "sp_bigru_apply",
    "sp_gru_scan",
    "sp_gru_scan_pipelined",
    "sp_bigru_layer",
    "sp_bigru_layer_dirs",
    "ring_attention",
    "sp_attn_apply",
    "make_attn_sp_forward",
    "make_ring_attention",
    "make_sp_grad_fn",
    "make_sp_train_step",
    "place_fresh_copy",
    "shard_train_inputs",
]
