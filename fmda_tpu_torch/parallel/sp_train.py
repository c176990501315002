"""The long-context training step over a (dp, sp) mesh, as
``fmda_tpu.parallel.sp_train`` builds it: the sequence-parallel forward,
weighted BCE, gradients, a clip by global norm and Adam, each rank holding
its (B/dp, T/sp) block of the batch and a copy of the params.

The gradient is the single-device one.  Every sp rank of a dp row
computes the same logits (the head's collectives make them so) and the
same loss, and the collectives' backwards are their adjoints, so each
rank seeds its backward with ``1 / sp`` of its row's loss; the row's loss
is its rows' BCE sum over the global element count.  One all-reduce over
the world then sums every rank's gradients (and the rows' losses):
each rank's local contributions once, the head's sp shares into one.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from fmda_tpu_torch.parallel.mesh import Mesh, batch_sharding, sequence_sharding

log = logging.getLogger("fmda_tpu_torch.parallel")

Tensor = torch.Tensor


@dataclass(frozen=True)
class ClippedAdam:
    """``optax.chain(optax.clip_by_global_norm(clip),
    optax.adam(learning_rate))``: the port's
    :func:`~fmda_tpu_torch.train.trainer.clip_by_global_norm` and
    ``torch.optim.Adam`` with optax's defaults, as the Trainer runs them.
    :meth:`init` makes the optimizer state (the Adam) for a model."""

    learning_rate: float = 1e-3
    clip: float = 50.0

    def init(self, model: torch.nn.Module) -> torch.optim.Optimizer:
        from fmda_tpu_torch.train.trainer import ADAM_BETAS, ADAM_EPS

        return torch.optim.Adam(model.parameters(), lr=self.learning_rate,
                                betas=ADAM_BETAS, eps=ADAM_EPS)


def all_reduce_gradients(params: Sequence[Tensor], extra: Sequence[Tensor],
                         group=None) -> List[Tensor]:
    """Sum every param's ``.grad`` and the ``extra`` scalars over ``group``
    (the world by default) in one all-reduce of one flat buffer; the grads
    are summed in place, the extras returned summed."""
    import torch.distributed as dist

    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [e.reshape(1).to(grads[0].dtype) for e in extra])
    dist.all_reduce(flat, group=group)
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return list(flat[at:].unbind())


def make_sp_grad_fn(
    mesh: Mesh,
    model_cfg,
    seq_len: int,
    *,
    weight: Optional[Tensor] = None,
    pos_weight: Optional[Tensor] = None,
    dp_axis: str = "dp",
    sp_axis: str = "sp",
    n_microbatches: int = 1,
):
    """``grad_fn(model, x_local, y_local) -> loss``: the forward and
    backward of :func:`make_sp_train_step` without the update.  Every
    param's ``.grad`` is left holding the global batch's gradient, summed
    over the world, and the global batch's loss is returned (the same on
    every rank).  Takes :func:`make_sp_train_step`'s arguments, warning
    and refusals."""
    if model_cfg.dropout:
        log.warning(
            "sp training runs the deterministic forward; "
            "ModelConfig.dropout=%.2f is ignored", model_cfg.dropout)
    if model_cfg.cell == "attn":
        from fmda_tpu_torch.parallel.ring_attention import (
            make_attn_sp_forward,
        )

        if n_microbatches != 1:
            raise ValueError(
                "n_microbatches applies only to the recurrent cells: the "
                "ring-attention program has no pipeline bubble to fill")
        forward = make_attn_sp_forward(mesh, model_cfg, seq_len,
                                       dp_axis=dp_axis, sp_axis=sp_axis)
    elif model_cfg.cell == "gru":
        from fmda_tpu_torch.parallel.seq_parallel import make_sp_forward

        forward = make_sp_forward(mesh, model_cfg, seq_len, dp_axis=dp_axis,
                                  sp_axis=sp_axis,
                                  n_microbatches=n_microbatches)
    else:
        raise ValueError(
            "sequence-parallel training implements cell='gru' (the "
            "staged carry-handoff scan) and cell='attn' (the K/V ring); "
            f"got ModelConfig.cell={model_cfg.cell!r} — train lstm on "
            "the dp-only path and ssm in its parallel scan mode "
            "(fmda_tpu_torch.train.Trainer)")
    from fmda_tpu_torch.parallel.collectives import wait_sends
    from fmda_tpu_torch.train.losses import weighted_bce_sums

    sp = mesh.shape[sp_axis]
    world = mesh.size

    def grad_fn(model, x_local: Tensor, y_local: Tensor) -> Tensor:
        model.zero_grad(set_to_none=True)
        params = list(model.parameters())
        logits = forward(model, x_local)
        loss_sum, _ = weighted_bce_sums(logits, y_local, weight=weight,
                                        pos_weight=pos_weight)
        # the global batch's element count: every row of every dp rank
        denom = float(x_local.shape[0] * mesh.shape[dp_axis]
                      * logits.shape[-1])
        row_loss = loss_sum / denom
        (row_loss / sp).backward()
        wait_sends()
        for p in params:
            if p.grad is None:  # a param this rank's graph did not reach
                p.grad = torch.zeros_like(p)
        if world == 1:
            return row_loss.detach()
        (loss,) = all_reduce_gradients(params, [row_loss.detach() / sp])
        return loss

    return grad_fn


def make_sp_train_step(
    mesh: Mesh,
    model_cfg,
    seq_len: int,
    optimizer: ClippedAdam,
    *,
    weight: Optional[Tensor] = None,
    pos_weight: Optional[Tensor] = None,
    dp_axis: str = "dp",
    sp_axis: str = "sp",
    n_microbatches: int = 1,
):
    """``step(model, opt_state, x_local, y_local) -> loss``: one training
    step on this rank's block of the global batch (x (B/dp, T/sp, F), y
    (B/dp, C)), the model and ``opt_state`` (``optimizer.init(model)``)
    updated in place, the global batch's loss returned (the same on every
    rank).  ``n_microbatches > 1`` pipelines the recurrence (the local
    batch must divide by it).

    ``model_cfg.cell`` picks the sequence core: the GRU's carry handoff or
    (``"attn"``) the transformer with ring attention.  The forward is the
    deterministic one: ``model_cfg.dropout`` is ignored (a warning says
    so); ``model_cfg.remat`` recomputes local work in the backward.  The
    gradient is :func:`make_sp_grad_fn`'s."""
    from fmda_tpu_torch.train.trainer import clip_by_global_norm

    grad_fn = make_sp_grad_fn(
        mesh, model_cfg, seq_len, weight=weight, pos_weight=pos_weight,
        dp_axis=dp_axis, sp_axis=sp_axis, n_microbatches=n_microbatches)

    def step(model, opt_state, x_local: Tensor, y_local: Tensor) -> Tensor:
        loss = grad_fn(model, x_local, y_local)
        clip_by_global_norm([p.grad for p in model.parameters()],
                            optimizer.clip)
        opt_state.step()
        return loss

    return step


def place_fresh_copy(tree: Mapping[str, Tensor], device) -> dict:
    """A copy of a ``state_dict``-like tree on ``device``, never an alias of
    the caller's tensors: training updates it in place."""
    return {k: torch.as_tensor(v).to(device, copy=True)
            for k, v in tree.items()}


def shard_train_inputs(
    mesh: Mesh,
    x,
    y,
    params: Mapping[str, Tensor],
    *,
    dp_axis: str = "dp",
    sp_axis: str = "sp",
) -> Tuple:
    """This rank's part of a global training batch: (x_local (B/dp, T/sp,
    F), y_local (B/dp, C), params), each on the rank's device, the params
    a fresh copy (:func:`place_fresh_copy`)."""
    def local(sharding, a):
        block = sharding.local(np.asarray(a))
        return torch.as_tensor(np.ascontiguousarray(block)).to(mesh.device)

    return (local(sequence_sharding(mesh, dp_axis, sp_axis), x),
            local(batch_sharding(mesh, dp_axis), y),
            place_fresh_copy(params, mesh.device))
