"""Sequence parallelism for the recurrent model: the time axis of a long
window split over the ``sp`` axis, as ``fmda_tpu.parallel.seq_parallel``
splits it.

- The input projection runs on each rank's own (B, T/sp, F) block.
- The recurrence is serial across blocks: rank k waits for the carry of
  rank k - 1, scans its block with the port's
  :func:`~fmda_tpu_torch.ops.gru.routed_gru_scan` (the route
  ``select_scan_fn`` picks for the local block: on a card at the model's
  widths kernel 1 forward and kernel 2 backward, past the kernel pair's
  envelope the wide route; the carried ``h0`` in and ``dh0`` out), then
  sends its final carry on; the reverse direction runs the other way.
  :func:`sp_gru_scan_pipelined` splits the batch into M microbatches, so
  rank k scans microbatch m as soon as it has m's carry.
- The pooling head reduces locally, then across the axis.

**One process a rank (MPMD).**  The reference runs every stage on every
device and keeps the valid one (the pipeline bubble, computed); here a
rank runs only its own stages, so the same math does less work.  A rank
runs its (direction, microbatch) stages in the order of the time each can
start, ``slot + m`` (the forward direction's slot is the rank's index, the
reverse's the mirror), so both directions' pipelines run at once.  Each
stage is one :class:`torch.autograd.Function` that receives, scans and
sends; its backward receives the final carry's cotangent, runs the scan's
backward and sends the carry's cotangent back.  Sends never block
(:func:`~fmda_tpu_torch.parallel.collectives.post_send`), and autograd
runs a rank's nodes in the reverse of the order it made them, so the
backward's messages mirror the forward's and no order of ranks deadlocks.

**Remat** recomputes only local work: with ``remat`` a stage keeps its
inputs, and its backward projects and scans again (kernel 1 once more)
before the scan's backward; no message is sent twice.

Kernel launches a rank makes, each step, per direction and layer, with M
microbatches: kernel 1 M times forward (2M with remat), kernel 2 and
``scan_dw`` M times in the backward.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from fmda_tpu_torch.ops.gru import GRUWeights, routed_gru_scan
from fmda_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce_sum,
    post_send,
    recv,
)
from fmda_tpu_torch.parallel.mesh import Axis, Mesh

Tensor = torch.Tensor


def _project_and_scan(x, h0, w_ih, b_ih, w_hh, b_hh, reverse, scan_fn):
    """The local work of a stage; with no ``w_ih``, ``x`` is the
    projection already."""
    xp = x if w_ih is None else F.linear(x, w_ih, b_ih)
    return scan_fn(xp, h0, w_hh, b_hh, reverse=reverse)


def _leaves(tensors, needs):
    """Detached copies of a stage's inputs to build its local graph on,
    requiring grad where the stage hands a gradient back."""
    return [None if t is None else t.detach().requires_grad_(need)
            for t, need in zip(tensors, needs)]


class _Stage(torch.autograd.Function):
    """One rank's scan of one direction for one microbatch: receive the
    carry from the previous slot (``prev``; the first slot starts from
    ``h0``), project and scan the local block, send the final carry to the
    next slot (``nxt``).  Returns (h_out, hs).  The backward mirrors it:
    the final carry's cotangent from the next slot, the scan's backward,
    the carry's cotangent to the previous slot."""

    @staticmethod
    def forward(ctx, x, h0, w_ih, b_ih, w_hh, b_hh, axis, prev, nxt,
                reverse, remat, scan_fn):
        carry = h0 if prev is None else recv(h0, axis, prev)
        inputs = (x, carry, w_ih, b_ih, w_hh, b_hh)
        ctx.axis, ctx.prev, ctx.nxt = axis, prev, nxt
        ctx.run = (reverse, scan_fn)
        ctx.needs = [t is not None and t.requires_grad for t in inputs]
        ctx.needs[1] = True  # the carry's cotangent goes to prev, or to h0
        if remat:
            ctx.save_for_backward(*inputs)
            ctx.graph = None
            h_out, hs = _project_and_scan(*inputs, reverse, scan_fn)
        else:
            leaves = _leaves(inputs, ctx.needs)
            with torch.enable_grad():
                h_out, hs = _project_and_scan(*leaves, reverse, scan_fn)
            ctx.graph = (leaves, h_out, hs)
        if nxt is not None:
            post_send(h_out.detach(), axis, nxt)
        return h_out.detach(), hs.detach()

    @staticmethod
    def backward(ctx, dh_out, dhs):
        axis = ctx.axis
        dh_out = dh_out.contiguous()
        if ctx.nxt is not None:
            dh_out = dh_out + recv(dh_out, axis, ctx.nxt)
        if ctx.graph is None:  # remat: project and scan again
            leaves = _leaves(ctx.saved_tensors, ctx.needs)
            with torch.enable_grad():
                h_out, hs = _project_and_scan(*leaves, *ctx.run)
        else:
            leaves, h_out, hs = ctx.graph
            ctx.graph = None
        wanted = [t for t, need in zip(leaves, ctx.needs) if need]
        grads = iter(torch.autograd.grad([h_out, hs], wanted,
                                         [dh_out, dhs.contiguous()],
                                         allow_unused=True))
        out = [next(grads) if need else None for need in ctx.needs]
        dcarry = out[1]
        if ctx.prev is not None:
            post_send(dcarry.contiguous(), axis, ctx.prev)
            out[1] = None  # h0 only gave the receive its shape
        return (*out, None, None, None, None, None, None)


def _slots(axis: Axis, reverse: bool) -> Tuple[int, Optional[int],
                                                Optional[int]]:
    """(this rank's pipeline slot, the index it receives its carry from,
    the index it sends its carry to) for one direction."""
    n, i = axis.size, axis.index
    if reverse:
        return n - 1 - i, (i + 1 if i < n - 1 else None), (
            i - 1 if i > 0 else None)
    return i, (i - 1 if i > 0 else None), (i + 1 if i < n - 1 else None)


def _run_stages(x_local, h0, dirs, axis: Axis, n_microbatches: int,
                remat: bool, scan_fn) -> List[Tuple[Tensor, Tensor]]:
    """Every (direction, microbatch) stage of one layer on this rank, in
    the order each can start; per direction, (h_final (B, H) as the stage
    ends it, hs (B, T_local, H)), microbatches concatenated."""
    batch = x_local.shape[0]
    if batch % n_microbatches != 0:
        raise ValueError(
            f"local (per-dp-shard) batch {batch} not divisible by "
            f"n_microbatches {n_microbatches}")
    mbs = batch // n_microbatches
    tasks = []
    for d, (weights, reverse) in enumerate(dirs):
        slot, prev, nxt = _slots(axis, reverse)
        for m in range(n_microbatches):
            tasks.append((slot + m, d, m, weights, reverse, prev, nxt))
    results: Dict[Tuple[int, int], Tuple[Tensor, Tensor]] = {}
    for _, d, m, w, reverse, prev, nxt in sorted(tasks, key=lambda t: t[:3]):
        rows = slice(m * mbs, (m + 1) * mbs)
        results[d, m] = _Stage.apply(
            x_local[rows], h0[rows], w.w_ih, w.b_ih, w.w_hh, w.b_hh, axis,
            prev, nxt, reverse, remat, scan_fn)
    out = []
    for d in range(len(dirs)):
        parts = [results[d, m] for m in range(n_microbatches)]
        out.append((torch.cat([p[0] for p in parts]),
                    torch.cat([p[1] for p in parts])))
    return out


def _is_last(axis: Axis, reverse: bool) -> float:
    """1.0 on the rank holding the direction's true final carry."""
    return float(axis.index == (0 if reverse else axis.size - 1))


def sp_gru_scan(
    xp_local: Tensor,
    h0: Tensor,
    w_hh: Tensor,
    b_hh: Tensor,
    axis: Axis,
    *,
    reverse: bool = False,
    scan_fn=routed_gru_scan,
    remat: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Time-sharded GRU recurrence over ``axis``.

    Args:
      xp_local: this rank's input-projection block (B, T_local, 3H).
      h0: the global initial hidden state (B, H), the same on every rank.
      reverse: the backward direction (stages run from the last rank).
      scan_fn: the local block's recurrence, by default the route the
        port's ``select_scan_fn`` picks for the block's shape and dtype.

    Returns (h_last, hs_local): the global final hidden state (every rank
    of the axis gets it) and this rank's per-step hiddens
    (B, T_local, H)."""
    return sp_gru_scan_pipelined(xp_local, h0, w_hh, b_hh, axis,
                                 n_microbatches=1, reverse=reverse,
                                 scan_fn=scan_fn, remat=remat)


def sp_gru_scan_pipelined(
    xp_local: Tensor,
    h0: Tensor,
    w_hh: Tensor,
    b_hh: Tensor,
    axis: Axis,
    *,
    n_microbatches: int,
    reverse: bool = False,
    scan_fn=routed_gru_scan,
    remat: bool = False,
) -> Tuple[Tensor, Tensor]:
    """:func:`sp_gru_scan` over ``n_microbatches`` equal microbatches of
    the batch: rank k scans microbatch m once it has m's carry, so the
    ranks work at once on different microbatches.  The useful-work ratio
    is ``sp * M / (sp + M - 1)``.  The batch must divide by M."""
    # the projection is the caller's here: the stages scan xp as it is
    w = GRUWeights(None, w_hh, None, b_hh)
    ((h_final, hs),) = _run_stages(xp_local, h0, [(w, reverse)], axis,
                                   n_microbatches, remat, scan_fn)
    h_last = all_reduce_sum(h_final * _is_last(axis, reverse), axis)
    return h_last, hs


def sp_bigru_layer_dirs(
    x_local: Tensor,
    weights_fwd: GRUWeights,
    weights_bwd: Optional[GRUWeights],
    axis: Axis,
    n_microbatches: int = 1,
    scan_fn=routed_gru_scan,
    remat: bool = False,
) -> Tuple[Tuple[Tensor, Tensor], Optional[Tuple[Tensor, Tensor]]]:
    """One (bi)GRU layer over a time-sharded input block, per direction:
    ``((h_last_f, hs_f), (h_last_b, hs_b) | None)``, each h_last the
    global final hidden (B, H), each hs this rank's (B, T_local, H).  The
    projection runs on the local block; the recurrence is
    :func:`sp_gru_scan_pipelined` (M = ``n_microbatches``), both
    directions' stages interleaved."""
    h0 = x_local.new_zeros((x_local.shape[0], weights_fwd.w_hh.shape[-1]))
    dirs = [(weights_fwd, False)] + (
        [] if weights_bwd is None else [(weights_bwd, True)])
    outs = _run_stages(x_local, h0, dirs, axis, n_microbatches, remat,
                       scan_fn)
    per_dir = [(all_reduce_sum(h * _is_last(axis, reverse), axis), hs)
               for (h, hs), (_, reverse) in zip(outs, dirs)]
    return per_dir[0], (per_dir[1] if weights_bwd is not None else None)


def sp_bigru_layer(
    x_local: Tensor,
    weights_fwd: GRUWeights,
    weights_bwd: Optional[GRUWeights],
    axis: Axis,
    n_microbatches: int = 1,
    scan_fn=routed_gru_scan,
    remat: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Direction-summed :func:`sp_bigru_layer_dirs`: (last_hidden_sum,
    gru_out_local), the head's inputs."""
    (h_f, hs_f), bwd = sp_bigru_layer_dirs(
        x_local, weights_fwd, weights_bwd, axis,
        n_microbatches=n_microbatches, scan_fn=scan_fn, remat=remat)
    if bwd is None:
        return h_f, hs_f
    h_b, hs_b = bwd
    return h_f + h_b, hs_f + hs_b


def _named(params) -> Dict[str, Tensor]:
    """A module's parameters by name, or a mapping as it is."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _weights(params: Dict[str, Tensor], suffix: str,
             dtype: torch.dtype) -> GRUWeights:
    return GRUWeights(*(params[f"{kind}_{suffix}"].to(dtype) for kind in (
        "weight_ih", "weight_hh", "bias_ih", "bias_hh")))


def pool_head_logits(params: Dict[str, Tensor], last_local: Tensor,
                     out_local: Tensor, axis: Axis, seq_len: int
                     ) -> Tensor:
    """The pool-concat head across the sharded time axis: ``last_local``
    (B, H) is the last position's value on the rank holding it and zeros
    elsewhere; ``out_local`` (B, T_local, H) this rank's outputs.  The
    last hidden and the sum pool cross the axis in one all-reduce, the max
    pool through an all-gather of the local maxima (a max has no adjoint
    of its own).  Float32 logits, as the single-device head gives."""
    hidden = out_local.shape[-1]
    summed = all_reduce_sum(torch.cat([last_local, out_local.sum(dim=1)],
                                      dim=-1), axis)
    last_hidden, sum_pool = summed[:, :hidden], summed[:, hidden:]
    max_pool = all_gather(out_local.amax(dim=1), axis).amax(dim=0)
    avg_pool = sum_pool / torch.tensor(seq_len, dtype=out_local.dtype,
                                       device=out_local.device)
    concat = torch.cat([last_hidden, max_pool, avg_pool], dim=-1)
    w, b = params["linear.weight"], params["linear.bias"]
    dtype = torch.promote_types(concat.dtype, w.dtype)
    return F.linear(concat.to(dtype), w.to(dtype), b.to(dtype)).float()


def sp_bigru_apply(
    params,
    x_local: Tensor,
    cfg,
    axis: Axis,
    seq_len: int,
    n_microbatches: int = 1,
) -> Tensor:
    """The stacked (bi)GRU forward with the pool-concat head, the time axis
    split over ``axis``: ``BiGRU``'s deterministic forward on the whole
    window.  ``params`` is the model (or its parameters by name).  Layer
    l > 0 takes the direction-concatenated outputs of layer l - 1, all
    local; the carry handoff inside each direction's scan is the only
    traffic until the head.  Dropout is not applied (the sp paths run the
    deterministic forward); ``cfg.remat`` recomputes each stage's local
    work in the backward."""
    params = _named(params)
    dtype = getattr(torch, cfg.dtype)
    x = x_local.to(dtype)
    h0 = x.new_zeros((x.shape[0], cfg.hidden_size))
    for layer in range(cfg.n_layers):
        dirs = [(_weights(params, f"l{layer}", dtype), False)]
        if cfg.bidirectional:
            dirs.append((_weights(params, f"l{layer}_reverse", dtype), True))
        outs = _run_stages(x, h0, dirs, axis, n_microbatches, cfg.remat,
                           routed_gru_scan)
        x = torch.cat([hs for _, hs in outs], dim=-1)
    # the last layer's direction sums; each direction's final carry lives
    # on its last slot's rank
    last_local = sum(h * _is_last(axis, reverse)
                     for (h, _), (_, reverse) in zip(outs, dirs))
    out_sum = sum(hs for _, hs in outs)
    return pool_head_logits(params, last_local, out_sum, axis, seq_len)


def make_sp_forward(
    mesh: Mesh,
    cfg,
    seq_len: int,
    *,
    dp_axis: str = "dp",
    sp_axis: str = "sp",
    n_microbatches: int = 1,
):
    """The sequence-parallel forward over a (dp, sp) mesh:
    ``forward(params, x_local) -> logits``, ``x_local`` this rank's
    (B/dp, T/sp, F) block, the logits this rank's dp rows (the same on
    every sp rank of them).  ``n_microbatches > 1`` pipelines the
    recurrence (the local batch must divide by it)."""
    axis = mesh.axis(sp_axis)  # the rows are this rank's already

    def forward(params, x_local: Tensor) -> Tensor:
        return sp_bigru_apply(params, x_local, cfg, axis, seq_len,
                              n_microbatches=n_microbatches)

    return forward
