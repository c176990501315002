"""Ring attention: attention with the time axis split over the ``sp`` axis,
as ``fmda_tpu.parallel.ring_attention`` computes it.

Each rank holds a (B, N, T/sp, D) time block of Q, K and V.  Its queries
attend to every block: for ``sp`` steps the rank folds the K/V block it
holds into its result and passes the block on around the ring.  A fold is
one call of the flash op
(:func:`~fmda_tpu_torch.ops.attention_kernel.flash_attention_with_lse`: on
a card, kernel 6) on the self-shaped (T/sp, T/sp) block, and the folds
merge through their logsumexps
(:func:`~fmda_tpu_torch.ops.attention.merge_softmax_segments`).  The
softmax is exact under any blocking of the keys, so the result is
single-device attention.  Shapes outside the flash op's envelope raise, as
the op does: the port has this one fold.

Causal: step s brings the block of rank ``(idx - s) mod sp``.  Step 0 is
the diagonal block, masked by the kernel's own causal mask; a block from a
later rank is wholly in the future, so its fold is skipped (no launch),
but the block still passes on around the ring.

The backward (:class:`_Ring`) runs the ring again: each step the rank runs
the flash backward (kernels 7 and 8, or their fused launch) on the block
it holds against the saved global logsumexp, adds to its dq, and passes
the block on with the dk and dv gathered for it so far; a last step hands
every block's gradients home.  Every rank sends and receives the same
messages in the same order, forward and backward.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from fmda_tpu_torch.models.attn import (
    _layer_norm,
    _linear,
    sinusoidal_positions,
)
from fmda_tpu_torch.ops.attention import (
    merge_heads,
    merge_softmax_segments,
    split_heads,
)
from fmda_tpu_torch.ops.attention_kernel import (
    flash_attention_with_lse,
    flash_bwd,
    flash_delta,
)
from fmda_tpu_torch.parallel.collectives import exchange
from fmda_tpu_torch.parallel.mesh import Axis, Mesh, Sharding
from fmda_tpu_torch.parallel.seq_parallel import pool_head_logits

Tensor = torch.Tensor


def _rotate(t: Tensor, axis: Axis) -> Tensor:
    """``t`` to the next rank of the ring; the previous rank's in return."""
    n, i = axis.size, axis.index
    return exchange(t.contiguous(), axis, (i + 1) % n, (i - 1) % n)


def _skipped(axis: Axis, step: int, causal: bool) -> bool:
    """Whether the block held at ``step`` lies wholly in the future."""
    owner = (axis.index - step) % axis.size
    return causal and owner > axis.index


class _Ring(torch.autograd.Function):
    """Ring attention over ``axis``: forward and backward as the module
    docstring sets them out.  Saves q, k, v, the output and the global
    logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, axis, causal):
        o = lse = None
        kv = torch.stack([k, v])
        for step in range(axis.size):
            if step:
                kv = _rotate(kv, axis)
            if _skipped(axis, step, causal):
                continue
            o_blk, lse_blk = flash_attention_with_lse(
                q, kv[0], kv[1], causal=causal and step == 0)
            o_blk = o_blk.float()
            o, lse = ((o_blk, lse_blk) if o is None else
                      merge_softmax_segments(o, lse, o_blk, lse_blk))
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.axis, ctx.causal = axis, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        axis, causal = ctx.axis, ctx.causal
        do = do.contiguous()
        delta = flash_delta(out, do, torch.zeros_like(lse))
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        # the block held and the dk, dv gathered for it so far travel
        # together, as one float32 message
        f32 = torch.float32
        held = torch.cat([torch.stack([k, v]).to(f32),
                          torch.zeros((2,) + k.shape, dtype=f32,
                                      device=k.device)])
        for step in range(axis.size):
            if step:
                held = _rotate(held, axis)
            if _skipped(axis, step, causal):
                continue
            dq_blk, dk_blk, dv_blk = flash_bwd(
                q, held[0].to(k.dtype), held[1].to(v.dtype), do, lse, delta,
                causal=causal and step == 0)
            dq += dq_blk.float()
            held[2] += dk_blk.float()
            held[3] += dv_blk.float()
        grads = held[2:] if axis.size == 1 else _rotate(held[2:], axis)
        return (dq.to(q.dtype), grads[0].to(k.dtype), grads[1].to(v.dtype),
                None, None)


def ring_attention(q: Tensor, k: Tensor, v: Tensor, axis: Axis, *,
                   causal: bool = False) -> Tensor:
    """Sequence-sharded attention over ``axis``.

    Args:
      q, k, v: this rank's time block, (B, N, T_local, D); the global
        sequence is the blocks in axis order.
      causal: the causal mask in global positions.

    Returns this rank's output block (B, N, T_local, D) in q's dtype."""
    return _Ring.apply(q, k, v, axis, causal)


def _qkv(block, x: Tensor):
    """An encoder block's local first half: LayerNorm and the QKV
    projection."""
    return _linear(block.qkv, _layer_norm(block.ln_attn, x)).chunk(3, dim=-1)


def _residuals(block, x: Tensor, attn: Tensor) -> Tensor:
    """An encoder block's local second half: the attention's projection
    and residual, then the GELU MLP and its residual."""
    x = x + _linear(block.proj, attn)
    y = _linear(block.mlp_in, _layer_norm(block.ln_mlp, x))
    return x + _linear(block.mlp_out,
                       torch.nn.functional.gelu(y, approximate="tanh"))


def sp_attn_apply(model, x_local: Tensor, cfg, axis: Axis,
                  seq_len: int) -> Tensor:
    """The sequence-sharded
    :class:`~fmda_tpu_torch.models.attn.TemporalTransformer` forward: the
    embedding, LayerNorms and MLPs on the local time block, attention as
    :func:`ring_attention`, the pool-concat head reduced locally and then
    across the axis.  ``TemporalTransformer``'s deterministic forward on
    the whole window (no mask, no dropout).  With ``cfg.remat`` each
    encoder block's two local halves are recomputed in the backward; the
    ring between them keeps its own inputs, so no message is sent
    twice."""
    dtype = getattr(torch, cfg.dtype)
    t_local = x_local.shape[1]
    pos = sinusoidal_positions(seq_len, cfg.hidden_size, dtype,
                               x_local.device)
    x = _linear(model.embed, x_local.to(dtype)) + pos[
        axis.index * t_local:(axis.index + 1) * t_local][None]
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in range(cfg.n_layers):
        block = getattr(model, f"block_{layer}")
        q, k, v = (checkpoint(_qkv, block, x, use_reentrant=False) if remat
                   else _qkv(block, x))
        attn = merge_heads(ring_attention(
            split_heads(q, cfg.n_heads), split_heads(k, cfg.n_heads),
            split_heads(v, cfg.n_heads), axis, causal=cfg.attn_causal))
        x = (checkpoint(_residuals, block, x, attn, use_reentrant=False)
             if remat else _residuals(block, x, attn))
    x = _layer_norm(model.ln_final, x)
    # the window's last position lives on the axis's last rank
    last_local = x[:, -1] * float(axis.index == axis.size - 1)
    return pool_head_logits(
        {"linear.weight": model.linear.weight,
         "linear.bias": model.linear.bias}, last_local, x, axis, seq_len)


def make_attn_sp_forward(mesh: Mesh, cfg, seq_len: int, *,
                         dp_axis: str = "dp", sp_axis: str = "sp"):
    """The sequence-parallel transformer forward over a (dp, sp) mesh:
    ``forward(model, x_local) -> logits``, the attention twin of
    :func:`~fmda_tpu_torch.parallel.seq_parallel.make_sp_forward`."""
    axis = mesh.axis(sp_axis)  # the rows are this rank's already

    def forward(model, x_local: Tensor) -> Tensor:
        return sp_attn_apply(model, x_local, cfg, axis, seq_len)

    return forward


def make_ring_attention(mesh: Mesh, *, axis_name: str = "sp",
                        batch_axis: Optional[str] = "dp",
                        causal: bool = False):
    """:func:`ring_attention` over the mesh: ``fn(q, k, v)`` takes the
    global (B, N, T, D) tensors (the same on every rank), splits time over
    ``axis_name`` and batch over ``batch_axis`` (where the mesh has it),
    and returns this rank's block of the output."""
    spec = (batch_axis if batch_axis in mesh.axis_names else None, None,
            axis_name)
    local = Sharding(mesh, spec).local
    axis = mesh.axis(axis_name)

    def fn(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
        return ring_attention(local(q), local(k), local(v), axis,
                              causal=causal)

    return fn
