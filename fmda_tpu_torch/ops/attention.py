"""Multi-head self-attention ops: the counterpart of
``fmda_tpu.ops.attention``, in plain PyTorch.

Everything is built from one primitive, :func:`online_attention_block`, the
numerically stable streaming-softmax step.  Over K/V blocks b = 1..n::

    m_b = max(m_{b-1}, rowmax(S_b))
    l_b = l_{b-1} * exp(m_{b-1} - m_b) + rowsum(exp(S_b - m_b))
    o_b = o_{b-1} * exp(m_{b-1} - m_b) + exp(S_b - m_b) @ V_b

and ``o_n / l_n`` is softmax(S) @ V however the key axis was blocked.  All
accumulation is float32 whatever the I/O dtype; logits are scaled by
1/sqrt(d_head).  :func:`merge_softmax_segments` combines two normalized
results over disjoint key segments through their logsumexps, the form in
which a sequence-sharded (ring) path folds one flash call per K/V block.

:func:`mha` is the model's attention.  Self-attention (Tq == Tk) with no
mask or a key mask goes through the flash op
(:func:`fmda_tpu_torch.ops.attention_kernel.flash_attention`): its CUDA
kernels on a card, their plain version on the CPU.  Any other shape or
mask runs the online-softmax block here, as the reference's ``mha`` does.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from fmda_tpu_torch.ops.attention_kernel import flash_attention

Tensor = torch.Tensor


class OnlineSoftmaxState(NamedTuple):
    """Running streaming-softmax accumulators, all float32: ``m`` (B, N,
    Tq) the running row max, ``l`` (B, N, Tq) the running row sum, ``o``
    (B, N, Tq, D) the unnormalized output."""

    m: Tensor
    l: Tensor  # noqa: E741
    o: Tensor


def init_online_state(batch: int, n_heads: int, q_len: int, d_head: int,
                      device=None) -> OnlineSoftmaxState:
    """The empty state: ``m = -inf``, ``l = 0``, ``o = 0``."""
    f32 = dict(dtype=torch.float32, device=device)
    return OnlineSoftmaxState(
        m=torch.full((batch, n_heads, q_len), -math.inf, **f32),
        l=torch.zeros((batch, n_heads, q_len), **f32),
        o=torch.zeros((batch, n_heads, q_len, d_head), **f32))


def online_attention_block(
    state: OnlineSoftmaxState,
    q: Tensor,
    k: Tensor,
    v: Tensor,
    mask: Optional[Tensor] = None,
) -> OnlineSoftmaxState:
    """Fold one K/V block into the running softmax state.

    ``q`` (B, N, Tq, D), ``k``/``v`` (B, N, Tk, D); ``mask`` (Tq, Tk) or
    broadcastable to (B, N, Tq, Tk), True = keep.  The products take the
    inputs in float32 (exact for bf16 operands) and accumulate in float32;
    the probabilities are rounded to v's dtype before the product with v.
    A row that has seen no unmasked key keeps ``m = -inf`` and ``l = 0``.
    """
    f32 = torch.float32
    scale = 1.0 / torch.sqrt(torch.tensor(q.shape[-1], dtype=f32))
    s = torch.einsum("bnqd,bnkd->bnqk", q.to(f32), k.to(f32)) * scale
    if mask is not None:
        s = torch.where(mask, s, -math.inf)
    m_new = torch.maximum(state.m, s.amax(dim=-1))
    # rows still without an unmasked key keep m = -inf; exp(-inf - -inf)
    # is nan, so their correction is pinned to 0
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    corr = torch.where(torch.isneginf(state.m), 0.0,
                       torch.exp(state.m - m_safe))
    p = torch.exp(torch.where(torch.isneginf(s), -math.inf,
                              s - m_safe[..., None]))
    l_new = state.l * corr + p.sum(dim=-1)
    o_new = state.o * corr[..., None] + torch.einsum(
        "bnqk,bnkd->bnqd", p.to(v.dtype).to(f32), v.to(f32))
    return OnlineSoftmaxState(m=m_new, l=l_new, o=o_new)


def finalize_online_state(state: OnlineSoftmaxState,
                          dtype: torch.dtype) -> Tensor:
    """The attention output (B, N, Tq, D) in ``dtype``; rows that saw only
    masked keys (l == 0) come out as zeros."""
    l = torch.where(state.l == 0.0, 1.0, state.l)  # noqa: E741
    return (state.o / l[..., None]).to(dtype)


def merge_softmax_segments(o1: Tensor, lse1: Tensor, o2: Tensor,
                           lse2: Tensor) -> Tuple[Tensor, Tensor]:
    """Combine two normalized attention results over disjoint key segments
    (``o_i`` (..., T, D), ``lse_i`` (..., T)) into the result over their
    union::

        m = max(lse1, lse2);  a_i = exp(lse_i - m)
        o = (o1 a1 + o2 a2) / (a1 + a2);  lse = m + log(a1 + a2)

    An empty segment carries the flash op's finite ``lse = -1e30``: its
    weight is exactly 0, and two empty segments merge to o = 0 without
    NaNs (which -inf arithmetic would give)."""
    m = torch.maximum(lse1, lse2)
    a1 = torch.exp(lse1 - m)
    a2 = torch.exp(lse2 - m)
    denom = a1 + a2
    o = (o1 * a1[..., None] + o2 * a2[..., None]) / denom[..., None]
    return o, m + torch.log(denom)


def _key_mask(mask: Tensor, batch: int, tk: int) -> Optional[Tensor]:
    """A (B or 1, 1, 1, Tk) mask as the (B, Tk) key mask the flash op
    takes; None for any other shape."""
    if mask.dim() == 4 and mask.shape[1:3] == (1, 1) and \
            mask.shape[3] == tk and mask.shape[0] in (1, batch):
        return mask[:, 0, 0, :].expand(batch, tk)
    return None


def mha(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = False,
        mask: Optional[Tensor] = None) -> Tensor:
    """Multi-head attention, (B, N, Tq, D) queries over (B, N, Tk, D) keys
    and values -> (B, N, Tq, D) in q's dtype.

    ``causal`` masks each query's future; with ``Tq != Tk`` query i sits at
    position ``Tk - Tq + i`` (suffix alignment: a short query block against
    a longer K/V history sees its whole past).  ``mask`` is (Tq, Tk) or
    broadcastable to (B, N, Tq, Tk), True = keep.

    Self-attention with no mask or a (B, 1, 1, Tk) key mask runs the flash
    op (on a card, its kernels); anything else runs
    :func:`online_attention_block` over the whole key axis."""
    batch, tq, tk = q.shape[0], q.shape[-2], k.shape[-2]
    if tq == tk:
        key_mask = None if mask is None else _key_mask(mask, batch, tk)
        if mask is None or key_mask is not None:
            return flash_attention(q, k, v, causal=causal, key_mask=key_mask)
    full_mask = None
    if causal:
        q_pos = tk - tq + torch.arange(tq, device=q.device)
        full_mask = q_pos[:, None] >= torch.arange(tk, device=q.device)[None]
    if mask is not None:
        full_mask = mask if full_mask is None else (full_mask & mask)
    state = init_online_state(batch, q.shape[1], tq, q.shape[-1], q.device)
    state = online_attention_block(state, q, k, v, full_mask)
    return finalize_online_state(state, q.dtype)


def split_heads(x: Tensor, n_heads: int) -> Tensor:
    """(B, T, N*D) -> (B, N, T, D)."""
    b, t, nd = x.shape
    return x.reshape(b, t, n_heads, nd // n_heads).transpose(1, 2)


def merge_heads(x: Tensor) -> Tensor:
    """(B, N, T, D) -> (B, T, N*D)."""
    b, n, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, n * d)
