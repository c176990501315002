"""Collectives over one axis of a process mesh, each differentiable, as
``fmda_tpu.parallel.collectives`` names them.

Each takes the :class:`~fmda_tpu_torch.parallel.mesh.Axis` it runs over
(``mesh.axis("sp")``); on an axis of one rank each is the identity.  The
backward of each is its adjoint, so gradients flow back through the
shifts as they do through JAX's ``ppermute``:

- :func:`all_reduce_sum`: the cotangents summed over the axis;
- :func:`all_gather`: the cotangents summed, then this rank's slice;
- :func:`ring_shift`, :func:`shift_right`, :func:`shift_left`: the
  cotangent sent the other way.

A loss every rank of the axis computes from an all-reduced value counts
each rank's cotangent once per rank: seed each rank's backward with its
share, ``loss / size``, so that the sums give the single-device gradient
(:mod:`fmda_tpu_torch.parallel.sp_train`).

**Transport.**  ``torch.distributed.send``/``recv`` are not
differentiable, and gloo takes CUDA tensors for ``all_reduce`` and
``broadcast`` but not for ``send``/``recv`` or ``all_gather``.  So where
the axis's backend is gloo and the tensor is on a card, point-to-point
messages and gathers go through pinned host buffers (:func:`to_host`,
:func:`from_host`), the compute staying on the card; with nccl, or on the
CPU, the tensor goes as it is.  Sends are non-blocking
(:func:`post_send`): the process keeps each until its message has left
(:func:`wait_sends`), and a receive is posted beside it, so no order of
sends and receives deadlocks.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from fmda_tpu_torch.parallel.mesh import Axis

Tensor = torch.Tensor


def host_transport(t: Tensor, axis: Axis) -> bool:
    """Whether ``t`` crosses ``axis`` through host memory: a card's
    tensor over a gloo group, which takes only host tensors for
    point-to-point messages and gathers."""
    return t.is_cuda and dist.get_backend(axis.group) == "gloo"


def to_host(t: Tensor) -> Tensor:
    """``t`` in a pinned host buffer of its own (waits for the copy)."""
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def from_host(buf: Tensor, device: torch.device) -> Tensor:
    """A pinned host buffer's values on ``device`` (a non-blocking copy;
    the caching host allocator keeps the buffer until it has run)."""
    return buf.to(device, non_blocking=True)


#: Sends posted and not yet known to have left, this process's: (work,
#: buffer) pairs.  The buffer must outlive its message.
_PENDING: List[Tuple[object, Tensor]] = []


def post_send(t: Tensor, axis: Axis, index: int) -> None:
    """Send ``t`` to the rank at ``index`` along ``axis``, without waiting
    for it to leave (:func:`wait_sends` does)."""
    t = to_host(t) if host_transport(t, axis) else t.contiguous()
    work = dist.isend(t, dst=axis.ranks[index], group=axis.group)
    # drop what has left already, keep the rest alive
    _PENDING[:] = [(w, b) for w, b in _PENDING if not w.is_completed()]
    _PENDING.append((work, t))


def wait_sends() -> None:
    """Wait until every posted send has left."""
    while _PENDING:
        work, _ = _PENDING.pop()
        work.wait()


def recv(like: Tensor, axis: Axis, index: int) -> Tensor:
    """Receive a tensor of ``like``'s shape, dtype and device from the rank
    at ``index`` along ``axis``; waits for it."""
    host = host_transport(like, axis)
    buf = torch.empty(like.shape, dtype=like.dtype,
                      pin_memory=host, device="cpu" if host else like.device)
    dist.recv(buf, src=axis.ranks[index], group=axis.group)
    return from_host(buf, like.device) if host else buf


def exchange(t: Tensor, axis: Axis, to: Optional[int],
             frm: Optional[int]) -> Optional[Tensor]:
    """Send ``t`` to index ``to`` and receive a tensor like it from index
    ``frm`` (either may be None): the receive is posted beside the send,
    so any pairing of ranks completes.  Returns what was received."""
    if to is not None:
        post_send(t, axis, to)
    return None if frm is None else recv(t, axis, frm)


def _all_reduce(t: Tensor, axis: Axis) -> Tensor:
    """Sum ``t`` over the axis into a new tensor (gloo takes a card's
    tensors for this collective)."""
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=axis.group)
    return out


def _all_gather(t: Tensor, axis: Axis) -> Tensor:
    """Every rank's ``t`` stacked along a new leading dimension, in axis
    order."""
    host = host_transport(t, axis)
    src = to_host(t) if host else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    out = torch.stack(parts)
    return from_host(out.pin_memory(), t.device) if host else out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis)[ctx.axis.index], None


class _Shift(torch.autograd.Function):
    """Each rank sends ``x`` ``shift`` places along the axis and receives
    from ``shift`` places back; ``wrap`` rotates around the ring, else a
    rank with no sender receives ``fill``.  The backward is the same
    exchange the other way."""

    @staticmethod
    def forward(ctx, x, fill, axis, shift, wrap):
        ctx.axis, ctx.shift, ctx.wrap = axis, shift, wrap
        ctx.has_fill = fill is not None
        to, frm = _partners(axis, shift, wrap)
        got = exchange(x, axis, to, frm)
        return fill.clone() if got is None else got

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        to, frm = _partners(axis, -ctx.shift, ctx.wrap)
        g = g.contiguous()
        # the cotangent of what this rank received goes back to its sender
        got = exchange(g, axis, to, frm)
        dx = torch.zeros_like(g) if got is None else got
        dfill = None
        if ctx.has_fill:
            received = _partners(axis, ctx.shift, ctx.wrap)[1] is not None
            dfill = torch.zeros_like(g) if received else g
        return dx, dfill, None, None, None


def _partners(axis: Axis, shift: int, wrap: bool
              ) -> Tuple[Optional[int], Optional[int]]:
    """(index this rank sends to, index it receives from) for a shift."""
    n, i = axis.size, axis.index
    if wrap:
        return (i + shift) % n, (i - shift) % n
    to, frm = i + shift, i - shift
    return (to if 0 <= to < n else None), (frm if 0 <= frm < n else None)


def all_reduce_sum(x: Tensor, axis: Axis) -> Tensor:
    """Sum across the axis; every rank gets the sum."""
    if axis.size == 1:
        return x
    return _AllReduceSum.apply(x, axis)


def all_reduce_mean(x: Tensor, axis: Axis) -> Tensor:
    return all_reduce_sum(x, axis) / axis.size


def all_gather(x: Tensor, axis: Axis, dim: int = 0, *,
               tiled: bool = False) -> Tensor:
    """Every rank's ``x``: stacked along a new ``dim`` by default,
    concatenated into the existing one when ``tiled``."""
    out = x[None] if axis.size == 1 else _AllGather.apply(x, axis)
    if tiled:
        return torch.cat(out.unbind(0), dim=dim)
    return out.movedim(0, dim)


def ring_shift(x: Tensor, axis: Axis, shift: int = 1) -> Tensor:
    """Rotate values around the axis: each rank receives the value of the
    rank ``shift`` places before it."""
    if axis.size == 1:
        return x
    return _Shift.apply(x, None, axis, shift, True)


def shift_right(x: Tensor, axis: Axis, fill: Tensor) -> Tensor:
    """Each rank's value to the next rank, no wraparound; the first rank
    receives ``fill``."""
    if axis.size == 1:
        return fill
    return _Shift.apply(x, fill, axis, 1, False)


def shift_left(x: Tensor, axis: Axis, fill: Tensor) -> Tensor:
    """Each rank's value to the previous rank; the last receives
    ``fill``."""
    if axis.size == 1:
        return fill
    return _Shift.apply(x, fill, axis, -1, False)
