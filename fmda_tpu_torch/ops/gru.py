"""GRU sequence ops: the input projection for all steps, then the scan.

The recurrence is split as in ``fmda_tpu.ops.gru``:

1. the input projection ``x @ W_ih^T + b_ih`` for every timestep at once,
   one large ``(B*T, F) x (F, 3H)`` product left to cuBLAS;
2. the recurrent scan, which carries only the ``h @ W_hh^T`` product and
   the gate algebra, by one of two routes, chosen by shape alone
   (:func:`select_scan_fn`, as ``fmda_tpu.ops.gru.select_scan_fn`` chooses
   between the Pallas pair and ``lax.scan``): the CUDA kernel pair of
   :mod:`fmda_tpu_torch.ops.gru_kernel` where
   :func:`~fmda_tpu_torch.ops.gru_kernel.kernel_supported` holds, else the
   wide route of :mod:`fmda_tpu_torch.ops.wide_scan` (a cuBLAS product and
   a fused gate kernel a step).

Gates follow the torch ``nn.GRU`` convention, packed ``[r, z, n]``:

    r_t = sigmoid(W_ir x_t + b_ir + W_hr h_{t-1} + b_hr)
    z_t = sigmoid(W_iz x_t + b_iz + W_hz h_{t-1} + b_hz)
    n_t = tanh(W_in x_t + b_in + r_t * (W_hn h_{t-1} + b_hn))
    h_t = (1 - z_t) * n_t + z_t * h_{t-1}
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fmda_tpu_torch.ops.gru_kernel import (
    gru_gates,
    gru_scan,
    gru_scan_bwd,
    gru_scan_bwd_reference,
    gru_scan_fwd,
    gru_scan_reference,
    kernel_supported,
)
from fmda_tpu_torch.ops.wide_scan import gru_wide_scan

__all__ = [
    "GRUWeights", "gru_gates", "gru_layer", "gru_scan", "gru_scan_bwd",
    "gru_scan_bwd_reference", "gru_scan_fwd", "gru_scan_reference",
    "gru_wide_scan", "input_projection", "kernel_supported", "routed_gru_scan",
    "select_scan_fn",
]


class GRUWeights(NamedTuple):
    """One direction's parameters, torch layout."""

    w_ih: torch.Tensor  # (3H, F)
    w_hh: torch.Tensor  # (3H, H)
    b_ih: torch.Tensor  # (3H,)
    b_hh: torch.Tensor  # (3H,)


def input_projection(x: torch.Tensor, weights: GRUWeights) -> torch.Tensor:
    """All-timestep input projection: (B, T, F) -> (B, T, 3H)."""
    return F.linear(x, weights.w_ih, weights.b_ih)


def select_scan_fn(shape: Tuple[int, int, int], itemsize: int):
    """The kernel-pair-vs-wide-route choice, shared by every caller
    (:func:`gru_layer` and the sequence-parallel stage, on its local
    block), so the rule lives in one place: :func:`gru_scan` where
    ``kernel_supported(*shape, itemsize)`` (``shape`` = (batch, seq_len,
    hidden)), else :func:`gru_wide_scan`.  Both take the same arguments
    and run on CPU tensors through their plain versions, so the route is
    the same on either device; neither catches the other's failure."""
    return gru_scan if kernel_supported(*shape, itemsize) else gru_wide_scan


def routed_gru_scan(
    xp: torch.Tensor,
    h0: torch.Tensor,
    w_hh: torch.Tensor,
    b_hh: torch.Tensor,
    *,
    reverse: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The differentiable GRU scan by the route :func:`select_scan_fn`
    picks for xp's (B, T) and h0's width in xp's dtype."""
    scan = select_scan_fn((xp.shape[0], xp.shape[1], h0.shape[-1]),
                          xp.element_size())
    return scan(xp, h0, w_hh, b_hh, reverse=reverse, mask=mask)


def gru_layer(
    x: torch.Tensor,
    weights: GRUWeights,
    h0: Optional[torch.Tensor] = None,
    *,
    reverse: bool = False,
    mask: Optional[torch.Tensor] = None,
    remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One direction of a GRU layer: projection, then the differentiable
    scan by the route :func:`select_scan_fn` picks for (B, T, H) in x's
    dtype (its kernels, or their plain versions for CPU tensors).  Returns
    (h_last, hs).  ``remat`` recomputes the kernel pair's plain scan in the
    backward pass, as the reference checkpoints its ``lax.scan``; the wide
    route rematerialises already (its backward recomputes every step's
    product from hs)."""
    hidden = weights.w_hh.shape[-1]
    if h0 is None:
        h0 = x.new_zeros((x.shape[0], hidden))
    xp = input_projection(x, weights)
    scan = select_scan_fn((x.shape[0], x.shape[1], hidden), x.element_size())
    if scan is gru_wide_scan:
        return scan(xp, h0, weights.w_hh, weights.b_hh, reverse=reverse,
                    mask=mask)
    if remat and xp.device.type == "cpu" and torch.is_grad_enabled():
        # the plain path only: the kernel pair saves xp, h0, the weights
        # and hs, and its backward sweep recomputes the gates, so it
        # rematerialises already (as the reference's Pallas pair does)
        return checkpoint(functools.partial(gru_scan, reverse=reverse,
                                            mask=mask),
                          xp, h0, weights.w_hh, weights.b_hh,
                          use_reentrant=False)
    return gru_scan(xp, h0, weights.w_hh, weights.b_hh, reverse=reverse,
                    mask=mask)
