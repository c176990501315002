"""LSTM sequence ops: the input projection for all steps, then the scan.

The recurrence is split as in ``fmda_tpu.ops.lstm`` (and as in
:mod:`fmda_tpu_torch.ops.gru`):

1. the input projection ``x @ W_ih^T + b_ih`` for every timestep at once,
   one large ``(B*T, F) x (F, 4H)`` product left to cuBLAS;
2. the recurrent scan, which carries h and c through the ``h @ W_hh^T``
   product and the gate algebra, by the route :func:`select_lstm_scan_fn`
   picks by shape alone: the CUDA kernel pair of
   :mod:`fmda_tpu_torch.ops.lstm_kernel` where its
   :func:`~fmda_tpu_torch.ops.lstm_kernel.kernel_supported` holds (H <= 512
   and W_hh on chip), else the wide route of
   :mod:`fmda_tpu_torch.ops.wide_scan`.

Gates follow the torch ``nn.LSTM`` convention, packed ``[i, f, g, o]``:

    i_t = sigmoid(W_ii x_t + b_ii + W_hi h_{t-1} + b_hi)
    f_t = sigmoid(W_if x_t + b_if + W_hf h_{t-1} + b_hf)
    g_t = tanh   (W_ig x_t + b_ig + W_hg h_{t-1} + b_hg)
    o_t = sigmoid(W_io x_t + b_io + W_ho h_{t-1} + b_ho)
    c_t = f_t * c_{t-1} + i_t * g_t
    h_t = o_t * tanh(c_t)
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fmda_tpu_torch.ops.lstm_kernel import (
    lstm_gates,
    lstm_scan,
    lstm_scan_bwd,
    lstm_scan_bwd_reference,
    lstm_scan_fwd,
    lstm_scan_reference,
    kernel_supported,
)
from fmda_tpu_torch.ops.wide_scan import lstm_wide_scan

__all__ = [
    "LSTMWeights", "lstm_gates", "lstm_input_projection", "lstm_layer",
    "lstm_scan", "lstm_scan_bwd", "lstm_scan_bwd_reference", "lstm_scan_fwd",
    "lstm_scan_reference", "lstm_wide_scan", "kernel_supported",
    "select_lstm_scan_fn",
]


class LSTMWeights(NamedTuple):
    """One direction's parameters, torch layout."""

    w_ih: torch.Tensor  # (4H, F)
    w_hh: torch.Tensor  # (4H, H)
    b_ih: torch.Tensor  # (4H,)
    b_hh: torch.Tensor  # (4H,)


def lstm_input_projection(x: torch.Tensor,
                          weights: LSTMWeights) -> torch.Tensor:
    """All-timestep input projection: (B, T, F) -> (B, T, 4H)."""
    return F.linear(x, weights.w_ih, weights.b_ih)


def select_lstm_scan_fn(shape: Tuple[int, int, int], itemsize: int):
    """The LSTM twin of :func:`fmda_tpu_torch.ops.gru.select_scan_fn`:
    :func:`lstm_scan` where ``kernel_supported(*shape, itemsize)``
    (``shape`` = (batch, seq_len, hidden)), else :func:`lstm_wide_scan`."""
    return lstm_scan if kernel_supported(*shape, itemsize) else lstm_wide_scan


def lstm_layer(
    x: torch.Tensor,
    weights: LSTMWeights,
    h0: Optional[torch.Tensor] = None,
    c0: Optional[torch.Tensor] = None,
    *,
    reverse: bool = False,
    mask: Optional[torch.Tensor] = None,
    remat: bool = False,
) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """One direction of an LSTM layer: projection, then the differentiable
    scan by the route :func:`select_lstm_scan_fn` picks (its kernels, or
    their plain versions for CPU tensors).  Returns ((h_last, c_last), hs).
    ``remat`` recomputes the kernel pair's plain scan in the backward
    pass, as the reference checkpoints its ``lax.scan``; the wide route
    rematerialises already."""
    state = (x.shape[0], weights.w_hh.shape[-1])
    h0 = x.new_zeros(state) if h0 is None else h0
    c0 = x.new_zeros(state) if c0 is None else c0
    xp = lstm_input_projection(x, weights)
    scan = select_lstm_scan_fn((x.shape[0], x.shape[1], state[1]),
                               x.element_size())
    if scan is lstm_wide_scan:
        return scan(xp, h0, c0, weights.w_hh, weights.b_hh, reverse=reverse,
                    mask=mask)
    if remat and xp.device.type == "cpu" and torch.is_grad_enabled():
        # the plain path only: the kernel pair saves xp, the carries, the
        # weights, hs and cs, and its backward sweep recomputes the gates,
        # so it rematerialises already (as the reference's Pallas pair)
        return checkpoint(functools.partial(lstm_scan, reverse=reverse,
                                            mask=mask),
                          xp, h0, c0, weights.w_hh, weights.b_hh,
                          use_reentrant=False)
    return lstm_scan(xp, h0, c0, weights.w_hh, weights.b_hh, reverse=reverse,
                     mask=mask)
