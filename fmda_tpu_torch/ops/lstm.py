"""LSTM sequence ops: the input projection for all steps, then the scan.

The recurrence is split as in ``fmda_tpu.ops.lstm`` (and as in
:mod:`fmda_tpu_torch.ops.gru`):

1. the input projection ``x @ W_ih^T + b_ih`` for every timestep at once,
   one large ``(B*T, F) x (F, 4H)`` product left to cuBLAS;
2. the recurrent scan, which carries h and c through the small
   ``h @ W_hh^T`` product and the gate algebra, in the CUDA kernels of
   :mod:`fmda_tpu_torch.ops.lstm_kernel` (forward, and backward when
   autograd records).

Gates follow the torch ``nn.LSTM`` convention, packed ``[i, f, g, o]``:

    i_t = sigmoid(W_ii x_t + b_ii + W_hi h_{t-1} + b_hi)
    f_t = sigmoid(W_if x_t + b_if + W_hf h_{t-1} + b_hf)
    g_t = tanh   (W_ig x_t + b_ig + W_hg h_{t-1} + b_hg)
    o_t = sigmoid(W_io x_t + b_io + W_ho h_{t-1} + b_ho)
    c_t = f_t * c_{t-1} + i_t * g_t
    h_t = o_t * tanh(c_t)
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from fmda_tpu_torch.ops.lstm_kernel import (
    lstm_gates,
    lstm_scan,
    lstm_scan_bwd,
    lstm_scan_bwd_reference,
    lstm_scan_fwd,
    lstm_scan_reference,
)

__all__ = [
    "LSTMWeights", "lstm_gates", "lstm_input_projection", "lstm_layer",
    "lstm_scan", "lstm_scan_bwd", "lstm_scan_bwd_reference", "lstm_scan_fwd",
    "lstm_scan_reference",
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


def lstm_layer(
    x: torch.Tensor,
    weights: LSTMWeights,
    h0: Optional[torch.Tensor] = None,
    c0: Optional[torch.Tensor] = None,
    *,
    reverse: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """One direction of an LSTM layer: projection, then the differentiable
    scan (its kernels, or their plain versions for CPU tensors).  Returns
    ((h_last, c_last), hs)."""
    state = (x.shape[0], weights.w_hh.shape[-1])
    h0 = x.new_zeros(state) if h0 is None else h0
    c0 = x.new_zeros(state) if c0 is None else c0
    xp = lstm_input_projection(x, weights)
    return lstm_scan(xp, h0, c0, weights.w_hh, weights.b_hh, reverse=reverse,
                     mask=mask)
