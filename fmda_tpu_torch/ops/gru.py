"""GRU sequence ops: the input projection for all steps, then the scan.

The recurrence is split as in ``fmda_tpu.ops.gru``:

1. the input projection ``x @ W_ih^T + b_ih`` for every timestep at once,
   one large ``(B*T, F) x (F, 3H)`` product left to cuBLAS;
2. the recurrent scan, which carries only the small ``h @ W_hh^T``
   product and the gate algebra, in the CUDA kernels of
   :mod:`fmda_tpu_torch.ops.gru_kernel` (forward, and backward when
   autograd records).

Gates follow the torch ``nn.GRU`` convention, packed ``[r, z, n]``:

    r_t = sigmoid(W_ir x_t + b_ir + W_hr h_{t-1} + b_hr)
    z_t = sigmoid(W_iz x_t + b_iz + W_hz h_{t-1} + b_hz)
    n_t = tanh(W_in x_t + b_in + r_t * (W_hn h_{t-1} + b_hn))
    h_t = (1 - z_t) * n_t + z_t * h_{t-1}
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from fmda_tpu_torch.ops.gru_kernel import (
    gru_gates,
    gru_scan,
    gru_scan_bwd,
    gru_scan_bwd_reference,
    gru_scan_fwd,
    gru_scan_reference,
)

__all__ = [
    "GRUWeights", "gru_gates", "gru_layer", "gru_scan", "gru_scan_bwd",
    "gru_scan_bwd_reference", "gru_scan_fwd", "gru_scan_reference",
    "input_projection",
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


def gru_layer(
    x: torch.Tensor,
    weights: GRUWeights,
    h0: Optional[torch.Tensor] = None,
    *,
    reverse: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One direction of a GRU layer: projection, then the differentiable
    scan (its kernels, or their plain versions for CPU tensors).  Returns
    (h_last, hs)."""
    hidden = weights.w_hh.shape[-1]
    if h0 is None:
        h0 = x.new_zeros((x.shape[0], hidden))
    xp = input_projection(x, weights)
    return gru_scan(xp, h0, weights.w_hh, weights.b_hh, reverse=reverse,
                    mask=mask)
