"""Bidirectional GRU price-movement classifier.

The counterpart of ``fmda_tpu.models.bigru.BiGRU``, weight for weight: the
:class:`~fmda_tpu_torch.models.common.RecurrentClassifier` (input dropout,
stacked optionally-bidirectional layers, the pool-concat head) over the
projection + scan ops of :mod:`fmda_tpu_torch.ops.gru`, whose scan is the
CUDA kernel.  Parameters are named as ``nn.GRU`` names them, gate rows
``[r, z, n]``, with the head under ``linear``, so the JAX package's flax
params load through :func:`fmda_tpu_torch.interop.params_from_flax`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fmda_tpu_torch.models.common import RecurrentClassifier
from fmda_tpu_torch.ops.gru import GRUWeights, gru_layer


class BiGRUState(NamedTuple):
    """Carried hidden state: (n_layers, n_directions, B, H)."""

    hidden: torch.Tensor


class BiGRU(RecurrentClassifier):
    """See module docstring."""

    n_gates = 3
    weights_type = GRUWeights
    state_type = BiGRUState

    def layer(self, x, weights, init, *, reverse, mask):
        h_last, hs = gru_layer(x, weights, None if init is None else init[0],
                               reverse=reverse, mask=mask,
                               remat=self.cfg.remat)
        return (h_last,), hs
