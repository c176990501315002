"""Bidirectional LSTM price-movement classifier.

The counterpart of ``fmda_tpu.models.bilstm.BiLSTM``, weight for weight:
the same :class:`~fmda_tpu_torch.models.common.RecurrentClassifier` as
:class:`~fmda_tpu_torch.models.bigru.BiGRU` (input dropout, stacked
optionally-bidirectional layers, the pool-concat head) over the projection
+ scan ops of :mod:`fmda_tpu_torch.ops.lstm`, whose scan is the CUDA
kernel.  The head reads the layers' final hiddens and per-step outputs;
the final cell states are carried state only.  Parameters are named as
``nn.LSTM`` names them, gate rows ``[i, f, g, o]``, with the head under
``linear``, so the JAX package's flax params load through
:func:`fmda_tpu_torch.interop.params_from_flax`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fmda_tpu_torch.models.common import RecurrentClassifier
from fmda_tpu_torch.ops.lstm import LSTMWeights, lstm_layer


class BiLSTMState(NamedTuple):
    """Carried state: hidden and cell, each (n_layers, n_dirs, B, H)."""

    hidden: torch.Tensor
    cell: torch.Tensor


class BiLSTM(RecurrentClassifier):
    """See module docstring."""

    n_gates = 4
    weights_type = LSTMWeights
    state_type = BiLSTMState

    def layer(self, x, weights, init, *, reverse, mask):
        h0, c0 = (None, None) if init is None else init
        (h_last, c_last), hs = lstm_layer(x, weights, h0, c0,
                                          reverse=reverse, mask=mask,
                                          remat=self.cfg.remat)
        return (h_last, c_last), hs
