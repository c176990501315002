"""Bidirectional GRU price-movement classifier.

The counterpart of ``fmda_tpu.models.bigru.BiGRU``, weight for weight:

- optional spatial (feature-channel) input dropout;
- stacked, optionally bidirectional GRU layers from the projection + scan
  ops of :mod:`fmda_tpu_torch.ops.gru` (the scan is the CUDA kernel);
- the pool-concat head: the sum of the last layer's final forward and
  backward hiddens, and max- and mean-pools of the direction-summed
  outputs, into ``Linear(3H -> n_classes)``.

Parameters are named as ``nn.GRU`` names them (``weight_ih_l0``,
``bias_hh_l0_reverse``, ...), with the head under ``linear``, so the JAX
package's flax params load through :func:`fmda_tpu_torch.interop.params_from_flax`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from fmda_tpu_torch.config import ModelConfig
from fmda_tpu_torch.models.common import dropout, pool_concat_logits
from fmda_tpu_torch.ops.gru import GRUWeights, gru_layer


def _suffix(layer: int, reverse: bool) -> str:
    return f"l{layer}" + ("_reverse" if reverse else "")


class BiGRU(nn.Module):
    """See module docstring.  ``cfg.n_features`` must be resolved."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        if cfg.n_features is None:
            raise ValueError("ModelConfig.n_features unresolved")
        self.cfg = cfg
        self.n_dirs = 2 if cfg.bidirectional else 1
        h = cfg.hidden_size
        for layer in range(cfg.n_layers):
            in_dim = cfg.n_features if layer == 0 else h * self.n_dirs
            for d in range(self.n_dirs):
                s = _suffix(layer, d == 1)
                for name, shape in ((f"weight_ih_{s}", (3 * h, in_dim)),
                                    (f"weight_hh_{s}", (3 * h, h)),
                                    (f"bias_ih_{s}", (3 * h,)),
                                    (f"bias_hh_{s}", (3 * h,))):
                    self.register_parameter(
                        name, nn.Parameter(torch.empty(shape)))
        self.linear = nn.Linear(3 * h, cfg.output_size)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(
        self, generator: Optional[torch.Generator] = None
    ) -> None:
        """torch's default U(-1/sqrt(fan), 1/sqrt(fan)): fan = H for the
        GRU, 3H for the head."""
        h = self.cfg.hidden_size
        for name, p in self.named_parameters():
            scale = 1.0 / math.sqrt(3 * h if name.startswith("linear.") else h)
            p.uniform_(-scale, scale, generator=generator)

    def direction_weights(self, layer: int, reverse: bool,
                          dtype: torch.dtype) -> GRUWeights:
        """One direction's params, cast to the compute dtype."""
        s = _suffix(layer, reverse)
        return GRUWeights(*(
            getattr(self, f"{kind}_{s}").to(dtype)
            for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")))

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        *,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """(B, T, F) windows -> (B, n_classes) float32 logits.

        ``mask`` is an optional (B, T) validity mask for padded windows;
        ``generator`` feeds the dropout masks in training mode."""
        cfg = self.cfg
        seq_len = x.shape[1]
        compute_dtype = getattr(torch, cfg.dtype)
        x = dropout(x.to(compute_dtype), cfg.dropout, training=self.training,
                    generator=generator, spatial=cfg.spatial_dropout)

        layer_input = x
        for layer in range(cfg.n_layers):
            outs, finals = [], []
            for d in range(self.n_dirs):
                h_last, hs = gru_layer(
                    layer_input,
                    self.direction_weights(layer, d == 1, compute_dtype),
                    reverse=d == 1, mask=mask)
                outs.append(hs)
                finals.append(h_last)
            layer_input = torch.cat(outs, dim=-1) if self.n_dirs == 2 else outs[0]
            # inter-layer dropout, as nn.GRU applies it (all but the last)
            if layer < cfg.n_layers - 1:
                layer_input = dropout(layer_input, cfg.dropout,
                                      training=self.training,
                                      generator=generator)

        last_hidden = torch.stack(finals).sum(dim=0)  # sum directions (B, H)
        gru_out = outs[0] + outs[1] if self.n_dirs == 2 else outs[0]
        return pool_concat_logits(
            self.linear, last_hidden, gru_out,
            mask=mask, seq_len=seq_len, compute_dtype=compute_dtype)
