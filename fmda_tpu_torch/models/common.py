"""Shared pieces of the recurrent model families: input dropout, the
pool-concat head (as ``fmda_tpu.models.common`` defines them), and
:class:`RecurrentClassifier`, the module both families are: the
parameters under ``nn.GRU``/``nn.LSTM``'s names, their init, the stacked
optionally-bidirectional layers and the head, with the cell's layer op
left to the family."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn


def dropout(
    x: torch.Tensor,
    p: float,
    *,
    training: bool,
    generator: Optional[torch.Generator] = None,
    spatial: bool = False,
) -> torch.Tensor:
    """Inverted dropout with the keep mask drawn from ``generator``.

    ``spatial`` draws one mask per (B, F) and broadcasts it over time, so
    whole feature channels drop across the window (torch's Dropout2d on
    (B, F, T))."""
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    shape = (x.shape[0], 1, x.shape[2]) if spatial else x.shape
    draw_on = generator.device if generator is not None else x.device
    keep = torch.rand(shape, generator=generator, device=draw_on) >= p
    return torch.where(keep.to(x.device), x / (1.0 - p), 0.0).to(x.dtype)


def pool_concat_logits(
    head: nn.Linear,
    last_hidden: torch.Tensor,
    out_sum: torch.Tensor,
    *,
    mask: Optional[torch.Tensor],
    seq_len: int,
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """Max-pool and mean-pool over the direction-summed per-step outputs,
    concatenated with the summed final hidden state into
    ``Linear(3H -> n_classes)``.

    The average divides by ``seq_len`` in the compute dtype; with a mask,
    the max skips invalid steps (``finfo.min`` fill) and the average
    divides by ``max(count, 1)``.  Logits are always float32.
    """
    if mask is None:
        max_pool = out_sum.amax(dim=1)
        avg_pool = out_sum.sum(dim=1) / torch.tensor(
            seq_len, dtype=compute_dtype, device=out_sum.device)
    else:
        m = mask[..., None].to(compute_dtype)
        neg = torch.finfo(compute_dtype).min
        max_pool = torch.where(m > 0, out_sum, neg).amax(dim=1)
        denom = m.sum(dim=1).clamp_min(1.0)
        avg_pool = (out_sum * m).sum(dim=1) / denom
    concat = torch.cat([last_hidden, max_pool, avg_pool], dim=-1)
    # the head's params are float32: the product runs in the promoted dtype
    dtype = torch.promote_types(concat.dtype, head.weight.dtype)
    logits = nn.functional.linear(
        concat.to(dtype), head.weight.to(dtype), head.bias.to(dtype))
    return logits.to(torch.float32)


def _suffix(layer: int, reverse: bool) -> str:
    return f"l{layer}" + ("_reverse" if reverse else "")


class RecurrentClassifier(nn.Module):
    """The price-movement classifier around a recurrent cell, weight for
    weight with ``fmda_tpu``'s ``BiGRU``/``BiLSTM``:

    - optional spatial (feature-channel) input dropout;
    - stacked, optionally bidirectional layers of the cell, with dropout
      between layers as ``nn.GRU``/``nn.LSTM`` apply it;
    - the pool-concat head: the sum of the last layer's final forward and
      backward hiddens, and max- and mean-pools of the direction-summed
      outputs, into ``Linear(3H -> n_classes)``.

    A family sets :attr:`n_gates` and :attr:`weights_type` and implements
    :meth:`layer`.  Parameters are named as torch's recurrent modules name
    them (``weight_ih_l0``, ``bias_hh_l0_reverse``, ...), with the head
    under ``linear``.  ``cfg.n_features`` must be resolved."""

    #: Gate blocks stacked in the recurrent weights (3 GRU, 4 LSTM).
    n_gates: int
    #: The NamedTuple ``(w_ih, w_hh, b_ih, b_hh)`` the layer op takes.
    weights_type: type

    def __init__(self, cfg, *,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        if cfg.n_features is None:
            raise ValueError("ModelConfig.n_features unresolved")
        self.cfg = cfg
        self.n_dirs = 2 if cfg.bidirectional else 1
        h, gh = cfg.hidden_size, self.n_gates * cfg.hidden_size
        for layer in range(cfg.n_layers):
            in_dim = cfg.n_features if layer == 0 else h * self.n_dirs
            for d in range(self.n_dirs):
                s = _suffix(layer, d == 1)
                for name, shape in ((f"weight_ih_{s}", (gh, in_dim)),
                                    (f"weight_hh_{s}", (gh, h)),
                                    (f"bias_ih_{s}", (gh,)),
                                    (f"bias_hh_{s}", (gh,))):
                    self.register_parameter(
                        name, nn.Parameter(torch.empty(shape)))
        self.linear = nn.Linear(3 * h, cfg.output_size)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(
        self, generator: Optional[torch.Generator] = None
    ) -> None:
        """torch's default U(-1/sqrt(fan), 1/sqrt(fan)): fan = H for the
        cell, 3H for the head."""
        h = self.cfg.hidden_size
        for name, p in self.named_parameters():
            scale = 1.0 / math.sqrt(3 * h if name.startswith("linear.") else h)
            p.uniform_(-scale, scale, generator=generator)

    def direction_weights(self, layer: int, reverse: bool,
                          dtype: torch.dtype):
        """One direction's params, cast to the compute dtype."""
        s = _suffix(layer, reverse)
        return self.weights_type(*(
            getattr(self, f"{kind}_{s}").to(dtype)
            for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")))

    def layer(self, x: torch.Tensor, weights, *, reverse: bool,
              mask: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One direction of one layer from zero state: (h_last, hs)."""
        raise NotImplementedError

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
                h_last, hs = self.layer(
                    layer_input,
                    self.direction_weights(layer, d == 1, compute_dtype),
                    reverse=d == 1, mask=mask)
                outs.append(hs)
                finals.append(h_last)
            layer_input = torch.cat(outs, dim=-1) if self.n_dirs == 2 else outs[0]
            # inter-layer dropout (all but the last layer)
            if layer < cfg.n_layers - 1:
                layer_input = dropout(layer_input, cfg.dropout,
                                      training=self.training,
                                      generator=generator)

        last_hidden = torch.stack(finals).sum(dim=0)  # sum directions (B, H)
        out_sum = outs[0] + outs[1] if self.n_dirs == 2 else outs[0]
        return pool_concat_logits(
            self.linear, last_hidden, out_sum,
            mask=mask, seq_len=seq_len, compute_dtype=compute_dtype)
