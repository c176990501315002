"""Temporal transformer price-movement classifier: the attention family,
``ModelConfig(cell="attn")``.

The counterpart of ``fmda_tpu.models.attn.TemporalTransformer``, weight
for weight.  The protocol of the sibling families (spatial input dropout,
a sequence core, the pool-concat head into ``Linear(3H -> n_classes)``)
over a pre-LN transformer encoder:

- ``embed`` Linear(F -> H) plus parameter-free sinusoidal positions;
- ``n_layers`` :class:`EncoderBlock` s (``block_{i}``): pre-LN multi-head
  attention through :func:`fmda_tpu_torch.ops.attention.mha` (the flash
  kernels on a card) and a GELU MLP, residual dropout on both; each
  recomputed in the backward pass when ``cfg.remat``;
- ``ln_final``, then the head over the per-step outputs, the last valid
  position standing for the recurrent families' final hidden.

Parameters are named as the flax tree names them (``embed``,
``block_0.ln_attn``, ``block_0.qkv``, ..., ``ln_final``, ``linear``), so
flax params load through :func:`fmda_tpu_torch.interop.params_from_flax`.
As in flax: LayerNorm's epsilon is 1e-6, GELU is the tanh approximation,
Dense kernels start lecun-normal (truncated) with zero biases, the head
uniform in 1/sqrt(3H).  The family has no carried state: its positions
re-index every tick, so the window re-encode is the Predictor.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fmda_tpu_torch.models.common import dropout, pool_concat_logits, remat
from fmda_tpu_torch.ops.attention import merge_heads, mha, split_heads

#: flax LayerNorm's epsilon (torch's default is 1e-5).
LN_EPS = 1e-6


def sinusoidal_positions(seq_len: int, dim: int,
                         dtype: torch.dtype = torch.float32,
                         device=None) -> torch.Tensor:
    """Parameter-free (T, dim) position encoding, sin and cos interleaved,
    computed in float32 as the reference computes it."""
    f32 = dict(dtype=torch.float32, device=device)
    pos = torch.arange(seq_len, **f32)[:, None]
    half = (dim + 1) // 2
    freq = torch.exp(-torch.log(torch.tensor(10000.0, **f32))
                     * torch.arange(half, **f32) / max(half, 1))
    ang = pos * freq[None, :]
    enc = torch.zeros((seq_len, dim), **f32)
    enc[:, 0::2] = torch.sin(ang)[:, :(dim + 1) // 2]
    enc[:, 1::2] = torch.cos(ang)[:, :dim // 2]
    return enc.to(dtype)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` in x's dtype (params are float32)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _layer_norm(layer: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm: statistics and normalization in float32, the
    result in x's dtype."""
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight,
                        layer.bias, layer.eps).to(x.dtype)


class EncoderBlock(nn.Module):
    """One pre-LN block: multi-head attention and a GELU MLP, each a
    residual with dropout."""

    def __init__(self, cfg) -> None:
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.ln_attn = nn.LayerNorm(h, eps=LN_EPS)
        self.qkv = nn.Linear(h, 3 * h)
        self.proj = nn.Linear(h, h)
        self.ln_mlp = nn.LayerNorm(h, eps=LN_EPS)
        self.mlp_in = nn.Linear(h, 4 * h)
        self.mlp_out = nn.Linear(4 * h, h)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor],
                *, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        cfg = self.cfg
        q, k, v = _linear(self.qkv, _layer_norm(self.ln_attn, x)).chunk(
            3, dim=-1)
        out = mha(split_heads(q, cfg.n_heads), split_heads(k, cfg.n_heads),
                  split_heads(v, cfg.n_heads), causal=cfg.attn_causal,
                  mask=attn_mask)
        out = _linear(self.proj, merge_heads(out))
        rate = cfg.attn_dropout if cfg.attn_dropout is not None else cfg.dropout
        x = x + dropout(out, rate, training=self.training,
                        generator=generator)
        y = _linear(self.mlp_in, _layer_norm(self.ln_mlp, x))
        y = _linear(self.mlp_out, F.gelu(y, approximate="tanh"))
        return x + dropout(y, rate, training=self.training,
                           generator=generator)


class TemporalTransformer(nn.Module):
    """See module docstring.  ``cfg.n_features`` must be resolved."""

    def __init__(self, cfg, *,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        if cfg.n_features is None:
            raise ValueError("ModelConfig.n_features unresolved")
        h, n_heads = cfg.hidden_size, cfg.n_heads
        if h % n_heads != 0:
            raise ValueError(
                f"n_heads={n_heads} must divide hidden_size={h}")
        self.cfg = cfg
        self.embed = nn.Linear(cfg.n_features, h)
        for layer in range(cfg.n_layers):
            self.add_module(f"block_{layer}", EncoderBlock(cfg))
        self.ln_final = nn.LayerNorm(h, eps=LN_EPS)
        self.linear = nn.Linear(3 * h, cfg.output_size)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(
        self, generator: Optional[torch.Generator] = None
    ) -> None:
        """flax's init: Dense kernels lecun-normal (a normal truncated to
        two standard deviations, rescaled to variance 1/fan_in), biases 0,
        LayerNorm scale 1 and bias 0; the head uniform in 1/sqrt(3H), as
        ``fmda_tpu.models.common`` draws it."""
        # std of the unit normal truncated to [-2, 2]
        truncated_std = 0.87962566103423978
        for module in self.modules():
            if isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, nn.Linear) and module is not self.linear:
                std = math.sqrt(1.0 / module.in_features) / truncated_std
                nn.init.trunc_normal_(module.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                module.bias.zero_()
        scale = 1.0 / math.sqrt(3 * self.cfg.hidden_size)
        for p in self.linear.parameters():
            p.uniform_(-scale, scale, generator=generator)

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        *,
        generator: Optional[torch.Generator] = None,
        state=None,
        return_state: bool = False,
    ) -> torch.Tensor:
        """(B, T, F) windows -> (B, n_classes) float32 logits.

        ``mask`` is an optional (B, T) validity mask: keys outside it are
        invisible to every query, and the head pools over valid steps only.
        ``generator`` feeds the dropout masks in training mode.  The family
        carries no state, so ``state`` and ``return_state`` raise."""
        cfg = self.cfg
        if state is not None or return_state:
            raise ValueError(
                "the attn family carries no state between windows: its "
                "positions re-index every tick, so serve it by re-encoding "
                "the window (the Predictor)")
        seq_len = x.shape[1]
        compute_dtype = getattr(torch, cfg.dtype)
        x = dropout(x.to(compute_dtype), cfg.dropout, training=self.training,
                    generator=generator, spatial=cfg.spatial_dropout)
        x = _linear(self.embed, x) + sinusoidal_positions(
            seq_len, cfg.hidden_size, compute_dtype, x.device)[None]
        # a key outside the validity mask is invisible to every query; a
        # fully padded row gives zeros and the head's mask drops it
        attn_mask = None if mask is None else (mask > 0)[:, None, None, :]
        for layer in range(cfg.n_layers):
            block = getattr(self, f"block_{layer}")
            if cfg.remat and torch.is_grad_enabled():
                # recompute each block in the backward instead of keeping
                # its (B, N, T, T)-sized intermediates (long contexts)
                x = remat(block, x, attn_mask, generator=generator)
            else:
                x = block(x, attn_mask, generator=generator)
        x = _layer_norm(self.ln_final, x)
        if mask is None:
            last_hidden = x[:, -1]
        else:  # the last valid position of each row
            idx = ((mask > 0).sum(dim=1) - 1).clamp_min(0)
            last_hidden = x[torch.arange(x.shape[0], device=x.device), idx]
        return pool_concat_logits(
            self.linear, last_hidden, x, mask=mask, seq_len=seq_len,
            compute_dtype=compute_dtype)
