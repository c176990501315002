"""Gated linear-recurrence (SSM) price-movement classifier.

The counterpart of ``fmda_tpu.models.ssm.GatedSSM``, weight for weight:
the training-mode half of the family's dual form.  Each window runs the
parallel scan (:func:`fmda_tpu_torch.ops.ssm.ssm_scan_parallel`, no kernel),
while serving advances the same parameters one tick at a time from the
constant-size ``(s, ema_fast, ema_slow)`` cache through the serve-tick
kernel (:mod:`fmda_tpu_torch.serve.streaming`,
:mod:`fmda_tpu_torch.runtime.session_pool`).

The protocol's shape, as in the sibling families (spatial input dropout,
stacked optionally-bidirectional layers, inter-layer dropout, a
``Linear(3H -> n_classes)`` head over three H-vectors), with two
differences forced by the O(1) cache: the recurrence is a diagonal
input-gated linear scan (no ``h @ W_hh`` product), and the head pools with
two learned-rate EMAs of the output sequence instead of windowed max/mean
(:func:`~fmda_tpu_torch.models.common.ema_concat_logits`).

Parameters carry the JAX package's flax names: ``weight_ih_l0`` (3H, F),
``bias_ih_l0`` (3H,) and the per-channel ``a_base_l0``, ``d_l0``,
``rho_f_l0``, ``rho_s_l0`` (H,), with ``_reverse`` suffixes for the
backward direction and the head under ``linear``, so flax params load
through :func:`fmda_tpu_torch.interop.params_from_flax`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from fmda_tpu_torch.models.common import (
    _suffix,
    dropout,
    ema_concat_logits,
)
from fmda_tpu_torch.ops.ssm import (
    SSMWeights,
    ema_pool_parallel,
    linear_scan_parallel,
    ssm_input_projection,
    ssm_scan_parallel,
)

#: The per-direction parameters, in :class:`SSMWeights`' order.
_PARAM_KINDS = ("weight_ih", "bias_ih", "a_base", "d", "rho_f", "rho_s")


class SSMState(NamedTuple):
    """Carried training-mode state for chunked streaming: each layer's
    diagonal state and the last layer's head EMAs (forward direction
    only: a backward carry would need the future)."""

    s: torch.Tensor  # (n_layers, B, H)
    ema_fast: torch.Tensor  # (B, H)
    ema_slow: torch.Tensor  # (B, H)


def _logit(p: float) -> float:
    return math.log(p / (1.0 - p))


class GatedSSM(nn.Module):
    """See module docstring.  ``cfg.n_features`` must be resolved."""

    def __init__(self, cfg, *,
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
                for kind, shape in zip(_PARAM_KINDS, ((3 * h, in_dim),
                                                      (3 * h,), (h,), (h,),
                                                      (h,), (h,))):
                    self.register_parameter(
                        f"{kind}_{s}", nn.Parameter(torch.empty(shape)))
        self.linear = nn.Linear(3 * h, cfg.output_size)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(
        self, generator: Optional[torch.Generator] = None
    ) -> None:
        """The JAX package's init, drawn from ``generator``: the projection
        and ``d`` U(-1/sqrt(H), 1/sqrt(H)); ``a_base`` so that
        ``sigmoid(a_base)`` is uniform in ``cfg.ssm_decay_range``;
        ``rho_f``, ``rho_s`` the logits of ``cfg.ssm_ema_init``; the head
        U(-1/sqrt(3H), 1/sqrt(3H))."""
        cfg = self.cfg
        lo, hi = cfg.ssm_decay_range
        ema_f, ema_s = cfg.ssm_ema_init
        scale = 1.0 / math.sqrt(cfg.hidden_size)
        for name, p in self.named_parameters():
            kind = name.rsplit("_l", 1)[0]
            if name.startswith("linear."):
                bound = 1.0 / math.sqrt(3 * cfg.hidden_size)
                p.uniform_(-bound, bound, generator=generator)
            elif kind == "a_base":
                u = torch.empty_like(p).uniform_(lo, hi, generator=generator)
                p.copy_(torch.log(u / (1.0 - u)))
            elif kind == "rho_f":
                p.fill_(_logit(ema_f))
            elif kind == "rho_s":
                p.fill_(_logit(ema_s))
            else:
                p.uniform_(-scale, scale, generator=generator)

    def direction_weights(self, layer: int, reverse: bool,
                          dtype: torch.dtype) -> SSMWeights:
        """One direction's params, cast to the compute dtype."""
        s = _suffix(layer, reverse)
        return SSMWeights(*(getattr(self, f"{kind}_{s}").to(dtype)
                            for kind in _PARAM_KINDS))

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        *,
        generator: Optional[torch.Generator] = None,
        state: Optional[SSMState] = None,
        return_state: bool = False,
    ):
        """(B, T, F) windows -> (B, n_classes) float32 logits, the contract
        of :meth:`RecurrentClassifier.forward`.

        A masked step is an identity of the recurrence (decay forced to 1,
        input to 0) and the head EMAs skip it, so a padded window gives its
        unpadded twin's logits."""
        cfg = self.cfg
        if state is not None and cfg.bidirectional:
            raise ValueError(
                "carried SSMState requires bidirectional=False; "
                "re-scan the full window for bidirectional models")
        hidden = cfg.hidden_size
        compute_dtype = getattr(torch, cfg.dtype)
        x = dropout(x.to(compute_dtype), cfg.dropout, training=self.training,
                    generator=generator, spatial=cfg.spatial_dropout)
        m = None if mask is None else mask[..., None].to(compute_dtype)

        layer_input = x
        s_finals = []  # forward-direction per-layer final states
        for layer in range(cfg.n_layers):
            outs, finals = [], []
            for d in range(self.n_dirs):
                reverse = d == 1
                w = self.direction_weights(layer, reverse, compute_dtype)
                if not reverse:
                    w_fwd = w
                xp = ssm_input_projection(layer_input, w)
                if m is not None:
                    # masked steps: decay 1 (zp + a_base = 30, sigmoid ~ 1),
                    # candidate and output gate 0
                    big = torch.tensor(30.0, dtype=compute_dtype,
                                       device=xp.device)
                    zp = torch.where(m > 0, xp[..., :hidden], big - w.a_base)
                    xp = torch.cat([zp, xp[..., hidden:] * m], dim=-1)
                s0 = (state.s[layer].to(compute_dtype)
                      if state is not None and not reverse else None)
                hs, s_last = ssm_scan_parallel(xp, w, s0, reverse=reverse)
                outs.append(hs)
                finals.append(s_last)
            if not cfg.bidirectional:
                s_finals.append(finals[0])
            layer_input = torch.cat(outs, dim=-1) if self.n_dirs == 2 else outs[0]
            if layer < cfg.n_layers - 1:
                layer_input = dropout(layer_input, cfg.dropout,
                                      training=self.training,
                                      generator=generator)

        out_sum = outs[0] + outs[1] if self.n_dirs == 2 else outs[0]
        # the head: EMAs of the direction-summed outputs at the last
        # layer's forward-direction rates, seeded by the carried EMAs
        ef0 = None if state is None else state.ema_fast.to(compute_dtype)
        es0 = None if state is None else state.ema_slow.to(compute_dtype)
        if m is None:
            ema_fast = ema_pool_parallel(out_sum, w_fwd.rho_f, ef0)
            ema_slow = ema_pool_parallel(out_sum, w_fwd.rho_s, es0)
            fwd_last = outs[0][:, -1]
        else:
            # masked steps carry the EMAs through
            emas = []
            for rho, e0 in ((w_fwd.rho_f, ef0), (w_fwd.rho_s, es0)):
                a = torch.where(m > 0, torch.sigmoid(rho).expand_as(out_sum),
                                torch.ones((), dtype=compute_dtype,
                                           device=out_sum.device))
                emas.append(linear_scan_parallel(a, (1.0 - a) * out_sum,
                                                 e0)[:, -1])
            ema_fast, ema_slow = emas
            # the last VALID forward step; the backward scan's end already
            # sits at t = 0 (the reversed scan crossed the padding first)
            idx = (mask.to(torch.int64).sum(dim=1) - 1).clamp_min(0)
            fwd_last = outs[0].gather(
                1, idx[:, None, None].expand(-1, 1, hidden))[:, 0]
        last_hidden = fwd_last + outs[1][:, 0] if self.n_dirs == 2 else fwd_last
        logits = ema_concat_logits(self.linear, last_hidden, ema_fast,
                                   ema_slow)
        if return_state:
            if cfg.bidirectional:
                raise ValueError(
                    "return_state requires bidirectional=False (the "
                    "backward direction cannot be carried)")
            return logits, SSMState(s=torch.stack(s_finals),
                                    ema_fast=ema_fast, ema_slow=ema_slow)
        return logits
