"""Shared pieces of the recurrent model families: input dropout and the
pool-concat head, as ``fmda_tpu.models.common`` defines them."""

from __future__ import annotations

from typing import Optional

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
