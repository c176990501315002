"""Gated linear-recurrence (SSM) sequence ops, as ``fmda_tpu.ops.ssm``
defines them: the O(1)-state family.

The transition is diagonal and input-gated, so one parameterisation runs
in two modes:

- **parallel (training and backtest) mode**, the whole window at once
  (:func:`ssm_scan_parallel`): ``s_t = a_t * s_{t-1} + u_t`` composes
  associatively, so the window is a log-depth doubling scan
  (:func:`linear_scan_parallel`) instead of a length-T loop;
- **recurrent (serving) mode**, one elementwise step per tick
  (:func:`ssm_cell_step`, the CUDA kernel of
  :mod:`fmda_tpu_torch.ops.ssm_kernel`), carrying a constant-size
  ``(s, ema_fast, ema_slow)`` cache of three H-vectors.

Cell math (gates packed ``[z, v, g]`` along the rows of ``w_ih (3H, F)``)::

    zp, vp, gp = split(x @ W_ih^T + b_ih)
    a_t  = sigmoid(zp + a_base)
    s_t  = a_t * s_{t-1} + (1 - a_t) * vp
    h_t  = s_t * silu(gp) + d * vp

and the head pools with two EMAs of ``h`` at learned per-channel rates
``sigmoid(rho_f)``, ``sigmoid(rho_s)``.  :func:`ssm_scan` is the sequential
reference, op for op the serving step ticked over the window; the parallel
scan reassociates the decay products, so it matches the sequential one to
float tolerance (about 1e-5 in float32 over protocol-length windows), not
to the bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from fmda_tpu_torch.ops.ssm_kernel import (
    SSMWeights,
    ssm_cell_step,
    ssm_cell_step_reference,
    ssm_gates,
)

Tensor = torch.Tensor

__all__ = [
    "N_CARRY", "N_GATES", "SSMWeights", "ema_pool_parallel",
    "linear_scan_parallel", "ssm_cell_step", "ssm_cell_step_reference",
    "ssm_gates", "ssm_input_projection", "ssm_scan", "ssm_scan_parallel",
]


#: Cell-carry arity of the serving cache: (s, ema_fast, ema_slow).
N_CARRY = 3
#: Packed gates in ``w_ih``: [z (decay), v (candidate), g (output gate)].
N_GATES = 3


def ssm_input_projection(x: Tensor, weights: SSMWeights) -> Tensor:
    """All-timestep input projection: (..., F) -> (..., 3H), the family's
    one large product (cuBLAS), outside the recurrence."""
    return F.linear(x, weights.w_ih, weights.b_ih)


def _split_gates(xp: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    hidden = xp.shape[-1] // 3
    return xp[..., :hidden], xp[..., hidden:2 * hidden], xp[..., 2 * hidden:]


def ssm_scan(
    xp: Tensor,
    carry: Tuple[Tensor, ...],
    w: SSMWeights,
    *,
    reverse: bool = False,
) -> Tuple[Tuple[Tensor, ...], Tensor]:
    """Sequential reference scan: :func:`ssm_cell_step_reference` ticked
    over the window.  Returns (carry_last, hs) with hs (B, T, H) in input
    order."""
    n_steps = xp.shape[1]
    outs = [None] * n_steps
    for t in (range(n_steps - 1, -1, -1) if reverse else range(n_steps)):
        outs[t], carry = ssm_cell_step_reference(xp[:, t], carry, w)
    if not outs:
        return tuple(carry), xp.new_empty((xp.shape[0], 0, carry[0].shape[-1]))
    return tuple(carry), torch.stack(outs, dim=1)


def linear_scan_parallel(a: Tensor, u: Tensor,
                         x0: Optional[Tensor] = None) -> Tensor:
    """All prefixes of ``x_t = a_t * x_{t-1} + u_t`` over axis 1, by a
    log-depth doubling scan (Hillis-Steele): after the round of offset k,
    position t holds the composition of the 2k steps ending at t.  Written
    out of place, so autograd differentiates through it.  ``a``, ``u`` are
    (B, T, H); ``x0`` (B, H) folds a carried initial state in
    (``x_t`` gains ``prod(a_1..t) * x0``).

    The tree differs from ``jax.lax.associative_scan``'s, so the two agree
    to float tolerance, not to the bit."""
    n_steps = a.shape[1]
    k = 1
    while k < n_steps:
        u = torch.cat([u[:, :k], a[:, k:] * u[:, :-k] + u[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    if x0 is not None:
        u = u + a * x0[:, None, :]
    return u


def ssm_scan_parallel(
    xp: Tensor,
    w: SSMWeights,
    s0: Optional[Tensor] = None,
    *,
    reverse: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Parallel mode over a whole window: (hs, s_last) with hs (B, T, H),
    in input order; ``reverse`` scans from the newest step down."""
    if reverse:
        xp = torch.flip(xp, dims=[1])
    zp, vp, gp = _split_gates(xp)
    a = torch.sigmoid(zp + w.a_base)
    s = linear_scan_parallel(a, (1.0 - a) * vp, s0)
    hs = s * F.silu(gp) + w.d * vp
    s_last = s[:, -1]
    if reverse:
        hs = torch.flip(hs, dims=[1])
    return hs, s_last


def ema_pool_parallel(hs: Tensor, rho: Tensor,
                      ema0: Optional[Tensor] = None) -> Tensor:
    """Final value of the head EMA ``e_t = r * e_{t-1} + (1 - r) * h_t``
    (``r = sigmoid(rho)``, per channel) over a window, in parallel mode:
    (B, H), the training-mode twin of the serving cache's EMA entries."""
    r = torch.sigmoid(rho)
    a = torch.broadcast_to(r, hs.shape)
    return linear_scan_parallel(a, (1.0 - r) * hs, ema0)[:, -1]
