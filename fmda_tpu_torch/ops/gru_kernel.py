"""The GRU scan as hand-written CUDA kernels, forward and backward, with
their plain versions and the differentiable op that joins them.

- :func:`gru_scan_fwd` is the port of ``fmda_tpu/ops/pallas_gru.py``'s
  ``_gru_step_kernel``; its plain version :func:`gru_scan_reference` is
  the PyTorch time loop with the same rounding (gate algebra in float32,
  the carry rounded to the I/O dtype each step).
- :func:`gru_scan_bwd` is the port of ``_gru_bwd_kernel``, as two
  kernels: the serial sweep (:func:`gru_scan_bwd_sweep`, whose plain
  version :func:`gru_scan_bwd_sweep_reference` is the reverse time loop
  with the same algebra and the same rounding of ``dg_h``), then the
  weight gradient after it (:func:`fmda_tpu_torch.ops.scan_dw.scan_dw`).
  Its plain version :func:`gru_scan_bwd_reference` composes the two plain
  versions.
- :func:`gru_scan` is the differentiable scan: a
  :class:`torch.autograd.Function` whose forward is :func:`gru_scan_fwd`
  and whose backward is :func:`gru_scan_bwd`, as ``custom_vjp`` joins the
  Pallas pair.

On CUDA tensors each wrapper launches its kernels (from
``csrc/gru_scan.cu`` and ``csrc/scan_dw.cu``, in the library
:mod:`fmda_tpu_torch.ops._cuda_lib` builds at first use) or raises; on CPU
tensors it runs its plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fmda_tpu_torch.ops import _cuda_lib, scan_dw
from fmda_tpu_torch.ops.scan_dw import h_prev_of, scan_dw_reference

# the wrappers' device test, a module global so a rehearsal can stub it
_on_cpu = _cuda_lib.on_cpu

#: Kernel launches made by :func:`gru_scan_fwd` (CPU calls do not count).
launches = 0
#: Kernel launches made by :func:`gru_scan_bwd` (CPU calls do not count).
bwd_launches = 0

_MAX_HIDDEN = 1024


# -- the plain version ---------------------------------------------------------


def gru_gates(
    xp_t: torch.Tensor, h: torch.Tensor, w_hh: torch.Tensor,
    b_hh: torch.Tensor,
) -> torch.Tensor:
    """One step: precomputed input projection + hidden projection -> new h.

    Gate algebra and the hidden product run in float32 whatever the I/O
    dtype (bf16 products are exact in f32, as on the TPU's MXU); the new
    carry is rounded to ``h.dtype``."""
    hidden = h.shape[-1]
    f32 = torch.float32
    hf = h.to(f32)
    hp = torch.matmul(hf, w_hh.to(f32).t()) + b_hh.to(f32)
    x = xp_t.to(f32)
    r = torch.sigmoid(x[..., :hidden] + hp[..., :hidden])
    z = torch.sigmoid(x[..., hidden:2 * hidden] + hp[..., hidden:2 * hidden])
    n = torch.tanh(x[..., 2 * hidden:] + r * hp[..., 2 * hidden:])
    return ((1.0 - z) * n + z * hf).to(h.dtype)


def gru_scan_reference(
    xp: torch.Tensor,
    h0: torch.Tensor,
    w_hh: torch.Tensor,
    b_hh: torch.Tensor,
    *,
    reverse: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan the recurrence over time: the plain version of the kernel.

    Args:
      xp: (B, T, 3H) precomputed input projections.
      h0: (B, H) initial hidden state.
      w_hh, b_hh: recurrent weights, torch layout ``[r, z, n]``.
      reverse: walk t from T-1 down to 0; outputs stay in input order.
      mask: optional (B, T) validity mask; where it is 0 the step carries
        the previous hidden state through unchanged.

    h0, w_hh and b_hh are cast to xp's dtype first, as the kernel's
    wrapper does.  Returns (h_last, hs) with hs (B, T, H).
    """
    dtype = xp.dtype
    h = h0.to(dtype)
    w_hh = w_hh.to(dtype)
    b_hh = b_hh.to(dtype)
    n_steps = xp.shape[1]
    outs = [None] * n_steps
    for t in (range(n_steps - 1, -1, -1) if reverse else range(n_steps)):
        h_new = gru_gates(xp[:, t], h, w_hh, b_hh)
        if mask is not None:
            h_new = torch.where(mask[:, t, None].bool(), h_new, h)
        outs[t] = h_new
        h = h_new
    if not outs:
        return h, xp.new_empty((xp.shape[0], 0, h0.shape[-1]))
    return h, torch.stack(outs, dim=1)


def gru_scan_bwd_sweep_reference(
    xp: torch.Tensor,
    h0: torch.Tensor,
    w_hh: torch.Tensor,
    b_hh: torch.Tensor,
    hs: torch.Tensor,
    dh_last: torch.Tensor,
    dhs: torch.Tensor,
    *,
    reverse: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's serial sweep, an explicit reverse time loop: the
    plain version of the sweep kernel.

    Args:
      xp, h0, w_hh, b_hh, reverse, mask: the forward's inputs.
      hs: (B, T, H) the forward's per-step hiddens.
      dh_last, dhs: cotangents of h_last (B, H) and hs (B, T, H).

    Gates are recomputed from the hidden state entering each step and all
    gate and cotangent algebra runs in float32; ``dg_h = [dr_pre, dz_pre,
    dn_pre r]`` is rounded once to the I/O dtype and that one rounded value
    feeds the dh chain, as in the Pallas kernel (so this is not autograd
    through the forward, which would not round it).  A masked step passes
    dh through and writes zeros.  Returns (dxp, dgn, dh0): dxp (B, T, 3H)
    and dgn (B, T, H), dg_h's n slice, in xp's dtype (with dxp's r and z
    slices, the operand of :func:`~fmda_tpu_torch.ops.scan_dw.scan_dw`);
    dh0 in float32.
    """
    dtype, f32 = xp.dtype, torch.float32
    hidden = h0.shape[-1]
    w = w_hh.to(dtype).to(f32)
    b = b_hh.to(dtype).to(f32)
    h_prevs = h_prev_of(h0.to(dtype), hs, reverse=reverse)
    dh = dh_last.to(f32)
    dxp = torch.zeros(xp.shape, dtype=dtype, device=xp.device)
    dgn = torch.zeros(hs.shape, dtype=dtype, device=xp.device)
    n_steps = xp.shape[1]
    for t in (range(n_steps) if reverse else range(n_steps - 1, -1, -1)):
        h_prev = h_prevs[:, t].to(f32)
        hp = torch.matmul(h_prev, w.t()) + b
        x = xp[:, t].to(f32)
        r = torch.sigmoid(x[:, :hidden] + hp[:, :hidden])
        z = torch.sigmoid(x[:, hidden:2 * hidden] + hp[:, hidden:2 * hidden])
        n = torch.tanh(x[:, 2 * hidden:] + r * hp[:, 2 * hidden:])
        dh = dh + dhs[:, t].to(f32)
        dn = dh * (1.0 - z)
        dz = dh * (h_prev - n)
        dn_pre = dn * (1.0 - n * n)
        dr_pre = dn_pre * hp[:, 2 * hidden:] * r * (1.0 - r)
        dz_pre = dz * z * (1.0 - z)
        dg_x = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1)
        dg_h = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=-1).to(dtype).to(f32)
        chained = dh * z + torch.matmul(dg_h, w)
        if mask is None:
            dh = chained
        else:
            keep = mask[:, t, None].bool()
            dg_x = torch.where(keep, dg_x, 0.0)
            dg_h = torch.where(keep, dg_h, 0.0)
            dh = torch.where(keep, chained, dh)
        dxp[:, t] = dg_x.to(dtype)
        dgn[:, t] = dg_h[:, 2 * hidden:].to(dtype)
    return dxp, dgn, dh


def gru_scan_bwd_reference(
    xp: torch.Tensor,
    h0: torch.Tensor,
    w_hh: torch.Tensor,
    b_hh: torch.Tensor,
    hs: torch.Tensor,
    dh_last: torch.Tensor,
    dhs: torch.Tensor,
    *,
    reverse: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`gru_scan_reference`: the plain version of the
    backward kernels, the sweep (:func:`gru_scan_bwd_sweep_reference`,
    whose arguments these are) and the weight gradient of dxp's r and z
    slices and dgn (:func:`~fmda_tpu_torch.ops.scan_dw.scan_dw_reference`)
    composed.  Returns (dxp, dh0, dw_hh, db_hh): dxp in xp's dtype, the
    others summed in float32 and cast to their inputs' dtypes.
    """
    dxp, dgn, dh0 = gru_scan_bwd_sweep_reference(
        xp, h0, w_hh, b_hh, hs, dh_last, dhs, reverse=reverse, mask=mask)
    dw, db = scan_dw_reference(dxp, h0.to(xp.dtype), hs, reverse=reverse,
                               tail=dgn)
    return dxp, dh0.to(h0.dtype), dw.to(w_hh.dtype), db.to(b_hh.dtype)


# -- the wrapper ---------------------------------------------------------------


def gru_scan_fwd(
    xp: torch.Tensor,
    h0: torch.Tensor,
    w_hh: torch.Tensor,
    b_hh: torch.Tensor,
    *,
    reverse: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRU forward scan: (h_last, hs), the signature of
    :func:`gru_scan_reference`.

    CUDA tensors launch the kernel (one launch, counted in
    :data:`launches`) or raise; CPU tensors run the plain version.  This
    is the raw forward launch and records no backward, so inputs that
    would record a gradient raise rather than get none: train through
    :func:`gru_scan`, or call this under ``torch.inference_mode()``."""
    tensors = [xp, h0, w_hh, b_hh] + ([mask] if mask is not None else [])
    _cuda_lib.refuse_recording("gru_scan_fwd", "gru_scan", tensors)
    if _on_cpu("gru_scan_fwd", tensors):
        return gru_scan_reference(xp, h0, w_hh, b_hh, reverse=reverse,
                                  mask=mask)
    return _launch(xp, h0, w_hh, b_hh, reverse=reverse, mask=mask)


def _check_dtype_and_shapes(name, xp, h0, w_hh, b_hh):
    """The checks both kernels make.  Returns (batch, n_steps, hidden, h0,
    w_hh, b_hh), the last three cast to xp's dtype."""
    batch, n_steps, hidden, cast = _cuda_lib.check_scan_inputs(
        name, xp, 3, _MAX_HIDDEN, h0=h0, w_hh=w_hh, b_hh=b_hh)
    return batch, n_steps, hidden, cast["h0"], cast["w_hh"], cast["b_hh"]


def _launch(xp, h0, w_hh, b_hh, *, reverse, mask):
    global launches
    batch, n_steps, hidden, h0, w_hh, b_hh = _check_dtype_and_shapes(
        "gru_scan_fwd", xp, h0, w_hh, b_hh)
    mask = _cuda_lib.mask_u8(mask, batch, n_steps)
    hs = torch.empty((batch, n_steps, hidden), dtype=xp.dtype,
                     device=xp.device)
    h_last = torch.empty((batch, hidden), dtype=xp.dtype, device=xp.device)
    lib = _cuda_lib.load()
    fn = getattr(lib, f"fmda_gru_scan_fwd_{_cuda_lib.SUPPORTED[xp.dtype]}")
    stream = _cuda_lib.stream_of(xp)
    err = fn(xp.data_ptr(), xp.stride(0), xp.stride(1), h0.data_ptr(),
             w_hh.data_ptr(), b_hh.data_ptr(),
             None if mask is None else mask.data_ptr(), hs.data_ptr(),
             h_last.data_ptr(), batch, n_steps, hidden, int(bool(reverse)),
             _cuda_lib.device_index(xp), stream)
    _cuda_lib.raise_on(lib, err, "gru_scan_fwd")
    launches += 1
    return h_last, hs


def gru_scan_bwd(
    xp: torch.Tensor,
    h0: torch.Tensor,
    w_hh: torch.Tensor,
    b_hh: torch.Tensor,
    hs: torch.Tensor,
    dh_last: torch.Tensor,
    dhs: torch.Tensor,
    *,
    reverse: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """GRU backward scan: (dxp, dh0, dw_hh, db_hh), the signature of
    :func:`gru_scan_bwd_reference`.

    CUDA tensors launch the kernels (one call, counted once in
    :data:`bwd_launches`: the serial sweep, then the weight gradient and
    the reduction of its partials) or raise; CPU tensors run the plain
    version."""
    tensors = [xp, h0, w_hh, b_hh, hs, dh_last, dhs] + (
        [mask] if mask is not None else [])
    if _on_cpu("gru_scan_bwd", tensors):
        return gru_scan_bwd_reference(xp, h0, w_hh, b_hh, hs, dh_last, dhs,
                                      reverse=reverse, mask=mask)
    return _launch_bwd(xp, h0, w_hh, b_hh, hs, dh_last, dhs,
                       reverse=reverse, mask=mask)


def gru_scan_bwd_sweep(
    xp: torch.Tensor,
    h0: torch.Tensor,
    w_hh: torch.Tensor,
    b_hh: torch.Tensor,
    hs: torch.Tensor,
    dh_last: torch.Tensor,
    dhs: torch.Tensor,
    *,
    reverse: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's serial sweep alone: (dxp, dgn, dh0), the signature of
    :func:`gru_scan_bwd_sweep_reference`.  CUDA tensors launch the sweep
    kernel (uncounted: :func:`gru_scan_bwd` is the backward) or raise; CPU
    tensors run the plain version."""
    tensors = [xp, h0, w_hh, b_hh, hs, dh_last, dhs] + (
        [mask] if mask is not None else [])
    if _on_cpu("gru_scan_bwd_sweep", tensors):
        return gru_scan_bwd_sweep_reference(
            xp, h0, w_hh, b_hh, hs, dh_last, dhs, reverse=reverse, mask=mask)
    return _launch_sweep(xp, h0, w_hh, b_hh, hs, dh_last, dhs,
                         reverse=reverse, mask=mask)


def _launch_sweep(xp, h0, w_hh, b_hh, hs, dh_last, dhs, *, reverse, mask):
    batch, n_steps, hidden, h0, w_hh, b_hh = _check_dtype_and_shapes(
        "gru_scan_bwd", xp, h0, w_hh, b_hh)
    _cuda_lib.check_shapes(
        {"hs": (batch, n_steps, hidden), "dhs": (batch, n_steps, hidden),
         "dh_last": (batch, hidden)},
        {"hs": hs, "dhs": dhs, "dh_last": dh_last})
    hs = hs.to(xp.dtype).contiguous()
    dhs = dhs.to(xp.dtype).contiguous()
    dh_last = dh_last.to(torch.float32).contiguous()
    mask = _cuda_lib.mask_u8(mask, batch, n_steps)
    lib = _cuda_lib.load()
    dxp = torch.empty((batch, n_steps, 3 * hidden), dtype=xp.dtype,
                      device=xp.device)
    dgn = torch.empty((batch, n_steps, hidden), dtype=xp.dtype,
                      device=xp.device)
    dh0 = torch.empty((batch, hidden), dtype=torch.float32, device=xp.device)
    fn = getattr(lib, f"fmda_gru_scan_sweep_{_cuda_lib.SUPPORTED[xp.dtype]}")
    err = fn(xp.data_ptr(), xp.stride(0), xp.stride(1), h0.data_ptr(),
             w_hh.data_ptr(), b_hh.data_ptr(), hs.data_ptr(),
             dh_last.data_ptr(), dhs.data_ptr(),
             None if mask is None else mask.data_ptr(), dxp.data_ptr(),
             dgn.data_ptr(), dh0.data_ptr(), batch, n_steps, hidden,
             int(bool(reverse)), _cuda_lib.device_index(xp),
             _cuda_lib.stream_of(xp))
    _cuda_lib.raise_on(lib, err, "gru_scan_bwd")
    return dxp, dgn, dh0


def _launch_bwd(xp, h0, w_hh, b_hh, hs, dh_last, dhs, *, reverse, mask):
    global bwd_launches
    dxp, dgn, dh0 = _launch_sweep(xp, h0, w_hh, b_hh, hs, dh_last, dhs,
                                  reverse=reverse, mask=mask)
    dw, db = scan_dw._launch(dxp, h0, hs, reverse=reverse, tail=dgn)
    bwd_launches += 1
    return dxp, dh0.to(h0.dtype), dw.to(w_hh.dtype), db.to(b_hh.dtype)


# -- the differentiable scan ---------------------------------------------------


class _GRUScan(torch.autograd.Function):
    """Forward :func:`gru_scan_fwd`, backward :func:`gru_scan_bwd`: the
    residuals are the inputs and ``hs`` (the backward recomputes the
    gates), as ``pallas_gru._vjp_fwd`` saves them.  An output whose
    cotangent autograd leaves undefined gets zeros (autograd's
    ``materialize_grads`` default)."""

    @staticmethod
    def forward(ctx, xp, h0, w_hh, b_hh, mask, reverse):
        h_last, hs = gru_scan_fwd(xp, h0, w_hh, b_hh, reverse=reverse,
                                  mask=mask)
        ctx.save_for_backward(xp, h0, w_hh, b_hh, hs, mask)
        ctx.reverse = reverse
        return h_last, hs

    @staticmethod
    def backward(ctx, dh_last, dhs):
        xp, h0, w_hh, b_hh, hs, mask = ctx.saved_tensors
        dxp, dh0, dw_hh, db_hh = gru_scan_bwd(
            xp, h0, w_hh, b_hh, hs, dh_last, dhs, reverse=ctx.reverse,
            mask=mask)
        return dxp, dh0, dw_hh, db_hh, None, None


def gru_scan(
    xp: torch.Tensor,
    h0: torch.Tensor,
    w_hh: torch.Tensor,
    b_hh: torch.Tensor,
    *,
    reverse: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The differentiable GRU scan: (h_last, hs), the signature of
    :func:`gru_scan_reference`.  Where autograd records, the forward and
    backward kernels run as one :class:`torch.autograd.Function` (their
    plain versions on CPU tensors); elsewhere this is
    :func:`gru_scan_fwd`."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xp, h0, w_hh, b_hh)):
        return _GRUScan.apply(xp, h0, w_hh, b_hh, mask, reverse)
    return gru_scan_fwd(xp, h0, w_hh, b_hh, reverse=reverse, mask=mask)
