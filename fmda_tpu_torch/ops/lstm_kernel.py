"""The LSTM scan as hand-written CUDA kernels, forward and backward, with
their plain versions and the differentiable op that joins them.

- :func:`lstm_scan_fwd` is the port of ``fmda_tpu/ops/pallas_lstm.py``'s
  ``_lstm_step_kernel``; its plain version :func:`lstm_scan_reference` is
  the PyTorch time loop with the same rounding (gate algebra in float32,
  ``h`` from the unrounded cell state, then ``h`` and ``c`` rounded to the
  I/O dtype each step).  Both return the per-step cell states ``cs``
  beside ``hs``: the backward reads them.
- :func:`lstm_scan_bwd` is the port of ``_lstm_bwd_kernel``, as two
  kernels: the serial sweep (:func:`lstm_scan_bwd_sweep`, whose plain
  version :func:`lstm_scan_bwd_sweep_reference` is the reverse time loop
  with the same algebra: ``tanh(c)`` from the rounded ``cs``, ``dh`` and
  ``dc`` carried in float32, the gate gradients rounded once to the I/O
  dtype), then the weight gradient after it
  (:func:`fmda_tpu_torch.ops.scan_dw.scan_dw`).  Its plain version
  :func:`lstm_scan_bwd_reference` composes the two plain versions.
- :func:`lstm_scan` is the differentiable scan, with the signature of
  ``fmda_tpu.ops.lstm.lstm_scan``: a :class:`torch.autograd.Function`
  whose forward is :func:`lstm_scan_fwd` and whose backward is
  :func:`lstm_scan_bwd`, as ``custom_vjp`` joins the Pallas pair.

Gates are packed ``[i, f, g, o]`` (``nn.LSTM``'s order).  Unlike the
Pallas pair, every function here takes an optional (B, T) mask with
``fmda_tpu.ops.lstm.lstm_scan``'s semantics: a masked step carries ``h``
and ``c`` through, and its backward passes ``dh`` and ``dc`` through.

On CUDA tensors each wrapper launches its kernels (from
``csrc/lstm_scan.cu`` and ``csrc/scan_dw.cu``, in the library
:mod:`fmda_tpu_torch.ops._cuda_lib` builds at first use) or raises; on CPU
tensors it runs its plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fmda_tpu_torch.ops import _cuda_lib, call_booked, count_launch, scan_dw
from fmda_tpu_torch.ops.scan_dw import h_prev_of, scan_dw_reference

# the wrappers' device test, a module global so a rehearsal can stub it
_on_cpu = _cuda_lib.on_cpu

#: Kernel launches made by :func:`lstm_scan_fwd` (CPU calls do not count).
launches = 0
#: Kernel launches made by :func:`lstm_scan_bwd` (CPU calls do not count).
bwd_launches = 0

#: The forward kernel runs one thread per (batch row, hidden unit), the
#: backward sweep one to four, in blocks of at most 512 threads
#: (csrc/lstm_scan.cu, kMaxThreads).
_MAX_HIDDEN = 512

Tensor = torch.Tensor


def kernel_supported(batch: int, seq_len: int, hidden: int,
                     itemsize: int) -> bool:
    """The LSTM twin of
    :func:`fmda_tpu_torch.ops.gru_kernel.kernel_supported` (the counterpart
    of ``fmda_tpu.ops.pallas_lstm.kernel_supported``): True where the
    kernel pair (:func:`lstm_scan`) runs the scan, wherever its forward
    holds W_hh on chip within its hidden limit of 512; false where the wide
    route runs it (every H > 512 among them).  A pure function of shape and
    dtype."""
    del batch, seq_len  # the card's crossover is in hidden and dtype alone
    return _cuda_lib.pair_runs(4, hidden, itemsize, _MAX_HIDDEN)


# -- the plain version ---------------------------------------------------------


def lstm_gates(
    xp_t: Tensor, h: Tensor, c: Tensor, w_hh: Tensor, b_hh: Tensor,
) -> Tuple[Tensor, Tensor]:
    """One step: precomputed input projection + hidden projection -> (new h,
    new c).

    Gate algebra and the hidden product run in float32 whatever the I/O
    dtype; the new h comes from the unrounded float32 cell state, then h
    and c are rounded to their dtypes (the Pallas kernel's order)."""
    f32 = torch.float32
    hp = torch.matmul(h.to(f32), w_hh.to(f32).t()) + b_hh.to(f32)
    return lstm_gate_algebra(xp_t, hp, h, c)


def lstm_gate_algebra(
    xp_t: Tensor, hp: Tensor, h: Tensor, c: Tensor,
) -> Tuple[Tensor, Tensor]:
    """The step's gate algebra from its hidden pre-activations ``hp`` (h .
    W_hh^T + b_hh), in float32; h from the unrounded float32 cell state,
    then h and c rounded to their dtypes."""
    hidden = h.shape[-1]
    f32 = torch.float32
    s = xp_t.to(f32) + hp.to(f32)
    i = torch.sigmoid(s[..., :hidden])
    f = torch.sigmoid(s[..., hidden:2 * hidden])
    g = torch.tanh(s[..., 2 * hidden:3 * hidden])
    o = torch.sigmoid(s[..., 3 * hidden:])
    c_new = f * c.to(f32) + i * g
    return (o * torch.tanh(c_new)).to(h.dtype), c_new.to(c.dtype)


def lstm_scan_reference(
    xp: Tensor,
    h0: Tensor,
    c0: Tensor,
    w_hh: Tensor,
    b_hh: Tensor,
    *,
    reverse: bool = False,
    mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Scan the recurrence over time: the plain version of the kernel.

    Args:
      xp: (B, T, 4H) precomputed input projections.
      h0, c0: (B, H) initial hidden and cell states.
      w_hh, b_hh: recurrent weights, torch layout ``[i, f, g, o]``.
      reverse: walk t from T-1 down to 0; outputs stay in input order.
      mask: optional (B, T) validity mask; where it is 0 the step carries
        the previous h and c through unchanged.

    h0, c0, w_hh and b_hh are cast to xp's dtype first, as the kernel's
    wrapper does.  Returns (h_last, c_last, hs, cs) with hs and cs
    (B, T, H).
    """
    dtype = xp.dtype
    h, c = h0.to(dtype), c0.to(dtype)
    w_hh, b_hh = w_hh.to(dtype), b_hh.to(dtype)
    n_steps = xp.shape[1]
    hs, cs = [None] * n_steps, [None] * n_steps
    for t in (range(n_steps - 1, -1, -1) if reverse else range(n_steps)):
        h_new, c_new = lstm_gates(xp[:, t], h, c, w_hh, b_hh)
        if mask is not None:
            keep = mask[:, t, None].bool()
            h_new = torch.where(keep, h_new, h)
            c_new = torch.where(keep, c_new, c)
        hs[t], cs[t] = h_new, c_new
        h, c = h_new, c_new
    if not n_steps:
        empty = xp.new_empty((xp.shape[0], 0, h0.shape[-1]))
        return h, c, empty, empty.clone()
    return h, c, torch.stack(hs, dim=1), torch.stack(cs, dim=1)


def lstm_scan_bwd_sweep_reference(
    xp: Tensor,
    h0: Tensor,
    c0: Tensor,
    w_hh: Tensor,
    b_hh: Tensor,
    hs: Tensor,
    cs: Tensor,
    dh_last: Tensor,
    dc_last: Tensor,
    dhs: Tensor,
    *,
    reverse: bool = False,
    mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The backward's serial sweep, an explicit reverse time loop: the
    plain version of the sweep kernel.

    Args:
      xp, h0, c0, w_hh, b_hh, reverse, mask: the forward's inputs.
      hs, cs: (B, T, H) the forward's per-step hidden and cell states.
      dh_last, dc_last, dhs: cotangents of h_last, c_last (B, H) and hs
        (B, T, H).

    Gates are recomputed from the state entering each step (h0/c0 at the
    first processed step, else hs/cs of the previous one), ``tanh(c)``
    from the rounded ``cs``, and all gate and cotangent algebra runs in
    float32; the gate gradients are rounded once to the I/O dtype and that
    one value is dxp and feeds the dh chain, as in the Pallas kernel (so in
    bfloat16 this is not autograd through the forward).  A masked step
    passes dh and dc through and writes zeros.  Returns (dxp, dh0, dc0):
    dxp in xp's dtype (the operand of
    :func:`~fmda_tpu_torch.ops.scan_dw.scan_dw`), dh0 and dc0 in float32.
    """
    dtype, f32 = xp.dtype, torch.float32
    hidden = h0.shape[-1]
    w = w_hh.to(dtype).to(f32)
    b = b_hh.to(dtype).to(f32)
    h_prevs = h_prev_of(h0.to(dtype), hs, reverse=reverse)
    c_prevs = h_prev_of(c0.to(dtype), cs, reverse=reverse)
    dh, dc = dh_last.to(f32), dc_last.to(f32)
    dxp = torch.zeros(xp.shape, dtype=dtype, device=xp.device)
    n_steps = xp.shape[1]
    for t in (range(n_steps) if reverse else range(n_steps - 1, -1, -1)):
        h_prev, c_prev = h_prevs[:, t].to(f32), c_prevs[:, t].to(f32)
        pre = xp[:, t].to(f32) + (torch.matmul(h_prev, w.t()) + b)
        i = torch.sigmoid(pre[:, :hidden])
        f = torch.sigmoid(pre[:, hidden:2 * hidden])
        g = torch.tanh(pre[:, 2 * hidden:3 * hidden])
        o = torch.sigmoid(pre[:, 3 * hidden:])
        tanh_c = torch.tanh(cs[:, t].to(f32))
        dh = dh + dhs[:, t].to(f32)
        d_o = dh * tanh_c
        dc_t = dc + dh * o * (1.0 - tanh_c * tanh_c)
        dgates = torch.cat([dc_t * g * i * (1.0 - i),
                            dc_t * c_prev * f * (1.0 - f),
                            dc_t * i * (1.0 - g * g),
                            d_o * o * (1.0 - o)], dim=-1).to(dtype).to(f32)
        chained_dh, chained_dc = torch.matmul(dgates, w), dc_t * f
        if mask is None:
            dh, dc = chained_dh, chained_dc
        else:
            keep = mask[:, t, None].bool()
            dgates = torch.where(keep, dgates, 0.0)
            dh = torch.where(keep, chained_dh, dh)
            dc = torch.where(keep, chained_dc, dc)
        dxp[:, t] = dgates.to(dtype)
    return dxp, dh, dc


def lstm_scan_bwd_reference(
    xp: Tensor,
    h0: Tensor,
    c0: Tensor,
    w_hh: Tensor,
    b_hh: Tensor,
    hs: Tensor,
    cs: Tensor,
    dh_last: Tensor,
    dc_last: Tensor,
    dhs: Tensor,
    *,
    reverse: bool = False,
    mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The backward of :func:`lstm_scan_reference`: the plain version of
    the backward kernels, the sweep (:func:`lstm_scan_bwd_sweep_reference`,
    whose arguments these are) and the weight gradient of dxp
    (:func:`~fmda_tpu_torch.ops.scan_dw.scan_dw_reference`) composed.
    Returns (dxp, dh0, dc0, dw_hh, db_hh): dxp in xp's dtype, the others
    summed in float32 and cast to their inputs' dtypes.
    """
    dxp, dh0, dc0 = lstm_scan_bwd_sweep_reference(
        xp, h0, c0, w_hh, b_hh, hs, cs, dh_last, dc_last, dhs,
        reverse=reverse, mask=mask)
    dw, db = scan_dw_reference(dxp, h0.to(xp.dtype), hs, reverse=reverse)
    return (dxp, dh0.to(h0.dtype), dc0.to(c0.dtype), dw.to(w_hh.dtype),
            db.to(b_hh.dtype))


# -- the wrappers --------------------------------------------------------------


def lstm_scan_fwd(
    xp: Tensor,
    h0: Tensor,
    c0: Tensor,
    w_hh: Tensor,
    b_hh: Tensor,
    *,
    reverse: bool = False,
    mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """LSTM forward scan: (h_last, c_last, hs, cs), the signature of
    :func:`lstm_scan_reference`.

    CUDA tensors launch the kernel (one launch, counted in
    :data:`launches`) or raise; CPU tensors run the plain version.  This
    is the raw forward launch and records no backward, so inputs that
    would record a gradient raise rather than get none: train through
    :func:`lstm_scan`, or call this under ``torch.inference_mode()``."""
    tensors = [xp, h0, c0, w_hh, b_hh] + ([mask] if mask is not None else [])
    _cuda_lib.refuse_recording("lstm_scan_fwd", "lstm_scan", tensors)
    if _on_cpu("lstm_scan_fwd", tensors):
        return lstm_scan_reference(xp, h0, c0, w_hh, b_hh, reverse=reverse,
                                   mask=mask)
    return _launch(xp, h0, c0, w_hh, b_hh, reverse=reverse, mask=mask)


def _launch(xp, h0, c0, w_hh, b_hh, *, reverse, mask):
    global launches
    batch, n_steps, hidden, p = _cuda_lib.check_scan_inputs(
        "lstm_scan_fwd", xp, 4, _MAX_HIDDEN, h0=h0, c0=c0, w_hh=w_hh,
        b_hh=b_hh)
    mask = _cuda_lib.mask_u8(mask, batch, n_steps)
    hs, cs = (torch.empty((batch, n_steps, hidden), dtype=xp.dtype,
                          device=xp.device) for _ in range(2))
    h_last, c_last = (torch.empty((batch, hidden), dtype=xp.dtype,
                                  device=xp.device) for _ in range(2))
    lib = _cuda_lib.load()
    fn = getattr(lib, f"fmda_lstm_scan_fwd_{_cuda_lib.SUPPORTED[xp.dtype]}")
    err = call_booked(
        "lstm_scan_fwd",
        (batch, n_steps, hidden, xp.element_size(), mask is not None), fn,
        (xp.data_ptr(), xp.stride(0), xp.stride(1), p["h0"].data_ptr(),
         p["c0"].data_ptr(), p["w_hh"].data_ptr(), p["b_hh"].data_ptr(),
         None if mask is None else mask.data_ptr(), hs.data_ptr(),
         cs.data_ptr(), h_last.data_ptr(), c_last.data_ptr(), batch,
         n_steps, hidden, int(bool(reverse)), _cuda_lib.device_index(xp),
         _cuda_lib.stream_of(xp)))
    _cuda_lib.raise_on(lib, err, "lstm_scan_fwd")
    launches += 1
    count_launch()
    return h_last, c_last, hs, cs


def lstm_scan_bwd(
    xp: Tensor,
    h0: Tensor,
    c0: Tensor,
    w_hh: Tensor,
    b_hh: Tensor,
    hs: Tensor,
    cs: Tensor,
    dh_last: Tensor,
    dc_last: Tensor,
    dhs: Tensor,
    *,
    reverse: bool = False,
    mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """LSTM backward scan: (dxp, dh0, dc0, dw_hh, db_hh), the signature of
    :func:`lstm_scan_bwd_reference`.

    CUDA tensors launch the kernels (one call, counted once in
    :data:`bwd_launches`: the serial sweep, then the weight gradient and
    the reduction of its partials) or raise; CPU tensors run the plain
    version."""
    tensors = [xp, h0, c0, w_hh, b_hh, hs, cs, dh_last, dc_last, dhs] + (
        [mask] if mask is not None else [])
    if _on_cpu("lstm_scan_bwd", tensors):
        return lstm_scan_bwd_reference(
            xp, h0, c0, w_hh, b_hh, hs, cs, dh_last, dc_last, dhs,
            reverse=reverse, mask=mask)
    return _launch_bwd(xp, h0, c0, w_hh, b_hh, hs, cs, dh_last, dc_last, dhs,
                       reverse=reverse, mask=mask)


def lstm_scan_bwd_sweep(
    xp: Tensor,
    h0: Tensor,
    c0: Tensor,
    w_hh: Tensor,
    b_hh: Tensor,
    hs: Tensor,
    cs: Tensor,
    dh_last: Tensor,
    dc_last: Tensor,
    dhs: Tensor,
    *,
    reverse: bool = False,
    mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The backward's serial sweep alone: (dxp, dh0, dc0), the signature of
    :func:`lstm_scan_bwd_sweep_reference`.  CUDA tensors launch the sweep
    kernel (uncounted: :func:`lstm_scan_bwd` is the backward) or raise;
    CPU tensors run the plain version."""
    tensors = [xp, h0, c0, w_hh, b_hh, hs, cs, dh_last, dc_last, dhs] + (
        [mask] if mask is not None else [])
    if _on_cpu("lstm_scan_bwd_sweep", tensors):
        return lstm_scan_bwd_sweep_reference(
            xp, h0, c0, w_hh, b_hh, hs, cs, dh_last, dc_last, dhs,
            reverse=reverse, mask=mask)
    return _launch_sweep(xp, h0, c0, w_hh, b_hh, hs, cs, dh_last, dc_last,
                         dhs, reverse=reverse, mask=mask)


def _launch_sweep(xp, h0, c0, w_hh, b_hh, hs, cs, dh_last, dc_last, dhs, *,
                  reverse, mask):
    batch, n_steps, hidden, p = _cuda_lib.check_scan_inputs(
        "lstm_scan_bwd", xp, 4, _MAX_HIDDEN, h0=h0, c0=c0, w_hh=w_hh,
        b_hh=b_hh)
    seq, state = (batch, n_steps, hidden), (batch, hidden)
    _cuda_lib.check_shapes(
        {"hs": seq, "cs": seq, "dhs": seq, "dh_last": state,
         "dc_last": state},
        {"hs": hs, "cs": cs, "dhs": dhs, "dh_last": dh_last,
         "dc_last": dc_last})
    hs, cs, dhs = (t.to(xp.dtype).contiguous() for t in (hs, cs, dhs))
    dh_last, dc_last = (t.to(torch.float32).contiguous()
                        for t in (dh_last, dc_last))
    mask = _cuda_lib.mask_u8(mask, batch, n_steps)
    lib = _cuda_lib.load()
    dxp = torch.empty((batch, n_steps, 4 * hidden), dtype=xp.dtype,
                      device=xp.device)
    dh0, dc0 = (torch.empty(state, dtype=torch.float32, device=xp.device)
                for _ in range(2))
    fn = getattr(lib, f"fmda_lstm_scan_sweep_{_cuda_lib.SUPPORTED[xp.dtype]}")
    err = call_booked(
        "lstm_scan_bwd",
        (batch, n_steps, hidden, xp.element_size(), mask is not None), fn,
        (xp.data_ptr(), xp.stride(0), xp.stride(1), p["h0"].data_ptr(),
         p["c0"].data_ptr(), p["w_hh"].data_ptr(), p["b_hh"].data_ptr(),
         hs.data_ptr(), cs.data_ptr(), dh_last.data_ptr(),
         dc_last.data_ptr(), dhs.data_ptr(),
         None if mask is None else mask.data_ptr(), dxp.data_ptr(),
         dh0.data_ptr(), dc0.data_ptr(), batch, n_steps, hidden,
         int(bool(reverse)), _cuda_lib.device_index(xp),
         _cuda_lib.stream_of(xp)))
    _cuda_lib.raise_on(lib, err, "lstm_scan_bwd")
    return dxp, dh0, dc0


def _launch_bwd(xp, h0, c0, w_hh, b_hh, hs, cs, dh_last, dc_last, dhs, *,
                reverse, mask):
    global bwd_launches
    dxp, dh0, dc0 = _launch_sweep(xp, h0, c0, w_hh, b_hh, hs, cs, dh_last,
                                  dc_last, dhs, reverse=reverse, mask=mask)
    dw, db = scan_dw._launch(dxp, h0, hs, reverse=reverse, tail=None)
    bwd_launches += 1
    count_launch()
    return (dxp, dh0.to(h0.dtype), dc0.to(c0.dtype), dw.to(w_hh.dtype),
            db.to(b_hh.dtype))


# -- the differentiable scan ---------------------------------------------------


class _LSTMScan(torch.autograd.Function):
    """Forward :func:`lstm_scan_fwd`, backward :func:`lstm_scan_bwd`: the
    residuals are the inputs, ``hs`` and ``cs`` (the backward recomputes
    the gates), as ``pallas_lstm._vjp_fwd`` saves them.  An output whose
    cotangent autograd leaves undefined (``c_last`` in the model) gets
    zeros (autograd's ``materialize_grads`` default)."""

    @staticmethod
    def forward(ctx, xp, h0, c0, w_hh, b_hh, mask, reverse):
        h_last, c_last, hs, cs = lstm_scan_fwd(xp, h0, c0, w_hh, b_hh,
                                               reverse=reverse, mask=mask)
        ctx.save_for_backward(xp, h0, c0, w_hh, b_hh, hs, cs, mask)
        ctx.reverse = reverse
        return h_last, c_last, hs

    @staticmethod
    def backward(ctx, dh_last, dc_last, dhs):
        xp, h0, c0, w_hh, b_hh, hs, cs, mask = ctx.saved_tensors
        grads = lstm_scan_bwd(xp, h0, c0, w_hh, b_hh, hs, cs, dh_last,
                              dc_last, dhs, reverse=ctx.reverse, mask=mask)
        return (*grads, None, None)


def lstm_scan(
    xp: Tensor,
    h0: Tensor,
    c0: Tensor,
    w_hh: Tensor,
    b_hh: Tensor,
    *,
    reverse: bool = False,
    mask: Optional[Tensor] = None,
) -> Tuple[Tuple[Tensor, Tensor], Tensor]:
    """The differentiable LSTM scan: ((h_last, c_last), hs), the signature
    of ``fmda_tpu.ops.lstm.lstm_scan``.  Where autograd records, the
    forward and backward kernels run as one :class:`torch.autograd.Function`
    (their plain versions on CPU tensors); elsewhere this is
    :func:`lstm_scan_fwd`, its ``cs`` dropped."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xp, h0, c0, w_hh, b_hh)):
        h_last, c_last, hs = _LSTMScan.apply(xp, h0, c0, w_hh, b_hh, mask,
                                             reverse)
    else:
        h_last, c_last, hs, _ = lstm_scan_fwd(xp, h0, c0, w_hh, b_hh,
                                              reverse=reverse, mask=mask)
    return (h_last, c_last), hs
