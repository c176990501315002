"""The wide scan route: the GRU and LSTM recurrences past the kernel pairs'
envelope, the counterpart of the JAX package's ``lax.scan`` path.

``fmda_tpu.ops.gru.select_scan_fn`` (and ``lstm.select_lstm_scan_fn``)
runs the fused Pallas pair only inside ``pallas_gru.kernel_supported``;
past it, at the widths where each step's ``(B, H) x (H, G H)`` product is
a real matrix product, it runs ``lax.scan``, whose step XLA compiles into
that product and one fused pass of gate algebra.  Here, per direction and
layer:

- forward, each step t: ``hh_t = h_{t-1} W_hh^T + b_hh``, one
  ``torch.addmm`` on cuBLAS into one preallocated (B, G H) buffer, then one
  launch of a fused gate kernel (``csrc/scan_wide.cu``), which writes h_t
  (and c_t) into hs[:, t] (cs[:, t]) in place;
- backward (:class:`torch.autograd.Function`): the residuals are xp, the
  initial states, the weights, hs (and cs) only.  Every step's hh is
  recomputed in one product over the B T rows (all h_{t-1} are known), so
  the route rematerialises as the kernel pairs do and ``remat`` needs
  nothing more; then, each step in reverse, one launch of a fused
  gate-backward kernel (dxp_t, the gate gradients the product sees, the
  direct part of dh_{t-1}; for the LSTM dc_{t-1}, and a direct part only
  under a mask) and one product ``dhh_t W_hh``, which the next launch adds
  to the direct part (dh stays in float32; an ``addmm`` could add it only
  in the I/O dtype).  After the sweep, dW_hh is one product over the B T
  rows and db_hh a row sum.

Each gate kernel has its plain version here (the forward's built on
``gru_gate_algebra`` / ``lstm_gate_algebra``, the backward's written out);
the wrappers run them on CPU tensors, and on CUDA tensors launch the
kernel or raise.  The scans themselves are the same code on both: only the
gate step differs.  Which route a layer takes is decided by shape alone,
before any launch: ``kernel_supported`` in :mod:`~fmda_tpu_torch.ops.gru`
and :mod:`~fmda_tpu_torch.ops.lstm`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fmda_tpu_torch.ops import _cuda_lib, call_booked, count_launch
from fmda_tpu_torch.ops.gru_kernel import gru_gate_algebra
from fmda_tpu_torch.ops.lstm_kernel import lstm_gate_algebra
from fmda_tpu_torch.ops.scan_dw import h_prev_of

Tensor = torch.Tensor

# the wrappers' device test, a module global so a rehearsal can stub it
_on_cpu = _cuda_lib.on_cpu

#: Launches of each gate kernel (CPU calls do not count): one a step.
gru_fwd_launches = 0
gru_bwd_launches = 0
lstm_fwd_launches = 0
lstm_bwd_launches = 0

_F32 = torch.float32


def _keep(mask_t: Optional[Tensor]) -> Optional[Tensor]:
    return None if mask_t is None else mask_t[:, None].bool()


# -- the gate kernels' plain versions ------------------------------------------


def gru_wide_gates_reference(xp_t: Tensor, hh_t: Tensor, h_prev: Tensor,
                             mask_t: Optional[Tensor] = None) -> Tensor:
    """One forward step from its hidden pre-activations ``hh_t`` (B, 3H):
    the new h in h_prev's dtype; h_prev where ``mask_t`` (B,) is 0."""
    h = gru_gate_algebra(xp_t, hh_t, h_prev)
    keep = _keep(mask_t)
    return h if keep is None else torch.where(keep, h, h_prev)


def lstm_wide_gates_reference(
    xp_t: Tensor, hh_t: Tensor, h_prev: Tensor, c_prev: Tensor,
    mask_t: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """One LSTM forward step from ``hh_t`` (B, 4H): (h, c) in their dtypes;
    (h_prev, c_prev) where ``mask_t`` is 0."""
    h, c = lstm_gate_algebra(xp_t, hh_t, h_prev, c_prev)
    keep = _keep(mask_t)
    if keep is None:
        return h, c
    return torch.where(keep, h, h_prev), torch.where(keep, c, c_prev)


def _step_cotangent(direct: Optional[Tensor], prod: Optional[Tensor],
                    dhs_t: Tensor) -> Tensor:
    dh = dhs_t.to(_F32)
    for part in (direct, prod):
        if part is not None:
            dh = dh + part.to(_F32)
    return dh


def gru_wide_gates_bwd_reference(
    xp_t: Tensor, hh_t: Tensor, h_prev: Tensor, direct: Tensor,
    prod: Optional[Tensor], dhs_t: Tensor, mask_t: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """One GRU backward step.  The step's cotangent is ``dh = direct + prod
    + dhs_t`` (``prod``, the next step's ``dhh W_hh``, None at the first
    processed step); the gates are recomputed from ``hh_t``.  Returns
    (dxp_t = [dr_pre, dz_pre, dn_pre], dhh_t = [dr_pre, dz_pre, dn_pre r],
    both in xp's dtype, and the direct part of dh_{t-1}, ``dh z``, in
    float32); a masked row gives zeros and passes dh through."""
    hidden = h_prev.shape[-1]
    x, hp, h = xp_t.to(_F32), hh_t.to(_F32), h_prev.to(_F32)
    dh = _step_cotangent(direct, prod, dhs_t)
    r = torch.sigmoid(x[:, :hidden] + hp[:, :hidden])
    z = torch.sigmoid(x[:, hidden:2 * hidden] + hp[:, hidden:2 * hidden])
    n = torch.tanh(x[:, 2 * hidden:] + r * hp[:, 2 * hidden:])
    dn_pre = dh * (1.0 - z) * (1.0 - n * n)
    dr_pre = dn_pre * hp[:, 2 * hidden:] * r * (1.0 - r)
    dz_pre = dh * (h - n) * z * (1.0 - z)
    dxp = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1)
    dhh = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=-1)
    new_direct = dh * z
    keep = _keep(mask_t)
    if keep is not None:
        dxp = torch.where(keep, dxp, 0.0)
        dhh = torch.where(keep, dhh, 0.0)
        new_direct = torch.where(keep, new_direct, dh)
    return dxp.to(xp_t.dtype), dhh.to(xp_t.dtype), new_direct


def lstm_wide_gates_bwd_reference(
    xp_t: Tensor, hh_t: Tensor, c_prev: Tensor, c_t: Tensor,
    direct: Optional[Tensor], prod: Optional[Tensor], dhs_t: Tensor,
    dc: Tensor, mask_t: Optional[Tensor] = None,
) -> Tuple[Tensor, Optional[Tensor], Tensor]:
    """One LSTM backward step: ``dh = direct + prod + dhs_t`` (a None part
    is 0) and the carried ``dc`` (float32), the gates recomputed from
    ``hh_t``, tanh(c) from the stored (rounded) ``c_t``.  Returns (dxp_t,
    the gate gradients rounded once to xp's dtype, which the product also
    sees; the direct part of dh_{t-1}; dc_{t-1} = dc_t f).  h_{t-1} reaches
    a step that runs only through the product, so the direct part is 0
    there: it is returned only under a mask (dh where a row is held, else
    0), None without one.  A masked row gives zero gate gradients and
    passes dh and dc through."""
    hidden = c_prev.shape[-1]
    s = xp_t.to(_F32) + hh_t.to(_F32)
    dh = _step_cotangent(direct, prod, dhs_t)
    dc = dc.to(_F32)
    i = torch.sigmoid(s[:, :hidden])
    f = torch.sigmoid(s[:, hidden:2 * hidden])
    g = torch.tanh(s[:, 2 * hidden:3 * hidden])
    o = torch.sigmoid(s[:, 3 * hidden:])
    tanh_c = torch.tanh(c_t.to(_F32))
    dc_t = dc + dh * o * (1.0 - tanh_c * tanh_c)
    dgates = torch.cat([dc_t * g * i * (1.0 - i),
                        dc_t * c_prev.to(_F32) * f * (1.0 - f),
                        dc_t * i * (1.0 - g * g),
                        dh * tanh_c * o * (1.0 - o)], dim=-1)
    new_direct, new_dc = None, dc_t * f
    keep = _keep(mask_t)
    if keep is not None:
        dgates = torch.where(keep, dgates, 0.0)
        new_direct = torch.where(keep, 0.0, dh)
        new_dc = torch.where(keep, new_dc, dc)
    return dgates.to(xp_t.dtype), new_direct, new_dc


# -- the gate kernels' wrappers ------------------------------------------------
#
# Each takes the step's operands as views (row stride free, last dimension
# contiguous) and writes its outputs into the views it is given: hs[:, t]
# and cs[:, t] forward, dxp[:, t] and dhh[:, t] backward, ``direct`` and
# ``dc`` (contiguous float32 (B, H)) in place.


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def _row(t: Optional[Tensor]) -> int:
    return 0 if t is None else t.stride(0)


def _checked(name: str, gates: int, wide, narrow) -> Tuple[int, int, str]:
    """A launch's checks: a supported dtype; the ``wide`` operands (xp_t
    first) (B, G H) and the ``narrow`` ones (B, H), in xp_t's dtype, each
    last dimension contiguous.  Returns (B, H, the entry's dtype tag)."""
    xp_t = wide[0]
    if xp_t.dtype not in _cuda_lib.SUPPORTED:
        raise TypeError(
            f"{name} kernel takes float32 or bfloat16, got {xp_t.dtype}")
    batch, hidden = xp_t.shape[0], narrow[0].shape[-1]
    for t, cols in [(t, gates * hidden) for t in wide] + [
            (t, hidden) for t in narrow]:
        if (tuple(t.shape) != (batch, cols) or t.dtype != xp_t.dtype
                or t.stride(-1) != 1):
            raise ValueError(
                f"{name}: operands must be ({batch}, {cols}) {xp_t.dtype} "
                f"with a contiguous last dimension, got {tuple(t.shape)} "
                f"{t.dtype} strides {t.stride()}")
    return batch, hidden, _cuda_lib.SUPPORTED[xp_t.dtype]


def _launch(name: str, tag: str, signature: tuple, args: tuple,
            device_of: Tensor) -> None:
    lib = _cuda_lib.load()
    fn = getattr(lib, f"fmda_{name}_{tag}")
    err = call_booked(
        name, signature, fn,
        (*args, _cuda_lib.device_index(device_of),
         _cuda_lib.stream_of(device_of)))
    _cuda_lib.raise_on(lib, err, name)
    count_launch()


def gru_wide_gates(xp_t: Tensor, hh_t: Tensor, h_prev: Tensor,
                   mask_t: Optional[Tensor], out: Tensor) -> Tensor:
    """One GRU forward step into ``out`` (B, H): on CUDA tensors one launch
    of ``gru_wide_fwd`` (counted in :data:`gru_fwd_launches`) or raise; on
    CPU tensors :func:`gru_wide_gates_reference`.  ``mask_t``, when given,
    is a (B,) uint8 column."""
    global gru_fwd_launches
    tensors = [xp_t, hh_t, h_prev, out] + (
        [mask_t] if mask_t is not None else [])
    if _on_cpu("gru_wide_fwd", tensors):
        return out.copy_(gru_wide_gates_reference(xp_t, hh_t, h_prev, mask_t))
    batch, hidden, tag = _checked("gru_wide_fwd", 3, [xp_t, hh_t],
                                  [h_prev, out])
    _launch("gru_wide_fwd", tag,
            (batch, hidden, xp_t.element_size(), mask_t is not None),
            (xp_t.data_ptr(), xp_t.stride(0), hh_t.data_ptr(),
             hh_t.stride(0), h_prev.data_ptr(), h_prev.stride(0),
             _ptr(mask_t), _row(mask_t), out.data_ptr(), out.stride(0),
             batch, hidden), xp_t)
    gru_fwd_launches += 1
    return out


def lstm_wide_gates(xp_t: Tensor, hh_t: Tensor, h_prev: Tensor,
                    c_prev: Tensor, mask_t: Optional[Tensor], h_out: Tensor,
                    c_out: Tensor) -> None:
    """One LSTM forward step into ``h_out`` and ``c_out``: on CUDA tensors
    one launch of ``lstm_wide_fwd`` (counted in :data:`lstm_fwd_launches`)
    or raise; on CPU tensors :func:`lstm_wide_gates_reference`."""
    global lstm_fwd_launches
    tensors = [xp_t, hh_t, h_prev, c_prev, h_out, c_out] + (
        [mask_t] if mask_t is not None else [])
    if _on_cpu("lstm_wide_fwd", tensors):
        h, c = lstm_wide_gates_reference(xp_t, hh_t, h_prev, c_prev, mask_t)
        h_out.copy_(h)
        c_out.copy_(c)
        return
    batch, hidden, tag = _checked("lstm_wide_fwd", 4, [xp_t, hh_t],
                                  [h_prev, c_prev, h_out, c_out])
    _launch("lstm_wide_fwd", tag,
            (batch, hidden, xp_t.element_size(), mask_t is not None),
            (xp_t.data_ptr(), xp_t.stride(0), hh_t.data_ptr(),
             hh_t.stride(0), h_prev.data_ptr(), h_prev.stride(0),
             c_prev.data_ptr(), c_prev.stride(0), _ptr(mask_t),
             _row(mask_t), h_out.data_ptr(), h_out.stride(0),
             c_out.data_ptr(), c_out.stride(0), batch, hidden), xp_t)
    lstm_fwd_launches += 1


def gru_wide_gates_bwd(xp_t: Tensor, hh_t: Tensor, h_prev: Tensor,
                       direct: Tensor, prod: Optional[Tensor], dhs_t: Tensor,
                       mask_t: Optional[Tensor], dxp_out: Tensor,
                       dhh_out: Tensor) -> None:
    """One GRU backward step: dxp_t into ``dxp_out``, dhh_t into
    ``dhh_out``, the direct part of dh_{t-1} into ``direct`` (in place).
    On CUDA tensors one launch of ``gru_wide_bwd`` (counted in
    :data:`gru_bwd_launches`) or raise; on CPU tensors
    :func:`gru_wide_gates_bwd_reference`."""
    global gru_bwd_launches
    tensors = [t for t in (xp_t, hh_t, h_prev, direct, prod, dhs_t, mask_t,
                           dxp_out, dhh_out) if t is not None]
    if _on_cpu("gru_wide_bwd", tensors):
        dxp, dhh, new_direct = gru_wide_gates_bwd_reference(
            xp_t, hh_t, h_prev, direct, prod, dhs_t, mask_t)
        dxp_out.copy_(dxp)
        dhh_out.copy_(dhh)
        direct.copy_(new_direct)
        return
    batch, hidden, tag = _checked("gru_wide_bwd", 3,
                                  [xp_t, hh_t, dxp_out, dhh_out],
                                  [h_prev, dhs_t])
    _check_carry("gru_wide_bwd", (batch, hidden), direct, prod)
    _launch("gru_wide_bwd", tag,
            (batch, hidden, xp_t.element_size(), mask_t is not None,
             prod is not None, True),
            (xp_t.data_ptr(), xp_t.stride(0), hh_t.data_ptr(),
             hh_t.stride(0), h_prev.data_ptr(), h_prev.stride(0),
             _ptr(prod), dhs_t.data_ptr(), dhs_t.stride(0), _ptr(mask_t),
             _row(mask_t), direct.data_ptr(), dxp_out.data_ptr(),
             dxp_out.stride(0), dhh_out.data_ptr(), dhh_out.stride(0),
             batch, hidden), xp_t)
    gru_bwd_launches += 1


def lstm_wide_gates_bwd(xp_t: Tensor, hh_t: Tensor, c_prev: Tensor,
                        c_t: Tensor, direct: Optional[Tensor],
                        prod: Optional[Tensor], dhs_t: Tensor, dc: Tensor,
                        mask_t: Optional[Tensor], dxp_out: Tensor) -> None:
    """One LSTM backward step: dxp_t into ``dxp_out`` and dc_{t-1} into
    ``dc`` (in place); ``direct`` (None: 0) is read, and under a mask, which
    needs it, overwritten with the direct part of dh_{t-1}.  On CUDA
    tensors one launch of ``lstm_wide_bwd`` (counted in
    :data:`lstm_bwd_launches`) or raise; on CPU tensors
    :func:`lstm_wide_gates_bwd_reference`."""
    global lstm_bwd_launches
    if mask_t is not None and direct is None:
        raise ValueError("lstm_wide_bwd: a masked step needs a direct "
                         "buffer (the rows it holds pass dh through)")
    tensors = [t for t in (xp_t, hh_t, c_prev, c_t, direct, prod, dhs_t, dc,
                           mask_t, dxp_out) if t is not None]
    if _on_cpu("lstm_wide_bwd", tensors):
        dxp, new_direct, new_dc = lstm_wide_gates_bwd_reference(
            xp_t, hh_t, c_prev, c_t, direct, prod, dhs_t, dc, mask_t)
        dxp_out.copy_(dxp)
        if new_direct is not None:
            direct.copy_(new_direct)
        dc.copy_(new_dc)
        return
    batch, hidden, tag = _checked("lstm_wide_bwd", 4,
                                  [xp_t, hh_t, dxp_out],
                                  [c_prev, c_t, dhs_t])
    _check_carry("lstm_wide_bwd", (batch, hidden), direct, prod, dc)
    _launch("lstm_wide_bwd", tag,
            (batch, hidden, xp_t.element_size(), mask_t is not None,
             prod is not None, direct is not None),
            (xp_t.data_ptr(), xp_t.stride(0), hh_t.data_ptr(),
             hh_t.stride(0), c_prev.data_ptr(), c_prev.stride(0),
             c_t.data_ptr(), c_t.stride(0), _ptr(prod), dhs_t.data_ptr(),
             dhs_t.stride(0), _ptr(mask_t), _row(mask_t), _ptr(direct),
             dc.data_ptr(), dxp_out.data_ptr(), dxp_out.stride(0), batch,
             hidden), xp_t)
    lstm_bwd_launches += 1


def _check_carry(name: str, shape: Tuple[int, int], direct: Tensor,
                 prod: Optional[Tensor], dc: Optional[Tensor] = None) -> None:
    """The backward's carried buffers that are given, each ``shape`` and
    contiguous: ``direct`` and ``dc`` float32, ``prod`` in the I/O dtype."""
    for label, t, f32 in (("direct", direct, True), ("dc", dc, True),
                          ("prod", prod, False)):
        if t is None:
            continue
        if (tuple(t.shape) != shape or not t.is_contiguous()
                or (f32 and t.dtype != _F32)):
            raise ValueError(f"{name}: {label} must be a contiguous "
                             f"{shape}" + (" float32" if f32 else ""))


# -- the scans -----------------------------------------------------------------


def _order(n_steps: int, reverse: bool):
    return range(n_steps - 1, -1, -1) if reverse else range(n_steps)


def _mask_cols(mask: Optional[Tensor], batch: int, n_steps: int):
    m = _cuda_lib.mask_u8(mask, batch, n_steps)
    return (lambda t: None) if m is None else (lambda t: m[:, t])


def _recompute_hh(h_prevs: Tensor, w_hh: Tensor, b_hh: Tensor) -> Tensor:
    """Every step's hidden pre-activations at once: (B, T, G H) from the
    (B, T, H) states entering the steps, one product over B T rows."""
    batch, n_steps, hidden = h_prevs.shape
    return torch.addmm(b_hh, h_prevs.reshape(-1, hidden), w_hh.t()).view(
        batch, n_steps, -1)


def _weight_grads(dg: Tensor, h_prevs: Tensor, w_hh: Tensor,
                  b_hh: Tensor) -> Tuple[Tensor, Tensor]:
    """dW_hh = sum_t dg_t^T h_{t-1}, one product over B T rows, and db_hh,
    the rows' float32 sum; in w_hh's and b_hh's dtypes."""
    gh, hidden = dg.shape[-1], h_prevs.shape[-1]
    dw = torch.mm(dg.reshape(-1, gh).t(), h_prevs.reshape(-1, hidden))
    db = torch.sum(dg.reshape(-1, gh), dim=0, dtype=_F32)
    return dw.to(w_hh.dtype), db.to(b_hh.dtype)


def gru_wide_scan_fwd(
    xp: Tensor, h0: Tensor, w_hh: Tensor, b_hh: Tensor, *,
    reverse: bool = False, mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """The GRU scan by the wide route: (h_last, hs), the signature of
    :func:`~fmda_tpu_torch.ops.gru_kernel.gru_scan_reference`; h0, w_hh and
    b_hh cast to xp's dtype.  Each step one ``addmm`` and one
    :func:`gru_wide_gates`."""
    dtype = xp.dtype
    h0, w_hh, b_hh = h0.to(dtype), w_hh.to(dtype), b_hh.to(dtype)
    batch, n_steps, gh = xp.shape
    hs = xp.new_empty((batch, n_steps, h0.shape[-1]))
    hh = xp.new_empty((batch, gh))
    col = _mask_cols(mask, batch, n_steps)
    h = h0
    for t in _order(n_steps, reverse):
        torch.addmm(b_hh, h, w_hh.t(), out=hh)
        h = gru_wide_gates(xp[:, t], hh, h, col(t), hs[:, t])
    return h.clone(), hs


def gru_wide_scan_bwd(
    xp: Tensor, h0: Tensor, w_hh: Tensor, b_hh: Tensor, hs: Tensor,
    dh_last: Tensor, dhs: Tensor, *, reverse: bool = False,
    mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The backward of :func:`gru_wide_scan_fwd`: (dxp, dh0, dw_hh, db_hh),
    the signature of
    :func:`~fmda_tpu_torch.ops.gru_kernel.gru_scan_bwd_reference`.  The
    steps' hh recomputed in one product, then each step in reverse one
    :func:`gru_wide_gates_bwd` and one product ``dhh_t W_hh``."""
    dtype = xp.dtype
    w, b = w_hh.to(dtype), b_hh.to(dtype)
    batch, n_steps, gh = xp.shape
    h_prevs = h_prev_of(h0.to(dtype), hs.to(dtype), reverse=reverse)
    hh = _recompute_hh(h_prevs, w, b)
    dhs = dhs.to(dtype).contiguous()  # autograd may hand an expanded one
    dxp, dhh = xp.new_empty(xp.shape), xp.new_empty(xp.shape)
    direct = dh_last.to(_F32).contiguous().clone()
    prod, have_prod = xp.new_empty((batch, h0.shape[-1])), False
    col = _mask_cols(mask, batch, n_steps)
    for t in _order(n_steps, not reverse):
        gru_wide_gates_bwd(xp[:, t], hh[:, t], h_prevs[:, t], direct,
                           prod if have_prod else None, dhs[:, t], col(t),
                           dxp[:, t], dhh[:, t])
        torch.mm(dhh[:, t], w, out=prod)
        have_prod = True
    dh0 = direct + prod.to(_F32) if have_prod else direct
    dw, db = _weight_grads(dhh, h_prevs, w_hh, b_hh)
    return dxp, dh0.to(h0.dtype), dw, db


def lstm_wide_scan_fwd(
    xp: Tensor, h0: Tensor, c0: Tensor, w_hh: Tensor, b_hh: Tensor, *,
    reverse: bool = False, mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The LSTM scan by the wide route: (h_last, c_last, hs, cs), the
    signature of
    :func:`~fmda_tpu_torch.ops.lstm_kernel.lstm_scan_reference`.  Each step
    one ``addmm`` and one :func:`lstm_wide_gates`."""
    dtype = xp.dtype
    h0, c0 = h0.to(dtype), c0.to(dtype)
    w_hh, b_hh = w_hh.to(dtype), b_hh.to(dtype)
    batch, n_steps, gh = xp.shape
    hs = xp.new_empty((batch, n_steps, h0.shape[-1]))
    cs = torch.empty_like(hs)
    hh = xp.new_empty((batch, gh))
    col = _mask_cols(mask, batch, n_steps)
    h, c = h0, c0
    for t in _order(n_steps, reverse):
        torch.addmm(b_hh, h, w_hh.t(), out=hh)
        lstm_wide_gates(xp[:, t], hh, h, c, col(t), hs[:, t], cs[:, t])
        h, c = hs[:, t], cs[:, t]
    return h.clone(), c.clone(), hs, cs


def lstm_wide_scan_bwd(
    xp: Tensor, h0: Tensor, c0: Tensor, w_hh: Tensor, b_hh: Tensor,
    hs: Tensor, cs: Tensor, dh_last: Tensor, dc_last: Tensor, dhs: Tensor,
    *, reverse: bool = False, mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The backward of :func:`lstm_wide_scan_fwd`: (dxp, dh0, dc0, dw_hh,
    db_hh), the signature of
    :func:`~fmda_tpu_torch.ops.lstm_kernel.lstm_scan_bwd_reference`.  The
    gate gradients are dxp and what the product sees.  The direct part of
    dh is dh_last at the first processed step and 0 after it but where a
    mask holds a row, so without a mask the kernel reads it once and never
    writes it, and dh0 is the last product alone."""
    dtype = xp.dtype
    w, b = w_hh.to(dtype), b_hh.to(dtype)
    batch, n_steps, _ = xp.shape
    h_prevs = h_prev_of(h0.to(dtype), hs.to(dtype), reverse=reverse)
    c_prevs = h_prev_of(c0.to(dtype), cs.to(dtype), reverse=reverse)
    hh = _recompute_hh(h_prevs, w, b)
    dhs, cs = dhs.to(dtype).contiguous(), cs.to(dtype)
    dxp = xp.new_empty(xp.shape)
    direct = dh_last.to(_F32).contiguous().clone()
    dc = dc_last.to(_F32).contiguous().clone()
    prod, have_prod = xp.new_empty((batch, h0.shape[-1])), False
    col = _mask_cols(mask, batch, n_steps)
    for t in _order(n_steps, not reverse):
        lstm_wide_gates_bwd(
            xp[:, t], hh[:, t], c_prevs[:, t], cs[:, t],
            direct if mask is not None or not have_prod else None,
            prod if have_prod else None, dhs[:, t], dc, col(t), dxp[:, t])
        torch.mm(dxp[:, t], w, out=prod)
        have_prod = True
    if not have_prod:
        dh0 = direct
    else:
        dh0 = prod.to(_F32) + (direct if mask is not None else 0.0)
    dw, db = _weight_grads(dxp, h_prevs, w_hh, b_hh)
    return dxp, dh0.to(h0.dtype), dc.to(c0.dtype), dw, db


# -- the differentiable scans --------------------------------------------------


class _GRUWideScan(torch.autograd.Function):
    """Forward :func:`gru_wide_scan_fwd`, backward
    :func:`gru_wide_scan_bwd`: the residuals are the inputs and ``hs``."""

    @staticmethod
    def forward(ctx, xp, h0, w_hh, b_hh, mask, reverse):
        h_last, hs = gru_wide_scan_fwd(xp, h0, w_hh, b_hh, reverse=reverse,
                                       mask=mask)
        ctx.save_for_backward(xp, h0, w_hh, b_hh, hs, mask)
        ctx.reverse = reverse
        return h_last, hs

    @staticmethod
    def backward(ctx, dh_last, dhs):
        xp, h0, w_hh, b_hh, hs, mask = ctx.saved_tensors
        grads = gru_wide_scan_bwd(xp, h0, w_hh, b_hh, hs, dh_last, dhs,
                                  reverse=ctx.reverse, mask=mask)
        return (*grads, None, None)


class _LSTMWideScan(torch.autograd.Function):
    """Forward :func:`lstm_wide_scan_fwd`, backward
    :func:`lstm_wide_scan_bwd`: the residuals are the inputs, ``hs`` and
    ``cs``."""

    @staticmethod
    def forward(ctx, xp, h0, c0, w_hh, b_hh, mask, reverse):
        h_last, c_last, hs, cs = lstm_wide_scan_fwd(
            xp, h0, c0, w_hh, b_hh, reverse=reverse, mask=mask)
        ctx.save_for_backward(xp, h0, c0, w_hh, b_hh, hs, cs, mask)
        ctx.reverse = reverse
        return h_last, c_last, hs

    @staticmethod
    def backward(ctx, dh_last, dc_last, dhs):
        xp, h0, c0, w_hh, b_hh, hs, cs, mask = ctx.saved_tensors
        grads = lstm_wide_scan_bwd(xp, h0, c0, w_hh, b_hh, hs, cs, dh_last,
                                   dc_last, dhs, reverse=ctx.reverse,
                                   mask=mask)
        return (*grads, None, None)


def gru_wide_scan(
    xp: Tensor, h0: Tensor, w_hh: Tensor, b_hh: Tensor, *,
    reverse: bool = False, mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """The differentiable GRU scan by the wide route: (h_last, hs), the
    signature of :func:`~fmda_tpu_torch.ops.gru_kernel.gru_scan`."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xp, h0, w_hh, b_hh)):
        return _GRUWideScan.apply(xp, h0, w_hh, b_hh, mask, reverse)
    return gru_wide_scan_fwd(xp, h0, w_hh, b_hh, reverse=reverse, mask=mask)


def lstm_wide_scan(
    xp: Tensor, h0: Tensor, c0: Tensor, w_hh: Tensor, b_hh: Tensor, *,
    reverse: bool = False, mask: Optional[Tensor] = None,
) -> Tuple[Tuple[Tensor, Tensor], Tensor]:
    """The differentiable LSTM scan by the wide route: ((h_last, c_last),
    hs), the signature of :func:`~fmda_tpu_torch.ops.lstm_kernel.lstm_scan`."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xp, h0, c0, w_hh, b_hh)):
        h_last, c_last, hs = _LSTMWideScan.apply(xp, h0, c0, w_hh, b_hh,
                                                 mask, reverse)
    else:
        h_last, c_last, hs, _ = lstm_wide_scan_fwd(
            xp, h0, c0, w_hh, b_hh, reverse=reverse, mask=mask)
    return (h_last, c_last), hs
