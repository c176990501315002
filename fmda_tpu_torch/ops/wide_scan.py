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

The GRU route runs each forward step as one launch wherever it can
(``csrc/gru_wide_step.cu``, :mod:`~fmda_tpu_torch.ops.gru_wide_step`): the
product on the tensor cores and the gate algebra in its epilogue, hh never
written; its plan (by shape, dtype and the card, before any launch) hands
float32 and H not a multiple of 64 back to the ``addmm`` and gate kernel
above.  Its backward runs each step as one launch where its own plan
lays the step out (``csrc/gru_wide_bwd_step.cu``,
:mod:`~fmda_tpu_torch.ops.gru_wide_bwd_step`): the product ``dhh_{t+1}
W_hh`` on the tensor cores and the gate gradients in its epilogue, the
product never written; float32 and H not a multiple of 64 keep the gate
kernel and the product above.

The LSTM route runs each direction as one persistent launch wherever it
can (``csrc/lstm_persist.cu``): the forward keeps each CTA's slice of W_hh
in shared memory for the whole scan, forms every step's product on the
tensor cores and runs the gate algebra beside it, one grid barrier a step;
the backward sweep does the same with W_hh's columns and the gate
gradients (the products over all B T rows, hh before it and dW_hh after
it, stay as above).  Its plan (:func:`lstm_persist_plan`, by shape, dtype
and the card, before any launch) hands a scan whose W_hh does not fit the
grid's shared memory back to the per-step kernels.

Each kernel has its plain version here (the gate steps' built on
``gru_gate_algebra`` / ``lstm_gate_algebra``, the backward's written out;
the persistent scans' walking the plan's tiles and unit slices); the
wrappers run them on CPU tensors, and on CUDA tensors launch the kernel or
raise.  The scans themselves are the same code on both: only the kernels
differ.  Which route a layer takes is decided by shape alone, before any
launch: ``kernel_supported`` in :mod:`~fmda_tpu_torch.ops.gru` and
:mod:`~fmda_tpu_torch.ops.lstm`.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from fmda_tpu_torch.ops import _cuda_lib, call_booked, count_launch
from fmda_tpu_torch.ops import gru_wide_bwd_step as _bwd
from fmda_tpu_torch.ops import gru_wide_step as _step
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
#: Launches of the persistent LSTM scans: one a direction a forward scan,
#: one a backward call
lstm_persist_fwd_launches = 0
lstm_persist_bwd_launches = 0

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


# -- the persistent LSTM scans -------------------------------------------------


def lstm_persist_plan(batch: int, hidden: int, dtype: torch.dtype,
                      device: torch.device) -> Optional[Dict[str, int]]:
    """The persistent scans' plan for a direction at (batch, hidden) in
    ``dtype`` on ``device``: on a card the library's own
    (``_cuda_lib.persist_plan_query``), for CPU tensors its Python copy at
    the H100's figures (``_cuda_lib.H100_FIGURES``), so the CPU walks the
    card's layout.  None: the per-step kernels keep the scan."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    if device.type != "cuda" or dtype not in _cuda_lib.SUPPORTED:
        return _cuda_lib.persist_plan(batch, hidden, itemsize,
                                      **_cuda_lib.H100_FIGURES)
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    return _card_plan(batch, hidden, dtype, index)


@functools.lru_cache(maxsize=256)
def _card_plan(batch, hidden, dtype, index):
    return _cuda_lib.persist_plan_query(batch, hidden, dtype, index)[0]


def _unit_rows(hidden: int, units: int) -> Tensor:
    """The gate rows of W_hh in the persistent forward's shared layout:
    slice q's 4 U rows, gate-major (row g U + u is W_hh[g H + q U + u])."""
    q, g, u = torch.meshgrid(torch.arange(hidden // units), torch.arange(4),
                             torch.arange(units), indexing="ij")
    return (g * hidden + q * units + u).reshape(-1)


def _k_split(plan: Dict[str, int], backward: bool) -> int:
    """How many K-split groups a bf16 persistent kernel of ``plan`` sums its
    product in (``lstm_persist_plan.h``'s ``ksplit`` of the product's
    warps)."""
    mtiles, nt = plan["rows_pad"] // 16, plan["units"] // 8
    if backward:
        warps = -(-mtiles // plan["mt_bwd"])
    else:
        warps = -(-mtiles // plan["mt"]) * nt
    return _cuda_lib.persist_ksplit(warps)


#: the low float64 mantissa bits a float32 does not hold
_F32_DROP = (1 << 29) - 1


def _add_f32(acc: Tensor, x: Tensor) -> Tensor:
    """float64 ``acc`` (holding float32 values) plus ``x``, rounded toward
    zero to a float32 value kept in float64 (the low 29 mantissa bits
    cleared), as the tensor cores add a k-step's products to their float32
    accumulator."""
    return ((acc + x).view(torch.int64) & ~_F32_DROP).view(torch.float64)


def _tc_product(a: Tensor, w: Tensor, groups: Sequence[int]) -> Tensor:
    """``a`` (R, K) times ``w`` (N, K) transposed, in float32, summed as a
    bf16 kernel sums it on the tensor cores: each k-step of 16 columns
    exactly (float64), added to its K-split group's float32 sum in K's
    order, rounded toward zero (k-step s is group ``groups[s]``), the
    groups' sums then added to group 0's in order.  So a plain version
    rounds its pre-activations and gate gradients to bf16 where the kernel
    does, not a BLAS's order apart.  Of the models
    ``experiments/torch_lstm_persist.py`` tried on the H100 (groups of 16,
    8, 4, 2 columns; to nearest or toward zero), this one gives the
    persistent kernels' bits most often (99.6 % of hs at (512, 1024));
    ``chip_smoke.py``'s witnesses hold the kernels to a float64 scan apart
    from it."""
    rows, k = a.shape
    steps = k // 16
    a64 = a.double().view(rows, steps, 16)
    w64 = w.double().view(w.shape[0], steps, 16)
    sums = [torch.zeros(rows, w.shape[0], dtype=torch.float64,
                        device=a.device) for _ in range(max(groups) + 1)]
    for s0 in range(0, steps, 16):  # 16 k-steps' products at a time
        block = torch.einsum("rsk,nsk->srn", a64[:, s0:s0 + 16],
                             w64[:, s0:s0 + 16])
        for i in range(block.shape[0]):
            q = groups[s0 + i]
            sums[q] = _add_f32(sums[q], block[i])
    total = sums[0].to(_F32)
    for part in sums[1:]:
        total = total + part.to(_F32)
    return total


def _persist_groups(plan: Dict[str, int], backward: bool,
                    k: int) -> List[int]:
    """Each k-step's K-split group in a bf16 persistent kernel of ``plan``
    over K = ``k``: k-step s of a chunk of c steps is group (s mod c) mod
    ks (:func:`_k_split`)."""
    chunk_steps, ks = plan["chunk"] // 16, _k_split(plan, backward)
    return [(s % chunk_steps) % ks for s in range(k // 16)]


def lstm_persist_scan_reference(
    xp: Tensor, h0: Tensor, c0: Tensor, w_hh: Tensor, b_hh: Tensor,
    plan: Dict[str, int], *, reverse: bool = False,
    mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """The plain version of :func:`lstm_persist_fwd`: (hs, cs), the
    product laid out as the plan's unit slices (each slice's 4 U gate rows
    in the kernel's gate-major order; a row's sums do not depend on its
    batch tile).  A step's pre-activations are the float32 product of the
    I/O-dtype h and W_hh (in bf16 summed in the kernel's order:
    :func:`_tc_product`) plus b_hh, rounded once to the I/O dtype (the
    route's addmm); then :func:`lstm_gate_algebra`; a masked row keeps h
    and c."""
    dtype = xp.dtype
    batch, n_steps, gh = xp.shape
    hidden, units = gh // 4, plan["units"]
    rows = _unit_rows(hidden, units).to(xp.device)
    w = w_hh.to(dtype)[rows].float()
    b = b_hh.to(dtype)[rows].float()
    keep = None if mask is None else (mask != 0)
    groups = (_persist_groups(plan, False, hidden)
              if dtype == torch.bfloat16 else None)
    hs = xp.new_empty((batch, n_steps, hidden))
    cs = torch.empty_like(hs)
    h, c = h0.to(dtype), c0.to(dtype)
    for t in _order(n_steps, reverse):
        prod = (_tc_product(h, w, groups) if dtype == torch.bfloat16
                else h.float() @ w.t())
        pre = (prod + b).to(dtype)
        # (rows, Q, 4, U) -> the gate blocks of the whole width
        pre = pre.view(batch, hidden // units, 4, units).transpose(
            1, 2).reshape(batch, gh)
        h_new, c_new = lstm_gate_algebra(xp[:, t], pre, h, c)
        if keep is not None:
            k = keep[:, t, None]
            h_new, c_new = torch.where(k, h_new, h), torch.where(k, c_new, c)
        hs[:, t], cs[:, t] = h_new, c_new
        h, c = h_new, c_new
    return hs, cs


def lstm_persist_sweep_reference(
    xp: Tensor, hh: Tensor, c0: Tensor, cs: Tensor, w_hh: Tensor,
    dhs: Tensor, dh_last: Tensor, dc_last: Tensor, plan: Dict[str, int], *,
    reverse: bool = False, mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The plain version of :func:`lstm_persist_bwd`: (dxp, dh0, dc0, the
    last two float32).  Each step dh = dhs_t + the direct part + the
    float32 product of the previous step's gate gradients (rounded to the
    I/O dtype, as stored) and W_hh's columns (float32 as the plan's unit
    slices; in bf16 summed in the kernel's order: :func:`_tc_product`);
    the gates recomputed from ``hh`` (the steps' recomputed
    pre-activations); the gate gradients, dc and the direct part as
    :func:`lstm_wide_gates_bwd_reference` makes them.  dh0 is the direct
    part plus the product of the last gate gradients."""
    dtype = xp.dtype
    batch, n_steps, gh = xp.shape
    hidden, units = gh // 4, plan["units"]
    w = w_hh.to(dtype).float()
    keep = None if mask is None else (mask != 0).to(torch.uint8)
    groups = (_persist_groups(plan, True, gh) if dtype == torch.bfloat16
              else None)
    dxp = xp.new_empty(xp.shape)
    direct = dh_last.float().clone()
    dc = dc_last.float().clone()
    c_prevs = h_prev_of(c0.to(dtype), cs.to(dtype), reverse=reverse)
    # W_hh's columns a slice: (Q, 4 H, U)
    w_slices = w.view(gh, hidden // units, units).permute(1, 0, 2)

    def product(dg):
        if dtype == torch.bfloat16:
            return _tc_product(dg, w.t(), groups)
        # every slice's (rows, U) product, back in unit order
        return torch.matmul(dg.float()[None], w_slices).permute(
            1, 0, 2).reshape(batch, hidden)

    prev = None
    for t in _order(n_steps, not reverse):
        prod = None if prev is None else product(dxp[:, prev])
        dg, new_direct, dc = lstm_wide_gates_bwd_reference(
            xp[:, t], hh[:, t], c_prevs[:, t], cs[:, t], direct, prod,
            dhs[:, t], dc, None if keep is None else keep[:, t])
        dxp[:, t] = dg
        direct = torch.zeros_like(direct) if new_direct is None else new_direct
        prev = t
    if prev is not None:
        direct = direct + product(dxp[:, prev])
    return dxp, direct, dc


def _persist_checks(name: str, tensors: Dict[str, Tensor],
                    shapes: Dict[str, Tuple[int, ...]],
                    dtypes: Dict[str, torch.dtype]) -> None:
    """Each operand of a persistent launch: its shape and dtype, contiguous
    (``xp``: its last dimension), 16-byte aligned (the bulk copies' and the
    pair loads' condition; xp's row strides even)."""
    for label, t in tensors.items():
        if t is None:
            continue
        if tuple(t.shape) != shapes[label] or t.dtype != dtypes[label]:
            raise ValueError(f"{name}: {label} must be {shapes[label]} "
                             f"{dtypes[label]}, got {tuple(t.shape)} "
                             f"{t.dtype}")
        ok = (t.stride(-1) == 1 and t.stride(0) % 2 == 0
              and t.stride(1) % 2 == 0 if label == "xp"
              else t.is_contiguous())
        if not ok or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be contiguous and "
                             f"16-byte aligned (strides {t.stride()})")


def _aligned(t: Tensor) -> Tensor:
    """``t`` contiguous and 16-byte aligned: itself, or a copy."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _xp_ready(xp: Tensor, multiple: int = 2) -> Tensor:
    """xp as a kernel reads it (a persistent launch a pair of units a load;
    the fused GRU step 16 bytes, ``multiple`` 8): its last dimension
    contiguous, its row strides multiples of ``multiple``, 16-byte
    aligned; itself, or a contiguous copy."""
    if (xp.stride(-1) == 1 and xp.stride(0) % multiple == 0
            and xp.stride(1) % multiple == 0 and xp.data_ptr() % 16 == 0):
        return xp
    return _aligned(xp)


def lstm_persist_fwd(
    xp: Tensor, h0: Tensor, c0: Tensor, w_hh: Tensor, b_hh: Tensor,
    plan: Dict[str, int], *, reverse: bool = False,
    mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """A forward scan direction in one launch: (hs, cs).  On CUDA tensors
    one cooperative launch of ``lstm_persist_fwd`` (counted in
    :data:`lstm_persist_fwd_launches`) laid out by ``plan`` (the library's
    own, :func:`lstm_persist_plan`; the launch refuses one that does not
    fit the card) or raise; on CPU tensors
    :func:`lstm_persist_scan_reference`.  h0, c0, w_hh and b_hh in xp's
    dtype; ``mask`` (B, T) uint8 or None."""
    global lstm_persist_fwd_launches
    tensors = [t for t in (xp, h0, c0, w_hh, b_hh, mask) if t is not None]
    if _on_cpu("lstm_persist_fwd", tensors):
        return lstm_persist_scan_reference(xp, h0, c0, w_hh, b_hh, plan,
                                           reverse=reverse, mask=mask)
    if xp.dtype not in _cuda_lib.SUPPORTED:
        raise TypeError(f"lstm_persist_fwd kernel takes float32 or bfloat16, "
                        f"got {xp.dtype}")
    batch, n_steps, gh = xp.shape
    hidden, dtype = gh // 4, xp.dtype
    _persist_checks(
        "lstm_persist_fwd",
        dict(xp=xp, h0=h0, c0=c0, w_hh=w_hh, b_hh=b_hh, mask=mask),
        dict(xp=(batch, n_steps, gh), h0=(batch, hidden),
             c0=(batch, hidden), w_hh=(gh, hidden), b_hh=(gh,),
             mask=(batch, n_steps)),
        dict(xp=dtype, h0=dtype, c0=dtype, w_hh=dtype, b_hh=dtype,
             mask=torch.uint8))
    hs = xp.new_empty((batch, n_steps, hidden))
    cs = torch.empty_like(hs)
    counter = torch.zeros(1, dtype=torch.int32, device=xp.device)
    tag = _cuda_lib.SUPPORTED[dtype]
    lib = _cuda_lib.load()
    err = call_booked(
        "lstm_persist_fwd",
        (batch, n_steps, hidden, xp.element_size(), mask is not None),
        getattr(lib, f"fmda_lstm_persist_fwd_{tag}"),
        (xp.data_ptr(), xp.stride(0), xp.stride(1), h0.data_ptr(),
         c0.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), _ptr(mask),
         hs.data_ptr(), cs.data_ptr(), counter.data_ptr(),
         _cuda_lib.persist_plan_ints(plan), batch, n_steps, hidden,
         int(reverse), _cuda_lib.device_index(xp),
         _cuda_lib.stream_of(xp)))
    _cuda_lib.raise_on(lib, err, "lstm_persist_fwd")
    count_launch()
    lstm_persist_fwd_launches += 1
    return hs, cs


def lstm_persist_bwd(
    xp: Tensor, hh: Tensor, c0: Tensor, cs: Tensor, w_hh: Tensor,
    dhs: Tensor, dh_last: Tensor, dc_last: Tensor, plan: Dict[str, int], *,
    reverse: bool = False, mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """A backward sweep in one launch: (dxp, dh0, dc0, the last two
    float32).  On CUDA tensors one cooperative launch of
    ``lstm_persist_bwd`` (counted in :data:`lstm_persist_bwd_launches`) or
    raise; on CPU tensors :func:`lstm_persist_sweep_reference`.  ``hh`` is
    the steps' recomputed (B, T, 4 H) pre-activations; every tensor but the
    float32 dh_last and dc_last in xp's dtype."""
    global lstm_persist_bwd_launches
    tensors = [t for t in (xp, hh, c0, cs, w_hh, dhs, dh_last, dc_last, mask)
               if t is not None]
    if _on_cpu("lstm_persist_bwd", tensors):
        return lstm_persist_sweep_reference(
            xp, hh, c0, cs, w_hh, dhs, dh_last, dc_last, plan,
            reverse=reverse, mask=mask)
    if xp.dtype not in _cuda_lib.SUPPORTED:
        raise TypeError(f"lstm_persist_bwd kernel takes float32 or bfloat16, "
                        f"got {xp.dtype}")
    batch, n_steps, gh = xp.shape
    hidden, dtype = gh // 4, xp.dtype
    _persist_checks(
        "lstm_persist_bwd",
        dict(xp=xp, hh=hh, c0=c0, cs=cs, w_hh=w_hh, dhs=dhs, dh_last=dh_last,
             dc_last=dc_last, mask=mask),
        dict(xp=(batch, n_steps, gh), hh=(batch, n_steps, gh),
             c0=(batch, hidden), cs=(batch, n_steps, hidden),
             w_hh=(gh, hidden), dhs=(batch, n_steps, hidden),
             dh_last=(batch, hidden), dc_last=(batch, hidden),
             mask=(batch, n_steps)),
        dict(xp=dtype, hh=dtype, c0=dtype, cs=dtype, w_hh=dtype, dhs=dtype,
             dh_last=_F32, dc_last=_F32, mask=torch.uint8))
    dxp = xp.new_empty((batch, n_steps, gh))
    dh0 = torch.empty((batch, hidden), dtype=_F32, device=xp.device)
    dc0 = torch.empty_like(dh0)
    counter = torch.zeros(1, dtype=torch.int32, device=xp.device)
    tag = _cuda_lib.SUPPORTED[dtype]
    lib = _cuda_lib.load()
    err = call_booked(
        "lstm_persist_bwd",
        (batch, n_steps, hidden, xp.element_size(), mask is not None),
        getattr(lib, f"fmda_lstm_persist_bwd_{tag}"),
        (xp.data_ptr(), xp.stride(0), xp.stride(1), hh.data_ptr(),
         c0.data_ptr(), cs.data_ptr(), w_hh.data_ptr(), dhs.data_ptr(),
         _ptr(mask), dh_last.data_ptr(), dc_last.data_ptr(), dxp.data_ptr(),
         dh0.data_ptr(), dc0.data_ptr(), counter.data_ptr(),
         _cuda_lib.persist_plan_ints(plan), batch, n_steps, hidden,
         int(reverse), _cuda_lib.device_index(xp),
         _cuda_lib.stream_of(xp)))
    _cuda_lib.raise_on(lib, err, "lstm_persist_bwd")
    count_launch()
    lstm_persist_bwd_launches += 1
    return dxp, dh0, dc0


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


def _gate_grads(dg: Tensor, h_prevs: Tensor, w_hh: Tensor,
                b_hh: Tensor) -> Tuple[Tensor, Tensor]:
    """dW_hh and db_hh from the fused GRU backward's (B, T, 4 H) buffer,
    whose columns [0, 2 H) and [3 H, 4 H) are dhh: two products over the
    B T rows, dhh's r and z blocks and its n block, into the row blocks of
    one (3 H, H) result; db_hh the rows' float32 sum; in w_hh's and b_hh's
    dtypes."""
    hidden = h_prevs.shape[-1]
    rows = dg.reshape(-1, 4 * hidden)
    h = h_prevs.reshape(-1, hidden)
    dw = rows.new_empty((3 * hidden, hidden))
    torch.mm(rows[:, :2 * hidden].t(), h, out=dw[:2 * hidden])
    torch.mm(rows[:, 3 * hidden:].t(), h, out=dw[2 * hidden:])
    sums = torch.sum(rows, dim=0, dtype=_F32)
    db = torch.cat((sums[:2 * hidden], sums[3 * hidden:]))
    return dw.to(w_hh.dtype), db.to(b_hh.dtype)


def gru_wide_scan_fwd(
    xp: Tensor, h0: Tensor, w_hh: Tensor, b_hh: Tensor, *,
    reverse: bool = False, mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """The GRU scan by the wide route: (h_last, hs), the signature of
    :func:`~fmda_tpu_torch.ops.gru_kernel.gru_scan_reference`; h0, w_hh and
    b_hh cast to xp's dtype.  Each step one launch of the fused step
    (:func:`~fmda_tpu_torch.ops.gru_wide_step.gru_wide_step_scan`) where
    :func:`~fmda_tpu_torch.ops.gru_wide_step.gru_wide_step_plan` lays the
    step out, else one ``addmm`` and one :func:`gru_wide_gates`."""
    dtype = xp.dtype
    h0, w_hh, b_hh = h0.to(dtype), w_hh.to(dtype), b_hh.to(dtype)
    batch, n_steps, gh = xp.shape
    hs = xp.new_empty((batch, n_steps, h0.shape[-1]))
    plan = (_step.gru_wide_step_plan(batch, gh // 3, dtype, xp.device)
            if n_steps else None)
    if plan is not None:
        _step.gru_wide_step_scan(
            _xp_ready(xp, 8), _aligned(h0), _aligned(w_hh), _aligned(b_hh),
            _cuda_lib.mask_u8(mask, batch, n_steps), hs, plan,
            reverse=reverse)
        return hs[:, 0 if reverse else n_steps - 1].clone(), hs
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
    launch of the fused backward step
    (:func:`~fmda_tpu_torch.ops.gru_wide_bwd_step.gru_wide_bwd_step_scan`)
    where :func:`~fmda_tpu_torch.ops.gru_wide_bwd_step.gru_wide_bwd_step_plan`
    lays the step out, else one :func:`gru_wide_gates_bwd` and one product
    ``dhh_t W_hh``; dh0 the direct part plus the last step's product."""
    dtype = xp.dtype
    w, b = w_hh.to(dtype), b_hh.to(dtype)
    batch, n_steps, gh = xp.shape
    h_prevs = h_prev_of(h0.to(dtype), hs.to(dtype), reverse=reverse)
    hh = _recompute_hh(h_prevs, w, b)
    direct = dh_last.to(_F32).contiguous().clone()
    plan = (_bwd.gru_wide_bwd_step_plan(batch, gh // 3, dtype, xp.device)
            if n_steps else None)
    if plan is not None:
        # one (B, T, 4 H) buffer: dxp its first 3 H columns, dhh its
        # [0, 2 H) and [3 H, 4 H); W_hh^T copied once a call
        dg = xp.new_empty((batch, n_steps, 4 * gh // 3))
        last = _bwd.gru_wide_bwd_step_scan(
            _xp_ready(xp, 8), hh, h_prevs, _aligned(dhs.to(dtype)),
            _cuda_lib.mask_u8(mask, batch, n_steps), _aligned(w.t()), direct,
            dg, plan, reverse=reverse)
        dh0 = direct + torch.mm(_bwd.dhh_of(dg[:, last]), w).to(_F32)
        dw, db = _gate_grads(dg, h_prevs, w_hh, b_hh)
        return dg[..., :gh], dh0.to(h0.dtype), dw, db
    dhs = dhs.to(dtype).contiguous()  # autograd may hand an expanded one
    dxp, dhh = xp.new_empty(xp.shape), xp.new_empty(xp.shape)
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
    :func:`~fmda_tpu_torch.ops.lstm_kernel.lstm_scan_reference`.  One
    :func:`lstm_persist_fwd` where :func:`lstm_persist_plan` lays the scan
    out, else each step one ``addmm`` and one :func:`lstm_wide_gates`."""
    dtype = xp.dtype
    h0, c0 = h0.to(dtype), c0.to(dtype)
    w_hh, b_hh = w_hh.to(dtype), b_hh.to(dtype)
    batch, n_steps, gh = xp.shape
    plan = (lstm_persist_plan(batch, gh // 4, dtype, xp.device)
            if n_steps else None)
    if plan is not None:
        hs, cs = lstm_persist_fwd(
            _xp_ready(xp), _aligned(h0), _aligned(c0), _aligned(w_hh),
            _aligned(b_hh), plan, reverse=reverse,
            mask=_cuda_lib.mask_u8(mask, batch, n_steps))
        last = 0 if reverse else n_steps - 1
        return hs[:, last].clone(), cs[:, last].clone(), hs, cs
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
    writes it, and dh0 is the last product alone.  Where
    :func:`lstm_persist_plan` lays the scan out, the sweep is one
    :func:`lstm_persist_bwd` between the same two products."""
    dtype = xp.dtype
    w, b = w_hh.to(dtype), b_hh.to(dtype)
    batch, n_steps, gh = xp.shape
    h_prevs = h_prev_of(h0.to(dtype), hs.to(dtype), reverse=reverse)
    plan = (lstm_persist_plan(batch, gh // 4, dtype, xp.device)
            if n_steps else None)
    if plan is not None:
        dxp, dh0, dc0 = lstm_persist_bwd(
            _xp_ready(xp), _recompute_hh(h_prevs, w, b), _aligned(c0.to(dtype)),
            _aligned(cs.to(dtype)), _aligned(w), _aligned(dhs.to(dtype)),
            _aligned(dh_last.to(_F32)), _aligned(dc_last.to(_F32)), plan,
            reverse=reverse, mask=_cuda_lib.mask_u8(mask, batch, n_steps))
        dw, db = _weight_grads(dxp, h_prevs, w_hh, b_hh)
        return dxp, dh0.to(h0.dtype), dc0.to(c0.dtype), dw, db
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
