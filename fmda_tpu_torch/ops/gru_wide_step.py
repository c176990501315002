"""One GRU forward step of the wide scan route in one launch: the product
``h_{t-1} W_hh^T`` and the gate algebra together (``csrc/gru_wide_step.cu``,
``gru_wide_step_fwd``), where the route's first counterpart ran a cuBLAS
``addmm`` into a (B, 3 H) buffer and the gate kernel W1 (``gru_wide_fwd``)
after it.

- :func:`gru_wide_step_plan` lays a step out by (batch, hidden, dtype,
  device) before any launch: on a card the library's own plan
  (``fmda_gru_wide_scan_fwd_plan``), for CPU tensors :func:`step_plan`, its
  Python copy, at the H100's figures (``_cuda_lib.H100_FIGURES``), so the
  CPU walks the card's layout.  None (float32, H not a multiple of 64)
  keeps the pair.
- :func:`gru_wide_step_reference` is the plain version: the product in
  float32 (in bf16 summed in the kernel's order), plus b_hh, rounded to the
  dtype (as the pair's ``addmm`` and the backward's recomputed hh round
  it), then W1's plain version.
- :func:`gru_wide_step_fwd` is the wrapper: on CUDA tensors one launch
  (counted in :data:`launches`) or raise; on CPU tensors the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch

from fmda_tpu_torch.ops import _cuda_lib, call_booked, count_launch

Tensor = torch.Tensor

# the wrapper's device test, a module global so a rehearsal can stub it
_on_cpu = _cuda_lib.on_cpu

#: Launches of the fused step (CPU calls do not count): one a step.
launches = 0

#: gru_wide_step.cu's constants: batch rows and units a CTA (and K a ring
#: slot), the ring's stages and a slot's bytes, the barriers' bytes and the
#: swizzle's alignment
STEP_TILE, STEP_STAGES = 64, 7
STEP_SLOT_BYTES = 4 * STEP_TILE * 128
STEP_BARRIER_BYTES, STEP_ALIGN_BYTES = 128, 1024
STEP_SMEM = (STEP_STAGES * STEP_SLOT_BYTES + STEP_BARRIER_BYTES
             + STEP_ALIGN_BYTES)
#: the plan's fields, in the order ``fmda_gru_wide_scan_fwd_plan`` reports
#: them and the launch takes them
STEP_FIELDS = ("tiles_m", "tiles_n", "mcast", "split", "cluster", "k_steps",
               "grid", "smem")


def step_plan(batch: int, hidden: int, itemsize: int, *, sms: int,
              clusters: Dict[int, int], smem: int = 0
              ) -> Optional[Dict[str, int]]:
    """How ``gru_wide_step_fwd`` lays out a step at (batch, hidden) in an
    I/O dtype of ``itemsize`` bytes on a card of ``sms`` SMs and
    ``clusters`` (size -> resident count): ``gru_wide_step.cu``'s
    ``step_plan``, line for line, a pure function of its arguments.  None
    where the pair keeps the step (float32: the tensor cores hold its
    operands only as TF32; H not a multiple of 64); else the fields of
    :data:`STEP_FIELDS`.  64 x 64 tiles of (rows, units); where they fill
    at most half the SMs, K split over the largest cluster of 8, 4 or 2
    that divides the k-steps, stays within the SMs and is resident all at
    once; else clusters of 2 along an even number of batch tiles (W_hh
    multicast).  ``chip_smoke.py`` holds it to the library's plan query."""
    del smem  # a figure of the persistent scans' plan, not of this one
    if batch < 1 or itemsize != 2 or hidden < STEP_TILE or hidden % STEP_TILE:
        return None
    tiles_m, tiles_n = -(-batch // STEP_TILE), hidden // STEP_TILE
    ctas, k_steps = tiles_m * tiles_n, hidden // STEP_TILE
    mcast = split = 1
    if 2 * ctas <= sms:
        split = next((s for s in (8, 4, 2) if k_steps % s == 0
                      and ctas * s <= sms and ctas <= clusters[s]), 1)
    elif tiles_m % 2 == 0:
        mcast = 2
    return dict(tiles_m=tiles_m, tiles_n=tiles_n, mcast=mcast, split=split,
                cluster=mcast * split, k_steps=k_steps // split,
                grid=ctas * split, smem=STEP_SMEM)


def step_plan_query(batch: int, hidden: int, dtype: torch.dtype,
                    device: int) -> Tuple[Optional[Dict[str, int]],
                                          Dict[str, object]]:
    """The library's own plan of a step on card ``device``
    (``fmda_gru_wide_scan_fwd_plan``): (the plan's fields, or None where the
    pair keeps the step; the card's figures it was made from, as
    :func:`step_plan` takes them)."""
    lib = _cuda_lib.load()
    n = len(STEP_FIELDS)
    out = (ctypes.c_int * (n + 6))()
    err = lib.fmda_gru_wide_scan_fwd_plan(
        batch, hidden, torch.tensor([], dtype=dtype).element_size(), device,
        out)
    _cuda_lib.raise_on(lib, err, "gru_wide_step plan")
    vals = list(out)
    figures = dict(sms=vals[n + 1],
                   clusters=dict(zip((1, 2, 4, 8), vals[n + 2:n + 6])))
    if not vals[0]:
        return None, figures
    return dict(zip(STEP_FIELDS, vals[1:n + 1])), figures


def gru_wide_step_plan(batch: int, hidden: int, dtype: torch.dtype,
                       device: torch.device) -> Optional[Dict[str, int]]:
    """The fused step's plan for (batch, hidden) in ``dtype`` on
    ``device``: on a card the library's own, for CPU tensors its Python
    copy at the H100's figures.  None: the pair (``addmm`` + W1) keeps the
    step."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    if device.type != "cuda":
        return step_plan(batch, hidden, itemsize, **_cuda_lib.H100_FIGURES)
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    return _card_plan(batch, hidden, dtype, index)


@functools.lru_cache(maxsize=256)
def _card_plan(batch, hidden, dtype, index):
    return step_plan_query(batch, hidden, dtype, index)[0]


# -- the plain version and the wrapper ----------------------------------------


def _step_groups(hidden: int, split: int) -> List[int]:
    """Each k-step of 16 columns' K-split rank in a step over K = ``hidden``
    laid out with ``split`` CTAs a cluster along K: contiguous shares of K,
    the ranks' sums added in rank order (``wide_scan._tc_product``'s
    groups)."""
    steps = hidden // 16
    return [s * split // steps for s in range(steps)]


def gru_wide_step_reference(xp_t: Tensor, h_prev: Tensor, w_hh: Tensor,
                            b_hh: Tensor, mask_t: Optional[Tensor] = None,
                            plan: Optional[Dict[str, int]] = None) -> Tensor:
    """One forward step: hh = h_{t-1} W_hh^T in float32 plus b_hh, rounded
    to xp_t's dtype, then the gate algebra of
    :func:`~fmda_tpu_torch.ops.wide_scan.gru_wide_gates_reference`; h_prev
    where ``mask_t`` (B,) is 0.  In bf16 with a ``plan``, the product is
    summed in the kernel's order (``wide_scan._tc_product`` over the
    plan's K split: :func:`_step_groups`), so the plain version rounds hh
    where the kernel does, not a BLAS's order apart; else one float32
    product (the order ``chip_smoke.py``'s ``wide first step`` also holds
    the route to, beside the pair)."""
    from fmda_tpu_torch.ops.wide_scan import (
        _tc_product, gru_wide_gates_reference)

    dtype = xp_t.dtype
    if plan is not None and dtype == torch.bfloat16:
        prod = _tc_product(h_prev, w_hh.to(dtype),
                           _step_groups(h_prev.shape[1], plan["split"]))
    else:
        prod = h_prev.float() @ w_hh.float().t()
    hh = (prod + b_hh.float()).to(dtype)
    return gru_wide_gates_reference(xp_t, hh, h_prev, mask_t)


def _check(xp_t: Tensor, h_prev: Tensor, w_hh: Tensor, b_hh: Tensor,
           mask_t: Optional[Tensor], out: Tensor) -> Tuple[int, int]:
    """A launch's conditions: bf16 operands of the step's shapes, last
    dimensions contiguous; W_hh and b_hh contiguous; every operand 16-byte
    aligned with row strides multiples of 8 (TMA reads h_prev and W_hh, the
    epilogue the rest 16 bytes at a time); mask_t a (B,) uint8 column.
    Returns (B, H)."""
    batch, hidden = h_prev.shape
    shapes = dict(xp_t=(xp_t, (batch, 3 * hidden)),
                  h_prev=(h_prev, (batch, hidden)),
                  w_hh=(w_hh, (3 * hidden, hidden)),
                  b_hh=(b_hh, (3 * hidden,)), out=(out, (batch, hidden)))
    for label, (t, shape) in shapes.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"gru_wide_step_fwd kernel takes bfloat16, got "
                            f"{label} {t.dtype}")
        if tuple(t.shape) != shape or t.stride(-1) != 1:
            raise ValueError(
                f"gru_wide_step_fwd: {label} must be {shape} with a "
                f"contiguous last dimension, got {tuple(t.shape)} strides "
                f"{t.stride()}")
    ok = (w_hh.is_contiguous() and b_hh.is_contiguous()
          and all(t.data_ptr() % 16 == 0 for t in (xp_t, h_prev, w_hh, b_hh,
                                                   out))
          and all(t.stride(0) % 8 == 0 for t in (xp_t, h_prev, out)))
    if not ok:
        raise ValueError("gru_wide_step_fwd: w_hh and b_hh must be "
                         "contiguous, every operand 16-byte aligned, and "
                         "xp_t's, h_prev's and out's row strides multiples "
                         "of 8")
    if mask_t is not None and (tuple(mask_t.shape) != (batch,)
                               or mask_t.dtype != torch.uint8):
        raise ValueError(f"gru_wide_step_fwd: mask_t must be ({batch},) "
                         f"uint8, got {tuple(mask_t.shape)} {mask_t.dtype}")
    return batch, hidden


def _plan_ints(plan: Dict[str, int]):
    return (ctypes.c_int * len(STEP_FIELDS))(*(plan[k] for k in STEP_FIELDS))


def _launch(lib, args: tuple, signature: tuple) -> None:
    """One launch of the kernel with the C entry's ``args``, booked with
    ``signature`` and counted in :data:`launches`; raises on its error."""
    global launches
    err = call_booked("gru_wide_step_fwd", signature,
                      lib.fmda_gru_wide_step_fwd_bf16, args)
    _cuda_lib.raise_on(lib, err, "gru_wide_step_fwd")
    count_launch()
    launches += 1


def gru_wide_step_fwd(xp_t: Tensor, h_prev: Tensor, w_hh: Tensor,
                      b_hh: Tensor, mask_t: Optional[Tensor], out: Tensor,
                      plan: Dict[str, int]) -> Tensor:
    """One GRU forward step into ``out`` (B, H): on CUDA tensors one launch
    of ``gru_wide_step_fwd`` laid out by ``plan`` (:func:`gru_wide_step_plan`;
    the launch refuses one that does not lay out the step), counted in
    :data:`launches`, or raise; on CPU tensors
    :func:`gru_wide_step_reference`.  Operands as :func:`_check` states."""
    tensors = [xp_t, h_prev, w_hh, b_hh, out] + (
        [mask_t] if mask_t is not None else [])
    if _on_cpu("gru_wide_step_fwd", tensors):
        return out.copy_(gru_wide_step_reference(xp_t, h_prev, w_hh, b_hh,
                                                 mask_t, plan))
    batch, hidden = _check(xp_t, h_prev, w_hh, b_hh, mask_t, out)
    _launch(_cuda_lib.load(),
            (xp_t.data_ptr(), xp_t.stride(0), h_prev.data_ptr(),
             h_prev.stride(0), w_hh.data_ptr(), b_hh.data_ptr(),
             None if mask_t is None else mask_t.data_ptr(),
             0 if mask_t is None else mask_t.stride(0), out.data_ptr(),
             out.stride(0), _plan_ints(plan), batch, hidden, 0,
             _cuda_lib.device_index(xp_t), _cuda_lib.stream_of(xp_t)),
            (batch, hidden, 2, mask_t is not None))
    return out


def gru_wide_step_scan(xp: Tensor, h0: Tensor, w_hh: Tensor, b_hh: Tensor,
                       mask: Optional[Tensor], hs: Tensor,
                       plan: Dict[str, int], reverse: bool = False) -> Tensor:
    """A scan direction through the fused step, into ``hs`` (B, T, H): on
    CUDA tensors T launches of ``gru_wide_step_fwd`` (each counted in
    :data:`launches`, from the second on overlapping the one before), the
    operands checked once (every step's are views of the same tensors at
    the same strides, 16-byte multiples apart); on CPU tensors
    :func:`gru_wide_step_fwd` a step.  xp (B, T, 3H) with row strides
    multiples of 8, h0, W_hh and b_hh in its dtype, ``mask`` (B, T) uint8 or
    None."""
    batch, n_steps, gh = xp.shape
    order = range(n_steps - 1, -1, -1) if reverse else range(n_steps)
    tensors = [xp, h0, w_hh, b_hh, hs] + ([mask] if mask is not None else [])
    if _on_cpu("gru_wide_step_fwd", tensors):
        h = h0
        for t in order:
            h = gru_wide_step_fwd(xp[:, t], h, w_hh, b_hh,
                                  None if mask is None else mask[:, t],
                                  hs[:, t], plan)
        return hs
    first = order[0]
    col = None if mask is None else mask[:, first]
    _check(xp[:, first], h0, w_hh, b_hh, col, hs[:, first])
    if xp.stride(1) % 8 or hs.stride(1) % 8:
        raise ValueError("gru_wide_step_scan: xp's and hs's step strides "
                         "must be multiples of 8")
    if tuple(hs.shape) != (batch, n_steps, gh // 3) or (
            mask is not None and tuple(mask.shape) != (batch, n_steps)):
        raise ValueError("gru_wide_step_scan: hs must be (B, T, H) and mask "
                         "(B, T)")
    hidden = gh // 3
    lib = _cuda_lib.load()
    ints = _plan_ints(plan)
    signature = (batch, hidden, 2, mask is not None)
    size = xp.element_size()
    xp_ptr, sx, sxt = xp.data_ptr(), xp.stride(0), xp.stride(1) * size
    hs_ptr, so, sht = hs.data_ptr(), hs.stride(0), hs.stride(1) * size
    m_ptr, sm = (0, 0) if mask is None else (mask.data_ptr(), mask.stride(0))
    w_ptr, b_ptr = w_hh.data_ptr(), b_hh.data_ptr()
    device, stream = _cuda_lib.device_index(xp), _cuda_lib.stream_of(xp)
    h_ptr, sh = h0.data_ptr(), h0.stride(0)
    for i, t in enumerate(order):
        # from the second step on, the last launch is the previous step,
        # the one that wrote h_{t-1} (and nothing else this step reads), so
        # the launch may overlap it ("early")
        _launch(lib, (xp_ptr + t * sxt, sx, h_ptr, sh, w_ptr, b_ptr,
                      m_ptr + t * mask.stride(1) if mask is not None
                      else None, sm, hs_ptr + t * sht, so, ints, batch,
                      hidden, int(i > 0), device, stream), signature)
        h_ptr, sh = hs_ptr + t * sht, so
    return hs
