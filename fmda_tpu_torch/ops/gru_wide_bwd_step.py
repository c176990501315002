"""One GRU backward step of the wide scan route in one launch: the product
``dhh_{t+1} W_hh`` and the step's gate gradients together
(``csrc/gru_wide_bwd_step.cu``, ``gru_wide_bwd_step``), where the route's
first counterpart ran the gate kernel W2 (``gru_wide_bwd``), which read the
previous step's product back from device memory rounded to the I/O dtype,
and a cuBLAS ``mm`` after it.

A direction's outputs go to one (B, T, 4 H) buffer ``dg``: step t's row is
[dr, dz, dn, dn r], so ``dg[..., :3 H]`` is dxp and columns [0, 2 H) and
[3 H, 4 H) are dhh_t = [dr, dz, dn r], the next step's product operand
(:func:`dhh_of`); each value is written once.

- :func:`gru_wide_bwd_step_plan` lays a step out by (batch, hidden, dtype,
  device) before any launch: on a card the library's own plan
  (``fmda_gru_wide_bwd_step_plan``), for CPU tensors :func:`bwd_step_plan`,
  its Python copy, at the H100's figures (``_cuda_lib.H100_FIGURES``).
  None (float32, H not a multiple of 64) keeps W2 and the ``mm``.
- :func:`gru_wide_bwd_step_reference` is the plain version: the product in
  float32 (in bf16 summed in the kernel's order), never rounded, then W2's
  plain version's gate gradients.
- :func:`gru_wide_bwd_step` is the wrapper of one launch and
  :func:`gru_wide_bwd_step_scan` a direction's: on CUDA tensors launches
  (each counted in :data:`launches`) or raise; on CPU tensors the plain
  version a step.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from fmda_tpu_torch.ops import _cuda_lib, call_booked, count_launch
from fmda_tpu_torch.ops import gru_wide_step as _step

Tensor = torch.Tensor

# the wrapper's device test, a module global so a rehearsal can stub it
_on_cpu = _cuda_lib.on_cpu

#: Launches of the fused backward step (CPU calls do not count): one a
#: step.
launches = 0

#: gru_wide_bwd_step.cu's constants, by the units a CTA takes (64, or 128
#: where H is a multiple of 128 and the plan splits K): the ring's stages;
#: the barriers' bytes; the bytes a prepared direction is kept in
BWD_STAGES = {64: 12, 128: 9}
BWD_BARRIER_BYTES = 256
BWD_HANDLE_BYTES = 1024


def bwd_smem(units: int) -> int:
    """A CTA's shared bytes at ``units`` units: the ring's slots (dhh's
    64 x 64 box and W_hh^T's box of the units), the barriers, the
    swizzle's alignment."""
    slot = (_step.STEP_TILE + units) * 128
    return (BWD_STAGES[units] * slot + BWD_BARRIER_BYTES
            + _step.STEP_ALIGN_BYTES)


def bwd_step_plan(batch: int, hidden: int, itemsize: int, *, sms: int,
                  clusters: Dict[int, int], smem: int = 0
                  ) -> Optional[Dict[str, int]]:
    """How ``gru_wide_bwd_step`` lays out a backward step at (batch, hidden)
    in an I/O dtype of ``itemsize`` bytes on a card of ``sms`` SMs and
    ``clusters`` (size -> resident count): ``gru_wide_bwd_step.cu``'s
    ``bwd_step_plan``, line for line, a pure function of its arguments.
    None where W2 and the ``mm`` keep the step (float32: the tensor cores
    hold its operands only as TF32; H not a multiple of 64); else
    :func:`~fmda_tpu_torch.ops.gru_wide_step.tile_plan` over K = 3 H in
    tiles of 128 units where H is a multiple of 128 and that layout splits
    K (a K rank's epilogue share then fits the epilogue's threads), else of
    64.  ``chip_smoke.py`` holds it to the library's plan query."""
    del smem  # a figure of the persistent scans' plan, not of this one
    tile = _step.STEP_TILE
    if batch < 1 or itemsize != 2 or hidden < tile or hidden % tile:
        return None
    k_total = 3 * hidden // tile
    if hidden % 128 == 0:
        wide = _step.tile_plan(batch, hidden, 128, k_total, bwd_smem(128),
                               sms=sms, clusters=clusters)
        if wide["split"] > 1:
            return wide
    return _step.tile_plan(batch, hidden, tile, k_total, bwd_smem(tile),
                           sms=sms, clusters=clusters)


def bwd_step_plan_query(batch: int, hidden: int, dtype: torch.dtype,
                        device: int) -> Tuple[Optional[Dict[str, int]],
                                              Dict[str, object]]:
    """The library's own plan of a backward step on card ``device``
    (``fmda_gru_wide_bwd_step_plan``): (the plan's fields, or None where W2
    keeps the step; the card's figures it was made from, as
    :func:`bwd_step_plan` takes them)."""
    lib = _cuda_lib.load()
    n = len(_step.STEP_FIELDS)
    out = (ctypes.c_int * (n + 6))()
    err = lib.fmda_gru_wide_bwd_step_plan(
        batch, hidden, torch.tensor([], dtype=dtype).element_size(), device,
        out)
    _cuda_lib.raise_on(lib, err, "gru_wide_bwd_step plan")
    vals = list(out)
    figures = dict(sms=vals[n + 1],
                   clusters=dict(zip((1, 2, 4, 8), vals[n + 2:n + 6])))
    if not vals[0]:
        return None, figures
    return dict(zip(_step.STEP_FIELDS, vals[1:n + 1])), figures


def gru_wide_bwd_step_plan(batch: int, hidden: int, dtype: torch.dtype,
                           device: torch.device) -> Optional[Dict[str, int]]:
    """The fused backward step's plan for (batch, hidden) in ``dtype`` on
    ``device``: on a card the library's own, for CPU tensors its Python
    copy at the H100's figures.  None: W2 and the ``mm`` keep the step."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    if device.type != "cuda":
        return bwd_step_plan(batch, hidden, itemsize,
                             **_cuda_lib.H100_FIGURES)
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    return _card_plan(batch, hidden, dtype, index)


@functools.lru_cache(maxsize=256)
def _card_plan(batch, hidden, dtype, index):
    return bwd_step_plan_query(batch, hidden, dtype, index)[0]


# -- the plain version ---------------------------------------------------------


def dhh_of(dg_t: Tensor) -> Tensor:
    """dhh_t = [dr, dz, dn r] (B, 3 H) from a step's (B, 4 H) row of the
    output buffer: the gate gradients the product sees."""
    hidden = dg_t.shape[-1] // 4
    return torch.cat((dg_t[..., :2 * hidden], dg_t[..., 3 * hidden:]), dim=-1)


def gru_wide_bwd_step_reference(
    xp_t: Tensor, hh_t: Tensor, h_prev: Tensor, direct: Tensor,
    dhh_next: Optional[Tensor], w_t: Tensor, dhs_t: Tensor,
    mask_t: Optional[Tensor] = None, plan: Optional[Dict[str, int]] = None,
) -> Tuple[Tensor, Tensor]:
    """One backward step: prod = dhh_{t+1} W_hh (``w_t`` is W_hh^T, (H,
    3 H); ``dhh_next`` (B, 3 H), None at the first processed step: no
    product) in float32, never rounded; in bf16 with a ``plan`` summed in
    the kernel's order (``wide_scan._tc_product`` over the plan's K split
    of K = 3 H: ``gru_wide_step._step_groups``), else one float32
    product.  Then the
    gate gradients of
    :func:`~fmda_tpu_torch.ops.wide_scan.gru_wide_gates_bwd_reference` with
    dh = (dhs_t + direct) + prod.  Returns the step's (B, 4 H) row [dr, dz,
    dn, dn r] in xp_t's dtype and the new direct part (float32)."""
    from fmda_tpu_torch.ops.wide_scan import (
        _tc_product, gru_wide_gates_bwd_reference)

    prod = None
    if dhh_next is not None:
        if plan is not None and xp_t.dtype == torch.bfloat16:
            prod = _tc_product(dhh_next, w_t.to(torch.bfloat16),
                               _step._step_groups(w_t.shape[1],
                                                  plan["split"]))
        else:
            prod = dhh_next.float() @ w_t.float().t()
    dxp, dhh, new_direct = gru_wide_gates_bwd_reference(
        xp_t, hh_t, h_prev, direct, prod, dhs_t, mask_t)
    hidden = h_prev.shape[-1]
    return torch.cat((dxp, dhh[:, 2 * hidden:]), dim=-1), new_direct


# -- the wrappers --------------------------------------------------------------


def _check(xp: Tensor, hh: Tensor, h_prevs: Tensor, dhs: Tensor,
           mask: Optional[Tensor], w_t: Tensor, direct: Tensor,
           dg: Tensor) -> Tuple[int, int, int]:
    """A direction's launch conditions: xp and hh (B, T, 3 H), h_prevs and
    dhs (B, T, H), W_hh^T (H, 3 H), all bf16 with contiguous last
    dimensions and row and step strides multiples of 8 (16-byte reads);
    W_hh^T contiguous; direct a contiguous (B, H) float32; dg a contiguous
    (B, T, 4 H) bf16 (TMA reads its rows); every operand 16-byte aligned;
    mask a (B, T) uint8 or None.  Returns (B, T, H)."""
    batch, n_steps, hidden = h_prevs.shape
    gh = 3 * hidden
    shapes = dict(xp=(xp, (batch, n_steps, gh)), hh=(hh, (batch, n_steps, gh)),
                  h_prevs=(h_prevs, (batch, n_steps, hidden)),
                  dhs=(dhs, (batch, n_steps, hidden)), w_t=(w_t, (hidden, gh)),
                  dg=(dg, (batch, n_steps, 4 * hidden)))
    for label, (t, shape) in shapes.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"gru_wide_bwd_step kernel takes bfloat16, got "
                            f"{label} {t.dtype}")
        if tuple(t.shape) != shape or t.stride(-1) != 1:
            raise ValueError(
                f"gru_wide_bwd_step: {label} must be {shape} with a "
                f"contiguous last dimension, got {tuple(t.shape)} strides "
                f"{t.stride()}")
    ok = (w_t.is_contiguous() and dg.is_contiguous()
          and all(t.data_ptr() % 16 == 0
                  for t in (xp, hh, h_prevs, dhs, w_t, direct, dg))
          and all(s % 8 == 0 for t in (xp, hh, h_prevs, dhs)
                  for s in t.stride()[:2]))
    if not ok:
        raise ValueError("gru_wide_bwd_step: w_t and dg must be contiguous, "
                         "every operand 16-byte aligned, and xp's, hh's, "
                         "h_prevs's and dhs's row and step strides "
                         "multiples of 8")
    if (tuple(direct.shape) != (batch, hidden) or direct.dtype != torch.float32
            or not direct.is_contiguous()):
        raise ValueError(f"gru_wide_bwd_step: direct must be a contiguous "
                         f"({batch}, {hidden}) float32")
    if mask is not None and (tuple(mask.shape) != (batch, n_steps)
                             or mask.dtype != torch.uint8):
        raise ValueError(f"gru_wide_bwd_step: mask must be ({batch}, "
                         f"{n_steps}) uint8, got {tuple(mask.shape)} "
                         f"{mask.dtype}")
    return batch, n_steps, hidden


def _prepare(lib, xp, hh, h_prevs, dhs, mask, w_t, direct, dg, plan):
    """The direction's launches prepared in a handle (its tensor maps made
    and its plan checked once, no launch); raises on the library's
    error."""
    batch, n_steps, hidden = h_prevs.shape
    handle = ctypes.create_string_buffer(BWD_HANDLE_BYTES)
    ints = (ctypes.c_int * len(_step.STEP_FIELDS))(
        *(plan[k] for k in _step.STEP_FIELDS))
    views = [(t.data_ptr(), t.stride(0), t.stride(1))
             for t in (xp, hh, h_prevs, dhs)]
    views.append((0, 0, 0) if mask is None
                 else (mask.data_ptr(), mask.stride(0), mask.stride(1)))
    err = lib.fmda_gru_wide_bwd_scan_prepare_bf16(
        *(v for view in views for v in view), w_t.data_ptr(),
        direct.data_ptr(), dg.data_ptr(), dg.stride(0), dg.stride(1), ints,
        batch, n_steps, hidden, _cuda_lib.device_index(xp), handle,
        BWD_HANDLE_BYTES)
    _cuda_lib.raise_on(lib, err, "gru_wide_bwd_step prepare")
    return handle


def _launch(lib, handle, t: int, t_next: int, early: int, stream: int,
            signature: tuple) -> None:
    """One launch of the kernel at step t of a prepared direction, booked
    with ``signature`` and counted in :data:`launches`; raises on its
    error."""
    global launches
    err = call_booked("gru_wide_bwd_step", signature,
                      lib.fmda_gru_wide_bwd_step_bf16,
                      (handle, t, t_next, early, stream))
    _cuda_lib.raise_on(lib, err, "gru_wide_bwd_step")
    count_launch()
    launches += 1


def _reference_step(xp, hh, h_prevs, dhs, mask, w_t, direct, dg, t, t_next,
                    plan) -> None:
    """Step t through the plain version, into dg[:, t] and direct."""
    dhh_next = None if t_next is None else dhh_of(dg[:, t_next])
    row, new_direct = gru_wide_bwd_step_reference(
        xp[:, t], hh[:, t], h_prevs[:, t], direct, dhh_next, w_t, dhs[:, t],
        None if mask is None else mask[:, t], plan)
    dg[:, t] = row
    direct.copy_(new_direct)


def gru_wide_bwd_step(xp: Tensor, hh: Tensor, h_prevs: Tensor, dhs: Tensor,
                      mask: Optional[Tensor], w_t: Tensor, direct: Tensor,
                      dg: Tensor, t: int, t_next: Optional[int],
                      plan: Dict[str, int]) -> None:
    """Step t of a backward direction over its (B, T, ...) operands (as
    :func:`_check` states): reads ``dg[:, t_next]`` (None: the first
    processed step, no product) and ``direct``, writes ``dg[:, t]`` and
    ``direct`` in place.  On CUDA tensors one launch of
    ``gru_wide_bwd_step`` laid out by ``plan``
    (:func:`gru_wide_bwd_step_plan`; the library refuses one that does not
    lay the step out), counted in :data:`launches`, or raise; on CPU
    tensors :func:`gru_wide_bwd_step_reference`."""
    tensors = [xp, hh, h_prevs, dhs, w_t, direct, dg] + (
        [mask] if mask is not None else [])
    if _on_cpu("gru_wide_bwd_step", tensors):
        _reference_step(xp, hh, h_prevs, dhs, mask, w_t, direct, dg, t,
                        t_next, plan)
        return
    batch, _, hidden = _check(xp, hh, h_prevs, dhs, mask, w_t, direct, dg)
    lib = _cuda_lib.load()
    handle = _prepare(lib, xp, hh, h_prevs, dhs, mask, w_t, direct, dg, plan)
    _launch(lib, handle, t, -1 if t_next is None else t_next, 0,
            _cuda_lib.stream_of(xp),
            (batch, hidden, 2, mask is not None, t_next is not None))


def gru_wide_bwd_step_scan(xp: Tensor, hh: Tensor, h_prevs: Tensor,
                           dhs: Tensor, mask: Optional[Tensor], w_t: Tensor,
                           direct: Tensor, dg: Tensor, plan: Dict[str, int],
                           reverse: bool = False) -> int:
    """A backward direction through the fused step, into ``dg`` and
    ``direct`` (which holds dh_last to begin with, the direct part of dh0
    at the end): each step in the backward's order (T - 1 down to 0; 0 up
    where the forward ran ``reverse``).  On CUDA tensors T launches of
    ``gru_wide_bwd_step`` (each counted in :data:`launches`, from the
    second on overlapping the one before), the operands checked and the
    tensor maps made once; on CPU tensors :func:`gru_wide_bwd_step` a
    step.  Returns the last processed step."""
    n_steps = xp.shape[1]
    order = list(range(n_steps)) if reverse else list(
        range(n_steps - 1, -1, -1))
    tensors = [xp, hh, h_prevs, dhs, w_t, direct, dg] + (
        [mask] if mask is not None else [])
    if _on_cpu("gru_wide_bwd_step", tensors):
        prev = None
        for t in order:
            gru_wide_bwd_step(xp, hh, h_prevs, dhs, mask, w_t, direct, dg, t,
                              prev, plan)
            prev = t
        return order[-1]
    batch, _, hidden = _check(xp, hh, h_prevs, dhs, mask, w_t, direct, dg)
    lib = _cuda_lib.load()
    handle = _prepare(lib, xp, hh, h_prevs, dhs, mask, w_t, direct, dg, plan)
    stream = _cuda_lib.stream_of(xp)
    masked = mask is not None
    prev = -1
    for t in order:
        # from the second step on, the last launch is the previous step,
        # the one that wrote dhh_{t+1} and direct (and nothing else this
        # step reads), so the launch may overlap it ("early")
        _launch(lib, handle, t, prev, int(prev >= 0), stream,
                (batch, hidden, 2, masked, prev >= 0))
        prev = t
    return order[-1]
