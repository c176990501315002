"""The SSM serve tick as a hand-written CUDA kernel, with its plain version.

:func:`ssm_cell_step` is the port of ``fmda_tpu/ops/pallas_ssm.py``'s
``_ssm_step_kernel``: one O(1) tick of the ``(s, ema_fast, ema_slow)``
serving cache,

    a = sigmoid(zp + a_base);  s' = a s + (1 - a) vp;  h = s' silu(gp) + d vp
    ef' = sigmoid(rho_f) ef + (1 - sigmoid(rho_f)) h     (es' likewise)

over a precomputed projection ``xp (B, 3H)`` packed ``[z, v, g]``.  Its
plain version :func:`ssm_cell_step_reference` rounds as the Pallas kernel
does, not as the jnp step: the carry and the four (H,) vectors are cast to
``xp``'s dtype, all algebra runs in float32, and each of the four outputs
is rounded once to that dtype.  In float32 that is the jnp step exactly.

The serving paths do not call it one layer at a time: :func:`ssm_serve_tick`
is the whole tick of a pool flush or a solo core, every layer, in one
launch (the counterpart of the reference's one jitted pool step): the
lanes' norms gathered and applied, per layer the input projection and the
step, the EMA head and its sigmoid, the new state scattered in place.  Its
weights arrive packed into one buffer (:func:`pack_tick_weights`), its
state as one ``(n_layers, 3, S, H)`` tensor.

On CUDA tensors each wrapper launches its kernel (``csrc/ssm_step.cu``, in
the library :mod:`fmda_tpu_torch.ops._cuda_lib` builds at first use) or
raises; on CPU tensors it runs its plain version.  The kernels have no
backward, as the Pallas kernel has none: serving runs them under
``torch.inference_mode()``, and training goes through the parallel scan.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from fmda_tpu_torch.ops import _cuda_lib, call_booked, count_launch

# the wrapper's device test, a module global so a rehearsal can stub it
_on_cpu = _cuda_lib.on_cpu

#: Kernel launches made by :func:`ssm_cell_step` (CPU calls do not count).
launches = 0
#: Kernel launches made by :func:`ssm_serve_tick`.
tick_launches = 0

Tensor = torch.Tensor


class SSMWeights(NamedTuple):
    """One direction's parameters: the packed projection and four
    per-channel vectors (the diagonal transition is the family's defining
    constraint)."""

    w_ih: Tensor  # (3H, F) packed [z, v, g]
    b_ih: Tensor  # (3H,)
    a_base: Tensor  # (H,) decay offset: a = sigmoid(zp + a_base)
    d: Tensor  # (H,) feedthrough
    rho_f: Tensor  # (H,) fast head-EMA rate pre-activation
    rho_s: Tensor  # (H,) slow head-EMA rate pre-activation


class TickWeights(NamedTuple):
    """A serving model's weights as :func:`ssm_serve_tick` reads them.

    ``packed`` is one flat buffer in the I/O dtype, the kernel's one weight
    pointer: per layer ``W_ih`` transposed to (F_in, 3H) (so the threads
    of neighbouring projection entries read neighbouring words), ``b_ih``,
    ``a_base``, ``d``, ``rho_f``, ``rho_s``; then the head's (C, 3H) weight
    and (C,) bias.  ``layers`` and ``head`` are views into it, in the
    shapes the plain version takes."""

    packed: Tensor
    layers: Tuple[SSMWeights, ...]
    head: Tuple[Tensor, Tensor]


# -- the plain version ---------------------------------------------------------


def ssm_gates(xp: Tensor, s: Tensor, a_base: Tensor,
              d: Tensor) -> Tuple[Tensor, Tensor]:
    """One state update from a precomputed projection, in the inputs'
    dtype: ``xp (..., 3H)``, ``s (..., H)`` -> ``(h, s_new)``."""
    hidden = xp.shape[-1] // 3
    zp, vp, gp = xp[..., :hidden], xp[..., hidden:2 * hidden], xp[..., 2 * hidden:]
    a = torch.sigmoid(zp + a_base)
    s_new = a * s + (1.0 - a) * vp
    return s_new * F.silu(gp) + d * vp, s_new


def ssm_cell_step_reference(
    xp: Tensor, carry: Tuple[Tensor, ...], w,
) -> Tuple[Tensor, Tuple[Tensor, ...]]:
    """One tick of the cache: the plain version of the kernel.

    Args:
      xp: (B, 3H) precomputed input projection.
      carry: ``(s, ema_fast, ema_slow)``, each (B, H).
      w: the direction's :class:`~fmda_tpu_torch.ops.ssm.SSMWeights` (only
        ``a_base``, ``d``, ``rho_f``, ``rho_s`` are read).

    Returns ``(h, (s_new, ema_fast_new, ema_slow_new))`` in xp's dtype."""
    dtype, f32 = xp.dtype, torch.float32

    def f(t):  # cast to the I/O dtype as the kernel's caller does, then up
        return t.to(dtype).to(f32)

    s, ef, es = carry
    h, s_new = ssm_gates(xp.to(f32), f(s), f(w.a_base), f(w.d))
    rf, rs = torch.sigmoid(f(w.rho_f)), torch.sigmoid(f(w.rho_s))
    ef_new = rf * f(ef) + (1.0 - rf) * h
    es_new = rs * f(es) + (1.0 - rs) * h
    return h.to(dtype), (s_new.to(dtype), ef_new.to(dtype), es_new.to(dtype))


# -- the wrapper ---------------------------------------------------------------


def ssm_cell_step(
    xp: Tensor, carry: Tuple[Tensor, ...], w,
) -> Tuple[Tensor, Tuple[Tensor, ...]]:
    """One tick of the serving cache: ``(h, (s', ef', es'))``, the signature
    of :func:`ssm_cell_step_reference`.

    CUDA tensors launch the kernel (one launch, counted in
    :data:`launches`) or raise; CPU tensors run the plain version.  Inputs
    that would record a gradient raise: the kernel has no backward."""
    tensors = [xp, *carry, w.a_base, w.d, w.rho_f, w.rho_s]
    _cuda_lib.refuse_recording("ssm_cell_step", "ssm_scan_parallel", tensors)
    if _on_cpu("ssm_cell_step", tensors):
        return ssm_cell_step_reference(xp, carry, w)
    return _launch(xp, carry, w)


def _launch(xp, carry, w):
    global launches
    if xp.dtype not in _cuda_lib.SUPPORTED:
        raise TypeError(
            f"ssm_cell_step kernel takes float32 or bfloat16, got {xp.dtype}")
    if xp.dim() != 2 or xp.shape[-1] % 3 or xp.shape[0] == 0:
        raise ValueError(f"xp must be (B, 3H) with B >= 1, got "
                         f"{tuple(xp.shape)}")
    if xp.stride(-1) != 1:
        raise ValueError("xp's last dimension must be contiguous")
    batch, hidden = xp.shape[0], xp.shape[1] // 3
    if hidden == 0:
        raise ValueError("ssm_cell_step kernel takes H >= 1")
    if len(carry) != 3:
        raise ValueError(f"carry must be (s, ema_fast, ema_slow), got "
                         f"{len(carry)} tensors")
    named = {"s": carry[0], "ema_fast": carry[1], "ema_slow": carry[2],
             "a_base": w.a_base, "d": w.d, "rho_f": w.rho_f,
             "rho_s": w.rho_s}
    cast = {k: t.to(xp.dtype).contiguous() for k, t in named.items()}
    _cuda_lib.check_shapes(
        {**{k: (batch, hidden) for k in ("s", "ema_fast", "ema_slow")},
         **{k: (hidden,) for k in ("a_base", "d", "rho_f", "rho_s")}}, cast)
    h, s_new, ef_new, es_new = (
        torch.empty((batch, hidden), dtype=xp.dtype, device=xp.device)
        for _ in range(4))
    lib = _cuda_lib.load()
    fn = getattr(lib, f"fmda_ssm_step_{_cuda_lib.SUPPORTED[xp.dtype]}")
    err = call_booked(
        "ssm_step", (batch, hidden, xp.element_size()), fn,
        (xp.data_ptr(), xp.stride(0), *(cast[k].data_ptr() for k in named),
         h.data_ptr(), s_new.data_ptr(), ef_new.data_ptr(),
         es_new.data_ptr(), batch, hidden, _cuda_lib.device_index(xp),
         _cuda_lib.stream_of(xp)))
    _cuda_lib.raise_on(lib, err, "ssm_cell_step")
    launches += 1
    count_launch()
    return h, (s_new, ef_new, es_new)


# -- the whole serve tick -----------------------------------------------------


def pack_tick_weights(layers: Sequence[SSMWeights],
                      head: Tuple[Tensor, Tensor]) -> TickWeights:
    """Pack the unidirectional layers' weights and the linear head
    ``(weight (C, 3H), bias (C,))`` into one buffer of the head's dtype and
    device (see :class:`TickWeights`)."""
    dtype = head[0].dtype
    parts = []
    for w in layers:
        parts += [w.w_ih.t(), w.b_ih, w.a_base, w.d, w.rho_f, w.rho_s]
    parts += list(head)
    packed = torch.cat([p.to(dtype).reshape(-1) for p in parts])
    views, off = [], 0
    for p in parts:
        views.append(packed[off:off + p.numel()].view(p.shape))
        off += p.numel()
    n = len(layers)
    return TickWeights(packed, tuple(
        SSMWeights(views[6 * i].t(), *views[6 * i + 1:6 * i + 6])
        for i in range(n)), (views[6 * n], views[6 * n + 1]))


def ssm_serve_tick_reference(rows: Tensor, slots: Tensor, x_min: Tensor,
                             x_range: Tensor, weights: TickWeights,
                             state: Tensor, pos: Tensor) -> Tensor:
    """One serve tick for every lane: the plain version of the fused
    kernel.

    Args:
      rows: (B, F) float32 raw feature rows, one a lane.
      slots: (B,) the lanes' slots in ``state`` (the padding slot may
        repeat; a live slot appears at most once).
      x_min, x_range: (S, F) float32 per-slot norm tables, or (1, F), one
        norm for every lane.
      weights: the model, from :func:`pack_tick_weights`.
      state: (n_layers, 3, S, H) ``(s, ema_fast, ema_slow)`` per layer, in
        the I/O dtype; the lanes' rows are replaced by their new values.
      pos: (S,) int64 tick positions; ``pos[slots] += 1``.

    Returns the (B, C) float32 sigmoid probabilities: normalize, round to
    the I/O dtype, per layer the projection (``F.linear``) and
    :func:`ssm_cell_step_reference`, the EMA head over ``[h, ema_fast,
    ema_slow]`` (``F.linear``), then ``sigmoid`` in float32."""
    idx = slots.long()
    norm_idx = idx if x_min.shape[0] != 1 else torch.zeros_like(idx)
    x = ((rows - x_min[norm_idx]) / x_range[norm_idx]).to(state.dtype)
    for layer, w in enumerate(weights.layers):
        carry = tuple(state[layer, c, idx] for c in range(3))
        x, carry = ssm_cell_step_reference(F.linear(x, w.w_ih, w.b_ih),
                                           carry, w)
        for c in range(3):
            state[layer, c, idx] = carry[c]
    pos[idx] = pos[idx] + 1
    logits = F.linear(torch.cat([x, carry[1], carry[2]], dim=-1),
                      *weights.head)
    return torch.sigmoid(logits.float())


def ssm_serve_tick(rows: Tensor, slots: Tensor, x_min: Tensor,
                   x_range: Tensor, weights: TickWeights, state: Tensor,
                   pos: Tensor) -> Tensor:
    """One serve tick for every lane, every layer in one launch: the
    signature of :func:`ssm_serve_tick_reference` (``state`` and ``pos``
    updated in place, the probabilities returned).

    CUDA tensors launch the kernel (one launch, counted in
    :data:`tick_launches`) or raise; CPU tensors run the plain version.
    On the card, ``slots`` stays where it is (no copy back to check it): a
    lane whose slot lies outside the state gets NaN probabilities and
    touches nothing."""
    tensors = [rows, slots, x_min, x_range, weights.packed, state, pos]
    _cuda_lib.refuse_recording("ssm_serve_tick", "ssm_scan_parallel",
                               tensors)
    if _on_cpu("ssm_serve_tick", tensors):
        return ssm_serve_tick_reference(rows, slots, x_min, x_range,
                                        weights, state, pos)
    return _launch_tick(rows, slots, x_min, x_range, weights, state, pos)


def _launch_tick(rows, slots, x_min, x_range, weights, state, pos):
    global tick_launches
    if state.dtype not in _cuda_lib.SUPPORTED:
        raise TypeError(
            f"ssm_serve_tick kernel takes float32 or bfloat16 state, got "
            f"{state.dtype}")
    if weights.packed.dtype != state.dtype:
        raise TypeError(
            f"ssm_serve_tick weights are {weights.packed.dtype}, the state "
            f"{state.dtype}")
    for label, t, dtype in (("rows", rows, torch.float32),
                            ("slots", slots, torch.int32),
                            ("x_min", x_min, torch.float32),
                            ("x_range", x_range, torch.float32),
                            ("pos", pos, torch.int64)):
        if t.dtype != dtype:
            raise TypeError(f"{label} must be {dtype}, got {t.dtype}")
    if state.dim() != 4 or state.shape[1] != 3:
        raise ValueError(
            f"state must be (n_layers, 3, S, H), got {tuple(state.shape)}")
    n_layers, _, n_slots, hidden = state.shape
    if rows.dim() != 2 or rows.shape[0] == 0:
        raise ValueError(
            f"rows must be (B, F) with B >= 1, got {tuple(rows.shape)}")
    batch, feats = rows.shape
    if len(weights.layers) != n_layers or n_layers == 0:
        raise ValueError(
            f"weights have {len(weights.layers)} layers, the state "
            f"{n_layers}")
    n_classes = weights.head[1].shape[0]
    norm_rows = x_min.shape[0] if x_min.dim() == 2 else 0
    if norm_rows not in (1, n_slots):
        raise ValueError(
            f"x_min must be (S, F) = {(n_slots, feats)} or (1, F), got "
            f"{tuple(x_min.shape)}")
    _cuda_lib.check_shapes(
        {"slots": (batch,), "pos": (n_slots,), "x_min": (norm_rows, feats),
         "x_range": (norm_rows, feats),
         "head": (n_classes, 3 * hidden),
         **{f"w_ih_l{i}": (3 * hidden, feats if i == 0 else hidden)
            for i in range(n_layers)}},
        {"slots": slots, "pos": pos, "x_min": x_min, "x_range": x_range,
         "head": weights.head[0],
         **{f"w_ih_l{i}": w.w_ih for i, w in enumerate(weights.layers)}})
    expect = (3 * hidden * (feats + hidden * (n_layers - 1))
              + 7 * hidden * n_layers + n_classes * (3 * hidden + 1))
    if weights.packed.dim() != 1 or weights.packed.numel() != expect:
        raise ValueError(
            f"packed weights must hold {expect} values, got "
            f"{tuple(weights.packed.shape)}")
    for label, t in (("rows", rows), ("slots", slots), ("x_min", x_min),
                     ("x_range", x_range), ("state", state), ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    if slots.device.type == "cpu" and (  # readable without a copy back
            int(slots.min()) < 0 or int(slots.max()) >= n_slots):
        raise IndexError(f"slots must lie in 0..{n_slots - 1}, got "
                         f"{slots.tolist()}")
    probs = torch.empty((batch, n_classes), dtype=torch.float32,
                        device=rows.device)
    lib = _cuda_lib.load()
    fn = getattr(lib, f"fmda_ssm_tick_{_cuda_lib.SUPPORTED[state.dtype]}")
    err = call_booked(
        "ssm_tick",
        (batch, n_layers, feats, hidden, n_classes, state.element_size()), fn,
        (rows.data_ptr(), slots.data_ptr(), x_min.data_ptr(),
         x_range.data_ptr(), norm_rows, weights.packed.data_ptr(),
         state.data_ptr(), pos.data_ptr(), probs.data_ptr(), batch, n_slots,
         feats, hidden, n_classes, n_layers, _cuda_lib.device_index(rows),
         _cuda_lib.stream_of(rows)))
    _cuda_lib.raise_on(lib, err, "ssm_serve_tick")
    tick_launches += 1
    count_launch()
    return probs
