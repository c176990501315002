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

On CUDA tensors the wrapper launches the kernel (``csrc/ssm_step.cu``, in
the library :mod:`fmda_tpu_torch.ops._cuda_lib` builds at first use) or
raises; on CPU tensors it runs the plain version.  The kernel has no
backward, as the Pallas kernel has none: serving runs it under
``torch.inference_mode()``, and training goes through the parallel scan.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from fmda_tpu_torch.ops import _cuda_lib

# the wrapper's device test, a module global so a rehearsal can stub it
_on_cpu = _cuda_lib.on_cpu

#: Kernel launches made by :func:`ssm_cell_step` (CPU calls do not count).
launches = 0

Tensor = torch.Tensor


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
    err = fn(xp.data_ptr(), xp.stride(0),
             *(cast[k].data_ptr() for k in named),
             h.data_ptr(), s_new.data_ptr(), ef_new.data_ptr(),
             es_new.data_ptr(), batch, hidden, _cuda_lib.device_index(xp),
             _cuda_lib.stream_of(xp))
    _cuda_lib.raise_on(lib, err, "ssm_cell_step")
    launches += 1
    return h, (s_new, ef_new, es_new)
