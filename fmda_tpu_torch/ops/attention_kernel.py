"""Flash attention as hand-written CUDA kernels, with their plain versions
and the differentiable op that joins them.

- :func:`flash_fwd` is the port of ``fmda_tpu/ops/pallas_attention.py``'s
  ``_fwd_kernel``: the online softmax over key blocks of
  :data:`SOFTMAX_BLOCK` in float32, giving ``o = acc / l`` in the I/O dtype
  and ``lse = m + log l`` in float32.  Its kernel (``csrc/flash_fwd.cu``)
  takes each block in one pass, a warp a 16-row query tile;
  :func:`flash_fwd_plan` reports how the kernel lays a call out.
- :func:`flash_dkv` and :func:`flash_dq` are the ports of ``_dkv_kernel``
  and ``_dq_kernel``: each recomputes ``p = exp(s - lse)`` and sweeps the
  other axis for its gradients (``csrc/flash_attn.cu``).  ``delta =
  rowsum(do * o) - dlse`` is computed in torch outside them
  (:func:`flash_delta`), as ``pallas_attention._bwd_impl`` computes it
  outside its kernels.
- :func:`flash_bwd` is the backward the differentiable op runs: dq, dk and
  dv in one launch of ``csrc/flash_bwd.cu``'s kernel where a CTA holds
  whole heads (T <= 128, D <= 64: the model's window), which computes s
  and ds once and forms dq from the ds it kept; elsewhere the two sweeps.
  :func:`flash_bwd_plan` reports which, and how the launch is laid out.
- :func:`flash_attention_with_lse` is the differentiable op, a
  :class:`torch.autograd.Function` over :func:`flash_fwd` and
  :func:`flash_bwd`, as ``custom_vjp`` joins the Pallas kernels;
  :func:`flash_attention` returns ``o`` alone.

Their arithmetic is the Pallas kernels': scores ``q k^T / sqrt(D)`` in
float32, masked entries set to the finite :data:`NEG` and their
probabilities forced to exactly 0 (``s <= NEG / 2``), ``p`` and ``ds``
rounded to the I/O dtype before their products, float32 sums.  A row
whose keys are all masked gives ``o = 0`` and ``lse = NEG``.

The envelope is wider than the Pallas kernels' (``T % 128 == 0``, no
mask): self-attention on (B, N, T, D) with any T >= 1 (the last key block
is ragged), D <= 512, causal or not, and an optional (B, T) key mask
(True = the key is visible to every query of that row).  Anything else
raises.  On CUDA tensors each wrapper launches its kernels (from
``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu`` and ``csrc/flash_attn.cu``, in
the library :mod:`fmda_tpu_torch.ops._cuda_lib` builds at first use) or
raises; on CPU tensors it runs its plain version.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from fmda_tpu_torch.ops import _cuda_lib

# the wrappers' device test, a module global so a rehearsal can stub it
_on_cpu = _cuda_lib.on_cpu

#: Kernel launches made by :func:`flash_fwd` (CPU calls do not count).
fwd_launches = 0
#: Kernel launches made by :func:`flash_dkv`, and by :func:`flash_bwd`
#: where it runs the sweeps.
dkv_launches = 0
#: Kernel launches made by :func:`flash_dq`, and by :func:`flash_bwd`
#: where it runs the sweeps.
dq_launches = 0
#: Launches of the fused backward kernel made by :func:`flash_bwd`.
bwd_launches = 0

#: The finite stand-in for -inf in masked score slots.
NEG = -1e30
#: Keys per block of the online softmax (the Pallas kernels' block edge):
#: each row's running max moves once a block.
SOFTMAX_BLOCK = 128
#: The largest head dimension the kernels take (the Pallas envelope's).
MAX_D = 512
#: The fields of the forward's plan, in the order its query reports them.
FWD_PLAN_FIELDS = ("split", "dw", "units", "wph", "resident", "keys", "tk",
                   "stages", "ldq", "ldk", "ldv", "grid", "smem")
#: The fields of the backward's plan, in the order its query reports them.
BWD_PLAN_FIELDS = ("fused", "split", "dw", "units", "wph", "rows", "stages",
                   "ld", "ldd", "grid", "smem", "threads")

Tensor = torch.Tensor


def flash_fwd_plan(bn: int, n_heads: int, t: int, d: int, dtype: torch.dtype,
                   lib: Optional[ctypes.CDLL] = None) -> Dict[str, int]:
    """How the forward kernel runs (B*N, T, D) in ``dtype``, from the
    launch's own plan (``fmda_flash_fwd_plan`` in ``csrc/flash_fwd_plan.cc``,
    read from ``lib``, the card's library by default).

    A warp owns a 16-row query tile; ``split`` warps share one when D > 64,
    each holding ``dw`` dims.  Where ``resident`` (T <= 128, D <= 64) a CTA
    holds ``units`` whole (b*n) heads whose K and V stay in shared memory,
    and ``wph`` warps a head walk its query tiles; otherwise it holds
    ``units`` consecutive query tiles of one head, and K and V stream
    through ``stages`` buffers of ``tk`` keys.  ``keys``: the keys of a
    block a warp holds scores for (128, or 32 where T <= 32 and D <= 16).
    ``ldq``, ``ldk``, ``ldv``: the shared tiles' row strides in elements;
    ``smem``: the bytes a CTA takes; ``grid``: the CTAs."""
    if dtype not in _cuda_lib.SUPPORTED:
        raise TypeError(f"flash_fwd takes float32 or bfloat16, got {dtype}")
    lib = lib or _cuda_lib.load()
    out = (ctypes.c_int * len(FWD_PLAN_FIELDS))()
    item = torch.tensor([], dtype=dtype).element_size()
    if lib.fmda_flash_fwd_plan(bn, n_heads, t, d, item, out) != 0:
        raise ValueError(f"flash_fwd plan outside the envelope: B*N={bn}, "
                         f"N={n_heads}, T={t}, D={d}")
    plan = dict(zip(FWD_PLAN_FIELDS, out))
    plan["resident"] = bool(plan["resident"])
    return plan


def flash_bwd_plan(bn: int, n_heads: int, t: int, d: int, dtype: torch.dtype,
                   *, sweeps: bool = False,
                   lib: Optional[ctypes.CDLL] = None) -> Dict[str, int]:
    """How the backward runs (B*N, T, D) in ``dtype``, from the launch's own
    plan (``fmda_flash_bwd_plan`` in ``csrc/flash_bwd_plan.cc``, read from
    ``lib``, the card's library by default): :func:`flash_bwd`'s, or with
    ``sweeps`` that of :func:`flash_dkv` and :func:`flash_dq`.

    ``fused`` (T <= 128 and D <= 64, unless ``sweeps``): one launch, a CTA
    holding ``units`` whole (b*n) heads and ``wph`` warps a head, each warp
    owning the head's key tiles w, w + wph, ... and then its query tiles.
    Else each sweep's CTA owns ``units`` 16-row tiles of one head,
    ``split`` warps a tile of ``dw`` dims each, and walks the other axis in
    chunks of ``rows`` through ``stages`` buffers.  ``ld``: the q, k, v and
    do tiles' row stride in elements; ``ldd``: the fused kernel's ds rows;
    ``grid``: CTAs; ``smem``: bytes a CTA; ``threads``: a CTA's."""
    if dtype not in _cuda_lib.SUPPORTED:
        raise TypeError(f"flash_bwd takes float32 or bfloat16, got {dtype}")
    lib = lib or _cuda_lib.load()
    out = (ctypes.c_int * len(BWD_PLAN_FIELDS))()
    item = torch.tensor([], dtype=dtype).element_size()
    if lib.fmda_flash_bwd_plan(bn, n_heads, t, d, item, int(sweeps),
                               out) != 0:
        raise ValueError(f"flash_bwd plan outside the envelope: B*N={bn}, "
                         f"N={n_heads}, T={t}, D={d}")
    plan = dict(zip(BWD_PLAN_FIELDS, out))
    plan["fused"] = bool(plan["fused"])
    return plan


def check_envelope(q: Tensor, k: Tensor, v: Tensor,
                   key_mask: Optional[Tensor]) -> None:
    """Raise unless (q, k, v, key_mask) is inside the kernels' envelope."""
    envelope = ("flash attention takes self-attention q, k, v of one shape "
                f"(B, N, T, D) with T >= 1 and 1 <= D <= {MAX_D}, and an "
                "optional (B, T) key mask")
    if not (q.dim() == 4 and q.shape == k.shape == v.shape):
        raise ValueError(f"{envelope}; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, _, t, d = q.shape
    if t < 1 or not 1 <= d <= MAX_D:
        raise ValueError(f"{envelope}; got T={t}, D={d}")
    if key_mask is not None and tuple(key_mask.shape) != (b, t):
        raise ValueError(f"{envelope}; got a key mask of shape "
                         f"{tuple(key_mask.shape)}")


def _scale(d_head: int) -> float:
    """1/sqrt(D), rounded once to float32 as the Pallas kernels' Python
    scalar is."""
    return float(torch.tensor(1.0 / math.sqrt(d_head), dtype=torch.float32))


# -- the plain version ---------------------------------------------------------


def _scores(q: Tensor, k: Tensor, k0: int, *, causal: bool,
            key_mask: Optional[Tensor]) -> Tensor:
    """float32 scores of q (B, N, T, D) against the key block ``k`` that
    starts at key ``k0``, masked entries set to :data:`NEG`."""
    f32 = torch.float32
    s = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) * _scale(
        q.shape[-1])
    keys = k0 + torch.arange(k.shape[-2], device=q.device)
    keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device)
    if causal:
        keep = torch.arange(q.shape[-2], device=q.device)[:, None] >= keys
    if key_mask is not None:
        keep = keep & key_mask[:, None, None, k0:k0 + k.shape[-2]].bool()
    return torch.where(keep, s, NEG)


def _probabilities(s: Tensor, shift: Tensor) -> Tensor:
    """exp(s - shift), exactly 0 where s is masked."""
    return torch.where(s <= NEG * 0.5, 0.0, torch.exp(s - shift[..., None]))


def flash_fwd_reference(
    q: Tensor, k: Tensor, v: Tensor, *, causal: bool = False,
    key_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """The plain version of the forward kernel: (o (B, N, T, D) in q's
    dtype, lse (B, N, T) float32), the online softmax over key blocks of
    :data:`SOFTMAX_BLOCK` with the kernel's arithmetic."""
    check_envelope(q, k, v, key_mask)
    f32, dtype = torch.float32, q.dtype
    m = torch.full(q.shape[:-1], NEG, dtype=f32, device=q.device)
    l = torch.zeros_like(m)  # noqa: E741
    acc = torch.zeros(q.shape, dtype=f32, device=q.device)
    for k0 in range(0, q.shape[-2], SOFTMAX_BLOCK):
        blk = slice(k0, k0 + SOFTMAX_BLOCK)
        s = _scores(q, k[..., blk, :], k0, causal=causal, key_mask=key_mask)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = _probabilities(s, m_new)
        l = l * corr + p.sum(dim=-1)  # noqa: E741
        acc = acc * corr[..., None] + torch.matmul(
            p.to(dtype).to(f32), v[..., blk, :].to(f32))
        m = m_new
    empty = l == 0.0
    l_safe = torch.where(empty, 1.0, l)
    o = (acc / l_safe[..., None]).to(dtype)
    return o, torch.where(empty, NEG, m + torch.log(l_safe))


def _bwd_terms(q, k, v, do, lse, delta, causal, key_mask):
    """The float32 ``p`` and ``ds`` both backward sweeps recompute, and the
    operands as the kernels read them (rounded to the I/O dtype)."""
    check_envelope(q, k, v, key_mask)
    f32, dtype = torch.float32, q.dtype

    def up(t):
        return t.to(dtype).to(f32)

    s = _scores(q, k, 0, causal=causal, key_mask=key_mask)
    p = _probabilities(s, lse.to(f32))
    dp = torch.matmul(up(do), up(v).transpose(-1, -2))
    ds = p * (dp - delta.to(f32)[..., None]) * _scale(q.shape[-1])
    return p, ds, up


def flash_dkv_reference(
    q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Tensor, delta: Tensor,
    *, causal: bool = False, key_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """The plain version of the dK/dV kernel: (dk, dv) in q's dtype from the
    forward's inputs, ``do`` (B, N, T, D), ``lse`` and ``delta`` (B, N, T)
    float32::

        p = exp(s - lse);  dv = p^T do;  ds = p (do v^T - delta) / sqrt(D)
        dk = ds^T q

    with p and ds rounded to the I/O dtype before their products and the
    sums in float32."""
    p, ds, up = _bwd_terms(q, k, v, do, lse, delta, causal, key_mask)
    dv = torch.matmul(up(p).transpose(-1, -2), up(do))
    dk = torch.matmul(up(ds).transpose(-1, -2), up(q))
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_dq_reference(
    q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Tensor, delta: Tensor,
    *, causal: bool = False, key_mask: Optional[Tensor] = None,
) -> Tensor:
    """The plain version of the dQ kernel: ``dq = ds k`` in q's dtype, with
    ``ds`` as :func:`flash_dkv_reference` has it."""
    _, ds, up = _bwd_terms(q, k, v, do, lse, delta, causal, key_mask)
    return torch.matmul(up(ds), up(k)).to(q.dtype)


def flash_bwd_reference(
    q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Tensor, delta: Tensor,
    *, causal: bool = False, key_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The plain version of the fused backward: (dq, dk, dv), the two plain
    sweeps :func:`flash_dq_reference` and :func:`flash_dkv_reference`."""
    kw = dict(causal=causal, key_mask=key_mask)
    dk, dv = flash_dkv_reference(q, k, v, do, lse, delta, **kw)
    return flash_dq_reference(q, k, v, do, lse, delta, **kw), dk, dv


def flash_delta(o: Tensor, do: Tensor, dlse: Tensor) -> Tensor:
    """``rowsum(do * o) - dlse`` in float32, (B, N, T): the backward's
    per-row term, the lse cotangent folded in (d lse_i / d s_ij = p_ij)."""
    f32 = torch.float32
    return (do.to(f32) * o.to(f32)).sum(dim=-1) - dlse.to(f32)


# -- the wrappers --------------------------------------------------------------


def flash_fwd(
    q: Tensor, k: Tensor, v: Tensor, *, causal: bool = False,
    key_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """The forward: (o, lse), the signature of :func:`flash_fwd_reference`.

    CUDA tensors launch the kernel (one launch, counted in
    :data:`fwd_launches`) or raise; CPU tensors run the plain version.
    This is the raw forward launch and records no backward, so inputs that
    would record a gradient raise: train through
    :func:`flash_attention_with_lse`."""
    tensors = [q, k, v] + ([key_mask] if key_mask is not None else [])
    _cuda_lib.refuse_recording("flash_fwd", "flash_attention_with_lse",
                               tensors)
    if _on_cpu("flash_fwd", tensors):
        return flash_fwd_reference(q, k, v, causal=causal, key_mask=key_mask)
    return _launch_fwd(q, k, v, causal, key_mask)


def flash_dkv(
    q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Tensor, delta: Tensor,
    *, causal: bool = False, key_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """The dK/dV sweep: (dk, dv), the signature of
    :func:`flash_dkv_reference`.  CUDA tensors launch the kernel (counted
    in :data:`dkv_launches`) or raise; CPU tensors run the plain
    version."""
    tensors = [q, k, v, do, lse, delta] + (
        [key_mask] if key_mask is not None else [])
    if _on_cpu("flash_dkv", tensors):
        return flash_dkv_reference(q, k, v, do, lse, delta, causal=causal,
                                   key_mask=key_mask)
    return _launch_bwd("dkv", q, k, v, do, lse, delta, causal, key_mask)


def flash_dq(
    q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Tensor, delta: Tensor,
    *, causal: bool = False, key_mask: Optional[Tensor] = None,
) -> Tensor:
    """The dQ sweep: dq, the signature of :func:`flash_dq_reference`.  CUDA
    tensors launch the kernel (counted in :data:`dq_launches`) or raise;
    CPU tensors run the plain version."""
    tensors = [q, k, v, do, lse, delta] + (
        [key_mask] if key_mask is not None else [])
    if _on_cpu("flash_dq", tensors):
        return flash_dq_reference(q, k, v, do, lse, delta, causal=causal,
                                  key_mask=key_mask)
    return _launch_bwd("dq", q, k, v, do, lse, delta, causal, key_mask)[0]


def flash_bwd(
    q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Tensor, delta: Tensor,
    *, causal: bool = False, key_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The backward: (dq, dk, dv), the signature of
    :func:`flash_bwd_reference`.  CUDA tensors run one C call that launches
    the fused kernel (counted in :data:`bwd_launches`) where
    :func:`flash_bwd_plan` fuses, else the two sweeps (counted in
    :data:`dkv_launches` and :data:`dq_launches`), or raise; CPU tensors
    run the plain version."""
    tensors = [q, k, v, do, lse, delta] + (
        [key_mask] if key_mask is not None else [])
    if _on_cpu("flash_bwd", tensors):
        return flash_bwd_reference(q, k, v, do, lse, delta, causal=causal,
                                   key_mask=key_mask)
    return _launch_flash_bwd(q, k, v, do, lse, delta, causal, key_mask)


def _folded(name: str, q: Tensor, k: Tensor, v: Tensor,
            key_mask: Optional[Tensor]):
    """The checks every launch makes; q, k, v as contiguous (B*N, T, D) and
    the key mask as contiguous uint8 (B, T)."""
    check_envelope(q, k, v, key_mask)
    if q.dtype not in _cuda_lib.SUPPORTED or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"{name} kernels take q, k, v all float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, n, t, d = q.shape
    fold = [x.reshape(b * n, t, d).contiguous() for x in (q, k, v)]
    return (b, n, t, d), fold, _cuda_lib.mask_u8(key_mask, b, t)


def _launch_fwd(q, k, v, causal, key_mask):
    global fwd_launches
    (b, n, t, d), (q3, k3, v3), mask = _folded("flash_fwd", q, k, v,
                                               key_mask)
    o = torch.empty_like(q3)
    lse = torch.empty((b * n, t), dtype=torch.float32, device=q.device)
    lib = _cuda_lib.load()
    fn = getattr(lib, f"fmda_flash_fwd_{_cuda_lib.SUPPORTED[q.dtype]}")
    err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
             None if mask is None else mask.data_ptr(), o.data_ptr(),
             lse.data_ptr(), b * n, n, t, d, int(bool(causal)),
             ctypes.c_float(_scale(d)), _cuda_lib.device_index(q),
             _cuda_lib.stream_of(q))
    _cuda_lib.raise_on(lib, err, "flash_fwd")
    fwd_launches += 1
    return o.view(b, n, t, d), lse.view(b, n, t)


def _call_bwd(name, n_outs, q, k, v, do, lse, delta, causal, key_mask,
              *extra):
    """Call the C entry ``fmda_<name>_<dtype>`` of a backward: the checks,
    the operands as the kernels read them, ``n_outs`` (B*N, T, D) outputs
    in q's dtype, then ``extra`` arguments after the stream."""
    (b, n, t, d), (q3, k3, v3), mask = _folded(name, q, k, v, key_mask)
    _cuda_lib.check_shapes(
        {"do": (b, n, t, d), "lse": (b, n, t), "delta": (b, n, t)},
        {"do": do, "lse": lse, "delta": delta})
    do3 = do.to(q.dtype).reshape(b * n, t, d).contiguous()
    lse2, delta2 = (x.to(torch.float32).reshape(b * n, t).contiguous()
                    for x in (lse, delta))
    outs = [torch.empty_like(q3) for _ in range(n_outs)]
    lib = _cuda_lib.load()
    fn = getattr(lib, f"fmda_{name}_{_cuda_lib.SUPPORTED[q.dtype]}")
    err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
             lse2.data_ptr(), delta2.data_ptr(),
             None if mask is None else mask.data_ptr(),
             *(x.data_ptr() for x in outs), b * n, n, t, d,
             int(bool(causal)), ctypes.c_float(_scale(d)),
             _cuda_lib.device_index(q), _cuda_lib.stream_of(q), *extra)
    _cuda_lib.raise_on(lib, err, name)
    return tuple(x.view(b, n, t, d) for x in outs)


def _launch_bwd(kind, q, k, v, do, lse, delta, causal, key_mask):
    """Launch the ``kind`` ("dkv" or "dq") sweep: (dk, dv) or (dq,)."""
    global dkv_launches, dq_launches
    outs = _call_bwd(f"flash_{kind}", 2 if kind == "dkv" else 1, q, k, v, do,
                     lse, delta, causal, key_mask)
    if kind == "dkv":
        dkv_launches += 1
    else:
        dq_launches += 1
    return outs


def _launch_flash_bwd(q, k, v, do, lse, delta, causal, key_mask):
    """Run the backward in one C call: (dq, dk, dv), from the fused kernel
    or the two sweeps, as the plan has it."""
    global bwd_launches, dkv_launches, dq_launches
    fused = ctypes.c_int(-1)
    outs = _call_bwd("flash_bwd", 3, q, k, v, do, lse, delta, causal,
                     key_mask, ctypes.byref(fused))
    if fused.value:
        bwd_launches += 1
    else:
        dkv_launches += 1
        dq_launches += 1
    return outs


# -- the differentiable op -----------------------------------------------------


class _Flash(torch.autograd.Function):
    """Forward :func:`flash_fwd`; backward :func:`flash_delta`, then
    :func:`flash_bwd`; the residuals are the inputs, o and lse (the
    backward recomputes p), as ``pallas_attention._flash_fwd`` saves them.
    An output whose cotangent autograd leaves undefined gets zeros."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal):
        o, lse = flash_fwd(q, k, v, causal=causal, key_mask=key_mask)
        ctx.save_for_backward(q, k, v, o, lse, key_mask)
        ctx.causal = causal
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, key_mask = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, do, lse, flash_delta(o, do, dlse),
                               causal=ctx.causal, key_mask=key_mask)
        return dq, dk, dv, None, None


def flash_attention_with_lse(
    q: Tensor, k: Tensor, v: Tensor, *, causal: bool = False,
    key_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Attention over (B, N, T, D) q, k, v: (o (B, N, T, D) in q's dtype,
    lse (B, N, T) float32), differentiable in both outputs (the lse
    cotangent folds into ``delta``).  The lse makes two results over
    disjoint key segments mergeable
    (:func:`fmda_tpu_torch.ops.attention.merge_softmax_segments`).  Where
    autograd records, the kernels run as one
    :class:`torch.autograd.Function` (their plain versions on CPU
    tensors); elsewhere this is :func:`flash_fwd`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, key_mask, causal)
    return flash_fwd(q, k, v, causal=causal, key_mask=key_mask)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = False,
                    key_mask: Optional[Tensor] = None) -> Tensor:
    """:func:`flash_attention_with_lse`'s output alone."""
    return flash_attention_with_lse(q, k, v, causal=causal,
                                    key_mask=key_mask)[0]
