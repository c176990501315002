"""The GRU forward scan as a hand-written CUDA kernel, and its plain version.

:func:`gru_scan_fwd` is the port of ``fmda_tpu/ops/pallas_gru.py``'s
``_gru_step_kernel``.  On CUDA tensors it launches ``csrc/gru_scan.cu`` or
raises; on CPU tensors it runs :func:`gru_scan_reference`, the plain
PyTorch time loop that computes the same function with the same rounding
(gate algebra in float32, the carry rounded to the I/O dtype each step).

The kernel is compiled with ``nvcc`` at first use into a shared library
with a plain C interface, loaded with :mod:`ctypes`, under
``build/fmda_tpu_torch/<hash of sources and flags>/`` at the repository
root.  Nothing is built or loaded at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

_PKG_DIR = Path(__file__).resolve().parents[1]
SOURCES: Tuple[Path, ...] = (_PKG_DIR / "csrc" / "gru_scan.cu",)
BUILD_ROOT = _PKG_DIR.parent / "build" / "fmda_tpu_torch"
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Kernel launches made by :func:`gru_scan_fwd` (CPU calls do not count).
launches = 0
#: What the last build in this process did: ``path``, ``seconds`` (None
#: when the library was already built), ``log`` (nvcc/ptxas output).
build_info: Dict[str, object] = {}

_lib: Optional[ctypes.CDLL] = None
_SUPPORTED = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAX_HIDDEN = 1024


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the GRU scan kernel is built from "
        "fmda_tpu_torch/csrc at first use")


def library_path(sources: Sequence[Path] = SOURCES) -> Path:
    """Where the library of ``sources`` lives: keyed by their content and
    the compiler flags, so an edited source never loads a stale build."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / "libgru_scan.so"


def build() -> Path:
    """Compile :data:`SOURCES` for sm_90a unless already built; raises on
    a missing ``nvcc`` or a failed build."""
    lib = library_path()
    if lib.exists():
        build_info.update(path=str(lib), seconds=None, log="")
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    lib.with_suffix(".log").write_text(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {lib.name}:\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    build_info.update(path=str(lib), seconds=seconds, log=log)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for tag in _SUPPORTED.values():
            fn = getattr(lib, f"fmda_gru_scan_fwd_{tag}")
            fn.argtypes = [p, ll, ll, p, p, p, p, p, p, i, i, i, i, i, p]
            fn.restype = i
        lib.fmda_cuda_error_string.argtypes = [i]
        lib.fmda_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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
    :data:`launches`) or raise; CPU tensors run the plain version.  The
    backward kernel is not ported yet, so inputs that would record a
    gradient raise rather than return a wrong one: call under
    ``torch.inference_mode()`` or ``torch.no_grad()``."""
    tensors = [xp, h0, w_hh, b_hh] + ([mask] if mask is not None else [])
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "gru_scan_fwd has no backward yet (the port of "
            "pallas_gru.py::_gru_bwd_kernel is the next slice); call it "
            "under torch.inference_mode()")
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return gru_scan_reference(xp, h0, w_hh, b_hh, reverse=reverse,
                                  mask=mask)
    if len(devices) != 1 or xp.device.type != "cuda":
        raise ValueError(
            f"gru_scan_fwd needs all inputs on one CUDA device or all on "
            f"the CPU, got {sorted(map(str, devices))}")
    return _launch(xp, h0, w_hh, b_hh, reverse=reverse, mask=mask)


def _launch(xp, h0, w_hh, b_hh, *, reverse, mask):
    global launches
    if xp.dtype not in _SUPPORTED:
        raise TypeError(
            f"gru_scan_fwd kernel takes float32 or bfloat16, got {xp.dtype}")
    if xp.dim() != 3 or xp.shape[-1] % 3:
        raise ValueError(f"xp must be (B, T, 3H), got {tuple(xp.shape)}")
    batch, n_steps, h3 = xp.shape
    hidden = h3 // 3
    if not 0 < hidden <= _MAX_HIDDEN or batch == 0:
        raise ValueError(
            f"gru_scan_fwd kernel takes B >= 1 and 1 <= H <= {_MAX_HIDDEN}, "
            f"got B={batch}, H={hidden}")
    expect = {"h0": (batch, hidden), "w_hh": (h3, hidden), "b_hh": (h3,)}
    h0, w_hh, b_hh = (t.to(xp.dtype) for t in (h0, w_hh, b_hh))
    for name, t in (("h0", h0), ("w_hh", w_hh), ("b_hh", b_hh)):
        if tuple(t.shape) != expect[name]:
            raise ValueError(
                f"{name} must be {expect[name]}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xp.stride(-1) != 1:
        raise ValueError("xp's last dimension must be contiguous")
    mask_ptr = None
    if mask is not None:
        if tuple(mask.shape) != (batch, n_steps):
            raise ValueError(
                f"mask must be (B, T) = {(batch, n_steps)}, got "
                f"{tuple(mask.shape)}")
        mask = (mask != 0).to(torch.uint8).contiguous()
        mask_ptr = mask.data_ptr()
    hs = torch.empty((batch, n_steps, hidden), dtype=xp.dtype,
                     device=xp.device)
    h_last = torch.empty((batch, hidden), dtype=xp.dtype, device=xp.device)
    lib = _load()
    fn = getattr(lib, f"fmda_gru_scan_fwd_{_SUPPORTED[xp.dtype]}")
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    err = fn(xp.data_ptr(), xp.stride(0), xp.stride(1), h0.data_ptr(),
             w_hh.data_ptr(), b_hh.data_ptr(), mask_ptr, hs.data_ptr(),
             h_last.data_ptr(), batch, n_steps, hidden, int(bool(reverse)),
             xp.device.index if xp.device.index is not None
             else torch.cuda.current_device(), stream)
    if err != 0:
        raise RuntimeError(
            "gru_scan_fwd kernel launch failed: "
            f"{lib.fmda_cuda_error_string(err).decode()} ({err})")
    launches += 1
    return h_last, hs
