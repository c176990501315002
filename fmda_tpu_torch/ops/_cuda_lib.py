"""The port's one CUDA library: how it is built, found and loaded, and the
checks every kernel wrapper shares.

Every kernel source under ``csrc/`` (the GRU scans in ``gru_scan.cu``, the
LSTM scans in ``lstm_scan.cu``, the backward scans' weight gradient in
``scan_dw.cu``, the SSM step and the fused serve tick in ``ssm_step.cu``,
the flash-attention forward in ``flash_fwd.cu``, laid out by the host code
of ``flash_fwd_plan.cc``, its fused backward in ``flash_bwd.cu`` and its
dK/dV and dQ sweeps in ``flash_attn.cu``, both laid out by
``flash_bwd_plan.cc`` and sharing ``flash_bwd_common.cuh``; the kernels all
including ``scan_common.cuh``, the flash kernels ``flash_mma.cuh``) goes
into one shared library with a plain C interface, loaded with
:mod:`ctypes`.  Each
source is compiled by its own ``nvcc`` for sm_90a, all started together,
and the objects are linked into
``build/fmda_tpu_torch/<hash of sources, headers and flags>/`` at the
repository root.  Nothing is built or loaded at import: :func:`load` does
it at the first launch on a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
#: The sources compiled into the library, one ``nvcc`` each.
SOURCES: Tuple[Path, ...] = (_CSRC / "gru_scan.cu", _CSRC / "lstm_scan.cu",
                             _CSRC / "scan_dw.cu", _CSRC / "ssm_step.cu",
                             _CSRC / "flash_fwd.cu", _CSRC / "flash_fwd_plan.cc",
                             _CSRC / "flash_attn.cu", _CSRC / "flash_bwd.cu",
                             _CSRC / "flash_bwd_plan.cc")
#: Headers the sources include: part of the library's key.
HEADERS: Tuple[Path, ...] = (_CSRC / "scan_common.cuh",
                             _CSRC / "flash_fwd_plan.h",
                             _CSRC / "flash_mma.cuh",
                             _CSRC / "flash_bwd_common.cuh",
                             _CSRC / "flash_bwd_plan.h")
BUILD_ROOT = _CSRC.parents[1] / "build" / "fmda_tpu_torch"
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIBRARY_NAME = "libfmda_scans.so"

#: The dtypes the kernels take, and the suffix of their C entry points.
SUPPORTED = {torch.float32: "f32", torch.bfloat16: "bf16"}

#: What the last build in this process did: ``path``, ``seconds`` (None
#: when the library was already built), ``log`` (nvcc/ptxas output).
build_info: Dict[str, object] = {}

_lib: Optional[ctypes.CDLL] = None


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
        "nvcc not found (set CUDA_HOME): the scan kernels are built from "
        "fmda_tpu_torch/csrc at first use")


def library_path(files: Sequence[Path] = SOURCES + HEADERS) -> Path:
    """Where the library of ``files`` lives: keyed by their content and the
    compiler flags, so an edited source or header never loads a stale
    build."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in files:
        digest.update(src.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / LIBRARY_NAME


def _run_all(cmds: Iterable[Sequence[str]]) -> Tuple[int, str]:
    """Run ``cmds`` side by side; (first non-zero return code or 0, the
    commands and their output)."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    rc, log = 0, []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        rc = rc or proc.returncode
    return rc, "".join(log)


def build() -> Path:
    """Compile :data:`SOURCES` for sm_90a, one ``nvcc`` per source started
    together, and link them into the library, unless already built; raises
    on a missing ``nvcc`` or a failed build."""
    lib = library_path()
    if lib.exists():
        build_info.update(path=str(lib), seconds=None, log="")
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = [lib.with_name(f"{src.stem}.{tag}.o") for src in SOURCES]
    tmp = lib.with_name(f"{lib.name}.{tag}")
    t0 = time.perf_counter()
    try:
        rc, log = _run_all([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                           for src, obj in zip(SOURCES, objs))
        if rc == 0:
            rc, link_log = _run_all(
                [[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
            log += link_log
        seconds = time.perf_counter() - t0
        lib.with_suffix(".log").write_text(log)
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}) building {lib.name}:\n{log}")
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    build_info.update(path=str(lib), seconds=seconds, log=log)
    return lib


def load() -> ctypes.CDLL:
    """The library, built and loaded at first call, its entry points
    typed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        # (entry point, its pointer arguments after xp and its two strides)
        for name, n_ptrs in (("gru_scan_fwd", 6), ("gru_scan_sweep", 10),
                             ("lstm_scan_fwd", 9), ("lstm_scan_sweep", 13)):
            for tag in SUPPORTED.values():
                fn = getattr(lib, f"fmda_{name}_{tag}")
                fn.argtypes = [p, ll, ll, *[p] * n_ptrs, i, i, i, i, i, p]
                fn.restype = i
        for tag in SUPPORTED.values():
            # xp, its row stride, 7 inputs, 4 outputs, B, H, device, stream
            fn = getattr(lib, f"fmda_ssm_step_{tag}")
            fn.argtypes = [p, ll, *[p] * 11, i, i, i, p]
            fn.restype = i
            # rows, slots, x_min, x_range, norm_rows, weights, state, pos,
            # probs, B, S, F, H, C, L, device, stream
            fn = getattr(lib, f"fmda_ssm_tick_{tag}")
            fn.argtypes = [p, p, p, p, i, p, p, p, p, *[i] * 7, p]
            fn.restype = i
        f = ctypes.c_float
        for tag in SUPPORTED.values():
            # q, k, v, key_mask, o, lse, B*N, N, T, D, causal, scale, device,
            # stream
            fn = getattr(lib, f"fmda_flash_fwd_{tag}")
            fn.argtypes = [*[p] * 6, i, i, i, i, i, f, i, p]
            fn.restype = i
        # B*N, N, T, D, itemsize, out[13]
        lib.fmda_flash_fwd_plan.argtypes = [i, i, i, i, i, p]
        lib.fmda_flash_fwd_plan.restype = i
        # pointer arguments, then B*N, N, T, D, causal, scale, device, stream
        for name, n_ptrs in (("flash_dkv", 9), ("flash_dq", 8)):
            for tag in SUPPORTED.values():
                fn = getattr(lib, f"fmda_{name}_{tag}")
                fn.argtypes = [*[p] * n_ptrs, i, i, i, i, i, f, i, p]
                fn.restype = i
        for tag in SUPPORTED.values():
            # q, k, v, do, lse, delta, key_mask, dq, dk, dv, B*N, N, T, D,
            # causal, scale, device, stream, then the int it sets to 1
            # where the fused kernel ran
            fn = getattr(lib, f"fmda_flash_bwd_{tag}")
            fn.argtypes = [*[p] * 10, i, i, i, i, i, f, i, p,
                           ctypes.POINTER(i)]
            fn.restype = i
        # B*N, N, T, D, itemsize, sweeps, out[12]
        lib.fmda_flash_bwd_plan.argtypes = [i, i, i, i, i, i, p]
        lib.fmda_flash_bwd_plan.restype = i
        for tag in SUPPORTED.values():
            # dg, its row stride, tail, tail_from, hs, h0, B, T, H, gH,
            # reverse, partials, dw_db, device, stream
            fn = getattr(lib, f"fmda_scan_dw_{tag}")
            fn.argtypes = [p, i, p, i, p, p, i, i, i, i, i, p, p, i, p]
            fn.restype = i
        for cell in ("gru", "lstm"):
            # B, H, itemsize, device, out[6]
            fn = getattr(lib, f"fmda_{cell}_scan_fwd_plan")
            fn.argtypes = [i, i, i, i, p]
            fn.restype = i
        lib.fmda_scan_dw_splits.argtypes = [i, i, i, i, i]
        lib.fmda_scan_dw_splits.restype = i
        lib.fmda_cuda_error_string.argtypes = [i]
        lib.fmda_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


#: The forward scans' branches, by the code their plan query returns.
FWD_BRANCHES = ("reg", "smem", "cluster", "device")


def fwd_plan(cell: str, batch: int, hidden: int, dtype: torch.dtype,
             device: int) -> Dict[str, object]:
    """How ``<cell>_scan_fwd`` runs (batch, hidden) in ``dtype`` on card
    ``device``, from the launcher's own plan (``fmda_<cell>_scan_fwd_plan``):
    ``branch`` (W_hh in registers, shared memory, a two-CTA cluster's shared
    memory, or device memory), ``lanes`` a hidden unit, batch ``rows`` a
    CTA, CTAs a ``cluster``, ``blocks`` in the grid and ``smem`` bytes a
    CTA."""
    lib = load()
    out = (ctypes.c_int * 6)()
    err = getattr(lib, f"fmda_{cell}_scan_fwd_plan")(
        batch, hidden, torch.tensor([], dtype=dtype).element_size(), device,
        out)
    raise_on(lib, err, f"{cell}_scan_fwd plan")
    branch, lanes, rows, cluster, blocks, smem = out
    return dict(branch=FWD_BRANCHES[branch], lanes=lanes, rows=rows,
                cluster=cluster, blocks=blocks, smem=smem)


# -- what every wrapper checks -------------------------------------------------


def on_cpu(name: str, tensors) -> bool:
    """True when every tensor is on the CPU, False when all are on one CUDA
    device; raises on anything else."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"{name} needs all inputs on one CUDA device or all on the CPU, "
            f"got {sorted(map(str, devices))}")
    return False


def refuse_recording(name: str, differentiable: str, tensors) -> None:
    """A raw forward launch records no backward: raise where autograd
    would record, rather than hand back a result without a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} is the raw forward launch and records no backward; use "
            f"{differentiable} (differentiable) or call it under "
            "torch.inference_mode()")


def mask_u8(mask: Optional[torch.Tensor], batch: int,
            n_steps: int) -> Optional[torch.Tensor]:
    """The (B, T) validity mask as the kernels read it: contiguous uint8."""
    if mask is None:
        return None
    if tuple(mask.shape) != (batch, n_steps):
        raise ValueError(
            f"mask must be (B, T) = {(batch, n_steps)}, got "
            f"{tuple(mask.shape)}")
    return (mask != 0).to(torch.uint8).contiguous()


def check_shapes(expect: Dict[str, Tuple[int, ...]],
                 tensors: Dict[str, torch.Tensor]) -> None:
    for label, t in tensors.items():
        if tuple(t.shape) != expect[label]:
            raise ValueError(
                f"{label} must be {expect[label]}, got {tuple(t.shape)}")


def check_scan_inputs(name: str, xp: torch.Tensor, n_gates: int,
                      max_hidden: int, **params: torch.Tensor):
    """The checks every scan kernel makes: a supported dtype; xp
    (B, T, n_gates * H) with its last dimension contiguous; the named
    states (``h0``, ``c0``: (B, H)) and weights (``w_hh``: (n_gates * H, H),
    ``b_hh``: (n_gates * H,)) contiguous once cast to xp's dtype.  Returns
    (batch, n_steps, hidden, {name: the cast tensor})."""
    if xp.dtype not in SUPPORTED:
        raise TypeError(
            f"{name} kernel takes float32 or bfloat16, got {xp.dtype}")
    if xp.dim() != 3 or xp.shape[-1] % n_gates:
        raise ValueError(
            f"xp must be (B, T, {n_gates}H), got {tuple(xp.shape)}")
    batch, n_steps, gh = xp.shape
    hidden = gh // n_gates
    if not 0 < hidden <= max_hidden or batch == 0:
        raise ValueError(
            f"{name} kernel takes B >= 1 and 1 <= H <= {max_hidden}, "
            f"got B={batch}, H={hidden}")
    cast = {label: t.to(xp.dtype) for label, t in params.items()}
    check_shapes({"h0": (batch, hidden), "c0": (batch, hidden),
                  "w_hh": (gh, hidden), "b_hh": (gh,)}, cast)
    for label, t in cast.items():
        if not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    if xp.stride(-1) != 1:
        raise ValueError("xp's last dimension must be contiguous")
    return batch, n_steps, hidden, cast


def raise_on(lib: ctypes.CDLL, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{lib.fmda_cuda_error_string(err).decode()} ({err})")


def device_index(t: torch.Tensor) -> int:
    return (t.device.index if t.device.index is not None
            else torch.cuda.current_device())


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
