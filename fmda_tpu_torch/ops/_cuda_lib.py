"""The port's one CUDA library: how it is built, found and loaded, and the
checks every kernel wrapper shares.

Every kernel source under ``csrc/`` (the GRU scans in ``gru_scan.cu``, the
LSTM scans in ``lstm_scan.cu``, the backward scans' weight gradient in
``scan_dw.cu``, the wide scan route's fused gate kernels in
``scan_wide.cu``, its fused GRU step in ``gru_wide_step.cu`` and its
persistent LSTM scans in ``lstm_persist.cu``, laid out by
``lstm_persist_plan.cc``, the SSM step and the fused serve tick in ``ssm_step.cu``,
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
                             _CSRC / "flash_bwd_plan.cc",
                             _CSRC / "scan_wide.cu",
                             _CSRC / "gru_wide_step.cu",
                             _CSRC / "lstm_persist.cu",
                             _CSRC / "lstm_persist_plan.cc")
#: Headers the sources include: part of the library's key.
HEADERS: Tuple[Path, ...] = (_CSRC / "scan_common.cuh",
                             _CSRC / "flash_fwd_plan.h",
                             _CSRC / "flash_mma.cuh",
                             _CSRC / "flash_bwd_common.cuh",
                             _CSRC / "flash_bwd_plan.h",
                             _CSRC / "lstm_persist_plan.h")
BUILD_ROOT = _CSRC.parents[1] / "build" / "fmda_tpu_torch"
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIBRARY_NAME = "libfmda_scans.so"

#: The dtypes the kernels take, and the suffix of their C entry points.
SUPPORTED = {torch.float32: "f32", torch.bfloat16: "bf16"}

#: What the build of the library in use did: ``path``, ``seconds`` (None
#: when another process built it), ``log`` (nvcc/ptxas output).
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
        if build_info.get("path") != str(lib):  # built by another process
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
        # the wide route's gate kernels: the step's operands, each a
        # pointer and (but prod, direct and dc) its row stride, then B, H,
        # device, stream
        for name, layout in (
                ("gru_wide_fwd", "ps ps ps ps ps"),
                ("lstm_wide_fwd", "ps ps ps ps ps ps ps"),
                ("gru_wide_bwd", "ps ps ps p ps ps p ps ps"),
                ("lstm_wide_bwd", "ps ps ps ps p ps ps p p ps")):
            kinds = [k for group in layout.split() for k in group]
            for tag in SUPPORTED.values():
                fn = getattr(lib, f"fmda_{name}_{tag}")
                fn.argtypes = [p if k == "p" else ll for k in kinds] + [
                    i, i, i, p]
                fn.restype = i
        # the persistent LSTM scans: xp and its two strides, the pointer
        # arguments, counter, the plan's ints, then B, T, H, reverse,
        # device, stream
        for name, n_ptrs in (("lstm_persist_fwd", 9), ("lstm_persist_bwd",
                                                       13)):
            for tag in SUPPORTED.values():
                fn = getattr(lib, f"fmda_{name}_{tag}")
                fn.argtypes = [p, ll, ll, *[p] * n_ptrs, i, i, i, i, i, p]
                fn.restype = i
        # B, H, itemsize, device, out[19]
        lib.fmda_lstm_persist_plan.argtypes = [i, i, i, i, p]
        lib.fmda_lstm_persist_plan.restype = i
        # the fused GRU step: xp_t and its row stride, h_{t-1} and its,
        # W_hh, b_hh, the mask column and its row stride, h_t and its, the
        # plan's ints, B, H, early, device, stream
        lib.fmda_gru_wide_step_fwd_bf16.argtypes = [
            p, ll, p, ll, p, p, p, ll, p, ll, p, i, i, i, i, p]
        lib.fmda_gru_wide_step_fwd_bf16.restype = i
        # B, H, itemsize, device, out[14]
        lib.fmda_gru_wide_scan_fwd_plan.argtypes = [i, i, i, i, p]
        lib.fmda_gru_wide_scan_fwd_plan.restype = i
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


# -- where the kernel pairs run: scan_common.cuh's forward plan, in Python ----

#: scan_common.cuh's constants: the register layout's width and lanes, the
#: shared-memory forward's block limit, the shared memory a forward CTA may
#: take, the rows a forward CTA may carry
SCAN_REG_H, SCAN_LANES, FWD_SMEM_THREADS = 32, 4, 512
MAX_FWD_SMEM_BYTES, FWD_MAX_ROWS = 232448, 4


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def fwd_branch(gates: int, hidden: int, itemsize: int) -> str:
    """The branch ``plan_fwd`` (scan_common.cuh) takes for a forward scan of
    ``gates`` gate blocks at ``hidden`` units in an I/O dtype of
    ``itemsize`` bytes, one of :data:`FWD_BRANCHES`: a pure function of
    shape and dtype (the batch and the card set only rows and blocks).
    ``chip_smoke.py`` holds it to the library's plan query."""
    if hidden <= SCAN_REG_H:
        return "reg"

    def fits(units, lanes, hp):
        m = 128 // itemsize  # elements in 32 banks: fwd_w_stride's padding
        ws = hp + (4 * lanes - hp) % m
        return (2 * FWD_MAX_ROWS * hp * 4 + gates * units * ws * itemsize
                <= MAX_FWD_SMEM_BYTES)

    lanes = SCAN_LANES if hidden * SCAN_LANES <= FWD_SMEM_THREADS else 1
    if fits(hidden, lanes, _round_up(hidden, 4 * lanes)):
        return "smem"
    if (hidden % 2 == 0 and hidden // 2 * SCAN_LANES <= FWD_SMEM_THREADS
            and fits(hidden // 2, SCAN_LANES,
                     _round_up(hidden, 4 * SCAN_LANES))):
        return "cluster"
    return "device"


def pair_runs(gates: int, hidden: int, itemsize: int,
              max_hidden: int) -> bool:
    """Whether a kernel pair takes a scan of ``hidden`` units: within its
    hidden limit, in a supported dtype, and with its forward's plan off
    the device-memory branch (W_hh held in registers, shared memory or a
    cluster's)."""
    return (0 < hidden <= max_hidden and itemsize in (2, 4)
            and fwd_branch(gates, hidden, itemsize) != "device")


# -- the persistent LSTM scans' plan: lstm_persist_plan.cc, in Python ---------

#: lstm_persist_plan.h's constants: consumer warps a CTA, units a warp's
#: column block, row tiles a warp at most, a backward warp's tiles at most,
#: the ring's chunks, a TMA box's bytes a row and rows at most, boxes a
#: chunk at most, the barriers' bytes and the swizzle's alignment, the
#: cluster sizes in the order the plan tries them
PERSIST_WARPS, PERSIST_UNIT_GROUP, PERSIST_MAX_MT = 8, 8, 4
PERSIST_MAX_BWD_TILES = 4
PERSIST_MIN_STAGES, PERSIST_MAX_STAGES = 2, 16
PERSIST_BOX_BYTES, PERSIST_MAX_BOX_ROWS, PERSIST_MAX_BOXES = 128, 256, 4
PERSIST_BARRIER_BYTES, PERSIST_ALIGN_BYTES = 256, 1024
PERSIST_CLUSTERS = (8, 4, 2, 1)
#: the plan's fields, in the order ``fmda_lstm_persist_plan`` reports them
#: and the launches take them
PERSIST_FIELDS = ("tiles", "slices", "units", "cluster", "chunk", "stages",
                  "mt", "mt_bwd", "rows", "rows_pad", "smem", "grid",
                  "ring_off")

#: The H100's figures (NVIDIA H100 80GB HBM3, as the plan query reports
#: them: ``chip_smoke.py``'s ``wide persist plan`` line): SMs, the shared
#: memory a CTA may opt in to, and the clusters of 1, 2, 4 and 8 CTAs of
#: one SM each that can be resident at once (placed by GPC: 15 of 8, not
#: 16).  CPU tensors plan with them, so the CPU runs the card's layout.
H100_FIGURES = dict(sms=132, smem=232448,
                    clusters={1: 132, 2: 66, 4: 30, 8: 15})


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _first(candidates, ok) -> int:
    return next((m for m in candidates if ok(m)), 0)


def persist_ksplit(warps: int) -> int:
    """lstm_persist_plan.h's ``ksplit``: how many groups of ``warps``
    consumer warps split a step's K where the product needs fewer warps
    than the CTA has."""
    k = 1
    while 2 * k * warps <= PERSIST_WARPS:
        k *= 2
    return k


def _scratch(rows_pad: int, units: int, mt: int, mt_bwd: int,
             itemsize: int) -> int:
    if itemsize != 2:  # the K-split runs in bf16 only
        return 0
    mtiles, nt = rows_pad // 16, units // PERSIST_UNIT_GROUP

    def scratch(warps, floats):
        return (persist_ksplit(warps) - 1) * warps * 32 * floats * 4

    return max(scratch(_cdiv(mtiles, mt) * nt, 16 * mt),
               scratch(_cdiv(mtiles, mt_bwd), 4 * mt_bwd * nt))


def persist_plan(batch: int, hidden: int, itemsize: int, *, sms: int,
                 smem: int, clusters: Dict[int, int]
                 ) -> Optional[Dict[str, int]]:
    """How the persistent LSTM scans lay out a direction at (batch,
    hidden) in an I/O dtype of ``itemsize`` bytes on a card of ``sms`` SMs,
    ``smem`` opt-in bytes a CTA and ``clusters`` (size -> resident count):
    ``lstm_persist_plan.cc``'s ``plan``, line for line, a pure function of
    its arguments.  None where no layout fits (the per-step kernels keep
    the scan); else the fields of :data:`PERSIST_FIELDS`.  Of the layouts
    that fit it takes the most CTAs, then the most batch tiles, then the
    smallest cluster.  ``chip_smoke.py`` holds it to the library's plan
    query."""
    del sms  # the clusters' counts carry it
    unit = PERSIST_UNIT_GROUP
    if (batch < 1 or hidden < unit or hidden % unit
            or itemsize not in (2, 4)):
        return None
    if hidden % (PERSIST_BOX_BYTES // itemsize):
        return None
    pad = 16 // itemsize
    mts = (1, 2, 4)

    def smem_of(ring_off, stages, slot, scratch):
        return (ring_off + stages * slot + PERSIST_BARRIER_BYTES + scratch
                + PERSIST_ALIGN_BYTES)

    best, key = None, None
    for c in PERSIST_CLUSTERS:
        cap = clusters[c] * c
        for u in range(unit, hidden + 1, unit):
            if hidden % u:
                continue
            q = hidden // u
            if q % c or q > cap:
                continue
            rows = _cdiv(batch, min(cap // q, _cdiv(batch, 16)))
            tiles = _cdiv(batch, rows)
            rows_pad = _round_up(rows, 16)
            if rows_pad // c > PERSIST_MAX_BOX_ROWS:
                continue
            mtiles, nt = rows_pad // 16, u // unit
            mt = _first(mts, lambda m: _cdiv(mtiles, m) * nt
                        <= PERSIST_WARPS)
            mt_bwd = _first((m for m in mts
                             if m * nt <= PERSIST_MAX_BWD_TILES),
                            lambda m: _cdiv(mtiles, m) <= PERSIST_WARPS)
            if not (mt and mt_bwd):
                continue
            ring_off = _round_up(4 * u * (hidden + pad) * itemsize,
                                 PERSIST_ALIGN_BYTES)
            scratch = _scratch(rows_pad, u, mt, mt_bwd, itemsize)
            room = smem - smem_of(ring_off, 0, 0, scratch)
            chunk = stages = 0
            for boxes in (4, 2, 1):
                width = boxes * PERSIST_BOX_BYTES // itemsize
                slot = boxes * rows_pad * PERSIST_BOX_BYTES
                fit = 0 if room < 0 else min(PERSIST_MAX_STAGES,
                                             room // slot)
                if hidden % width == 0 and fit >= (
                        3 if boxes > 1 else PERSIST_MIN_STAGES):
                    chunk, stages = width, fit
                    break
            if not chunk:
                continue
            plan = dict(tiles=tiles, slices=q, units=u, cluster=c,
                        chunk=chunk, stages=stages, mt=mt, mt_bwd=mt_bwd,
                        rows=rows, rows_pad=rows_pad,
                        smem=smem_of(ring_off, stages, chunk * itemsize
                                     // PERSIST_BOX_BYTES * rows_pad
                                     * PERSIST_BOX_BYTES, scratch),
                        grid=tiles * q, ring_off=ring_off)
            k = (plan["grid"], tiles, -c)
            if key is None or k > key:
                best, key = plan, k
    return best


def persist_plan_query(batch: int, hidden: int, dtype: torch.dtype,
                       device: int) -> Tuple[Optional[Dict[str, int]],
                                             Dict[str, object]]:
    """The library's own plan of the persistent LSTM scans on card
    ``device`` (``fmda_lstm_persist_plan``): (the plan's fields, or None
    where it hands the scan back; the card's figures it was made from, as
    :func:`persist_plan` takes them)."""
    lib = load()
    n = len(PERSIST_FIELDS)
    out = (ctypes.c_int * (n + 7))()
    err = lib.fmda_lstm_persist_plan(
        batch, hidden, torch.tensor([], dtype=dtype).element_size(), device,
        out)
    raise_on(lib, err, "lstm_persist plan")
    vals = list(out)
    figures = dict(sms=vals[n + 1], smem=vals[n + 2],
                   clusters=dict(zip((1, 2, 4, 8), vals[n + 3:n + 7])))
    if not vals[0]:
        return None, figures
    return dict(zip(PERSIST_FIELDS, vals[1:n + 1])), figures


def persist_plan_ints(plan: Dict[str, int]):
    """A plan as the persistent launches take it: the ints of
    :data:`PERSIST_FIELDS`, in order."""
    return (ctypes.c_int * len(PERSIST_FIELDS))(
        *(plan[k] for k in PERSIST_FIELDS))


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
