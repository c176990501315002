"""The native C++ join scheduler (``native/joincore.cpp``) through ctypes,
as ``fmda_tpu.stream.native_join`` binds it.

With ``StreamEngine(..., join_backend="native")`` the engine's matching
loop (the watermarked interval join of every pending book tick against
every side feed) runs in C++; the payloads stay in Python keyed by
timestamp, so only int64 scheduling state crosses the boundary.  Its join
decisions are the Python scheduler's, bit for bit.  The library builds on
demand like the ring bus (:mod:`fmda_tpu_torch.stream._native`).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

from fmda_tpu_torch.stream._native import build_and_load


class NativeJoinUnavailable(RuntimeError):
    pass


def _load_library() -> ctypes.CDLL:
    lib = build_and_load("libjoincore.so", NativeJoinUnavailable)
    lib.jc_create.restype = ctypes.c_void_p
    lib.jc_create.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32]
    lib.jc_destroy.argtypes = [ctypes.c_void_p]
    lib.jc_add_side.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                ctypes.c_int64]
    lib.jc_force_max_ts.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                    ctypes.c_int64]
    lib.jc_add_deep.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.jc_pending.restype = ctypes.c_int64
    lib.jc_pending.argtypes = [ctypes.c_void_p]
    lib.jc_step.restype = ctypes.c_int64
    lib.jc_step.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


_lib: Optional[ctypes.CDLL] = None


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _load_library()
    return _lib


def native_join_available() -> bool:
    """Whether the join scheduler builds and loads here."""
    try:
        _get_lib()
        return True
    except NativeJoinUnavailable:  # loss-free: a capability probe
        return False


class NativeJoinCore:
    """Scheduler handle: add timestamps, step, read the matched tuples."""

    def __init__(self, floor_s: int, tolerance_s: int, watermark_s: int,
                 n_streams: int) -> None:
        self._lib = _get_lib()
        self.n_streams = n_streams
        self._handle = self._lib.jc_create(floor_s, tolerance_s,
                                           watermark_s, n_streams)
        if not self._handle:
            raise NativeJoinUnavailable("jc_create failed")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.jc_destroy(handle)
            self._handle = None

    def add_side(self, stream: int, ts: int) -> None:
        self._lib.jc_add_side(self._handle, stream, ts)

    def force_max_ts(self, stream: int, max_ts: int) -> None:
        self._lib.jc_force_max_ts(self._handle, stream, max_ts)

    def add_deep(self, ts: int) -> None:
        self._lib.jc_add_deep(self._handle, ts)

    @property
    def pending(self) -> int:
        return int(self._lib.jc_pending(self._handle))

    def step(self) -> Tuple[List[Tuple[int, ...]], List[int]]:
        """One micro-batch: ``(emitted, dropped)``, emitted the matched
        ``(deep_ts, side_ts_0, ..., side_ts_{n-1})`` in timestamp order,
        dropped the book timestamps past every horizon."""
        cap = max(self.pending, 1)
        width = 1 + self.n_streams
        rows = (ctypes.c_int64 * (cap * width))()
        drops = (ctypes.c_int64 * cap)()
        n_dropped = ctypes.c_int64(0)
        n = int(self._lib.jc_step(self._handle, rows, cap, drops, cap,
                                  ctypes.byref(n_dropped)))
        if n < 0 or n > cap or n_dropped.value > cap:
            raise RuntimeError("jc_step overflow/failure")
        emitted = [tuple(rows[i * width:(i + 1) * width]) for i in range(n)]
        dropped = [int(drops[i]) for i in range(n_dropped.value)]
        return emitted, dropped
