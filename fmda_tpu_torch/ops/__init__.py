"""Tensor ops of the port: the GRU and LSTM projections and scans (the
kernel pairs, and the wide route past their envelope), the SSM's scans and serve tick, multi-head attention and its flash op (with
their CUDA kernels), the technical indicators (numpy) and the multi-label
metrics.

Each kernel's wrapper adds one to its counter where it launches the
kernel, and calls :func:`count_launch` beside it; :func:`launch_counts`
reads the counters, by kernel name, and :func:`thread_launches` the
launches of the calling thread alone.  Around its C call each wrapper also
makes its C call through :func:`call_booked`, which books the launch in
the kernel ledger when one is attached (:func:`attach_ledger`; see
:mod:`fmda_tpu_torch.obs.device`)."""

from __future__ import annotations

import importlib
import threading
from typing import Dict

#: kernel name -> (module of its wrapper, the counter the wrapper adds to)
LAUNCH_COUNTERS = {
    "gru_scan_fwd": ("gru_kernel", "launches"),
    "gru_scan_bwd": ("gru_kernel", "bwd_launches"),
    "lstm_scan_fwd": ("lstm_kernel", "launches"),
    "lstm_scan_bwd": ("lstm_kernel", "bwd_launches"),
    "scan_dw": ("scan_dw", "launches"),
    "ssm_step": ("ssm_kernel", "launches"),
    "ssm_tick": ("ssm_kernel", "tick_launches"),
    "flash_fwd": ("attention_kernel", "fwd_launches"),
    "flash_dkv": ("attention_kernel", "dkv_launches"),
    "flash_dq": ("attention_kernel", "dq_launches"),
    "flash_bwd": ("attention_kernel", "bwd_launches"),
    "gru_wide_fwd": ("wide_scan", "gru_fwd_launches"),
    "gru_wide_bwd": ("wide_scan", "gru_bwd_launches"),
    "lstm_wide_fwd": ("wide_scan", "lstm_fwd_launches"),
    "lstm_wide_bwd": ("wide_scan", "lstm_bwd_launches"),
    "lstm_persist_fwd": ("wide_scan", "lstm_persist_fwd_launches"),
    "lstm_persist_bwd": ("wide_scan", "lstm_persist_bwd_launches"),
    "gru_wide_step_fwd": ("gru_wide_step", "launches"),
    "gru_wide_bwd_step": ("gru_wide_bwd_step", "launches"),
}


def _module(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def launch_counts() -> Dict[str, int]:
    """Every kernel's launches so far in this process, by kernel name."""
    return {kernel: getattr(_module(mod), attr)
            for kernel, (mod, attr) in LAUNCH_COUNTERS.items()}


def total_launches() -> int:
    """The launches of every kernel together."""
    return sum(launch_counts().values())


_thread = threading.local()


def count_launch(n: int = 1) -> None:
    """Add ``n`` launches to the calling thread's count."""
    _thread.launches = getattr(_thread, "launches", 0) + n


def thread_launches() -> int:
    """The launches of every kernel made by the calling thread so far: a
    flush's own launches, when a trainer launches kernels from another
    thread at the same time."""
    return getattr(_thread, "launches", 0)


#: the kernel ledger the wrappers book their launches into; None (the
#: default) books nothing
_ledger = None


def attach_ledger(ledger) -> None:
    """Book every launch from now on into ``ledger`` (an object with
    ``begin(kernel, signature)`` and ``end(token)``), or into none."""
    global _ledger
    _ledger = ledger


def book_launch(kernel: str, signature: tuple):
    """Just before a kernel's C call: book the launch of ``kernel`` with
    the shapes ``signature`` (its cost's arguments,
    :data:`fmda_tpu_torch.ops.cost.LAUNCH_COSTS`).  Returns the token
    :func:`launch_done` takes."""
    ledger = _ledger
    if ledger is None:
        return None
    return ledger.begin(kernel, signature)


def launch_done(token, kernels=None) -> None:
    """Just after the C call that :func:`book_launch` booked.  ``kernels``
    names what the call launched when that differs from the booked name
    (a backward that ran as two sweeps)."""
    if token is not None:
        token[0].end(token, kernels)


def call_booked(kernel: str, signature: tuple, fn, args, kernels=None):
    """``fn(*args)``, a kernel's C entry, booked as a launch of ``kernel``
    with the shapes ``signature``: the arguments are evaluated before the
    booking, so a timed launch's events bracket the C call alone.
    ``kernels()``, when given, names what the call launched (read after
    it)."""
    token = book_launch(kernel, signature)
    err = fn(*args)
    launch_done(token, None if kernels is None else kernels())
    return err


def reset_launch_counts() -> None:
    """Every kernel's launch count to 0."""
    for mod, attr in LAUNCH_COUNTERS.values():
        setattr(_module(mod), attr, 0)
