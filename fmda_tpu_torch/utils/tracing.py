"""Host wall clock per named pipeline stage, and device-trace helpers, as
``fmda_tpu.utils.tracing`` defines them.

:class:`StageTimer` times host stages.  The reference's device helpers
wrap the JAX profiler; here they wrap :mod:`torch.profiler`:
:func:`device_scope` and :func:`step_annotation` are
``record_function`` ranges (and NVTX ranges on a CUDA build), and
:func:`device_trace` captures a CPU and CUDA profile of the enclosed
region as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator

log = logging.getLogger("fmda_tpu_torch")


class StageTimer:
    """Accumulates wall-clock per named stage; cheap enough for hot loops.

    Thread-safe: one lock around the accumulator writes and the summary
    read, so a reader's ``summary()`` never iterates a dict another
    thread is growing.  The stage body itself runs outside the lock —
    only the two dict updates are serialised.
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            with self._lock:
                self.totals[name] += elapsed
                self.counts[name] += 1

    def observe(self, name: str, seconds: float) -> None:
        """Record an already-measured duration (callers that time with
        their own clock, e.g. the gateway's multi-point flush path)."""
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "total_s": total,
                    "count": self.counts[name],
                    "mean_s": total / max(self.counts[name], 1),
                }
                for name, total in self.totals.items()
            }

    def log_summary(self, level: int = logging.INFO) -> None:
        for name, stats in sorted(self.summary().items()):
            log.log(
                level,
                "stage %-24s total=%.4fs count=%d mean=%.6fs",
                name,
                stats["total_s"],
                int(stats["count"]),
                stats["mean_s"],
            )


def _nvtx():
    """``torch.cuda.nvtx`` where this torch has CUDA, else None."""
    import torch

    return torch.cuda.nvtx if torch.cuda.is_available() else None


@contextlib.contextmanager
def device_scope(name: str) -> Iterator[None]:
    """Name a region on the profiler's timeline: a ``record_function``
    range (and an NVTX range on a CUDA build)."""
    import torch

    nvtx = _nvtx()
    if nvtx is not None:
        nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx is not None:
            nvtx.range_pop()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a CPU and CUDA profile of the enclosed region and write it
    into ``log_dir`` as a Chrome trace (``trace.<pid>.json``; load it at
    https://ui.perfetto.dev).  Wrap a few steps of a hot loop, not a whole
    run: traces are large."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace.{os.getpid()}.json"))


def step_annotation(name: str, step: int):
    """Mark one step on the profiler's timeline: a range named
    ``f"{name}#{step}"``."""
    return device_scope(f"{name}#{step}")
