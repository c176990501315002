"""Device observability on the card: the kernel ledger, cost and MFU, and
device memory, the counterpart of ``fmda_tpu.obs.device``.

The reference watches what XLA compiled; the port compiles nothing per
shape (``nvcc`` builds every kernel once, :mod:`fmda_tpu_torch.ops._cuda_lib`),
so its device plane watches the kernels themselves.  Three instruments,
torch-free at import (torch is imported only where a sample is taken):

- :class:`KernelLedger`: every launch of every kernel the wrappers make,
  booked through :func:`fmda_tpu_torch.ops.book_launch` once the ledger is
  attached (:func:`configure_device_obs`).  Per ``(kernel, signature)``
  (the launch's shapes) it keeps the launches, the FLOPs and bytes of one
  launch (:data:`fmda_tpu_torch.ops.cost.LAUNCH_COSTS`, the formulas of
  ``chip_smoke.py``'s ``bound_ms``), and device milliseconds from a pair
  of ``torch.cuda.Event`` recorded around every ``sample_every``-th launch
  of a kernel: their sum and mean, and their minimum.  Scrape time reads only the pairs whose end event has
  completed (``query()``), and derives ``device_mfu`` and
  ``device_arithmetic_intensity`` between scrapes against the H100's
  peaks (:data:`~fmda_tpu_torch.ops.cost.PEAK_F32_FLOP_PER_S`, 67 TFLOP/s,
  and 3.35 TB/s).  Its dump has a pinned schema (:data:`LEDGER_SCHEMA`,
  :data:`KERNEL_SCHEMA`) and carries the build's ``nvcc`` seconds.
- :class:`DeviceMemoryMonitor`: a cadence-gated sampler of the caching
  allocator (``torch.cuda.memory_allocated``, ``memory_reserved``,
  ``max_memory_allocated``, ``mem_get_info``) with per-owner bytes from
  callbacks that return tensors (the pool's state, a model's parameters),
  each storage counted once, a high watermark and a leak heuristic on
  *allocated* bytes (reserved bytes only grow: the allocator keeps what
  it cached, so a heuristic on them fires on every warm-up).  Pinned host
  staging (``device.PinnedStaging``) is host memory, and no owner
  reports it.  Without a card the monitor reports its owners' bytes and
  no allocator figures (``None``).
- :func:`device_report`: the ``/device`` document ``perf`` reads.

What a sampled device time bounds: the pair is recorded on the launch's
stream just before and just after the wrapper's C call, so it spans the
kernel, any gap while the host enqueues it on an idle card, and any work
another thread (the continuous trainer shares the fleet's stream) put
on that stream in between.  Each pair is an upper bound of the kernel's
own time, so their minimum is the tightest; the mean carries the host's
jitter too.  A backward flash call that runs as two sweeps shares one pair,
booked under ``flash_dkv``.  On a CPU run nothing launches: the ledger
reports 0 launches and no device time.

No counterpart, and why: ``tracked_jit``, the jit-cache probe,
cost-analysis FLOPs and unexpected-recompile detection watch a compiler
that compiles per shape at run time; the port compiles once, before the
first launch, and its kernels take every shape of their envelope.  The
reference's ``kernel_fallbacks`` counts a Pallas kernel's fall back to
its reference path; a port wrapper on a CUDA tensor launches its kernel
or raises, so there is no fallback to count and the key is dropped.

Cost discipline: a detached ledger costs each launch one module-global
read; an attached one a dict update under one lock, and two event records
on a sampled launch.  No instrument synchronizes the card or reads a
tensor's value on a hot path.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

#: bump when LEDGER_SCHEMA / KERNEL_SCHEMA change shape
LEDGER_SCHEMA_VERSION = 1

#: exact key set of KernelLedger.dump() (pinned)
LEDGER_SCHEMA = (
    "schema_version", "backend", "launches_total", "sampled_launches_total",
    "device_ms_sampled_total", "flops_total", "bytes_total",
    "pending_samples", "dropped_samples", "sample_every", "nvcc_seconds",
    "kernels",
)

#: exact key set of each dump()["kernels"] entry (pinned)
KERNEL_SCHEMA = (
    "kernel", "signature", "launches", "flops", "bytes_moved", "sampled",
    "device_ms_sampled", "device_ms_mean", "device_ms_min",
)

#: exact key set of device_report() (pinned)
REPORT_SCHEMA = ("ledger", "memory", "mfu", "arithmetic_intensity")


def _cuda_available() -> bool:
    try:
        import torch

        return bool(torch.cuda.is_available())
    except Exception:  # noqa: BLE001 — a torch that cannot probe its
        # runtime reads as no card: the plane reports, it never raises
        return False


class _Record:
    """One (kernel, signature)'s account."""

    __slots__ = ("kernel", "signature", "launches", "flops", "bytes_moved",
                 "sampled", "device_ms", "device_ms_min")

    def __init__(self, kernel: str, signature: tuple, cost) -> None:
        self.kernel = kernel
        self.signature = signature
        self.launches = 0
        self.flops = float(cost.flops)
        self.bytes_moved = float(cost.bytes_moved)
        self.sampled = 0
        self.device_ms = 0.0
        self.device_ms_min: Optional[float] = None


class KernelLedger:
    """Per-kernel launches, cost and sampled device time.

    Thread-safe: the fleet's pump and a trainer's thread book launches at
    the same time.  ``begin``/``end`` are what
    :func:`fmda_tpu_torch.ops.book_launch` and ``launch_done`` call."""

    def __init__(self, *, enabled: bool = True, sample_every: int = 16,
                 max_pending: int = 4096, event=None) -> None:
        self.enabled = enabled
        #: time one launch in this many of each kernel (0: none)
        self.sample_every = int(sample_every)
        #: makes the timing events (``torch.cuda.Event(enable_timing=True)``
        #: unless given): ``record()``, ``query()``, ``elapsed_time(end)``
        self._event = event
        self._lock = threading.Lock()
        self._records: Dict[Tuple[str, tuple], _Record] = {}
        self._begun: Dict[str, int] = {}
        #: (record, start event, end event) awaiting completion
        self._pending: deque = deque()
        self._max_pending = int(max_pending)
        self._dropped = 0
        self._mfu_prev: Optional[Tuple[float, float, float]] = None
        self._mfu = 0.0
        self._intensity = 0.0

    # -- the launch path -----------------------------------------------------

    def begin(self, kernel: str, signature: tuple):
        """Before the C call: the token :meth:`end` takes (None when
        disabled), with a start event on sampled launches."""
        if not self.enabled:
            return None
        # a race between two launching threads skews one sampling draw
        n = self._begun.get(kernel, 0) + 1
        self._begun[kernel] = n
        start = None
        if self.sample_every and n % self.sample_every == 0:
            start = self._new_event()
            start.record()
        return (self, kernel, signature, start)

    def _new_event(self):
        if self._event is not None:
            return self._event()
        import torch

        return torch.cuda.Event(enable_timing=True)

    def end(self, token, kernels=None) -> None:
        """After the C call: book the launch (under ``kernels`` when the
        call launched other kernels than the one it was booked as)."""
        _, kernel, signature, start = token
        stop = None
        if start is not None:
            stop = self._new_event()
            stop.record()
        names = kernels or (kernel,)
        with self._lock:
            first = None
            for name in names:
                rec = self._records.get((name, signature))
                if rec is None:
                    from fmda_tpu_torch.ops.cost import LAUNCH_COSTS

                    rec = self._records[(name, signature)] = _Record(
                        name, signature, LAUNCH_COSTS[name](signature))
                rec.launches += 1
                first = first or rec
            if stop is not None:
                if len(self._pending) >= self._max_pending:
                    self._pending.popleft()
                    self._dropped += 1
                self._pending.append((first, start, stop))

    # -- scrape-time reads ---------------------------------------------------

    def _collect_locked(self) -> None:
        """Fold every completed sampled pair into its record; pairs still
        on the card stay pending (``query()``: no wait)."""
        keep = deque()
        for rec, start, stop in self._pending:
            if stop.query():
                ms = start.elapsed_time(stop)
                rec.sampled += 1
                rec.device_ms += ms
                if rec.device_ms_min is None or ms < rec.device_ms_min:
                    rec.device_ms_min = ms
            else:
                keep.append((rec, start, stop))
        self._pending = keep

    def reset(self) -> None:
        """Drop every record and sample (tests; a run's fresh start)."""
        with self._lock:
            self._records.clear()
            self._begun.clear()
            self._pending = deque()
            self._dropped = 0
            self._mfu_prev = None
            self._mfu = 0.0
            self._intensity = 0.0

    def launches(self) -> Dict[str, int]:
        """Launches booked, by kernel."""
        with self._lock:
            out: Dict[str, int] = {}
            for rec in self._records.values():
                out[rec.kernel] = out.get(rec.kernel, 0) + rec.launches
        return out

    def kernel_totals(self) -> Dict[str, Dict[str, float]]:
        """By kernel: launches, sampled launches, sampled device ms, their
        mean and minimum, FLOPs and bytes done."""
        with self._lock:
            self._collect_locked()
            recs = list(self._records.values())
        out: Dict[str, Dict[str, float]] = {}
        for rec in recs:
            acc = out.setdefault(rec.kernel, dict(
                launches=0, sampled=0, device_ms_sampled=0.0, flops=0.0,
                bytes_moved=0.0))
            acc["launches"] += rec.launches
            acc["sampled"] += rec.sampled
            acc["device_ms_sampled"] += rec.device_ms
            acc["flops"] += rec.launches * rec.flops
            acc["bytes_moved"] += rec.launches * rec.bytes_moved
            if rec.device_ms_min is not None:
                acc["device_ms_min"] = min(
                    acc.get("device_ms_min", rec.device_ms_min),
                    rec.device_ms_min)
        for acc in out.values():
            acc.setdefault("device_ms_min", None)
            acc["device_ms_mean"] = (acc["device_ms_sampled"] / acc["sampled"]
                                     if acc["sampled"] else None)
        return out

    def backend(self) -> str:
        return "cuda" if _cuda_available() else "cpu"

    def mfu(self) -> float:
        """The last scrape interval's MFU (0.0 until two scrapes land)."""
        with self._lock:
            return self._mfu

    def arithmetic_intensity(self) -> float:
        with self._lock:
            return self._intensity

    def dump(self) -> Dict[str, object]:
        """The pinned-schema ledger document (:data:`LEDGER_SCHEMA`)."""
        with self._lock:
            self._collect_locked()
            recs = list(self._records.values())
            pending = len(self._pending)
            dropped = self._dropped
        kernels = [{
            "kernel": r.kernel,
            "signature": repr(r.signature),
            "launches": r.launches,
            "flops": r.flops,
            "bytes_moved": r.bytes_moved,
            "sampled": r.sampled,
            "device_ms_sampled": r.device_ms,
            "device_ms_mean": r.device_ms / r.sampled if r.sampled else None,
            "device_ms_min": r.device_ms_min,
        } for r in recs]
        kernels.sort(key=lambda k: (k["kernel"], k["signature"]))
        return {
            "schema_version": LEDGER_SCHEMA_VERSION,
            "backend": self.backend(),
            "launches_total": sum(r.launches for r in recs),
            "sampled_launches_total": sum(r.sampled for r in recs),
            "device_ms_sampled_total": sum(r.device_ms for r in recs),
            "flops_total": sum(r.launches * r.flops for r in recs),
            "bytes_total": sum(r.launches * r.bytes_moved for r in recs),
            "pending_samples": pending,
            "dropped_samples": dropped,
            "sample_every": self.sample_every,
            "nvcc_seconds": nvcc_seconds(),
            "kernels": kernels,
        }

    def families(self) -> Dict[str, List[Dict[str, object]]]:
        """Scrape-time collector (registry snapshot shape): per-kernel
        launch counters and sampled device time, the build's seconds, and
        the MFU and arithmetic intensity of the interval since the last
        scrape."""
        from fmda_tpu_torch.ops.cost import PEAK_F32_FLOP_PER_S

        totals = self.kernel_totals()
        counters: List[Dict[str, object]] = []
        gauges: List[Dict[str, object]] = []
        flops_done = bytes_done = 0.0
        for name, acc in sorted(totals.items()):
            flops_done += acc["flops"]
            bytes_done += acc["bytes_moved"]
            labels = {"kernel": name}
            counters.append({"name": "kernel_launches_total",
                             "labels": labels, "value": acc["launches"]})
            counters.append({"name": "kernel_sampled_launches_total",
                             "labels": labels, "value": acc["sampled"]})
            counters.append({"name": "kernel_device_ms_sampled_total",
                             "labels": labels,
                             "value": acc["device_ms_sampled"]})
            counters.append({"name": "kernel_flops_total",
                             "labels": labels, "value": acc["flops"]})
        seconds = nvcc_seconds()
        if seconds is not None:
            gauges.append({"name": "kernel_build_seconds", "labels": {},
                           "value": seconds})
        backend = self.backend()
        now = time.monotonic()
        with self._lock:
            prev = self._mfu_prev
            self._mfu_prev = (now, flops_done, bytes_done)
            if prev is not None and now > prev[0]:
                d_flops = max(0.0, flops_done - prev[1])
                d_bytes = max(0.0, bytes_done - prev[2])
                self._mfu = d_flops / (now - prev[0]) / PEAK_F32_FLOP_PER_S
                self._intensity = d_flops / d_bytes if d_bytes else 0.0
            mfu, intensity = self._mfu, self._intensity
        gauges.append({"name": "device_mfu", "labels": {"backend": backend},
                       "value": mfu})
        gauges.append({"name": "device_arithmetic_intensity",
                       "labels": {"backend": backend}, "value": intensity})
        return {"counters": counters, "gauges": gauges}


def nvcc_seconds() -> Optional[float]:
    """The kernels' build time in this process (None when the library was
    already built, or never loaded)."""
    import sys

    lib = sys.modules.get("fmda_tpu_torch.ops._cuda_lib")
    return None if lib is None else lib.build_info.get("seconds")


def _tensors(obj):
    """Every tensor in a nest of tuples, lists and dicts."""
    if hasattr(obj, "untyped_storage"):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)


class DeviceMemoryMonitor:
    """Cadence-gated device memory sampler.

    Owners register a callback returning their live tensors; a sample
    attributes each owner's bytes (each storage once, so views of one
    tensor count once), reads the caching allocator where a card is
    present, tracks the high watermark and runs a monotonic-growth leak
    heuristic on allocated bytes: ``leak_window`` consecutive samples each
    strictly above the last → suspected leak.  ``maybe_sample`` costs one
    clock read when not due."""

    def __init__(self, *, interval_s: float = 5.0, leak_window: int = 12,
                 enabled: bool = True) -> None:
        self.enabled = enabled
        self.interval_s = interval_s
        self.leak_window = max(3, int(leak_window))
        self._lock = threading.Lock()
        self._owners: Dict[str, Callable[[], object]] = {}
        self._last_sample: Optional[float] = None
        self._by_owner: Dict[str, float] = {}
        self._owners_bytes = 0.0
        self._allocated: Optional[float] = None
        self._reserved: Optional[float] = None
        self._max_allocated: Optional[float] = None
        self._free: Optional[float] = None
        self._total: Optional[float] = None
        self._watermark = 0.0
        self._history: deque = deque(maxlen=self.leak_window)
        self._leak = False
        self._samples = 0

    def register_owner(self, name: str,
                       tensors_fn: Callable[[], object]) -> None:
        """Attach an owner's callback (a second registration under the
        same name replaces the first)."""
        with self._lock:
            self._owners[name] = tensors_fn

    def set_leak_window(self, window: int) -> None:
        window = max(3, int(window))
        with self._lock:
            if window != self.leak_window:
                self.leak_window = window
                self._history = deque(self._history, maxlen=window)

    def maybe_sample(self, now: Optional[float] = None) -> bool:
        """Sample if the cadence is due; True when a sample was taken."""
        if not self.enabled:
            return False
        if now is None:
            now = time.monotonic()
        last = self._last_sample
        if last is not None and now - last < self.interval_s:
            return False
        self._last_sample = now
        self.sample()
        return True

    def sample(self) -> Dict[str, object]:
        """Take one sample now (cadence ignored)."""
        with self._lock:
            owners = dict(self._owners)
        by_owner: Dict[str, float] = {}
        seen_all: set = set()
        owners_bytes = 0.0
        for name, fn in owners.items():
            seen: set = set()
            total = 0.0
            try:
                for t in _tensors(fn()):
                    st = t.untyped_storage()
                    key = (str(t.device), st.data_ptr())
                    if key in seen:
                        continue
                    seen.add(key)
                    total += st.nbytes()
                    if key not in seen_all:
                        seen_all.add(key)
                        owners_bytes += st.nbytes()
            except Exception:  # noqa: BLE001 — a mid-teardown owner (a
                # pool being rebuilt) reads as zero for one sample, never
                # breaks the monitor
                total = 0.0
            by_owner[name] = total
        allocated = reserved = max_allocated = free = total_mem = None
        if _cuda_available():
            import torch

            allocated = float(torch.cuda.memory_allocated())
            reserved = float(torch.cuda.memory_reserved())
            max_allocated = float(torch.cuda.max_memory_allocated())
            free_b, total_b = torch.cuda.mem_get_info()
            free, total_mem = float(free_b), float(total_b)
        basis = allocated if allocated is not None else owners_bytes
        with self._lock:
            self._by_owner = by_owner
            self._owners_bytes = owners_bytes
            self._allocated = allocated
            self._reserved = reserved
            self._max_allocated = max_allocated
            self._free, self._total = free, total_mem
            self._watermark = max(self._watermark, basis,
                                  max_allocated or 0.0)
            self._history.append(basis)
            hist = list(self._history)
            self._leak = (len(hist) == self.leak_window
                          and all(b > a for a, b in zip(hist, hist[1:])))
            self._samples += 1
            return self._doc_locked()

    # -- export --------------------------------------------------------------

    def _doc_locked(self) -> Dict[str, object]:
        return {
            "allocated_bytes": self._allocated,
            "reserved_bytes": self._reserved,
            "max_allocated_bytes": self._max_allocated,
            "free_bytes": self._free,
            "total_bytes": self._total,
            "owners_bytes": self._owners_bytes,
            "by_owner": dict(self._by_owner),
            "watermark_bytes": self._watermark,
            "leak_suspected": self._leak,
            "samples": self._samples,
            "leak_window": self.leak_window,
        }

    def doc(self) -> Dict[str, object]:
        with self._lock:
            return self._doc_locked()

    @property
    def watermark_bytes(self) -> float:
        with self._lock:
            return self._watermark

    @property
    def leak_suspected(self) -> bool:
        with self._lock:
            return self._leak

    def families(self) -> Dict[str, List[Dict[str, object]]]:
        with self._lock:
            doc = self._doc_locked()
        gauges = []
        for key, name in (("allocated_bytes", "device_allocated_bytes"),
                          ("reserved_bytes", "device_reserved_bytes"),
                          ("free_bytes", "device_free_bytes")):
            if doc[key] is not None:
                gauges.append({"name": name, "labels": {},
                               "value": doc[key]})
        for owner, nbytes in sorted(doc["by_owner"].items()):
            gauges.append({"name": "device_live_bytes",
                           "labels": {"owner": owner}, "value": nbytes})
        gauges.append({"name": "device_memory_watermark_bytes",
                       "labels": {}, "value": doc["watermark_bytes"]})
        gauges.append({"name": "device_memory_leak_suspected", "labels": {},
                       "value": 1.0 if doc["leak_suspected"] else 0.0})
        counters = [{"name": "device_memory_samples_total", "labels": {},
                     "value": doc["samples"]}]
        return {"counters": counters, "gauges": gauges}


# -- process defaults + config ------------------------------------------------

_DEFAULT_LEDGER = KernelLedger(enabled=True)
_DEFAULT_MEMORY = DeviceMemoryMonitor()


def default_ledger() -> KernelLedger:
    return _DEFAULT_LEDGER


def default_memory_monitor() -> DeviceMemoryMonitor:
    return _DEFAULT_MEMORY


def configure_device_obs(cfg) -> None:
    """Apply a ``ProfilingConfig`` to the process defaults: attach the
    kernel ledger to the wrappers (or detach it), set the memory cadence
    and leak window, and start or stop the host profiler.  Serve-time
    entry points call this before building pools; a process that never
    does books no launches."""
    from fmda_tpu_torch import ops
    from fmda_tpu_torch.obs.pyprof import default_profiler

    led = default_ledger()
    led.enabled = bool(cfg.enabled)
    ops.attach_ledger(led if cfg.enabled else None)
    mon = default_memory_monitor()
    mon.enabled = bool(cfg.enabled)
    mon.interval_s = float(cfg.memory_interval_s)
    mon.set_leak_window(cfg.memory_leak_window)
    prof = default_profiler()
    prof.interval_ms = float(cfg.profile_interval_ms)
    prof.max_stacks = int(cfg.profile_max_stacks)
    if cfg.enabled and cfg.host_profiler:
        prof.start()
    elif prof.running:
        prof.stop()


def device_report(*, ledger: Optional[KernelLedger] = None,
                  memory: Optional[DeviceMemoryMonitor] = None
                  ) -> Dict[str, object]:
    """The ``/device`` document (:data:`REPORT_SCHEMA`): the ledger dump,
    the memory doc, and the last scrape interval's MFU and arithmetic
    intensity."""
    ledger = ledger if ledger is not None else default_ledger()
    memory = memory if memory is not None else default_memory_monitor()
    return {
        "ledger": ledger.dump(),
        "memory": memory.doc(),
        "mfu": ledger.mfu(),
        "arithmetic_intensity": ledger.arithmetic_intensity(),
    }
