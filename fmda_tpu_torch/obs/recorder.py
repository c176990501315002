"""The flight recorder: bounded, rotated postmortem bundles, as
``fmda_tpu.obs.recorder`` writes them.

When an SLO alert fires (or chaos injects a fault), the evidence an
operator needs is *volatile*: the span ring evicts, the event ring
wraps, the time-series window slides, and by the time a human looks the
breach has scrolled away.  :class:`FlightRecorder` freezes all of it the
moment the trigger fires:

``postmortem_<seq>_<reason>/``
    - ``meta.json``     — reason, trigger detail, stamps, alert state;
    - ``trace.json``    — the tracer's span ring as Chrome/Perfetto
      ``trace_event`` JSON (load at https://ui.perfetto.dev or feed
      ``python -m fmda_tpu_torch trace --input``);
    - ``snapshot.json`` — the full registry snapshot (every counter/
      gauge/histogram at trigger time);
    - ``tsdb.json``     — the time-series window (rates + per-interval
      latency summaries) covering the run-up to the trigger;
    - ``events.jsonl``  — the event-log tail;
    - ``workers.json``  — per-worker stats (heartbeat-carried serving
      counters, wire frame stats) when a fleet context supplies them;
    - ``profile.folded`` — the host profiler's flamegraph-collapsed
      stacks (where the host was when the breach fired);
    - ``device.json``   — the kernel ledger + device memory report
      (fmda_tpu_torch.obs.device: launches, sampled device time, MFU,
      watermarks);
    - ``quality.json``  — the model-quality window (fmda_tpu_torch.obs.quality:
      per-version accuracy/F-beta, drift scores, the capture/join
      conservation ledger) when an evaluator is attached.

Bundles are **bounded and rotated**: at most ``keep`` on disk (oldest
deleted), with a per-reason debounce so a flapping alert cannot write
the disk full.  Every write is best-effort — a full disk degrades the
postmortem, never the serving loop that triggered it.

torch-free (router-role code); reads pass through the injected callables
so the recorder never imports the subsystems it dumps.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import Callable, Dict, List, Optional

log = logging.getLogger("fmda_tpu_torch.obs")


def _safe(reason: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "-" for c in reason)


class FlightRecorder:
    """Dumps the observability plane's volatile state on demand."""

    def __init__(
        self,
        directory: str,
        *,
        keep: int = 4,
        min_interval_s: float = 60.0,
        window_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        store=None,
        events=None,
        tracer=None,
        snapshot_fn: Optional[Callable[[], dict]] = None,
        workers_fn: Optional[Callable[[], dict]] = None,
        profile_fn: Optional[Callable[[], str]] = None,
        device_fn: Optional[Callable[[], dict]] = None,
        quality_fn: Optional[Callable[[], dict]] = None,
    ) -> None:
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = directory
        self.keep = keep
        self.min_interval_s = min_interval_s
        self.window_s = window_s
        self.clock = clock
        self.store = store
        self.events = events
        self.tracer = tracer
        self.snapshot_fn = snapshot_fn
        self.workers_fn = workers_fn
        self.profile_fn = profile_fn
        self.device_fn = device_fn
        self.quality_fn = quality_fn
        #: reason -> clock stamp of its last bundle (the debounce)
        self._last: Dict[str, float] = {}
        self._seq = 0
        self.triggered_total = 0
        self.debounced_total = 0

    # -- trigger ------------------------------------------------------------

    def trigger(
        self,
        reason: str,
        detail: Optional[dict] = None,
        now: Optional[float] = None,
    ) -> Optional[str]:
        """Write one bundle; returns its path, or None when debounced
        (or the write failed — counted + logged, never raised: the
        recorder must not crash the loop that fired it)."""
        now = self.clock() if now is None else now
        last = self._last.get(reason)
        if last is not None and now - last < self.min_interval_s:
            self.debounced_total += 1
            return None
        self._last[reason] = now
        self._seq += 1
        name = f"postmortem_{self._seq:04d}_{_safe(reason)}"
        path = os.path.join(self.directory, name)
        try:
            os.makedirs(path, exist_ok=True)
            self._write(path, reason, detail, now)
            self._rotate()
        # loss-free: every bundle write is best-effort by contract —
        # a full disk must never take down the alerting that fired it
        except OSError as e:
            log.error("flight recorder: bundle %s failed: %s", name, e)
            return None
        self.triggered_total += 1
        log.warning("flight recorder: postmortem bundle %s (%s)",
                    path, reason)
        return path

    def _write(self, path: str, reason: str, detail: Optional[dict],
               now: float) -> None:
        meta = {
            "reason": reason,
            "detail": detail or {},
            "monotonic": now,
            "unix_ts": time.time(),
            "window_s": self.window_s,
        }
        self._dump_json(path, "meta.json", meta)
        if self.tracer is not None:
            self._dump_json(path, "trace.json", self.tracer.chrome())
        if self.snapshot_fn is not None:
            self._guarded(path, "snapshot.json",
                          lambda: self._dump_json(
                              path, "snapshot.json", self.snapshot_fn()))
        if self.store is not None:
            self._guarded(path, "tsdb.json",
                          lambda: self._dump_json(
                              path, "tsdb.json",
                              self.store.dump(window_s=self.window_s,
                                              now=now)))
        if self.events is not None:
            self._guarded(path, "events.jsonl",
                          lambda: self._dump_text(
                              path, "events.jsonl", self.events.to_jsonl()))
        if self.workers_fn is not None:
            self._guarded(path, "workers.json",
                          lambda: self._dump_json(
                              path, "workers.json", self.workers_fn()))
        if self.profile_fn is not None:
            self._guarded(path, "profile.folded",
                          lambda: self._dump_text(
                              path, "profile.folded", self.profile_fn()))
        if self.device_fn is not None:
            self._guarded(path, "device.json",
                          lambda: self._dump_json(
                              path, "device.json", self.device_fn()))
        if self.quality_fn is not None:
            # the model-quality window (per-version accuracy, drift,
            # conservation ledger) at trigger time — the evidence a
            # quality-SLO postmortem is about
            self._guarded(path, "quality.json",
                          lambda: self._dump_json(
                              path, "quality.json", self.quality_fn()))

    def _guarded(self, path: str, name: str, fn) -> None:
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — loss-free: one dead
            # source (a closed warehouse, an unserialisable stat)
            # degrades that file, never the rest of the bundle
            log.warning("flight recorder: %s/%s skipped: %s",
                        os.path.basename(path), name, e)

    @staticmethod
    def _dump_json(path: str, name: str, doc) -> None:
        with open(os.path.join(path, name), "w") as fh:
            json.dump(doc, fh, indent=2, default=str)
            fh.write("\n")

    @staticmethod
    def _dump_text(path: str, name: str, text: str) -> None:
        with open(os.path.join(path, name), "w") as fh:
            fh.write(text)

    # -- rotation -----------------------------------------------------------

    def bundles(self) -> List[str]:
        """Bundle paths on disk, oldest first (by sequence in the name)."""
        try:
            names = sorted(
                n for n in os.listdir(self.directory)
                if n.startswith("postmortem_"))
        except OSError:  # loss-free: no directory means no bundles
            return []
        return [os.path.join(self.directory, n) for n in names]

    def _rotate(self) -> None:
        bundles = self.bundles()
        for path in bundles[:max(0, len(bundles) - self.keep)]:
            try:
                shutil.rmtree(path)
            # loss-free: a bundle that refuses deletion only costs disk
            except OSError as e:
                log.warning("flight recorder: rotate %s failed: %s",
                            path, e)
