"""Single-command local fleet topology: workers spawned, router inline, as
``fmda_tpu.fleet.launcher`` defines it.

``launch_local_fleet`` builds the whole multi-host topology on one
machine for benches, tests, and demos, with each tier in its **own
process** (own GIL — a shared interpreter would serialize bus frame
handling behind the load driver and flatten the scaling the topology
exists to buy):

- the calling process runs the **router** and hosts the **control bus**
  behind a :class:`~fmda_tpu_torch.fleet.wire.BusServer` (membership +
  migrated state — low-rate traffic);
- N **worker** processes (``python -m fmda_tpu_torch serve-fleet --role
  worker``) build identical models from the shared seed (a seeded
  ``torch.Generator``: deterministic init), each with its own CUDA
  context on the card (``device``; ``"cpu"`` runs them without one),
  connect a SocketBus for control, and each host
  their OWN data-plane bus (inbox + results), announced in their
  heartbeats — the router links to every worker directly and the
  worker's serving hot loop never crosses a socket;
- the launcher blocks until membership is complete, so bootstrap joins
  never migrate anything.

The launcher is router-role code: no torch (the workers own the
device math in their own processes).  Each worker builds its kernels at
first use; the build renames its library into place atomically, so
workers that start cold together race safely.
"""

from __future__ import annotations

import logging
import os
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import replace as dc_replace
from typing import Dict, List, Optional, Sequence

from fmda_tpu_torch.config import (
    FleetTopologyConfig,
    FrameworkConfig,
    fleet_topics,
)
from fmda_tpu_torch.fleet.router import FleetRouter
from fmda_tpu_torch.fleet.wire import BusServer

log = logging.getLogger("fmda_tpu_torch.fleet")


def spawn_supported(python: str = sys.executable) -> bool:
    """Can this host spawn worker subprocesses at all?  (Restricted CI
    hosts sometimes cannot: ``serve-fleet --role local`` then reports
    ``skipped`` instead of erroring.)"""
    try:
        proc = subprocess.run(
            [python, "-c", "pass"], timeout=60,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        return proc.returncode == 0
    except Exception:  # noqa: BLE001 — loss-free: a capability probe; any failure means "no"
        return False


def _build_local_bus(config: FrameworkConfig, topics: Sequence[str]):
    """NativeBus when buildable (the C++ log is the production-shaped
    local broker), InProcessBus otherwise — same fallback contract as
    :func:`fmda_tpu_torch.app.default_bus`, with the fleet topics added and
    the arena sized for deep tick backlogs."""
    try:
        from fmda_tpu_torch.stream.native_bus import (
            NativeBus,
            native_available,
        )

        if native_available():
            return NativeBus(
                topics,
                arena_bytes=config.fleet.bus_arena_bytes,
                max_records=config.bus.capacity)
        log.warning("native bus unavailable; using InProcessBus")
    except Exception as e:  # noqa: BLE001 — loss-free: loud fallback to InProcessBus, never a failed startup
        log.warning("native bus unavailable (%s); using InProcessBus", e)
    from fmda_tpu_torch.stream.bus import InProcessBus

    return InProcessBus(topics, capacity=config.bus.capacity)


class LocalFleet:
    """A running local topology: workers spawned, router inline."""

    def __init__(
        self,
        *,
        router: FleetRouter,
        server,
        bus,
        procs: List[subprocess.Popen],
        worker_ids: List[str],
        log_dir: str,
        worker_argv: Optional[Dict[str, List[str]]] = None,
        repo_root: Optional[str] = None,
    ) -> None:
        self.router = router
        self.server = server
        self.bus = bus
        self.procs = procs
        self.worker_ids = worker_ids
        self.log_dir = log_dir
        #: exact spawn command per worker id — the chaos soak revives a
        #: killed worker by replaying it (a fresh incarnation: same id,
        #: fresh state, hellos its own way back into membership)
        self.worker_argv = worker_argv or {}
        self.repo_root = repo_root

    def proc_for(self, worker_id: str) -> Optional[subprocess.Popen]:
        try:
            return self.procs[self.worker_ids.index(worker_id)]
        except ValueError:  # loss-free: unknown id means "no process"
            return None

    def kill_worker(self, worker_id: str) -> bool:
        """SIGKILL one worker process — no drain, no goodbye: the
        silent-death failure the heartbeat timeout exists to catch
        (the chaos soak's ``kill worker:<id>`` events land here)."""
        proc = self.proc_for(worker_id)
        if proc is None or proc.poll() is not None:
            return False
        proc.kill()
        proc.wait(timeout=10.0)
        log.warning("chaos: killed worker %s (pid %d)",
                    worker_id, proc.pid)
        return True

    def add_worker(self) -> Optional[str]:
        """Spawn ONE MORE worker process into the running topology (the
        autoscaler's scale-up actuation) — a fresh id, the same argv
        template as the bootstrap workers.  Non-blocking: the new
        worker hellos its own way into membership exactly like any
        join, so the caller's ordinary pump loop sees it arrive (and no
        results are consumed waiting here).  Returns the new worker id,
        or None when the topology can't grow (no argv template)."""
        if not self.worker_ids or self.repo_root is None:
            return None
        template = self.worker_argv.get(self.worker_ids[0])
        if template is None or "--worker-id" not in template:
            return None
        m = re.match(r"^(.*?)(\d+)$", self.worker_ids[0])
        prefix = m.group(1) if m else self.worker_ids[0]
        used = set()
        for wid in self.worker_ids:
            m = re.match(re.escape(prefix) + r"(\d+)$", wid)
            if m:
                used.add(int(m.group(1)))
        idx = 0
        while idx in used:
            # never reuse an id: revive_worker owns the same-id path,
            # and a retired id's goodbye may still be settling
            idx += 1
        wid = f"{prefix}{idx}"
        argv = list(template)
        argv[argv.index("--worker-id") + 1] = wid
        proc = _spawn(
            argv, os.path.join(self.log_dir, f"{wid}.log"),
            self.repo_root)
        self.worker_ids.append(wid)
        self.procs.append(proc)
        self.worker_argv[wid] = argv
        log.info("scale-up: spawned worker %s (pid %d)", wid, proc.pid)
        return wid

    def revive_worker(self, worker_id: str) -> bool:
        """Spawn a fresh incarnation of a killed worker (same id, same
        argv).  It hellos on its own; the router treats it as any other
        join — rebalance, fresh bus at offset 0 (the hello purges any
        saved resume position)."""
        argv = self.worker_argv.get(worker_id)
        proc = self.proc_for(worker_id)
        if argv is None or self.repo_root is None:
            return False
        if proc is not None and proc.poll() is None:
            return False  # still alive — nothing to revive
        new = _spawn(
            argv,
            os.path.join(self.log_dir, f"{worker_id}.revived.log"),
            self.repo_root)
        self.procs[self.worker_ids.index(worker_id)] = new
        log.warning("chaos: revived worker %s (pid %d)",
                    worker_id, new.pid)
        return True

    def __enter__(self) -> "LocalFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def shutdown(
        self, *, graceful: bool = True, timeout_s: float = 30.0
    ) -> Dict[str, dict]:
        """Stop the topology; returns the final per-worker stats (off
        their goodbye heartbeats).  Stragglers are terminated, then
        killed — shutdown always completes."""
        try:
            self.router.stop_workers(graceful=graceful)
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                self.router.pump()
                if all(p.poll() is not None for p in self.procs):
                    break
                time.sleep(0.05)
        # loss-free: shutdown path — the finally below still reaps
        # every process, and final stats come from the router's view
        except ConnectionError:
            log.warning("bus connection lost during shutdown")
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.terminate()
            for p in self.procs:
                if p.poll() is None:
                    try:
                        p.wait(timeout=5.0)
                    # loss-free: escalation, not a swallow — the kill
                    # below reaps the process that ignored terminate()
                    except subprocess.TimeoutExpired:
                        p.kill()
            self.router.close()
            self.server.stop()
        return self.router.worker_stats()

    def worker_logs(self) -> Dict[str, str]:
        """Captured stdout+stderr per spawned process (post-mortem)."""
        out = {}
        for name in self.worker_ids:
            path = os.path.join(self.log_dir, f"{name}.log")
            try:
                with open(path) as fh:
                    out[name] = fh.read()
            except OSError:  # loss-free: post-mortem probe; no log is ""
                out[name] = ""
        return out


def _spawn(argv: List[str], log_path: str, repo_root: str):
    log_fh = open(log_path, "w")
    proc = subprocess.Popen(
        argv, stdout=log_fh, stderr=subprocess.STDOUT, cwd=repo_root)
    log_fh.close()  # the child holds its own descriptor
    return proc


def launch_local_fleet(
    *,
    n_workers: int,
    config: Optional[FrameworkConfig] = None,
    hidden: int = 32,
    seed: int = 0,
    capacity_per_worker: Optional[int] = None,
    bucket_sizes: Optional[Sequence[int]] = None,
    max_linger_ms: Optional[float] = None,
    window: Optional[int] = None,
    trace_dir: Optional[str] = None,
    device: Optional[str] = None,
    wait_timeout_s: float = 180.0,
    python: str = sys.executable,
    log_dir: Optional[str] = None,
    wrap_bus=None,
) -> LocalFleet:
    """Spawn the whole topology and block until every worker joined.

    Worker model/runtime knobs are passed on the command line so every
    process builds the identical serving stack; ``trace_dir`` enables
    tracing in every process with one ``--trace-out`` file per worker
    (merge with ``python -m fmda_tpu_torch trace --merge <trace_dir>``).
    ``device`` passes through as each worker's ``--device`` (None: the
    card, as every entry point defaults).  ``wrap_bus`` interposes on the
    router's bus handle only (the chaos soak's
    :class:`~fmda_tpu_torch.chaos.wrap.ChaosBus`).
    """
    config = config or FrameworkConfig()
    fleet_cfg: FleetTopologyConfig = dc_replace(
        config.fleet, n_workers=n_workers)
    worker_ids = [
        f"{fleet_cfg.worker_prefix}{i}" for i in range(n_workers)]
    log_dir = log_dir or tempfile.mkdtemp(prefix="fmda_fleet_")
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    # ship the WHOLE config to every worker process: topology knobs
    # (heartbeat cadence, grace windows — the chaos soak shortens them)
    # must match across the fleet, and CLI flags only cover the model/
    # batching subset
    from fmda_tpu_torch.config import save_config

    config_path = os.path.join(log_dir, "fleet_config.json")
    save_config(config, config_path)

    # the router's own bus: the control plane, plus shared-mode inbox/
    # results topics so --shared-bus workers (and tests) still work
    from fmda_tpu_torch.config import DEFAULT_TOPICS

    topics = tuple(DEFAULT_TOPICS) + fleet_topics(worker_ids)
    bus = _build_local_bus(config, topics)
    server = BusServer(bus, host=fleet_cfg.host, port=fleet_cfg.port,
                       wire_format=fleet_cfg.wire_format).start()
    address = server.address
    procs: List[subprocess.Popen] = []
    worker_argv: Dict[str, List[str]] = {}
    try:
        for wid in worker_ids:
            argv = [
                python, "-m", "fmda_tpu_torch", "serve-fleet",
                "--role", "worker",
                "--worker-id", wid,
                "--connect", address,
                "--hidden", str(hidden),
                "--seed", str(seed),
                "--config", config_path,
            ]
            if device is not None:
                argv += ["--device", str(device)]
            if capacity_per_worker is not None:
                argv += ["--sessions", str(capacity_per_worker)]
            if bucket_sizes is not None:
                argv += ["--bucket-sizes",
                         ",".join(str(b) for b in bucket_sizes)]
            if max_linger_ms is not None:
                argv += ["--max-linger-ms", str(max_linger_ms)]
            if window is not None:
                argv += ["--window", str(window)]
            if trace_dir:
                argv += ["--trace", "--trace-out",
                         os.path.join(trace_dir, f"{wid}.json")]
            worker_argv[wid] = argv
            procs.append(_spawn(
                argv, os.path.join(log_dir, f"{wid}.log"), repo_root))

        # `wrap_bus` wraps the ROUTER's handle only (the BusServer keeps
        # serving the raw bus to workers): control-plane faults hit the
        # router without perturbing the workers' transport
        router = FleetRouter(
            wrap_bus(bus) if wrap_bus is not None else bus,
            fleet_cfg, n_features=config.features.n_features)

        def _sleep_and_check(dt: float) -> None:
            time.sleep(dt)
            for p, wid in zip(procs, worker_ids):
                if p.poll() is not None:
                    tail = ""
                    try:
                        with open(os.path.join(
                                log_dir, f"{wid}.log")) as fh:
                            tail = fh.read()[-2000:]
                    # loss-free: the log tail is best-effort garnish —
                    # the RuntimeError below still raises either way
                    except OSError:
                        pass
                    raise RuntimeError(
                        f"worker {wid} exited rc={p.returncode} before "
                        f"joining; log tail:\n{tail}")

        router.wait_for_workers(
            n_workers, timeout_s=wait_timeout_s,
            sleep_fn=_sleep_and_check)
    except BaseException:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.stop()
        raise
    return LocalFleet(
        router=router, server=server, bus=bus, procs=procs,
        worker_ids=worker_ids, log_dir=log_dir,
        worker_argv=worker_argv, repo_root=repo_root)
