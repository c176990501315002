"""The elastic soak: a market-open spike through the autoscaler, gated,
as ``fmda_tpu.control.elastic`` defines it.

``run_elastic_soak`` launches the real spawned-worker topology at
``min_workers``, runs a three-phase load — calm warmup, market-open
spike (every session ticking in bursts), cool-down — with the
:class:`~fmda_tpu_torch.control.plane.ControlPlane`'s autoscaler live: the
spike's latency burn must spawn a worker (sessions rebalance onto it
via live migration), and the cool-down's idle must retire it again
through :meth:`FleetRouter.request_leave` — the drain → export →
replay migration, so the scale-down loses zero sessions and zero
ticks.  The report hard-gates the chaos soak's never-abort contract on
the way:

- ``exit_ok`` / ``unaccounted_zero`` / ``no_unexpected_results`` —
  the accounting identity (submitted == served + counted losses) holds
  through both scaling moves;
- ``scaled_up`` / ``scaled_down`` — the loop actually moved, both
  directions, and the fleet ended back at ``min_workers``;
- ``zero_session_loss`` — no session lost carried state to either
  migration wave;
- ``post_scale_all_served`` — after the scale-down, probe ticks to
  every session are served by the shrunk fleet (migrated-back sessions
  serve for real, not merely import);
- with ``compare_fixed=True`` the identical seeded schedule replays
  through a fixed ``min_workers`` fleet and every clean session must be
  **bit-identical** — elasticity may move sessions, never change them.
  Bucket size is pinned to 1 (flush composition must not perturb the
  kernels' reduction order), exactly the chaos soak's discipline.
- ``no_recompiles_after_warmup`` — no worker launched a kernel at a
  bucket its warm-up did not prime: the port compiles nothing per
  shape, so this reads each worker's ``kernel_launches_by_bucket``
  where the reference reads its XLA recompile count
  (:func:`~fmda_tpu_torch.chaos.soak.launches_off_warm_buckets`, whose
  module doc says why).

The latency target is *calibrated*, not configured: the warmup phase
measures this host's baseline p99 and the objective is set a fixed
multiple above it, so the spike burns budget and the cool-down clears
it on fast and slow hosts alike.  ``device`` passes through to every
worker (None: the card).  Router-role code: numpy + stdlib, no torch (the
workers own the device math in their processes).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, Optional

import numpy as np

from fmda_tpu_torch.chaos.soak import (
    LOSS_COUNTERS,
    SOAK_BUCKETS,
    Norm,
    _identity_verdict,
    launches_off_warm_buckets,
)
from fmda_tpu_torch.config import FrameworkConfig
from fmda_tpu_torch.control.autoscale import LocalFleetActuator
from fmda_tpu_torch.control.plane import ControlPlane
from fmda_tpu_torch.obs.slo import SERIES_E2E

log = logging.getLogger("fmda_tpu_torch.control")

#: tenant labels cycled over the soak's sessions — QoS stays detached
#: here (no policy at the workers), but every label must survive open →
#: migrate → report → readopt verbatim (the report asserts it)
SOAK_TENANTS = ("gold", "standard", "bronze")


def run_elastic_soak(
    *,
    n_sessions: int = 8,
    hidden: int = 8,
    seed: int = 0,
    window: int = 8,
    min_workers: int = 1,
    max_workers: int = 2,
    warmup_rounds: int = 30,
    base_duty: float = 0.2,
    spike_batch: int = 4,
    spike_timeout_s: float = 90.0,
    drop_timeout_s: float = 120.0,
    probe_rounds: int = 3,
    target_mult: float = 4.0,
    compare_fixed: bool = True,
    config: Optional[FrameworkConfig] = None,
    wait_timeout_s: float = 240.0,
    sleep_fn: Callable[[float], None] = time.sleep,
    device: Optional[str] = None,
) -> dict:
    """Run the soak; returns the gated report (see the module doc).

    The spike and cool phases are wall-clock-bounded (worker spawn cost
    is real), but every round's rng consumption is schedule-pure — the
    adaptive run records its actual round counts and the fixed
    reference replays them exactly, so the bit-identity comparison sees
    two runs of one schedule."""
    config = _elastic_config(config)
    adaptive = _run_topology(
        None, elastic=True, config=config, n_sessions=n_sessions,
        hidden=hidden, seed=seed, window=window,
        min_workers=min_workers, max_workers=max_workers,
        warmup_rounds=warmup_rounds, base_duty=base_duty,
        spike_batch=spike_batch, spike_timeout_s=spike_timeout_s,
        drop_timeout_s=drop_timeout_s, probe_rounds=probe_rounds,
        target_mult=target_mult, wait_timeout_s=wait_timeout_s,
        sleep_fn=sleep_fn, device=device)
    report = _gate_report(adaptive, min_workers)
    if compare_fixed:
        reference = _run_topology(
            adaptive["schedule"], elastic=False, config=config,
            n_sessions=n_sessions, hidden=hidden, seed=seed,
            window=window, min_workers=min_workers,
            max_workers=max_workers, warmup_rounds=warmup_rounds,
            base_duty=base_duty, spike_batch=spike_batch,
            spike_timeout_s=spike_timeout_s,
            drop_timeout_s=drop_timeout_s, probe_rounds=probe_rounds,
            target_mult=target_mult, wait_timeout_s=wait_timeout_s,
            sleep_fn=sleep_fn, device=device)
        report["identity"] = _identity_verdict(adaptive, reference)
        report["gates"]["identity_ok"] = report["identity"]["ok"]
    report["gates_ok"] = all(report["gates"].values())
    return report


def _elastic_config(config: Optional[FrameworkConfig]) -> FrameworkConfig:
    """The soak posture: fast failure detection, tight linger (bucket-1
    flushes), generous queue bound (the spike is a latency test, not a
    shed test — sheds would break the router-side accounting identity)."""
    config = config or FrameworkConfig()
    return dataclasses.replace(
        config,
        fleet=dataclasses.replace(
            config.fleet,
            heartbeat_interval_s=0.2,
            heartbeat_timeout_s=5.0,
            result_timeout_s=10.0,
            control_retry_s=0.3,
        ),
        runtime=dataclasses.replace(
            config.runtime, max_linger_ms=0.5, queue_bound=4096),
        slo=dataclasses.replace(
            config.slo,
            interval_s=min(config.slo.interval_s, 0.25),
            scrape_interval_s=min(config.slo.scrape_interval_s, 1.0),
            fast_window_s=min(config.slo.fast_window_s, 2.0),
            slow_window_s=min(config.slo.slow_window_s, 8.0),
        ),
    )


def _run_topology(
    schedule: Optional[Dict[str, int]],
    *,
    elastic: bool,
    config: FrameworkConfig,
    n_sessions: int,
    hidden: int,
    seed: int,
    window: int,
    min_workers: int,
    max_workers: int,
    warmup_rounds: int,
    base_duty: float,
    spike_batch: int,
    spike_timeout_s: float,
    drop_timeout_s: float,
    probe_rounds: int,
    target_mult: float,
    wait_timeout_s: float,
    sleep_fn: Callable[[float], None],
    device: Optional[str],
) -> dict:
    from fmda_tpu_torch.fleet.launcher import launch_local_fleet
    from fmda_tpu_torch.obs.aggregate import FleetTelemetry

    telemetry = FleetTelemetry(config.slo) if elastic else None
    topo = launch_local_fleet(
        n_workers=min_workers, config=config, hidden=hidden, seed=seed,
        capacity_per_worker=max(4, n_sessions),
        bucket_sizes=SOAK_BUCKETS, window=window,
        wait_timeout_s=wait_timeout_s, device=device)
    router = topo.router
    plane: Optional[ControlPlane] = None
    rng = np.random.default_rng(seed)
    feats = config.features.n_features
    sids = [f"E{i:03d}" for i in range(n_sessions)]
    tenants = {sid: SOAK_TENANTS[i % len(SOAK_TENANTS)]
               for i, sid in enumerate(sids)}
    mins = rng.normal(0.0, 1.0, (n_sessions, feats)).astype(np.float32)
    maxs = mins + rng.uniform(1.0, 5.0, (n_sessions, feats)).astype(
        np.float32)
    walk = rng.normal(size=(n_sessions, feats)).astype(np.float32)
    seq_to_idx: Dict[str, Dict[int, int]] = {s: {} for s in sids}
    results: Dict[str, Dict[int, np.ndarray]] = {s: {} for s in sids}
    submitted: Dict[str, int] = {s: 0 for s in sids}
    post_served: Dict[str, int] = {s: 0 for s in sids}
    submit_failures: Dict[str, int] = {}
    unexpected = 0
    max_live = min_workers
    counting_probes = False
    ran: Dict[str, int] = {}
    target_p99_ms = None
    try:
        for i, sid in enumerate(sids):
            router.open_session(sid, Norm(mins[i], maxs[i]),
                                tenant=tenants[sid])

        def absorb() -> None:
            nonlocal unexpected, max_live
            for res in router.pump():
                idx = seq_to_idx.get(res.session_id, {}).get(res.seq)
                if idx is None or idx in results[res.session_id]:
                    unexpected += 1
                    continue
                results[res.session_id][idx] = np.asarray(
                    res.probabilities, np.float32)
                if counting_probes:
                    post_served[res.session_id] += 1
            max_live = max(max_live, len(router.membership.live()))
            if telemetry is not None:
                telemetry.maybe_collect(router)
            if plane is not None:
                plane.maybe_tick()

        def submit_tick(i: int) -> None:
            sid = sids[i]
            waited = 0.0
            while router.saturated and waited < 5.0:
                absorb()
                sleep_fn(0.002)
                waited += 0.002
            try:
                seq = router.submit(sid, walk[i])
            except KeyError:
                submit_failures[sid] = submit_failures.get(sid, 0) + 1
                return
            seq_to_idx[sid][seq] = submitted[sid]
            submitted[sid] += 1

        def do_round(reps: int, duty: float, pace_s: float) -> None:
            # rng consumption is a pure function of (reps, duty) — the
            # reference run replays the identical stream per round
            ticking = rng.random(n_sessions) < duty
            for _ in range(reps):
                deltas = rng.normal(
                    scale=0.1, size=(n_sessions, feats)).astype(
                        np.float32)
                walk[ticking] += deltas[ticking]
                for i in np.flatnonzero(ticking):
                    submit_tick(int(i))
            absorb()
            if pace_s:
                sleep_fn(pace_s)

        # -- warmup: measure this host's baseline p99 -------------------
        for _ in range(warmup_rounds):
            do_round(1, base_duty, 0.02)
        ran["warmup"] = warmup_rounds
        # calibration must read a POPULATED window: the scrape cadence
        # lags the first rounds, and a target derived from an empty
        # histogram would sit far under the pacing-dominated baseline —
        # burn would pin at max and the fleet could never look idle
        # again.  Extra rounds are schedule-pure (the reference replays
        # the recorded count); only the elastic run decides when to stop.
        cal = 0
        budget = schedule["calibrate"] if schedule is not None else None
        deadline = time.monotonic() + 20.0
        while True:
            if budget is not None:
                if cal >= budget:
                    break
            else:
                hist = telemetry.store.window_histogram(
                    SERIES_E2E, window_s=config.slo.slow_window_s,
                    now=telemetry.clock())
                if hist.n >= 20 or time.monotonic() > deadline:
                    break
            do_round(1, base_duty, 0.02)
            cal += 1
        ran["calibrate"] = cal
        if elastic:
            hist = telemetry.store.window_histogram(
                SERIES_E2E, window_s=config.slo.slow_window_s,
                now=telemetry.clock())
            base_ms = hist.percentile(99) * 1e3 if hist.n else 1.0
            target_p99_ms = min(max(target_mult * base_ms, 2.0), 200.0)
            ctrl_cfg = dataclasses.replace(
                config.control,
                batching=False, autoscale=True,
                target_p99_ms=target_p99_ms,
                interval_s=0.25,
                min_workers=min_workers, max_workers=max_workers,
                scale_up_burn=2.0, up_sustain_s=0.75,
                scale_down_frac=0.5, down_sustain_s=2.0,
                cooldown_s=1.5)
            plane = ControlPlane(
                ctrl_cfg, telemetry=telemetry, router=router,
                actuator=LocalFleetActuator(topo),
                slo_cfg=dataclasses.replace(
                    config.slo, latency_p99_ms=target_p99_ms))
            # the SLO engine judges burn against the calibrated target
            telemetry.slo.cfg = dataclasses.replace(
                telemetry.slo.cfg, latency_p99_ms=target_p99_ms)

        # -- market-open spike: every session, spike_batch deep ---------
        spike = 0
        deadline = time.monotonic() + spike_timeout_s
        budget = schedule["spike"] if schedule is not None else None
        while True:
            if budget is not None:
                if spike >= budget:
                    break
            elif (len(router.membership.live()) > min_workers
                  or time.monotonic() > deadline):
                break
            do_round(spike_batch, 1.0, 0.0)
            spike += 1
        ran["spike"] = spike

        # -- cool-down: idle until the fleet shrinks back ---------------
        cool = 0
        deadline = time.monotonic() + drop_timeout_s
        budget = schedule["cool"] if schedule is not None else None
        while True:
            if budget is not None:
                if cool >= budget:
                    break
            elif (len(router.membership.live()) <= min_workers
                  and cool >= 10) or time.monotonic() > deadline:
                break
            do_round(1, base_duty, 0.03)
            cool += 1
        ran["cool"] = cool

        # -- settle + probes through the (shrunk) fleet ------------------
        settle_deadline = time.monotonic() + 30.0
        while router.outstanding_ticks \
                and time.monotonic() < settle_deadline:
            absorb()
            sleep_fn(0.01)
        counting_probes = True
        for _ in range(probe_rounds):
            do_round(1, 1.01, 0.02)  # duty > 1: every session probes
        ran["probes"] = probe_rounds
        settle_deadline = time.monotonic() + 30.0
        while router.outstanding_ticks \
                and time.monotonic() < settle_deadline:
            absorb()
            sleep_fn(0.01)
        tainted = set(router.lost_state_sessions)
        tenant_intact = all(
            router.session_tenant(sid) == tenants[sid] for sid in sids
            if sid in router.open_session_ids())
        counters = dict(router.metrics.counters)
        worker_stats = dict(router.worker_stats())
        final_live = len(router.membership.live())
        decisions = list(plane.decisions) if plane is not None else []
    finally:
        try:
            topo.shutdown()
        except Exception:  # noqa: BLE001 — loss-free: teardown failure
            # must not mask the run's own verdict; gates have evidence
            log.exception("elastic soak teardown failed")
    return {
        "schedule": ran,
        "sessions": sids,
        "submitted": submitted,
        "submit_failures": submit_failures,
        "results": results,
        "post_served": post_served,
        "unexpected_results": unexpected,
        "seq_reused": [],  # no takeover path: wire seqs never reused
        "counters": counters,
        "worker_stats": worker_stats,
        "tainted": sorted(tainted),
        "tenant_intact": tenant_intact,
        "target_p99_ms": target_p99_ms,
        "max_live": max_live,
        "final_live": final_live,
        "decisions": decisions,
    }


def _gate_report(run: dict, min_workers: int) -> dict:
    counters = run["counters"]
    n_submitted = sum(run["submitted"].values())
    n_served = sum(len(v) for v in run["results"].values())
    losses = sum(counters.get(k, 0) for k in LOSS_COUNTERS)
    unaccounted = n_submitted - n_served - losses
    post_quiet = [s for s, n in run["post_served"].items() if n == 0]
    actions = [d["action"] for d in run["decisions"]]
    # elastic scaling must never step outside the warmed buckets:
    # migrated-in sessions land on the buckets every worker primed (the
    # module doc: what stands for the reference's recompile count)
    recompiles = launches_off_warm_buckets(run["worker_stats"])
    gates = {
        "exit_ok": True,  # reaching here at all is gate zero
        "unaccounted_zero": unaccounted == 0,
        "no_unexpected_results": run["unexpected_results"] == 0,
        "no_recompiles_after_warmup": recompiles == 0,
        "scaled_up": ("scale_up" in actions
                      and run["max_live"] > min_workers),
        "scaled_down": ("scale_down" in actions
                        and run["final_live"] == min_workers),
        "zero_session_loss": (
            not run["tainted"]
            and counters.get("sessions_lost_state", 0) == 0
            and run["tenant_intact"]),
        "post_scale_all_served": not post_quiet,
    }
    return {
        "schedule": run["schedule"],
        "ticks_submitted": n_submitted,
        "ticks_served": n_served,
        "losses": {k: counters.get(k, 0) for k in LOSS_COUNTERS
                   if counters.get(k, 0)},
        "unaccounted": unaccounted,
        "target_p99_ms": run["target_p99_ms"],
        "max_live": run["max_live"],
        "final_live": run["final_live"],
        "decisions": run["decisions"],
        "post_scale_quiet_sessions": post_quiet,
        "submit_failures": run["submit_failures"],
        "recompiles_after_warmup": recompiles,
        # the workers' stats (departed ones' off their goodbyes), as the
        # chaos soak's report carries them: where each worker's kernel
        # launches by kernel and by bucket are read
        "worker_stats": run["worker_stats"],
        "gates": gates,
    }
