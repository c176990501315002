"""The chaos soak: the full local multi-host topology under a fault plan,
as ``fmda_tpu.chaos.soak`` defines it.

``run_chaos_soak`` launches the real spawned-worker topology
(:mod:`fmda_tpu_torch.fleet.launcher`), drives a loadgen mix (bursts +
slow-drip stragglers) through the router, and *executes the plan* while
the load runs:

- ``kill worker:<id>`` — SIGKILL the worker process (no drain, no
  goodbye), revive a fresh incarnation ``duration`` steps later;
- ``kill router`` — drop the router object and build a NEW one over the
  same bus (``from_end=True``), which must rebuild the session registry
  from worker session reports before the load continues — the failover
  path;
- ``kill/delay bus`` — the router's own control-bus handle fails/stalls
  (via :class:`~fmda_tpu_torch.chaos.wrap.ChaosBus`) while its data links
  keep serving;
- ``partition link:<id>`` / ``delay router.pump`` — the compiled-in
  injection points fire through the process-default runtime.

The report hard-gates the **never-abort contract**:

- the function returning at all is gate zero (``serve-fleet --role
  local --chaos-plan`` exits 0 iff every gate holds);
- ``unaccounted_zero``: every submitted tick is either served or sits
  in exactly one loss counter (``results_missing`` +
  ``migration_buffer_shed`` + ``inflight_dropped_on_close``) — counted
  degradation, no silent loss;
- ``post_chaos_all_served``: after the last fault window closes, every
  open session serves ticks again (nothing orphaned — fresh-reopened
  sessions included).  This is asserted with **probe ticks**: once the
  plan is spent, the soak waits for the topology to actually recover
  (every revived worker re-joined, every migration settled — the
  ``recovery_ok`` gate; wall-clock worker startup is allowed to outlast
  the plan's virtual steps) and then submits fresh ticks to every open
  session through the recovered fleet, so a revived worker must *serve*
  its migrated sessions, not merely import them;
- ``failover_ok``: each router takeover re-adopted every open session;
- with ``compare_unfaulted=True`` the same tick sequence runs through
  an unfaulted topology and every *clean* session (no state loss, no
  tick loss) must be **bit-identical** across the two runs — chaos may
  only ever degrade the sessions it actually touched.

Bucket size is pinned to 1 so flush composition cannot perturb the
kernels' reduction order — the identity gate compares raw float bytes
(the same discipline as the migration bit-identity test).  The soak's
router kills land at a drain boundary, so surviving sessions carry no
in-flight loss across the takeover.

**The recompile gate.**  The reference gates ``no_recompiles_after_warmup``
on the XLA compiles each worker counts after its warm-up (a program
traced for a shape the warm-up missed).  The port compiles nothing per
shape: ``nvcc`` builds every kernel once and each takes every bucket.
What stands for an untraced shape is a launch at a bucket the worker's
warm-up did not prime, so the gate reads each worker's
``kernel_launches_by_bucket`` (its heartbeat's counterpart of
``compile_count``, :mod:`fmda_tpu_torch.fleet.worker`) and counts the
launches at any bucket outside the soak's pinned set; the report keeps
the reference's key, ``recompiles_after_warmup``, for that count.

``device`` passes through to every worker (None: the card, and a worker
without one exits before it joins, naming ``device='cpu'``).

Router-role code: numpy + stdlib only, no torch (the workers own the
device math in their own processes).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np

from fmda_tpu_torch.chaos.inject import configure_chaos, default_chaos
from fmda_tpu_torch.chaos.plan import FaultPlan
from fmda_tpu_torch.chaos.wrap import ChaosBus
from fmda_tpu_torch.config import FrameworkConfig
from fmda_tpu_torch.fleet.router import FleetRouter

log = logging.getLogger("fmda_tpu_torch.chaos")


class _Norm(NamedTuple):
    # NormParams' attribute shape without the torch import chain
    # (fmda_tpu_torch.data's __init__ pulls the pipeline in): encode_norm
    # only reads .x_min / .x_max
    x_min: np.ndarray
    x_max: np.ndarray


#: public alias — the elastic soak (fmda_tpu_torch.control.elastic) opens
#: its sessions with the same torch-free stand-in
Norm = _Norm


#: Loss counters that REMOVE a tick from the router's in-flight table —
#: the accounting identity is submitted == served + the sum of these.
LOSS_COUNTERS = (
    "results_missing",
    "migration_buffer_shed",
    "inflight_dropped_on_close",
)

#: the soak's pinned flush bucket (see the module doc)
SOAK_BUCKETS = (1,)


def launches_off_warm_buckets(worker_stats: Dict[str, dict]) -> int:
    """Kernel launches the workers made at a bucket outside
    ``SOAK_BUCKETS``, off their stats' ``kernel_launches_by_bucket``: the
    port's count for the reference's ``recompiles_after_warmup`` (see the
    module doc)."""
    return sum(int(n) for stats in worker_stats.values()
               for b, n in (stats.get("kernel_launches_by_bucket")
                            or {}).items()
               if int(b) not in SOAK_BUCKETS)


def run_chaos_soak(
    plan: Optional[FaultPlan],
    *,
    n_workers: int = 2,
    n_sessions: int = 12,
    hidden: int = 8,
    seed: int = 0,
    window: int = 8,
    round_sleep_s: float = 0.05,
    duty: float = 0.7,
    slow_fraction: float = 0.25,
    slow_duty: float = 0.2,
    burst_every: int = 10,
    probe_rounds: int = 3,
    recover_timeout_s: float = 120.0,
    compare_unfaulted: bool = True,
    config: Optional[FrameworkConfig] = None,
    wait_timeout_s: float = 240.0,
    sleep_fn: Callable[[float], None] = time.sleep,
    device: Optional[str] = None,
) -> dict:
    """Run the soak; returns the gated report (see the module doc).

    ``plan=None`` runs the load shape with no faults.  With
    ``compare_unfaulted=True`` (and a non-empty plan) the same schedule
    replays through an unfaulted topology and the report carries the
    bit-identity verdict.
    """
    if plan is None:
        plan = FaultPlan(n_steps=30)
    config = _soak_config(config)
    telemetry = _soak_telemetry(config)
    kwargs = dict(
        config=config, n_workers=n_workers, n_sessions=n_sessions,
        hidden=hidden, seed=seed, window=window,
        round_sleep_s=round_sleep_s, duty=duty,
        slow_fraction=slow_fraction, slow_duty=slow_duty,
        burst_every=burst_every, probe_rounds=probe_rounds,
        recover_timeout_s=recover_timeout_s,
        wait_timeout_s=wait_timeout_s,
        sleep_fn=sleep_fn, device=device)
    try:
        faulted = _run_topology(plan, telemetry=telemetry, **kwargs)
    finally:
        if telemetry is not None:
            # detach from the chaos singleton NOW: the reference run
            # below (and any later soak in this process) must not fire
            # this run's recorder
            telemetry.close()
    report = _gate_report(plan, faulted)
    if telemetry is not None:
        fired = sum(1 for e in telemetry.events.tail()
                    if e.get("kind") == "slo.alert_fired")
        report["telemetry"] = {
            "alerts_firing": telemetry.slo.firing(),
            "alerts_fired_total": fired,
            "tsdb_series": len(telemetry.store.series()),
            "postmortems": (telemetry.recorder.bundles()
                            if telemetry.recorder is not None else []),
        }
    if compare_unfaulted and plan.events:
        # no telemetry on the reference run: its store/alerts would
        # overwrite the faulted run's evidence, and the identity gate
        # compares probabilities, not telemetry
        reference = _run_topology(FaultPlan(n_steps=plan.n_steps),
                                  telemetry=None, **kwargs)
        report["identity"] = _identity_verdict(faulted, reference)
        report["gates"]["identity_ok"] = report["identity"]["ok"]
    report["gates_ok"] = all(report["gates"].values())
    return report


def _soak_telemetry(config: FrameworkConfig):
    """Fleet telemetry for the soak: the time-series store,
    SLO burn-rate evaluation, and — when the ``[slo]`` section names a
    ``postmortem_dir`` — the flight recorder, all riding the soak's
    absorb loop (cadence-gated, off the submit path).  The soak's
    virtual steps are ~50 ms of wall clock, so the windows shrink to
    match: a fleet-scale 5 m/1 h posture would never see a soak-length
    breach."""
    if not config.slo.enabled:
        return None
    from fmda_tpu_torch.obs.aggregate import FleetTelemetry

    slo_cfg = dataclasses.replace(
        config.slo,
        interval_s=min(config.slo.interval_s, 0.25),
        scrape_interval_s=min(config.slo.scrape_interval_s, 1.0),
        fast_window_s=min(config.slo.fast_window_s, 3.0),
        slow_window_s=min(config.slo.slow_window_s, 12.0),
        postmortem_min_interval_s=min(
            config.slo.postmortem_min_interval_s, 5.0),
    )
    return FleetTelemetry(slo_cfg)


def _soak_config(config: Optional[FrameworkConfig]) -> FrameworkConfig:
    """The soak's topology posture: fast failure detection (the plan's
    virtual steps are ~50 ms), short result aging so lost ticks settle
    into ``results_missing`` inside the run, tight linger for bucket-1
    flushes."""
    config = config or FrameworkConfig()
    return dataclasses.replace(
        config,
        fleet=dataclasses.replace(
            config.fleet,
            heartbeat_interval_s=0.2,
            # 4s, not the 2s a 50ms-step plan would suggest: on a busy
            # (2-core CI) host a healthy worker's beat can stall past
            # 2s under pure scheduling contention, and a false reap
            # loses real carried state.  Kill detection latency is
            # absorbed by the post-plan recovery barrier, so the soak
            # gates no longer depend on the reap landing mid-loop.
            heartbeat_timeout_s=4.0,
            result_timeout_s=5.0,
            bus_error_grace_s=5.0,
            control_retry_s=0.3,
        ),
        runtime=dataclasses.replace(
            config.runtime, max_linger_ms=0.5),
    )


def _run_topology(
    plan: FaultPlan,
    *,
    telemetry=None,
    config: FrameworkConfig,
    n_workers: int,
    n_sessions: int,
    hidden: int,
    seed: int,
    window: int,
    round_sleep_s: float,
    duty: float,
    slow_fraction: float,
    slow_duty: float,
    burst_every: int,
    probe_rounds: int,
    recover_timeout_s: float,
    wait_timeout_s: float,
    sleep_fn: Callable[[float], None],
    device: Optional[str],
) -> dict:
    from fmda_tpu_torch.fleet.launcher import launch_local_fleet

    topo = launch_local_fleet(
        n_workers=n_workers, config=config, hidden=hidden, seed=seed,
        capacity_per_worker=max(4, n_sessions),
        bucket_sizes=SOAK_BUCKETS, window=window,
        wait_timeout_s=wait_timeout_s, device=device,
        wrap_bus=lambda bus: ChaosBus(bus, "bus"))
    # enable AFTER the launch: bootstrap must be fault-free (the plan's
    # settle window starts at step 0 of the LOAD, not of worker spawn)
    chaos = default_chaos()
    configure_chaos(enabled=bool(plan.events), plan=plan)
    router = topo.router
    takeovers: List[dict] = []
    #: loss/degradation counters accumulated across router incarnations
    #: — a takeover replaces the router object (fresh registry), but the
    #: dead incarnation's counted losses are still this run's losses
    counter_base: Dict[str, int] = {}
    tainted: set = set()
    seq_reused: set = set()
    killed_at: Dict[str, int] = {}
    #: non-empty while a router takeover could not reach the bus (an
    #: overlapping hand-written fault window) — retried step by step
    pending_takeover: List[int] = []
    rng = np.random.default_rng(seed)
    feats = config.features.n_features
    sids = [f"T{i:03d}" for i in range(n_sessions)]
    mins = rng.normal(0.0, 1.0, (n_sessions, feats)).astype(np.float32)
    maxs = mins + rng.uniform(1.0, 5.0, (n_sessions, feats)).astype(
        np.float32)
    walk = rng.normal(size=(n_sessions, feats)).astype(np.float32)
    per_duty = np.full(n_sessions, duty)
    n_slow = int(n_sessions * slow_fraction)
    if n_slow:
        per_duty[rng.choice(n_sessions, size=n_slow, replace=False)] = \
            slow_duty
    last_fault_step = max((e.step + e.duration for e in plan.events),
                          default=-1)
    #: wire seq -> submission index, per session (a takeover adopting a
    #: lossy session's lower seq counter REUSES wire seqs; the reuse is
    #: tracked and excludes the session from the identity set)
    seq_to_idx: Dict[str, Dict[int, int]] = {s: {} for s in sids}
    results: Dict[str, Dict[int, np.ndarray]] = {s: {} for s in sids}
    post_served: Dict[str, int] = {s: 0 for s in sids}
    submitted: Dict[str, int] = {s: 0 for s in sids}
    submit_failures: Dict[str, int] = {}
    unexpected = 0
    try:
        for i, sid in enumerate(sids):
            router.open_session(sid, _Norm(mins[i], maxs[i]))

        def absorb_results(batch, step: int) -> None:
            nonlocal unexpected
            for res in batch:
                idx = seq_to_idx.get(res.session_id, {}).get(res.seq)
                if idx is None or idx in results[res.session_id]:
                    unexpected += 1
                    continue
                results[res.session_id][idx] = np.asarray(
                    res.probabilities, np.float32)
                if step > last_fault_step:
                    post_served[res.session_id] += 1

        def absorb(step: int) -> None:
            absorb_results(router.pump(), step)
            if telemetry is not None:
                # cadence-gated fold into the tsdb + SLO evaluation —
                # one clock read when not due; follows router takeovers
                # because the closure reads the loop's live binding
                telemetry.maybe_collect(router)

        def submit_tick(i: int, step: int) -> None:
            sid = sids[i]
            waited = 0.0
            while router.saturated and waited < 5.0:
                absorb(step)
                sleep_fn(0.002)
                waited += 0.002
            try:
                seq = router.submit(sid, walk[i])
            except KeyError:
                # a session a takeover failed to adopt: the failover_ok
                # gate already records the miss — the soak must carry
                # that verdict in its report, not die on a traceback
                submit_failures[sid] = submit_failures.get(sid, 0) + 1
                tainted.add(sid)
                return
            if seq in seq_to_idx[sid]:
                seq_reused.add(sid)
            seq_to_idx[sid][seq] = submitted[sid]
            submitted[sid] += 1

        for step in range(plan.n_steps):
            chaos.advance(step)
            router = _apply_process_events(
                plan, step, topo, router, config, tainted, killed_at,
                takeovers, counter_base, sleep_fn,
                on_results=lambda rs, s=step: absorb_results(rs, s),
                pending_takeover=pending_takeover)
            _revive_due(plan, step, topo, killed_at)
            ticking = rng.random(n_sessions) < per_duty
            if burst_every and step and step % burst_every == 0:
                ticking[:] = True  # market-open spike
            deltas = rng.normal(
                scale=0.1, size=(n_sessions, feats)).astype(np.float32)
            walk[ticking] += deltas[ticking]
            for i in np.flatnonzero(ticking):
                submit_tick(int(i), step)
            absorb(step)
            sleep_fn(round_sleep_s)
        # the plan is spent: advance the injection runtime past every
        # window (a window reaching the final step must not stay open
        # into recovery) and fire any revive the virtual schedule still
        # owes — wall-clock worker startup (torch import + warm-up) is
        # allowed to outlast the plan's steps
        probe_step = max(plan.n_steps, last_fault_step + 1)
        chaos.advance(probe_step)
        _revive_due(plan, probe_step, topo, killed_at)
        if pending_takeover:
            # a takeover that stayed blocked to the end of the plan:
            # every window is past the probe step, so this attempt can
            # only fail if the bus is genuinely gone — in which case the
            # recovery gate fails loudly on the old incarnation
            router = _apply_process_events(
                FaultPlan(n_steps=probe_step), probe_step, topo, router,
                config, tainted, killed_at, takeovers, counter_base,
                sleep_fn,
                on_results=lambda rs: absorb_results(rs, probe_step),
                pending_takeover=pending_takeover)
        recovery = _await_recovery(
            router, n_workers, absorb, probe_step, sleep_fn,
            timeout_s=recover_timeout_s, skip=not plan.events)
        # post-chaos probes: the ``post_chaos_all_served`` gate's ground
        # truth.  Every open session gets ``probe_rounds`` fresh ticks
        # THROUGH the recovered topology — a revived worker must serve
        # its migrated sessions for real, not merely import them.  The
        # unfaulted reference replays the identical schedule (same rng
        # stream), so the bit-identity comparison covers the probes too.
        for _ in range(probe_rounds):
            deltas = rng.normal(
                scale=0.1, size=(n_sessions, feats)).astype(np.float32)
            walk += deltas
            for i in range(n_sessions):
                submit_tick(i, probe_step)
            absorb(probe_step)
            sleep_fn(round_sleep_s)
        # settle: everything in flight answers or ages into a counter
        deadline = time.monotonic() + 30.0
        while router.outstanding_ticks and time.monotonic() < deadline:
            absorb(probe_step)
            sleep_fn(0.01)
        open_sessions = len(router.open_session_ids())
        # observation-based taint: every session whose carried state was
        # actually lost (fresh reopen — planned kill OR a false reap on
        # a stalled host) is excluded from the bit-identity set.  The
        # router, not the plan, is the authority on what got hurt.
        tainted |= router.lost_state_sessions
        counters = dict(counter_base)
        for k, v in router.metrics.counters.items():
            counters[k] = counters.get(k, 0) + v
    finally:
        configure_chaos(enabled=False)
        topo.router = router  # shutdown must stop through the live one
        try:
            worker_stats = topo.shutdown()
        except Exception:  # noqa: BLE001 — loss-free: a teardown
            # failure must not mask the run's own verdict (or its
            # exception); the gates already have their evidence
            log.exception("soak teardown failed")
            worker_stats = {}
    return {
        "plan": plan.summary(),
        "n_steps": plan.n_steps,
        "sessions": sids,
        "submitted": submitted,
        "submit_failures": submit_failures,
        "results": results,
        "post_served": post_served,
        "unexpected_results": unexpected,
        "seq_reused": sorted(seq_reused),
        "counters": counters,
        "chaos_injected": chaos.summary(),
        "worker_stats": worker_stats,
        "takeovers": takeovers,
        "tainted": sorted(tainted),
        "last_fault_step": last_fault_step,
        "open_sessions": open_sessions,
        "recovery": recovery,
        "probe_rounds": probe_rounds,
    }


def _await_recovery(
    router: FleetRouter,
    n_workers: int,
    absorb: Callable[[int], None],
    step: int,
    sleep_fn: Callable[[float], None],
    *,
    timeout_s: float,
    skip: bool,
) -> dict:
    """The post-chaos recovery barrier: before the probe phase may judge
    serving, every revived worker must re-join (membership back to full
    strength), every migration must settle, and every in-flight tick
    must answer or age into a counter.  Bounded by ``timeout_s`` of wall
    clock — worker restart cost (torch import + warm-up) is the budget
    here, not the plan's virtual steps — and a fleet that cannot recover
    inside it fails the ``recovery_ok`` gate loudly."""
    t0 = time.monotonic()
    deadline = t0 + timeout_s
    if not skip:
        while time.monotonic() < deadline:
            absorb(step)
            if (len(router.membership) >= n_workers
                    and not router.migrating_sessions
                    and not router.outstanding_ticks):
                break
            sleep_fn(0.05)
    return {
        "workers_live": len(router.membership),
        "migrating_sessions": router.migrating_sessions,
        "outstanding_ticks": router.outstanding_ticks,
        "recovery_s": round(time.monotonic() - t0, 3),
        "ok": (len(router.membership) >= n_workers
               and not router.migrating_sessions),
    }


def _apply_process_events(
    plan, step, topo, router, config, tainted, killed_at, takeovers,
    counter_base, sleep_fn, on_results, pending_takeover,
) -> FleetRouter:
    """Execute the orchestrated (process-level) events opening at this
    step (plus any takeover still pending from an earlier step); returns
    the (possibly replaced) router."""
    want_takeover = bool(pending_takeover)
    for event in plan.starting(step):
        if event.kind != "kill":
            continue
        target = event.target
        if target.startswith("worker:"):
            wid = target.split(":", 1)[1]
            # sessions on the victim lose carried state by definition —
            # excluded from the bit-identity set, still gated on
            # post-chaos serving
            for sid in router.open_session_ids():
                if router._sessions[sid].owner == wid:
                    tainted.add(sid)
            if topo.kill_worker(wid):
                killed_at[wid] = step
        elif target == "router":
            want_takeover = True
    if want_takeover:
        new = _router_takeover(
            topo, router, config, takeovers, counter_base, tainted,
            step, sleep_fn, on_results)
        if new is None:
            # the control bus is itself inside a fault window at this
            # step (possible only in hand-written overlapping plans —
            # generated plans keep windows disjoint): the old
            # incarnation keeps routing and the takeover retries once
            # the window state is re-evaluated at the next step
            pending_takeover[:] = [step]
        else:
            pending_takeover.clear()
            router = new
            topo.router = router
    return router


def _revive_due(plan, step, topo, killed_at) -> None:
    for wid, at in list(killed_at.items()):
        for event in plan.for_target(f"worker:{wid}"):
            if event.kind == "kill" and event.step == at \
                    and step >= at + event.duration:
                topo.revive_worker(wid)
                del killed_at[wid]
                break


def _router_takeover(
    topo, old: FleetRouter, config: FrameworkConfig, takeovers,
    counter_base, tainted, step, sleep_fn, on_results,
) -> Optional[FleetRouter]:
    """Kill the router object and fail over to a fresh one on the same
    bus: the new router re-learns membership from heartbeats and
    rebuilds the session registry from worker session reports — no
    session may be orphaned.  Returns ``None`` (old router untouched)
    when the replacement cannot even reach the bus — an injected bus
    fault active at this very step; the caller retries at a later one."""
    expected = len(old.open_session_ids())
    # results landing during the handoff drain are still served ticks —
    # the accounting identity must see them
    on_results(old.drain(timeout_s=20.0))
    try:
        new = FleetRouter(
            ChaosBus(topo.bus, "bus"),
            dataclasses.replace(
                config.fleet, n_workers=old.cfg.n_workers),
            n_features=old.n_features,
            from_end=True,
        )
    # loss-free: the takeover retries next step; nothing is dropped
    except (ConnectionError, OSError) as e:
        log.warning(
            "chaos: router takeover at step %d blocked by an active "
            "bus fault (%s) — retrying next step", step, e)
        return None
    # the dying incarnation's counted losses stay this run's losses,
    # and the sessions it saw lose state stay tainted
    for k, v in old.metrics.counters.items():
        counter_base[k] = counter_base.get(k, 0) + v
    tainted |= old.lost_state_sessions
    old.close()  # links dropped; the old incarnation is gone
    deadline = time.monotonic() + 30.0
    while len(new.open_session_ids()) < expected \
            and time.monotonic() < deadline:
        new.pump()
        sleep_fn(0.02)
    adopted = len(new.open_session_ids())
    takeovers.append({
        "step": step,
        "sessions_before": expected,
        "sessions_adopted": adopted,
        "rebuilt_in_time": adopted >= expected,
    })
    log.warning(
        "chaos: router takeover at step %d — %d/%d sessions adopted",
        step, adopted, expected)
    return new


def _gate_report(plan: FaultPlan, run: dict) -> dict:
    counters = run["counters"]
    n_submitted = sum(run["submitted"].values())
    n_served = sum(len(v) for v in run["results"].values())
    losses = sum(counters.get(k, 0) for k in LOSS_COUNTERS)
    unaccounted = n_submitted - n_served - losses
    post_quiet = [sid for sid, n in run["post_served"].items() if n == 0]
    failover_ok = all(t["rebuilt_in_time"] for t in run["takeovers"])
    # the warm-up contract, checked under fire: chaos may kill workers
    # and migrate sessions, but no worker may ever launch at a bucket its
    # warm-up did not prime (the module doc: what stands for the
    # reference's recompile count)
    recompiles = launches_off_warm_buckets(run["worker_stats"])
    gates = {
        "exit_ok": True,  # reaching here at all is gate zero
        "unaccounted_zero": unaccounted == 0,
        "no_unexpected_results": run["unexpected_results"] == 0,
        "post_chaos_all_served": not post_quiet,
        "failover_ok": failover_ok,
        "recovery_ok": run["recovery"]["ok"],
        "no_recompiles_after_warmup": recompiles == 0,
    }
    return {
        "plan": run["plan"],
        "chaos_injected": run["chaos_injected"],
        "ticks_submitted": n_submitted,
        "ticks_served": n_served,
        "losses": {k: counters.get(k, 0) for k in LOSS_COUNTERS
                   if counters.get(k, 0)},
        "unaccounted": unaccounted,
        "degradation_counters": {
            k: v for k, v in sorted(counters.items())
            if v and k not in ("routed_ticks", "results_received")
        },
        "post_chaos_quiet_sessions": post_quiet,
        "submit_failures": run["submit_failures"],
        "recovery": run["recovery"],
        "probe_rounds": run["probe_rounds"],
        "takeovers": run["takeovers"],
        "tainted_sessions": run["tainted"],
        "worker_stats": run["worker_stats"],
        "recompiles_after_warmup": recompiles,
        "gates": gates,
    }


def _identity_verdict(faulted: dict, reference: dict) -> dict:
    """Compare the faulted run's *clean* sessions against the unfaulted
    reference, bit for bit.  Clean = carried state never lost (in
    EITHER run — a falsely-reaped worker on a stalled host loses state
    just as really as a planned kill), no wire-seq reuse, and a gapless
    result stream (every submission answered) — chaos may only ever
    perturb the sessions it actually touched, and at least one session
    must come through untouched."""
    clean: List[str] = []
    divergent: List[str] = []
    excluded: List[str] = []
    for sid in faulted["sessions"]:
        n = faulted["submitted"][sid]
        if (sid in faulted["tainted"] or sid in faulted["seq_reused"]
                or sid in reference["tainted"]
                or sid in reference["seq_reused"]):
            excluded.append(sid)  # lossy: already counted, not compared
            continue
        if n != reference["submitted"][sid]:
            # an untainted session must replay the same schedule — a
            # mismatch here is a soak-harness bug, surfaced loudly
            divergent.append(sid)
            continue
        if (len(faulted["results"][sid]) != n
                or len(reference["results"][sid]) != n):
            excluded.append(sid)  # result gap: counted, not compared
            continue
        same = all(
            np.array_equal(faulted["results"][sid][q],
                           reference["results"][sid][q])
            for q in range(n)
        )
        (clean if same else divergent).append(sid)
    return {
        "clean_sessions": len(clean),
        "excluded_sessions": excluded,
        "divergent_sessions": divergent,
        "ok": bool(clean) and not divergent,
    }
