"""The cadence-paced live loop: replay's A/B baseline, as
``fmda_tpu.replay.reference`` runs it.

It serves the same history source through the same gateway surface as
:class:`~fmda_tpu_torch.replay.driver.ReplayDriver`, but as a live feed
would: a round arrives on a wall-clock cadence, rows are submitted one
tick at a time (no block coalescing), and a forced flush ends each round.
Replay must beat it by a wide margin (the cadence is what replay
deletes), and with a lockstep (``duty=1.0``) source the two publish the
same probabilities byte for byte: the flushes hold the same rows, so the
float32 reductions run in the same order.  This is the one module of
:mod:`fmda_tpu_torch.replay` that paces by the host clock, on purpose.
"""

from __future__ import annotations

import time
from typing import Dict, List

from fmda_tpu_torch.replay.driver import open_replay_sessions
from fmda_tpu_torch.runtime.loadgen import launches_by_bucket


def run_live_reference(
    gateway,
    source,
    *,
    cadence_s: float = 0.0,
    tenant_classes: tuple = (),
    tenant_weights: tuple = (),
    seed: int = 0,
    collect: bool = False,
) -> Dict:
    """Serve ``source`` live-style: one round per ``cadence_s`` of wall
    time (0 = as fast as per-tick submission goes — still slower than
    replay's coalesced blocks), forced flush per round so composition
    matches replay's round-per-flush and bit-identity holds.  Returns
    the run summary; with ``collect`` the per-tick results ride on the
    ``"results"`` key."""
    session_ids = open_replay_sessions(
        gateway, source, tenant_classes=tenant_classes,
        tenant_weights=tenant_weights, seed=seed)
    results: List = []

    def keep(batch) -> int:
        if collect and batch:
            results.extend(batch)
        return len(batch)

    submitted = 0
    served = 0
    rounds = 0
    # lint: ignore[virtual-clock] live reference loop — wall-clock pacing IS the baseline being measured
    t0 = time.perf_counter()
    next_due = t0
    for batch in source:
        if cadence_s > 0.0:
            # lint: ignore[virtual-clock] live reference loop — paces rounds at the live cadence
            now = time.perf_counter()
            if now < next_due:
                # lint: ignore[virtual-clock] live reference loop — sleeps to the cadence, like a live feed
                time.sleep(next_due - now)
            next_due = max(next_due + cadence_s, now)
        for k, ti in enumerate(batch.tickers):
            sid = session_ids[int(ti)]
            while gateway.saturated:
                drained = gateway.pump(force=True)
                served += keep(drained)
                if not drained and gateway.saturated:
                    # lint: ignore[virtual-clock] live reference loop — GIL yield under backpressure
                    time.sleep(0.002)
            gateway.submit(sid, batch.rows[k])
            submitted += 1
        served += keep(gateway.pump(force=True))
        rounds += 1
    served += keep(gateway.drain())
    # lint: ignore[virtual-clock] telemetry read for the throughput summary
    wall_s = time.perf_counter() - t0

    summary = gateway.metrics.summary()
    out: Dict = {
        "sessions": len(session_ids),
        "rounds": rounds,
        "ticks_submitted": submitted,
        "ticks_served": served,
        "cadence_s": cadence_s,
        "wall_s": round(wall_s, 3),
        "ticks_per_s": round(served / wall_s, 1) if wall_s > 0 else None,
        "kernel_launches_by_bucket": launches_by_bucket(gateway),
        **summary,
    }
    if collect:
        out["results"] = results
    return out
