"""Capacity model: sweep sessions × arrival rate → max sustainable load,
as ``fmda_tpu.control.capacity`` defines it (the artifact's schema, keys
and cells are the reference's).

"How many tickers at what tick rate can this host serve inside the
SLO?" is the question every deployment sizing starts from, and the
control plane's scaling thresholds are only as good as the answer.
This sweep measures it empirically: for each (sessions, duty) cell a
fresh gateway serves a seeded synthetic load, and the cell is
*sustainable* when the measured p99 meets the objective with zero
sheds and every submitted tick served.  The output is one JSON
artifact (``schema`` pinned — downstream tooling parses it) listing
the grid, the max sustainable cell, and a fixed-vs-adaptive linger A/B
that shows the batching controller earning its keep on the same load.

torch-free by injection: callers supply ``gateway_factory(n_sessions)``
returning a :class:`~fmda_tpu_torch.runtime.gateway.FleetGateway`-shaped
object (:func:`pool_gateway_factory` builds real pools on the card; the
schema tests inject a deterministic fake), so importing this module never
touches the device stack.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np

from fmda_tpu_torch.control.controller import BatchingController

#: bump on any shape change; tests pin it together with the top-level keys
CAPACITY_SCHEMA = "fmda.control.capacity/1"

#: top-level artifact keys (pinned by tests/test_control.py)
CAPACITY_KEYS = (
    "schema", "slo_p99_ms", "rounds", "grid", "max_sustainable",
    "controller_ab",
)

#: per-cell keys (pinned alongside)
CELL_KEYS = (
    "sessions", "duty", "submitted", "served", "shed", "p99_ms",
    "ticks_per_s", "ok",
)


def pool_gateway_factory(
    model_cfg,
    params,
    *,
    window: int,
    bucket_sizes: Sequence[int] = (8, 32),
    max_linger_ms: float = 2.0,
    device=None,
    pools: Optional[list] = None,
) -> Callable[[int], object]:
    """``gateway_factory`` over real pools: each call builds a
    :class:`~fmda_tpu_torch.runtime.session_pool.SessionPool` of exactly
    ``n_sessions`` slots on ``device`` (None: the card, raising without
    one), warms every bucket on padding-only flushes outside the gateway
    (so no cell's p99 pays a first launch's build or allocation), and
    fronts it with a fresh :class:`FleetGateway`.  Each pool is appended
    to ``pools`` when given (the caller reads launches per pool)."""
    from fmda_tpu_torch.runtime import (
        BatcherConfig,
        FleetGateway,
        SessionPool,
    )

    buckets = tuple(bucket_sizes)

    def factory(n_sessions: int):
        pool = SessionPool(model_cfg, params, capacity=n_sessions,
                           window=window, device=device)
        for b in buckets:
            pool.step(np.full(b, pool.padding_slot, np.int32),
                      np.zeros((b, model_cfg.n_features), np.float32))
        if pools is not None:
            pools.append(pool)
        return FleetGateway(pool, batcher_config=BatcherConfig(
            bucket_sizes=buckets, max_linger_s=max_linger_ms / 1e3))

    return factory


def _drive(
    gateway,
    n_sessions: int,
    duty: float,
    rounds: int,
    rng,
    *,
    on_round: Optional[Callable[[int], None]] = None,
) -> dict:
    """One load cell: open sessions, run seeded duty-cycled rounds,
    drain, report the cell measurements."""
    nf = getattr(gateway, "n_features", None)
    if nf is None:
        nf = gateway.pool.cfg.n_features
    sids = [f"C{i:04d}" for i in range(n_sessions)]
    for sid in sids:
        gateway.open_session(sid)
    submitted = 0
    t0 = time.perf_counter()
    for r in range(rounds):
        ticks = rng.random(n_sessions) < duty
        for i, sid in enumerate(sids):
            if ticks[i]:
                gateway.submit(
                    sid, rng.normal(size=nf).astype(np.float32))
                submitted += 1
        gateway.pump()
        if on_round is not None:
            on_round(r)
    gateway.drain()
    elapsed = max(time.perf_counter() - t0, 1e-9)
    for sid in sids:
        gateway.close_session(sid)
    counters = dict(gateway.metrics.counters)
    hist = gateway.metrics.histograms["total"]
    from fmda_tpu_torch.obs.aggregate import GATEWAY_LOSS_COUNTERS

    shed = sum(counters.get(k, 0) for k in GATEWAY_LOSS_COUNTERS)
    return {
        "sessions": n_sessions,
        "duty": duty,
        "submitted": submitted,
        "served": counters.get("ticks_served", 0),
        "shed": shed,
        "p99_ms": round(hist.percentile(99) * 1e3, 3) if hist.n else None,
        "ticks_per_s": round(submitted / elapsed, 1),
    }


def run_capacity_model(
    gateway_factory: Callable[[int], object],
    *,
    slo_p99_ms: float,
    session_grid: Sequence[int] = (8, 16, 32),
    duty_grid: Sequence[float] = (0.25, 0.5, 1.0),
    rounds: int = 60,
    seed: int = 0,
    controller_ab: bool = True,
    ab_target_frac: float = 0.5,
) -> dict:
    """The full sweep → artifact dict (see module docstring).

    ``gateway_factory(n_sessions)`` must return a fresh gateway (own
    metrics) per call; each cell runs on its own so no queue state or
    histogram bleeds across cells."""
    grid = []
    for n_sessions in session_grid:
        for duty in duty_grid:
            rng = np.random.default_rng(seed)
            gw = gateway_factory(n_sessions)
            cell = _drive(gw, n_sessions, duty, rounds, rng)
            cell["ok"] = bool(
                cell["shed"] == 0
                and cell["served"] == cell["submitted"]
                and (cell["p99_ms"] is None
                     or cell["p99_ms"] <= slo_p99_ms))
            grid.append(cell)
    sustainable = [c for c in grid if c["ok"] and c["submitted"]]
    best = (max(sustainable, key=lambda c: c["ticks_per_s"])
            if sustainable else None)
    out = {
        "schema": CAPACITY_SCHEMA,
        "slo_p99_ms": slo_p99_ms,
        "rounds": rounds,
        "grid": grid,
        "max_sustainable": best,
        "controller_ab": None,
    }
    if controller_ab:
        # A/B at the LIGHTEST cell — the linger-bound regime.  At full
        # duty the buckets fill instantly and linger never binds, so no
        # controller could move the needle there; under a trickle the
        # fixed linger IS the tail latency, and cutting it is exactly
        # how the batching controller earns its keep.  Protocol: the
        # adaptive arm first converges on a warmup gateway (steering
        # toward ``ab_target_frac`` of the fixed-linger p99), then a
        # fresh gateway starts from the converged settings and the
        # measured histogram covers only steady-state ticks — a fair
        # fixed-vs-converged comparison, not one polluted by the
        # pre-convergence ramp.
        n_ab = min(session_grid)
        duty_ab = min(duty_grid)
        rng = np.random.default_rng(seed)
        fixed = _drive(gateway_factory(n_ab), n_ab, duty_ab, rounds, rng)
        target = None
        adaptive = None
        decisions = 0
        converged = None
        if fixed["p99_ms"]:
            target = max(fixed["p99_ms"] * ab_target_frac, 0.05)
            warm = gateway_factory(n_ab)
            linger0 = warm.batcher.config.max_linger_s * 1e3
            ctrl = BatchingController(
                target_p99_ms=target, linger_ms=linger0,
                bucket_sizes=warm.batcher.config.bucket_sizes,
                min_linger_ms=0.0,
                max_linger_ms=max(linger0, 1.0),
                linger_step_ms=max(linger0 / 4.0, 0.05))

            def steer_on(gw) -> Callable[[int], None]:
                def steer(r: int) -> None:
                    nonlocal decisions
                    if r % 5 != 4:
                        return
                    hist = gw.metrics.histograms["total"]
                    p99 = hist.percentile(99) * 1e3 if hist.n else None
                    if ctrl.decide(p99, float(r)) is not None:
                        decisions += 1
                        gw.retune(max_linger_ms=ctrl.linger_ms,
                                  bucket_cap=ctrl.bucket_cap)
                return steer

            rng = np.random.default_rng(seed)
            _drive(warm, n_ab, duty_ab, rounds, rng,
                   on_round=steer_on(warm))
            gw = gateway_factory(n_ab)
            gw.retune(max_linger_ms=ctrl.linger_ms,
                      bucket_cap=ctrl.bucket_cap)
            converged = {"linger_ms": round(ctrl.linger_ms, 4),
                         "bucket_cap": ctrl.bucket_cap}
            rng = np.random.default_rng(seed)
            adaptive = _drive(gw, n_ab, duty_ab, rounds, rng,
                              on_round=steer_on(gw))
        out["controller_ab"] = {
            "sessions": n_ab,
            "duty": duty_ab,
            "target_p99_ms": target,
            "fixed_p99_ms": fixed["p99_ms"],
            "adaptive_p99_ms": adaptive["p99_ms"] if adaptive else None,
            "converged": converged,
            "decisions": decisions,
            "improved": bool(
                adaptive and fixed["p99_ms"] and adaptive["p99_ms"]
                and adaptive["p99_ms"] < fixed["p99_ms"]),
        }
    return out
