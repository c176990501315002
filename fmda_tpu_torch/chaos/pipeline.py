"""The data-plane chaos soak: feeds → engine → warehouse → predictor
under a seeded fault plan, as ``fmda_tpu.chaos.pipeline`` defines it.

Where :mod:`fmda_tpu_torch.chaos.soak` drives the *serving* tier (router +
spawned workers), ``run_pipeline_soak`` drives the *data plane* the
paper is actually about: synthetic feed messages flow onto the bus, the
join engine lands rows through a write-ahead-journaled warehouse, and
an optional solo :class:`~fmda_tpu_torch.serve.predictor.Predictor` serves
the signals — while the plan takes feeds down (``feed:<topic>``), makes
the warehouse unreachable (``warehouse.append``), and kills the engine
outright (``engine.step``, rebuilt from its checkpoint like a process
restart after SIGKILL — the object is discarded with no cleanup, so the
checkpoint and bus offsets are all the new incarnation gets).

The report hard-gates the never-abort contract for the whole pipeline:

- ``exit_ok`` — the function returning at all is gate zero;
- ``accounting_zero`` — every published book tick is landed or sits in
  exactly one visible counter (unjoinable drops, journal shed, pending
  joins, journal backlog): ``ingested == landed + Σ losses``, held
  *across* the engine kill/restore (crash-replay dedupe makes
  re-landing idempotent);
- ``degraded_entered`` / ``degraded_recovered`` — a feed outage flips
  the engine into degraded-mode joins (rows emitted with last-known
  side features, counted per topic) and the stream re-joins cleanly
  after recovery (no topic still degraded at the end);
- ``journal_spilled`` / ``journal_drained`` — a warehouse outage spills
  to the durable journal and the backfill drains it to zero once the
  store answers;
- ``engine_restarted`` — every planned engine kill was followed by a
  checkpoint restore that kept serving;
- ``post_chaos_probes_landed`` (and ``post_chaos_probes_served`` with a
  predictor attached) — fresh probe bars published after the last fault
  window land through the recovered pipeline and are served end to end;
- ``identity_ok`` — with ``compare_unfaulted=True``, rows the chaos
  never touched (not degraded, present in both runs) are **bit
  identical** to an unfaulted replay of the same message schedule,
  compared on raw landed table bytes (derived views legitimately shift
  around a degraded neighbor; the landing path must not).

Determinism: the message schedule is a pure function of ``seed``
(:mod:`fmda_tpu_torch.data.synthetic`), the plan is a pure function of its
seed (:meth:`FaultPlan.generate`), and the soak holds no other
randomness — a failing soak replays from its seed.

Keep ``staleness_deadline_s`` below ``watermark_s + 2*join_tolerance_s``
(660 s at the default feature config): past that, a tick waiting on a
dead feed can lose its healthy matches to watermark eviction and drop
(counted) before the ghost arrives — legal, but the soak wants to see
degraded *emissions*.

The Predictor (``predictor=True``) is the port's solo
:class:`~fmda_tpu_torch.serve.predictor.Predictor` on ``device`` (None:
the card, raising without one; ``"cpu"`` runs its plain PyTorch path):
its forward is kernel 1, the GRU forward scan, twice a signal.  No torch
on this import path, and none at all unless ``predictor=True``.
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Dict, List, Optional, Tuple

from fmda_tpu_torch.chaos.inject import (
    ChaosFault,
    configure_chaos,
    default_chaos,
)
from fmda_tpu_torch.chaos.plan import FaultPlan
from fmda_tpu_torch.config import (
    DEFAULT_TOPICS,
    FeatureConfig,
    TOPIC_DEEP,
    WarehouseConfig,
)

log = logging.getLogger("fmda_tpu_torch.chaos")

#: side-feed topics a generated pipeline plan may take down (taking the
#: book feed down just pauses the pipeline — no join stress)
SIDE_FEED_TOPICS = ("vix", "volume", "cot", "ind")

#: the pipeline gate's conservation vocabulary: report fields summed as
#: losses in ``ingested == landed + Σ losses`` — the data-plane
#: counterpart of ``fmda_tpu_torch.chaos.soak.LOSS_COUNTERS`` (these are
#: report keys over engine/journal stats, not RuntimeMetrics counter
#: names)
PIPELINE_LOSS_FIELDS = (
    "dropped_unjoinable",
    "pending_joins",
    "journal_pending",
    "journal_shed",
)


def generate_pipeline_plan(
    seed: int,
    rounds: int,
    *,
    feed_outages: int = 1,
    feed_outage_steps: int = 8,
    warehouse_outages: int = 1,
    warehouse_outage_steps: int = 4,
    engine_kills: int = 1,
    engine_kill_steps: int = 2,
    settle_steps: int = 4,
) -> FaultPlan:
    """The calibrated data-plane schedule — a pure function of ``seed``."""
    return FaultPlan.generate(
        seed, rounds,
        worker_kills=0, router_restarts=0, link_partitions=0,
        bus_blips=0, delays=0,
        feed_outages=feed_outages,
        feed_topics=SIDE_FEED_TOPICS,
        feed_outage_steps=feed_outage_steps,
        warehouse_kills=warehouse_outages,
        warehouse_outage_steps=warehouse_outage_steps,
        engine_kills=engine_kills,
        engine_kill_steps=engine_kill_steps,
        settle_steps=settle_steps,
    )


def _bars(fc: FeatureConfig, seed: int, n_bars: int
          ) -> List[List[Tuple[str, dict]]]:
    """The message schedule, chunked per book tick: each bar opens with
    its DEEP message and carries the side-feed messages for that tick."""
    from fmda_tpu_torch.data.synthetic import (
        SyntheticMarketConfig,
        synthetic_session_messages,
    )

    cfg = SyntheticMarketConfig(
        seed=seed, n_days=n_bars // 78 + 1)
    bars: List[List[Tuple[str, dict]]] = []
    for topic, msg in synthetic_session_messages(fc, cfg):
        if topic == TOPIC_DEEP:
            if len(bars) >= n_bars:
                break
            bars.append([])
        bars[-1].append((topic, msg))
    return bars


def _build_predictor(bus, warehouse, fc: FeatureConfig, *,
                     window: int, hidden: int, seed: int, device=None):
    """A small real Predictor (the solo serving path) fed by the
    engine's signals — randomly initialized (the soak gates serving
    plumbing, not accuracy), deterministic in ``seed`` (an explicit
    ``torch.Generator``), on ``device``."""
    import numpy as np
    import torch

    from fmda_tpu_torch.config import ModelConfig
    from fmda_tpu_torch.data.normalize import NormParams
    from fmda_tpu_torch.models import build_model
    from fmda_tpu_torch.serve.predictor import Predictor

    model_cfg = ModelConfig(
        hidden_size=hidden, n_features=fc.n_features, dropout=0.0)
    state = build_model(
        model_cfg, generator=torch.Generator().manual_seed(seed)
    ).state_dict()
    norm = NormParams(
        x_min=np.zeros(fc.n_features, np.float32),
        x_max=np.ones(fc.n_features, np.float32))
    return Predictor(
        bus, warehouse, model_cfg, state, norm,
        window=window, from_end=False, max_staleness_s=None,
        device=device)


def run_pipeline_soak(
    plan: Optional[FaultPlan] = None,
    *,
    seed: int = 0,
    rounds: int = 30,
    bars_per_round: int = 2,
    probe_rounds: int = 3,
    staleness_deadline_s: int = 450,
    checkpoint_every: int = 3,
    journal_bound: int = 4096,
    predictor: bool = False,
    window: int = 8,
    hidden: int = 4,
    compare_unfaulted: bool = True,
    work_dir: Optional[str] = None,
    device=None,
) -> dict:
    """Run the data-plane soak; returns the gated report (module doc).

    ``plan=None`` runs the schedule fault-free (a fast pipeline smoke).
    With ``compare_unfaulted=True`` and a non-empty plan, the identical
    message schedule replays through an unfaulted pipeline and the
    report carries the raw-row bit-identity verdict.
    """
    if plan is None:
        plan = FaultPlan(n_steps=rounds)
    kwargs = dict(
        seed=seed, rounds=rounds, bars_per_round=bars_per_round,
        probe_rounds=probe_rounds,
        staleness_deadline_s=staleness_deadline_s,
        checkpoint_every=checkpoint_every, journal_bound=journal_bound,
        predictor=predictor, window=window, hidden=hidden,
        work_dir=work_dir, device=device)
    faulted = _run_pipeline(plan, **kwargs)
    report = _gate_report(plan, faulted, predictor=predictor)
    if compare_unfaulted and plan.events:
        # the identity verdict only reads landed rows — skip the
        # predictor (model build + first launch) on the reference replay
        reference = _run_pipeline(
            FaultPlan(n_steps=plan.n_steps),
            **{**kwargs, "predictor": False})
        report["identity"] = _identity_verdict(faulted, reference)
        report["gates"]["identity_ok"] = report["identity"]["ok"]
    report["gates_ok"] = all(report["gates"].values())
    return report


def _run_pipeline(plan: FaultPlan, *, seed, rounds, bars_per_round,
                  probe_rounds, staleness_deadline_s, checkpoint_every,
                  journal_bound, predictor, window, hidden,
                  work_dir, device) -> dict:
    from fmda_tpu_torch.stream.bus import InProcessBus
    from fmda_tpu_torch.stream.engine import StreamEngine
    from fmda_tpu_torch.stream.journal import BufferedWarehouse
    from fmda_tpu_torch.stream.warehouse import Warehouse

    fc = FeatureConfig()
    n_bars = (rounds + probe_rounds) * bars_per_round
    bars = _bars(fc, seed, n_bars)
    log.warning(
        "pipeline soak: %d rounds x %d bars, plan %s",
        rounds, bars_per_round, plan.summary() or "(no faults)")
    chaos = default_chaos()
    tmp_ctx = tempfile.TemporaryDirectory(dir=work_dir)
    run: Dict[str, object] = {}
    try:
        tmp = tmp_ctx.name
        ckpt = os.path.join(tmp, "engine.ckpt.json")
        journal = os.path.join(tmp, "warehouse.journal.jsonl")
        bus = InProcessBus(DEFAULT_TOPICS, capacity=1 << 18)
        inner = Warehouse(fc, WarehouseConfig(path=":memory:"))
        wh = BufferedWarehouse(inner, journal, bound=journal_bound)

        def make_engine() -> StreamEngine:
            return StreamEngine(
                bus, wh, fc, checkpoint_path=ckpt,
                checkpoint_every=checkpoint_every,
                staleness_deadline_s=staleness_deadline_s)

        engine: Optional[StreamEngine] = make_engine()
        served_ts: set = set()
        pred = (_build_predictor(bus, wh, fc, window=window,
                                 hidden=hidden, seed=seed, device=device)
                if predictor else None)
        configure_chaos(enabled=bool(plan.events), plan=plan)

        ingested = 0
        feed_skips: Dict[str, int] = {}
        engine_restarts = 0
        degraded_entered: set = set()
        degraded_exited: set = set()
        active_degraded: set = set()
        dropped_before_kill = 0
        emitted_stats: Dict[str, object] = {}

        def pump_feeds(step_bars) -> None:
            nonlocal ingested
            for bar in step_bars:
                for topic, msg in bar:
                    if chaos.enabled:
                        try:
                            chaos.check("feed:" + topic)
                        except ChaosFault:
                            # the feed is down: its messages for this
                            # window never reach the bus, counted
                            feed_skips[topic] = \
                                feed_skips.get(topic, 0) + 1
                            continue
                    bus.publish(topic, msg)
                    if topic == TOPIC_DEEP:
                        ingested += 1

        def step_engine() -> None:
            nonlocal engine, engine_restarts, dropped_before_kill
            if engine is None:
                if chaos.enabled and chaos.active("engine.step"):
                    return  # still inside the kill window
                # process restart: all the new incarnation gets is the
                # durable checkpoint + the bus — restore() in __init__
                engine = make_engine()
                engine_restarts += 1
            try:
                engine.step()
            # loss-free: the kill IS the experiment — the conservation
            # gate re-derives every loss from the replayed/landed state
            except ChaosFault:
                # SIGKILL semantics: drop the object with no cleanup;
                # counters it accumulated since the last checkpoint die
                # with it, except drops which feed the accounting gate
                dropped_before_kill = int(engine.stats["dropped"])
                engine = None

        def observe_degraded() -> None:
            if engine is None:
                return
            cur = set(engine.degraded_streams())
            degraded_entered.update(cur - active_degraded)
            degraded_exited.update(active_degraded - cur)
            active_degraded.clear()
            active_degraded.update(cur)

        for step in range(rounds):
            chaos.advance(step)
            pump_feeds(bars[step * bars_per_round:
                            (step + 1) * bars_per_round])
            step_engine()
            observe_degraded()
            if pred is not None:
                served_ts.update(
                    p.timestamp for p in pred.poll())

        # the plan is spent: move the clock past every window, rebuild
        # a killed engine, then drive fresh probe bars through the
        # recovered pipeline
        last_fault = max((e.step + e.duration for e in plan.events),
                         default=-1)
        probe_step = max(rounds, last_fault + 1)
        chaos.advance(probe_step)
        probe_ts: List[str] = []
        for r in range(probe_rounds):
            lo = (rounds + r) * bars_per_round
            step_bars = bars[lo:lo + bars_per_round]
            probe_ts.extend(
                msg["Timestamp"] for bar in step_bars
                for topic, msg in bar if topic == TOPIC_DEEP)
            pump_feeds(step_bars)
            step_engine()
            observe_degraded()
            if pred is not None:
                served_ts.update(p.timestamp for p in pred.poll())
        # settle: an idle step quiesces the checkpoint and drains any
        # journal tail; a second poll serves the trailing signals
        for _ in range(2):
            step_engine()
            observe_degraded()
            if pred is not None:
                served_ts.update(p.timestamp for p in pred.poll())

        stats = engine.stats if engine is not None else {}
        emitted_stats = dict(stats)
        run = {
            "plan": plan.summary(),
            "n_steps": plan.n_steps,
            "ingested": ingested,
            "landed": len(inner),
            "dropped": int(stats.get("dropped", dropped_before_kill)),
            "pending_joins": int(stats.get("pending", 0)),
            "feed_skips": feed_skips,
            "engine_restarts": engine_restarts,
            "checkpoint_corrupt": int(
                stats.get("checkpoint_corrupt", 0)),
            "degraded_rows": dict(stats.get("degraded_rows", {})),
            "degraded_entered": sorted(degraded_entered),
            "degraded_exited": sorted(degraded_exited),
            "degraded_active_at_end": sorted(
                stats.get("degraded_streams", [])),
            "degraded_ts": sorted(
                engine.degraded_row_timestamps) if engine else [],
            "journal": wh.journal_stats(),
            "probe_ts": probe_ts,
            "probes_landed": [t for t in probe_ts
                              if inner.has_timestamp(t)],
            "served_ts": sorted(served_ts),
            "chaos_injected": chaos.summary(),
            "landed_raw": inner.raw_rows_for(inner.timestamps()),
            "engine_stats": emitted_stats,
        }
    finally:
        configure_chaos(enabled=False)
        tmp_ctx.cleanup()
    return run


def _gate_report(plan: FaultPlan, run: dict, *, predictor: bool) -> dict:
    journal = run["journal"]
    losses = {
        "dropped_unjoinable": run["dropped"],
        "pending_joins": run["pending_joins"],
        "journal_pending": journal["pending"],
        "journal_shed": journal["shed_rows"],
    }
    # the declared vocabulary and the summed terms must never drift
    # apart: a reordered/extended PIPELINE_LOSS_FIELDS that this dict
    # does not mirror would mislabel the per-field attribution
    # operators act on while the (order-independent) total stayed green
    assert set(losses) == set(PIPELINE_LOSS_FIELDS), (
        sorted(losses), PIPELINE_LOSS_FIELDS)
    unaccounted = run["ingested"] - run["landed"] - sum(losses.values())
    planned = run["plan"]
    feed_faults = [k for k in planned if k.startswith("kill:feed:")]
    wh_faults = planned.get("kill:warehouse.append", 0)
    engine_faults = planned.get("kill:engine.step", 0)
    gates = {
        "exit_ok": True,  # reaching here at all is gate zero
        "accounting_zero": unaccounted == 0,
        "post_chaos_probes_landed": (
            len(run["probes_landed"]) == len(run["probe_ts"])
            and journal["pending"] == 0),
    }
    if feed_faults:
        gates["degraded_entered"] = bool(run["degraded_entered"]) and \
            any(run["degraded_rows"].get(t, 0) > 0
                for t in run["degraded_entered"])
        gates["degraded_recovered"] = (
            not run["degraded_active_at_end"]
            and set(run["degraded_entered"])
            <= set(run["degraded_exited"]))
    if wh_faults:
        gates["journal_spilled"] = journal["spilled_rows"] > 0
        gates["journal_drained"] = (
            journal["pending"] == 0 and journal["backfilled_rows"] > 0)
    if engine_faults:
        gates["engine_restarted"] = \
            run["engine_restarts"] >= engine_faults
    if predictor:
        gates["post_chaos_probes_served"] = set(
            run["probe_ts"]) <= set(run["served_ts"])
    return {
        "plan": planned,
        "chaos_injected": run["chaos_injected"],
        "ingested": run["ingested"],
        "landed": run["landed"],
        "losses": {k: v for k, v in losses.items() if v},
        "unaccounted": unaccounted,
        "feed_skips": run["feed_skips"],
        "degraded_rows": {
            k: v for k, v in run["degraded_rows"].items() if v},
        "degraded_entered": run["degraded_entered"],
        "degraded_exited": run["degraded_exited"],
        "journal": journal,
        "engine_restarts": run["engine_restarts"],
        "checkpoint_corrupt": run["checkpoint_corrupt"],
        "probe_rounds": len(run["probe_ts"]),
        "probes_landed": len(run["probes_landed"]),
        "served": len(run["served_ts"]),
        "gates": gates,
    }


def _identity_verdict(faulted: dict, reference: dict) -> dict:
    """Raw landed rows for timestamps chaos never touched must be bit
    identical to the unfaulted replay; rows the faults did touch are
    excluded (they are already counted degradation)."""
    f_rows: Dict[str, tuple] = faulted["landed_raw"]
    r_rows: Dict[str, tuple] = reference["landed_raw"]
    excluded = set(faulted["degraded_ts"])
    common = [t for t in f_rows
              if t in r_rows and t not in excluded]
    divergent = [t for t in common if f_rows[t] != r_rows[t]]
    return {
        "clean_rows": len(common) - len(divergent),
        "excluded_rows": len(excluded)
        + len([t for t in f_rows if t not in r_rows]),
        "divergent_rows": divergent[:10],
        "ok": bool(common) and not divergent,
    }
