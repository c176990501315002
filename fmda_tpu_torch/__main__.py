"""fmda_tpu_torch command line: the ported slices of ``python -m fmda_tpu``.

    python -m fmda_tpu_torch demo     [--days N] [--epochs N] [--batch-size B]
                                      [--seed S] [--checkpoint-dir D] [--device cpu]
    python -m fmda_tpu_torch ingest   --warehouse W (--synthetic-days N
                                      | --replay FIXTURES [--replay-start TS]
                                      [--ticks N]) [--engine-checkpoint P]
    python -m fmda_tpu_torch train    --warehouse W [--epochs N] [--batch-size B]
                                      [--seed S] [--checkpoint-dir D] [--device cpu]
                                      [--continuous [--max-rounds N]]
    python -m fmda_tpu_torch backtest --warehouse W --checkpoint C [--device cpu]
    python -m fmda_tpu_torch serve    --warehouse W --checkpoint C [--device cpu]
    python -m fmda_tpu_torch serve-fleet --role solo [--cell ssm] [--predictor]
                                      [--sessions N] [--ticks N] [--device cpu]
                                      [--replay [--hot-swap]]
                                      [--continuous-train [--train-rounds N]
                                      [--swap-guard]]
                                      [--trace [--trace-sample R]] [--trace-out F]
                                      [--metrics-port P [--metrics-hold-s S]]
                                      [--jax-profile DIR]
    python -m fmda_tpu_torch status   [--endpoint HOST:PORT [...]]
                                      [--warehouse W] [--watch N]
    python -m fmda_tpu_torch trace    (--input F | --endpoint HOST:PORT
                                      | --merge F ... [--out F]) [--last N]
                                      [--slowest N] [--min-ms X] [--json]
    python -m fmda_tpu_torch perf     (--endpoint HOST:PORT | --input F)
                                      [--profile F] [--top N] [--json]
    python -m fmda_tpu_torch quality  (--endpoint HOST:PORT | --bundle D
                                      | --artifact F) [--json]

``demo`` is the end-to-end proof run: a synthetic corpus through the
streaming engine into a warehouse, training, and a backtest of the
checkpoint it just trained.  ``ingest`` lands feeds into a warehouse file
through the streaming engine (the stack
:class:`~fmda_tpu_torch.app.Application` builds: the native ring bus when
it builds): the synthetic corpus, or a recorded session replayed through
the acquisition layer.  ``train``, ``backtest`` and
``serve`` read a warehouse file ``fmda_tpu`` (or this package) wrote; ``train`` writes a port checkpoint
(:mod:`fmda_tpu_torch.train.checkpoint`) that the other two read, with
the drift reference profile beside it; ``train --continuous`` tails the
warehouse and fine-tunes round by round, a checkpoint and a profile a
round.  ``serve-fleet`` runs the fleet runtime against a synthetic load:
seeded ticker sessions through the FleetGateway, or (``--predictor``)
predict-timestamp signals over a synthetic corpus warehouse through the
batched Predictor, or (``--replay``) a history backfill on a virtual
clock, with ``--hot-swap`` a new checkpoint landing halfway;
``--continuous-train`` runs the continuous trainer in a thread beside the
sessions' load, each accepted round hot-swapped into the live gateway
(``--swap-guard``: after a shadow score against the incumbent);
``--trace``/``--trace-out`` trace it end to end,
``--metrics-port`` serves the observability endpoint while it runs.
``status``, ``trace``, ``perf`` and ``quality`` read that endpoint (or
saved files; ``status`` without one builds a local application over the
configured warehouse) and print its snapshot, trace breakdowns, device report and
model quality (:mod:`fmda_tpu_torch.obs.report`).  All run their models on
the CUDA card unless ``--device cpu`` is given (``ingest`` runs no model).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def _config(args):
    from fmda_tpu_torch.config import FrameworkConfig, load_config

    return load_config(args.config) if args.config else FrameworkConfig()


def _warehouse(path: str, cfg):
    from fmda_tpu_torch.stream import Warehouse

    return Warehouse(cfg.features, dataclasses.replace(cfg.warehouse, path=path))


def _checkpoint_dir(args, cfg) -> str:
    """--checkpoint-dir if passed, else the config's train.checkpoint_dir."""
    return (args.checkpoint_dir if args.checkpoint_dir is not None
            else cfg.train.checkpoint_dir)


def _checkpoint(args, cfg):
    from fmda_tpu_torch.train.checkpoint import latest_checkpoint

    return args.checkpoint or latest_checkpoint(_checkpoint_dir(args, cfg))


def _window_threshold(args, cfg):
    window = args.window if args.window is not None else cfg.train.window
    threshold = (args.threshold if args.threshold is not None
                 else cfg.train.prob_threshold)
    return window, threshold


def _save_quality_profile(wh, cfg, ckpt, *, max_rows: int = 4096) -> None:
    """Write the training-time drift reference profile beside the
    checkpoint, over the newest ``max_rows`` rows.  Best effort: a
    profile that cannot be built (degenerate data) does not fail
    training."""
    from fmda_tpu_torch.eval.drift import (
        build_profile, profile_path_for, save_profile)

    try:
        n = len(wh)
        ids = list(range(max(1, n - max_rows + 1), n + 1))
        rows = wh.fetch(ids)
        targets = wh.fetch_targets(ids) if n > cfg.features.max_lead else None
        profile = build_profile(rows, targets, bins=cfg.quality.drift_bins,
                                columns=list(wh.x_fields))
        path = save_profile(profile_path_for(ckpt), profile)
        print(f"drift reference profile: {path}")
    except (ValueError, IndexError, OSError) as e:
        print(f"drift reference profile not written: {e}", file=sys.stderr)


def _train(wh, cfg, *, epochs, batch_size, checkpoint_dir, seed, device):
    """Train over a warehouse and write a checkpoint and its drift
    reference profile: imbalance weights from the whole target table, then
    ``Trainer.fit``.  Flags given (not None) override the config.  Returns
    ``(checkpoint, history, dataset)``, or None (after saying why) when
    the warehouse is empty.  Shared by ``train`` and ``demo``."""
    from fmda_tpu_torch.train import (
        Trainer, imbalance_weights_from_source, save_checkpoint)

    if len(wh) == 0:
        print("warehouse is empty: ingest rows first", file=sys.stderr)
        return None
    fc = cfg.features
    model_cfg = dataclasses.replace(cfg.model, n_features=len(wh.x_fields))
    overrides = {k: v for k, v in dict(
        batch_size=batch_size, epochs=epochs, seed=seed).items()
        if v is not None}
    train_cfg = dataclasses.replace(cfg.train, **overrides)
    weight, pos_weight = imbalance_weights_from_source(wh)
    trainer = Trainer(model_cfg, train_cfg, weight=weight,
                      pos_weight=pos_weight, device=device)
    state, history, dataset = trainer.fit(
        wh, bid_levels=fc.bid_levels, ask_levels=fc.ask_levels)
    ckpt = save_checkpoint(checkpoint_dir, state, dataset.final_norm_params)
    last = history["train"][-1]
    print(f"trained {len(history['train'])} epochs: "
          f"loss={last.loss:.4f} acc={last.accuracy:.4f} "
          f"(device={trainer.device})")
    print(f"checkpoint: {ckpt}")
    _save_quality_profile(wh, cfg, ckpt)
    return ckpt, history, dataset


def _backtest(wh, cfg, ckpt: str, *, window: int, threshold: float,
              device):
    """Score a checkpoint over the warehouse and print the signal-quality
    table; returns the backtest result.  Shared by ``backtest`` and
    ``demo``."""
    from fmda_tpu_torch.serve import backtest_from_checkpoint, trading_summary

    result = backtest_from_checkpoint(
        wh, ckpt, dataclasses.replace(cfg.model, n_features=len(wh.x_fields)),
        window=window, threshold=threshold, device=device)
    m = result.metrics
    print(f"backtest over {len(result.probabilities)} rows: "
          f"accuracy={float(m.accuracy):.3f} hamming={float(m.hamming):.3f}")
    print(f"{'label':>8} {'signals':>8} {'hits':>6} {'precision':>10} "
          f"{'recall':>7} {'edge':>7}")
    for label, s in trading_summary(result).items():
        print(f"{label:>8} {s.signals:>8} {s.hits:>6} {s.precision:>10.3f} "
              f"{s.recall:>7.3f} {s.edge:>+7.3f}")
    return result


def cmd_demo(args) -> int:
    """The synthetic end-to-end proof run: ``build_corpus`` (the feeds
    through the streaming engine into an in-memory warehouse), training,
    then a backtest of exactly the checkpoint just trained.  Absent flags
    fall back to the config file when one is given, else to quick demo
    defaults (2 epochs at batch 32)."""
    from fmda_tpu_torch.data.synthetic import (
        SyntheticMarketConfig, build_corpus)
    from fmda_tpu_torch.device import resolve_device

    device = resolve_device(args.device)  # before any work
    cfg = _config(args)
    epochs = args.epochs if args.epochs is not None else (
        cfg.train.epochs if args.config else 2)
    batch_size = args.batch_size if args.batch_size is not None else (
        cfg.train.batch_size if args.config else 32)
    seed = args.seed if args.seed is not None else cfg.train.seed
    wh, stats = build_corpus(
        cfg.features, SyntheticMarketConfig(seed=seed, n_days=args.days))
    print(f"corpus: {len(wh)} rows ({stats})")
    try:
        trained = _train(
            wh, cfg, epochs=epochs, batch_size=batch_size,
            checkpoint_dir=_checkpoint_dir(args, cfg), seed=seed,
            device=device)
        if trained is None:
            return 2
        _backtest(wh, cfg, trained[0], window=cfg.train.window,
                  threshold=cfg.train.prob_threshold, device=device)
    finally:
        wh.close()
    return 0


def cmd_ingest(args) -> int:
    """Land feeds into a warehouse file through the streaming engine:
    ``--synthetic-days`` publishes the synthetic corpus, ``--replay`` a
    recorded session through the acquisition layer; everything is
    published first, then the engine steps once.  The stack is the
    :class:`~fmda_tpu_torch.app.Application` the config builds: the
    native ring bus, the warehouse (journaled when configured) and the
    engine."""
    from fmda_tpu_torch.app import Application
    from fmda_tpu_torch.data.synthetic import (
        SyntheticMarketConfig, synthetic_session_messages)

    cfg = _config(args)
    engine_overrides = {k: v for k, v in dict(
        checkpoint_path=args.engine_checkpoint,
        checkpoint_every=args.checkpoint_every).items() if v is not None}
    cfg = dataclasses.replace(
        cfg,
        warehouse=dataclasses.replace(cfg.warehouse, path=args.warehouse),
        engine=dataclasses.replace(cfg.engine, **engine_overrides))
    if not (args.synthetic_days or args.replay):
        print("pass --synthetic-days or --replay (a RecordingTransport "
              "fixture file)", file=sys.stderr)
        return 2
    try:
        app = Application(cfg)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    bus, wh, engine = app.bus, app.warehouse, app.engine
    try:
        if args.synthetic_days:
            for topic, msg in synthetic_session_messages(
                    cfg.features, SyntheticMarketConfig(
                        seed=args.seed, n_days=args.synthetic_days)):
                bus.publish(topic, msg)
        else:
            ticks = _replay_session(args, cfg, bus)
            print(f"replayed {ticks} session tick(s)", file=sys.stderr)
            if ticks == 0:
                print("0 ticks replayed: check --replay-start against the "
                      "recording's market-calendar date", file=sys.stderr)
                return 2
        engine.step()
        print(f"warehouse {args.warehouse}: {len(wh)} rows; "
              f"engine {engine.stats}")
    finally:
        app.close()
        wh.close()
    return 0


def _replay_session(args, cfg, bus) -> int:
    """Re-run a recorded session (a RecordingTransport file) through the
    acquisition layer: the same clients and scrapers, the responses served
    back in recorded order, the clock simulated at the session cadence."""
    import datetime as dt

    from fmda_tpu_torch.ingest import (
        AlphaVantageClient, COTScraper, EconomicCalendarScraper, IEXClient,
        RecordingTransport, SessionDriver, SessionReplayTransport,
        TradierCalendarClient, VIXScraper)

    transport = SessionReplayTransport(
        RecordingTransport.load_fixtures(args.replay))
    clock = {"now": dt.datetime.strptime(args.replay_start,
                                         "%Y-%m-%d %H:%M:%S")}

    def fast_sleep(seconds):
        clock["now"] += dt.timedelta(seconds=seconds)

    sc = cfg.session
    driver = SessionDriver(
        bus, sc,
        iex=IEXClient("replay", transport),
        alpha_vantage=AlphaVantageClient("replay", transport),
        calendar=TradierCalendarClient("replay", transport),
        indicator_scraper=EconomicCalendarScraper(
            cfg.features, transport=transport),
        vix_scraper=VIXScraper(transport),
        cot_scraper=COTScraper(sc.cot_subject, transport),
        now_fn=lambda: clock["now"], sleep_fn=fast_sleep)
    ticks = driver.run_session(max_ticks=args.ticks or None)
    if transport.misses:
        # the replay ran under feeds or a cadence the recording lacks:
        # the per-feed warnings say which ticks, this which endpoints
        print("recording has no responses for: "
              + ", ".join(sorted(set(transport.misses))), file=sys.stderr)
    return ticks


def cmd_train(args) -> int:
    """Train over a warehouse file and write a checkpoint and its drift
    reference profile.  ``--continuous`` runs the continuous fine-tuning
    loop over the file instead (no fleet attached: its checkpoints are the
    output)."""
    from fmda_tpu_torch.device import resolve_device
    from fmda_tpu_torch.train import ContinuousTrainer

    device = resolve_device(args.device)  # before any data is read
    cfg = _config(args)
    ckpt_dir = _checkpoint_dir(args, cfg)
    wh = _warehouse(args.warehouse, cfg)
    try:
        if not args.continuous:
            return 0 if _train(
                wh, cfg, epochs=args.epochs, batch_size=args.batch_size,
                checkpoint_dir=ckpt_dir, seed=args.seed,
                device=device) else 2
        if len(wh) == 0:
            print("warehouse is empty: ingest rows first", file=sys.stderr)
            return 2
        fc = cfg.features
        model_cfg = dataclasses.replace(cfg.model,
                                        n_features=len(wh.x_fields))
        train_cfg = dataclasses.replace(cfg.train, **{
            k: v for k, v in dict(batch_size=args.batch_size,
                                  epochs=args.epochs, seed=args.seed).items()
            if v is not None})
        ct = ContinuousTrainer(
            wh, model_cfg, train_cfg, checkpoint_dir=ckpt_dir,
            bid_levels=fc.bid_levels, ask_levels=fc.ask_levels,
            drift_bins=cfg.quality.drift_bins, target_lead=fc.max_lead,
            device=device)
        out = ct.run(max_rounds=args.max_rounds)
        print(f"continuous train: {out['rounds']} round(s), "
              f"{out['rows_seen']} rows seen, "
              f"{len(out['checkpoints'])} checkpoint(s) "
              f"(device={ct.trainer.device})")
        for ckpt in out["checkpoints"]:
            print(f"checkpoint: {ckpt}")
        return 0 if out["rounds"] > 0 else 2
    finally:
        wh.close()


def cmd_backtest(args) -> int:
    cfg = _config(args)
    ckpt = _checkpoint(args, cfg)
    if ckpt is None:
        print("no checkpoint found", file=sys.stderr)
        return 2
    wh = _warehouse(args.warehouse, cfg)
    window, threshold = _window_threshold(args, cfg)
    _backtest(wh, cfg, ckpt, window=window, threshold=threshold,
              device=args.device)
    return 0


def cmd_serve(args) -> int:
    """Tail-follow the warehouse file: another process appends rows to the
    same SQLite file; each new row is served through the signal-triggered
    Predictor (signals synthesised locally)."""
    from fmda_tpu_torch.config import DEFAULT_TOPICS, TOPIC_PREDICT_TIMESTAMP
    from fmda_tpu_torch.serve import Predictor
    from fmda_tpu_torch.stream import InProcessBus

    cfg = _config(args)
    ckpt = _checkpoint(args, cfg)
    if ckpt is None:
        print("no checkpoint found", file=sys.stderr)
        return 2
    wh = _warehouse(args.warehouse, cfg)
    window, threshold = _window_threshold(args, cfg)
    bus = InProcessBus(DEFAULT_TOPICS)
    predictor = Predictor.from_checkpoint(
        ckpt, bus, wh,
        dataclasses.replace(cfg.model, n_features=len(wh.x_fields)),
        window=window, threshold=threshold,
        from_end=False, max_staleness_s=None, device=args.device)
    served = 0
    last_pos = window - 1 if args.from_start else len(wh)
    deadline = time.monotonic() + args.duration_s if args.duration_s else None
    while True:
        # the cursor is the last row position fetched: a concurrent commit
        # shows up in the next poll, never twice (rows are append-only)
        new_rows = wh.timestamps_after(last_pos)
        if new_rows:
            for _, ts in new_rows:
                bus.publish(TOPIC_PREDICT_TIMESTAMP, {"Timestamp": ts})
            last_pos = new_rows[-1][0]
            for p in predictor.poll():
                served += 1
                print(json.dumps({
                    "timestamp": p.timestamp,
                    "probabilities": [
                        round(float(v), 4) for v in p.probabilities],
                    "labels": list(p.labels),
                }), flush=True)
        if args.once or (deadline is not None
                         and time.monotonic() >= deadline):
            break
        time.sleep(args.poll_interval_s)
    print(f"served {served} predictions", file=sys.stderr)
    return 0


#: serve-fleet flags whose planes are not ported yet, each with the
#: ROADMAP item (queue 1) that ports it; a run that sets one exits 2.
UNPORTED_FLEET_FLAGS = {
    "workers": "item 7 (multi-host serving)",
    "listen": "item 7 (multi-host serving)",
    "connect": "item 7 (multi-host serving)",
    "worker_id": "item 7 (multi-host serving)",
    "shared_bus": "item 7 (multi-host serving)",
    "wire_format": "item 7 (multi-host serving)",
    "duration_s": "item 7 (multi-host serving)",
    "no_controller": "item 7 (control/)",
    "tenant_mix": "item 7 (control/)",
    "chaos_plan": "item 7 (chaos/)",
    "chaos_no_reference": "item 7 (chaos/)",
    "trace_dir": "item 7 (multi-host serving: one trace file a process)",
    "postmortem_dir": "item 7 (obs/recorder.py, the flight recorder)",
    "shard_pool": "item 8 (parallelism)",
}


def _unported_fleet_flag(args) -> str:
    """The first unported serve-fleet flag the run sets, as its message;
    '' when none is set."""
    if args.role != "solo":
        return (f"--role {args.role} is not ported yet (ROADMAP queue 1, "
                "item 7: multi-host serving); use --role solo")
    for dest, item in UNPORTED_FLEET_FLAGS.items():
        if getattr(args, dest) not in (None, False):
            flag = "--" + dest.replace("_", "-")
            return f"{flag} is not ported yet (ROADMAP queue 1, {item})"
    return ""


def _fleet_flag_conflict(args) -> str:
    """The reference's refusals of flag combinations, as its messages;
    '' when the flags compose."""
    if args.hot_swap and not args.replay:
        return "--hot-swap lands mid-backfill; it needs --replay"
    if args.replay and args.predictor:
        return ("--replay serves carried-state sessions; it composes with "
                "--cell, not --predictor")
    if args.continuous_train and (args.replay or args.predictor):
        return ("--continuous-train is its own load shape; drop "
                "--replay/--predictor")
    if args.swap_guard and not args.continuous_train:
        return ("--swap-guard gates --continuous-train swaps; add "
                "--continuous-train")
    return ""


def cmd_serve_fleet(args) -> int:
    """Multi-tenant serving against a synthetic load, one process
    (``--role solo``), built through the
    :class:`~fmda_tpu_torch.app.Application`: N ticker sessions through
    the micro-batching fleet runtime (one pool step a flush serves every
    session in it), or ``--predictor``'s predict-timestamp signals through
    the batched window-re-scan Predictor, or ``--replay``'s history
    backfill at full speed on a virtual clock (``[replay]``; with
    ``--hot-swap`` a new checkpoint lands halfway).  Prints the runtime's
    metrics (per-stage latency histograms, counters, gauges, host stages,
    kernel launches per bucket) as one JSON object; exits 1 when
    ``--slo-p99-ms`` is missed (unless ``--slo-soft``).
    ``--trace``/``--trace-out`` trace the load, ``--metrics-port`` serves
    the observability endpoint during it, ``--jax-profile DIR`` writes a
    torch profile of it into DIR."""
    import os

    from fmda_tpu_torch.device import resolve_device

    refused = _unported_fleet_flag(args) or _fleet_flag_conflict(args)
    if refused:
        print(refused, file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    cfg = _config(args)
    cell = args.cell or os.environ.get("FMDA_FLEET_CELL")
    if cell:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, cell=cell))
    bucket_sizes = (tuple(int(b) for b in args.bucket_sizes.split(","))
                    if args.bucket_sizes else None)
    if args.predictor:
        # the window-re-scan Predictor: the batching knobs land on the
        # predictor_* half of RuntimeConfig
        overrides = dict(
            predictor_max_linger_ms=args.max_linger_ms,
            predictor_queue_bound=args.queue_bound,
            predictor_window=args.window,
            predictor_bucket_sizes=bucket_sizes,
            predictor_ring=(True if args.ring else None))
    else:
        overrides = dict(
            capacity=max(args.sessions, cfg.runtime.capacity,
                         cfg.replay.n_tickers if args.replay else 0),
            max_linger_ms=args.max_linger_ms, queue_bound=args.queue_bound,
            window=args.window, bucket_sizes=bucket_sizes)
    overrides.update(pipeline_depth=(0 if args.serial else None),
                     slo_p99_ms=args.slo_p99_ms)
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, **{k: v for k, v in overrides.items()
                        if v is not None}))
    # tracing and [profiling] apply before anything is built, so every
    # component captures a configured tracer and the ledger books the
    # first launch
    from fmda_tpu_torch.obs import configure_device_obs, configure_tracing

    tracing = bool(args.trace or args.trace_out)
    configure_tracing(
        enabled=tracing or cfg.tracing.enabled,
        sample_rate=(args.trace_sample if tracing
                     else cfg.tracing.sample_rate),
        capacity=cfg.tracing.max_spans)
    configure_device_obs(cfg.profiling)
    return _serve_fleet(args, cfg, device)


def _replay_width(cfg) -> int:
    """The feature width a replay serves: a warehouse backfill streams the
    raw landed table (``table_columns()`` wide), not the derived
    ``x_fields`` view, so the model is sized to those rows."""
    if cfg.replay.source == "warehouse":
        return len(cfg.features.table_columns())
    return cfg.features.n_features


def _seeded_state(model_cfg, seed: int):
    """A random-init ``state_dict`` from ``seed`` (the serving math does
    not depend on the checkpoint)."""
    import torch

    from fmda_tpu_torch.models import build_model

    generator = torch.Generator().manual_seed(seed)
    return build_model(model_cfg, generator=generator).state_dict()


def _carrier_config(cfg, args, n_features: int):
    """The unidirectional carrier the solo fleet's pool serves, sized by
    ``--hidden`` (attn, which carries no state, serves as gru)."""
    return dataclasses.replace(
        cfg.model, bidirectional=False, dropout=0.0,
        hidden_size=args.hidden, n_features=n_features,
        cell=cfg.model.cell if cfg.model.cell != "attn" else "gru")


def _run_replay(gateway, cfg, args, *, warehouse=None, swap_params=None):
    """The ``--replay`` load: a full-speed virtual-clock backfill through
    the gateway's unmodified submit/pump surface
    (:class:`~fmda_tpu_torch.replay.ReplayDriver`) in place of the
    cadence-shaped synthetic load.  With ``swap_params`` the checkpoint
    lands halfway through the backfill, no session dropped."""
    from fmda_tpu_torch.replay import (
        ReplayDriver, SyntheticHistory, WarehouseHistory)

    rc = cfg.replay
    n_features = _replay_width(cfg)
    if rc.source == "warehouse":
        source = WarehouseHistory(
            warehouse, rc.n_tickers, n_features=n_features,
            start_ts=rc.start_ts, end_ts=rc.end_ts, chunk=rc.chunk)
    else:
        source = SyntheticHistory(rc.n_tickers, rc.n_rounds, n_features,
                                  seed=rc.seed, duty=rc.duty,
                                  step_s=rc.step_s)
    quality = None
    if cfg.quality.enabled and rc.source == "warehouse":
        # warehoused backfills have joinable labels: the run reports live
        # quality per weights version beside its throughput
        from fmda_tpu_torch.obs.quality import QualityEvaluator

        quality = QualityEvaluator(cfg.quality, warehouse=warehouse,
                                   max_lead=cfg.features.max_lead)
    # halfway for the synthetic source; a warehouse backfill's round
    # count is known only once its rows stream
    swap_at = max(1, rc.n_rounds // 2)
    swapped: dict = {}

    def on_round(r):
        if swap_params is not None and not swapped and r + 1 >= swap_at:
            version = gateway.hot_swap(swap_params)
            swapped.update({"round": r + 1, "weights_version": version})

    driver = ReplayDriver(gateway, source, seed=rc.seed,
                          wire_dialect=rc.wire_dialect, on_round=on_round,
                          quality=quality)
    out = driver.run()
    out["replay"] = {"source": rc.source, "n_tickers": rc.n_tickers}
    if swapped:
        out["hot_swap"] = swapped
    if quality is not None:
        quality.join()  # the final join: whatever has its labels already
        q = quality.summary()
        out["quality"] = {"conservation": q["conservation"],
                          "overall": q["overall"],
                          "versions": q["versions"]}
    return out


def _serve_fleet(args, cfg, device) -> int:
    import os
    import tempfile

    from fmda_tpu_torch.app import Application

    corpus_dir = None
    if args.predictor or args.continuous_train:
        # the synthetic corpus, landed through the streaming engine: the
        # Predictor's signals read it; the continuous trainer tails it as
        # a backlog (a file, as a tail-follow reads one)
        from fmda_tpu_torch.data.synthetic import (
            SyntheticMarketConfig, build_corpus)

        days = args.predictor_days if args.predictor else args.continuous_days
        wh_cfg = None
        if args.continuous_train:
            corpus_dir = tempfile.TemporaryDirectory()
            wh_cfg = dataclasses.replace(cfg.warehouse, path=os.path.join(
                corpus_dir.name, "corpus.sqlite"))
        wh, _ = build_corpus(cfg.features, SyntheticMarketConfig(
            seed=args.seed, n_days=days), wh_cfg)
        app = Application(cfg, warehouse=wh, device=device)
    else:
        app = Application(cfg, device=device)
    try:
        return _serve_app(args, cfg, app, device)
    finally:
        app.close()
        app.warehouse.close()
        if corpus_dir is not None:
            corpus_dir.cleanup()


def _serve_app(args, cfg, app, device) -> int:
    import threading

    import numpy as np

    rc = cfg.runtime
    continuous = None
    if args.predictor:
        from fmda_tpu_torch.data.normalize import NormParams
        from fmda_tpu_torch.runtime import (
            PredictorLoadConfig, run_predictor_load)

        wh = app.warehouse
        window = (rc.predictor_window if rc.predictor_window is not None
                  else rc.window)
        model_cfg = dataclasses.replace(
            cfg.model, dropout=0.0, hidden_size=args.hidden,
            n_features=len(wh.x_fields))
        state = _seeded_state(model_cfg, args.seed)
        norm = NormParams(np.zeros(model_cfg.n_features, np.float32),
                          np.ones(model_cfg.n_features, np.float32))
        gateway = app.attach_predictor_fleet(model_cfg, state, norm,
                                             max_staleness_s=None)
        out = _run_observed(args, app.observability, gateway,
                            lambda: run_predictor_load(
                                gateway, wh.timestamps()[window - 1:],
                                PredictorLoadConfig(n_signals=args.signals,
                                                    burst=args.burst)))
        out["ring"] = gateway.pool.use_ring
    else:
        from fmda_tpu_torch.runtime import FleetLoadConfig, run_fleet_load

        n_features = (len(app.warehouse.x_fields) if args.continuous_train
                      else _replay_width(cfg) if args.replay
                      else cfg.features.n_features)
        model_cfg = _carrier_config(cfg, args, n_features)
        state = _seeded_state(model_cfg, args.seed)
        gateway = app.attach_fleet(model_cfg, state)
        if args.continuous_train:
            # each accepted round hot-swaps the live pool from the
            # trainer's thread; serving never stops
            from fmda_tpu_torch.train import (
                ContinuousTrainer, gateway_publisher)

            require_eval, verdicts = None, []
            if args.swap_guard:
                from fmda_tpu_torch.eval.shadow import ShadowEvaluator

                # the model is sized to the joined x_fields view; the
                # shadow replay streams raw landed chunks through the
                # warehouse's derived views
                guard = ShadowEvaluator(
                    state, model_config=model_cfg, warehouse=app.warehouse,
                    quality_config=cfg.quality,
                    max_lead=cfg.features.max_lead, window=rc.window,
                    row_transform=app.warehouse.joined_row_transform,
                    device=device)

                def require_eval(params):
                    ok, detail = guard(params)
                    verdicts.append({"ok": ok, **detail})
                    return ok, detail
            continuous = ContinuousTrainer(
                app.warehouse, model_cfg, cfg.train,
                checkpoint_dir=(args.train_checkpoint_dir
                                or cfg.train.checkpoint_dir),
                publish=gateway_publisher(gateway,
                                          require_eval=require_eval),
                bid_levels=cfg.features.bid_levels,
                ask_levels=cfg.features.ask_levels,
                drift_bins=cfg.quality.drift_bins,
                target_lead=cfg.features.max_lead, device=device)
            continuous_thread = threading.Thread(
                target=lambda: continuous.run(max_rounds=args.train_rounds),
                daemon=True, name="fmda-torch-continuous-train")
            continuous_thread.start()
        if args.replay:
            swap_params = None
            if args.hot_swap:
                # the same stack from the next seed: the same shapes (a
                # swap changes no launch), other weights
                swap_params = _seeded_state(model_cfg, args.seed + 1)

            def run_load():
                return _run_replay(gateway, cfg, args,
                                   warehouse=app.warehouse,
                                   swap_params=swap_params)
        else:
            def run_load():
                return run_fleet_load(gateway, FleetLoadConfig(
                    n_sessions=args.sessions, n_ticks=args.ticks,
                    duty=args.duty, seed=args.seed,
                    storm_every=args.storm_every,
                    storm_fraction=args.storm_fraction,
                    burst_every=args.burst_every,
                    burst_rounds=args.burst_rounds,
                    slow_fraction=args.slow_fraction,
                    slow_duty=args.slow_duty))
        out = _run_observed(args, app.observability, gateway, run_load)
        out["cell"] = model_cfg.cell
        if continuous is not None:
            # the tail quiesces by itself (at most continuous_follow_polls
            # empty polls), so the backlog's last round lands; stop() is
            # the backstop
            continuous_thread.join(timeout=120.0)
            if continuous_thread.is_alive():
                continuous.stop()
                continuous_thread.join(timeout=120.0)
            summary = continuous.summary()
            summary["weights_version"] = gateway.weights_version
            if args.swap_guard:
                summary["swap_guard"] = verdicts
            out["continuous_train"] = summary
    out["device"] = str(device)
    if args.trace or args.trace_out:
        from fmda_tpu_torch.obs import default_tracer

        tracer = default_tracer()
        out["tracing"] = {
            "traces_finished": tracer.traces_finished,
            "spans_buffered": len(tracer.spans()),
            "e2e": tracer.e2e.summary(),
        }
        if args.trace_out:
            with open(args.trace_out, "w") as fh:
                json.dump(tracer.chrome(), fh)
            out["tracing"]["file"] = args.trace_out
            print(f"perfetto trace written to {args.trace_out} (load at "
                  f"https://ui.perfetto.dev, or `python -m fmda_tpu_torch "
                  f"trace --input {args.trace_out}`)", file=sys.stderr)
    slo_ok = True
    if rc.slo_p99_ms is not None:
        p99 = out.get("latency", {}).get("total", {}).get("p99_ms")
        slo_ok = p99 is not None and p99 <= rc.slo_p99_ms
        out["slo"] = {"p99_ms_bound": rc.slo_p99_ms, "p99_ms": p99,
                      "ok": slo_ok, "soft": bool(args.slo_soft)}
    print(json.dumps(out, indent=2))
    if args.metrics_port is not None and args.metrics_hold_s > 0:
        # keep the endpoint scrapeable after the (finite) load, before the
        # SLO verdict exits
        print(f"holding metrics endpoint for {args.metrics_hold_s:.0f}s",
              file=sys.stderr)
        time.sleep(args.metrics_hold_s)
    if not slo_ok and not args.slo_soft:
        p99 = out["slo"]["p99_ms"]
        print("SLO gate failed: "
              + (f"total p99 {p99}ms > {rc.slo_p99_ms}ms bound"
                 if p99 is not None else
                 "no latency data collected (nothing served)")
              + " (--slo-soft reports without failing)", file=sys.stderr)
        return 1
    return 0


def _run_observed(args, obs, gateway, run_load) -> dict:
    """Run the load with the endpoint up (``--metrics-port``, or the
    config's ``observability.endpoint_enabled`` on its port) and inside a
    torch profile (``--jax-profile``), the carried-state pool's flushes
    annotated as numbered ``pool_flush`` ranges."""
    if args.metrics_port is not None or obs.config.endpoint_enabled:
        server = obs.start_server(port=args.metrics_port)
        print(f"metrics endpoint: {server.url}/metrics (healthz, snapshot, "
              f"events, trace, device, profile)", file=sys.stderr)
    if not args.jax_profile:
        return run_load()
    from fmda_tpu_torch.utils.tracing import device_trace

    if hasattr(gateway, "annotate_device_steps"):
        gateway.annotate_device_steps = True
    with device_trace(args.jax_profile):
        out = run_load()
    print(f"torch profile (Chrome trace) written into {args.jax_profile}",
          file=sys.stderr)
    return out


def _add_serve_fleet(sub, common) -> None:
    p = sub.add_parser(
        "serve-fleet", parents=[common],
        help="the micro-batching fleet runtime against a synthetic load")
    p.add_argument("--role",
                   choices=("solo", "broker", "router", "worker", "local"),
                   default="solo",
                   help="'solo' (the default) runs the one-process fleet "
                        "runtime; the multi-host roles are not ported yet "
                        "and exit 2")
    p.add_argument("--sessions", type=int, default=64,
                   help="concurrent ticker sessions (pool capacity grows "
                        "to fit when the config's is smaller)")
    p.add_argument("--ticks", type=int, default=100,
                   help="submission rounds over the fleet")
    p.add_argument("--duty", type=float, default=1.0,
                   help="fraction of sessions ticking per round")
    p.add_argument("--storm-every", type=int, default=0,
                   help="reconnect storm: every N rounds, close and reopen "
                        "a burst of sessions (0 = off)")
    p.add_argument("--storm-fraction", type=float, default=0.25,
                   help="fraction of sessions hit per reconnect storm")
    p.add_argument("--burst-every", type=int, default=0,
                   help="synchronized burst: every N rounds every session "
                        "ticks for --burst-rounds rounds (0 = off)")
    p.add_argument("--burst-rounds", type=int, default=1,
                   help="consecutive all-tick rounds per burst")
    p.add_argument("--slow-fraction", type=float, default=0.0,
                   help="fraction of sessions ticking at --slow-duty")
    p.add_argument("--slow-duty", type=float, default=0.05,
                   help="tick probability per round of the slow sessions")
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--cell", default=None, choices=["gru", "lstm", "ssm"],
                   help="carried-state cell family of the pool (overrides "
                        "[model] cell; default env FMDA_FLEET_CELL, else "
                        "the config)")
    p.add_argument("--window", type=int, default=None,
                   help="override config runtime.window (default 30)")
    p.add_argument("--bucket-sizes", default=None, metavar="N,N,...",
                   help="override config runtime.bucket_sizes (ascending)")
    p.add_argument("--max-linger-ms", type=float, default=None,
                   help="override config runtime.max_linger_ms")
    p.add_argument("--queue-bound", type=int, default=None,
                   help="override config runtime.queue_bound")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--predictor", action="store_true",
                   help="serve the window-re-scan Predictor instead of "
                        "carried-state sessions: predict-timestamp signals "
                        "over the synthetic corpus (78 bars a day, landed "
                        "through the streaming engine), batched into "
                        "bucketed (B, window, F) forwards "
                        "(runtime.predictor_* knobs)")
    p.add_argument("--predictor-days", type=int, default=3,
                   help="warehouse size for --predictor (days of bars)")
    p.add_argument("--signals", type=int, default=0,
                   help="signal count for --predictor (0 = every servable "
                        "warehouse timestamp)")
    p.add_argument("--burst", type=int, default=32,
                   help="signals published per poll for --predictor")
    p.add_argument("--ring", action="store_true", default=None,
                   help="keep the device-resident window ring for "
                        "--predictor (runtime.predictor_ring)")
    p.add_argument("--serial", action="store_true", default=None,
                   help="disable the one-deep flush overlap pipeline "
                        "(runtime.pipeline_depth=0; the bit-identical A/B "
                        "reference)")
    p.add_argument("--slo-p99-ms", type=float, default=None,
                   help="latency-SLO gate: exit 1 unless p99 of "
                        "submit->publish stays under this bound "
                        "(overrides config runtime.slo_p99_ms)")
    p.add_argument("--slo-soft", action="store_true",
                   help="report the SLO verdict in the JSON but never "
                        "fail the run")
    p.add_argument("--continuous-train", action="store_true",
                   help="run the continuous fine-tuning loop in a thread "
                        "beside the load, over a synthetic corpus "
                        "warehouse of --continuous-days days tailed as a "
                        "backlog; every accepted round hot-swaps the live "
                        "gateway ([train] continuous_* knobs)")
    p.add_argument("--continuous-days", type=int, default=2,
                   help="corpus size (trading days of 78 bars) for the "
                        "--continuous-train warehouse")
    p.add_argument("--swap-guard", action="store_true",
                   help="with --continuous-train: shadow-score every "
                        "candidate against the incumbent before its swap "
                        "(fmda_tpu_torch.eval.shadow; a refusal keeps the "
                        "incumbent serving and is counted)")
    p.add_argument("--replay", action="store_true",
                   help="historical backfill: serve the [replay] config "
                        "section's history source (seeded synthetic, or "
                        "the warehouse's rows) through the unmodified "
                        "serving path at full speed on a virtual clock "
                        "(the rows' own timestamps), in place of the "
                        "synthetic load")
    p.add_argument("--hot-swap", action="store_true",
                   help="with --replay: land a checkpoint from the next "
                        "seed into the live gateway halfway through the "
                        "backfill, no session dropped; results carry "
                        "weights_version from the swap barrier on")
    p.add_argument("--train-rounds", type=int, default=None,
                   help="bound --continuous-train fine-tune rounds "
                        "(default: until the backlog quiesces)")
    p.add_argument("--train-checkpoint-dir", default=None,
                   help="--continuous-train checkpoint directory "
                        "(default: config train.checkpoint_dir)")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve /metrics, /healthz, /snapshot, /events, "
                        "/trace, /device and /profile on this port during "
                        "the run (0 = ephemeral)")
    p.add_argument("--metrics-hold-s", type=float, default=0.0,
                   help="keep the metrics endpoint up this long after the "
                        "load finishes")
    p.add_argument("--trace", action="store_true",
                   help="trace every sampled tick end to end "
                        "(fmda_tpu_torch.obs.trace; spans also served on "
                        "/trace when --metrics-port is up)")
    p.add_argument("--trace-sample", type=float, default=1.0,
                   help="trace sampling rate in [0,1] (default 1.0: every "
                        "tick)")
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="write the span ring as Chrome/Perfetto "
                        "trace_event JSON after the load (implies --trace; "
                        "read it with `python -m fmda_tpu_torch trace "
                        "--input FILE` or ui.perfetto.dev)")
    p.add_argument("--jax-profile", default=None, metavar="DIR",
                   help="the reference's flag, so one command line runs on "
                        "both packages: here a torch.profiler capture (CPU "
                        "and CUDA activity) of the load, written into DIR "
                        "as a Chrome trace, the pool's flushes annotated "
                        "as numbered pool_flush ranges")
    # the reference's flags of planes not ported yet: accepted by the
    # parser so that a run setting one exits 2 naming its ROADMAP item
    unported = p.add_argument_group(
        "not ported yet (each exits 2 and names its ROADMAP item)")
    for dest in UNPORTED_FLEET_FLAGS:
        flag = "--" + dest.replace("_", "-")
        if dest in ("shared_bus", "no_controller", "chaos_no_reference",
                    "shard_pool"):
            unported.add_argument(flag, action="store_true", default=None)
        else:
            unported.add_argument(flag, default=None)
    p.set_defaults(fn=cmd_serve_fleet)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="fmda_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument(
        "--config", default=None, metavar="JSON",
        help="FrameworkConfig overrides as JSON (the fmda_tpu schema; the "
             "features/bus/warehouse/engine/model/train/session/runtime/"
             "quality/observability/tracing/profiling sections are read)")
    common.add_argument(
        "--device", default=None,
        help="torch device (default: cuda; pass 'cpu' to run the plain "
             "PyTorch path without a card)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("demo", parents=[common],
                       help="synthetic end-to-end proof run")
    p.add_argument("--days", type=int, default=8)
    p.add_argument("--epochs", type=int, default=None,
                   help="default: config's train.epochs, or 2 standalone")
    p.add_argument("--batch-size", type=int, default=None,
                   help="default: config's train.batch_size, or 32 "
                        "standalone")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--checkpoint-dir", default=None)
    p.set_defaults(fn=cmd_demo)

    p = sub.add_parser("ingest", parents=[common],
                       help="fill a warehouse file through the streaming "
                            "engine (host only: --device is not read)")
    p.add_argument("--warehouse", required=True, help="sqlite file path")
    p.add_argument("--synthetic-days", type=int, default=0)
    p.add_argument("--replay", default=None, metavar="FIXTURES",
                   help="re-run a recorded session (RecordingTransport "
                        "file) through the acquisition layer")
    p.add_argument("--replay-start", default="2020-02-07 09:30:00",
                   help="simulated clock start for --replay")
    p.add_argument("--ticks", type=int, default=0,
                   help="cap on --replay session ticks (0 = until close)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--engine-checkpoint", default=None)
    p.add_argument("--checkpoint-every", type=int, default=None)
    p.set_defaults(fn=cmd_ingest)

    p = sub.add_parser("train", parents=[common],
                       help="train over a warehouse file")
    p.add_argument("--warehouse", required=True, help="sqlite file path")
    p.add_argument("--checkpoint-dir", default=None,
                   help="override config train.checkpoint_dir")
    p.add_argument("--epochs", type=int, default=None,
                   help="override config train.epochs (default 25)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="override config train.batch_size (default 2)")
    p.add_argument("--seed", type=int, default=None,
                   help="override config train.seed (default 0)")
    p.add_argument("--continuous", action="store_true",
                   help="tail the warehouse and fine-tune continuously "
                        "([train] continuous_* knobs; a checkpoint and a "
                        "drift profile a round)")
    p.add_argument("--max-rounds", type=int, default=None,
                   help="bound --continuous fine-tune rounds (default: "
                        "until the warehouse quiesces)")
    p.set_defaults(fn=cmd_train)

    for name, fn, text in (
        ("backtest", cmd_backtest, "score a checkpoint over history"),
        ("serve", cmd_serve, "prediction daemon over a warehouse"),
    ):
        p = sub.add_parser(name, parents=[common], help=text)
        p.add_argument("--warehouse", required=True, help="sqlite file path")
        p.add_argument("--checkpoint", default=None)
        p.add_argument("--checkpoint-dir", default=None)
        p.add_argument("--window", type=int, default=None,
                       help="override config train.window (default 30)")
        p.add_argument("--threshold", type=float, default=None,
                       help="label decision threshold")
        p.set_defaults(fn=fn)
        if name == "serve":
            p.add_argument("--poll-interval-s", type=float, default=0.5)
            p.add_argument("--duration-s", type=float, default=0.0)
            p.add_argument("--once", action="store_true",
                           help="one poll pass, then exit")
            p.add_argument("--from-start", action="store_true",
                           help="serve existing history too, not just new "
                                "rows")
    _add_serve_fleet(sub, common)
    from fmda_tpu_torch.obs.report import add_parsers

    add_parsers(sub, common)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
