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
    python -m fmda_tpu_torch serve-fleet --role local [--no-controller]
                                      [--workers N] [--cell ssm]
                                      [--sessions N] [--ticks N]
                                      [--tenant-mix CLASS:W,...]
                                      [--trace-dir D] [--postmortem-dir D]
                                      [--metrics-port P] [--replay
                                      [--hot-swap]] [--device cpu]
                                      [--chaos-plan generate|FILE
                                      [--chaos-no-reference]]
    python -m fmda_tpu_torch serve-fleet --role broker|router [--listen P]
                                      [--connect HOST:PORT] [--workers N]
                                      [--no-controller] [--duration-s S]
    python -m fmda_tpu_torch serve-fleet --role worker --worker-id W
                                      --connect HOST:PORT [--shared-bus]
                                      [--wire-format auto|binary|json]
                                      [--device cpu]
    python -m fmda_tpu_torch chaos-pipeline [--rounds N] [--seed S]
                                      [--plan F] [--no-predictor]
                                      [--no-reference] [--device cpu]
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
``serve-fleet --role local`` runs the multi-host topology on one machine:
N worker processes, each with its own pool on the card, behind a router
in this process, with the adaptive control plane beside it
(:mod:`fmda_tpu_torch.control`: the batching controller, per-tenant QoS
for ``--tenant-mix`` sessions when ``[control] tenant_classes`` names
them, the autoscaler) unless ``--no-controller``; with ``--chaos-plan``
it runs the chaos soak instead (:mod:`fmda_tpu_torch.chaos.soak`).
``broker``, ``router`` and ``worker`` start its tiers by hand.  The
broker and the router need no card and import no torch.
``chaos-pipeline`` runs the data-plane chaos soak
(:mod:`fmda_tpu_torch.chaos.pipeline`).
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


def _control_plane(args, cfg, telemetry, *, router=None, actuator=None,
                   initial_linger_ms=None, bucket_sizes=None):
    """The adaptive control plane for --role router/local
    (:mod:`fmda_tpu_torch.control`): on whenever fleet telemetry is (the
    loops read its signals) unless ``[control] enabled = false`` or
    ``--no-controller``.  Attached to the telemetry, so its decision ring
    serves on ``/control``; None when off."""
    if telemetry is None or not cfg.control.enabled or args.no_controller:
        return None
    from fmda_tpu_torch.control import ControlPlane

    plane = ControlPlane(
        cfg.control, telemetry=telemetry, router=router,
        actuator=actuator, slo_cfg=cfg.slo,
        initial_linger_ms=(initial_linger_ms if initial_linger_ms
                           is not None else cfg.runtime.max_linger_ms),
        bucket_sizes=tuple(bucket_sizes if bucket_sizes is not None
                           else cfg.runtime.bucket_sizes))
    telemetry.attach_controller(plane)
    return plane


def _tenant_mix(args):
    """Parse ``--tenant-mix gold:1,standard:4`` into the loadgen's
    parallel (classes, weights) tuples; ((), ()) when unset."""
    spec = getattr(args, "tenant_mix", None)
    if not spec:
        return (), ()
    classes, weights = [], []
    for part in spec.split(","):
        name, _, w = part.partition(":")
        if not name.strip():
            raise SystemExit(f"bad --tenant-mix entry: {part!r}")
        classes.append(name.strip())
        try:
            weights.append(float(w) if w else 1.0)
        except ValueError:
            raise SystemExit(
                f"bad --tenant-mix weight in {part!r} "
                "(want CLASS or CLASS:WEIGHT)") from None
    return tuple(classes), tuple(weights)


def _worker_qos(cfg):
    """A worker's per-tenant QoS policy: the ``[control]`` tenant classes
    (:class:`~fmda_tpu_torch.control.qos.QosPolicy`), None when the
    section names none or the control plane is off."""
    if not (cfg.control.enabled and cfg.control.tenant_classes):
        return None
    from fmda_tpu_torch.control.qos import QosPolicy

    return QosPolicy.from_config(cfg.control)


def _fleet_flag_conflict(args) -> str:
    """The reference's refusals of flag combinations, as its messages;
    '' when the flags compose."""
    if args.replay and args.role not in ("solo", "local"):
        return ("--replay drives a solo gateway or the local topology; "
                "use --role solo or --role local")
    if args.replay and args.role == "local" and _config(
            args).replay.source == "warehouse":
        # spawned workers size their models from the feature schema; a
        # warehouse backfill streams raw landed rows (narrower)
        return ("[replay] source=warehouse backfills run solo "
                "(landed-row width); drop --role local")
    if args.hot_swap and not args.replay:
        return "--hot-swap lands mid-backfill; it needs --replay"
    if args.replay and args.predictor:
        return ("--replay serves carried-state sessions; it composes with "
                "--cell, not --predictor")
    if args.continuous_train and args.role != "solo":
        return ("--continuous-train runs beside the solo gateway; use "
                "--role solo (fleet-wide: run `train --continuous` "
                "against the shared warehouse and let the router "
                "broadcast)")
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
    torch profile of it into DIR.

    ``--role broker|router|worker|local`` runs the multi-host topology
    instead (:mod:`fmda_tpu_torch.fleet`): a router fronting N worker
    processes over the cross-process bus, with session routing,
    membership and live migration.  The broker and the router need no
    card and import no torch; each worker runs its pool on the card."""
    refused = _fleet_flag_conflict(args)
    if refused:
        print(refused, file=sys.stderr)
        return 2
    if args.role == "worker":
        return _cmd_fleet_worker(args)
    if args.role == "broker":
        return _cmd_fleet_broker(args)
    if args.role == "router":
        return _cmd_fleet_router(args)
    if args.role == "local":
        return _cmd_fleet_local(args)
    from fmda_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    cfg = _fleet_runtime_overrides(args, _config(args))
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


def _run_replay(gateway, cfg, args, *, warehouse=None, swap_params=None,
                is_router=False, extra_on_round=None):
    """The ``--replay`` load: a full-speed virtual-clock backfill through
    the gateway's (or, ``is_router``, the fleet router's) unmodified
    submit/pump surface (:class:`~fmda_tpu_torch.replay.ReplayDriver`)
    in place of the cadence-shaped synthetic load.  With ``swap_params``
    the checkpoint lands halfway through the backfill, straight into the
    gateway or broadcast to every live worker through the router, no
    session dropped."""
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
    tenant_classes, tenant_weights = _tenant_mix(args)
    swapped: dict = {}

    def on_round(r):
        if swap_params is not None and not swapped and r + 1 >= swap_at:
            if is_router:
                told = gateway.broadcast_hot_swap(swap_params)
                swapped.update({"round": r + 1, "workers_told": told})
            else:
                version = gateway.hot_swap(swap_params)
                swapped.update({"round": r + 1, "weights_version": version})
        if extra_on_round is not None:
            extra_on_round(r)

    # a router encodes per link itself; the dialect round trip is the
    # solo gateway's stand-in for those bytes
    driver = ReplayDriver(gateway, source, tenant_classes=tenant_classes,
                          tenant_weights=tenant_weights, seed=rc.seed,
                          wire_dialect=None if is_router else rc.wire_dialect,
                          on_round=on_round, quality=quality)
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
    _maybe_write_trace(args, out)
    if args.trace_out:
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


def _fleet_wire_override(args, cfg):
    """Fold the cross-role serve-fleet switches into cfg: the wire format
    (``--wire-format`` -> [fleet]) and the carried-state cell family
    (``--cell``, else ``FMDA_FLEET_CELL`` -> [model] cell), so both work
    from the command line alone on every role."""
    import os

    if getattr(args, "wire_format", None):
        cfg = dataclasses.replace(cfg, fleet=dataclasses.replace(
            cfg.fleet, wire_format=args.wire_format))
    cell = getattr(args, "cell", None) or os.environ.get("FMDA_FLEET_CELL")
    if cell:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, cell=cell))
    return cfg


def _bucket_sizes(args):
    return (tuple(int(b) for b in args.bucket_sizes.split(","))
            if args.bucket_sizes else None)


def _fleet_runtime_overrides(args, cfg):
    """Fold the cross-role switches (:func:`_fleet_wire_override`) and the
    serve-fleet batching flags into cfg (with ``--predictor`` into the
    predictor_* half of RuntimeConfig)."""
    cfg = _fleet_wire_override(args, cfg)
    bucket_sizes = _bucket_sizes(args)
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
                     slo_p99_ms=args.slo_p99_ms,
                     shard_pool=None if args.predictor else args.shard_pool)
    return dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, **{k: v for k, v in overrides.items()
                        if v is not None}))


def _maybe_write_trace(args, out: dict) -> None:
    """The --trace/--trace-out tail of every serve-fleet role."""
    if not (args.trace or args.trace_out):
        return
    from fmda_tpu_torch.obs.trace import default_tracer

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


def _cmd_fleet_worker(args) -> int:
    """serve-fleet --role worker: one slot-range owner of a multi-host
    topology.  Connects a SocketBus to the router's bus server, joins by
    hello, hosts its own data-plane bus (unless ``--shared-bus``) and
    serves its inbox on the card until the router says stop (or the
    ``--duration-s`` safety valve fires)."""
    if not args.worker_id or not args.connect:
        print("--role worker needs --worker-id and --connect HOST:PORT",
              file=sys.stderr)
        return 2
    cfg = _fleet_runtime_overrides(args, _config(args))
    from fmda_tpu_torch.device import resolve_device

    device = resolve_device(args.device)  # raises without a card
    from fmda_tpu_torch.obs.device import configure_device_obs
    from fmda_tpu_torch.obs.trace import configure_tracing

    if args.trace or args.trace_out:
        configure_tracing(enabled=True, sample_rate=args.trace_sample)
    # [profiling] before the pool is built, so the ledger books the
    # warm-up flushes' launches
    configure_device_obs(cfg.profiling)
    from fmda_tpu_torch.config import (
        TOPIC_FLEET_PREDICTION,
        fleet_worker_topic,
    )
    from fmda_tpu_torch.fleet.wire import BusServer, SocketBus
    from fmda_tpu_torch.fleet.worker import FleetWorker
    from fmda_tpu_torch.obs.observability import Observability
    from fmda_tpu_torch.stream.bus import InProcessBus

    # every worker of one topology builds the same weights from --seed
    model_cfg = _carrier_config(cfg, args, cfg.features.n_features)
    state = _seeded_state(model_cfg, args.seed)
    wire_format = cfg.fleet.wire_format
    bus = SocketBus.connect(args.connect, wire_format=wire_format)
    data_bus = data_server = data_address = None
    if not args.shared_bus:
        # worker-hosted data plane (the default): this process serves its
        # own inbox and results bus; the router links to it directly, so
        # the serving hot loop never crosses a socket
        data_bus = InProcessBus(
            (fleet_worker_topic(args.worker_id), TOPIC_FLEET_PREDICTION))
        data_server = BusServer(data_bus, host=cfg.fleet.host,
                                wire_format=wire_format).start()
        data_address = data_server.address
    # split-topology workers re-dial the control bus after a router or
    # broker restart (the data plane is local, serving never stops);
    # shared-bus workers exit cleanly after the grace instead
    reconnect = (None if args.shared_bus
                 else (lambda: SocketBus.connect(
                     args.connect, wire_format=wire_format)))
    worker = FleetWorker(
        args.worker_id, bus, model_cfg, state,
        config=cfg.fleet, runtime=cfg.runtime, capacity=args.sessions,
        data_bus=data_bus, data_address=data_address,
        reconnect_fn=reconnect, device=device, qos=_worker_qos(cfg))
    # every series this worker exports carries a `process` label, so a
    # fleet-wide scrape never collides
    obs = Observability(cfg.observability, process=args.worker_id)
    obs.track_fleet(worker.gateway)
    bus.bind_metrics(obs.registry)
    if args.metrics_port is not None:
        server = obs.start_server(port=args.metrics_port)
        # announced in every liveness message: the router's fleet
        # aggregator scrapes exactly the addresses heartbeats carry
        worker.heartbeater.announce["metrics"] = server.url
        print(f"worker {args.worker_id} metrics: {server.url}/metrics",
              file=sys.stderr)
    try:
        stats = worker.run(
            duration_s=args.duration_s if args.duration_s else None)
    finally:
        obs.close()
        if data_server is not None:
            data_server.stop()
        bus.close()
    out = {"worker": args.worker_id, "stats": stats, "device": str(device),
           **worker.metrics.summary()}
    _maybe_write_trace(args, out)
    print(json.dumps(out, indent=2))
    return 0


def _fleet_worker_ids(args, cfg):
    n = args.workers if args.workers is not None else cfg.fleet.n_workers
    return [f"{cfg.fleet.worker_prefix}{i}" for i in range(n)]


def _cmd_fleet_broker(args) -> int:
    """serve-fleet --role broker: host the topology's bus and bus server
    and nothing else (the local stand-in for a Kafka broker).  No card,
    no torch.  Runs until killed or ``--duration-s`` elapses."""
    from fmda_tpu_torch.config import DEFAULT_TOPICS, fleet_topics
    from fmda_tpu_torch.fleet.launcher import _build_local_bus
    from fmda_tpu_torch.fleet.wire import BusServer

    # one connection-serving thread per client, each doing short frame
    # work: the default 5 ms GIL switch interval turns every request
    # into milliseconds of queueing under concurrency
    sys.setswitchinterval(0.0005)
    cfg = _fleet_wire_override(args, _config(args))
    topics = tuple(DEFAULT_TOPICS) + fleet_topics(_fleet_worker_ids(args,
                                                                    cfg))
    bus = _build_local_bus(cfg, topics)
    port = args.listen if args.listen is not None else cfg.fleet.port
    server = BusServer(bus, host=cfg.fleet.host, port=port,
                       wire_format=cfg.fleet.wire_format).start()
    # the one line launchers parse to find the ephemeral port
    print(f"BROKER {server.address}", flush=True)
    deadline = (time.monotonic() + args.duration_s
                if args.duration_s else None)
    try:
        while deadline is None or time.monotonic() < deadline:
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def _fleet_telemetry(args, cfg):
    """Router-side fleet telemetry (store, aggregator, SLO engine, flight
    recorder: :mod:`fmda_tpu_torch.obs.aggregate`) for --role
    router/local, or None when ``[slo]`` disables it.  ``--postmortem-dir``
    overrides the config's bundle directory."""
    if not cfg.slo.enabled:
        return None
    from fmda_tpu_torch.obs.aggregate import FleetTelemetry

    slo_cfg = cfg.slo
    if args.postmortem_dir:
        slo_cfg = dataclasses.replace(slo_cfg,
                                      postmortem_dir=args.postmortem_dir)
    return FleetTelemetry(slo_cfg)


def _cmd_fleet_router(args) -> int:
    """serve-fleet --role router: the routing, membership and migration
    loop on a bus-only host (no card, no torch).  With ``--connect`` it
    joins a broker's bus; otherwise it hosts the bus and bus server
    itself (``--listen``)."""
    cfg = _fleet_wire_override(args, _config(args))
    from fmda_tpu_torch.fleet.router import FleetRouter

    if args.trace or args.trace_out:
        from fmda_tpu_torch.obs.trace import configure_tracing

        configure_tracing(enabled=True, sample_rate=args.trace_sample)
    server = None
    if args.connect:
        from fmda_tpu_torch.fleet.wire import SocketBus

        bus = SocketBus.connect(args.connect,
                                wire_format=cfg.fleet.wire_format)
        fleet_cfg = cfg.fleet
    else:
        from fmda_tpu_torch.config import DEFAULT_TOPICS, fleet_topics
        from fmda_tpu_torch.fleet.launcher import _build_local_bus
        from fmda_tpu_torch.fleet.wire import BusServer

        topics = tuple(DEFAULT_TOPICS) + fleet_topics(
            _fleet_worker_ids(args, cfg))
        bus = _build_local_bus(cfg, topics)
        fleet_cfg = dataclasses.replace(
            cfg.fleet, port=(args.listen if args.listen is not None
                             else cfg.fleet.port))
        server = BusServer(bus, host=fleet_cfg.host, port=fleet_cfg.port,
                           wire_format=fleet_cfg.wire_format).start()
        print(f"router bus server on {server.address}; start workers "
              f"with: python -m fmda_tpu_torch serve-fleet --role worker "
              f"--connect {server.address} --worker-id w<N>",
              file=sys.stderr)
    router = FleetRouter(bus, fleet_cfg, n_features=cfg.features.n_features)
    telemetry = _fleet_telemetry(args, cfg)
    # no actuator: a bare router cannot spawn workers, so the autoscale
    # loop stays off and the batching loop retunes through the router
    plane = _control_plane(args, cfg, telemetry, router=router)
    tele_server = None
    if telemetry is not None and args.metrics_port is not None:
        # the router's own scrape surface: fleet-level series (/query),
        # the SLO alert document (/alerts) and an SLO-aware /healthz
        tele_server = telemetry.start_server(port=args.metrics_port)
        print(f"router telemetry: {tele_server.url}/metrics "
              f"(query, alerts, healthz)", file=sys.stderr)
    deadline = (time.monotonic() + args.duration_s
                if args.duration_s else None)
    try:
        while deadline is None or time.monotonic() < deadline:
            router.pump()
            if telemetry is not None:
                # cadence-gated fold (one clock read when not due)
                telemetry.maybe_collect(router)
            if plane is not None:
                plane.maybe_tick()
            time.sleep(0.005)
    except KeyboardInterrupt:
        pass
    finally:
        router.stop_workers()
        # keep pumping briefly so the workers' drain and goodbye (final
        # stats) make it into the summary: stop_workers only sends stop
        grace = time.monotonic() + 5.0
        try:
            while router.membership.workers and time.monotonic() < grace:
                router.pump()
                time.sleep(0.02)
        except (ConnectionError, OSError):
            pass
        if telemetry is not None:
            telemetry.close()
        if tele_server is not None:
            tele_server.stop()
        if server is not None:
            server.stop()
    out = router.summary()
    out["n_features"] = router.n_features
    if telemetry is not None:
        out["alerts"] = telemetry.alerts()["firing"]
    if plane is not None:
        out["control"] = plane.status()
    _maybe_write_trace(args, out)
    print(json.dumps(out, indent=2, default=str))
    return 0


def _cmd_fleet_chaos(args, cfg) -> int:
    """serve-fleet --role local --chaos-plan: the chaos soak — the whole
    topology under a fault plan (kill/revive workers, router takeover,
    bus blips, link partitions; :mod:`fmda_tpu_torch.chaos.soak`),
    hard-gating the never-abort contract.  Exit 1 iff a gate fails."""
    from fmda_tpu_torch.chaos.plan import FaultPlan, plan_from_config
    from fmda_tpu_torch.chaos.soak import run_chaos_soak

    worker_ids = _fleet_worker_ids(args, cfg)
    if args.chaos_plan == "generate":
        plan = plan_from_config(cfg.chaos, worker_ids, n_steps=args.ticks)
    else:
        plan = FaultPlan.load(args.chaos_plan)
    out = run_chaos_soak(
        plan,
        n_workers=len(worker_ids),
        n_sessions=args.sessions,
        hidden=args.hidden,
        seed=args.seed,
        duty=args.duty,
        slow_fraction=args.slow_fraction,
        slow_duty=args.slow_duty,
        burst_every=args.burst_every,
        compare_unfaulted=not args.chaos_no_reference,
        config=cfg,
        device=args.device,
    )
    print(json.dumps(out, indent=2, default=str))
    return 0 if out["gates_ok"] else 1


def cmd_chaos_pipeline(args) -> int:
    """chaos-pipeline: the data-plane chaos soak — synthetic feeds → join
    engine → journaled warehouse → Predictor, in-process, under a seeded
    fault plan (feed outage, warehouse outage, engine kill;
    :mod:`fmda_tpu_torch.chaos.pipeline`), hard-gating the never-abort
    contract for the whole pipeline.  The Predictor runs on the card
    unless ``--device cpu`` (``--no-predictor`` needs none).  Exit 1 iff
    a gate fails."""
    from fmda_tpu_torch.chaos.pipeline import (
        generate_pipeline_plan,
        run_pipeline_soak,
    )
    from fmda_tpu_torch.chaos.plan import FaultPlan

    cfg = _config(args)
    cc = cfg.chaos
    seed = args.seed if args.seed is not None else cc.seed
    if args.plan:
        plan = FaultPlan.load(args.plan)
    else:
        plan = generate_pipeline_plan(
            seed, args.rounds,
            feed_outages=cc.feed_outages,
            feed_outage_steps=cc.feed_outage_steps,
            warehouse_outages=cc.warehouse_outages,
            warehouse_outage_steps=cc.warehouse_outage_steps,
            engine_kills=cc.engine_kills,
            engine_kill_steps=cc.engine_kill_steps,
            settle_steps=cc.settle_steps)
    out = run_pipeline_soak(
        plan,
        seed=seed,
        rounds=args.rounds,
        predictor=not args.no_predictor,
        compare_unfaulted=not args.no_reference,
        device=args.device,
    )
    print(json.dumps(out, indent=2, default=str))
    return 0 if out["gates_ok"] else 1


def _cmd_fleet_local(args) -> int:
    """serve-fleet --role local: the one-command topology.  Spawns N
    worker processes (``--device`` passes through; each opens its own
    CUDA context on the card), runs the router inline, drives the
    synthetic fleet load (or ``--replay``) through the router and prints
    the aggregate and per-worker stats."""
    import os

    from fmda_tpu_torch.fleet.launcher import (
        launch_local_fleet,
        spawn_supported,
    )
    from fmda_tpu_torch.runtime.loadgen import (
        FleetLoadConfig,
        run_fleet_load,
    )

    cfg = _fleet_wire_override(args, _config(args))
    if not spawn_supported():
        print(json.dumps(
            {"skipped": "subprocess spawn unavailable on this host"}))
        return 0
    if args.chaos_plan:
        return _cmd_fleet_chaos(args, cfg)
    if args.trace or args.trace_out or args.trace_dir:
        from fmda_tpu_torch.obs.trace import configure_tracing

        configure_tracing(enabled=True, sample_rate=args.trace_sample)
    n = args.workers if args.workers is not None else cfg.fleet.n_workers
    topo = launch_local_fleet(
        n_workers=n, config=cfg, hidden=args.hidden, seed=args.seed,
        capacity_per_worker=args.sessions, bucket_sizes=_bucket_sizes(args),
        max_linger_ms=args.max_linger_ms, window=args.window,
        trace_dir=args.trace_dir, device=args.device)
    telemetry = _fleet_telemetry(args, cfg)
    plane = None
    if telemetry is not None:
        from fmda_tpu_torch.control import LocalFleetActuator

        plane = _control_plane(
            args, cfg, telemetry, router=topo.router,
            actuator=LocalFleetActuator(topo),
            initial_linger_ms=args.max_linger_ms,
            bucket_sizes=_bucket_sizes(args))
    tele_server = None
    if telemetry is not None and args.metrics_port is not None:
        tele_server = telemetry.start_server(port=args.metrics_port)
        print(f"fleet telemetry: {tele_server.url}/metrics "
              f"(query, alerts, healthz, control)", file=sys.stderr)

    def on_round(r):
        telemetry.maybe_collect(topo.router)
        if plane is not None:
            plane.maybe_tick()

    tenant_classes, tenant_weights = _tenant_mix(args)
    try:
        if args.replay:
            swap_params = None
            if args.hot_swap:
                # the workers' stack from the next seed: the same shapes,
                # other weights
                swap_params = _seeded_state(
                    _carrier_config(cfg, args, _replay_width(cfg)),
                    args.seed + 1)
            out = _run_replay(
                topo.router, cfg, args, swap_params=swap_params,
                is_router=True,
                extra_on_round=on_round if telemetry is not None else None)
            if args.hot_swap:
                # the router's view of who acked which version: the
                # zero-downtime proof is spread 0 with sessions intact
                fleet = topo.router.summary()
                out.setdefault("hot_swap", {})
                out["hot_swap"]["weights_versions"] = fleet.get(
                    "weights_versions")
                out["hot_swap"]["weights_version_spread"] = fleet.get(
                    "weights_version_spread")
        else:
            out = run_fleet_load(topo.router, FleetLoadConfig(
                n_sessions=args.sessions, n_ticks=args.ticks,
                duty=args.duty, seed=args.seed,
                storm_every=args.storm_every,
                storm_fraction=args.storm_fraction,
                burst_every=args.burst_every,
                burst_rounds=args.burst_rounds,
                slow_fraction=args.slow_fraction,
                slow_duty=args.slow_duty,
                tenant_classes=tenant_classes,
                tenant_weights=tenant_weights),
                on_round=on_round if telemetry is not None else None)
        if telemetry is not None:
            telemetry.collect(topo.router)  # the final fold
    finally:
        worker_stats = topo.shutdown()
        if telemetry is not None:
            telemetry.close()
        if tele_server is not None and args.metrics_hold_s <= 0:
            tele_server.stop()
    out["workers"] = n
    out["worker_stats"] = worker_stats
    out["table_version"] = topo.router.table.version
    if telemetry is not None:
        out["alerts"] = telemetry.alerts()["firing"]
        out["fleet"] = {
            g["name"]: g["value"] for g in telemetry.fleet_gauges()}
    if plane is not None:
        out["control"] = plane.status()
    if args.trace_dir:
        from fmda_tpu_torch.obs.trace import default_tracer

        with open(os.path.join(args.trace_dir, "router.json"), "w") as fh:
            json.dump(default_tracer().chrome(), fh)
        out["trace_dir"] = args.trace_dir
        print(f"per-process traces in {args.trace_dir}; merge with "
              f"`python -m fmda_tpu_torch trace --merge {args.trace_dir}`",
              file=sys.stderr)
    _maybe_write_trace(args, out)
    print(json.dumps(out, indent=2, default=str), flush=True)
    if tele_server is not None and args.metrics_hold_s > 0:
        # the endpoint outlives the load, so /alerts and /query can be
        # read against the run's final state
        print(f"holding fleet telemetry endpoint for "
              f"{args.metrics_hold_s:.0f}s", file=sys.stderr, flush=True)
        time.sleep(args.metrics_hold_s)
        tele_server.stop()
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
                        "runtime; the multi-host topology "
                        "(fmda_tpu_torch.fleet) splits into 'broker' (bus "
                        "and bus server only, no card), 'router' (session "
                        "routing, membership, migration; no card, no "
                        "torch), 'worker' (one slot-range owner on the "
                        "card) and 'local' (one command: N workers "
                        "spawned, router inline, synthetic load)")
    p.add_argument("--workers", type=int, default=None,
                   help="worker-process count for --role local/router/"
                        "broker (default: config fleet.n_workers)")
    p.add_argument("--listen", type=int, default=None,
                   help="bus-server port for --role router/broker (0 = "
                        "ephemeral; default: config fleet.port)")
    p.add_argument("--connect", default=None, metavar="HOST:PORT",
                   help="the bus server to join, for --role worker (or a "
                        "router that joins a broker)")
    p.add_argument("--worker-id", default=None,
                   help="this worker's id (--role worker); the router "
                        "routes its slot-range to fleet_ticks_<id>")
    p.add_argument("--shared-bus", action="store_true",
                   help="--role worker: do the data plane on the shared "
                        "--connect bus too, instead of hosting this "
                        "worker's own inbox/results bus")
    p.add_argument("--wire-format", default=None,
                   choices=["auto", "binary", "json"],
                   help="frame encoding on every SocketBus link "
                        "(overrides [fleet] wire_format; json = the "
                        "rollback format)")
    p.add_argument("--duration-s", type=float, default=0.0,
                   help="safety-valve runtime bound for --role "
                        "worker/router/broker (0 = until stopped)")
    p.add_argument("--no-controller", action="store_true",
                   help="--role router/local: disable the adaptive "
                        "control plane (fmda_tpu_torch.control; on by "
                        "default whenever fleet telemetry is) — fixed "
                        "linger, no autoscaling, global oldest-drop "
                        "shedding")
    p.add_argument("--tenant-mix", default=None,
                   metavar="CLASS:WEIGHT,...",
                   help="--role local (and --replay): tenant-labeled "
                        "traffic mix, e.g. 'gold:1,standard:4' — sessions "
                        "are assigned a priority class weight-"
                        "proportionally and opened labeled (per-tenant "
                        "QoS applies when [control] tenant_classes "
                        "configures the policy)")
    p.add_argument("--chaos-plan", default=None, metavar="generate|FILE",
                   help="--role local: run the chaos soak under a fault "
                        "plan ('generate' = the [chaos] section's seeded "
                        "plan over --ticks steps; else a plan JSON file); "
                        "exit 1 iff a never-abort gate fails")
    p.add_argument("--chaos-no-reference", action="store_true",
                   help="with --chaos-plan: skip the unfaulted reference "
                        "run (drops the bit-identity gate)")
    p.add_argument("--trace-dir", default=None, metavar="DIR",
                   help="--role local: enable tracing in every process "
                        "and write one trace file per process into DIR "
                        "(merge: `python -m fmda_tpu_torch trace --merge "
                        "DIR`)")
    p.add_argument("--postmortem-dir", default=None, metavar="DIR",
                   help="--role router/local: flight-recorder bundle "
                        "directory (overrides [slo] postmortem_dir): an "
                        "SLO alert firing dumps a rotated postmortem "
                        "bundle there")
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
                        "the run (0 = ephemeral); for --role router/local "
                        "this is the fleet telemetry endpoint (with "
                        "/query and /alerts)")
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
    p.add_argument("--shard-pool", action="store_true", default=None,
                   help="split the session pool's slots over the dp axis of "
                        "the configured [mesh] on the visible cards "
                        "(runtime.shard_pool; a 1-device mesh is the "
                        "unsharded pool)")
    p.set_defaults(fn=cmd_serve_fleet)


def _add_chaos_pipeline(sub, common) -> None:
    p = sub.add_parser(
        "chaos-pipeline", parents=[common],
        help="data-plane chaos soak: feeds -> engine -> journaled "
             "warehouse -> Predictor under a seeded fault plan; exit 1 "
             "iff a never-abort gate fails")
    p.add_argument("--seed", type=int, default=None,
                   help="plan + market seed (default: [chaos] seed)")
    p.add_argument("--rounds", type=int, default=30,
                   help="virtual steps the plan schedules over")
    p.add_argument("--plan", default=None, metavar="FILE",
                   help="explicit fault-plan JSON instead of the seeded "
                        "data-plane schedule (the reproduction path)")
    p.add_argument("--no-predictor", action="store_true",
                   help="skip the Predictor stage (no card, no torch; "
                        "drops the probes-served gate)")
    p.add_argument("--no-reference", action="store_true",
                   help="skip the unfaulted reference replay (faster; "
                        "drops the bit-identity gate)")
    p.set_defaults(fn=cmd_chaos_pipeline)


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
    _add_chaos_pipeline(sub, common)
    from fmda_tpu_torch.obs.report import add_parsers

    add_parsers(sub, common)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
