"""fmda_tpu_torch command line: the serving slice of ``python -m fmda_tpu``.

    python -m fmda_tpu_torch backtest --warehouse W --checkpoint C [--device cpu]
    python -m fmda_tpu_torch serve    --warehouse W --checkpoint C [--device cpu]

Both read a warehouse file ``fmda_tpu`` (or this package) wrote and a port
checkpoint (:mod:`fmda_tpu_torch.train.checkpoint`), and run on the CUDA
card unless ``--device cpu`` is given.
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


def _checkpoint(args, cfg):
    from fmda_tpu_torch.train.checkpoint import latest_checkpoint

    return args.checkpoint or latest_checkpoint(
        args.checkpoint_dir if args.checkpoint_dir is not None
        else cfg.train.checkpoint_dir)


def _window_threshold(args, cfg):
    window = args.window if args.window is not None else cfg.train.window
    threshold = (args.threshold if args.threshold is not None
                 else cfg.train.prob_threshold)
    return window, threshold


def cmd_backtest(args) -> int:
    from fmda_tpu_torch.serve import backtest_from_checkpoint, trading_summary

    cfg = _config(args)
    ckpt = _checkpoint(args, cfg)
    if ckpt is None:
        print("no checkpoint found", file=sys.stderr)
        return 2
    wh = _warehouse(args.warehouse, cfg)
    window, threshold = _window_threshold(args, cfg)
    result = backtest_from_checkpoint(
        wh, ckpt, dataclasses.replace(cfg.model, n_features=len(wh.x_fields)),
        window=window, threshold=threshold, device=args.device)
    m = result.metrics
    print(f"backtest over {len(result.probabilities)} rows: "
          f"accuracy={float(m.accuracy):.3f} hamming={float(m.hamming):.3f}")
    print(f"{'label':>8} {'signals':>8} {'hits':>6} {'precision':>10} "
          f"{'recall':>7} {'edge':>7}")
    for label, s in trading_summary(result).items():
        print(f"{label:>8} {s.signals:>8} {s.hits:>6} {s.precision:>10.3f} "
              f"{s.recall:>7.3f} {s.edge:>+7.3f}")
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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="fmda_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument(
        "--config", default=None, metavar="JSON",
        help="FrameworkConfig overrides as JSON (the fmda_tpu schema; the "
             "features/warehouse/model/train sections are read)")
    common.add_argument(
        "--device", default=None,
        help="torch device (default: cuda; pass 'cpu' to run the plain "
             "PyTorch path without a card)")
    sub = parser.add_subparsers(dest="command", required=True)

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
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
