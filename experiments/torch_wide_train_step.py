#!/usr/bin/env python3
"""A ``flagship_wide`` training step of the port on the card: the JAX
package's bench.py shape (H = 1024, bf16, batch 512, T = 30, the model's
features, dropout 0.5 with spatial dropout), every scan on the wide route,
one ``Trainer.train_step`` at a time on a placed batch of seeded random
windows.

    python3 experiments/torch_wide_train_step.py [--root DIR] [--cell gru]
                                                 [--steps N] [--out FILE]

``--root`` names the directory the package is imported from (default: the
checkout this file is in), so one call can time an unpacked parent tree
beside this one, alternated (parent, change, change, parent).  After 3
warm-up steps, ``--steps`` steps (default 20), each bracketed by CUDA
events (device ms, the queue not primed: what the step's launches take
end to end) and by the host's clock to a synchronize (a caller's wait);
the medians, the range, and each kernel's launches a step
(``ops.launch_counts``).  One JSON line, also written to FILE when
``--out`` names one.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

WARMUP = 3


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--cell", default="gru", choices=("gru", "lstm"))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_wide_train_step: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from fmda_tpu_torch import ops
    from fmda_tpu_torch.config import FrameworkConfig, TrainConfig
    from fmda_tpu_torch.data.pipeline import Batch
    from fmda_tpu_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = FrameworkConfig()
    model_cfg = dataclasses.replace(cfg.model, cell=args.cell,
                                    hidden_size=1024, dtype="bfloat16",
                                    dropout=0.5, spatial_dropout=True)
    batch_size, window = 512, cfg.train.window
    trainer = Trainer(model_cfg, TrainConfig(batch_size=batch_size,
                                             window=window, epochs=1),
                      device="cuda")
    rng = np.random.default_rng(0)
    batch = trainer.place(Batch(
        rng.normal(size=(batch_size, window, model_cfg.n_features)).astype(
            np.float32),
        (rng.random((batch_size, model_cfg.output_size)) < 0.5).astype(
            np.float32),
        np.ones(batch_size, np.float32)))
    state = trainer.init_state()
    t_build = time.perf_counter()
    for _ in range(WARMUP):
        loss, _ = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t_build
    ops.reset_launch_counts()
    device_ms, wait_ms = [], []
    for _ in range(args.steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        loss, _ = trainer.train_step(state, batch)
        end.record()
        torch.cuda.synchronize()
        wait_ms.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))
    counts = {k: v // args.steps for k, v in ops.launch_counts().items()
              if v}
    row = dict(root=root, package=os.path.dirname(os.path.dirname(
                   os.path.abspath(ops.__file__))), cell=args.cell,
               card=card_line(),
               batch=batch_size, steps=window, hidden=1024, dtype="bfloat16",
               timed_steps=args.steps, warmup_s=warmup_s,
               loss=float(loss), finite=bool(np.isfinite(float(loss))),
               device_ms=statistics.median(device_ms),
               device_ms_range=[min(device_ms), max(device_ms)],
               wait_ms=statistics.median(wait_ms),
               wait_ms_range=[min(wait_ms), max(wait_ms)],
               launches_per_step=counts)
    text = json.dumps(row)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0 if row["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
