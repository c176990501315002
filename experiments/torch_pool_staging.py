#!/usr/bin/env python3
"""The session pool's flush with two ways of staging its slots and rows,
in one process on one card.

    python3 experiments/torch_pool_staging.py [--flushes N] [--rounds R]

- ``pinned``: the pool's own staging (``SessionPool._stage``): the slots
  in the dtype their reader takes and the rows, packed into one pinned
  buffer and sent by one non-blocking copy;
- ``pageable``: a blocking ``.to(device)`` of the int64 slots and one of
  the float32 rows (each waits for the stream), as the gru and lstm pool
  staged a flush before the fleet gateway.

For gru and lstm at full width (``FrameworkConfig().model``, one layer,
unidirectional), ``SessionPool(capacity=128, window=30)`` with 64
sessions and seeded random rows: each round times N blocking flushes
(``SessionPool.step``) of each way, N stagings alone (the card idle
before each), and the fleet gateway's default load (``FleetGateway``
over a fresh pool, ``RuntimeConfig()``'s batching, pipeline depth 1,
``run_fleet_load(FleetLoadConfig())``: 64 sessions x 100 rounds), in the
order pinned, pageable, pageable, pinned, after a warm-up of both.
Prints one JSON line per cell and round (the host clock's median and p99
per flush and the median per staging, in ms, and the gateway's ticks/s,
each way), then one line per cell with the medians over the rounds.
Host times spread between calls, so compare the ways only inside one
run.  Needs a CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CELLS = ("gru", "lstm")
SESSIONS = 64
ORDER = ("pinned", "pageable", "pageable", "pinned")


def make_model(cell: str):
    from fmda_tpu_torch.config import FrameworkConfig
    from fmda_tpu_torch.models import build_model

    model_cfg = dataclasses.replace(FrameworkConfig().model, cell=cell,
                                    bidirectional=False, dropout=0.0)
    return model_cfg, build_model(
        model_cfg, generator=torch.Generator().manual_seed(0)).state_dict()


def new_pool(model_cfg, state, way: str):
    """A fresh pool staging its flushes the given way."""
    from fmda_tpu_torch.config import FrameworkConfig
    from fmda_tpu_torch.runtime import SessionPool

    rt = FrameworkConfig().runtime
    pool = SessionPool(model_cfg, state, capacity=rt.capacity,
                       window=rt.window, device="cuda")
    if way == "pageable":
        pool._stage = pageable_stage(pool)
    return pool


def fleet_ticks_per_s(model_cfg, state, way: str) -> float:
    """The fleet gateway's default load over a fresh pool: ticks/s."""
    from fmda_tpu_torch.config import DEFAULT_TOPICS, FrameworkConfig
    from fmda_tpu_torch.runtime import (
        BatcherConfig, FleetGateway, FleetLoadConfig, run_fleet_load)
    from fmda_tpu_torch.stream import InProcessBus

    rt = FrameworkConfig().runtime
    gateway = FleetGateway(
        new_pool(model_cfg, state, way),
        InProcessBus(DEFAULT_TOPICS, capacity=1 << 20),
        batcher_config=BatcherConfig(bucket_sizes=rt.bucket_sizes,
                                     max_linger_s=rt.max_linger_ms / 1e3),
        queue_bound=rt.queue_bound, pipeline_depth=1)
    return run_fleet_load(gateway, FleetLoadConfig())["ticks_per_s"]


def pageable_stage(pool):
    """The blocking staging: slots and rows each by ``.to(device)``."""
    def stage(slots, rows):
        return (torch.as_tensor(rows).to(pool.device),
                torch.as_tensor(slots).to(pool.device))
    return stage


def time_flushes(pool, slots, rows, n: int):
    ms = []
    for i in range(n):
        t = time.perf_counter()
        pool.step(slots, rows[i % len(rows)])
        ms.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ms)), float(np.percentile(ms, 99))


def time_stagings(pool, slots, rows, n: int) -> float:
    """The median host time of the staging alone, the card idle before
    each."""
    ms = []
    with torch.inference_mode():
        for i in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pool._stage(slots, rows[i % len(rows)])
            ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(ms))


def main(flushes: int, rounds: int) -> int:
    if not torch.cuda.is_available():
        print("torch_pool_staging: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    metrics = ("p50_ms", "stage_ms", "fleet_ticks_per_s")
    for cell in CELLS:
        model_cfg, state = make_model(cell)
        pools = {w: new_pool(model_cfg, state, w) for w in set(ORDER)}
        for pool in pools.values():  # the same slots in each
            slots = np.array([pool.alloc(f"s{i}").slot
                              for i in range(SESSIONS)], np.int64)
        rows = rng.random((16, SESSIONS, model_cfg.n_features), np.float32)
        for way, pool in pools.items():  # warm-up
            time_flushes(pool, slots, rows, 50)
            fleet_ticks_per_s(model_cfg, state, way)
        medians = {f"{w}_{m}": [] for w in pools for m in metrics}
        for r in range(rounds):
            line = {"cell": cell, "round": r, "flushes": flushes}
            for way in ORDER:
                p50, p99 = time_flushes(pools[way], slots, rows, flushes)
                for key, v in (
                        (f"{way}_p50_ms", p50), (f"{way}_p99_ms", p99),
                        (f"{way}_stage_ms", time_stagings(
                            pools[way], slots, rows, flushes)),
                        (f"{way}_fleet_ticks_per_s", fleet_ticks_per_s(
                            model_cfg, state, way))):
                    line.setdefault(key, []).append(v)
                    if key in medians:
                        medians[key].append(v)
            print(json.dumps(line), flush=True)
        summary = {k: float(np.median(v)) for k, v in medians.items()}
        print(json.dumps({"summary": cell, **summary, **{
            f"pinned_over_pageable_{m}": summary[f"pinned_{m}"]
            / summary[f"pageable_{m}"] for m in metrics}}), flush=True)
    return 0


if __name__ == "__main__":
    args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
    sys.exit(main(int(args.get("--flushes", 500)),
                  int(args.get("--rounds", 5))))
