#!/usr/bin/env python3
"""Chip smoke for fmda_tpu_torch: the quickest proof that the port starts,
builds its kernels, serves and trains correctly on a CUDA card (an H100).

    python3 chip_smoke.py            # from the repository root, one card

Phases, each printed as one JSON line, each fatal on failure:

1. ``device``: the card, its power limit, the torch/CUDA versions.
   Then ``lint``, on the host: ``python -m fmda_tpu_torch lint --json`` in
   a subprocess, the static-analysis gate over the port's own tree
   against this host's torch (a CUDA build): exit 0, no new finding, no
   torch symbol of the port that this torch lacks, within LINT_BUDGET_S;
   one line ``{"cell": "lint", "modules", "new", "drift_symbols",
   "torch", "seconds"}``.
2. ``build``: nvcc builds the one library that holds every kernel (the
   GRU and LSTM forward and backward scans, the SSM step and the fused SSM
   serve tick, the flash attention forward, its fused backward and its
   dK/dV and dQ sweeps) from
   ``fmda_tpu_torch/csrc`` for sm_90a, one nvcc per source, all started
   together.
3. ``kernel``: each kernel against its plain PyTorch version on the card,
   at the shapes its paths use (and wider: each forward scan at H = 33,
   64, 128 and 512 and from a strided projection, every branch of its
   plan, named on its line as ``branch``; the backward sweeps at H = 128,
   past their register layout; the SSM
   step at every pool bucket, in bf16, from a strided projection and at
   (256, 512); the fused SSM serve tick (``kernel ssm_tick``: a whole
   flush, every layer, state and positions in place) at buckets 1-128, in
   bf16, at two layers and padded through a repeated padding slot, and one
   session's bits alone and in a bucket of 64; the scans and the flash
   kernels at the multi-ticker batch of 800 too; the flash kernels at the
   model's (256, 4, 30, 8) in f32 and bf16, causal or not, with and without
   a key mask, at the Predictor's batch 1, at T = 1024 and at D = 64 and
   512, each line with the plan its launch took: the fused backward where
   a CTA holds whole heads, the two sweeps at T = 1024 and D = 512; each
   backward's second call must give the same bits, and no backward
   instance may spill), with times, the
   roofline bound and the library yardstick (cuDNN, SDPA) beside it where
   one exists.  Each backward scan is two kernels, the serial sweep and the
   weight gradient (``scan_dw``), timed apart too (``sweep_ms``,
   ``dw_ms``); a second call of a scan must give the same bits.
   ``wide``: the wide scan route, the counterpart of the JAX package's
   lax.scan path past the Pallas envelope (``ops/wide_scan.py``: a cuBLAS
   product and a fused gate kernel of ``csrc/scan_wide.cu`` a step).
   ``wide rule``: ``kernel_supported`` against the library's plan query
   (the kernel pair wherever its forward's plan holds W_hh on chip, the
   wide route wherever it reads W_hh from device memory or passes the
   hidden limit).
   ``wide persist plan``: the persistent LSTM scans' plan query against
   its Python copy (``_cuda_lib.persist_plan``) on the card's figures.
   ``wide kernel``: each of the four gate kernels (GRU and LSTM, forward
   and backward) against its plain version at (512, 1024) bf16 and (256,
   512) f32, masked and not, ms beside its bound.  ``wide persist``: the
   LSTM route's persistent scans (``csrc/lstm_persist.cu``, one launch a
   direction: forward and the backward sweep) against their plain
   versions at those shapes and B = 1, masked and not, both directions, a
   second call the same bits (bf16 within 2e-2, each output also of its own
   largest entry), ms beside the bound and the L2 bytes a step; ``wide
   persist cluster``: the same on a plan of clusters of 2 (the TMA
   multicast); ``wide persist witness``: the route's scan and gradients
   through the persistent and through the per-step kernels, each against
   a float64 scan written in this file, the persistent route no farther
   from it than the per-step route.  ``wide step plan``, ``wide step``,
   ``wide step scan``, ``wide step witness``: the GRU route's fused
   forward step (``csrc/gru_wide_step.cu``) against its plan query, its
   plain version and a float64 scan; ``wide bwd step plan``, ``wide bwd
   step``, ``wide bwd step scan``, ``wide bwd step witness``: the same for
   its fused backward step (``csrc/gru_wide_bwd_step.cu``: the product
   dhh_{t+1} W_hh and the gate gradients in one launch a step), beside W2
   and a cuBLAS mm.  ``wide route``: the route's scans forward and forward +
   backward against the same scans through the plain versions, both
   directions, beside kernel 1's (3's) device-memory branch where it runs,
   the LSTM's per-step kernels (W3, W4) and cuDNN's layer.  ``wide path``
   (after the warehouse's paths' set-up, before ``path``): the JAX
   package's ``flagship_wide`` (H = 1024, bf16, batch 512, dropout 0.5,
   spatial) for gru and for lstm: the first step's loss and gradients
   against the plain gate steps (the same dropout), ``Trainer.fit`` for an
   epoch of a 4,096-row warehouse, the checkpoint, a backtest of 4 batches
   (against the plain gate steps), the Predictor on 8 signals, and the
   bidirectional streaming core for 8 ticks (its backward re-scan of the
   30-row ring on the wide route, against the plain gate steps); kernels
   1-4 and ``scan_dw`` 0 launches, the fused GRU forward step T a scan and
   direction and its backward step T a backward call and direction (W1
   and W2 0), the LSTM's persistent scans one a scan (or a backward call)
   and direction and its gate kernels 0.  Every line carries ``route``.  The phase must take at most
   40 s (``WIDE_BUDGET_S``).
4. ``path``: the window-re-scan serving path at full width
   (``FrameworkConfig()``: H=32, F=108, window 30, float32) over a
   20,000-row warehouse: ``backtest`` at batch 256, then 32 signals through
   ``Predictor.from_checkpoint(...).poll()``, both recomputed on the CPU
   and compared.
5. ``train``: the training path at full width on the same warehouse:
   ``Trainer.fit`` for one epoch at batch 256 (dropout 0.5, spatial), a
   step breakdown, the device's busy share, then the trained checkpoint
   saved and backtested on the card.
6. ``train vs cpu``: the first 16 steps at dropout 0 on the card and on
   the CPU, per-step losses and final params compared.
7. ``stream``: carried-state streaming serving of a seeded unidirectional
   model at full width: ``StreamingPredictor`` over ``StreamingBiGRU``, one
   signal 2,000 rows in (a catch-up of 2,000 ticks), then 32 signals one
   row apart, with host pieces; recomputed on the CPU and compared.
   ``stream bidirectional``: the same through
   ``StreamingBiGRUBidirectional`` (the backward direction re-scanned every
   tick by the family's forward-scan kernel).
   The ssm core ticks through the fused serve tick, one launch a tick.
8. ``pool``: ``SessionPool(capacity=128, window=30)`` with 64 sessions,
   each with its own norms over its own slice of the warehouse: 100
   flushes of all 64, then 20 of 16 live sessions padded to 32 through the
   padding lane; flush times, session ticks/s, the card against the CPU,
   and a slot exported, freed and imported back and into a fresh pool,
   both ticking on bit-identically.  The ssm pool's flush is one launch of
   the fused tick, and at most SSM_POOL_MAX_OPS device ops.
9. ``fleet``: ``FleetGateway`` over the same pool, driven by
   ``run_fleet_load`` through FLEET_LOADS (64 sessions x 100 rounds, 128
   sessions, a ragged fleet at duty 0.5 with reconnect storms on a virtual
   clock), each at pipeline depth 1 and 0: ticks/s, total and device
   p50/p99, flushes by bucket, the busy share; both depths the same bits,
   every session's last probabilities against the same load on the CPU.
10. ``predictor fleet``: ``PredictorGateway`` over the warehouse, 2,048
   signals in bursts of 32 through ``run_predictor_load``, the device
   window ring off then on (the same bits); a bucket-1 flush the solo
   Predictor's bits, bucketed flushes within PATH_TOL of it.
11. ``train multi``: ``Trainer.fit_multi`` over 50 tickers (in-memory
   warehouses of 2,000 random-walk rows each) for one epoch in the mixed
   composition, 16 windows of every ticker a step (800 rows), launches
   against the counts of the dataset's own batches, steps back to back,
   the composer's time a batch and the busy share; for gru one epoch of
   chunk-interleaved batches of 256 too; then ``train multi vs cpu``, the
   first 8 mixed steps at dropout 0 on the card and on the CPU.
12. ``continuous``: ``ContinuousTrainer`` tailing a 4,096-row file
   warehouse as a backlog in a thread beside default fleet loads through
   a ``FleetGateway``, every round hot-swapped into it by
   ``gateway_publisher``: rounds, swaps, checkpoints and their drift
   profiles, ticks served under several versions, every tick published
   or counted dropped, the pool serving the last round's weights bit for
   bit; the fleet's ticks/s and latencies with the trainer and without
   it; then ``continuous vs cpu``, the same loop alone on both devices.

13. ``pipeline``: the reference's main path from raw feed messages to
   predictions: half a year of synthetic days (126 x 78 bars) through the bus
   and the port's ``StreamEngine`` into a file warehouse (ingest rows/s,
   the engine's step ms and stats), the ``demo`` command's train (one
   epoch at batch 256) and backtest on it, then the next day live, bar by
   bar, into the ``Predictor``, a bidirectional gru ``StreamingPredictor``
   on the trained checkpoint and an ssm one (both caught up over the corpus
   first): bar-to-prediction p50/p99 per consumer, its split, the busy
   share, the card's Predictor against the CPU's, and the golden day
   (``tests/data/golden_day.jsonl``) through the engine.
14. ``obs``: the observability plane.  The pipeline's next day, traced at
   100 % through the same bus, engine and consumers (``obs traced day``):
   every bar split into its spans (bus_publish, join, land, signal, each
   consumer's serve), their medians against the phase's own host clocks,
   and a QualityEvaluator over the Predictor's predictions.  Then tracing's
   cost on the default fleet load (gru, ssm; off, 1 % and 100 %
   alternating, OBS_LOADS loads of off and of 1 %), the device plane's cost
   on the ssm pool's flush loop (kernel ledger and memory monitor, then the
   host profiler too, against all off), a MetricsServer on 127.0.0.1:0 over a
   traced ssm fleet scraped and read by the ``trace``, ``perf`` and
   ``status`` commands (the ledger's launches, its sampled device time
   against the kernel phase's, MFU, the memory watermark, the traces), and
   a ``device_trace`` of 10 fleet flushes.
15. ``app``: the composition root.  ``default_bus`` builds the native C++
   ring bus and the engine runs the C++ join scheduler (a failed ``g++``
   build fails the phase); the pipeline's days land through an
   ``Application`` on the native bus and join and through the Python bus
   and join, every landed column the same bits (rows/s, step ms of each);
   ``app.train()``, then the Predictor from its checkpoint, an ssm
   ``StreamingPredictor`` and the batched Predictor (gru) attached and the
   next day bar by bar, one ``run_tick`` a bar (p50/p99), the consumers
   against the same consumers on the CPU; ``serve-fleet --role solo
   --cell ssm`` and ``status`` without ``--endpoint`` through the app.
16. ``replay`` (gru, ssm): ``ReplayDriver`` over ``SyntheticHistory`` (16
   tickers x 96 rounds, bucket 16) against ``run_live_reference`` at a 25
   ms cadence, byte-identical in the in-process, binary and json
   dialects; the halfway hot swap's accounting; card against CPU;
   ``WarehouseHistory`` over the app's warehouse with the quality plane
   (conservation); for gru the ``ShadowEvaluator`` (card = CPU) and
   ``serve-fleet --continuous-train --swap-guard``.
17. ``remat``: an attn training step at T = 1024 (batch 16, 10 book
   levels) with ``model.remat`` and without: gradients within 1e-5, a
   lower peak of allocated memory with remat; gru's two peaks.
18. ``multihost``: the multi-process fleet on the one card, this process
   the router, each worker a process of its own with its own CUDA
   context (``launch_local_fleet``, binary wire, buckets 8/32/64,
   capacity 128 a worker): ssm at 1 and 4 workers, 64 sessions a worker x
   100 rounds (weak scaling: ticks/s, the ratio, ``route`` p50, ``total``
   p99, the host's cores), every tick served and every loss counter 0;
   gru under the default load on 2 workers, a third added by
   ``add_worker()`` halfway, every session's seqs in order, no state lost,
   the probabilities against an unmigrated 1-worker run; then
   ``serve-fleet --role local --workers 2 --cell ssm --no-controller`` in a
   subprocess (exit 0, its trace files stitched by ``trace --merge``,
   ``status --endpoint`` against its telemetry server).  The launches
   are counted in the workers, by kernel (off their goodbye stats: kernel
   5 once a flush and no other kernel in an ssm worker, none in a gru
   worker); this process launches nothing (checked).
19. ``control``: the control plane.  ``run_capacity_model`` over real ssm
   pools (buckets 8/32, linger 2 ms, SLO 50 ms, sessions 8/16/32 x duty
   0.25/0.5/1.0, 60 rounds a cell, the controller A/B): the reference's
   schema and keys, served + shed = submitted in every cell, kernel 5
   once a flush; ``serve-fleet --role local --workers 2 --cell ssm
   --tenant-mix gold:1,standard:4`` with the controller and two tenant
   classes (per-class admits and sheds, a non-empty decision ring,
   ``status --endpoint`` printing the control section); the elastic soak
   (1..2 workers, 8 sessions, bit-identical to the fixed fleet at bucket
   1, every gate).
20. ``chaos``: the fleet chaos soak (a worker killed and revived, a
   router takeover, a link partition, a bus blip, delays; 12 sessions,
   ssm, bucket 1): every gate, nothing unaccounted, the clean sessions
   bit for bit the unfaulted run's; the data-plane soak (a feed outage,
   a warehouse outage, an engine kill) with the Predictor on the card:
   every gate, the landed rows bit for bit, kernel 1 twice a prediction,
   the probabilities against the CPU's; ``chaos-pipeline`` exits 0.
21. ``parallel``: ``fmda_tpu_torch.parallel`` on the one card.
   ``parallel sp gru``: the reference bench's ``phase_longctx_sp``
   (``bench.py:1271-1345``) at its shapes, a world of 8 rank processes
   (dp = 2 x sp = 4, gloo; each rank this script again, ``--parallel-rank``,
   loading the build phase's library and building nothing): B = 64, T =
   1024, 10 book levels a side (F = 120), H = 32, bidirectional, remat,
   clip 50, Adam 1e-3; at M = 1, 2, 4 microbatches the gradient of the
   initial params (``make_sp_grad_fn``: summed over the world, before the
   clip), then a warm-up and 4 timed steps: step ms, sequences/s, the
   speedup over M = 1 beside the bench's model ``sp*M/(sp+M-1)``; the
   gradient against the unsharded first step's (within TRAIN_TOL of the
   largest gradient: a gradient counted sp times, or divided by sp once
   too often, is off by 75 % or more of itself, which Adam's update and
   the loss would not show), the losses and final params against the same
   steps unsharded here (TRAIN_TOL), every rank's params the same bits.
   A rank's launches over the gradient and the 5 steps (6 calls), a
   direction's stage M times a call (kernel 1 forward and again for
   remat's recompute, kernel 2 and ``scan_dw`` once a stage backward):
   ``gru_scan_fwd`` 24M, ``gru_scan_bwd`` and ``scan_dw`` 12M each, every
   other kernel 0.
   ``parallel ring attn``: the same world and shapes with ``cell="attn"``
   (4 heads of 8, remat): the step beside the unsharded attn step here
   (the bench's denominator), the gradient as for gru, loss and params
   within TRAIN_TOL (the key bias held to Adam's drift); a rank's
   launches: ``flash_fwd`` once a fold, 4 folds a call (24), the
   backward's sweeps ``flash_dkv`` and
   ``flash_dq`` once a fold each (T/sp = 256 is past the fused kernel's
   128; the plan printed), ``flash_bwd`` 0. ``parallel ring causal``: a
   causal forward and backward at (4, 4, 256, 8): the rank at sp index s
   folds s + 1 blocks (``flash_fwd`` and, fused at T/sp = 64,
   ``flash_bwd`` s + 1 each; the future blocks launch nothing), within
   1e-5 of the flash op unsharded here. ``parallel dp train``: the world
   ends and two of its processes join a world of 2 of their own (no start
   of new processes): ``Trainer(mesh=)`` over the ``train vs cpu`` phase's 16
   batches of 256 (128 rows a rank) and ``train multi vs cpu``'s 8 mixed
   batches of 800, against the same steps in this process (TRAIN_TOL), a
   rank's launches kernel 1, kernel 2 and ``scan_dw`` twice a step.
   ``parallel shard pool``: ``SessionPool(mesh=)`` over a local mesh of 2
   blocks on the card (capacity 128, 64 sessions dealt round the blocks,
   100 flushes at bucket 64): ssm the unsharded pool's bits with kernel 5
   once a block a flush, gru within PATH_TOL, a 1-device mesh the
   unsharded pool's bits; ``serve-fleet --role solo --cell ssm
   --shard-pool`` exits 0.

Phases 4-6, 10 and 11 run for the BiGRU (``cell="gru"``, the default),
the BiLSTM (``cell="lstm"``), the TemporalTransformer (``cell="attn"``:
the flash kernels) and the bidirectional gated SSM (``cell="ssm"``:
parallel mode, no kernel); phases 7-9 for gru, lstm and ssm (``stream
bidirectional`` for gru and lstm); phase 12 for gru and ssm; phase 13
for the BiGRU (its streaming consumers gru and ssm); phase 14 for ssm (its
tracing cost for gru too); phase 15 for gru (its stream ssm); phase 16
for gru and ssm; phase 17 for attn and gru; phase 18 for ssm and gru;
phase 19 for ssm; phase 20 for ssm (the fleet) and gru (the Predictor);
phase 21 for gru and attn (its pool ssm and gru).
Their lines carry
``cell``.  Every kernel's launch count is reset just before each path and
read just after it, and must equal what the path should launch, every
other kernel's 0 (``scan_dw`` counts the backward scans' weight-gradient
kernel, once a backward call).  Then the ``{"kernels": [...]}`` summary,
the card line, and as the last line ``{"ok": true, "device": {...}}``.  TF32 is off
for matmuls and cuDNN, so float32 means float32 everywhere.  Exits
non-zero, and prints no result, without a card or outside the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from fmda_tpu_torch.ops.cost import (
    SCAN_SHAPES,
    flash_bound,
    scan_bound,
    scan_bwd_bound,
    ssm_bound,
    tick_bound,
)

SEED = 0
WAREHOUSE_ROWS = 20_000
SIGNALS = 32
#: the backtest batches the path's busy share is profiled over
PATH_SHARE_BATCHES = 16
BATCH = 256
#: the predictor fleet's flush buckets (RuntimeConfig.predictor_bucket_sizes)
PREDICTOR_BUCKETS = (8, 32, 64)
F32_TOL = 1e-5
BF16_TOL = 2e-2
PATH_TOL = 1e-5
#: the card against the CPU over 16 training steps at dropout 0: float32
#: sums in other orders, compounded by the steps (the target)
TRAIN_TOL = 1e-4
TRAIN_CHUNK = 2048
TRAIN_VS_CPU_STEPS = 16
#: the train breakdown's pieces, each ended by its own synchronize, against
#: the whole step (one synchronize): host times, which spread by ~15 %
BREAKDOWN_TOL = 0.25
#: scale of the backward phase's random cotangents (dh_last, dhs)
COT_SCALE = 0.1
#: timed calls a median is taken over: the kernel phases' time is mostly
#: these calls, the library's behind a long device sleep
REPS = 20
#: the device sleep before a primed call: ~1 ms, longer than a kernel
#: wrapper's host time; a cuDNN call through autograd can take longer than
#: that to enqueue on a busy host, so the library yardstick gets ~10 ms
PRIME_CYCLES = 2_000_000
LIBRARY_PRIME_CYCLES = 20_000_000

#: the lint phase's budget: a parse of the tree and torch's import
LINT_BUDGET_S = 15.0

#: the script's start, for each line's ``elapsed_s``
START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - START}), flush=True)


def check(ok: bool, message: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {message}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def phase_lint() -> dict:
    """The static-analysis gate over the port's own tree, in a subprocess
    on this host: ``python -m fmda_tpu_torch lint --json`` must exit 0 with
    no new finding and no unresolved torch symbol against this host's
    torch, within LINT_BUDGET_S.  Host only: lint touches no device."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "fmda_tpu_torch", "lint", "--json"],
        capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    seconds = time.perf_counter() - t0
    check(out.returncode in (0, 1),
          f"lint exited {out.returncode}: {out.stderr[-2000:]}")
    doc = json.loads(out.stdout)
    drift = doc["reports"]["torch_api_drift"]
    line = {"cell": "lint", "modules": doc["n_modules"],
            "new": len(doc["new"]), "drift_symbols": drift["n_symbols"],
            "torch": drift["torch_version"], "seconds": seconds}
    print(json.dumps(line), flush=True)
    check(out.returncode == 0 and doc["ok"],
          "lint is not clean: " + json.dumps(
              {k: doc[k] for k in ("new", "stale_baseline",
                                   "forbidden_baseline")})[:4000])
    check(line["new"] == 0 and line["drift_symbols"] == 0,
          f"lint: {line['new']} new findings, {line['drift_symbols']} "
          f"unresolved torch symbols: {sorted(drift['symbols'])[:20]}")
    check(seconds <= LINT_BUDGET_S,
          f"lint took {seconds:.1f} s, over its {LINT_BUDGET_S} s budget")
    return line


def time_ms(fn, *, prime: bool, prime_cycles: int = PRIME_CYCLES,
            reps: int = 0, warmup: int = 5) -> float:
    """Median of ``reps`` (REPS by default) CUDA-event times of one call,
    after ``warmup`` calls.

    ``prime`` queues a device sleep of ``prime_cycles`` before each call,
    so the host's launch overhead hides behind it whenever it is shorter:
    the result is then the device time of the call.  Unprimed, it is the
    time the caller waits for the call on an idle card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
             for _ in range(reps or REPS)]
    for start, end in pairs:
        if prime:
            torch.cuda._sleep(prime_cycles)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


@dataclasses.dataclass(frozen=True)
class Scan:
    """One recurrence's kernel pair, as the kernel phases drive it: the
    module with ``<name>_scan_fwd``/``_bwd`` and their ``_reference``s, the
    gate blocks and carried states (h; or h and c), the element-wise
    operations per (row, step, unit) of each direction, the cuDNN module
    of the same layer (a yardstick never called by the port), and where
    the kernels live and what they replace."""

    name: str
    module: object
    gates: int
    states: int
    fwd_ops: int
    bwd_ops: int
    library: type
    source: str
    replaces: tuple

    def fn(self, kind: str):
        return getattr(self.module, f"{self.name}_scan_{kind}")


def scan_specs():
    from fmda_tpu_torch.ops import gru_kernel, lstm_kernel

    return (
        Scan("gru", gru_kernel, **SCAN_SHAPES["gru"], library=torch.nn.GRU,
             source="fmda_tpu_torch/csrc/gru_scan.cu",
             replaces=("fmda_tpu/ops/pallas_gru.py:147",
                       "fmda_tpu/ops/pallas_gru.py:252")),
        Scan("lstm", lstm_kernel, **SCAN_SHAPES["lstm"],
             library=torch.nn.LSTM,
             source="fmda_tpu_torch/csrc/lstm_scan.cu",
             replaces=("fmda_tpu/ops/pallas_lstm.py:80",
                       "fmda_tpu/ops/pallas_lstm.py:195")),
    )


def scan_case_inputs(scan: Scan, c, gen, dev):
    """The forward's inputs of one case: (xp, *initial states, W_hh, b_hh)
    and the mask, uniform from ``gen``.  A ``strided`` case's xp is the
    second half of a (B, T, 2 gH) projection, as a bidirectional layer
    slices its one projection: batch and time strides of 2 gH."""
    b, t, h, dtype = c["batch"], c["steps"], c["hidden"], c["dtype"]
    scale = 1.0 / math.sqrt(h)

    def rand(*shape, s=1.0):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * s).to(dtype)

    gh = scan.gates * h
    xp = (rand(b, t, 2 * gh, s=2.0)[..., gh:] if c.get("strided")
          else rand(b, t, gh, s=2.0))
    states = [rand(b, h, s=0.5) if c["h0"] else
              torch.zeros(b, h, dtype=dtype, device=dev)
              for _ in range(scan.states)]
    w, bias = rand(gh, h, s=scale), rand(gh, s=scale)
    mask = None
    if c["masked"]:  # ragged valid lengths 1..T
        lengths = torch.randint(1, t + 1, (b,), generator=gen, device=dev)
        mask = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    return (xp, *states, w, bias), mask, rand


def library_layer(scan: Scan, c, n_features, gen, dev, *, grad=False):
    """cuDNN's layer of the same family and width, and a (B, T, F) input:
    the yardstick, input projection included."""
    lib = scan.library(n_features, c["hidden"], batch_first=True).to(
        dev, c["dtype"])
    # one contiguous weight buffer, as cuDNN wants: without it every call
    # first compacts the weights (`to` does not flatten them)
    lib.flatten_parameters()
    x = torch.rand((c["batch"], c["steps"], n_features), generator=gen,
                   device=dev).to(c["dtype"])
    return lib, x.requires_grad_(grad)


def fwd_cases(scan: Scan):
    cases = [dict(batch=b, steps=t, hidden=h, dtype=dtype, reverse=reverse,
                  masked=False, h0=False)
             for b, t, h in ((1, 30, 32), (BATCH, 30, 32), (BATCH, 30, 128))
             for dtype in (torch.float32, torch.bfloat16)
             for reverse in (False, True)]
    base = dict(batch=BATCH, steps=30, hidden=32, dtype=torch.float32)
    # every branch of the forward's plan: H = 33 (shared memory, H not a
    # multiple of the lanes' chunks, a partial last warp), 64 (shared
    # memory), 512 (device memory, one lane a unit); xp sliced from a wider
    # projection at the stream's (1, 30, 32)
    cases += [dict(base, hidden=h, reverse=False, masked=False, h0=False)
              for h in (33, 64, 512)]
    cases.append(dict(base, batch=1, reverse=True, masked=False, h0=False,
                      strided=True))
    # the predictor fleet's buckets and the multi-ticker mixed batch
    cases += [dict(base, batch=b, reverse=False, masked=False, h0=False)
              for b in (*PREDICTOR_BUCKETS, MULTI_BATCH)]
    if scan.name == "gru":
        return cases + [dict(base, reverse=True, masked=True, h0=False),
                        dict(base, reverse=False, masked=False, h0=True)]
    # the LSTM's masked rows with nonzero h0 and c0, in its register branch
    # (H = 32), its shared-memory one (H = 128 bf16) and its cluster one
    # (H = 128 f32)
    return cases + [dict(base, reverse=False, masked=True, h0=True),
                    dict(base, reverse=True, masked=True, h0=True),
                    dict(base, hidden=128, reverse=True, masked=True,
                         h0=True),
                    dict(base, hidden=128, dtype=torch.bfloat16,
                         reverse=False, masked=True, h0=True)]


def phase_kernel(scan: Scan, n_features: int, device: str = "cuda"):
    """<name>_scan_fwd against <name>_scan_reference on the card, every
    output compared, and against itself: a second call must give the same
    bits.  Each line names the branch the launcher's plan took (``branch``:
    W_hh in registers, shared memory, a cluster's shared memory or device
    memory) with its lanes a unit and rows a CTA."""
    from fmda_tpu_torch.ops import _cuda_lib

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    fwd, ref = scan.fn("fwd"), getattr(scan.module,
                                       f"{scan.name}_scan_reference")
    results = []
    for c in fwd_cases(scan):
        b, t, h, dtype = c["batch"], c["steps"], c["hidden"], c["dtype"]
        args, mask, _ = scan_case_inputs(scan, c, gen, dev)
        kw = dict(reverse=c["reverse"], mask=mask)
        plan = _cuda_lib.fwd_plan(scan.name, b, h, dtype,
                                  dev.index or 0)
        with torch.inference_mode():
            got, want = fwd(*args, **kw), ref(*args, **kw)
            again = fwd(*args, **kw)
            torch.cuda.synchronize()
            same_bits = all(torch.equal(g, a) for g, a in zip(got, again))
            err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got, want))
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
            ms = time_ms(lambda: fwd(*args, **kw), prime=True)
            call_ms = time_ms(lambda: fwd(*args, **kw), prime=False)
            plain_ms = time_ms(lambda: ref(*args, **kw), prime=True)
            library_ms = None
            if not (c["reverse"] or c["masked"] or c["h0"]
                    or c.get("strided")):
                lib, x = library_layer(scan, c, n_features, gen, dev)
                library_ms = time_ms(lambda: lib(x), prime=True,
                                     prime_cycles=LIBRARY_PRIME_CYCLES)
        bound_ms, bound_by = scan_bound(
            b, t, h, args[0].element_size(), c["masked"], gates=scan.gates,
            states=scan.states, elementwise=scan.fwd_ops)
        row = dict(batch=b, steps=t, hidden=h,
                   dtype=str(dtype).replace("torch.", ""),
                   reverse=c["reverse"], masked=c["masked"],
                   nonzero_h0=c["h0"], strided=bool(c.get("strided")),
                   branch=plan["branch"], lanes=plan["lanes"],
                   rows_per_cta=plan["rows"], max_abs_err=err, tol=tol,
                   bit_identical_rerun=same_bits,
                   ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        emit(f"kernel {scan.name}_scan_fwd", **row)
        check(finite, f"non-finite kernel output in {row}")
        check(err <= tol, f"kernel disagrees with its plain version: {row}")
        check(same_bits, f"kernel's second call differs: {row}")
        results.append(row)
    return results


def phase_kernel_bwd(scan: Scan, n_features: int, device: str = "cuda"):
    """<name>_scan_bwd against <name>_scan_bwd_reference on the card, on
    the same inputs (hs, and cs for the LSTM, from the forward kernel),
    and against itself: a second call must give the same bits.
    Cotangents of every output (h_last, c_last for the LSTM, hs) are
    uniform in +-COT_SCALE, the order of a training loss's gradient;
    errors are reported absolute and relative to each output's largest
    entry.  Beside the call's ``ms``, ``sweep_ms`` and ``dw_ms`` time its
    two parts alone: the serial sweep, and the weight gradient
    (scan_dw's kernel and the reduction of its partials) of the sweep's
    output."""
    from fmda_tpu_torch.ops.scan_dw import scan_dw

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    fwd, bwd, sweep = scan.fn("fwd"), scan.fn("bwd"), scan.fn("bwd_sweep")
    ref = getattr(scan.module, f"{scan.name}_scan_bwd_reference")
    names = ("dxp", "dh0", "dc0")[:1 + scan.states] + ("dw_hh", "db_hh")
    base = dict(batch=BATCH, steps=30, hidden=32, dtype=torch.float32,
                reverse=False, masked=False, h0=False)
    cases = [dict(base), dict(base, reverse=True),
             dict(base, masked=True, h0=True),
             dict(base, masked=True, h0=True, reverse=True),
             dict(base, dtype=torch.bfloat16),
             dict(base, dtype=torch.bfloat16, reverse=True),
             dict(base, batch=1), dict(base, batch=MULTI_BATCH),
             dict(base, hidden=128)]
    if scan.name == "lstm":  # W_hh in shared memory at H = 128 in bf16 only
        cases += [dict(base, hidden=128, dtype=torch.bfloat16),
                  dict(base, hidden=128, masked=True, h0=True)]
    results = []
    for c in cases:
        b, t, h, dtype = c["batch"], c["steps"], c["hidden"], c["dtype"]
        args, mask, rand = scan_case_inputs(scan, c, gen, dev)
        d_lasts = [rand(b, h, s=COT_SCALE) for _ in range(scan.states)]
        dhs = rand(b, t, h, s=COT_SCALE)
        kw = dict(reverse=c["reverse"], mask=mask)
        with torch.inference_mode():
            seqs = fwd(*args, **kw)[scan.states:]  # hs (, cs)
            bargs = (*args, *seqs, *d_lasts, dhs)
            got, want = bwd(*bargs, **kw), ref(*bargs, **kw)
            again = bwd(*bargs, **kw)
            torch.cuda.synchronize()
            same_bits = all(torch.equal(g, a) for g, a in zip(got, again))
            errs, rel = {}, {}
            for name, g, r in zip(names, got, want):
                check(g.shape == r.shape and g.dtype == r.dtype,
                      f"{name}: {g.shape} {g.dtype} against {r.shape} "
                      f"{r.dtype}")
                diff = (g.float() - r.float()).abs().max().item()
                errs[name] = diff
                rel[name] = diff / max(r.float().abs().max().item(), 1e-30)
            finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
            err = max(errs.values())
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            ms = time_ms(lambda: bwd(*bargs, **kw), prime=True)
            call_ms = time_ms(lambda: bwd(*bargs, **kw), prime=False)
            plain_ms = time_ms(lambda: ref(*bargs, **kw), prime=True)
            swept = sweep(*bargs, **kw)
            # the weight gradient's operand: dxp, and for the GRU its n
            # slice replaced by the sweep's round(dn_pre * r)
            tail = swept[1] if scan.name == "gru" else None
            sweep_ms = time_ms(lambda: sweep(*bargs, **kw), prime=True)
            dw_ms = time_ms(lambda: scan_dw(swept[0], args[1], seqs[0],
                                            reverse=c["reverse"], tail=tail),
                            prime=True)
        library_ms = library_fwd_bwd_ms = None
        if not (c["reverse"] or c["masked"] or c["h0"]):
            # cuDNN's backward of the same layer (input projection
            # included), alone and with its forward
            lib, x = library_layer(scan, c, n_features, gen, dev, grad=True)
            wrt = [x, *lib.parameters()]

            def outputs():
                out, state = lib(x)
                return (out, *(state if isinstance(state, tuple)
                               else (state,)))

            outs = outputs()
            cot = [torch.rand_like(o) for o in outs]
            library_ms = time_ms(lambda: torch.autograd.grad(
                outs, wrt, cot, retain_graph=True), prime=True,
                prime_cycles=LIBRARY_PRIME_CYCLES)
            library_fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(
                outputs(), wrt, cot), prime=True,
                prime_cycles=LIBRARY_PRIME_CYCLES)
        bound_ms, bound_by = scan_bwd_bound(
            b, t, h, args[0].element_size(), c["masked"], gates=scan.gates,
            states=scan.states, elementwise=scan.bwd_ops)
        row = dict(batch=b, steps=t, hidden=h,
                   dtype=str(dtype).replace("torch.", ""),
                   reverse=c["reverse"], masked=c["masked"],
                   nonzero_h0=c["h0"], max_abs_err=err, errs=errs,
                   rel_errs=rel, tol=tol, bit_identical_rerun=same_bits,
                   ms=ms, sweep_ms=sweep_ms, dw_ms=dw_ms, call_ms=call_ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   library_fwd_bwd_ms=library_fwd_bwd_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        emit(f"kernel {scan.name}_scan_bwd", **row)
        check(finite, f"non-finite backward kernel output in {row}")
        check(err <= tol,
              f"backward kernel disagrees with its plain version: {row}")
        check(same_bits, f"backward kernel's second call differs: {row}")
        results.append(row)
    return results


#: kernel 5: where it lives and what it replaces
SSM_SOURCE = "fmda_tpu_torch/csrc/ssm_step.cu"
SSM_REPLACES = "fmda_tpu/ops/pallas_ssm.py:56"
def ssm_cases():
    """Every pool bucket and the solo core's B = 1 at the model's H = 32,
    bf16, a projection read through a row stride of 4H (a slice, not
    copied), and the Pallas envelope's largest case (256, 512)."""
    f32 = dict(hidden=32, dtype=torch.float32, strided=False)
    return ([dict(f32, batch=b) for b in (1, 8, 32, 64, 128)]
            + [dict(f32, batch=64, dtype=torch.bfloat16),
               dict(f32, batch=64, strided=True),
               dict(f32, batch=256, hidden=512)])


def phase_kernel_ssm(device: str = "cuda"):
    """ssm_cell_step against ssm_cell_step_reference on the card, all four
    outputs compared, from nonzero carries."""
    from fmda_tpu_torch.ops import ssm_kernel
    from fmda_tpu_torch.ops.ssm import SSMWeights

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    results = []
    for c in ssm_cases():
        b, h, dtype = c["batch"], c["hidden"], c["dtype"]

        def rand(*shape, lo=-1.0, hi=1.0):
            u = torch.rand(shape, generator=gen, device=dev)
            return (u * (hi - lo) + lo).to(dtype)

        xp = rand(b, 4 * h if c["strided"] else 3 * h, lo=-2.0, hi=2.0)
        xp = xp[:, :3 * h]
        carry = tuple(rand(b, h, lo=-0.5, hi=0.5) for _ in range(3))
        w = SSMWeights(None, None, rand(h, lo=1.0, hi=3.0),
                       rand(h, lo=-0.3, hi=0.3), rand(h, lo=-0.5, hi=0.5),
                       rand(h, lo=2.5, hi=3.5))
        args = (xp, carry, w)
        with torch.inference_mode():
            got = ssm_kernel.ssm_cell_step(*args)
            want = ssm_kernel.ssm_cell_step_reference(*args)
            torch.cuda.synchronize()
            got, want = (got[0], *got[1]), (want[0], *want[1])
            check(all(g.shape == r.shape and g.dtype == r.dtype
                      for g, r in zip(got, want)),
                  f"ssm_step outputs {[(g.shape, g.dtype) for g in got]}")
            err = max((g.float() - r.float()).abs().max().item()
                      for g, r in zip(got, want))
            finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
            ms = time_ms(lambda: ssm_kernel.ssm_cell_step(*args), prime=True)
            call_ms = time_ms(lambda: ssm_kernel.ssm_cell_step(*args),
                              prime=False)
            plain_ms = time_ms(
                lambda: ssm_kernel.ssm_cell_step_reference(*args), prime=True)
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        bound_ms, bound_by = ssm_bound(b, h, xp.element_size())
        # no one PyTorch call computes the tick: library_ms stays None
        row = dict(batch=b, hidden=h, dtype=str(dtype).replace("torch.", ""),
                   strided=c["strided"], xp_row_stride=xp.stride(0),
                   max_abs_err=err, tol=tol, ms=ms, call_ms=call_ms,
                   plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                   bound_by=bound_by)
        emit("kernel ssm_step", **row)
        check(finite, f"non-finite ssm_step output in {row}")
        check(err <= tol, f"ssm_step disagrees with its plain version: {row}")
        results.append(row)
    return results


#: the fused tick's flushes: every pool bucket and the solo core's B = 1
#: at the model's width, bf16, two layers, a flush of 16 live lanes padded
#: to 32 through a repeated padding slot, and H = 512, whose W_ih is too
#: large to stage in shared memory (the projection reads device memory)
TICK_LIVE_PADDED = 16


def tick_cases():
    f32 = dict(dtype=torch.float32, n_layers=1, padded=False, hidden=32)
    return ([dict(f32, batch=b) for b in (1, 8, 32, 64, 128)]
            + [dict(f32, batch=64, dtype=torch.bfloat16),
               dict(f32, batch=64, n_layers=2),
               dict(f32, batch=64, n_layers=2, dtype=torch.bfloat16),
               dict(f32, batch=32, padded=True),
               dict(f32, batch=64, hidden=512)])


def tick_model(n_layers, dtype, dev, hidden=32):
    """The fused tick's weights for a seeded random ssm model at full width
    (F=108, C=4; H=32 unless given), packed as the pool packs them."""
    from fmda_tpu_torch.models import build_model
    from fmda_tpu_torch.ops import ssm_kernel
    from fmda_tpu_torch.serve.streaming import _layer_weights, serving_params

    cfg = model_config("ssm", bidirectional=False, dropout=0.0,
                       n_layers=n_layers, hidden_size=hidden)
    model = build_model(cfg, generator=torch.Generator().manual_seed(SEED))
    params = serving_params(model.state_dict(), dtype, dev)
    layers = [_layer_weights(params, False, "ssm", layer)
              for layer in range(n_layers)]
    return cfg, ssm_kernel.pack_tick_weights(
        layers, (params["linear.weight"], params["linear.bias"]))


def phase_kernel_ssm_tick(device: str = "cuda"):
    """ssm_serve_tick against ssm_serve_tick_reference on the card, over a
    pool of capacity 128 (+ the padding slot) with per-slot norms and a
    nonzero state: the probabilities of the live lanes, the state and the
    positions compared; then one session's bits in bucket 1 and bucket 64."""
    from fmda_tpu_torch.ops import ssm_kernel

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    n_slots, pad = 129, 128
    results = []
    for c in tick_cases():
        b, n_layers, dtype = c["batch"], c["n_layers"], c["dtype"]
        cfg, weights = tick_model(n_layers, dtype, dev, c["hidden"])
        feats, hidden = cfg.n_features, cfg.hidden_size
        classes = weights.head[1].shape[0]
        live = TICK_LIVE_PADDED if c["padded"] else b
        slots = torch.full((b,), pad, dtype=torch.int32, device=dev)
        slots[:live] = torch.randperm(pad, generator=gen, device=dev)[
            :live].int()
        rows = torch.randn((b, feats), generator=gen, device=dev) * 3.0
        x_min = torch.randn((n_slots, feats), generator=gen, device=dev)
        x_range = torch.rand((n_slots, feats), generator=gen,
                             device=dev) * 4.0 + 1.0
        state0 = (torch.rand((n_layers, 3, n_slots, hidden), generator=gen,
                             device=dev) - 0.5).to(dtype)
        pos0 = torch.randint(0, 1000, (n_slots,), generator=gen, device=dev)
        tensors = dict(rows=rows, slots=slots, x_min=x_min, x_range=x_range,
                       weights=weights)
        with torch.inference_mode():
            got_state, got_pos = state0.clone(), pos0.clone()
            got = ssm_kernel.ssm_serve_tick(**tensors, state=got_state,
                                            pos=got_pos)
            want_state, want_pos = state0.clone(), pos0.clone()
            want = ssm_kernel.ssm_serve_tick_reference(
                **tensors, state=want_state, pos=want_pos)
            torch.cuda.synchronize()
            check(got.shape == want.shape == (b, classes)
                  and got.dtype == torch.float32,
                  f"ssm_tick probabilities {tuple(got.shape)} {got.dtype}")
            keep = torch.ones(n_slots, dtype=torch.bool, device=dev)
            keep[pad] = False  # the padding slot's racing writes
            err = max((got[:live] - want[:live]).abs().max().item(),
                      (got_state[..., keep, :].float()
                       - want_state[..., keep, :].float()).abs().max().item())
            pos_equal = torch.equal(got_pos[keep], want_pos[keep])
            finite = bool(torch.isfinite(got[:live]).all()) and bool(
                torch.isfinite(got_state.float()).all())
            run_state, run_pos = state0.clone(), pos0.clone()

            def kernel():
                return ssm_kernel.ssm_serve_tick(**tensors, state=run_state,
                                                 pos=run_pos)

            def plain():
                return ssm_kernel.ssm_serve_tick_reference(
                    **tensors, state=run_state, pos=run_pos)

            ms = time_ms(kernel, prime=True)
            call_ms = time_ms(kernel, prime=False)
            plain_ms = time_ms(plain, prime=True)
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        bound_ms, bound_by = tick_bound(b, n_layers, feats, hidden, classes,
                                        torch.tensor([], dtype=dtype)
                                        .element_size())
        # no one PyTorch call computes the tick: library_ms stays None
        row = dict(batch=b, live=live, n_layers=n_layers, features=feats,
                   hidden=hidden, dtype=str(dtype).replace("torch.", ""),
                   padded=c["padded"], max_abs_err=err, pos_equal=pos_equal,
                   tol=tol, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
        emit("kernel ssm_tick", **row)
        check(finite, f"non-finite ssm_tick output in {row}")
        check(err <= tol and pos_equal,
              f"ssm_tick disagrees with its plain version: {row}")
        results.append(row)

    # one session, the same state, alone and in a bucket of 64: the same
    # bits
    cfg, weights = tick_model(1, torch.float32, dev)
    feats, hidden = cfg.n_features, cfg.hidden_size
    rows = torch.randn((64, feats), generator=gen, device=dev)
    slots = torch.randperm(pad, generator=gen, device=dev)[:64].int()
    x_min = torch.zeros((n_slots, feats), device=dev)
    x_range = torch.ones((n_slots, feats), device=dev)
    state0 = torch.rand((1, 3, n_slots, hidden), generator=gen,
                        device=dev) - 0.5
    lane = 17
    with torch.inference_mode():
        solo_state, solo_pos = state0.clone(), torch.zeros(
            n_slots, dtype=torch.int64, device=dev)
        solo = ssm_kernel.ssm_serve_tick(
            rows[lane:lane + 1], slots[lane:lane + 1], x_min, x_range,
            weights, solo_state, solo_pos)
        full_state, full_pos = state0.clone(), torch.zeros_like(solo_pos)
        full = ssm_kernel.ssm_serve_tick(rows, slots, x_min, x_range,
                                         weights, full_state, full_pos)
        torch.cuda.synchronize()
    s = int(slots[lane])
    same = (torch.equal(solo[0], full[lane])
            and torch.equal(solo_state[:, :, s], full_state[:, :, s]))
    emit("kernel ssm_tick bucket bits", slot=s, lane=lane, buckets=[1, 64],
         bit_identical=same)
    check(same, "a session's ssm_tick result depends on its bucket")
    return results


#: kernels 6-8: where they live and what they replace (the fused backward,
#: flash_bwd, replaces both backward kernels: the dK/dV one here, the dQ
#: one as its entry's ``also_replaces``)
FLASH_SOURCES = {"flash_fwd": "fmda_tpu_torch/csrc/flash_fwd.cu",
                 "flash_dkv": "fmda_tpu_torch/csrc/flash_attn.cu",
                 "flash_dq": "fmda_tpu_torch/csrc/flash_attn.cu",
                 "flash_bwd": "fmda_tpu_torch/csrc/flash_bwd.cu"}
FLASH_REPLACES = {"flash_fwd": "fmda_tpu/ops/pallas_attention.py:94",
                  "flash_dkv": "fmda_tpu/ops/pallas_attention.py:200",
                  "flash_dq": "fmda_tpu/ops/pallas_attention.py:265",
                  "flash_bwd": "fmda_tpu/ops/pallas_attention.py:200"}
#: the model's attention: (B, N, T, D) at batch 256, 4 heads of 8, window 30
FLASH_MAIN = (BATCH, 4, 30, 8)


def flash_cases():
    """The serving and training shape in f32 and bf16, causal or not, with
    and without a key mask (ragged valid lengths, one row fully hidden);
    the Predictor's batch 1, the predictor fleet's buckets and the
    multi-ticker mixed batch; the
    long-context (16, 4, 1024, 8), causal or not; the D envelope at 64 and
    512, in f32 and bf16."""
    b, n, t, d = FLASH_MAIN
    base = dict(batch=b, heads=n, seq=t, d=d, dtype=torch.float32,
                causal=False, masked=False)
    return ([dict(base, dtype=dtype, causal=causal, masked=masked)
             for dtype in (torch.float32, torch.bfloat16)
             for causal in (False, True) for masked in (False, True)]
            + [dict(base, batch=1)]
            + [dict(base, batch=b) for b in (*PREDICTOR_BUCKETS,
                                             MULTI_BATCH)]
            + [dict(base, batch=16, seq=1024, causal=causal)
               for causal in (False, True)]
            + [dict(base, batch=8, heads=2, seq=256, d=64, dtype=dtype)
               for dtype in (torch.float32, torch.bfloat16)]
            + [dict(base, batch=2, heads=1, seq=128, d=512, dtype=dtype)
               for dtype in (torch.float32, torch.bfloat16)])


def flash_pairs(c, key_mask) -> int:
    """The (query, key) pairs this case's data makes visible: the work the
    function needs (a hidden key needs none)."""
    b, n, t = c["batch"], c["heads"], c["seq"]
    keep = (torch.ones(b, t, dtype=torch.bool) if key_mask is None
            else key_mask.cpu())
    if c["causal"]:  # keys at or before the query: prefix counts
        return n * int(keep.long().cumsum(dim=1).sum())
    return n * t * int(keep.long().sum())


def sdpa(q, k, v, causal, key_mask):
    """One PyTorch call of the same attention, the yardstick (never on the
    port's path)."""
    if key_mask is None:
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal)
    mask = key_mask[:, None, None, :]
    if causal:
        t = q.shape[-2]
        mask = mask & torch.ones(t, t, dtype=torch.bool,
                                 device=q.device).tril()
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask)


def phase_kernel_flash(device: str = "cuda"):
    """flash_fwd against flash_fwd_reference (o, lse), then flash_dkv,
    flash_dq and flash_bwd against theirs (dk, dv; dq; dq, dk, dv) on the
    kernel forward's o and lse with a nonzero lse cotangent, at every case
    of :func:`flash_cases`; a second call of each backward must give the
    same bits.  flash_bwd must run its fused kernel exactly where the plan
    fuses (T <= 128, D <= 64: the model's shape) and the two sweeps
    elsewhere (T = 1024, D = 512), as the launch counts show.  Returns the
    rows, each naming its ``kernel`` and carrying its launch's plan."""
    from fmda_tpu_torch.ops import attention_kernel as ak

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    results = []
    for c in flash_cases():
        b, n, t, d, dtype = (c["batch"], c["heads"], c["seq"], c["d"],
                             c["dtype"])

        def randn(*shape, s=1.0):
            return (torch.randn(shape, generator=gen, device=dev) * s).to(
                dtype)

        q, k, v = (randn(b, n, t, d) for _ in range(3))
        key_mask = None
        if c["masked"]:  # ragged valid lengths 1..T, row 0 fully hidden
            lengths = torch.randint(1, t + 1, (b,), generator=gen,
                                    device=dev)
            key_mask = torch.arange(t, device=dev)[None, :] < lengths[:, None]
            key_mask[0] = False
        kw = dict(causal=c["causal"], key_mask=key_mask)
        pairs = flash_pairs(c, key_mask)
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        shape = dict(batch=b, heads=n, seq=t, d=d,
                     dtype=str(dtype).replace("torch.", ""),
                     causal=c["causal"], masked=c["masked"], pairs=pairs,
                     tol=tol)
        with torch.inference_mode():
            o, lse = ak.flash_fwd(q, k, v, **kw)
            want = ak.flash_fwd_reference(q, k, v, **kw)
            do, dlse = randn(b, n, t, d), torch.randn(
                (b, n, t), generator=gen, device=dev) * 0.5
            bargs = (q, k, v, do, lse, ak.flash_delta(o, do, dlse))
            before = launch_counts()
            got_bwd = {"flash_dkv": ak.flash_dkv(*bargs, **kw),
                       "flash_dq": (ak.flash_dq(*bargs, **kw),),
                       "flash_bwd": ak.flash_bwd(*bargs, **kw)}
            moved = {name: count - before[name]
                     for name, count in launch_counts().items()
                     if count != before[name]}
            again = {"flash_dkv": ak.flash_dkv(*bargs, **kw),
                     "flash_dq": (ak.flash_dq(*bargs, **kw),),
                     "flash_bwd": ak.flash_bwd(*bargs, **kw)}
            want_bwd = {"flash_dkv": ak.flash_dkv_reference(*bargs, **kw),
                        "flash_dq": (ak.flash_dq_reference(*bargs, **kw),),
                        "flash_bwd": ak.flash_bwd_reference(*bargs, **kw)}
            torch.cuda.synchronize()
        bwd_plan = ak.flash_bwd_plan(b * n, n, t, d, dtype)
        fused = t <= ak.SOFTMAX_BLOCK and d <= 64
        check(bwd_plan["fused"] == fused and moved == (
            {"flash_dkv": 1, "flash_dq": 1, "flash_bwd": 1} if fused else
            {"flash_dkv": 2, "flash_dq": 2}),
              f"flash_bwd at {shape} launched {moved} under {bwd_plan}")
        outputs = {"flash_fwd": ((o, lse), want), **{
            name: (got_bwd[name], want_bwd[name]) for name in got_bwd}}
        fns = {"flash_fwd": (lambda: ak.flash_fwd(q, k, v, **kw),
                             lambda: ak.flash_fwd_reference(q, k, v, **kw)),
               "flash_dkv": (lambda: ak.flash_dkv(*bargs, **kw),
                             lambda: ak.flash_dkv_reference(*bargs, **kw)),
               "flash_dq": (lambda: ak.flash_dq(*bargs, **kw),
                            lambda: ak.flash_dq_reference(*bargs, **kw)),
               "flash_bwd": (lambda: ak.flash_bwd(*bargs, **kw),
                             lambda: ak.flash_bwd_reference(*bargs, **kw))}
        plans = {"flash_fwd": ak.flash_fwd_plan(b * n, n, t, d, dtype),
                 "flash_dkv": ak.flash_bwd_plan(b * n, n, t, d, dtype,
                                                sweeps=True),
                 "flash_bwd": bwd_plan}
        plans["flash_dq"] = plans["flash_dkv"]
        # the yardstick: SDPA's forward, its backward alone (dq, dk and dv
        # in one call) and both, on the same tensors
        lq, lk, lv = (x.detach().clone().requires_grad_(True)
                      for x in (q, k, v))
        lib_out = sdpa(lq, lk, lv, c["causal"], key_mask)
        library = {"fwd": time_ms(lambda: sdpa(q, k, v, c["causal"],
                                               key_mask), prime=True,
                                  prime_cycles=LIBRARY_PRIME_CYCLES),
                   "bwd": time_ms(lambda: torch.autograd.grad(
                       lib_out, (lq, lk, lv), do, retain_graph=True),
                       prime=True, prime_cycles=LIBRARY_PRIME_CYCLES),
                   "fwd_bwd": time_ms(lambda: torch.autograd.grad(
                       sdpa(lq, lk, lv, c["causal"], key_mask), (lq, lk, lv),
                       do), prime=True, prime_cycles=LIBRARY_PRIME_CYCLES)}
        for name, (got, ref) in outputs.items():
            errs = [(g.float() - r.float()).abs().max().item()
                    for g, r in zip(got, ref)]
            check(all(g.shape == r.shape and g.dtype == r.dtype
                      for g, r in zip(got, ref)),
                  f"{name} outputs {[(g.shape, g.dtype) for g in got]}")
            finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
            with torch.inference_mode():
                kernel_fn, plain_fn = fns[name]
                ms = time_ms(kernel_fn, prime=True)
                call_ms = time_ms(kernel_fn, prime=False)
                plain_ms = time_ms(plain_fn, prime=True)
            bound_ms, bound_by = flash_bound(name, c, q.element_size(),
                                             pairs, c["masked"])
            row = dict(kernel=name, **shape, max_abs_err=max(errs),
                       errs=errs, out_max_abs=[g.float().abs().max().item()
                                               for g in got],
                       ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                       library_ms=library["fwd" if name == "flash_fwd"
                                          else "bwd"],
                       library_fwd_bwd_ms=library["fwd_bwd"],
                       bound_ms=bound_ms, bound_by=bound_by,
                       plan=plans[name])
            if name != "flash_fwd":
                row.update(bit_identical_rerun=all(
                    torch.equal(g, a) for g, a in zip(got, again[name])))
            emit("kernel flash_fwd" if name == "flash_fwd"
                 else "kernel flash_bwd", **row)
            check(finite, f"non-finite {name} output in {row}")
            check(row.get("bit_identical_rerun", True),
                  f"{name} gave other bits on a second call: {row}")
            check(max(errs) <= tol,
                  f"{name} disagrees with its plain version: {row}")
            results.append(row)
    return results


#: the wide route's gate kernels (``csrc/scan_wide.cu``): no Pallas kernel;
#: they stand in for the gate algebra XLA fuses into the body of the JAX
#: package's lax.scan, which ``select_scan_fn`` runs past the Pallas
#: envelope
WIDE_SOURCE = "fmda_tpu_torch/csrc/scan_wide.cu"
WIDE_REPLACES = {"gru": "fmda_tpu/ops/gru.py:100",
                 "lstm": "fmda_tpu/ops/lstm.py:108"}
WIDE_KERNELS = ("gru_wide_fwd", "gru_wide_bwd", "lstm_wide_fwd",
                "lstm_wide_bwd")
#: (batch, hidden, dtype): flagship_wide's step (the JAX package's
#: bench.py phase_flagship_wide) and the records' H = 512 f32 shape
WIDE_SHAPES = ((512, 1024, torch.bfloat16), (256, 512, torch.float32))
WIDE_STEPS = 30
#: the wide path's warehouse: the train cell's random walk cut to this
#: many rows, in chunks of WIDE_CHUNK (a few steps of batch 512)
WIDE_ROWS = 4096
WIDE_CHUNK = 1024
WIDE_BATCH = 512
WIDE_BACKTEST_BATCHES = 4
WIDE_SIGNALS = 8
WIDE_STREAM_TICKS = 8
#: the persistent LSTM scans (``csrc/lstm_persist.cu``): the LSTM route's
#: scan in one launch a direction, wherever their plan lays it out
PERSIST_SOURCE = "fmda_tpu_torch/csrc/lstm_persist.cu"
PERSIST_KERNELS = ("lstm_persist_fwd", "lstm_persist_bwd")
#: WIDE_SHAPES and the Predictor's and the stream's B = 1
PERSIST_SHAPES = WIDE_SHAPES + ((1, 1024, torch.bfloat16),)
#: the plan query against its Python copy at these (batch, hidden)
PERSIST_PLAN_CASES = ((1, 1024), (256, 1024), (512, 1024), (256, 512),
                      (512, 512), (800, 768), (288, 768), (512, 1600),
                      (1, 1600), (512, 2048), (3, 48))
#: the cluster size the kernels also run at flagship_wide's shape, where
#: the plan takes one CTA a cluster (the multicast path's check)
PERSIST_CLUSTER = 2
#: the persistent route against the float64 witness (``wide persist
#: witness``), by dtype: each output's largest difference over the
#: witness's largest entry at most WITNESS_TOL, its root mean square
#: difference at most WITNESS_RMS_RATIO times the per-step route's.  From
#: ``experiments/torch_lstm_persist.py``'s witness phase on the H100
#: (B = 1, 256, 512 at H = 1024 bf16, masked and not): bf16 at most
#: 0.0068 of the largest entry in both routes, the ratio 0.971-1.008;
#: f32 (256, 512) at most 1.75e-6, the ratio 1.007-2.885 (dh0: the
#: sweep's float32 sums over 4 H in order, cuBLAS's blocked)
WITNESS_OUTPUTS = ("h_last", "c_last", "hs", "dxp", "dh0", "dc0", "dw_hh",
                   "db_hh")
WITNESS_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
WITNESS_RMS_RATIO = {"bfloat16": 1.1, "float32": 4.0}
#: the fused GRU step (``csrc/gru_wide_step.cu``): a GRU wide step's
#: product and gates in one launch, wherever its plan lays the step out
STEP_SOURCE = "fmda_tpu_torch/csrc/gru_wide_step.cu"
STEP_KERNEL = "gru_wide_step_fwd"
#: the batches the wide path launches the step at (flagship_wide's step,
#: a chunk's last windows padded to it; the Predictor's and the stream's
#: B = 1), checked and timed; ``wide path`` fails if the step launches at
#: a (batch, hidden) outside STEP_SHAPES and STEP_RAGGED_SHAPES
STEP_SHAPES = ((WIDE_BATCH, 1024, torch.bfloat16), (1, 1024, torch.bfloat16))
#: checked, not timed: a chunk's last windows unpadded ((WIDE_CHUNK -
#: WIDE_STEPS + 1) mod WIDE_BATCH = 483 rows), a batch tile of 35 rows
#: past the TMA box's end under W_hh's multicast
STEP_RAGGED_SHAPES = (((WIDE_CHUNK - WIDE_STEPS + 1) % WIDE_BATCH, 1024,
                       torch.bfloat16),)
#: the plan query against its Python copy at these (batch, hidden)
STEP_PLAN_CASES = ((1, 1024), (64, 1024), (128, 1024), (256, 1024),
                   (483, 1024), (512, 1024), (800, 1024), (1, 2048),
                   (8, 512), (3, 48), (512, 96))
#: the fused GRU route's witness (``wide step witness``): its outputs, and
#: the (batch, hidden, dtype, masked) it runs at, flagship_wide's step
#: masked and the stream's B = 1 both ways (a float64 scan and its
#: gradients at B = 512 take seconds)
STEP_WITNESS_OUTPUTS = ("h_last", "hs", "dxp", "dh0", "dw_hh", "db_hh")
STEP_WITNESS_CASES = ((512, 1024, torch.bfloat16, True),
                      (1, 1024, torch.bfloat16, False),
                      (1, 1024, torch.bfloat16, True))
#: the gru wide path's first step through the fused route against the
#: plain versions with the step's product as one float32 BLAS product
#: (``wide first step blas``): the root mean square of every parameter's
#: relative gradient distance at most FIRST_STEP_RMS_RATIO times the
#: pair's (the route the step replaced).  From
#: ``experiments/torch_gru_wide_step.py --first-step 8`` on the H100: the
#: pooled ratio 0.918-1.078 over the path's first 8 batches (1.078 on
#: the first, the smoke's); one parameter's alone read up to 1.59, too
#: noisy to bound
FIRST_STEP_RMS_RATIO = 1.2
#: the fused GRU backward step (``csrc/gru_wide_bwd_step.cu``): a GRU wide
#: backward step's product dhh_{t+1} W_hh and gate gradients in one launch,
#: wherever its plan lays the step out
BWD_SOURCE = "fmda_tpu_torch/csrc/gru_wide_bwd_step.cu"
BWD_KERNEL = "gru_wide_bwd_step"
#: the backward's checked shapes are the forward's: STEP_SHAPES timed
#: (flagship_wide's training batch and B = 1), STEP_RAGGED_SHAPES
#: (a last batch tile of 35 rows) checked; ``wide path`` fails if the
#: backward step launches at a (batch, hidden) outside them.  Checked too:
#: a width whose tiles take 64 units (H not a multiple of 128), off the
#: path
BWD_NARROW_SHAPES = ((64, 192, torch.bfloat16),)
#: the fused backward against W2 and the mm in the route's float64 witness
#: (``wide bwd step witness``): the pooled root mean square of the
#: gradients' relative distances (dxp, dh0, dW_hh, db_hh) at most this
#: times the pair's; the fused backward keeps the product in float32,
#: where the pair rounds it to bf16 a step
BWD_WITNESS_RATIO = 1.2
#: what the wide phase (its rule, kernels, route and paths) may take
WIDE_BUDGET_S = 40.0
#: repetitions of the kernel pair's device-memory branch beside the route,
#: and of the route's plain versions (the LSTM's sums its bf16 products a
#: k-step at a time, as the persistent kernels do)
WIDE_PAIR_REPS = 3
#: how the wide route's own and its yardsticks' times are taken: primed
#: (device ms) and not (a caller's wait), 10 repetitions, not REPS (each
#: primed one a ~10 ms sleep and the call), to keep the phase inside
#: WIDE_BUDGET_S
WIDE_TIME_REPS = 10
WIDE_PRIMED = dict(prime=True, prime_cycles=LIBRARY_PRIME_CYCLES,
                   reps=WIDE_TIME_REPS)
WIDE_CALLED = dict(prime=False, reps=WIDE_TIME_REPS)


class plain_wide_gates:
    """Inside, the wide route's gate steps and its fused GRU steps run
    their plain versions on card tensors too (the wrappers' ``_on_cpu``
    answers True): the computation the kernels are held to, with the same
    cuBLAS products around the gate steps."""

    def __enter__(self):
        from fmda_tpu_torch.ops import (
            gru_wide_bwd_step, gru_wide_step, wide_scan)

        self._saved = [(m, m._on_cpu) for m in (wide_scan, gru_wide_step,
                                                gru_wide_bwd_step)]
        for module, _ in self._saved:
            module._on_cpu = lambda name, tensors: True
        return self

    def __exit__(self, *exc):
        for module, saved in self._saved:
            module._on_cpu = saved
        return False


class plan_off:
    """Inside, ``fmda_tpu_torch.ops.<module>.<name>`` (a redesigned route's
    plan) answers None: the route before the redesign runs, timed and
    witnessed beside it."""

    def __init__(self, module: str, name: str):
        import importlib

        self._mod = importlib.import_module(f"fmda_tpu_torch.ops.{module}")
        self._name = name

    def __enter__(self):
        self._saved = getattr(self._mod, self._name)
        setattr(self._mod, self._name, lambda *a, **k: None)
        return self

    def __exit__(self, *exc):
        setattr(self._mod, self._name, self._saved)
        return False


class launch_shapes:
    """Inside, the signature of every launch of each of ``kernels`` is
    collected in ``seen[kernel]`` (the wrappers' bookings,
    ``ops.attach_ledger``), each booking passed on to the ledger attached
    before."""

    def __init__(self, *kernels: str):
        self.seen = {k: set() for k in kernels}

    def __enter__(self):
        from fmda_tpu_torch import ops

        self._prev = ops._ledger
        ops.attach_ledger(self)
        return self

    def begin(self, kernel, signature):
        if kernel in self.seen:
            self.seen[kernel].add(tuple(signature))
        return None if self._prev is None else self._prev.begin(kernel,
                                                                signature)

    def __exit__(self, *exc):
        from fmda_tpu_torch import ops

        ops.attach_ledger(self._prev)
        return False


def pair_gru() -> plan_off:
    """The fused GRU step's plan forced off: the GRU route's forward runs
    the pair (a cuBLAS ``addmm`` and W1 a step)."""
    return plan_off("gru_wide_step", "gru_wide_step_plan")


def pair_gru_bwd() -> plan_off:
    """The fused GRU backward step's plan forced off: the GRU route's
    backward runs W2 and a cuBLAS ``mm`` a step."""
    return plan_off("gru_wide_bwd_step", "gru_wide_bwd_step_plan")


def per_step_lstm() -> plan_off:
    """The persistent LSTM plan forced off: the route's scans run the
    per-step kernels (W3, W4)."""
    return plan_off("wide_scan", "lstm_persist_plan")


def wide_route(cell: str, batch: int, hidden: int, itemsize: int) -> str:
    """The route the port takes for a scan: ``kernel_pair`` or ``wide``."""
    from fmda_tpu_torch.ops import gru_kernel, lstm_kernel

    module = gru_kernel if cell == "gru" else lstm_kernel
    return ("kernel_pair" if module.kernel_supported(batch, WIDE_STEPS, hidden,
                                                     itemsize) else "wide")


def phase_wide_rule(device: str = "cuda") -> dict:
    """``kernel_supported`` against the library's own plan query: the
    Python copy of the plan (``_cuda_lib.fwd_branch``, which the rule
    reads) must name the plan's branch, and wherever the plan reads W_hh
    from device memory the rule must send the scan to the wide route."""
    from fmda_tpu_torch.ops import _cuda_lib, gru_kernel, lstm_kernel

    limits = {"gru": (gru_kernel, 3, 1024), "lstm": (lstm_kernel, 4, 512)}
    rows = []
    for cell, (module, gates, limit) in limits.items():
        for dtype in (torch.float32, torch.bfloat16):
            itemsize = torch.tensor([], dtype=dtype).element_size()
            for hidden in (8, 32, 33, 64, 96, 128, 160, 192, 256, 384, 512,
                           768, 1024, 1536):
                rule = module.kernel_supported(WIDE_BATCH, WIDE_STEPS,
                                               hidden, itemsize)
                branch = (_cuda_lib.fwd_plan(cell, WIDE_BATCH, hidden, dtype,
                                             0)["branch"]
                          if hidden <= limit and device == "cuda" else None)
                mirror = _cuda_lib.fwd_branch(gates, hidden, itemsize)
                rows.append(dict(cell=cell, hidden=hidden,
                                 dtype=str(dtype).replace("torch.", ""),
                                 kernel_supported=rule, plan=branch,
                                 mirror=mirror))
                check(branch is None or branch == mirror,
                      f"wide rule: {cell} H={hidden} {dtype}: the plan "
                      f"takes {branch}, its Python copy says {mirror}")
                check(not rule or (branch or mirror) != "device",
                      f"wide rule: {cell} H={hidden} {dtype} keeps the "
                      f"kernel pair on the plan's device branch")
    on_pair = {f"{r['cell']} {r['dtype']}": [x["hidden"] for x in rows
                                             if x["cell"] == r["cell"]
                                             and x["dtype"] == r["dtype"]
                                             and x["kernel_supported"]]
               for r in rows}
    emit("wide rule", kernel_pair_hidden=on_pair,
         device_branch={f"{r['cell']} {r['dtype']} {r['hidden']}": r["plan"]
                        for r in rows if r["plan"] == "device"})
    if device == "cuda":
        phase_persist_plan()
        phase_step_plan()
        phase_bwd_step_plan()
    return on_pair


def phase_step_plan() -> list:
    """The fused GRU step's plan query (``fmda_gru_wide_scan_fwd_plan``)
    against its Python copy (``gru_wide_step.step_plan``) on the figures
    the query reports, at STEP_PLAN_CASES in both dtypes: the same fields,
    or both handing the step back to the pair."""
    from fmda_tpu_torch.ops import gru_wide_step

    rows = []
    for batch, hidden in STEP_PLAN_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            itemsize = torch.tensor([], dtype=dtype).element_size()
            plan, figures = gru_wide_step.step_plan_query(batch, hidden,
                                                          dtype, 0)
            mirror = gru_wide_step.step_plan(batch, hidden, itemsize,
                                             **figures)
            rows.append(dict(batch=batch, hidden=hidden,
                             dtype=str(dtype).replace("torch.", ""),
                             plan=plan))
            check(mirror == plan, f"step plan ({batch}, {hidden}) {dtype}: "
                  f"the query lays out {plan}, its Python copy {mirror}")
    emit("wide step plan", figures=figures,
         fused={f"{r['batch']} {r['hidden']} {r['dtype']}":
                None if r["plan"] is None else
                {k: r["plan"][k] for k in ("mcast", "split", "grid")}
                for r in rows})
    return rows


def phase_bwd_step_plan() -> list:
    """The fused GRU backward step's plan query
    (``fmda_gru_wide_bwd_step_plan``) against its Python copy
    (``gru_wide_bwd_step.bwd_step_plan``) on the figures the query
    reports, at STEP_PLAN_CASES in both dtypes: the same fields, or both
    handing the step back to W2 and the mm."""
    from fmda_tpu_torch.ops import gru_wide_bwd_step as bw

    rows = []
    for batch, hidden in STEP_PLAN_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            itemsize = torch.tensor([], dtype=dtype).element_size()
            plan, figures = bw.bwd_step_plan_query(batch, hidden, dtype, 0)
            mirror = bw.bwd_step_plan(batch, hidden, itemsize, **figures)
            rows.append(dict(batch=batch, hidden=hidden,
                             dtype=str(dtype).replace("torch.", ""),
                             plan=plan))
            check(mirror == plan, f"bwd step plan ({batch}, {hidden}) "
                  f"{dtype}: the query lays out {plan}, its Python copy "
                  f"{mirror}")
    emit("wide bwd step plan", figures=figures,
         fused={f"{r['batch']} {r['hidden']} {r['dtype']}":
                None if r["plan"] is None else
                {k: r["plan"][k] for k in ("mcast", "split", "k_steps",
                                            "grid")}
                for r in rows})
    return rows


def phase_persist_plan() -> list:
    """The persistent LSTM scans' plan query (``fmda_lstm_persist_plan``)
    against its Python copy (``_cuda_lib.persist_plan``) on the figures
    the query reports, at PERSIST_PLAN_CASES in both dtypes: the same
    fields, or both handing the scan back."""
    from fmda_tpu_torch.ops import _cuda_lib

    rows = []
    for batch, hidden in PERSIST_PLAN_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            itemsize = torch.tensor([], dtype=dtype).element_size()
            plan, figures = _cuda_lib.persist_plan_query(batch, hidden, dtype,
                                                         0)
            mirror = _cuda_lib.persist_plan(batch, hidden, itemsize,
                                            **figures)
            rows.append(dict(batch=batch, hidden=hidden,
                             dtype=str(dtype).replace("torch.", ""),
                             plan=plan, mirror=mirror == plan))
            check(mirror == plan, f"persist plan ({batch}, {hidden}) "
                  f"{dtype}: the query lays out {plan}, its Python copy "
                  f"{mirror}")
    emit("wide persist plan", figures=figures,
         persistent={f"{r['batch']} {r['hidden']} {r['dtype']}":
                     None if r["plan"] is None else
                     {k: r["plan"][k] for k in ("tiles", "slices",
                                                 "cluster", "chunk",
                                                 "stages", "smem")}
                     for r in rows})
    return rows


def wide_step_operands(cell, batch, hidden, dtype, masked, gen, dev):
    """One step's operands, uniform from ``gen``: the gate inputs (G H),
    the states, the backward's float32 carries, its product and cotangent,
    and a (B,) uint8 mask column (about a third of the rows masked)."""
    gh = (3 if cell == "gru" else 4) * hidden

    def rand(*shape, s=1.0, dt=dtype):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * s).to(dt)

    ops = dict(xp_t=rand(batch, gh, s=2.0), hh_t=rand(batch, gh, s=2.0),
               h_prev=rand(batch, hidden, s=0.5),
               c_prev=rand(batch, hidden, s=0.5),
               c_t=rand(batch, hidden, s=0.5),
               direct=rand(batch, hidden, s=COT_SCALE, dt=torch.float32),
               dc=rand(batch, hidden, s=COT_SCALE, dt=torch.float32),
               prod=rand(batch, hidden, s=COT_SCALE),
               dhs_t=rand(batch, hidden, s=COT_SCALE))
    ops["mask_t"] = ((torch.rand(batch, generator=gen, device=dev) > 0.33)
                     .to(torch.uint8) if masked else None)
    return ops


def wide_direct(name, o) -> bool:
    """Whether a backward step is given the float32 direct part of dh: the
    GRU's always; the LSTM's, which a later step (a product given) needs
    only under a mask, as the scan gives it."""
    return name == "gru_wide_bwd" or o["mask_t"] is not None


def wide_gate_call(name, o, outs):
    """The call of one gate kernel's wrapper on the operands ``o`` into
    ``outs`` (fresh buffers; the float32 carries cloned, since the kernel
    updates them in place): returns the outputs (the LSTM backward's
    direct part only under a mask, where it writes one)."""
    from fmda_tpu_torch.ops import wide_scan as ws

    if name == "gru_wide_fwd":
        ws.gru_wide_gates(o["xp_t"], o["hh_t"], o["h_prev"], o["mask_t"],
                          outs["h"])
        return [outs["h"]]
    if name == "lstm_wide_fwd":
        ws.lstm_wide_gates(o["xp_t"], o["hh_t"], o["h_prev"], o["c_prev"],
                           o["mask_t"], outs["h"], outs["c"])
        return [outs["h"], outs["c"]]
    outs["direct"].copy_(o["direct"])
    if name == "gru_wide_bwd":
        ws.gru_wide_gates_bwd(o["xp_t"], o["hh_t"], o["h_prev"],
                              outs["direct"], o["prod"], o["dhs_t"],
                              o["mask_t"], outs["dxp"], outs["dhh"])
        return [outs["dxp"], outs["dhh"], outs["direct"]]
    outs["dc"].copy_(o["dc"])
    direct = outs["direct"] if wide_direct(name, o) else None
    ws.lstm_wide_gates_bwd(o["xp_t"], o["hh_t"], o["c_prev"], o["c_t"],
                           direct, o["prod"], o["dhs_t"], outs["dc"],
                           o["mask_t"], outs["dxp"])
    return [outs["dxp"], outs["dc"]] + ([direct] if o["mask_t"] is not None
                                        else [])


def wide_gate_reference(name, o):
    """The same step through the plain version, as a list of outputs."""
    from fmda_tpu_torch.ops import wide_scan as ws

    if name == "gru_wide_fwd":
        return [ws.gru_wide_gates_reference(o["xp_t"], o["hh_t"],
                                            o["h_prev"], o["mask_t"])]
    if name == "lstm_wide_fwd":
        return list(ws.lstm_wide_gates_reference(
            o["xp_t"], o["hh_t"], o["h_prev"], o["c_prev"], o["mask_t"]))
    if name == "gru_wide_bwd":
        return list(ws.gru_wide_gates_bwd_reference(
            o["xp_t"], o["hh_t"], o["h_prev"], o["direct"], o["prod"],
            o["dhs_t"], o["mask_t"]))
    dxp, direct, dc = ws.lstm_wide_gates_bwd_reference(
        o["xp_t"], o["hh_t"], o["c_prev"], o["c_t"],
        o["direct"] if wide_direct(name, o) else None, o["prod"],
        o["dhs_t"], o["dc"], o["mask_t"])
    return [dxp, dc] + ([direct] if direct is not None else [])


#: the PyTorch call that computes each gate kernel's function (unmasked,
#: its biases None: hh already holds b_hh), never on the port's path
WIDE_LIBRARY = {"gru_wide_fwd": "_thnn_fused_gru_cell",
                "gru_wide_bwd": "_thnn_fused_gru_cell_backward",
                "lstm_wide_fwd": "_thnn_fused_lstm_cell"}


def wide_gate_library(name, o, want) -> dict:
    """An unmasked gate step through its PyTorch call (WIDE_LIBRARY), its
    outputs held to the plain version's ``want`` first, then timed: the
    forwards' (h[, c]); the GRU backward's dxp, dhh and direct part from
    the forward call's workspace and dh = direct + prod + dhs_t rounded to
    the I/O dtype (the call takes dh in it).  Empty where no call
    computes the function (the LSTM backward's carries dc)."""
    if name not in WIDE_LIBRARY:
        return {}
    aten = torch.ops.aten
    if name == "gru_wide_bwd":
        _, ws_ = aten._thnn_fused_gru_cell(o["xp_t"], o["hh_t"], o["h_prev"],
                                           None, None)
        dh = (o["direct"] + o["prod"].float() + o["dhs_t"].float()).to(
            o["xp_t"].dtype)

        def fn():
            return aten._thnn_fused_gru_cell_backward(dh, ws_, False)[:3]
    elif name == "gru_wide_fwd":
        def fn():
            return aten._thnn_fused_gru_cell(o["xp_t"], o["hh_t"],
                                             o["h_prev"], None, None)[:1]
    else:
        def fn():
            return aten._thnn_fused_lstm_cell(o["xp_t"], o["hh_t"],
                                              o["c_prev"], None, None)[:2]
    got = fn()
    torch.cuda.synchronize()
    errs, rels = persist_errors(got, want)
    return dict(library=WIDE_LIBRARY[name], library_max_abs_err=max(errs),
                library_max_rel_err=max(rels),
                library_ms=time_ms(fn, prime=True))


def phase_wide_kernels(device: str = "cuda") -> list:
    """(a) Each of the wide route's four gate kernels against its plain
    version on the card, at WIDE_SHAPES, masked and not: every output
    compared, a second call the same bits; the kernel's device ms, the
    plain version's, and the bound (bytes at 3.35 TB/s against the
    element-wise operations at 67 TFLOP/s: ``wide_gates_bound``).
    ``library_ms``: unmasked, the PyTorch call of WIDE_LIBRARY that
    computes the same step (:func:`wide_gate_library`, checked equal first;
    none for the LSTM backward, null).
    The LSTM gate kernels are the per-step route, which the persistent
    scans' plan keeps where W_hh does not fit the grid; then the
    persistent scans themselves (:func:`phase_wide_persist`)."""
    from fmda_tpu_torch.ops.cost import wide_gates_bound

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    results = []
    for name in WIDE_KERNELS:
        cell, backward = name.split("_")[0], name.endswith("bwd")
        for batch, hidden, dtype in WIDE_SHAPES:
            gh = (3 if cell == "gru" else 4) * hidden
            for masked in (False, True):
                o = wide_step_operands(cell, batch, hidden, dtype, masked,
                                       gen, dev)
                outs = dict(h=torch.empty(batch, hidden, dtype=dtype,
                                          device=dev),
                            dxp=torch.empty(batch, gh, dtype=dtype,
                                            device=dev),
                            direct=torch.empty(batch, hidden, device=dev))
                outs["c"] = torch.empty_like(outs["h"])
                outs["dhh"] = torch.empty_like(outs["dxp"])
                outs["dc"] = torch.empty_like(outs["direct"])
                with torch.inference_mode():
                    got = [g.clone() for g in wide_gate_call(name, o, outs)]
                    again = wide_gate_call(name, o, outs)
                    want = wide_gate_reference(name, o)
                    torch.cuda.synchronize()
                    same_bits = all(torch.equal(g, a)
                                    for g, a in zip(got, again))
                    err = max((g.float() - w.float()).abs().max().item()
                              for g, w in zip(got, want))
                    finite = all(bool(torch.isfinite(g.float()).all())
                                 for g in got)
                    ms = time_ms(lambda: wide_gate_call(name, o, outs),
                                 prime=True)
                    plain_ms = time_ms(lambda: wide_gate_reference(name, o),
                                       prime=True)
                    library = (wide_gate_library(name, o, want)
                               if not masked and device == "cuda" else {})
                itemsize = torch.tensor([], dtype=dtype).element_size()
                bound_ms, bound_by = wide_gates_bound(
                    cell, batch, hidden, itemsize, masked, backward,
                    direct=wide_direct(name, o))
                tol = F32_TOL if dtype == torch.float32 else BF16_TOL
                row = dict(kernel=name, batch=batch, hidden=hidden,
                           dtype=str(dtype).replace("torch.", ""),
                           masked=masked, max_abs_err=err, tol=tol,
                           bit_identical_rerun=same_bits, ms=ms,
                           plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=None)
                row.update(library)
                emit(f"wide kernel {name}", **row)
                check(not library or persist_agrees(
                    dict(max_abs_err=library["library_max_abs_err"],
                         max_rel_err=library["library_max_rel_err"]),
                    dtype), f"{name}'s library call computes another "
                      f"function: {row}")
                check(finite, f"non-finite {name} output: {row}")
                check(err <= tol, f"{name} disagrees with its plain "
                      f"version: {row}")
                check(same_bits, f"{name} gave other bits on a second "
                      f"call: {row}")
                results.append(row)
    return results + phase_wide_persist(device)


def persist_mask(batch, gen, dev):
    """A (B, T) uint8 mask of ragged lengths (every row at least a step),
    uniform from ``gen``."""
    lengths = torch.randint(1, WIDE_STEPS + 1, (batch,), generator=gen,
                            device=dev)
    return (torch.arange(WIDE_STEPS, device=dev)[None, :]
            < lengths[:, None]).to(torch.uint8)


def phase_wide_persist(device: str = "cuda") -> list:
    """(a) The persistent LSTM scans against their plain versions on the
    card at PERSIST_SHAPES, masked and not, both directions: the forward
    (hs, cs) and the backward sweep (dxp, dh0, dc0) from the forward's
    states, every output (:func:`persist_agrees`), a second call the same
    bits; then :func:`phase_persist_cluster` and
    :func:`phase_persist_witness`.  At each shape's
    unmasked forward direction: the kernel's device ms, the plain
    version's, the bound (``scan_bound`` at gates = 4, states = 2;
    ``persist_sweep_bound`` for the sweep, whose products over all B T
    rows stay outside it), the L2 bytes a step of its plan; ``library_ms``
    is cuDNN's layer, in the route's line."""
    from fmda_tpu_torch.ops import wide_scan as ws
    from fmda_tpu_torch.ops.cost import (
        persist_l2_bytes, persist_sweep_bound, scan_bound)
    from fmda_tpu_torch.ops.scan_dw import h_prev_of

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    shapes = SCAN_SHAPES["lstm"]
    results = []
    for batch, hidden, dtype in PERSIST_SHAPES:
        itemsize = torch.tensor([], dtype=dtype).element_size()
        plan = ws.lstm_persist_plan(batch, hidden, dtype, dev)
        check(plan is not None, f"persist ({batch}, {hidden}) {dtype}: the "
              f"plan hands the scan back")
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        for masked in (False, True):
            for reverse in (False, True):
                (xp, h0, c0, w, b), cots = wide_scan_inputs(
                    "lstm", batch, hidden, dtype, gen, dev)
                mask = persist_mask(batch, gen, dev) if masked else None
                kw = dict(reverse=reverse, mask=mask)
                with torch.inference_mode():
                    want = ws.lstm_persist_scan_reference(xp, h0, c0, w, b,
                                                          plan, **kw)
                    hh = ws._recompute_hh(h_prev_of(h0, want[0],
                                                    reverse=reverse), w, b)
                    sweep = (xp, hh, c0, want[1], w, cots[2],
                             cots[0].float(), cots[1].float(), plan)
                    calls = {
                        "lstm_persist_fwd": (
                            lambda: ws.lstm_persist_fwd(
                                xp, h0, c0, w, b, plan, **kw),
                            lambda: ws.lstm_persist_scan_reference(
                                xp, h0, c0, w, b, plan, **kw)),
                        "lstm_persist_bwd": (
                            lambda: ws.lstm_persist_bwd(*sweep, **kw),
                            lambda: ws.lstm_persist_sweep_reference(
                                *sweep, **kw))}
                    for name, (kernel, plain) in calls.items():
                        got = [g.clone() for g in kernel()]
                        again = kernel()
                        ref = plain()
                        torch.cuda.synchronize()
                        errs, rels = persist_errors(got, ref)
                        row = dict(
                            kernel=name, batch=batch, hidden=hidden,
                            dtype=str(dtype).replace("torch.", ""),
                            masked=masked, reverse=reverse,
                            max_abs_err=max(errs), errs=errs,
                            max_rel_err=max(rels), rel_errs=rels, tol=tol,
                            bit_identical_rerun=all(
                                torch.equal(g, a) for g, a in zip(got, again)),
                            finite=all(bool(torch.isfinite(g.float()).all())
                                       for g in got))
                        if not (masked or reverse):
                            backward = name == "lstm_persist_bwd"
                            row.update(
                                plan=plan,
                                ms=time_ms(kernel, prime=True),
                                # the plain scans sum bf16 products a
                                # k-step at a time: one timed call
                                plain_ms=time_ms(plain, prime=True, reps=1,
                                                 warmup=1),
                                l2_bytes_per_step=persist_l2_bytes(
                                    plan, batch, hidden, itemsize, backward),
                                library_ms=None)
                            row["bound_ms"], row["bound_by"] = (
                                persist_sweep_bound(batch, WIDE_STEPS, hidden,
                                                    itemsize, False)
                                if backward else scan_bound(
                                    batch, WIDE_STEPS, hidden, itemsize,
                                    False, gates=shapes["gates"],
                                    states=shapes["states"],
                                    elementwise=shapes["fwd_ops"]))
                        emit(f"wide persist {name}", **row)
                        check(row["finite"], f"non-finite {name} output: "
                              f"{row}")
                        check(persist_agrees(row, dtype), f"{name} "
                              f"disagrees with its plain version: {row}")
                        check(row["bit_identical_rerun"], f"{name} gave "
                              f"other bits on a second call: {row}")
                        results.append(row)
    phase_persist_cluster(device)
    phase_persist_witness(device)
    return results


def persist_errors(got, want):
    """Each output's largest difference, and the same relative to the
    output's own largest entry."""
    errs = [(g.float() - w.float()).abs().max().item()
            for g, w in zip(got, want)]
    rels = [e / max(w.float().abs().max().item(), 1e-30)
            for e, w in zip(errs, want)]
    return errs, rels


def persist_agrees(row, dtype) -> bool:
    """A persistent kernel's outputs against its plain version: float32
    within F32_TOL; bfloat16 within BF16_TOL and each within BF16_TOL of
    its own largest entry (the sweep's outputs are a cotangent's size, so
    the absolute bound alone would be near the values themselves)."""
    if dtype == torch.float32:
        return row["max_abs_err"] <= F32_TOL
    return row["max_abs_err"] <= BF16_TOL and row["max_rel_err"] <= BF16_TOL


def phase_persist_cluster(device: str = "cuda") -> list:
    """The persistent kernels on a plan of clusters of PERSIST_CLUSTER
    CTAs (the plan made as if the card held no other size) at
    flagship_wide's (512, 1024) bf16, masked, against their plain versions
    and a second call: the TMA multicast the plan keeps for shapes whose
    batch tile needs it, run where the smoke's own shapes take one CTA a
    cluster."""
    from fmda_tpu_torch.ops import _cuda_lib
    from fmda_tpu_torch.ops import wide_scan as ws
    from fmda_tpu_torch.ops.scan_dw import h_prev_of

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    batch, hidden, dtype = WIDE_SHAPES[0]
    figures = (_cuda_lib.persist_plan_query(batch, hidden, dtype, 0)[1]
               if device == "cuda" else _cuda_lib.H100_FIGURES)
    only = dict(figures, clusters={k: (v if k == PERSIST_CLUSTER else 0)
                                   for k, v in figures["clusters"].items()})
    plan = _cuda_lib.persist_plan(batch, hidden, 2, **only)
    check(plan is not None and plan["cluster"] == PERSIST_CLUSTER,
          f"persist cluster: no plan of clusters of {PERSIST_CLUSTER}")
    (xp, h0, c0, w, b), cots = wide_scan_inputs("lstm", batch, hidden, dtype,
                                                gen, dev)
    mask = persist_mask(batch, gen, dev)
    rows = []
    with torch.inference_mode():
        hs_cs = ws.lstm_persist_scan_reference(xp, h0, c0, w, b, plan,
                                               mask=mask)
        hh = ws._recompute_hh(h_prev_of(h0, hs_cs[0]), w, b)
        sweep = (xp, hh, c0, hs_cs[1], w, cots[2], cots[0].float(),
                 cots[1].float(), plan)
        for name, kernel, ref in (
                ("lstm_persist_fwd",
                 lambda: ws.lstm_persist_fwd(xp, h0, c0, w, b, plan,
                                             mask=mask), hs_cs),
                ("lstm_persist_bwd",
                 lambda: ws.lstm_persist_bwd(*sweep, mask=mask),
                 ws.lstm_persist_sweep_reference(*sweep, mask=mask))):
            got = [g.clone() for g in kernel()]
            again = kernel()
            torch.cuda.synchronize()
            errs, rels = persist_errors(got, ref)
            row = dict(kernel=name, batch=batch, hidden=hidden,
                       dtype="bfloat16", masked=True, plan=plan,
                       max_abs_err=max(errs), max_rel_err=max(rels),
                       rel_errs=rels, tol=BF16_TOL,
                       bit_identical_rerun=all(torch.equal(g, a)
                                               for g, a in zip(got, again)))
            emit(f"wide persist cluster {name}", **row)
            check(persist_agrees(row, dtype) and row["bit_identical_rerun"],
                  f"{name} on clusters of {PERSIST_CLUSTER}: {row}")
            rows.append(row)
    return rows


def lstm_scan_f64(xp, h0, c0, w, b, mask, reverse):
    """The LSTM scan in float64 on its inputs' values, written here apart
    from the port: the exact function both wide routes round (h, c and
    the pre-activations never rounded); gates i, f, g, o; a held row keeps
    h and c.  (h_last, c_last, hs)."""
    x, h, c, w, b = (t.double() for t in (xp, h0, c0, w, b))
    n_steps, hidden = x.shape[1], h.shape[-1]
    hs = [None] * n_steps
    for t in (range(n_steps - 1, -1, -1) if reverse else range(n_steps)):
        i, f, g, o = (x[:, t] + h @ w.t() + b).split(hidden, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        if mask is not None:
            keep = mask[:, t, None] != 0
            h_new = torch.where(keep, h_new, h)
            c_new = torch.where(keep, c_new, c)
        hs[t], h, c = h_new, h_new, c_new
    return h, c, torch.stack(hs, dim=1)


def witness_errors(got, exact):
    """Each tensor's distance from the float64 witness: its largest
    difference over the witness's largest entry, and its root mean square
    difference over the witness's root mean square."""
    rel, rms = [], []
    for g, e in zip(got, exact):
        d = g.double() - e
        rel.append(d.abs().max().item() / max(e.abs().max().item(), 1e-300))
        rms.append(d.pow(2).mean().sqrt().item()
                   / max(e.pow(2).mean().sqrt().item(), 1e-300))
    return rel, rms


def persist_witness(batch, hidden, dtype, masked, gen, dev) -> dict:
    """The LSTM route's scan, forward and gradients (h_last, c_last, hs;
    dxp, dh0, dc0, dW_hh, db_hh at unit cotangents), through the
    persistent kernels and through the per-step kernels (W3, W4 and
    cuBLAS's products), each against :func:`lstm_scan_f64` and its
    float64 gradients: a witness independent of both routes' summation
    orders and of the plain versions."""
    from fmda_tpu_torch.ops import wide_scan as ws

    (xp, h0, c0, w, b), _ = wide_scan_inputs("lstm", batch, hidden, dtype,
                                             gen, dev)
    mask = persist_mask(batch, gen, dev) if masked else None
    cots = [(torch.rand(s, generator=gen, device=dev) * 2 - 1).to(dtype)
            for s in ((batch, hidden), (batch, hidden),
                      (batch, WIDE_STEPS, hidden))]
    args64 = [t.double().requires_grad_() for t in (xp, h0, c0, w, b)]
    out64 = lstm_scan_f64(*args64, mask, False)
    exact = [o.detach() for o in out64] + [
        g.detach() for g in torch.autograd.grad(
            out64, args64, [c.double() for c in cots])]
    del out64, args64

    def route():
        args = [t.clone().requires_grad_() for t in (xp, h0, c0, w, b)]
        (h, c), hs = ws.lstm_wide_scan(*args, mask=mask)
        return [h.detach(), c.detach(), hs.detach(),
                *torch.autograd.grad([h, c, hs], args, cots)]

    persist = route()
    with per_step_lstm():
        per_step = route()
    torch.cuda.synchronize()
    p_rel, p_rms = witness_errors(persist, exact)
    s_rel, s_rms = witness_errors(per_step, exact)
    return dict(batch=batch, hidden=hidden,
                dtype=str(dtype).replace("torch.", ""), masked=masked,
                outputs=list(WITNESS_OUTPUTS),
                persist_rel=p_rel, per_step_rel=s_rel,
                persist_rms=p_rms, per_step_rms=s_rms,
                rms_ratio=[p / max(q, 1e-300) for p, q in zip(p_rms, s_rms)])


def phase_persist_witness(device: str = "cuda") -> list:
    """:func:`persist_witness` at PERSIST_SHAPES, masked and not: every
    output of the persistent route within WITNESS_RMS_RATIO (its dtype's)
    of the per-step route's root mean square distance from the float64
    witness, and its largest difference within WITNESS_TOL of the
    witness's largest entry."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    rows = []
    for batch, hidden, dtype in PERSIST_SHAPES:
        for masked in (False, True):
            row = persist_witness(batch, hidden, dtype, masked, gen, dev)
            tol = WITNESS_TOL[row["dtype"]]
            ratio = WITNESS_RMS_RATIO[row["dtype"]]
            row.update(tol=tol, rms_ratio_bound=ratio)
            row["ok"] = (max(row["persist_rel"]) <= tol
                         and max(row["rms_ratio"]) <= ratio)
            emit("wide persist witness", **row)
            check(row["ok"], f"the persistent route is farther from the "
                  f"float64 witness than the per-step route: {row}")
            rows.append(row)
    return rows


def phase_wide_step(device: str = "cuda") -> list:
    """The fused GRU step (``gru_wide_step_fwd``) against its plain version
    (``gru_wide_step_reference``) on the card at STEP_SHAPES and
    STEP_RAGGED_SHAPES, masked and not: the output, a second call the same
    bits; at STEP_SHAPES unmasked, its device ms
    (a lone launch) beside its bound (``gru_wide_step_bound``), the plain
    version's, the pair's it replaces (``addmm`` and W1) and
    ``_thnn_fused_gru_cell``'s (W1's function in one PyTorch call; with
    the ``addmm`` before it, ``library_pair_ms``: no one call computes the
    whole step, so ``library_ms`` is null), and a step of a scan through
    each route (:func:`scan_step_times`).  Then the route's scan through it, reversed
    and masked, WIDE_STEPS steps, against the same scan through the plain
    step, and :func:`phase_step_witness`."""
    from fmda_tpu_torch.ops import gru_wide_step as st
    from fmda_tpu_torch.ops import wide_scan as ws
    from fmda_tpu_torch.ops.cost import gru_wide_step_bound

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    thnn = torch.ops.aten._thnn_fused_gru_cell
    rows = []
    for batch, hidden, dtype in STEP_SHAPES + STEP_RAGGED_SHAPES:
        timed = (batch, hidden, dtype) in STEP_SHAPES
        plan = st.gru_wide_step_plan(batch, hidden, dtype, dev)
        check(plan is not None, f"wide step ({batch}, {hidden}) {dtype}: "
              f"the plan hands the step back")
        (_, _, w, b), _ = wide_scan_inputs("gru", batch, hidden, dtype, gen,
                                           dev)
        for masked in (False, True):
            o = wide_step_operands("gru", batch, hidden, dtype, masked, gen,
                                   dev)
            xp_t, h, mask_t = o["xp_t"], o["h_prev"], o["mask_t"]
            out = torch.empty(batch, hidden, dtype=dtype, device=dev)
            hh = torch.empty(batch, 3 * hidden, dtype=dtype, device=dev)

            def call():
                return st.gru_wide_step_fwd(xp_t, h, w, b, mask_t, out, plan)

            def plain():
                return st.gru_wide_step_reference(xp_t, h, w, b, mask_t,
                                                  plan)

            with torch.inference_mode():
                got = call().clone()
                again = call()
                want = plain()
                torch.cuda.synchronize()
                errs, rels = persist_errors([got], [want])
                row = dict(kernel=STEP_KERNEL, batch=batch, hidden=hidden,
                           dtype=str(dtype).replace("torch.", ""),
                           masked=masked, plan=plan, max_abs_err=errs[0],
                           max_rel_err=rels[0], tol=BF16_TOL,
                           bit_identical_rerun=torch.equal(got, again),
                           finite=bool(torch.isfinite(got.float()).all()))
                if timed and not masked and device == "cuda":
                    row.update(
                        ms=time_ms(call, prime=True),
                        plain_ms=time_ms(plain, prime=True),
                        pair_ms=time_ms(lambda: ws.gru_wide_gates(
                            xp_t, torch.addmm(b, h, w.t(), out=hh), h, None,
                            out), prime=True),
                        thnn_cell_ms=time_ms(lambda: thnn(
                            xp_t, hh, h, None, None), prime=True),
                        library_pair_ms=time_ms(lambda: thnn(
                            xp_t, torch.addmm(b, h, w.t(), out=hh), h, None,
                            None), prime=True),
                        library_ms=None)
                    row["bound_ms"], row["bound_by"] = gru_wide_step_bound(
                        batch, hidden, 2, False)
                    row.update(scan_step_times(batch, hidden, dtype, gen,
                                               dev))
            emit("wide step", **row)
            check(row["finite"], f"non-finite {STEP_KERNEL} output: {row}")
            check(persist_agrees(row, dtype), f"{STEP_KERNEL} disagrees with "
                  f"its plain version: {row}")
            check(row["bit_identical_rerun"], f"{STEP_KERNEL} gave other "
                  f"bits on a second call: {row}")
            rows.append(row)
        # a reversed, masked scan: each step's h_{t-1} the last one's output
        (xp, h0, w, b), _ = wide_scan_inputs("gru", batch, hidden, dtype, gen,
                                             dev)
        mask = persist_mask(batch, gen, dev)
        with torch.inference_mode():
            got = ws.gru_wide_scan_fwd(xp, h0, w, b, reverse=True, mask=mask)
            with plain_wide_gates():
                want = ws.gru_wide_scan_fwd(xp, h0, w, b, reverse=True,
                                            mask=mask)
            torch.cuda.synchronize()
        errs, rels = persist_errors(got, want)
        row = dict(kernel=STEP_KERNEL, batch=batch, hidden=hidden,
                   dtype=str(dtype).replace("torch.", ""), steps=WIDE_STEPS,
                   reverse=True, masked=True, max_abs_err=max(errs),
                   max_rel_err=max(rels), rel_errs=rels, tol=BF16_TOL)
        emit("wide step scan", **row)
        check(persist_agrees(row, dtype), f"the route's scan through "
              f"{STEP_KERNEL} disagrees with its plain version: {row}")
        rows.append(row)
    phase_step_witness(device)
    return rows


def scan_step_times(batch, hidden, dtype, gen, dev) -> dict:
    """A step's device ms as the route runs it: a forward scan of
    WIDE_STEPS steps over WIDE_STEPS, through the fused step (each launch
    after the first overlapping the one before) and through the pair it
    replaced (the plan forced off: an ``addmm`` and W1 a step)."""
    from fmda_tpu_torch.ops import wide_scan as ws

    (xp, h0, w, b), _ = wide_scan_inputs("gru", batch, hidden, dtype, gen,
                                         dev)
    out = {}
    for key, route in (("scan_step_ms", contextlib.nullcontext),
                       ("pair_scan_step_ms", pair_gru)):
        with route(), torch.inference_mode():
            out[key] = time_ms(lambda: ws.gru_wide_scan_fwd(xp, h0, w, b),
                               **WIDE_PRIMED) / WIDE_STEPS
    return out


def bwd_direction(batch, hidden, n_steps, masked, gen, dev):
    """A GRU backward direction's operands in bf16, uniform from ``gen``
    at ``wide_step_operands``' scales, in the order the fused backward's
    wrappers take them (xp and hh (B, T, 3H), h_prevs and dhs (B, T, H),
    the (B, T) uint8 mask (about a third of the steps masked) or None,
    W_hh^T, the float32 direct part, the (B, T, 4H) output buffer filled
    with gate gradients: row t_next is what step t reads), and W_hh."""
    gh = 3 * hidden

    def rand(*shape, s=1.0, dt=torch.bfloat16):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * s).to(dt)

    w = rand(gh, hidden, s=hidden ** -0.5)
    mask = ((torch.rand(batch, n_steps, generator=gen, device=dev) > 0.33)
            .to(torch.uint8) if masked else None)
    ops = (rand(batch, n_steps, gh, s=2.0), rand(batch, n_steps, gh, s=2.0),
           rand(batch, n_steps, hidden, s=0.5),
           rand(batch, n_steps, hidden, s=COT_SCALE), mask,
           w.t().contiguous(),
           rand(batch, hidden, s=COT_SCALE, dt=torch.float32),
           rand(batch, n_steps, 4 * hidden, s=COT_SCALE))
    return ops, w


def phase_wide_bwd_step(device: str = "cuda") -> list:
    """The fused GRU backward step (``gru_wide_bwd_step``) against its
    plain version (``gru_wide_bwd_step_reference``) on the card at
    STEP_SHAPES, STEP_RAGGED_SHAPES and BWD_NARROW_SHAPES, masked and not:
    a step with a product (step 0 of a two-step direction, reading row 1 of
    the output buffer), its row [dr, dz, dn, dn r] and direct part, a
    second call the same bits.  At STEP_SHAPES unmasked: its device ms (a lone launch)
    beside its bound (``gru_wide_bwd_step_bound``), the plain version's,
    the pair's it replaces (W2 and a cuBLAS ``mm``), and
    ``_thnn_fused_gru_cell_backward`` and the ``mm`` (``library_pair_ms``:
    no one PyTorch call computes the step, so ``library_ms`` is null); a
    step of a sweep through each (:func:`bwd_sweep_times`).  Then the
    route's backward through it, reversed and masked, WIDE_STEPS steps,
    against the same backward through the plain versions, each gradient
    within BF16_TOL of its largest entry."""
    from fmda_tpu_torch.ops import gru_wide_bwd_step as bw
    from fmda_tpu_torch.ops import wide_scan as ws
    from fmda_tpu_torch.ops.cost import gru_wide_bwd_step_bound

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    rows = []
    for batch, hidden, dtype in (STEP_SHAPES + STEP_RAGGED_SHAPES
                                 + BWD_NARROW_SHAPES):
        timed = (batch, hidden, dtype) in STEP_SHAPES
        plan = bw.gru_wide_bwd_step_plan(batch, hidden, dtype, dev)
        check(plan is not None, f"wide bwd step ({batch}, {hidden}) "
              f"{dtype}: the plan hands the step back")
        for masked in (False, True):
            ops, w = bwd_direction(batch, hidden, 2, masked, gen, dev)
            xp, hh, hp, dhs, mask, w_t, direct, dg = ops
            direct0 = direct.clone()
            step = [t[:, 0] for t in (xp, hh, hp, dhs)]
            mask_t = None if mask is None else mask[:, 0]

            def call():
                direct.copy_(direct0)
                bw.gru_wide_bwd_step(*ops, 0, 1, plan)
                return [dg[:, 0].clone(), direct.clone()]

            def plain():
                return list(bw.gru_wide_bwd_step_reference(
                    *step[:3], direct0, bw.dhh_of(dg[:, 1]), w_t, step[3],
                    mask_t, plan))

            with torch.inference_mode():
                got = call()
                again = call()
                want = plain()
                torch.cuda.synchronize()
                errs, rels = persist_errors(got, want)
                row = dict(kernel=BWD_KERNEL, batch=batch, hidden=hidden,
                           dtype=str(dtype).replace("torch.", ""),
                           masked=masked, plan=plan, outputs=["dg", "direct"],
                           max_abs_err=max(errs), max_rel_err=max(rels),
                           rel_errs=rels, tol=BF16_TOL,
                           bit_identical_rerun=all(
                               torch.equal(g, a) for g, a in zip(got, again)),
                           finite=all(bool(torch.isfinite(g.float()).all())
                                      for g in got))
                if timed and not masked and device == "cuda":
                    row.update(bwd_step_times(ops, w, call, plain))
                    row["bound_ms"], row["bound_by"] = (
                        gru_wide_bwd_step_bound(batch, hidden, 2, False))
                    row.update(bwd_sweep_times(batch, hidden, gen, dev))
            emit("wide bwd step", **row)
            check(row["finite"], f"non-finite {BWD_KERNEL} output: {row}")
            check(persist_agrees(row, dtype), f"{BWD_KERNEL} disagrees with "
                  f"its plain version: {row}")
            check(row["bit_identical_rerun"], f"{BWD_KERNEL} gave other "
                  f"bits on a second call: {row}")
            rows.append(row)
        # the route's backward, reversed and masked: each step reads the
        # last one's row, the first none
        (xp, h0, w, b), cots = wide_scan_inputs("gru", batch, hidden, dtype,
                                                gen, dev)
        mask = persist_mask(batch, gen, dev)
        with torch.inference_mode():
            _, hs = ws.gru_wide_scan_fwd(xp, h0, w, b, reverse=True,
                                         mask=mask)
            args = (xp, h0, w, b, hs, cots[0], cots[1])
            got = ws.gru_wide_scan_bwd(*args, reverse=True, mask=mask)
            with plain_wide_gates():
                want = ws.gru_wide_scan_bwd(*args, reverse=True, mask=mask)
            torch.cuda.synchronize()
        errs, rels = persist_errors(got, want)
        row = dict(kernel=BWD_KERNEL, batch=batch, hidden=hidden,
                   dtype=str(dtype).replace("torch.", ""), steps=WIDE_STEPS,
                   reverse=True, masked=True,
                   outputs=["dxp", "dh0", "dw_hh", "db_hh"],
                   max_abs_err=max(errs), max_rel_err=max(rels),
                   rel_errs=rels, tol=BF16_TOL)
        emit("wide bwd step scan", **row)
        # each gradient relative to its largest entry, as ``wide route``
        # holds them: dW_hh sums B T rows, so one flipped bf16 rounding of
        # a gate gradient moves an entry by an ulp of a large value
        check(max(rels) <= BF16_TOL, f"the route's backward through "
              f"{BWD_KERNEL} disagrees with its plain version: {row}")
        rows.append(row)
    return rows


def bwd_step_times(ops, w, call, plain) -> dict:
    """A lone backward step's device ms (queue primed) on a two-step
    direction's operands ``ops`` (:func:`bwd_direction`): the fused kernel
    (``call``), its plain version (``plain``), the pair it replaced (W2
    reading the last step's product, then the ``mm`` writing this one's)
    and ``_thnn_fused_gru_cell_backward`` with the same ``mm`` after it
    (its workspace from ``_thnn_fused_gru_cell``; dh = direct + product +
    dhs_t rounded to bf16, as the call takes it)."""
    from fmda_tpu_torch.ops import gru_wide_bwd_step as bw
    from fmda_tpu_torch.ops import wide_scan as ws

    aten = torch.ops.aten
    xp, hh, hp, dhs, _, _, direct, dg = ops
    x_t, h_t, p_t, d_t = (t[:, 0].contiguous() for t in (xp, hh, hp, dhs))
    prod = torch.mm(bw.dhh_of(dg[:, 1]), w)
    carry = direct.clone()
    dxp_o, dhh_o = torch.empty_like(x_t), torch.empty_like(x_t)

    def pair():
        ws.gru_wide_gates_bwd(x_t, h_t, p_t, carry, prod, d_t, None, dxp_o,
                              dhh_o)
        torch.mm(dhh_o, w, out=prod)

    _, workspace = aten._thnn_fused_gru_cell(x_t, h_t, p_t, None, None)
    dh = (direct + prod.float() + d_t.float()).to(torch.bfloat16)

    def library():
        grads = aten._thnn_fused_gru_cell_backward(dh, workspace, False)
        return torch.mm(grads[1], w)

    return dict(ms=time_ms(call, prime=True),
                plain_ms=time_ms(plain, prime=True),
                pair_ms=time_ms(pair, prime=True),
                library_pair_ms=time_ms(library, prime=True),
                library_ms=None)


def bwd_sweep_times(batch, hidden, gen, dev) -> dict:
    """A step of a backward sweep as the route runs it: WIDE_STEPS steps
    over WIDE_STEPS (the direct part reset first), through the fused step
    (each launch after the first overlapping the one before) and through
    the pair it replaced (W2 and a cuBLAS ``mm`` a step): device ms
    (primed) and what a caller waits (unprimed), a step's share."""
    from fmda_tpu_torch.ops import gru_wide_bwd_step as bw
    from fmda_tpu_torch.ops import wide_scan as ws

    ops, w = bwd_direction(batch, hidden, WIDE_STEPS, False, gen, dev)
    xp, hh, hp, dhs, _, _, direct, dg = ops
    direct0 = direct.clone()
    plan = bw.gru_wide_bwd_step_plan(batch, hidden, torch.bfloat16, dev)
    dxp, dhh = torch.empty_like(xp), torch.empty_like(xp)
    prod = torch.empty(batch, hidden, dtype=torch.bfloat16, device=dev)

    def fused():
        direct.copy_(direct0)
        bw.gru_wide_bwd_step_scan(*ops, plan)

    def pair():
        direct.copy_(direct0)
        for i, t in enumerate(range(WIDE_STEPS - 1, -1, -1)):
            ws.gru_wide_gates_bwd(xp[:, t], hh[:, t], hp[:, t], direct,
                                  prod if i else None, dhs[:, t], None,
                                  dxp[:, t], dhh[:, t])
            torch.mm(dhh[:, t], w, out=prod)

    out = {}
    with torch.inference_mode():
        for key, fn in (("scan_step", fused), ("pair_scan_step", pair)):
            out[f"{key}_ms"] = time_ms(fn, **WIDE_PRIMED) / WIDE_STEPS
            out[f"{key}_call_ms"] = time_ms(fn, **WIDE_CALLED) / WIDE_STEPS
    return out


def gru_scan_f64(xp, h0, w, b, mask, reverse):
    """The GRU scan in float64 on its inputs' values, written here apart
    from the port: the exact function both GRU routes round (h and the
    pre-activations never rounded); gates r, z, n; a held row keeps h.
    (h_last, hs)."""
    x, h, w, b = (t.double() for t in (xp, h0, w, b))
    n_steps, hidden = x.shape[1], h.shape[-1]
    hs = [None] * n_steps
    for t in (range(n_steps - 1, -1, -1) if reverse else range(n_steps)):
        xr, xz, xn = x[:, t].split(hidden, dim=-1)
        hr, hz, hn = (h @ w.t() + b).split(hidden, dim=-1)
        r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
        h_new = (1 - z) * torch.tanh(xn + r * hn) + z * h
        if mask is not None:
            h_new = torch.where(mask[:, t, None] != 0, h_new, h)
        hs[t], h = h_new, h_new
    return h, torch.stack(hs, dim=1)


def gru_step_witness(batch, hidden, dtype, masked, gen, dev) -> dict:
    """The GRU route's scan, forward and gradients (h_last, hs; dxp, dh0,
    dW_hh, db_hh at unit cotangents), its forward through the fused step
    and through the pair (the plan forced off: cuBLAS's ``addmm`` and W1),
    the backward the fused backward step in both; and a third time, the
    fused forward with the backward through W2 and cuBLAS's products (its
    plan forced off: ``w2_*``); each against :func:`gru_scan_f64` and its
    float64 gradients.  ``bwd_pooled_ratio``: the root mean square of the
    gradients' relative distances through the fused backward over that
    through W2's."""
    from fmda_tpu_torch.ops import wide_scan as ws

    (xp, h0, w, b), _ = wide_scan_inputs("gru", batch, hidden, dtype, gen,
                                         dev)
    mask = persist_mask(batch, gen, dev) if masked else None
    cots = [(torch.rand(s, generator=gen, device=dev) * 2 - 1).to(dtype)
            for s in ((batch, hidden), (batch, WIDE_STEPS, hidden))]
    args64 = [t.double().requires_grad_() for t in (xp, h0, w, b)]
    out64 = gru_scan_f64(*args64, mask, False)
    exact = [o.detach() for o in out64] + [
        g.detach() for g in torch.autograd.grad(
            out64, args64, [c.double() for c in cots])]
    del out64, args64

    def route():
        args = [t.clone().requires_grad_() for t in (xp, h0, w, b)]
        h, hs = ws.gru_wide_scan(*args, mask=mask)
        return [h.detach(), hs.detach(),
                *torch.autograd.grad([h, hs], args, cots)]

    fused = route()
    with pair_gru():
        pair = route()
    with pair_gru_bwd():
        w2 = route()
    torch.cuda.synchronize()
    f_rel, f_rms = witness_errors(fused, exact)
    p_rel, p_rms = witness_errors(pair, exact)
    w_rel, w_rms = witness_errors(w2, exact)
    grads = slice(2, None)  # dxp, dh0, dW_hh, db_hh
    return dict(batch=batch, hidden=hidden,
                dtype=str(dtype).replace("torch.", ""), masked=masked,
                outputs=list(STEP_WITNESS_OUTPUTS), fused_rel=f_rel,
                pair_rel=p_rel, fused_rms=f_rms, pair_rms=p_rms,
                rms_ratio=[p / max(q, 1e-300) for p, q in zip(f_rms, p_rms)],
                w2_rel=w_rel, w2_rms=w_rms,
                bwd_pooled_ratio=math.sqrt(
                    sum(f * f for f in f_rms[grads])
                    / max(sum(w * w for w in w_rms[grads]), 1e-300)))


def phase_step_witness(device: str = "cuda") -> list:
    """:func:`gru_step_witness` at STEP_WITNESS_CASES: every output of the
    fused route within WITNESS_RMS_RATIO of the pair's root mean square
    distance from the float64 witness, and its largest difference within
    WITNESS_TOL of the witness's largest entry."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    rows = []
    for batch, hidden, dtype, masked in STEP_WITNESS_CASES:
        row = gru_step_witness(batch, hidden, dtype, masked, gen, dev)
        tol = WITNESS_TOL[row["dtype"]]
        ratio = WITNESS_RMS_RATIO[row["dtype"]]
        row.update(tol=tol, rms_ratio_bound=ratio)
        row["ok"] = (max(row["fused_rel"]) <= tol
                     and max(row["rms_ratio"]) <= ratio)
        emit("wide step witness", **{k: v for k, v in row.items()
                                     if not k.startswith(("w2_", "bwd_"))})
        check(row["ok"], f"the fused GRU route is farther from the float64 "
              f"witness than the pair: {row}")
        bwd = dict(batch=batch, hidden=hidden, dtype=row["dtype"],
                   masked=masked, outputs=list(STEP_WITNESS_OUTPUTS[2:]),
                   fused_rel=row["fused_rel"][2:],
                   w2_rel=row["w2_rel"][2:], fused_rms=row["fused_rms"][2:],
                   w2_rms=row["w2_rms"][2:],
                   pooled_ratio=row["bwd_pooled_ratio"], tol=tol,
                   pooled_ratio_bound=BWD_WITNESS_RATIO)
        bwd["ok"] = (max(bwd["fused_rel"]) <= tol
                     and bwd["pooled_ratio"] <= BWD_WITNESS_RATIO)
        emit("wide bwd step witness", **bwd)
        check(bwd["ok"], f"the fused GRU backward is farther from the "
              f"float64 witness than W2 and the mm: {bwd}")
        rows.append(row)
    return rows


def wide_scan_inputs(cell, batch, hidden, dtype, gen, dev, *, grad=False):
    """A scan's inputs (xp, h0[, c0], W_hh, b_hh), uniform from ``gen``,
    nonzero initial states, and cotangents of its outputs in
    +-COT_SCALE."""
    gh = (3 if cell == "gru" else 4) * hidden
    scale = 1.0 / math.sqrt(hidden)

    def rand(*shape, s=1.0):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * s).to(dtype)

    states = 1 if cell == "gru" else 2
    args = [rand(batch, WIDE_STEPS, gh, s=2.0),
            *[rand(batch, hidden, s=0.5) for _ in range(states)],
            rand(gh, hidden, s=scale), rand(gh, s=scale)]
    cots = [rand(batch, hidden, s=COT_SCALE) for _ in range(states)]
    cots.append(rand(batch, WIDE_STEPS, hidden, s=COT_SCALE))
    if grad:
        args = [a.requires_grad_() for a in args]
    return args, cots


def wide_scan_outputs(cell, scan, args, reverse):
    """A scan's outputs as a list: (h_last, hs) or (h_last, c_last, hs)."""
    out = scan(*args, reverse=reverse)
    if cell == "gru":
        return list(out)
    (h_last, c_last), hs = out
    return [h_last, c_last, hs]


def phase_wide_route(n_features: int, device: str = "cuda") -> list:
    """(b) The wide route's scans (``gru_wide_scan``, ``lstm_wide_scan``)
    forward and forward + backward against the same scans through the
    kernels' plain versions on the card, at WIDE_SHAPES, both
    directions.  Beside the forward direction's times: the route before
    its redesign (the LSTM's per-step kernels, ``per_step_*``; the GRU's
    ``addmm`` and W1, ``unfused_*``), kernel 1's (or 3's) device-memory
    branch on the same scan, alone and with its backward, where it runs
    (the LSTM pair stops at H = 512), and cuDNN's layer of the same width
    (input projection included, beside the route's own layer), a
    yardstick never on the port's path; for the GRU in bf16 also the
    backward before its redesign (``w2_*``: W2 and a cuBLAS ``mm`` a step,
    the forward fused).  ``ms`` is device time (queue
    primed); ``call_ms`` what a caller waits on an idle card (the route's
    host calls, T or 2 T a direction, are part of it)."""
    from fmda_tpu_torch.ops import gru as gru_ops, lstm as lstm_ops
    from fmda_tpu_torch.ops import gru_wide_bwd_step, gru_wide_step
    from fmda_tpu_torch.ops import wide_scan as ws
    from fmda_tpu_torch.ops.cost import scan_bound, scan_bwd_bound

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    results = []
    for cell in ("gru", "lstm"):
        route = ws.gru_wide_scan if cell == "gru" else ws.lstm_wide_scan
        pair = gru_ops.gru_scan if cell == "gru" else lstm_ops.lstm_scan
        shapes = SCAN_SHAPES[cell]
        for batch, hidden, dtype in WIDE_SHAPES:
            itemsize = torch.tensor([], dtype=dtype).element_size()
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            for reverse in (False, True):
                args, cots = wide_scan_inputs(cell, batch, hidden, dtype,
                                              gen, dev, grad=True)
                with torch.inference_mode():
                    fwd = lambda: wide_scan_outputs(  # noqa: E731
                        cell, route, [a.detach() for a in args], reverse)
                    got = fwd()
                    with plain_wide_gates():
                        want = fwd()
                fwd_err = max((g.float() - w.float()).abs().max().item()
                              for g, w in zip(got, want))

                def fwd_bwd():
                    outs = wide_scan_outputs(cell, route, args, reverse)
                    return torch.autograd.grad(outs, args, cots)

                got = fwd_bwd()
                with plain_wide_gates():
                    want = fwd_bwd()
                torch.cuda.synchronize()
                errs = [(g.float() - w.float()).abs().max().item()
                        for g, w in zip(got, want)]
                rel = [e / max(w.float().abs().max().item(), 1e-30)
                       for e, w in zip(errs, want)]
                finite = all(bool(torch.isfinite(g.float()).all())
                             for g in got)
                row = dict(cell=cell, route=wide_route(cell, batch, hidden,
                                                       itemsize),
                           batch=batch, steps=WIDE_STEPS, hidden=hidden,
                           dtype=str(dtype).replace("torch.", ""),
                           reverse=reverse, fwd_max_abs_err=fwd_err,
                           grad_max_abs_err=max(errs), grad_rel_errs=rel,
                           tol=tol)
                if not reverse:
                    with torch.inference_mode():
                        row.update(ms=time_ms(fwd, **WIDE_PRIMED),
                                   call_ms=time_ms(fwd, **WIDE_CALLED))
                        with plain_wide_gates():
                            row["plain_ms"] = time_ms(
                                fwd, prime=True,
                                prime_cycles=LIBRARY_PRIME_CYCLES,
                                reps=WIDE_PAIR_REPS, warmup=1)
                    row.update(
                        fwd_bwd_ms=time_ms(fwd_bwd, **WIDE_PRIMED),
                        fwd_bwd_call_ms=time_ms(fwd_bwd, **WIDE_CALLED))
                    fb, _ = scan_bwd_bound(batch, WIDE_STEPS, hidden,
                                           itemsize, False,
                                           gates=shapes["gates"],
                                           states=shapes["states"],
                                           elementwise=shapes["bwd_ops"])
                    row["bound_ms"], row["bound_by"] = scan_bound(
                        batch, WIDE_STEPS, hidden, itemsize, False,
                        gates=shapes["gates"], states=shapes["states"],
                        elementwise=shapes["fwd_ops"])
                    row["fwd_bwd_bound_ms"] = row["bound_ms"] + fb
                    if cell == "lstm":
                        row.update(persist_plan=ws.lstm_persist_plan(
                            batch, hidden, dtype, dev), **per_step_times(
                                fwd, fwd_bwd, per_step_lstm))
                    else:
                        row.update(step_plan=gru_wide_step.gru_wide_step_plan(
                            batch, hidden, dtype, dev), **per_step_times(
                                fwd, fwd_bwd, pair_gru, "unfused"))
                        if dtype == torch.bfloat16:
                            # the backward on W2 and the mm, the forward
                            # fused: a backward direction's parent
                            row.update(bwd_step_plan=(
                                gru_wide_bwd_step.gru_wide_bwd_step_plan(
                                    batch, hidden, dtype, dev)),
                                **per_step_times(fwd, fwd_bwd, pair_gru_bwd,
                                                 "w2"))
                    row.update(wide_yardsticks(cell, pair, args, cots, batch,
                                               hidden, dtype, n_features,
                                               gen, dev))
                emit(f"wide route {cell}", **row)
                check(finite, f"non-finite wide-route gradients: {row}")
                # gradients relative to each one's largest entry: dW_hh
                # sums B T rows, and in bf16 one rounding flip of an h
                # moves its bf16 sum by an ulp of a large value
                check(fwd_err <= tol and max(rel) <= tol,
                      f"wide route disagrees with its plain version: {row}")
                results.append(row)
    return results


def per_step_times(fwd, fwd_bwd, route, tag="per_step") -> dict:
    """The same scan on the route before its redesign (``route``: the
    LSTM's per-step kernels, the persistent plan forced off; the GRU's
    pair, the fused step's plan forced off), forward and with its
    backward, device and call ms, keys led by ``tag``."""
    with route():
        with torch.inference_mode():
            out = {f"{tag}_ms": time_ms(fwd, **WIDE_PRIMED),
                   f"{tag}_call_ms": time_ms(fwd, **WIDE_CALLED)}
        out.update({f"{tag}_fwd_bwd_ms": time_ms(fwd_bwd, **WIDE_PRIMED),
                    f"{tag}_fwd_bwd_call_ms": time_ms(fwd_bwd,
                                                      **WIDE_CALLED)})
    return out


def wide_yardsticks(cell, pair, args, cots, batch, hidden, dtype,
                    n_features, gen, dev) -> dict:
    """The times beside the wide route's at one shape: the kernel pair's
    device-memory branch where its hidden limit allows (forward alone and
    with its backward), the route's layer (projection and scan, as
    ``gru_layer``/``lstm_layer`` run it) and cuDNN's layer, forward and
    forward + backward."""
    from fmda_tpu_torch.ops import _cuda_lib
    from fmda_tpu_torch.ops.gru import GRUWeights, gru_layer
    from fmda_tpu_torch.ops.lstm import LSTMWeights, lstm_layer

    out = {}
    limit = 1024 if cell == "gru" else 512
    detached = [a.detach() for a in args]
    if hidden <= limit:
        # its device-memory branch takes 6-300 ms a call here: three
        # repetitions after one warm-up
        out["pair_branch"] = _cuda_lib.fwd_plan(cell, batch, hidden, dtype,
                                                dev.index or 0)["branch"]
        with torch.inference_mode():
            out["pair_ms"] = time_ms(lambda: wide_scan_outputs(
                cell, pair, detached, False), prime=True,
                prime_cycles=LIBRARY_PRIME_CYCLES, reps=WIDE_PAIR_REPS,
                warmup=1)
        out["pair_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            wide_scan_outputs(cell, pair, args, False), args, cots),
            prime=True, prime_cycles=LIBRARY_PRIME_CYCLES,
            reps=WIDE_PAIR_REPS, warmup=1)
    lib, x = library_layer(next(s for s in scan_specs() if s.name == cell),
                           dict(batch=batch, steps=WIDE_STEPS, hidden=hidden,
                                dtype=dtype), n_features, gen, dev, grad=True)
    wrap = GRUWeights if cell == "gru" else LSTMWeights
    weights = wrap(*(p.detach().requires_grad_() for p in (
        lib.weight_ih_l0, lib.weight_hh_l0, lib.bias_ih_l0, lib.bias_hh_l0)))
    layer = gru_layer if cell == "gru" else lstm_layer
    wrt = [x, *weights]

    def route_layer():
        out_ = layer(x, weights)
        return [out_[1], *(out_[0] if cell == "lstm" else (out_[0],))]

    def cudnn_layer():
        o, state = lib(x)
        return [o, *(state if isinstance(state, tuple) else (state,))]

    for name, fn in (("layer", route_layer), ("cudnn", cudnn_layer)):
        with torch.inference_mode():
            out[f"{name}_ms"] = time_ms(fn, **WIDE_PRIMED)
        probe = fn()
        cot = [torch.rand_like(o) * COT_SCALE for o in probe]
        inputs = wrt if name == "layer" else [x, *lib.parameters()]
        out[f"{name}_fwd_bwd_ms"] = time_ms(
            lambda: torch.autograd.grad(fn(), inputs, cot), **WIDE_PRIMED)
        # the backward alone, on a kept graph (kernel 4's yardstick too)
        out[f"{name}_bwd_ms"] = time_ms(
            lambda: torch.autograd.grad(probe, inputs, cot,
                                        retain_graph=True), **WIDE_PRIMED)
    return out


def wide_grads(trainer, state, batch, rng_state):
    """The first step's loss and parameter gradients (not applied), the
    dropout generator set to ``rng_state`` first."""
    state.generator.set_state(rng_state)
    state.model.train()
    logits = state.model(batch.x, generator=state.generator)
    loss = trainer.batch_loss(logits, batch)
    params = [p for p in state.model.parameters() if p.requires_grad]
    return loss.detach(), torch.autograd.grad(loss, params)


class blas_order_step:
    """Inside, the fused GRU step's plain version takes its product as one
    float32 BLAS product, not summed in the kernel's order: with
    :class:`plain_wide_gates`, a plain route that copies nothing of the
    kernel's rounding."""

    def __enter__(self):
        from fmda_tpu_torch.ops import gru_wide_step

        self._ref = ref = gru_wide_step.gru_wide_step_reference
        gru_wide_step.gru_wide_step_reference = (
            lambda xp_t, h, w, b, mask_t=None, plan=None: ref(xp_t, h, w, b,
                                                              mask_t))
        return self

    def __exit__(self, *exc):
        from fmda_tpu_torch.ops import gru_wide_step

        gru_wide_step.gru_wide_step_reference = self._ref
        return False


def first_step_blas(trainer, state, batch, rng_state, loss_k,
                    grads_k) -> dict:
    """The gru wide path's first step through the fused route (``loss_k``,
    ``grads_k``) and through the pair (:func:`pair_gru`), each against the
    same step through the plain versions with the BLAS-order product
    (:class:`blas_order_step`): the losses' distances, each parameter's
    root mean square gradient distance over the plain gradient's, and the
    fused route's distance over the pair's (``rms_ratio``; ``pooled_ratio``
    over every parameter's relative distance at once)."""
    with plain_wide_gates(), blas_order_step():
        loss_b, grads_b = wide_grads(trainer, state, batch, rng_state)
    with pair_gru():
        loss_p, grads_p = wide_grads(trainer, state, batch, rng_state)
    torch.cuda.synchronize()

    def rel_rms(a, b):
        b = b.double()
        d = (a.double() - b).pow(2).mean().sqrt()
        return float(d / b.pow(2).mean().sqrt().clamp_min(1e-300))

    fused = [rel_rms(a, b) for a, b in zip(grads_k, grads_b)]
    pair = [rel_rms(a, b) for a, b in zip(grads_p, grads_b)]
    return dict(loss_fused_err=abs(float(loss_k) - float(loss_b)),
                loss_pair_err=abs(float(loss_p) - float(loss_b)),
                fused_rel_rms=fused, pair_rel_rms=pair,
                rms_ratio=[f / max(p, 1e-300) for f, p in zip(fused, pair)],
                pooled_ratio=math.sqrt(sum(f * f for f in fused)
                                       / max(sum(p * p for p in pair),
                                             1e-300)))


def wide_trainer(directory: str, device: str, cell: str):
    """The wide path's set-up: (the framework config, flagship_wide's model
    config for ``cell``, the train config, a WIDE_ROWS warehouse in
    ``directory`` (the train cell's random walk, cut), its Trainer, its
    ChunkDataset)."""
    from fmda_tpu_torch.config import FrameworkConfig, TrainConfig
    from fmda_tpu_torch.data.pipeline import ChunkDataset
    from fmda_tpu_torch.data.synthetic import random_walk_rows
    from fmda_tpu_torch.stream import Warehouse
    from fmda_tpu_torch.train import Trainer, imbalance_weights_from_source

    cfg = FrameworkConfig()
    fc, window = cfg.features, cfg.train.window
    model_cfg = model_config(cell, hidden_size=1024, dtype="bfloat16",
                             dropout=0.5, spatial_dropout=True)
    train_cfg = TrainConfig(batch_size=WIDE_BATCH, window=window,
                            chunk_size=WIDE_CHUNK, epochs=1)
    wh = Warehouse(cfg.features, dataclasses.replace(
        cfg.warehouse, path=f"{directory}/wide_{cell}.sqlite"))
    wh.insert_rows(random_walk_rows(cfg.features.table_columns(), WIDE_ROWS,
                                    seed=SEED))
    weights = imbalance_weights_from_source(wh)
    trainer = Trainer(model_cfg, train_cfg, weight=weights[0],
                      pos_weight=weights[1], device=device)
    dataset = ChunkDataset(wh, train_cfg.chunk_size, window,
                           bid_levels=fc.bid_levels, ask_levels=fc.ask_levels,
                           cache_chunks=train_cfg.cache_chunks)
    return cfg, model_cfg, train_cfg, wh, trainer, dataset


def phase_wide_path(directory: str, device: str = "cuda",
                    cell: str = "gru") -> dict:
    """(c) The JAX package's ``flagship_wide`` (bench.py: H = 1024, bf16,
    batch 512, T = 30, F = 108, dropout 0.5 with spatial dropout, the
    model's defaults otherwise) through the port's entry points, every
    scan on the wide route: the first step's loss and gradients (the same
    seeded dropout generator) against the same step through the gate
    kernels' plain versions on the card; ``Trainer.fit`` for one epoch of
    a WIDE_ROWS warehouse (the train cell's random walk, cut); its
    checkpoint; a backtest of WIDE_BACKTEST_BATCHES batches, against the
    plain versions; the Predictor on WIDE_SIGNALS signals; the
    bidirectional streaming core from the trained weights for
    WIDE_STREAM_TICKS ticks, its backward direction's re-scan of the
    window-row ring on the wide route, against the plain versions.
    Kernels 1-4 and ``scan_dw`` launch 0 times; for gru the fused step
    (``gru_wide_step_fwd``) T times a scan and direction and the fused
    backward step (``gru_wide_bwd_step``) T times a backward call and
    direction, the first step's counts checked too, W1 and W2 0 times; for
    lstm the persistent scans
    once a scan and direction (the forward) and once a backward call and
    direction, the gate kernels W3 and W4 0 times.  For gru also the
    first step against the plain versions with the step's product in
    BLAS order, beside the pair (:func:`first_step_blas`), and every
    shape the fused steps launched at one ``wide step`` / ``wide bwd step``
    checked.  Returns the path's launch counts."""
    from fmda_tpu_torch.config import (
        DEFAULT_TOPICS, TOPIC_PREDICT_TIMESTAMP, TOPIC_PREDICTION)
    from fmda_tpu_torch.data.pipeline import WindowBatches
    from fmda_tpu_torch.serve import (
        Predictor, StreamingBiGRUBidirectional, backtest_from_checkpoint)
    from fmda_tpu_torch.stream import InProcessBus
    from fmda_tpu_torch.train import save_checkpoint

    t_phase = time.perf_counter()
    cfg, model_cfg, train_cfg, wh, trainer, dataset = wide_trainer(
        directory, device, cell)
    window = cfg.train.window
    route = wide_route(cell, WIDE_BATCH, model_cfg.hidden_size, 2)
    check(route == "wide", f"wide path {cell}: the rule picked {route}")
    train_chunks, val_chunks, _ = dataset.split(train_cfg.val_size,
                                                train_cfg.test_size)
    n_train = sum(len(WindowBatches(dataset, i, WIDE_BATCH))
                  for i in train_chunks)
    n_val = sum(len(WindowBatches(dataset, i, WIDE_BATCH))
                for i in val_chunks)

    # the first step, kernels against plain versions, the same dropout
    state = trainer.init_state()
    batch = trainer.place(next(iter(WindowBatches(dataset, train_chunks[0],
                                                  WIDE_BATCH))))
    rng = state.generator.get_state()
    start_path()
    loss_k, grads_k = wide_grads(trainer, state, batch, rng)
    torch.cuda.synchronize()
    first_counts = launch_counts()
    with plain_wide_gates():
        loss_p, grads_p = wide_grads(trainer, state, batch, rng)
    torch.cuda.synchronize()
    loss_err = abs(float(loss_k) - float(loss_p))
    names = [n for n, q in state.model.named_parameters() if q.requires_grad]
    rels = {n: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for n, a, b in zip(names, grads_k, grads_p)}
    grad_rel = max(rels.values())
    grads_finite = all(bool(torch.isfinite(g).all()) for g in grads_k)
    emit("wide first step", cell=cell, route=route, model=str(model_cfg),
         batch=WIDE_BATCH, steps=window, loss=float(loss_k),
         plain_loss=float(loss_p), loss_abs_err=loss_err,
         grad_max_rel_err=grad_rel, grad_rel_errs=rels, tol=BF16_TOL,
         launches=first_counts)
    check(grads_finite and math.isfinite(float(loss_k)),
          f"wide path {cell}: non-finite first step")
    check(loss_err <= BF16_TOL and grad_rel <= BF16_TOL,
          f"wide path {cell}: the first step's kernels and plain versions "
          f"disagree (loss {loss_err}, gradients {grad_rel})")
    if cell == "gru":
        # one layer, both directions: T fused steps each way and back
        check_launches(first_counts, {STEP_KERNEL: 2 * window,
                                      BWD_KERNEL: 2 * window},
                       "wide first step gru")
        row = first_step_blas(trainer, state, batch, rng, loss_k, grads_k)
        row.update(params=names, rms_ratio_bound=FIRST_STEP_RMS_RATIO)
        row["ok"] = row["pooled_ratio"] <= FIRST_STEP_RMS_RATIO
        emit("wide first step blas", cell=cell, **row)
        check(row["ok"], f"wide path gru: the fused route's first step is "
              f"farther from the BLAS-order plain version than the pair's: "
              f"{row}")

    fwd, bwd = f"{cell}_wide_fwd", f"{cell}_wide_bwd"
    per_forward = 2 * window  # both directions, a launch a step
    per_scan = window  # the stream's re-scan of one direction
    if cell == "lstm":
        # the persistent scans: one launch a direction, at the path's
        # batches and the stream's B = 1 alike
        from fmda_tpu_torch.ops import wide_scan

        for b in (WIDE_BATCH, 1):
            check(wide_scan.lstm_persist_plan(
                b, model_cfg.hidden_size, torch.bfloat16,
                torch.device(device)) is not None,
                f"wide path lstm: the persistent plan hands B = {b} back")
        fwd, bwd, per_forward, per_scan = PERSIST_KERNELS + (2, 1)
    else:
        # the fused steps: one launch a step, forward at the path's batches
        # and the stream's B = 1 alike, backward at the training batch; W1
        # and W2 at 0
        from fmda_tpu_torch.ops import gru_wide_bwd_step, gru_wide_step

        for b in (WIDE_BATCH, 1):
            check(gru_wide_step.gru_wide_step_plan(
                b, model_cfg.hidden_size, torch.bfloat16,
                torch.device(device)) is not None,
                f"wide path gru: the fused step's plan hands B = {b} back")
        check(gru_wide_bwd_step.gru_wide_bwd_step_plan(
            WIDE_BATCH, model_cfg.hidden_size, torch.bfloat16,
            torch.device(device)) is not None,
            f"wide path gru: the fused backward's plan hands B = "
            f"{WIDE_BATCH} back")
        fwd, bwd = STEP_KERNEL, BWD_KERNEL
    # the fused steps' launch shapes from here to the stream's end: each
    # must be one ``wide step`` / ``wide bwd step`` held to its plain
    # version (a leftover recorder after a failure passes every booking on)
    shapes = launch_shapes(STEP_KERNEL, BWD_KERNEL).__enter__()
    start_path()
    t0 = time.perf_counter()
    state, history, _ = trainer.fit(wh, dataset=dataset, initial_state=state)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = launch_counts()
    tr, va = history["train"][-1], history["val"][-1]
    emit("wide fit", cell=cell, route=route, steps=state.step,
         val_batches=n_val, seconds=fit_s,
         ms_per_step=fit_s * 1e3 / max(n_train + n_val, 1),
         train_loss=tr.loss, val_loss=va.loss, launches=fit_counts)
    check(state.step == n_train, f"wide fit {cell}: {state.step} steps, "
          f"expected {n_train}")
    check(all(math.isfinite(m.loss) for m in (tr, va) if n_val or m is tr),
          f"wide fit {cell}: non-finite losses")
    check_launches(fit_counts, {fwd: per_forward * (n_train + n_val),
                                bwd: per_forward * n_train},
                   f"wide {cell} training")

    ckpt = save_checkpoint(f"{directory}/wide_{cell}", state,
                           dataset.final_norm_params)
    ids = (window, window + WIDE_BACKTEST_BATCHES * WIDE_BATCH - 1)

    def run_backtest():
        return backtest_from_checkpoint(
            wh, ckpt, model_cfg, window=window, batch_size=WIDE_BATCH,
            ids=ids, device=device)

    start_path()
    t0 = time.perf_counter()
    bt = run_backtest()
    torch.cuda.synchronize()
    bt_s = time.perf_counter() - t0
    bt_counts = launch_counts()
    with plain_wide_gates():
        plain_bt = run_backtest()
    bt_err = float(abs(bt.probabilities - plain_bt.probabilities).max())
    emit("wide backtest", cell=cell, route=route,
         rows=len(bt.probabilities), batches=WIDE_BACKTEST_BATCHES,
         seconds=bt_s, max_abs_err_vs_plain=bt_err, tol=BF16_TOL,
         launches=bt_counts)
    check(len(bt.probabilities) == WIDE_BACKTEST_BATCHES * WIDE_BATCH,
          f"wide backtest {cell}: {len(bt.probabilities)} rows")
    check(bool(np.isfinite(bt.probabilities).all()),
          f"wide backtest {cell}: non-finite probabilities")
    check(bt_err <= BF16_TOL, f"wide backtest {cell}: kernels and plain "
          f"versions disagree by {bt_err}")
    check_launches(bt_counts, {fwd: per_forward * WIDE_BACKTEST_BATCHES},
                   f"wide {cell} backtest")

    bus = InProcessBus(DEFAULT_TOPICS)
    predictor = Predictor.from_checkpoint(
        ckpt, bus, wh, model_cfg, window=window,
        threshold=cfg.train.prob_threshold, from_end=False,
        max_staleness_s=None, device=device)
    stamps = [ts for _, ts in wh.timestamps_after(len(wh) - WIDE_SIGNALS)]
    start_path()
    preds, lat_ms = [], []
    for ts in stamps:
        bus.publish(TOPIC_PREDICT_TIMESTAMP, {"Timestamp": ts})
        t = time.perf_counter()
        preds += predictor.poll()
        lat_ms.append((time.perf_counter() - t) * 1e3)
    pred_counts = launch_counts()
    published = len(bus.consumer(TOPIC_PREDICTION).poll())
    emit("wide predictor", cell=cell, route=route, signals=WIDE_SIGNALS,
         served=len(preds), published=published,
         p50_ms=statistics.median(lat_ms), max_ms=max(lat_ms),
         launches=pred_counts)
    check(len(preds) == WIDE_SIGNALS == published,
          f"wide predictor {cell}: {len(preds)} served, {published} "
          f"published of {WIDE_SIGNALS}")
    check(all(all(math.isfinite(v) for v in p.probabilities) for p in preds),
          f"wide predictor {cell}: non-finite probabilities")
    check_launches(pred_counts, {fwd: per_forward * WIDE_SIGNALS},
                   f"wide {cell} predictor")

    # the bidirectional streaming core: a carried forward direction (torch
    # ops) and the backward direction's re-scan of the ring, one gate
    # launch a ring slot a tick
    stream_rows = list(wh.fetch(range(1, WIDE_STREAM_TICKS + 1)))
    params, norm = state.model.state_dict(), dataset.final_norm_params

    def stream():
        core = StreamingBiGRUBidirectional(model_cfg, params, norm,
                                           window=window, device=device)
        return np.concatenate([core.step(r) for r in stream_rows])

    stream_route = wide_route(cell, 1, model_cfg.hidden_size, 2)
    start_path()
    t0 = time.perf_counter()
    stream_probs = stream()
    stream_s = time.perf_counter() - t0
    stream_counts = launch_counts()
    with plain_wide_gates():
        stream_err = float(abs(stream_probs - stream()).max())
    emit("wide stream", cell=cell, route=stream_route,
         ticks=WIDE_STREAM_TICKS, window=window, seconds=stream_s,
         max_abs_err_vs_plain=stream_err, tol=BF16_TOL,
         launches=stream_counts)
    check(stream_route == "wide",
          f"wide stream {cell}: the rule picked {stream_route}")
    check(bool(np.isfinite(stream_probs).all()),
          f"wide stream {cell}: non-finite probabilities")
    check(stream_err <= BF16_TOL, f"wide stream {cell}: kernels and plain "
          f"versions disagree by {stream_err}")
    check_launches(stream_counts, {fwd: per_scan * WIDE_STREAM_TICKS},
                   f"wide {cell} stream")
    shapes.__exit__(None, None, None)
    wh.close()
    launched = {k: sorted({sig[:2] for sig in v})
                for k, v in shapes.seen.items()}
    emit("wide path", cell=cell, route=route,
         seconds=time.perf_counter() - t_phase,
         step_shapes=launched[STEP_KERNEL],
         bwd_step_shapes=launched[BWD_KERNEL])
    checked = {(b, h) for b, h, _ in STEP_SHAPES + STEP_RAGGED_SHAPES}
    for kernel, seen in launched.items():
        check(set(seen) <= checked, f"wide path {cell}: {kernel} launched "
              f"at (batch, hidden) {seen}, checked at {sorted(checked)} "
              f"only")
    return add_counts(add_counts(add_counts(fit_counts, bt_counts),
                                 pred_counts), stream_counts)


def wide_entry(name, rows, launches) -> dict:
    """A gate kernel's entry of the summary line, at flagship_wide's step
    (WIDE_SHAPES[0]: (512, 1024) bf16), unmasked; ``f32_512``: the same at
    WIDE_SHAPES[1], (256, 512) f32."""
    def case(batch, hidden, dtype):
        return next(r for r in rows if r["kernel"] == name
                    and (r["batch"], r["hidden"]) == (batch, hidden)
                    and r["dtype"] == str(dtype).replace("torch.", "")
                    and not r["masked"])

    main_shape, f32 = (case(*shape) for shape in WIDE_SHAPES)
    return {
        "name": name,
        "route": "cuda",
        "source": WIDE_SOURCE,
        "replaces": WIDE_REPLACES[name.split("_")[0]],
        "replaces_kind": "the lax.scan route's fused gate algebra, no "
                         "pallas_call",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["kernel"] == name),
        **{k: main_shape[k] for k in TIMES},
        "shape": list(WIDE_SHAPES[0][:2]),
        "dtype": str(WIDE_SHAPES[0][2]).replace("torch.", ""),
        "f32_512": {k: f32[k] for k in TIMES},
    }


def persist_entry(name, rows, route_rows, launches) -> dict:
    """A persistent scan's entry of the summary line, at flagship_wide's
    (512, 30, 1024) bf16, unmasked, forward direction; ``f32_512`` and
    ``b1``: the same at (256, 30, 512) f32 and (1, 30, 1024) bf16.
    ``library_ms``: cuDNN's LSTM layer at the same shape (its input
    projection included; its forward for the forward, its backward on a
    kept graph for the sweep), never on the port's path."""
    def case(batch, hidden, dtype):
        return next(r for r in rows if r["kernel"] == name
                    and (r["batch"], r["hidden"]) == (batch, hidden)
                    and r["dtype"] == str(dtype).replace("torch.", "")
                    and not (r["masked"] or r["reverse"]))

    main_shape, f32, b1 = (case(*shape) for shape in PERSIST_SHAPES)
    lib = next(r for r in route_rows if r["cell"] == "lstm"
               and (r["batch"], r["hidden"]) == PERSIST_SHAPES[0][:2]
               and not r["reverse"])
    times = {k: main_shape[k] for k in TIMES if k != "library_ms"}
    times["library_ms"] = lib["cudnn_ms" if name == "lstm_persist_fwd"
                              else "cudnn_bwd_ms"]
    return {
        "name": name,
        "route": "cuda",
        "source": PERSIST_SOURCE,
        "replaces": WIDE_REPLACES["lstm"],
        "replaces_kind": "the lax.scan route's whole scan, no pallas_call",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["kernel"] == name),
        **times,
        "shape": [PERSIST_SHAPES[0][0], WIDE_STEPS, PERSIST_SHAPES[0][1]],
        "dtype": str(PERSIST_SHAPES[0][2]).replace("torch.", ""),
        "plan": main_shape["plan"],
        "l2_bytes_per_step": main_shape["l2_bytes_per_step"],
        "f32_512": {k: f32[k] for k in TIMES if k != "library_ms"},
        "b1": {k: b1[k] for k in TIMES if k != "library_ms"},
    }


def step_entry(rows, launches) -> dict:
    """The fused GRU step's entry of the summary line, at flagship_wide's
    step (STEP_SHAPES[0]: (512, 1024) bf16), unmasked; ``b1``: the same at
    (1, 1024).  ``library_ms`` is null (no one PyTorch call computes the
    step); ``library_pair_ms`` is the ``addmm`` and
    ``_thnn_fused_gru_cell``, ``pair_ms`` the ``addmm`` and W1, each a lone
    launch; ``scan_step_ms`` and ``pair_scan_step_ms`` a step of a scan
    through the fused step and through the pair."""
    def case(batch, hidden, dtype):
        return next(r for r in rows if "ms" in r
                    and (r["batch"], r["hidden"]) == (batch, hidden)
                    and r["dtype"] == str(dtype).replace("torch.", ""))

    main_shape, b1 = (case(*shape) for shape in STEP_SHAPES)
    extra = ("pair_ms", "thnn_cell_ms", "library_pair_ms", "scan_step_ms",
             "pair_scan_step_ms")
    return {
        "name": STEP_KERNEL,
        "route": "cuda",
        "source": STEP_SOURCE,
        "replaces": WIDE_REPLACES["gru"],
        "replaces_kind": "the lax.scan route's step: its product and fused "
                         "gate algebra, no pallas_call",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **{k: main_shape[k] for k in TIMES + extra},
        "shape": list(STEP_SHAPES[0][:2]),
        "dtype": str(STEP_SHAPES[0][2]).replace("torch.", ""),
        "plan": main_shape["plan"],
        "b1": {k: b1[k] for k in TIMES + extra},
    }


def bwd_entry(rows, launches) -> dict:
    """The fused GRU backward step's entry of the summary line, at
    flagship_wide's step (STEP_SHAPES[0]: (512, 1024) bf16), unmasked, a
    lone launch; ``b1``: the same at (1, 1024).  ``library_ms`` is null
    (no one PyTorch call computes the step); ``library_pair_ms`` is
    ``_thnn_fused_gru_cell_backward`` and the ``mm``, ``pair_ms`` W2 and
    the ``mm``; ``scan_step_ms`` and ``pair_scan_step_ms`` a step of a
    sweep through the fused step and through the pair (``*_call_ms``: a
    caller's wait)."""
    def case(batch, hidden, dtype):
        return next(r for r in rows if "ms" in r
                    and (r["batch"], r["hidden"]) == (batch, hidden)
                    and r["dtype"] == str(dtype).replace("torch.", ""))

    main_shape, b1 = (case(*shape) for shape in STEP_SHAPES)
    extra = ("pair_ms", "library_pair_ms", "scan_step_ms",
             "pair_scan_step_ms", "scan_step_call_ms",
             "pair_scan_step_call_ms")
    return {
        "name": BWD_KERNEL,
        "route": "cuda",
        "source": BWD_SOURCE,
        "replaces": WIDE_REPLACES["gru"],
        "replaces_kind": "jax.grad of the lax.scan route's step: the "
                         "product dhh W_hh and the gate gradients, no "
                         "pallas_call",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **{k: main_shape[k] for k in TIMES + extra},
        "shape": list(STEP_SHAPES[0][:2]),
        "dtype": str(STEP_SHAPES[0][2]).replace("torch.", ""),
        "plan": main_shape["plan"],
        "b1": {k: b1[k] for k in TIMES + extra},
    }


def median_ms(fn, items) -> float:
    """Median host time of ``fn(item)`` over ``items``, in ms."""
    out = []
    for item in items:
        t = time.perf_counter()
        fn(item)
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def p99(values) -> float:
    return sorted(values)[math.ceil(0.99 * len(values)) - 1]


def breakdown(wh, ckpt, model_cfg, window, norm, stamps, device):
    """Where a signal's and a backtest batch's time goes: the warehouse on
    the host against the forward on the card (host clock, each forward
    ended by a synchronize; medians over the signals or batches)."""
    from fmda_tpu_torch.data.normalize import normalize
    from fmda_tpu_torch.data.windows import window_index_matrix
    from fmda_tpu_torch.serve.predictor import load_model, make_batched_forward
    from fmda_tpu_torch.train.checkpoint import restore_checkpoint

    def on_device(fn):
        def run(item):
            fn(item)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
        return run

    tree, _ = restore_checkpoint(ckpt)
    model = load_model(model_cfg, tree["params"], torch.device(device))
    forward = make_batched_forward(model)
    x_min = torch.as_tensor(norm.x_min, device=device)
    x_range = torch.as_tensor(norm.x_max - norm.x_min, device=device)
    ids = [wh.id_for_timestamp(ts) for ts in stamps]
    windows = [wh.fetch(range(i - window + 1, i + 1))[None] for i in ids]
    t = time.perf_counter()
    rows = normalize(wh.fetch(range(1, len(wh) + 1)), norm)
    fetch_all_s = time.perf_counter() - t
    widx = window_index_matrix(len(rows), window)
    starts = range(0, len(widx) - BATCH + 1, BATCH)
    batches = [rows[widx[s:s + BATCH]] for s in starts]
    with torch.inference_mode():
        return dict(
            signal_lookup_ms=median_ms(wh.id_for_timestamp, stamps),
            signal_fetch_ms=median_ms(
                lambda i: wh.fetch(range(i - window + 1, i + 1)), ids),
            signal_forward_ms=median_ms(on_device(
                lambda x: forward(x_min, x_range,
                                  torch.from_numpy(x).to(device)).cpu()),
                windows),
            backtest_fetch_normalize_s=fetch_all_s,
            batch_gather_ms=median_ms(lambda s: rows[widx[s:s + BATCH]],
                                      starts),
            batch_forward_ms=median_ms(on_device(
                lambda x: model(torch.from_numpy(x).to(device))), batches))


def device_share(fn, *, host_activity: bool = True) -> dict:
    """Kernel time on the card while ``fn`` runs, from torch.profiler's
    CUDA activity, against the wall time (profiler on, so the wall time
    is inflated and the share a lower bound), ``device_ops``, the kernels
    and copies the card ran, and ``port_kernels_ms``, the device time of
    each of the port's kernels.  ``busy_share`` is None when the
    profiler saw no device activity.  ``host_activity=False`` records the
    device's activity alone, which adds less to the host's time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = ([ProfilerActivity.CPU] if host_activity else []) + [
        ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    per_kernel, device_ops = {}, 0
    for evt in prof.key_averages():
        # a user annotation (Adam's step, say) also shows on the device's
        # timeline as a span around its kernels: not kernel time
        if (evt.device_type == DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            per_kernel[evt.key] = evt.self_device_time_total / 1e3
            device_ops += evt.count
    device_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    # the port's own kernels by name, every instance summed
    port = {}
    for name, ms in per_kernel.items():
        found = re.search(r"namespace\)::(\w+_kernel)\b", name)
        if found:
            port[found.group(1)] = port.get(found.group(1), 0.0) + ms
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms if device_ms else None,
                device_ops=device_ops,
                top_kernels_ms={k[:60]: v for k, v in top},
                port_kernels_ms=port)


def make_warehouse(directory: str):
    """The 20,000-row random-walk warehouse both paths read, in
    ``directory``; the default schema (108 features)."""
    from fmda_tpu_torch.config import FrameworkConfig
    from fmda_tpu_torch.data.synthetic import random_walk_rows
    from fmda_tpu_torch.stream import Warehouse

    cfg = FrameworkConfig()
    t0 = time.perf_counter()
    wh = Warehouse(cfg.features, dataclasses.replace(
        cfg.warehouse, path=f"{directory}/wh.sqlite"))
    wh.insert_rows(random_walk_rows(cfg.features.table_columns(),
                                    WAREHOUSE_ROWS, seed=SEED))
    check(len(wh.x_fields) == cfg.model.n_features,
          f"warehouse serves {len(wh.x_fields)} features, model takes "
          f"{cfg.model.n_features}")
    emit("warehouse", rows=len(wh), features=len(wh.x_fields),
         seconds=time.perf_counter() - t0)
    return wh


def launch_counts() -> dict:
    """Every kernel's launch count, by kernel name."""
    from fmda_tpu_torch.ops import launch_counts as counts

    return counts()


def start_path() -> None:
    """A path starts: every kernel's launch count to 0."""
    from fmda_tpu_torch.ops import reset_launch_counts

    reset_launch_counts()


def check_launches(counts: dict, expected: dict, what: str) -> None:
    """``counts`` (from :func:`launch_counts`) must be ``expected`` and 0
    for every other kernel."""
    want = {k: expected.get(k, 0) for k in counts}
    check(counts == want, f"{what} launched {counts}, expected {want}")


def forward_kernel(cell: str):
    """The kernel a family's window forward launches at full width (one
    layer), and how often a forward: gru and lstm their forward scan once a
    direction, attn the flash forward once a layer, the SSM none (it
    re-scans in parallel mode)."""
    return {"gru": ("gru_scan_fwd", 2), "lstm": ("lstm_scan_fwd", 2),
            "attn": ("flash_fwd", 1), "ssm": (None, 0)}[cell]


def train_launches(cell: str, n_train: int, n_val: int) -> dict:
    """What one epoch launches: the family's forward kernel at every train
    step and val batch, its backward kernels at every train step (for gru
    and lstm a backward scan, whose weight gradient is scan_dw's kernel;
    for attn the fused backward, one launch: the model's (T, D) = (30, 8)
    fuses, and the sweeps launch 0 times)."""
    fwd, per_forward = forward_kernel(cell)
    if fwd is None:
        return {}
    backward = ({"flash_bwd": n_train}
                if cell == "attn"
                else {f"{cell}_scan_bwd": per_forward * n_train,
                      "scan_dw": per_forward * n_train})
    return {fwd: per_forward * (n_train + n_val), **backward}


def model_config(cell: str, **fields):
    """``FrameworkConfig().model`` (full width) with ``cell`` and
    ``fields``."""
    from fmda_tpu_torch.config import FrameworkConfig

    return dataclasses.replace(FrameworkConfig().model, cell=cell, **fields)


def phase_path(wh, directory: str, device: str = "cuda", cell: str = "gru"):
    """The serving slice at full width, on the card and again on the CPU,
    for one cell family.  Returns the path's launch counts (two forward
    scans a forward for gru and lstm, one flash forward for attn, none for
    ssm)."""
    from fmda_tpu_torch.config import (
        DEFAULT_TOPICS, FrameworkConfig, TOPIC_PREDICT_TIMESTAMP,
        TOPIC_PREDICTION)
    from fmda_tpu_torch.data.normalize import chunk_norm_params
    from fmda_tpu_torch.models import build_model
    from fmda_tpu_torch.serve import Predictor, backtest_from_checkpoint
    from fmda_tpu_torch.serve.backtest import trading_summary
    from fmda_tpu_torch.stream import InProcessBus
    from fmda_tpu_torch.train.checkpoint import save_checkpoint

    cfg = FrameworkConfig()
    fc, window = cfg.features, cfg.train.window
    model_cfg = model_config(cell)
    threshold = cfg.train.prob_threshold
    t0 = time.perf_counter()
    n = len(wh)
    x_all = wh.fetch(range(1, n + 1))
    norm = chunk_norm_params(x_all, wh.x_fields, bid_levels=fc.bid_levels,
                             ask_levels=fc.ask_levels)
    model = build_model(
        model_cfg, generator=torch.Generator().manual_seed(SEED))
    ckpt = save_checkpoint(f"{directory}/ckpt", model.state_dict(), norm)
    setup_s = time.perf_counter() - t0
    emit("path setup", cell=cell, rows=n, features=len(wh.x_fields),
         model=str(model_cfg), window=window, seconds=setup_s)

    def run_backtest(device, **kw):
        return backtest_from_checkpoint(
            wh, ckpt, model_cfg, window=window, threshold=threshold,
            batch_size=BATCH, device=device, **kw)

    stamps = [ts for _, ts in wh.timestamps_after(n - SIGNALS)]

    def serve(device):
        bus = InProcessBus(DEFAULT_TOPICS)
        predictor = Predictor.from_checkpoint(
            ckpt, bus, wh, model_cfg, window=window, threshold=threshold,
            from_end=False, max_staleness_s=None, device=device)
        preds, lat_ms = [], []
        for ts in stamps:
            bus.publish(TOPIC_PREDICT_TIMESTAMP, {"Timestamp": ts})
            t = time.perf_counter()
            preds += predictor.poll()
            lat_ms.append((time.perf_counter() - t) * 1e3)
        published = len(bus.consumer(TOPIC_PREDICTION).poll())
        return preds, lat_ms, published, predictor.serve_errors

    # warm-up: cuBLAS handles and module loads, before the counted run
    run_backtest(device, ids=(window, window + BATCH))
    torch.cuda.synchronize()

    fwd, per_forward = forward_kernel(cell)
    start_path()
    t0 = time.perf_counter()
    gpu_bt = run_backtest(device)
    torch.cuda.synchronize()
    bt_s = time.perf_counter() - t0
    bt_launches = launch_counts().get(fwd, 0)
    gpu_preds, lat_ms, published, errors = serve(device)
    counts = launch_counts()  # the path ends here
    pred_launches = counts.get(fwd, 0) - bt_launches

    served = len(gpu_bt.probabilities)
    n_batches = math.ceil(served / BATCH)
    check_launches(counts, {fwd: per_forward * (n_batches + SIGNALS)}
                   if fwd else {}, f"{cell} serving")
    m = gpu_bt.metrics
    emit("path backtest", cell=cell, rows=served, batch=BATCH,
         batches=n_batches, seconds=bt_s,
         rows_per_s=served / bt_s, launches=bt_launches,
         accuracy=float(m.accuracy), hamming=float(m.hamming),
         fbeta=[float(v) for v in m.fbeta],
         overall_edge=trading_summary(gpu_bt)["overall"].edge)
    check(served == n - window + 1, f"backtest served {served} rows")
    check(bt_launches == per_forward * n_batches,
          f"backtest launched its kernel {bt_launches} times, "
          f"expected {per_forward * n_batches}")
    check(bool(torch.isfinite(torch.from_numpy(gpu_bt.probabilities))
               .all()), "non-finite backtest probabilities")
    emit("path predictor", cell=cell, signals=SIGNALS, served=len(gpu_preds),
         published=published, serve_errors=errors,
         launches=pred_launches, p50_ms=statistics.median(lat_ms),
         p99_ms=p99(lat_ms),
         mean_ms=statistics.fmean(lat_ms))
    check(len(gpu_preds) == SIGNALS and published == SIGNALS,
          f"{len(gpu_preds)} predictions served, {published} published, "
          f"of {SIGNALS} signals")
    check(pred_launches == per_forward * SIGNALS,
          f"predictor launched its kernel {pred_launches} times, "
          f"expected {per_forward * SIGNALS}")
    emit("path breakdown", cell=cell, **breakdown(wh, ckpt, model_cfg, window,
                                       norm, stamps, device))
    if torch.device(device).type == "cuda":
        emit("path device share", cell=cell, backtest=device_share(
            lambda: run_backtest(device, ids=(
                window, window + PATH_SHARE_BATCHES * BATCH - 1)),
            host_activity=False), backtest_batches=PATH_SHARE_BATCHES,
            predictor=device_share(lambda: serve(device),
                                   host_activity=False),
            profiler="device activity only")

    # the same port on the CPU: plain versions, no kernel
    cpu_bt = run_backtest("cpu")
    cpu_preds, _, _, _ = serve("cpu")
    bt_err = float(abs(gpu_bt.probabilities - cpu_bt.probabilities).max())
    pr_err = max(abs(a - b) for g, c in zip(gpu_preds, cpu_preds)
                 for a, b in zip(g.probabilities, c.probabilities))
    same_labels = ([p.labels for p in gpu_preds]
                   == [p.labels for p in cpu_preds])
    same_metrics = all(
        (a == b).all() for a, b in zip(gpu_bt.metrics, cpu_bt.metrics))
    emit("path vs cpu", cell=cell, backtest_max_abs_err=bt_err,
         predictor_max_abs_err=pr_err, labels_equal=same_labels,
         backtest_metrics_equal=bool(same_metrics), tol=PATH_TOL)
    check(bt_err <= PATH_TOL and pr_err <= PATH_TOL,
          "GPU and CPU probabilities disagree")
    check(same_labels, "GPU and CPU predicted labels differ")
    return counts


def train_breakdown(trainer, state, dataset, train_chunks, device):
    """Where a train step's time goes, piece by piece, each piece ended by
    a synchronize (host clock; medians over the first 16 batches): host
    compose (a chunk's window gather, per batch, and the batch slice), the
    copy to the card, forward + loss, backward, clip + Adam, metrics, and
    a whole step.  The step's own pieces (forward to metrics) must add up
    to the whole step within BREAKDOWN_TOL, so the split cannot drift from
    what ``Trainer.train_step`` does."""
    from fmda_tpu_torch.data.pipeline import WindowBatches

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t) * 1e3

    gathers = []
    for idx in train_chunks[:3]:  # the gather behind every pass's chunks
        t = time.perf_counter()
        x_windows, _ = dataset.windows(idx, dataset.norm_params[idx])
        gathers.append((time.perf_counter() - t) * 1e3 / math.ceil(
            len(x_windows) / BATCH))
    host = [b for idx in train_chunks[:2]
            for b in WindowBatches(dataset, idx, BATCH)][:16]
    in_step = ("forward", "backward", "optimizer", "metrics")
    pieces = {k: [] for k in ("slice", "h2d", *in_step, "step")}

    def forward(placed):
        state.optimizer.zero_grad(set_to_none=True)
        logits = state.model(placed.x, generator=state.generator)
        return logits, trainer.batch_loss(logits, placed)

    for b in host:
        t = time.perf_counter()
        next(iter(WindowBatches(dataset, train_chunks[0], BATCH)))
        pieces["slice"].append((time.perf_counter() - t) * 1e3)
        placed, ms = timed(lambda: trainer.place(b))
        pieces["h2d"].append(ms)
        state.model.train()
        (logits, loss), ms = timed(lambda: forward(placed))
        pieces["forward"].append(ms)
        _, ms = timed(loss.backward)
        pieces["backward"].append(ms)
        _, ms = timed(lambda: trainer.apply_gradients(state))
        pieces["optimizer"].append(ms)
        _, ms = timed(lambda: trainer.batch_metrics(logits.detach(), placed))
        pieces["metrics"].append(ms)
        _, ms = timed(lambda: trainer.train_step(state, placed))
        pieces["step"].append(ms)
    # steps back to back on placed batches, one synchronize at the end:
    # the mean step time when the host runs ahead of the card
    placed = [trainer.place(b) for b in host]
    sync()
    t = time.perf_counter()
    for b in placed:
        trainer.train_step(state, b)
    sync()
    out = {"compose_gather_ms_per_batch": statistics.median(gathers)}
    out.update({f"{k}_ms": statistics.median(v) for k, v in pieces.items()})
    out["mean_step_ms"] = (time.perf_counter() - t) * 1e3 / len(placed)
    out["pieces_sum_ms"] = sum(out[f"{k}_ms"] for k in in_step)
    out["pieces_over_step"] = out["pieces_sum_ms"] / out["step_ms"]
    check(abs(out["pieces_over_step"] - 1) <= BREAKDOWN_TOL,
          f"the step's pieces add up to {out['pieces_sum_ms']:.3f} ms, the "
          f"whole step takes {out['step_ms']:.3f} ms: the breakdown no "
          f"longer splits Trainer.train_step ({out}; threads "
          f"{[t.name for t in threading.enumerate()]})")
    return out


def phase_train(wh, directory: str, device: str = "cuda", cell: str = "gru"):
    """The training path at full width for one cell family: Trainer.fit for
    one epoch, then the trained checkpoint backtested on the card.  Returns
    (the epoch's launch counts, train steps, dataset, weights)."""
    from fmda_tpu_torch.config import FrameworkConfig, TrainConfig
    from fmda_tpu_torch.data.pipeline import ChunkDataset, WindowBatches
    from fmda_tpu_torch.serve import backtest_from_checkpoint
    from fmda_tpu_torch.train import (
        Trainer, imbalance_weights_from_source, save_checkpoint)

    cfg = FrameworkConfig()
    fc, window = cfg.features, cfg.train.window
    model_cfg = model_config(cell)
    train_cfg = TrainConfig(batch_size=BATCH, chunk_size=TRAIN_CHUNK,
                            epochs=1)
    t0 = time.perf_counter()
    weights = imbalance_weights_from_source(wh)
    trainer = Trainer(model_cfg, train_cfg, weight=weights[0],
                      pos_weight=weights[1], device=device)
    dataset = ChunkDataset(wh, train_cfg.chunk_size, train_cfg.window,
                           bid_levels=fc.bid_levels, ask_levels=fc.ask_levels,
                           cache_chunks=train_cfg.cache_chunks)
    train_chunks, val_chunks, _ = dataset.split(train_cfg.val_size,
                                                train_cfg.test_size)
    n_train = sum(len(WindowBatches(dataset, i, BATCH)) for i in train_chunks)
    n_val = sum(len(WindowBatches(dataset, i, BATCH)) for i in val_chunks)
    n_windows = sum(len(dataset.windows(i)[0]) for i in train_chunks)
    setup_s = time.perf_counter() - t0
    emit("train setup", cell=cell, model=str(model_cfg), train=str(train_cfg),
         chunks=len(dataset), train_chunks=len(train_chunks),
         val_chunks=len(val_chunks), train_steps=n_train,
         val_batches=n_val, train_windows=n_windows, seconds=setup_s)

    # warm-up: cuBLAS handles, Adam's and the loss's kernels, on a
    # throwaway state, before the counted run
    warm = trainer.init_state()
    for b in list(WindowBatches(dataset, train_chunks[0], BATCH))[:2]:
        trainer.train_step(warm, trainer.place(b))
    torch.cuda.synchronize()

    start_path()
    t0 = time.perf_counter()
    state, history, _ = trainer.fit(wh, dataset=dataset)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = launch_counts()  # the path ends here
    tr, va = history["train"][-1], history["val"][-1]
    emit("train fit", cell=cell, epochs=len(history["train"]), steps=state.step,
         seconds=fit_s, samples_per_s=n_windows / fit_s, launches=counts,
         train_loss=tr.loss, train_accuracy=tr.accuracy,
         val_loss=va.loss, val_accuracy=va.accuracy,
         val_hamming=va.hamming)
    check(state.step == n_train, f"{state.step} steps, expected {n_train}")
    check_launches(counts, train_launches(cell, n_train, n_val),
                   f"{cell} training")
    check(all(math.isfinite(m.loss) for m in (tr, va)),
          f"non-finite losses {tr.loss}, {va.loss}")

    # a second epoch replays the placed batches: its steps, timed whole,
    # then (after the breakdown) under the profiler
    t0 = time.perf_counter()
    state, _, _ = trainer.fit(wh, dataset=dataset, initial_state=state)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    emit("train replay epoch", cell=cell, seconds=replay_s,
         ms_per_batch=replay_s * 1e3 / (n_train + n_val),
         samples_per_s=n_windows / replay_s)
    emit("train breakdown", cell=cell, **train_breakdown(trainer, state, dataset,
                                              train_chunks, device))
    if torch.device(device).type == "cuda":
        emit("train device share", cell=cell, batches=n_train + n_val,
             epoch=device_share(lambda: trainer.fit(
                 wh, dataset=dataset, initial_state=state),
                 host_activity=False), profiler="device activity only")

    # train, then serve: the checkpoint backtested on the card, and a
    # slice of it on the CPU
    ckpt = save_checkpoint(f"{directory}/trained", state,
                           dataset.final_norm_params)
    t0 = time.perf_counter()
    bt = backtest_from_checkpoint(wh, ckpt, model_cfg, window=window,
                                  batch_size=BATCH, device=device)
    torch.cuda.synchronize()
    bt_s = time.perf_counter() - t0
    ids = (window, window + 4 * BATCH - 1)
    on_card = backtest_from_checkpoint(wh, ckpt, model_cfg, window=window,
                                       batch_size=BATCH, ids=ids,
                                       device=device)
    on_cpu = backtest_from_checkpoint(wh, ckpt, model_cfg, window=window,
                                      batch_size=BATCH, ids=ids,
                                      device="cpu")
    err = float(abs(on_card.probabilities - on_cpu.probabilities).max())
    emit("train backtest", cell=cell, checkpoint=os.path.basename(ckpt),
         rows=len(bt.probabilities), seconds=bt_s,
         accuracy=float(bt.metrics.accuracy),
         hamming=float(bt.metrics.hamming), cpu_rows=len(on_cpu.probabilities),
         cpu_max_abs_err=err, tol=PATH_TOL)
    check(len(bt.probabilities) == len(wh) - window + 1,
          f"backtest of the trained checkpoint served "
          f"{len(bt.probabilities)} rows")
    check(bool(torch.isfinite(torch.from_numpy(bt.probabilities)).all()),
          "non-finite probabilities from the trained checkpoint")
    check(err <= PATH_TOL, "trained checkpoint: card and CPU disagree")
    return counts, n_train, dataset, weights


def phase_train_vs_cpu(dataset, weights, device: str = "cuda",
                       cell: str = "gru"):
    """The first TRAIN_VS_CPU_STEPS steps at dropout 0 from the same
    initial weights, on the card and on the CPU: per-step losses and the
    final params compared.  Returns what :func:`steps_vs_cpu` returns."""
    from fmda_tpu_torch.config import TrainConfig
    from fmda_tpu_torch.data.pipeline import WindowBatches

    train_cfg = TrainConfig(batch_size=BATCH, chunk_size=TRAIN_CHUNK)
    train_chunks, _, _ = dataset.split(train_cfg.val_size,
                                       train_cfg.test_size)
    host = [b for idx in train_chunks[:3]
            for b in WindowBatches(dataset, idx, BATCH)]
    return steps_vs_cpu("train vs cpu", host[:TRAIN_VS_CPU_STEPS],
                        TRAIN_VS_CPU_STEPS, train_cfg, weights, device, cell)


def steps_vs_cpu(phase: str, host, n_steps: int, train_cfg, weights,
                 device: str, cell: str, **fields) -> tuple:
    """Train steps over the host batches ``host`` at dropout 0 from the
    same initial weights, on the card and on the CPU: per-step losses and
    the final params within TRAIN_TOL (emitted as ``phase``).  Returns
    (host, weights, train_cfg): the parallel phase's dp world steps the
    gru runs' batches again."""
    from fmda_tpu_torch.train import Trainer

    model_cfg = model_config(cell, dropout=0.0)
    runs = {}
    for dev in (device, "cpu"):
        trainer = Trainer(model_cfg, train_cfg, weight=weights[0],
                          pos_weight=weights[1], device=dev)
        state = trainer.init_state()  # the same weights on both devices
        t0 = time.perf_counter()
        losses = [float(trainer.train_step(state, trainer.place(b))[0])
                  for b in host]
        runs[dev] = (losses, {k: v.detach().cpu() for k, v in
                              state.model.state_dict().items()},
                     time.perf_counter() - t0)
    (g_loss, g_par, g_s), (c_loss, c_par, c_s) = runs[device], runs["cpu"]
    loss_err = max(abs(a - b) for a, b in zip(g_loss, c_loss))
    key_bias_max = None
    if cell == "attn":
        # The key bias adds q . b_k to every score of a query, which the
        # softmax cancels: its gradient is 0 in exact arithmetic, so each
        # device feeds Adam its own rounding noise, which Adam scales to
        # steps of up to the learning rate.  It changes no output (the
        # losses agree); it is held to the drift Adam allows, and the query
        # and value biases are compared with everything else.
        h = model_cfg.hidden_size
        key_bias_max = max(float(par[k][h:2 * h].abs().max())
                           for par in (g_par, c_par) for k in par
                           if k.endswith("qkv.bias"))
        check(key_bias_max <= len(host) * train_cfg.learning_rate,
              f"attn key bias drifted to {key_bias_max}")

    def compared(par):
        if cell != "attn":
            return par
        h = model_cfg.hidden_size
        return {k: torch.cat([v[:h], v[2 * h:]]) if k.endswith("qkv.bias")
                else v for k, v in par.items()}

    g_cmp, c_cmp = compared(g_par), compared(c_par)
    param_err = max(float((g_cmp[k] - c_cmp[k]).abs().max()) for k in g_cmp)
    moved = max(float((g_par[k] - v).abs().max()) for k, v in
                Trainer(model_cfg, train_cfg, device="cpu").init_state()
                .model.state_dict().items())
    emit(phase, cell=cell, steps=len(host), batch=train_cfg.batch_size,
         loss_max_abs_err=loss_err, param_max_abs_err=param_err,
         params_moved=moved, first_loss=g_loss[0], last_loss=g_loss[-1],
         card_seconds=g_s, cpu_seconds=c_s, key_bias_max=key_bias_max,
         tol=TRAIN_TOL, **fields)
    check(len(host) == n_steps, f"only {len(host)} batches")
    check(loss_err <= TRAIN_TOL and param_err <= TRAIN_TOL,
          f"{phase}: training on the card and on the CPU disagree")
    return host, weights, train_cfg


#: the streaming phase's first signal: a predictor started this many rows
#: into the warehouse catches them all up through the recurrence
STREAM_CATCHUP = 2_000
#: the pool phase's fleet: sessions, flushes of all of them, then flushes
#: of the first few padded to a larger bucket through the padding lane
POOL_SESSIONS = 64
POOL_FULL_FLUSHES = 100
POOL_PADDED_FLUSHES = 20
POOL_PADDED_LIVE = 16
POOL_PADDED_BUCKET = 32
POOL_MOVED_TICKS = 10
#: the ssm pool's device ops a flush: one copy of the slots and rows, the
#: fused tick, the probabilities' copy back (and one to spare)
SSM_POOL_MAX_OPS = 4


def serving_setup(wh, cell: str, bidirectional: bool):
    """A seeded random-init model at full width (dropout 0, as the fleet's
    worker builds its model), its ``state_dict`` and the warehouse-wide
    norm stats."""
    from fmda_tpu_torch.config import FrameworkConfig
    from fmda_tpu_torch.data.normalize import chunk_norm_params
    from fmda_tpu_torch.models import build_model

    fc = FrameworkConfig().features
    model_cfg = model_config(cell, bidirectional=bidirectional, dropout=0.0)
    model = build_model(model_cfg,
                        generator=torch.Generator().manual_seed(SEED))
    norm = chunk_norm_params(wh.fetch(range(1, len(wh) + 1)), wh.x_fields,
                             bid_levels=fc.bid_levels,
                             ask_levels=fc.ask_levels)
    return model_cfg, model.state_dict(), norm


def phase_stream(wh, device: str = "cuda", cell: str = "gru",
                 bidirectional: bool = False):
    """Carried-state streaming serving at full width for one family:
    ``StreamingPredictor`` over ``StreamingBiGRU`` (or, ``bidirectional``,
    ``StreamingBiGRUBidirectional``), one signal STREAM_CATCHUP rows in,
    then SIGNALS signals one row apart; the same on the CPU, compared.
    Returns the path's launch counts."""
    from fmda_tpu_torch.config import (
        DEFAULT_TOPICS, FrameworkConfig, TOPIC_PREDICT_TIMESTAMP,
        TOPIC_PREDICTION)
    from fmda_tpu_torch.serve import (
        StreamingBiGRU, StreamingBiGRUBidirectional, StreamingPredictor)
    from fmda_tpu_torch.stream import InProcessBus

    label = "stream bidirectional" if bidirectional else "stream"
    window = FrameworkConfig().runtime.window
    model_cfg, state, norm = serving_setup(wh, cell, bidirectional)
    core_cls = StreamingBiGRUBidirectional if bidirectional else StreamingBiGRU
    after = dict(wh.timestamps_after(STREAM_CATCHUP - 1))
    stamps = [after[STREAM_CATCHUP + k] for k in range(SIGNALS + 1)]
    n_ticks = STREAM_CATCHUP + SIGNALS

    def serve(dev):
        core = core_cls(model_cfg, state, norm, window=window, device=dev)
        bus = InProcessBus(DEFAULT_TOPICS)
        predictor = StreamingPredictor(bus, wh, core, from_end=False)
        preds, lat_ms = [], []
        for ts in stamps:
            bus.publish(TOPIC_PREDICT_TIMESTAMP, {"Timestamp": ts})
            t = time.perf_counter()
            preds += predictor.poll()
            lat_ms.append((time.perf_counter() - t) * 1e3)
        published = len(bus.consumer(TOPIC_PREDICTION).poll())
        return preds, lat_ms, published, core.ticks_seen

    # warm-up: cuBLAS handles and module loads, before the counted run
    warm = core_cls(model_cfg, state, norm, window=window, device=device)
    for row in wh.fetch(range(1, 4)):
        warm.step(row)
    torch.cuda.synchronize()

    start_path()
    preds, lat_ms, published, ticks = serve(device)
    counts = launch_counts()  # the path ends here
    if cell == "ssm":  # the fused tick, every layer, once a tick
        expected = {"ssm_tick": ticks}
    elif bidirectional:  # the backward direction's re-scan, once a tick
        expected = {forward_kernel(cell)[0]: ticks}
    else:
        expected = {}
    signal_ms = lat_ms[1:]
    emit(label, cell=cell, model=str(model_cfg), window=window,
         signals=len(stamps), served=len(preds), published=published,
         ticks=ticks, catchup_ticks=STREAM_CATCHUP,
         catchup_s=lat_ms[0] / 1e3,
         catchup_ticks_per_s=STREAM_CATCHUP / (lat_ms[0] / 1e3),
         p50_ms=statistics.median(signal_ms), p99_ms=p99(signal_ms),
         mean_ms=statistics.fmean(signal_ms), launches=counts)
    check(len(preds) == published == len(stamps) and ticks == n_ticks,
          f"{len(preds)} predictions, {published} published, {ticks} ticks "
          f"for {len(stamps)} signals over {n_ticks} rows")
    check_launches(counts, expected, f"{cell} {label}")
    check(all(np.isfinite(p).all() for _, p, _ in preds),
          "non-finite streaming probabilities")

    # where a signal's time goes: the SQLite lookup and the one-row fetch
    # on the host, the tick (its probabilities brought back to the host)
    core = core_cls(model_cfg, state, norm, window=window, device=device)
    ids = [wh.id_for_timestamp(ts) for ts in stamps[1:]]
    rows = wh.fetch(ids)
    pieces = dict(lookup_ms=median_ms(wh.id_for_timestamp, stamps[1:]),
                  fetch_ms=median_ms(lambda i: wh.fetch(range(i, i + 1)),
                                     ids),
                  tick_ms=median_ms(core.step, rows))
    if torch.device(device).type == "cuda":
        pieces["device_share"] = share = device_share(
            lambda: [core.step(row) for row in rows])
        pieces["device_ops_per_tick"] = share["device_ops"] / len(rows)
    emit(f"{label} breakdown", cell=cell, **pieces)

    cpu_preds, _, _, _ = serve("cpu")
    err = max(float(np.abs(g - c).max())
              for (_, g, _), (_, c, _) in zip(preds, cpu_preds))
    same_labels = [g[2] for g in preds] == [c[2] for c in cpu_preds]
    emit(f"{label} vs cpu", cell=cell, signals=len(cpu_preds),
         max_abs_err=err, labels_equal=same_labels, tol=PATH_TOL)
    check(len(cpu_preds) == len(preds) and err <= PATH_TOL,
          f"{cell} {label}: card and CPU disagree ({err})")
    check(same_labels, f"{cell} {label}: card and CPU labels differ")
    return counts


def phase_pool(wh, device: str = "cuda", cell: str = "gru"):
    """The session pool at full width for one family: POOL_SESSIONS
    sessions, each with its own norms over its own slice of the warehouse,
    POOL_FULL_FLUSHES flushes of all of them, then POOL_PADDED_FLUSHES of
    the first POOL_PADDED_LIVE padded to POOL_PADDED_BUCKET; the same on
    the CPU, compared; then one slot moved.  Returns the path's launch
    counts."""
    from fmda_tpu_torch.config import FrameworkConfig
    from fmda_tpu_torch.data.normalize import chunk_norm_params
    from fmda_tpu_torch.runtime import SessionPool

    cfg = FrameworkConfig()
    fc, rt = cfg.features, cfg.runtime
    check(POOL_SESSIONS in rt.bucket_sizes
          and POOL_PADDED_BUCKET in rt.bucket_sizes,
          f"the flush sizes are not buckets of {rt.bucket_sizes}")
    model_cfg, state, _ = serving_setup(wh, cell, bidirectional=False)
    span = len(wh) // POOL_SESSIONS
    x_all = wh.fetch(range(1, POOL_SESSIONS * span + 1))
    slices = [x_all[i * span:(i + 1) * span] for i in range(POOL_SESSIONS)]
    norms = [chunk_norm_params(sl, wh.x_fields, bid_levels=fc.bid_levels,
                               ask_levels=fc.ask_levels) for sl in slices]
    schedule = ([(POOL_SESSIONS, POOL_SESSIONS)] * POOL_FULL_FLUSHES
                + [(POOL_PADDED_LIVE, POOL_PADDED_BUCKET)]
                * POOL_PADDED_FLUSHES)

    def make_pool(dev):
        return SessionPool(model_cfg, state, capacity=rt.capacity,
                           window=rt.window, device=dev)

    def flush(pool, handles, ticks, live, bucket):
        slots = np.full(bucket, pool.padding_slot, np.int64)
        rows = np.zeros((bucket, len(wh.x_fields)), np.float32)
        for lane in range(live):
            slots[lane] = handles[lane].slot
            rows[lane] = slices[lane][ticks[lane]]
            ticks[lane] += 1
        return pool.step(slots, rows)

    def run(dev):
        pool = make_pool(dev)
        handles = [pool.alloc(f"s{i}", norms[i])
                   for i in range(POOL_SESSIONS)]
        ticks, last, flush_ms = [0] * POOL_SESSIONS, {}, []
        for live, bucket in schedule:
            t = time.perf_counter()
            probs = flush(pool, handles, ticks, live, bucket)
            flush_ms.append((time.perf_counter() - t) * 1e3)
            last.update((i, probs[i]) for i in range(live))
        return pool, handles, ticks, last, flush_ms

    # warm-up: one flush at each bucket on a throwaway pool
    warm = make_pool(device)
    warm_handles = [warm.alloc(f"w{i}") for i in range(POOL_SESSIONS)]
    for live, bucket in sorted(set(schedule)):
        flush(warm, warm_handles, [0] * POOL_SESSIONS, live, bucket)
    torch.cuda.synchronize()

    start_path()
    t0 = time.perf_counter()
    pool, handles, ticks, last, flush_ms = run(device)
    wall_s = time.perf_counter() - t0
    counts = launch_counts()  # the path ends here
    # ssm: the fused tick, every layer, once a flush
    expected = {"ssm_tick": len(schedule)} if cell == "ssm" else {}
    full, padded = (flush_ms[:POOL_FULL_FLUSHES],
                    flush_ms[POOL_FULL_FLUSHES:])
    session_ticks = sum(live for live, _ in schedule)
    snap = pool.export_slot(handles[0])
    state_bytes = sum(t.numel() * t.element_size() for t in (
        *[c for layer in snap["carry"] for c in layer], snap["ring"]))
    emit("pool", cell=cell, model=str(model_cfg), capacity=rt.capacity,
         window=rt.window, sessions=POOL_SESSIONS, flushes=len(schedule),
         session_ticks=session_ticks, seconds=wall_s,
         session_ticks_per_s=session_ticks / (sum(flush_ms) / 1e3),
         bucket64_p50_ms=statistics.median(full), bucket64_p99_ms=p99(full),
         bucket32_p50_ms=statistics.median(padded),
         bucket32_p99_ms=p99(padded), launches=counts,
         state_bytes_per_session=state_bytes)
    check(pool.n_active == POOL_SESSIONS and sum(ticks) == session_ticks,
          f"{pool.n_active} sessions, {sum(ticks)} ticks")
    check_launches(counts, expected, f"{cell} pool")
    check(all(np.isfinite(p).all() for p in last.values()),
          "non-finite pool probabilities")

    if torch.device(device).type == "cuda":
        share = device_share(lambda: [
            flush(pool, handles, ticks, POOL_SESSIONS, POOL_SESSIONS)
            for _ in range(POOL_PADDED_FLUSHES)])
        per_flush = share["device_ops"] / POOL_PADDED_FLUSHES
        emit("pool device share", cell=cell, flushes=POOL_PADDED_FLUSHES,
             bucket=POOL_SESSIONS, device_ops_per_flush=per_flush, **share)
        # ssm: the staged copy in, the tick, the probabilities back
        check(cell != "ssm" or per_flush <= SSM_POOL_MAX_OPS,
              f"ssm pool: {per_flush} device ops a flush, expected at most "
              f"{SSM_POOL_MAX_OPS}")

    _, _, _, cpu_last, _ = run("cpu")
    err = max(float(np.abs(last[i] - cpu_last[i]).max()) for i in last)
    emit("pool vs cpu", cell=cell, sessions=len(cpu_last), max_abs_err=err,
         tol=PATH_TOL)
    check(len(cpu_last) == POOL_SESSIONS and err <= PATH_TOL,
          f"{cell} pool: card and CPU disagree ({err})")

    # one session moved: exported, freed and imported back, and into a
    # fresh pool; both then tick on the same rows, bit for bit
    snap = pool.export_slot(handles[0])
    pool.free(handles[0])
    back = pool.alloc("s0-back")
    pool.import_slot(back, snap)
    fresh = make_pool(device)
    moved = fresh.alloc("s0")
    fresh.import_slot(moved, snap)
    rows = slices[0][ticks[0]:ticks[0] + POOL_MOVED_TICKS]
    same = all(np.array_equal(pool.step([back.slot], row[None]),
                              fresh.step([moved.slot], row[None]))
               for row in rows)
    emit("pool moved slot", cell=cell, ticks=len(rows), bit_identical=same,
         pos=snap["pos"], state_bytes=state_bytes)
    check(len(rows) == POOL_MOVED_TICKS and same,
          f"{cell} pool: an imported slot ticks differently")
    return counts


#: the fleet phase's loads through FleetGateway + run_fleet_load, each run
#: at pipeline depth 1 and 0: the reference serve-fleet default (64
#: sessions, 100 rounds, duty 1.0), the largest bucket filled (128
#: sessions), and a ragged fleet (duty 0.5) with reconnect storms
FLEET_LOADS = {
    "default": dict(),
    "full128": dict(n_sessions=128),
    "ragged_storm": dict(duty=0.5, storm_every=10),
}
#: the ragged load's virtual clock: advanced this much after each round's
#: pump, so which ticks share a flush (the deadline path) is the same at
#: both pipeline depths and on the CPU (a real clock would make it depend
#: on the host's speed); the other loads flush batch-full every round
FLEET_ROUND_S = 0.0015
#: the predictor fleet phase: signals, and the burst sizes a load polls,
#: in turn: bursts of 32 (every flush bucket 32), and ragged bursts whose
#: flushes land in buckets 8, 32 and 64, some padded (a burst of 100
#: flushes 64 and 36); the solo Predictor comparisons (bucket 1 bit for
#: bit; bucketed to PATH_TOL)
PREDICTOR_SIGNALS = 2048
PREDICTOR_LOADS = {"burst32": (32,), "ragged": (5, 8, 20, 32, 50, 64, 100)}
PREDICTOR_SOLO_BITS = 8
PREDICTOR_SOLO_SAMPLES = 64


class RoundClock:
    """A virtual monotonic clock that the load advances after each
    round."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, _round: int) -> None:
        self.t += FLEET_ROUND_S


def fleet_gateway(model_cfg, state, *, device, depth, clock=time.monotonic):
    """A fresh FleetGateway over ``SessionPool(capacity=128, window=30)``
    with the config's batching, publishing onto its own bus: (gateway,
    bus)."""
    from fmda_tpu_torch.config import DEFAULT_TOPICS, FrameworkConfig
    from fmda_tpu_torch.runtime import BatcherConfig, FleetGateway, SessionPool
    from fmda_tpu_torch.stream import InProcessBus

    rt = FrameworkConfig().runtime
    pool = SessionPool(model_cfg, state, capacity=rt.capacity,
                       window=rt.window, device=device)
    bus = InProcessBus(DEFAULT_TOPICS, capacity=1 << 20)
    gateway = FleetGateway(
        pool, bus, batcher_config=BatcherConfig(
            bucket_sizes=rt.bucket_sizes,
            max_linger_s=rt.max_linger_ms / 1e3),
        queue_bound=rt.queue_bound, pipeline_depth=depth, clock=clock)
    return gateway, bus


def fleet_run(model_cfg, state, load_fields, *, device, depth,
              profile=False):
    """One run of a fleet load through a fresh FleetGateway over
    ``SessionPool(capacity=128, window=30)``: the load's summary, the
    fleet topic's messages in order, and (``profile``) the busy share."""
    from fmda_tpu_torch.config import TOPIC_FLEET_PREDICTION
    from fmda_tpu_torch.runtime import FleetLoadConfig, run_fleet_load

    virtual = load_fields.get("duty", 1.0) < 1.0
    clock = RoundClock() if virtual else time.monotonic
    gateway, bus = fleet_gateway(model_cfg, state, device=device,
                                 depth=depth, clock=clock)
    load = FleetLoadConfig(**load_fields)
    on_round = clock.advance if virtual else None
    share = None
    if profile:
        out = {}
        share = device_share(lambda: out.update(
            run_fleet_load(gateway, load, on_round=on_round)))
    else:
        out = run_fleet_load(gateway, load, on_round=on_round)
    messages = [r.value for r in bus.consumer(TOPIC_FLEET_PREDICTION).poll()]
    return out, messages, share, virtual


def published_same(overlapped, serial) -> bool:
    """Whether the fleet topic's transcripts of one load at pipeline depth
    1 (``overlapped``) and 0 (``serial``), each ``(summary, messages)``,
    carry the same results, bit for bit.  Without closes they are the same
    list.  A session closed while a flush of its ticks is in flight drops
    those results (``stale_results_dropped``), and only the overlapped
    gateway has a flush in flight across a close: so its transcript must
    be the serial one's, in order, less exactly that many more results."""
    (out1, msgs1), (out0, msgs0) = overlapped, serial
    extra = (out1["counters"].get("stale_results_dropped", 0)
             - out0["counters"].get("stale_results_dropped", 0))
    if len(msgs0) - len(msgs1) != extra:
        return False
    it = iter(msgs0)
    return all(any(m == m0 for m0 in it) for m in msgs1)


def phase_fleet(device: str = "cuda", cell: str = "gru"):
    """The fleet runtime for one carried-state family: FleetGateway over
    SessionPool(capacity=128, window=30) at full width, driven by
    run_fleet_load through each of FLEET_LOADS at pipeline depth 1 and 0;
    every published result the same bits at both depths, every session's
    last probabilities within PATH_TOL of the same load on the CPU, and
    the launches: ssm's fused tick once a flush, gru and lstm none.
    Returns the path's launch counts (depth-1 runs and depth-0 runs
    together)."""
    model_cfg = model_config(cell, bidirectional=False, dropout=0.0)
    from fmda_tpu_torch.models import build_model

    state = build_model(
        model_cfg, generator=torch.Generator().manual_seed(SEED)).state_dict()
    # warm-up: one short load, before the counted runs
    fleet_run(model_cfg, state, dict(n_sessions=8, n_ticks=2),
              device=device, depth=1)
    torch.cuda.synchronize()

    totals = {}
    for name, fields in FLEET_LOADS.items():
        runs = {}
        for depth in (1, 0):
            start_path()
            t0 = time.perf_counter()
            out, messages, _, virtual = fleet_run(
                model_cfg, state, fields, device=device, depth=depth)
            wall_s = time.perf_counter() - t0
            counts = launch_counts()  # the path ends here
            flushes = out["counters"]["flushes"]
            expected = {"ssm_tick": flushes} if cell == "ssm" else {}
            check_launches(counts, expected,
                           f"{cell} fleet {name} depth {depth}")
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            lat = out["latency"]
            emit("fleet", cell=cell, load=name, pipeline_depth=depth,
                 sessions=out["sessions"], rounds=out["rounds"],
                 ticks_submitted=out["ticks_submitted"],
                 ticks_served=out["ticks_served"], seconds=wall_s,
                 ticks_per_s=out["ticks_served"] / out["wall_s"]
                 if out["wall_s"] else None,
                 latency_clock="virtual" if virtual else "host",
                 total_p50_ms=lat["total"]["p50_ms"],
                 total_p99_ms=lat["total"]["p99_ms"],
                 device_p50_ms=lat["device"]["p50_ms"],
                 device_p99_ms=lat["device"]["p99_ms"],
                 counters=out["counters"],
                 kernel_launches_by_bucket=out["kernel_launches_by_bucket"],
                 launches=counts)
            check(out["ticks_served"] + out["counters"].get(
                      "stale_dropped", 0) + out["counters"].get(
                      "stale_results_dropped", 0) == out["ticks_submitted"]
                  and out["counters"].get("shed_oldest", 0) == 0,
                  f"{cell} fleet {name}: ticks lost: {out['counters']}")
            check(all(np.isfinite(m["probabilities"]).all()
                      for m in messages), f"{cell} fleet {name}: non-finite")
            runs[depth] = (out, messages)
        same = published_same(runs[1], runs[0])
        # what forms the flushes is the same at both depths; what differs
        # is when a flush completes, so how many results a reconnect storm
        # finds stale (see published_same)
        counters_same = all(
            runs[1][0]["counters"].get(k) == runs[0][0]["counters"].get(k)
            for k in ("flushes", "padded_lanes", "stale_dropped",
                      *(k for k in runs[0][0]["counters"]
                        if k.startswith("flushes_bucket_"))))
        cpu_out, cpu_messages, _, _ = fleet_run(
            model_cfg, state, fields, device="cpu", depth=1)
        last = {m["session"]: np.asarray(m["probabilities"])
                for m in runs[1][1]}
        cpu_last = {m["session"]: np.asarray(m["probabilities"])
                    for m in cpu_messages}
        err = max(float(np.abs(last[k] - cpu_last[k]).max()) for k in last)
        emit("fleet depths and cpu", cell=cell, load=name,
             results=len(runs[1][1]), results_serial=len(runs[0][1]),
             bit_identical_depths=same,
             counters_equal=counters_same,
             overlapped_flushes=runs[1][0]["counters"].get(
                 "overlapped_flushes", 0),
             sessions=len(last), max_abs_err_vs_cpu=err, tol=PATH_TOL)
        check(same and counters_same and len(runs[1][1]) > 0,
              f"{cell} fleet {name}: pipeline depths 1 and 0 differ")
        check(set(last) == set(cpu_last) and err <= PATH_TOL,
              f"{cell} fleet {name}: card and CPU disagree ({err})")

    if torch.device(device).type == "cuda":
        out, _, share, _ = fleet_run(model_cfg, state, FLEET_LOADS["default"],
                                     device=device, depth=1, profile=True)
        emit("fleet device share", cell=cell, load="default",
             flushes=out["counters"]["flushes"],
             device_ops_per_flush=share["device_ops"]
             / out["counters"]["flushes"], **share)
    return totals


def phase_predictor_fleet(wh, device: str = "cuda", cell: str = "gru"):
    """The batched Predictor for one family at full width:
    PredictorGateway over the warehouse, PREDICTOR_SIGNALS signals through
    run_predictor_load in each of PREDICTOR_LOADS, with the device window
    ring off and then on (the ring's flushes the same bits as the fetch
    flushes); the ragged load flushes in every bucket, some padded; a
    bucket-1 flush the same bits as the solo Predictor, every load's
    bucketed flushes within PATH_TOL of it; the launches: gru and lstm
    their forward scan twice a flush, attn kernel 6 once, ssm none.
    Returns the path's launch counts (every run)."""
    from fmda_tpu_torch.config import (
        DEFAULT_TOPICS, FrameworkConfig, TOPIC_PREDICTION)
    from fmda_tpu_torch.runtime import (
        BatcherConfig, PredictorGateway, PredictorLoadConfig, PredictorPool,
        run_predictor_load)
    from fmda_tpu_torch.serve import Predictor
    from fmda_tpu_torch.stream import InProcessBus

    rt = FrameworkConfig().runtime
    check(tuple(rt.predictor_bucket_sizes) == PREDICTOR_BUCKETS,
          f"predictor buckets {rt.predictor_bucket_sizes}, expected "
          f"{PREDICTOR_BUCKETS}")
    window = rt.window
    model_cfg, state, norm = serving_setup(wh, cell, bidirectional=True)
    stamps = wh.timestamps()[window - 1:][:PREDICTOR_SIGNALS]

    def gateway(use_ring, buckets=PREDICTOR_BUCKETS):
        pool = PredictorPool(model_cfg, state, norm, window=window,
                             use_ring=use_ring, device=device)
        return PredictorGateway(
            pool, InProcessBus(DEFAULT_TOPICS, capacity=1 << 20), wh,
            batcher_config=BatcherConfig(
                bucket_sizes=buckets,
                max_linger_s=rt.predictor_max_linger_ms / 1e3),
            queue_bound=rt.predictor_queue_bound,
            pipeline_depth=rt.pipeline_depth, max_staleness_s=None)

    # warm-up: one burst at each bucket, before the counted runs
    warm = gateway(False)
    for b in PREDICTOR_BUCKETS:
        for ts in stamps[:b]:
            warm.submit(ts)
        warm.drain()
    torch.cuda.synchronize()

    fwd, per_flush = forward_kernel(cell)
    totals, fetched = {}, {}
    for load, bursts in PREDICTOR_LOADS.items():
        transcripts = {}
        for use_ring in (False, True):
            gw = gateway(use_ring)
            start_path()
            out = run_predictor_load(gw, stamps, PredictorLoadConfig(
                n_signals=PREDICTOR_SIGNALS, bursts=bursts))
            counts = launch_counts()  # the path ends here
            flushes = out["counters"]["flushes"]
            check_launches(counts, {fwd: per_flush * flushes} if fwd else {},
                           f"{cell} predictor fleet {load} ring={use_ring}")
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            transcripts[use_ring] = [
                r.value for r in gw.bus.consumer(TOPIC_PREDICTION).poll()]
            lat, c = out["latency"], out["counters"]
            emit("predictor fleet", cell=cell, load=load, ring=use_ring,
                 signals=out["signals_submitted"],
                 served=out["signals_served"], bursts=list(bursts),
                 seconds=out["wall_s"],
                 signals_per_s=out["signals_served"] / out["wall_s"],
                 total_p50_ms=lat["total"]["p50_ms"],
                 total_p99_ms=lat["total"]["p99_ms"],
                 gather_p50_ms=lat["gather"]["p50_ms"],
                 gather_p99_ms=lat["gather"]["p99_ms"],
                 device_p50_ms=lat["device"]["p50_ms"],
                 device_p99_ms=lat["device"]["p99_ms"],
                 ring_hits=c.get("ring_hits", 0),
                 ring_misses=c.get("ring_misses", 0), counters=c,
                 kernel_launches_by_bucket=out["kernel_launches_by_bucket"],
                 launches=counts)
            check(out["signals_served"] == len(stamps) == PREDICTOR_SIGNALS,
                  f"{cell} predictor fleet {load}: {out['signals_served']} "
                  f"served of {len(stamps)}")
            check(not use_ring or (c.get("ring_hits", 0) == flushes - 1
                                   and c.get("ring_misses", 0) == 1),
                  f"{cell} predictor fleet {load}: ring hits/misses {c}")
            used = {b for b in PREDICTOR_BUCKETS
                    if c.get(f"flushes_bucket_{b}", 0)}
            check(len(bursts) == 1 or (used == set(PREDICTOR_BUCKETS)
                                       and c.get("padded_lanes", 0) > 0),
                  f"{cell} predictor fleet {load}: flushed in buckets "
                  f"{sorted(used)} with {c.get('padded_lanes', 0)} padded "
                  "lanes")
        check(transcripts[True] == transcripts[False],
              f"{cell} predictor fleet {load}: ring and fetch flushes differ")
        fetched[load] = transcripts[False]

    # the solo Predictor on the card: a bucket-1 flush gives its bits, every
    # load's bucketed flushes its values within PATH_TOL
    solo = Predictor(InProcessBus(DEFAULT_TOPICS), wh, model_cfg, state,
                     norm, window=window, from_end=False,
                     max_staleness_s=None, device=device)
    one = gateway(False, buckets=(1,))
    step = len(stamps) // PREDICTOR_SOLO_BITS
    bits_same = True
    for ts in stamps[::step][:PREDICTOR_SOLO_BITS]:
        one.submit(ts)
        bits_same &= one.drain() == [solo.predict_for_timestamp(ts)]
    step = len(stamps) // PREDICTOR_SOLO_SAMPLES
    sampled = stamps[::step][:PREDICTOR_SOLO_SAMPLES]
    solo_p = {ts: np.asarray(solo.predict_for_timestamp(ts).probabilities)
              for ts in sampled}
    errs = {}
    for load, messages in fetched.items():
        by_ts = {m["timestamp"]: np.asarray(m["probabilities"])
                 for m in messages}
        errs[load] = max(float(np.abs(by_ts[ts] - solo_p[ts]).max())
                         for ts in sampled)
    emit("predictor fleet vs solo", cell=cell, ring_bit_identical=True,
         bucket1_bit_identical=bits_same, bucket1_signals=PREDICTOR_SOLO_BITS,
         bucketed_samples=PREDICTOR_SOLO_SAMPLES,
         max_abs_err=max(errs.values()), max_abs_err_by_load=errs,
         tol=PATH_TOL)
    check(bits_same, f"{cell} predictor fleet: a bucket-1 flush differs "
          "from the solo Predictor")
    check(max(errs.values()) <= PATH_TOL,
          f"{cell} predictor fleet: bucketed flushes off the solo ({errs})")
    return totals


#: the multi-ticker phase: the experiment's mixed batch, 16 windows of
#: each of 50 tickers (800 rows a step), over 50 in-memory warehouses of
#: MULTI_ROWS seeded random-walk rows (seeds 0-49, ~26 sessions each) in
#: chunks of MULTI_CHUNK; then the chunk-interleaved composition at
#: BATCH; and the first MULTI_VS_CPU_STEPS mixed steps on the CPU
MULTI_TICKERS = 50
MULTI_PER_TICKER = 16
MULTI_BATCH = MULTI_TICKERS * MULTI_PER_TICKER
MULTI_ROWS = 2000
MULTI_CHUNK = 100
MULTI_VS_CPU_STEPS = 8
MULTI_STEP_BATCHES = 16
#: the rounds of the train pass the busy share is measured over
MULTI_SHARE_ROUNDS = 4
#: the continuous phase: a file warehouse of CONTINUOUS_ROWS random-walk
#: rows tailed as a backlog in pages of CONTINUOUS_PAGE rows; the tail's
#: empty polls CONTINUOUS_POLL_S apart (the [train] default is 1 s: the
#: backlog's quiescence would idle 8 s a run)
CONTINUOUS_ROWS = 4096
CONTINUOUS_PAGE = 1024
CONTINUOUS_POLL_S = 0.05
CONTINUOUS_BATCH = 256
CONTINUOUS_CHUNK = 512


def multi_sources():
    """The multi-ticker phase's tickers: ``{ticker: Warehouse}``, each
    in memory with MULTI_ROWS random-walk rows of its own seed, and the
    class weights over the union of their targets (as the experiment
    weighs them)."""
    from fmda_tpu_torch.config import FrameworkConfig
    from fmda_tpu_torch.data.synthetic import random_walk_rows
    from fmda_tpu_torch.stream import Warehouse
    from fmda_tpu_torch.train import class_weights

    cfg = FrameworkConfig()
    t0 = time.perf_counter()
    sources = {}
    for i in range(MULTI_TICKERS):
        wh = Warehouse(cfg.features, cfg.warehouse)
        wh.insert_rows(random_walk_rows(cfg.features.table_columns(),
                                        MULTI_ROWS, seed=SEED + i))
        sources[f"T{i:02d}"] = wh
    y = np.concatenate([wh.fetch_targets(range(1, len(wh) + 1))
                        for wh in sources.values()])
    weights = class_weights(np.maximum(y.sum(axis=0), 1.0), len(y))
    emit("multi setup", tickers=len(sources), rows_per_ticker=MULTI_ROWS,
         features=len(next(iter(sources.values())).x_fields),
         seconds=time.perf_counter() - t0)
    return sources, weights


def mixed_pass(mtd, chunks):
    """A pass's mixed batches, composed on the host: (batches, real
    windows, the composer's ms a batch)."""
    t0 = time.perf_counter()
    batches = [b for rc in mtd.rounds(chunks)
               for b in mtd.mixed_batches(rc, MULTI_PER_TICKER)]
    ms = (time.perf_counter() - t0) * 1e3 / max(len(batches), 1)
    return batches, int(sum(b.mask.sum() for b in batches)), ms


def phase_train_multi(sources, weights, device: str = "cuda",
                      cell: str = "gru"):
    """Multi-ticker training for one family at full width: one epoch of
    ``Trainer.fit_multi`` in the mixed composition (MULTI_PER_TICKER
    windows of every ticker, MULTI_BATCH rows a step; dropout 0.5,
    spatial), launches checked against the counts the dataset's splits
    and mixed batches give; steps back to back, and the busy share over
    the pass's first MULTI_SHARE_ROUNDS rounds; for gru one epoch
    chunk-interleaved at BATCH too; then the first MULTI_VS_CPU_STEPS
    mixed steps at dropout 0 on the card and on the CPU.  Returns the
    path's launch counts and what :func:`steps_vs_cpu` returns."""
    from fmda_tpu_torch.config import FrameworkConfig, TrainConfig
    from fmda_tpu_torch.data.pipeline import prefetch_batches
    from fmda_tpu_torch.train import MultiTickerDataset, Trainer

    fc = FrameworkConfig().features
    levels = dict(bid_levels=fc.bid_levels, ask_levels=fc.ask_levels)
    model_cfg = model_config(cell)
    train_cfg = TrainConfig(batch_size=MULTI_BATCH, chunk_size=MULTI_CHUNK,
                            window=30, epochs=1)
    mtd = MultiTickerDataset(sources, MULTI_CHUNK, train_cfg.window,
                             **levels)
    train_chunks, val_chunks, _ = mtd.splits(train_cfg.val_size,
                                             train_cfg.test_size)
    host, n_windows, compose_ms = mixed_pass(mtd, train_chunks)
    n_train, n_val = len(host), len(mixed_pass(mtd, val_chunks)[0])
    trainer = Trainer(model_cfg, train_cfg, weight=weights[0],
                      pos_weight=weights[1], device=device)
    # warm-up on a throwaway state, before the counted run
    warm = trainer.init_state()
    for b in host[:2]:
        trainer.train_step(warm, trainer.place(b))
    torch.cuda.synchronize()

    start_path()
    t0 = time.perf_counter()
    state, history, fitted = trainer.fit_multi(
        sources, mixed_batch_per_ticker=MULTI_PER_TICKER, **levels)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = launch_counts()  # the path ends here
    fit_steps = state.step
    tr, va = history["train"][-1], history["val"][-1]
    # the mean step with the host ahead of the card: placed batches back
    # to back, one synchronize at the end
    placed = [trainer.place(b) for b in host[:MULTI_STEP_BATCHES]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in placed:
        trainer.train_step(state, b)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / len(placed)
    emit("train multi", cell=cell, tickers=len(sources),
         per_ticker=MULTI_PER_TICKER, batch=MULTI_BATCH,
         train_rounds=len(mtd.rounds(train_chunks)), steps=n_train,
         val_batches=n_val, train_windows=n_windows, seconds=fit_s,
         samples_per_s=n_windows / fit_s, mean_step_ms=step_ms,
         compose_ms_per_batch=compose_ms, launches=counts,
         train_loss=tr.loss, train_accuracy=tr.accuracy, val_loss=va.loss,
         val_accuracy=va.accuracy)
    check(fit_steps == n_train, f"{fit_steps} steps, expected {n_train}")
    check_launches(counts, train_launches(cell, n_train, n_val),
                   f"{cell} multi-ticker training")
    check(all(math.isfinite(m.loss) for m in (tr, va)),
          f"non-finite losses {tr.loss}, {va.loss}")
    if torch.device(device).type == "cuda":
        # a steady window of the pass: the first MULTI_SHARE_ROUNDS rounds
        # through the pipeline fit_multi runs (the composer thread, the
        # placed batches, the steps); a whole epoch's trace costs the
        # profiler a minute for ssm's ~95,000 device ops
        rounds = mtd.rounds(train_chunks)[:MULTI_SHARE_ROUNDS]

        def window():
            for b in prefetch_batches(
                    (b for rc in rounds
                     for b in mtd.mixed_batches(rc, MULTI_PER_TICKER)),
                    trainer.place, depth=train_cfg.prefetch_depth):
                trainer.train_step(state, b)

        emit("train multi device share", cell=cell, rounds=len(rounds),
             batches=sum(max(len(mtd.batches(t, c, MULTI_PER_TICKER))
                             for t, c in rc.items()) for rc in rounds),
             window=device_share(window, host_activity=False),
             profiler="device activity only")

    if cell == "gru":
        # the chunk-interleaved composition: single-ticker batches
        inter_cfg = dataclasses.replace(train_cfg, batch_size=BATCH)
        inter = Trainer(model_cfg, inter_cfg, weight=weights[0],
                        pos_weight=weights[1], device=device)
        n_inter = sum(len(mtd.batches(t, c, BATCH)) for t, c in train_chunks)
        n_inter_val = sum(len(mtd.batches(t, c, BATCH))
                          for t, c in val_chunks)
        start_path()
        t0 = time.perf_counter()
        istate, ihist, _ = inter.fit_multi(sources, **levels)
        torch.cuda.synchronize()
        inter_s = time.perf_counter() - t0
        inter_counts = launch_counts()  # the path ends here
        emit("train multi interleaved", cell=cell, batch=BATCH,
             steps=n_inter, val_batches=n_inter_val,
             train_windows=n_windows, seconds=inter_s,
             samples_per_s=n_windows / inter_s, launches=inter_counts,
             train_loss=ihist["train"][-1].loss)
        check(istate.step == n_inter,
              f"{istate.step} interleaved steps, expected {n_inter}")
        check_launches(inter_counts, train_launches(cell, n_inter,
                                                    n_inter_val),
                       f"{cell} interleaved multi-ticker training")
        counts = {k: v + inter_counts[k] for k, v in counts.items()}

    # the card against the CPU: the first mixed steps at dropout 0, and
    # each ticker's serving stats
    norms = fitted.final_norm_params()
    again = MultiTickerDataset(sources, MULTI_CHUNK, train_cfg.window,
                               **levels).final_norm_params()
    same_norms = norms.keys() == again.keys() and all(
        np.array_equal(norms[t].x_min, again[t].x_min)
        and np.array_equal(norms[t].x_max, again[t].x_max) for t in norms)
    vs_cpu = steps_vs_cpu("train multi vs cpu", host[:MULTI_VS_CPU_STEPS],
                          MULTI_VS_CPU_STEPS, train_cfg, weights, device,
                          cell, norm_params_equal=same_norms)
    check(same_norms, "per-ticker serving stats differ between datasets")
    return counts, vs_cpu


def close_sessions(gateway) -> None:
    """Close every open session of a fleet gateway (between loads)."""
    for session_id in gateway.pool.session_ids():
        gateway.close_session(session_id)


def fleet_loads(gateway, *, until=None, n=1):
    """Default fleet loads through ``gateway``, each with fresh sessions
    closed after it: ``n`` of them, or (``until``, an Event) one after
    another until it is set.  Returns each load's summary and the
    gateway's metrics over all of them."""
    from fmda_tpu_torch.runtime import (
        FleetLoadConfig, RuntimeMetrics, run_fleet_load)

    gateway.metrics = RuntimeMetrics()
    outs = []
    while True:
        outs.append(run_fleet_load(gateway, FleetLoadConfig()))
        close_sessions(gateway)
        finished = until.is_set() if until is not None else len(outs) >= n
        if finished:
            return outs, gateway.metrics.summary()


def load_fields(outs, summary) -> dict:
    """Ticks/s over the loads' wall time, each load's ticks/s (median,
    least, most), and the device and total latencies over all of them."""
    lat = summary["latency"]
    served = sum(o["ticks_served"] for o in outs)
    per_load = [o["ticks_served"] / o["wall_s"] for o in outs]
    return dict(loads=len(outs), ticks_served=served,
                ticks_per_s=served / sum(o["wall_s"] for o in outs),
                load_ticks_per_s_median=float(np.median(per_load)),
                load_ticks_per_s_min=min(per_load),
                load_ticks_per_s_max=max(per_load),
                device_p50_ms=lat["device"]["p50_ms"],
                device_p99_ms=lat["device"]["p99_ms"],
                total_p50_ms=lat["total"]["p50_ms"],
                total_p99_ms=lat["total"]["p99_ms"])


def phase_continuous(directory: str, device: str = "cuda",
                     cell: str = "gru"):
    """Continuous fine-tuning beside the live fleet for one carried-state
    family at full width: a ContinuousTrainer over a file warehouse of
    CONTINUOUS_ROWS rows, tailed as a backlog, publishing every round into
    a FleetGateway over SessionPool(capacity=128, window=30) through
    gateway_publisher, from its own thread, while default loads run one
    after another through the gateway (as ``serve-fleet
    --continuous-train`` runs them).  Checks rounds, swaps, checkpoints
    and profiles, that ticks were served under several versions, that
    every submitted tick was published or counted as dropped, that the
    pool serves the last round's weights bit for bit, and the launches.
    Then the same loop with no fleet on the card and on the CPU at
    dropout 0.  Returns the path's launch counts."""

    from fmda_tpu_torch.config import (
        DEFAULT_TOPICS, FrameworkConfig, TOPIC_FLEET_PREDICTION, TrainConfig)
    from fmda_tpu_torch.data.synthetic import random_walk_rows
    from fmda_tpu_torch.eval import profile_path_for
    from fmda_tpu_torch.models import build_model
    from fmda_tpu_torch.obs import default_registry
    from fmda_tpu_torch.runtime import BatcherConfig, FleetGateway, SessionPool
    from fmda_tpu_torch.stream import InProcessBus, Warehouse
    from fmda_tpu_torch.train import ContinuousTrainer, gateway_publisher

    cfg = FrameworkConfig()
    fc, rt = cfg.features, cfg.runtime
    t0 = time.perf_counter()
    wh = Warehouse(fc, dataclasses.replace(
        cfg.warehouse, path=f"{directory}/continuous_{cell}.sqlite"))
    wh.insert_rows(random_walk_rows(fc.table_columns(), CONTINUOUS_ROWS,
                                    seed=SEED))
    model_cfg = model_config(cell, bidirectional=False, dropout=0.0)
    check(len(wh.x_fields) == model_cfg.n_features,
          f"continuous warehouse serves {len(wh.x_fields)} features")
    train_cfg = TrainConfig(batch_size=CONTINUOUS_BATCH,
                            chunk_size=CONTINUOUS_CHUNK, window=30,
                            val_size=0.0, test_size=0.0,
                            continuous_poll_s=CONTINUOUS_POLL_S)

    def trainer(dev, tag, publish=None):
        return ContinuousTrainer(
            wh, model_cfg, train_cfg,
            checkpoint_dir=f"{directory}/continuous_{cell}_{tag}",
            publish=publish, bid_levels=fc.bid_levels,
            ask_levels=fc.ask_levels, drift_bins=cfg.quality.drift_bins,
            target_lead=fc.max_lead, chunk=CONTINUOUS_PAGE, device=dev)

    params = build_model(
        model_cfg, generator=torch.Generator().manual_seed(SEED)).state_dict()
    pool = SessionPool(model_cfg, params, capacity=rt.capacity,
                       window=rt.window, device=device)
    bus = InProcessBus(DEFAULT_TOPICS, capacity=1 << 22)
    results = bus.consumer(TOPIC_FLEET_PREDICTION)
    gateway = FleetGateway(
        pool, bus, batcher_config=BatcherConfig(
            bucket_sizes=rt.bucket_sizes,
            max_linger_s=rt.max_linger_ms / 1e3),
        queue_bound=rt.queue_bound, pipeline_depth=rt.pipeline_depth)
    ct = trainer(device, "fleet", gateway_publisher(gateway))
    emit("continuous setup", cell=cell, rows=len(wh), page=CONTINUOUS_PAGE,
         train=str(train_cfg), model=str(model_cfg),
         seconds=time.perf_counter() - t0)

    fleet_loads(gateway)  # warms the gateway
    results.poll()
    before_ticks = gateway.version_ticks
    gateway.kernel_launches_by_bucket.clear()
    rounds_hist = default_registry().histogram("continuous_round_seconds")
    before_rounds = rounds_hist.snapshot()

    start_path()
    done, summary, errors = threading.Event(), {}, []

    def run():
        try:
            summary.update(ct.run())
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
        finally:
            done.set()

    t0 = time.perf_counter()
    thread = threading.Thread(target=run, name="chip-smoke-continuous",
                              daemon=True)
    thread.start()
    outs, with_trainer = fleet_loads(gateway, until=done)
    thread.join(timeout=600)
    wall_s = time.perf_counter() - t0
    counts = launch_counts()  # the path ends here
    by_bucket = dict(gateway.kernel_launches_by_bucket)
    check(not thread.is_alive(), "the continuous trainer did not finish")
    if errors:
        raise errors[0]
    after = rounds_hist.snapshot()
    n_rounds = after["n"] - before_rounds["n"]
    version_ticks = {v: n - before_ticks.get(v, 0)
                     for v, n in gateway.version_ticks.items()
                     if n > before_ticks.get(v, 0)}
    published = len(results.poll())
    c = with_trainer["counters"]
    submitted = sum(o["ticks_submitted"] for o in outs)
    dropped = c.get("stale_dropped", 0) + c.get("stale_results_dropped", 0)
    served_params = pool.live_tree()[0]
    trained = ct.state.model.state_dict()
    same_weights = served_params.keys() == trained.keys() and all(
        torch.equal(served_params[k], v) for k, v in trained.items())
    files = [(ck, profile_path_for(ck)) for ck in summary["checkpoints"]]
    steps = ct.state.step
    expected = ({"ssm_tick": c["flushes"]} if cell == "ssm" else
                {f"{cell}_scan_fwd": steps, f"{cell}_scan_bwd": steps,
                 "scan_dw": steps})
    # the fleet alone for as many loads, just after: with the trainer and
    # without it, each load's ticks/s
    alone_outs, alone = fleet_loads(gateway, n=len(outs))
    results.poll()
    with_fields = load_fields(outs, with_trainer)
    alone_fields = load_fields(alone_outs, alone)
    emit("continuous", cell=cell, **{k: summary[k] for k in (
        "rounds", "rows_seen", "swaps_accepted", "swaps_refused",
        "last_metrics")}, weights_version=gateway.weights_version,
        train_steps=steps, seconds=wall_s,
        round_mean_s=(after["total_s"] - before_rounds["total_s"])
        / max(n_rounds, 1),
        version_ticks=version_ticks, ticks_submitted=submitted,
        ticks_dropped=dropped, results_published=published,
        served_weights_equal_trained=same_weights, launches=counts,
        kernel_launches_by_bucket=by_bucket, alone=alone_fields,
        with_trainer=with_fields,
        load_ticks_per_s_median_ratio=with_fields["load_ticks_per_s_median"]
        / alone_fields["load_ticks_per_s_median"],
        loads_separate=with_fields["load_ticks_per_s_max"]
        < alone_fields["load_ticks_per_s_min"])
    check(summary["rounds"] >= 2 and n_rounds == summary["rounds"],
          f"{cell} continuous: {summary['rounds']} rounds")
    check(summary["swaps_accepted"] == summary["rounds"]
          == gateway.weights_version,
          f"{cell} continuous: swaps {summary['swaps_accepted']}, version "
          f"{gateway.weights_version}, rounds {summary['rounds']}")
    check(all(os.path.exists(f) for pair in files for f in pair),
          f"{cell} continuous: a checkpoint or its profile is missing")
    check(len(version_ticks) >= 2,
          f"{cell} continuous: ticks served under {version_ticks}")
    check(published == c["ticks_served"] == submitted - dropped
          and c.get("shed_oldest", 0) == 0,
          f"{cell} continuous: {published} published, {submitted} "
          f"submitted, {dropped} dropped ({c})")
    check(same_weights, f"{cell} continuous: the pool does not serve the "
          "last round's weights")
    check_launches(counts, expected, f"{cell} continuous")
    # a flush books its own launches only, none of the trainer's
    check(sum(by_bucket.values()) == (c["flushes"] if cell == "ssm" else 0),
          f"{cell} continuous: flushes booked {by_bucket} launches over "
          f"{c['flushes']} flushes")

    # the same loop alone, on the card and on the CPU: the backlog makes
    # its rounds the same
    finals = {}
    for dev in (device, "cpu"):
        alone_ct = trainer(dev, f"alone_{torch.device(dev).type}")
        t0 = time.perf_counter()
        out = alone_ct.run()
        finals[dev] = (out, {k: v.detach().cpu() for k, v in
                             alone_ct.state.model.state_dict().items()},
                       time.perf_counter() - t0)
    (g_out, g_par, g_s), (c_out, c_par, c_s) = finals[device], finals["cpu"]
    err = max(float((g_par[k] - c_par[k]).abs().max()) for k in g_par)
    emit("continuous vs cpu", cell=cell, rounds=g_out["rounds"],
         cpu_rounds=c_out["rounds"], param_max_abs_err=err,
         card_seconds=g_s, cpu_seconds=c_s, tol=TRAIN_TOL)
    check(g_out["rounds"] == c_out["rounds"] == summary["rounds"],
          f"{cell} continuous vs cpu: rounds differ")
    check(err <= TRAIN_TOL,
          f"{cell} continuous: card and CPU disagree ({err})")
    wh.close()
    return counts


#: the pipeline phase: half a year of synthetic trading days landed through
#: the port's engine (126 x 78 = 9,828 rows), then the next day live, bar by
#: bar; the app phase lands the same days (a year until the parallel phase
#: took its time: the depth of both phases' catch-ups, PERF.md section 4)
PIPELINE_DAYS = 126
#: the golden day's narrow schema (the reference's engine tests' own)
GOLDEN_FEATURES = dict(
    bid_levels=2, ask_levels=2, event_list=("Core CPI",),
    volume_ma_periods=(3,), price_ma_periods=(3,), delta_ma_periods=(2,),
    bollinger_period=3, stoch_preceding=2, atr_preceding=2,
    target_lead1=2, target_lead2=3, get_cot=False)


def golden_day() -> dict:
    """``tests/data/golden_day.jsonl`` through the port's engine on this
    host: x within 1e-6 of ``golden_day_expected.npz``, targets exact."""
    from fmda_tpu_torch.config import (
        DEFAULT_TOPICS, FeatureConfig, WarehouseConfig)
    from fmda_tpu_torch.stream import InProcessBus, StreamEngine, Warehouse

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data")
    with open(os.path.join(data, "golden_day.jsonl")) as fh:
        messages = [json.loads(line) for line in fh]
    expected = np.load(os.path.join(data, "golden_day_expected.npz"),
                       allow_pickle=False)
    fc = FeatureConfig(**GOLDEN_FEATURES)
    bus = InProcessBus(DEFAULT_TOPICS)
    wh = Warehouse(fc, WarehouseConfig(path=":memory:"))
    engine = StreamEngine(bus, wh, fc)
    for msg in messages:
        bus.publish(msg["topic"], msg["value"])
    engine.step()
    n = len(expected["x"])
    check(len(wh) == n, f"golden day landed {len(wh)} rows, expected {n}")
    check(tuple(expected["fields"]) == wh.x_fields, "golden day schema")
    x_err = float(np.abs(wh.fetch(range(1, n + 1)) - expected["x"]).max())
    y_same = bool((wh.fetch_targets(range(1, n + 1)) == expected["y"]).all())
    check(x_err <= 1e-6 and y_same,
          f"golden day differs: x {x_err}, targets equal {y_same}")
    wh.close()
    return dict(messages=len(messages), rows=n, x_max_abs_err=x_err,
                targets_equal=y_same)


def phase_pipeline(directory: str, device: str = "cuda", traced_day=None):
    """The reference's main path from raw feed messages to predictions:
    synthetic feeds -> InProcessBus -> StreamEngine -> Warehouse ->
    ``demo``'s train and backtest -> checkpoint -> a live day bar by bar ->
    Predictor and two StreamingPredictors -> the prediction topic.

    - corpus: one seeded stream of PIPELINE_DAYS + 1 synthetic days; the
      first PIPELINE_DAYS land through the engine as ``build_corpus``
      lands them (a day published, one step), into a file warehouse;
    - demo: the ``demo`` command's own train and backtest code on that
      warehouse, one epoch at batch 256 (the train phase's settings);
    - live day: the last day, bar by bar: the bar's five messages
      published, one engine step, then three consumers of the signal
      topic poll: ``Predictor.from_checkpoint`` (no staleness check: the
      synthetic clock is in 2020), a bidirectional gru
      ``StreamingPredictor`` on the same checkpoint and an ssm one from a
      seeded init, both caught up over the corpus first.  A consumer's
      bar-to-prediction latency is the engine's part (first publish to
      the end of the step) plus its own poll, as each would see it alone;
    - the card's Predictor against the port's on the CPU for the live
      day's timestamps, and the golden day.

    ``traced_day(live)``, when given, runs after all that on the same bus,
    engine, warehouse and consumers (``live``), with the corpus's next day
    left in ``live["messages"]``.  Returns the path's launch counts (the
    demo's and the live day's)."""
    import contextlib
    import io

    from fmda_tpu_torch import __main__ as cli
    from fmda_tpu_torch.config import (
        DEFAULT_TOPICS, FrameworkConfig, TOPIC_PREDICT_TIMESTAMP,
        TOPIC_PREDICTION, TrainConfig)
    from fmda_tpu_torch.data.pipeline import WindowBatches
    from fmda_tpu_torch.data.synthetic import (
        BARS_PER_DAY, SyntheticMarketConfig, synthetic_session_messages)
    from fmda_tpu_torch.obs.registry import MetricsRegistry, default_registry
    from fmda_tpu_torch.serve import (
        Predictor, StreamingBiGRU, StreamingBiGRUBidirectional,
        StreamingPredictor)
    from fmda_tpu_torch.serve.predictor import load_model, make_batched_forward
    from fmda_tpu_torch.stream import InProcessBus, StreamEngine, Warehouse
    from fmda_tpu_torch.train import imbalance_weights_from_source
    from fmda_tpu_torch.train.checkpoint import restore_checkpoint

    cfg = FrameworkConfig(train=TrainConfig(
        batch_size=BATCH, chunk_size=TRAIN_CHUNK, epochs=1, seed=SEED))
    fc, window = cfg.features, cfg.train.window
    per_day = 5 * BARS_PER_DAY
    phase_t0 = time.perf_counter()

    # -- the corpus: PIPELINE_DAYS days through the engine, a step a day -----
    registry = MetricsRegistry()
    wh = Warehouse(fc, dataclasses.replace(
        cfg.warehouse, path=f"{directory}/pipeline.sqlite"))
    bus = InProcessBus(DEFAULT_TOPICS)
    engine = StreamEngine(bus, wh, fc, metrics=registry)
    # the corpus, the live day and the obs phase's traced day: the generator
    # is sequential, so the first days are the same whatever n_days
    messages = synthetic_session_messages(fc, SyntheticMarketConfig(
        seed=SEED, n_days=PIPELINE_DAYS + 2))
    step_ms = []
    t0 = time.perf_counter()
    for _ in range(PIPELINE_DAYS):
        for _ in range(per_day):
            bus.publish(*next(messages))
        t = time.perf_counter()
        engine.step()
        step_ms.append((time.perf_counter() - t) * 1e3)
    corpus_s = time.perf_counter() - t0
    stats = engine.stats
    n_rows = PIPELINE_DAYS * BARS_PER_DAY
    emit("pipeline corpus", days=PIPELINE_DAYS, rows=len(wh),
         features=len(wh.x_fields), seconds=corpus_s,
         ingest_rows_per_s=len(wh) / corpus_s,
         step_ms_p50=statistics.median(step_ms), step_ms_p99=p99(step_ms),
         step_ms_mean=statistics.fmean(step_ms),
         stages=engine.timer.summary(),
         step_histogram=registry.histogram("engine_step_seconds").summary(),
         stats=stats)
    check(len(wh) == n_rows and stats["emitted"] == n_rows,
          f"corpus landed {len(wh)} rows, expected {n_rows}")
    check(stats["dropped"] == 0 and stats["bad_messages"] == 0
          and stats["pending"] == 0,
          f"corpus dropped or held rows: {stats}")
    check(len(wh.x_fields) == cfg.model.n_features,
          f"corpus serves {len(wh.x_fields)} features")

    # -- demo: its train and backtest code on the corpus ------------------------
    epoch_hist = default_registry().histogram("train_epoch_seconds")
    epoch_s0 = epoch_hist.total_s
    start_path()
    demo_out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(demo_out):
        ckpt, history, dataset = cli._train(
            wh, cfg, epochs=None, batch_size=None,
            checkpoint_dir=f"{directory}/pipeline_ckpt", seed=None,
            device=device)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        bt = cli._backtest(wh, cfg, ckpt, window=window,
                           threshold=cfg.train.prob_threshold, device=device)
        torch.cuda.synchronize()
        bt_s = time.perf_counter() - t0
    demo_counts = launch_counts()  # the demo ends here
    epoch_s = epoch_hist.total_s - epoch_s0
    # the demo's train call, split: its host pieces again, alone
    t = time.perf_counter()
    imbalance_weights_from_source(wh)
    weights_s = time.perf_counter() - t
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli._save_quality_profile(wh, cfg, f"{directory}/profile_probe.pt")
    profile_s = time.perf_counter() - t
    train_chunks, val_chunks, _ = dataset.split(cfg.train.val_size,
                                                cfg.train.test_size)
    n_train = sum(len(WindowBatches(dataset, i, BATCH)) for i in train_chunks)
    n_val = sum(len(WindowBatches(dataset, i, BATCH)) for i in val_chunks)
    n_windows = sum(len(dataset.windows(i)[0]) for i in train_chunks)
    served = len(bt.probabilities)
    expected = train_launches("gru", n_train, n_val)
    expected["gru_scan_fwd"] += 2 * math.ceil(served / BATCH)
    tr = history["train"][-1]
    emit("pipeline demo", checkpoint=os.path.basename(ckpt),
         train_steps=n_train, val_batches=n_val, train_windows=n_windows,
         train_s=train_s, train_windows_per_s=n_windows / train_s,
         epoch_s=epoch_s, epoch_train_windows_per_s=n_windows / epoch_s,
         weights_s=weights_s, drift_profile_s=profile_s,
         train_loss=tr.loss, train_accuracy=tr.accuracy,
         backtest_rows=served, backtest_s=bt_s,
         backtest_windows_per_s=served / bt_s,
         accuracy=float(bt.metrics.accuracy),
         hamming=float(bt.metrics.hamming), launches=demo_counts,
         output=demo_out.getvalue().splitlines())
    check_launches(demo_counts, expected, "pipeline demo")
    check(served == n_rows - window + 1, f"demo backtest served {served}")
    check(math.isfinite(tr.loss) and bool(np.isfinite(bt.probabilities).all()),
          "demo: non-finite loss or probabilities")

    # -- the live day's consumers, the streaming ones caught up -----------------
    model_cfg = dataclasses.replace(cfg.model, n_features=len(wh.x_fields))
    tree, norm = restore_checkpoint(ckpt)
    ssm_cfg, ssm_state, ssm_norm = serving_setup(wh, "ssm", False)
    cores = {
        "gru_bidirectional": StreamingBiGRUBidirectional(
            model_cfg, tree["params"], norm, window=window, device=device),
        "ssm": StreamingBiGRU(ssm_cfg, ssm_state, ssm_norm, window=window,
                              device=device),
    }
    start_path()
    streams = {name: StreamingPredictor(
        bus, wh, core, threshold=cfg.train.prob_threshold, from_end=True)
        for name, core in cores.items()}
    last_ts = wh.timestamps_after(n_rows - 1)[0][1]
    bus.publish(TOPIC_PREDICT_TIMESTAMP, {"Timestamp": last_ts})
    catchup_s = {}
    for name, sp in streams.items():
        t0 = time.perf_counter()
        check(len(sp.poll()) == 1, f"{name} catch-up served nothing")
        torch.cuda.synchronize()
        catchup_s[name] = time.perf_counter() - t0
    predictor = Predictor.from_checkpoint(
        ckpt, bus, wh, model_cfg, window=window,
        threshold=cfg.train.prob_threshold, from_end=True,
        max_staleness_s=None, device=device)
    consumers = {"predictor": predictor.poll,
                 **{name: sp.poll for name, sp in streams.items()}}
    emit("pipeline catch-up", ticks=n_rows, seconds=catchup_s,
         ticks_per_s={k: n_rows / v for k, v in catchup_s.items()})

    # -- the live day, bar by bar -------------------------------------------------
    out_offset = bus.end_offset(TOPIC_PREDICTION)
    live = {name: [] for name in consumers}
    latency = {name: [] for name in consumers}
    engine_ms, stamps = [], []

    def live_day():
        for _ in range(BARS_PER_DAY):
            bar = [next(messages) for _ in range(5)]
            t_bar = time.perf_counter()
            for topic, msg in bar:
                bus.publish(topic, msg)
            check(engine.step() == 1, "a live bar did not land one row")
            t_engine = time.perf_counter()
            engine_ms.append((t_engine - t_bar) * 1e3)
            stamps.append(bar[0][1]["Timestamp"])
            for name, poll in consumers.items():
                t = time.perf_counter()
                got = poll()
                latency[name].append((t_engine - t_bar
                                      + time.perf_counter() - t) * 1e3)
                live[name].append(got)

    share = device_share(live_day, host_activity=False)
    counts = launch_counts()  # the live day ends here
    catchup_ticks = n_rows
    expected_live = {
        "gru_scan_fwd": 2 * BARS_PER_DAY + catchup_ticks + BARS_PER_DAY,
        "ssm_tick": catchup_ticks + BARS_PER_DAY}
    check(all(len(got) == 1 for v in live.values() for got in v),
          "a consumer did not serve exactly one prediction a bar: "
          + str({k: [len(g) for g in v] for k, v in live.items()}))
    probs = {
        "predictor": [np.asarray(g[0].probabilities) for g in
                      live["predictor"]],
        **{name: [g[0][1] for g in live[name]] for name in streams}}
    served_ts = {"predictor": [g[0].timestamp for g in live["predictor"]],
                 **{name: [g[0][0] for g in live[name]] for name in streams}}
    check(all(v == stamps for v in served_ts.values()),
          "a consumer served other timestamps than the bars'")
    check(all(np.isfinite(p).all() for v in probs.values() for p in v),
          "non-finite live probabilities")
    published = bus.end_offset(TOPIC_PREDICTION) - out_offset
    check(published == 3 * BARS_PER_DAY,
          f"{published} predictions published for {BARS_PER_DAY} bars")
    emit("pipeline live day", bars=BARS_PER_DAY, rows=len(wh),
         published=published, engine_step_ms_p50=statistics.median(engine_ms),
         engine_step_ms_p99=p99(engine_ms),
         bar_to_prediction_ms={name: dict(
             p50=statistics.median(v), p99=p99(v), mean=statistics.fmean(v))
             for name, v in latency.items()},
         device_share=share, profiler="device activity only",
         launches=counts, engine_stats=engine.stats)
    check_launches(counts, expected_live, "pipeline live day")

    # -- where a bar's consumer time goes ---------------------------------------
    ids = [wh.id_for_timestamp(ts) for ts in stamps]
    forward = make_batched_forward(load_model(
        model_cfg, tree["params"], torch.device(device)))
    x_min = torch.as_tensor(norm.x_min, device=device)
    x_range = torch.as_tensor(norm.x_max - norm.x_min, device=device)
    windows = [wh.fetch(range(i - window + 1, i + 1))[None] for i in ids]
    rows = wh.fetch(ids)

    def synced(fn):
        def run(item):
            fn(item)
            torch.cuda.synchronize()
        return run

    pieces = dict(
        lookup_ms=median_ms(wh.id_for_timestamp, stamps),
        fetch_window_ms=median_ms(
            lambda i: wh.fetch(range(i - window + 1, i + 1)), ids),
        fetch_row_ms=median_ms(lambda i: wh.fetch(range(i, i + 1)), ids),
        forward_ms=median_ms(synced(lambda x: forward(
            x_min, x_range, torch.from_numpy(x).to(device)).cpu()), windows))
    for name, core in cores.items():
        fresh = type(core)(core.cfg,
                           tree["params"] if name != "ssm" else ssm_state,
                           norm if name != "ssm" else ssm_norm,
                           window=window, device=device)
        pieces[f"{name}_tick_ms"] = median_ms(fresh.step, rows)
    emit("pipeline live breakdown", **pieces)

    # -- the card's Predictor against the port's on the CPU ----------------------
    cpu_bus = InProcessBus(DEFAULT_TOPICS)
    cpu_pred = Predictor.from_checkpoint(
        ckpt, cpu_bus, wh, model_cfg, window=window,
        threshold=cfg.train.prob_threshold, from_end=False,
        max_staleness_s=None, device="cpu")
    for ts in stamps:
        cpu_bus.publish(TOPIC_PREDICT_TIMESTAMP, {"Timestamp": ts})
    cpu_preds = cpu_pred.poll()
    err = max(float(np.abs(g - np.asarray(c.probabilities)).max())
              for g, c in zip(probs["predictor"], cpu_preds))
    same_labels = ([g[0].labels for g in live["predictor"]]
                   == [c.labels for c in cpu_preds])
    golden = golden_day()
    emit("pipeline vs cpu", signals=len(cpu_preds), max_abs_err=err,
         labels_equal=same_labels, tol=PATH_TOL, golden_day=golden)
    check(len(cpu_preds) == BARS_PER_DAY and err <= PATH_TOL,
          f"pipeline: card and CPU Predictor disagree ({err})")
    check(same_labels, "pipeline: card and CPU labels differ")
    emit("pipeline done", seconds=time.perf_counter() - phase_t0)
    if traced_day is not None:
        traced_day(dict(bus=bus, engine=engine, wh=wh, messages=messages,
                        consumers=consumers, cfg=cfg))
    wh.close()
    return {k: demo_counts[k] + counts[k] for k in counts}


#: the obs phase: default fleet loads of tracing off and of 1 % sampling
#: (alternating; 100 % every other round), the settings (a sample rate;
#: None is tracing off), the gross-loss floor of 1 % sampling's median
#: ticks/s against off's, and the reference's budget for the plane
#: (bench.py trace_overhead: 2 %).  A load's ticks/s spreads ~2x on the
#: card's host (PERF.md section 7), so the floor needs many loads a side
OBS_LOADS = 20
OBS_TRACE_RATES = (None, 0.01, 1.0)
OBS_TRACE_FLOOR = 0.90
OBS_BUDGET = 0.98
#: the device plane's cost on the ssm pool's flush loop: sessions (one
#: flush of bucket 64 a step), steps a run, interleaved runs a setting
OBS_PLANE_STEPS = 300
OBS_PLANE_REPS = 20
#: the ledger's sampled ssm_tick time against the kernel phase's primed
#: time at bucket 64 must agree within this factor either way: each event
#: pair brackets the kernel plus the host's enqueue of it (the ctypes call,
#: the launch) on a card that idles between flushes (the fleet is
#: host-bound), so every pair reads above the kernel's own ~12 us; their
#: minimum, the tightest of those bounds, by about one launch's host time,
#: not by an order of magnitude (their mean carries the host's jitter: a
#: pair that waits on a descheduled host thread reads 0.1 ms and more)
OBS_DEVICE_MS_FACTOR = 10.0
#: the traced live day against the phase's own host clocks for the same
#: bars: the medians agree within the larger of this many ms and this
#: share of the clock's median (the clock brackets the call, the spans
#: start inside it: the engine's step before its first stamp and after its
#: signals, a consumer's poll of the bus around its serve span)
OBS_CLOCK_TOL_MS = 0.25
OBS_CLOCK_TOL_SHARE = 0.10
#: fleet flushes inside the device_trace capture
OBS_PROFILE_FLUSHES = 10
#: the argument that runs the capture alone (``device_trace_child``)
DEVICE_TRACE_ARG = "--obs-device-trace"


def prometheus_parses(text: str) -> bool:
    """Every line of a text exposition a ``# TYPE`` comment or a
    ``name{labels} value`` sample with a float value."""
    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? (\S+)$')
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            continue
        m = sample.match(line)
        if m is None:
            return False
        try:
            float(m.group(2))
        except ValueError:
            return False
    return bool(text)


def scrape(url: str):
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read().decode()


def cli_output(argv) -> tuple:
    """(exit code, stdout) of ``python -m fmda_tpu_torch ARGV``, in this
    process."""
    import contextlib
    import io

    from fmda_tpu_torch import __main__ as cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def obs_trace_cost(models, device):
    """The default fleet load with tracing off, at 1 % and at 100 %,
    alternating in one process, OBS_LOADS loads of off and of 1 % and half
    as many at 100 % for each family: each setting's median ticks/s and
    range."""
    from fmda_tpu_torch.obs import configure_tracing, default_tracer

    flushes = {}
    for cell, (model_cfg, state) in models.items():
        tps = {rate: [] for rate in OBS_TRACE_RATES}
        finished = {rate: 0 for rate in OBS_TRACE_RATES}
        served = {rate: 0 for rate in OBS_TRACE_RATES}
        flushes[cell] = 0
        for i in range(OBS_LOADS):
            for rate in OBS_TRACE_RATES:
                if rate == 1.0 and i % 2:
                    continue
                configure_tracing(enabled=rate is not None,
                                  sample_rate=rate or 1.0)
                default_tracer().clear()
                out, _, _, _ = fleet_run(model_cfg, state,
                                         FLEET_LOADS["default"],
                                         device=device, depth=1)
                tps[rate].append(out["ticks_served"] / out["wall_s"])
                finished[rate] += default_tracer().traces_finished
                served[rate] += out["ticks_served"]
                flushes[cell] += out["counters"]["flushes"]
        configure_tracing(enabled=False)
        default_tracer().clear()
        med = {rate: statistics.median(v) for rate, v in tps.items()}
        row = {str(rate or "off"): dict(
            median_ticks_per_s=med[rate], min=min(tps[rate]),
            max=max(tps[rate]), traces_finished=finished[rate])
            for rate in OBS_TRACE_RATES}
        ratio_1 = med[0.01] / med[None]
        ratio_100 = med[1.0] / med[None]
        emit("obs tracing cost", cell=cell,
             loads={str(rate or "off"): len(v) for rate, v in tps.items()},
             settings=row, ratio_1pct=ratio_1, ratio_100pct=ratio_100,
             floor=OBS_TRACE_FLOOR, budget_2pct_held=ratio_1 >= OBS_BUDGET)
        check(ratio_1 >= OBS_TRACE_FLOOR,
              f"{cell} fleet: 1 % tracing costs more than a gross loss "
              f"({ratio_1:.3f} of off)")
        check(finished[None] == 0 and finished[1.0] == served[1.0]
              and 0 < finished[0.01] < served[0.01],
              f"{cell} fleet: traces {finished} for ticks {served}")
    return flushes


def obs_plane_cost(model_cfg, state, device):
    """The device plane's cost on the ssm pool's flush loop: the pool
    stepped directly (the batcher's scheduling noise is larger than the
    cost priced), one flush of all 64 sessions a step, with the kernel
    ledger (CUDA-event sampling included) and the memory monitor's cadence
    check a step, then with the host profiler running too, against all of
    them off; interleaved, OBS_PLANE_REPS runs a setting."""
    from fmda_tpu_torch import ops
    from fmda_tpu_torch.config import ProfilingConfig
    from fmda_tpu_torch.obs import (
        configure_device_obs, default_ledger, default_memory_monitor)
    from fmda_tpu_torch.obs.pyprof import HostProfiler
    from fmda_tpu_torch.runtime import SessionPool

    pool = SessionPool(model_cfg, state, capacity=128, window=30,
                       device=device)
    for i in range(POOL_SESSIONS):
        pool.alloc(f"S{i}")
    gen = np.random.default_rng(SEED)
    slots = np.arange(POOL_SESSIONS, dtype=np.int32)
    rows = gen.normal(size=(POOL_SESSIONS, model_cfg.n_features)).astype(
        np.float32)
    memory = default_memory_monitor()
    memory.register_owner("obs_plane_pool", pool.live_tree)
    launched0 = ops.launch_counts()["ssm_tick"]
    for _ in range(50):
        pool.step(slots, rows)
    ledger = default_ledger()
    samples = 0

    def run(setting):
        nonlocal samples
        configure_device_obs(ProfilingConfig(enabled=setting != "off"))
        profiler = HostProfiler() if setting == "plane+profiler" else None
        if profiler is not None:
            profiler.start()
        try:
            t0 = time.perf_counter()
            for _ in range(OBS_PLANE_STEPS):
                pool.step(slots, rows)
                memory.maybe_sample()
            return time.perf_counter() - t0
        finally:
            if profiler is not None:
                profiler.stop()
                samples += sum(HostProfiler.parse_folded(
                    profiler.folded()).values())

    settings = ("off", "plane", "plane+profiler")
    times = {k: [] for k in settings}
    ledger.reset()
    for _ in range(OBS_PLANE_REPS):
        for k in settings:
            times[k].append(run(k))
    configure_device_obs(ProfilingConfig(enabled=False))
    booked = ledger.launches().get("ssm_tick", 0)
    launched = ops.launch_counts()["ssm_tick"] - launched0
    med = {k: statistics.median(v) for k, v in times.items()}
    low = {k: min(v) for k, v in times.items()}
    emit("obs device plane cost", cell="ssm", steps=OBS_PLANE_STEPS,
         reps=OBS_PLANE_REPS, seconds_median=med, seconds_min=low,
         plane_ratio=med["plane"] / med["off"],
         plane_ratio_min=low["plane"] / low["off"],
         profiler_share=(med["plane+profiler"] - med["plane"]) / med["off"],
         profiler_share_min=(low["plane+profiler"] - low["plane"])
         / low["off"],
         profiler_samples=samples, ledger_launches=booked,
         ssm_tick_launches=launched,
         sampled=ledger.kernel_totals().get("ssm_tick", {}).get("sampled"))
    # the ledger books exactly the launches made while it was attached
    check(booked == 2 * OBS_PLANE_REPS * OBS_PLANE_STEPS
          and launched == 50 + 3 * OBS_PLANE_REPS * OBS_PLANE_STEPS,
          f"ledger booked {booked} of {launched} ssm_tick launches")
    return launched


def obs_endpoint(model_cfg, state, tick_rows, device):
    """A MetricsServer on 127.0.0.1:0 over a traced ssm fleet (100 %): the
    default load between two scrapes of /metrics, then /healthz,
    /snapshot, /trace and /device, and the CLI's trace, perf and status
    against it."""
    from fmda_tpu_torch import ops
    from fmda_tpu_torch.config import ObservabilityConfig, ProfilingConfig
    from fmda_tpu_torch.obs import (
        Observability, configure_device_obs, configure_tracing,
        default_ledger, default_memory_monitor, default_tracer)
    from fmda_tpu_torch.obs.trace import group_chrome_traces
    from fmda_tpu_torch.runtime import FleetLoadConfig, run_fleet_load

    configure_device_obs(ProfilingConfig(memory_interval_s=0.0))
    ledger = default_ledger()
    ledger.reset()
    tracer = configure_tracing(enabled=True, sample_rate=1.0)
    tracer.clear()
    gateway, _ = fleet_gateway(model_cfg, state, device=device, depth=1)
    obs = Observability(ObservabilityConfig(port=0))
    obs.track_fleet(gateway)
    try:
        server = obs.start_server(host="127.0.0.1", port=0)
        endpoint = f"127.0.0.1:{server.port}"
        scrape(server.url + "/metrics")  # the MFU's first reading
        launched0 = ops.launch_counts()["ssm_tick"]
        t0 = time.perf_counter()
        out = run_fleet_load(gateway, FleetLoadConfig(
            **FLEET_LOADS["default"]))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        launched = ops.launch_counts()["ssm_tick"] - launched0
        status, metrics = scrape(server.url + "/metrics")
        health_status, health = scrape(server.url + "/healthz")
        snap = json.loads(scrape(server.url + "/snapshot")[1])
        trace_doc = json.loads(scrape(server.url + "/trace")[1])
        device_doc = json.loads(scrape(server.url + "/device")[1])
        cli = {name: cli_output([name, "--endpoint", endpoint, *extra])
               for name, extra in (("trace", ["--last", "3"]),
                                   ("perf", []), ("status", []))}
    finally:
        obs.close()
        configure_tracing(enabled=False)
        configure_device_obs(ProfilingConfig(enabled=False))
    def gauge(name):
        found = re.search(rf"^fmda_{name}\{{[^}}]*\}} (\S+)$", metrics, re.M)
        return float(found.group(1)) if found else None

    mfu = gauge("device_mfu")
    totals = {k["kernel"]: k for k in device_doc["ledger"]["kernels"]}
    tick = totals["ssm_tick"]
    sampled_ms = tick["device_ms_mean"]
    tightest_ms = tick["device_ms_min"]
    kernel_ms = next(r for r in tick_rows if r["batch"] == POOL_SESSIONS
                     and r["n_layers"] == 1 and r["dtype"] == "float32"
                     and r["hidden"] == 32 and not r["padded"])["ms"]
    memory = device_doc["memory"]
    pool_bytes = memory["by_owner"].get("session_pool", 0)
    grouped = group_chrome_traces(trace_doc)
    served = out["ticks_served"]
    emit("obs endpoint", cell="ssm", endpoint=endpoint, load_s=load_s,
         ticks_served=served, metrics_lines=len(metrics.splitlines()),
         prometheus_parses=prometheus_parses(metrics), healthz=health_status,
         ledger_ssm_tick=tick["launches"], ssm_tick_launches=launched,
         sampled=tick["sampled"], sampled_device_ms_mean=sampled_ms,
         sampled_device_ms_min=tightest_ms, kernel_phase_ms=kernel_ms,
         min_over_kernel=(tightest_ms / kernel_ms
                          if tightest_ms and kernel_ms else None),
         mean_over_kernel=(sampled_ms / kernel_ms
                           if sampled_ms and kernel_ms else None),
         device_mfu=mfu,
         arithmetic_intensity=gauge("device_arithmetic_intensity"),
         snapshot_series=sum(len(v) for v in snap.values()),
         nvcc_seconds=device_doc["ledger"]["nvcc_seconds"],
         memory_watermark_bytes=memory["watermark_bytes"],
         pool_bytes=pool_bytes, allocated_bytes=memory["allocated_bytes"],
         reserved_bytes=memory["reserved_bytes"],
         traces_started=tracer.traces_started,
         traces_finished=tracer.traces_finished,
         traces_in_ring=len(grouped),
         cli_exit={k: v[0] for k, v in cli.items()},
         cli_lines={k: len(v[1].splitlines()) for k, v in cli.items()})
    check(status == 200 and prometheus_parses(metrics),
          "the /metrics text does not parse")
    check(health_status == 200 and json.loads(health)["status"] == "ok",
          f"/healthz: {health}")
    check(tick["launches"] == launched == out["counters"]["flushes"],
          f"ledger booked {tick['launches']} ssm_tick launches, the "
          f"counter {launched}, flushes {out['counters']['flushes']}")
    check(tightest_ms is not None
          and kernel_ms / OBS_DEVICE_MS_FACTOR <= tightest_ms
          <= kernel_ms * OBS_DEVICE_MS_FACTOR,
          f"sampled ssm_tick {tightest_ms} ms (the least of "
          f"{tick['sampled']}) against the kernel phase's {kernel_ms} ms")
    check(mfu is not None and 0 < mfu < 1, f"device_mfu {mfu}")
    check(pool_bytes > 0 and memory["watermark_bytes"] >= pool_bytes,
          f"memory watermark {memory['watermark_bytes']} under the pool's "
          f"{pool_bytes} bytes")
    check(tracer.traces_started == tracer.traces_finished == served
          == out["ticks_submitted"],
          f"traces {tracer.traces_started}/{tracer.traces_finished} for "
          f"{served} ticks")
    check(all(rc == 0 for rc, _ in cli.values())
          and cli["trace"][1].count("root=tick") == 3
          and "kernel ledger" in cli["perf"][1]
          and "status: ok" in cli["status"][1],
          f"the CLI against the endpoint: {cli}")
    return launched


def obs_device_trace(device):
    """``device_trace`` over OBS_PROFILE_FLUSHES flushes of the ssm fleet
    into the build directory, in a process of its own: a CPU and CUDA
    profile late in a process that has run many profiles before (the
    busy shares of the earlier phases) keeps no device activity on this
    card's torch, while a CUDA-only profile in the same process still
    does, so the capture runs as ``device_trace`` would in a serving
    process that traces once.  The child checks the Chrome JSON for the
    numbered ``pool_flush`` ranges and the ssm tick kernel; its launches
    are its own process's."""
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), DEVICE_TRACE_ARG,
         device], capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    for line in child.stdout.splitlines():
        print(line, flush=True)
    check(child.returncode == 0,
          f"the device_trace capture failed ({child.returncode}): "
          f"{child.stderr[-2000:]}")


def device_trace_child(device: str) -> int:
    """The capture of :func:`obs_device_trace`, in this process."""
    from fmda_tpu_torch.models import build_model
    from fmda_tpu_torch.ops import _cuda_lib
    from fmda_tpu_torch.utils.tracing import device_trace

    model_cfg = model_config("ssm", bidirectional=False, dropout=0.0)
    state = build_model(model_cfg, generator=torch.Generator().manual_seed(
        SEED)).state_dict()
    gateway, _ = fleet_gateway(model_cfg, state, device=device, depth=1)
    gateway.annotate_device_steps = True
    for i in range(POOL_SESSIONS):
        gateway.open_session(f"S{i}")
    gen = np.random.default_rng(SEED)
    rows = gen.normal(size=(POOL_SESSIONS, model_cfg.n_features)).astype(
        np.float32)
    out_dir = _cuda_lib.BUILD_ROOT / "obs_device_trace"
    for old in out_dir.glob("*.json") if out_dir.exists() else ():
        old.unlink()
    for i in range(POOL_SESSIONS):  # warm-up, outside the capture
        gateway.submit(f"S{i}", rows[i])
    gateway.pump(force=True)
    t0 = time.perf_counter()
    with device_trace(str(out_dir)):
        for _ in range(OBS_PROFILE_FLUSHES):
            for i in range(POOL_SESSIONS):
                gateway.submit(f"S{i}", rows[i])
            gateway.pump(force=True)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    files = sorted(out_dir.glob("*.json"))
    check(len(files) == 1, f"device_trace wrote {files}")
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = [e.get("name", "") for e in events]
    flushes = sorted({n for n in names if n.startswith("pool_flush#")})
    kernels = [n for n in names if "ssm_tick_kernel" in n]
    categories = {}
    for e in events:
        categories[e.get("cat", "")] = categories.get(e.get("cat", ""), 0) + 1
    emit("obs device trace", file=str(files[0]), bytes=files[0].stat().st_size,
         seconds=seconds, events=len(events), categories=categories,
         pool_flush_ranges=len(flushes), ssm_tick_kernels=len(kernels))
    check(len(flushes) == OBS_PROFILE_FLUSHES,
          f"{len(flushes)} pool_flush ranges in the device trace")
    check(torch.device(device).type != "cuda" or len(kernels) > 0,
          "no ssm_tick kernel in the device trace")
    return 0


def obs_traced_day(live):
    """One more synthetic day through the pipeline's bus, engine and
    three consumers with tracing at 100 %: each bar's messages published
    inside a ``session_tick`` root (as ``SessionDriver.run_tick`` publishes
    them), every bar split into its spans (bus_publish, the engine's join,
    land and signal, each consumer's serve), their medians, the trace
    against the phase's own host clocks for the same bars, and a
    QualityEvaluator over the Predictor's predictions.  Returns the day's
    launch counts."""
    from fmda_tpu_torch.data.synthetic import BARS_PER_DAY
    from fmda_tpu_torch.obs import configure_tracing
    from fmda_tpu_torch.obs.quality import QualityEvaluator

    bus, engine, wh = live["bus"], live["engine"], live["wh"]
    consumers, messages, cfg = live["consumers"], live["messages"], live["cfg"]
    tracer = configure_tracing(enabled=True, sample_rate=1.0,
                               capacity=1 << 16)
    tracer.clear()
    quality = QualityEvaluator(cfg.quality, warehouse=wh,
                               max_lead=cfg.features.max_lead)
    clock_ms = {"engine": [], **{name: [] for name in consumers}}
    roots = []
    start_path()
    try:
        for _ in range(BARS_PER_DAY):
            bar = [next(messages) for _ in range(5)]
            with tracer.root("session_tick", "ingest"):
                for topic, msg in bar:
                    bus.publish(topic, msg)
            roots.append(tracer.spans()[-1].trace_id)
            t = time.perf_counter()
            check(engine.step() == 1, "a traced bar did not land one row")
            clock_ms["engine"].append((time.perf_counter() - t) * 1e3)
            for name, poll in consumers.items():
                t = time.perf_counter()
                got = poll()
                clock_ms[name].append((time.perf_counter() - t) * 1e3)
                check(len(got) == 1, f"{name} served {len(got)} on a "
                      "traced bar")
                if name == "predictor":
                    pred = got[0]
                    quality.capture("SPY", pred.timestamp,
                                    np.asarray(pred.probabilities))
        counts = launch_counts()  # the traced day ends here
    finally:
        configure_tracing(enabled=False)
    by_trace = tracer.traces()
    stages = {k: [] for k in ("bus_publish", "join", "land", "signal",
                              "engine", *consumers)}
    for tid in roots:
        spans = by_trace[tid]
        named = {}
        for s in spans:
            named.setdefault(s.name, []).append(s)
        stages["bus_publish"].append(
            sum(s.dur_ns for s in named["bus_publish"]) / 1e6)
        for k in ("join", "land", "signal"):
            stages[k].append(named[k][0].dur_ns / 1e6)
        first, last = named["join"][0], named["signal"][0]
        stages["engine"].append(
            (last.t0_ns + last.dur_ns - first.t0_ns) / 1e6)
        serves = sorted(named["serve"], key=lambda s: s.t0_ns)
        check(len(serves) == len(consumers),
              f"a traced bar has {len(serves)} serve spans")
        for name, s in zip(consumers, serves):
            stages[name].append(s.dur_ns / 1e6)
    medians = {k: statistics.median(v) for k, v in stages.items()}
    clock_medians = {k: statistics.median(v) for k, v in clock_ms.items()}
    agree = {}
    for k in clock_ms:
        tol = max(OBS_CLOCK_TOL_MS, OBS_CLOCK_TOL_SHARE * clock_medians[k])
        agree[k] = abs(medians[k] - clock_medians[k]) <= tol
    quality.join(now=0.0)
    cons = quality.conservation()
    emit("obs traced day", bars=BARS_PER_DAY, traces=len(roots),
         spans=tracer.recorded, stage_median_ms=medians,
         clock_median_ms=clock_medians, tol_ms=OBS_CLOCK_TOL_MS,
         tol_share=OBS_CLOCK_TOL_SHARE, agree=agree,
         quality_joined=cons["joined"], quality=cons,
         quality_overall=quality.summary()["overall"], launches=counts)
    check(all(agree.values()),
          f"the trace and the host clocks disagree: {medians} against "
          f"{clock_medians}")
    check(cons["captured"] == BARS_PER_DAY and cons["joined"] > 0
          and cons["captured"] == cons["joined"] + cons["pending"]
          + cons["expired"] + cons["shed"],
          f"quality conservation: {cons}")
    check_launches(counts, {"gru_scan_fwd": 3 * BARS_PER_DAY,
                            "ssm_tick": BARS_PER_DAY}, "obs traced day")
    return counts


def phase_obs(tick_rows, traced_day_counts, device: str = "cuda"):
    """The observability plane on the card, after the pipeline (whose
    end ran ``obs_traced_day``): tracing's cost on the default fleet load
    (gru, ssm), the device plane's cost on the ssm pool's flush loop, a
    live endpoint over a traced ssm fleet with the CLI against it, and a
    device trace of the fleet's flushes.  Returns the phase's launch
    counts, the traced day's included."""
    from fmda_tpu_torch.models import build_model

    phase_t0 = time.perf_counter()
    models = {}
    for cell in ("gru", "ssm"):
        model_cfg = model_config(cell, bidirectional=False, dropout=0.0)
        models[cell] = (model_cfg, build_model(
            model_cfg, generator=torch.Generator().manual_seed(
                SEED)).state_dict())
    fleet_run(*models["ssm"], dict(n_sessions=8, n_ticks=2), device=device,
              depth=1)  # warm-up
    start_path()
    # the ssm fleet's flushes and the pool's steps, one tick launch each;
    # the gru pool launches no kernel
    flushes = obs_trace_cost(models, device)
    ticks = flushes["ssm"]
    ticks += obs_plane_cost(*models["ssm"], device)
    ticks += obs_endpoint(*models["ssm"], tick_rows, device)
    obs_device_trace(device)  # its launches are its own process's
    counts = launch_counts()  # the phase ends here
    check_launches(counts, {"ssm_tick": ticks}, "obs")
    emit("obs done", seconds=time.perf_counter() - phase_t0,
         launches=counts, traced_day_launches=traced_day_counts)
    return {k: counts[k] + traced_day_counts[k] for k in counts}


#: the app phase: the pipeline phase's days (PIPELINE_DAYS synthetic days,
#: a step a day) landed twice, through the native bus and join and through
#: the Python ones, then an Application on the native warehouse, on the
#: card, serving the next day bar by bar.  The keys the reference's
#: Application reports after such a day (no fleet attached):
#: tests/test_torch_app.py holds these to fmda_tpu.app's
APP_STATS_KEYS = ("bad_messages", "checkpoint_corrupt", "consumer_lag",
                  "degraded_rows", "degraded_streams", "dropped", "emitted",
                  "pending", "warehouse_rows", "watermark_age_s")
APP_STAGE_KEYS = ("ingest", "join", "land", "signal")
#: each consumer's own prediction topic, so its messages read apart
APP_TOPICS = {"predictor": "prediction", "ssm_stream": "prediction_ssm",
              "predictor_fleet": "prediction_fleet"}


def quiet_planes() -> None:
    """Tracing and the device plane off (the obs phase toggles both)."""
    from fmda_tpu_torch.config import ProfilingConfig
    from fmda_tpu_torch.obs import configure_device_obs, configure_tracing

    configure_tracing(enabled=False)
    configure_device_obs(ProfilingConfig(enabled=False))


def land_corpus(bus, engine, corpus, per_day: int) -> dict:
    """The corpus through ``bus`` and ``engine``, a day published, one
    step: seconds, rows/s and step ms."""
    step_ms = []
    t0 = time.perf_counter()
    for d in range(0, len(corpus), per_day):
        for topic, msg in corpus[d:d + per_day]:
            bus.publish(topic, msg)
        t = time.perf_counter()
        engine.step()
        step_ms.append((time.perf_counter() - t) * 1e3)
    seconds = time.perf_counter() - t0
    return dict(seconds=seconds, rows_per_s=engine.stats["emitted"] / seconds,
                step_ms_p50=statistics.median(step_ms),
                step_ms_p99=p99(step_ms), stats=engine.stats,
                stages=engine.timer.summary())


def landed_equal(a, b) -> bool:
    """Every landed column of two warehouses the same bits: the raw table
    chunk by chunk, the derived feature views and the targets."""
    raw_a, raw_b = list(a.iter_row_chunks()), list(b.iter_row_chunks())
    n = len(a)
    ids = range(1, n + 1)
    return (n == len(b) and len(raw_a) == len(raw_b)
            and all(ta == tb and ma.tobytes() == mb.tobytes()
                    for (ta, ma), (tb, mb) in zip(raw_a, raw_b))
            and a.fetch(ids).tobytes() == b.fetch(ids).tobytes()
            and a.fetch_targets(ids).tobytes()
            == b.fetch_targets(ids).tobytes())


def app_consumers(app, ckpt, ssm_setup, window, threshold):
    """The three consumers the app serves, each publishing to its own
    topic: the Predictor from the checkpoint, an ssm StreamingPredictor,
    and the batched Predictor (gru) on the checkpoint's weights."""
    from fmda_tpu_torch.serve import StreamingBiGRU
    from fmda_tpu_torch.train.checkpoint import restore_checkpoint

    for topic in APP_TOPICS.values():
        app.bus.add_topic(topic)
    ssm_cfg, ssm_state, ssm_norm = ssm_setup
    app.attach_predictor_from_checkpoint(
        ckpt, window=window, threshold=threshold, from_end=True,
        max_staleness_s=None, prediction_topic=APP_TOPICS["predictor"])
    app.attach_streaming_predictor(
        StreamingBiGRU(ssm_cfg, ssm_state, ssm_norm, window=window,
                       device=app.device),
        threshold=threshold, from_end=True,
        prediction_topic=APP_TOPICS["ssm_stream"])
    tree, norm = restore_checkpoint(ckpt)
    app.attach_predictor_fleet(
        app.config.model, tree["params"], norm, max_staleness_s=None,
        prediction_topic=APP_TOPICS["predictor_fleet"])


def app_predictions(bus, offsets) -> dict:
    """Each consumer's published (timestamp, probabilities) since
    ``offsets``."""
    return {name: [(r.value["timestamp"],
                    np.asarray(r.value["probabilities"], np.float32))
                   for r in bus.read(topic, offsets[name])]
            for name, topic in APP_TOPICS.items()}


def phase_app(directory: str, device: str = "cuda"):
    """The composition root on the card, after ``obs``:

    - the native path: ``default_bus`` builds the C++ ring bus and an
      engine with ``join_backend="native"`` runs the C++ scheduler (a
      failed ``g++`` build fails the phase: no fallback is accepted);
    - engine replay: the pipeline's PIPELINE_DAYS days through the
      Application's NativeBus and native join into a file warehouse, and
      through an InProcessBus and the python join into another, every
      landed column the same bits; rows/s and step ms of each;
    - ``app.train()`` (one epoch at batch 256), the checkpoint, then the
      Predictor from it, an ssm StreamingPredictor and the batched
      Predictor (gru) attached, and the next day bar by bar, one
      ``run_tick`` a bar: served = bars x consumers, each consumer's
      probabilities within PATH_TOL of the same consumers on the CPU,
      the launches, the keys of ``stats`` and ``stage_timings``;
      ``run_tick`` p50/p99;
    - the CLI through the Application: ``serve-fleet --role solo --cell
      ssm`` (kernel 5 once a flush) and ``status`` without ``--endpoint``
      over the phase's warehouse.

    Returns (the path's launch counts, the native warehouse's path)."""
    from fmda_tpu_torch.app import Application, default_bus
    from fmda_tpu_torch.config import (
        EngineConfig, FrameworkConfig, TOPIC_PREDICT_TIMESTAMP, TrainConfig)
    from fmda_tpu_torch.data.pipeline import WindowBatches
    from fmda_tpu_torch.data.synthetic import (
        BARS_PER_DAY, SyntheticMarketConfig, synthetic_session_messages)
    from fmda_tpu_torch.obs.registry import MetricsRegistry
    from fmda_tpu_torch.stream import InProcessBus, StreamEngine, Warehouse
    from fmda_tpu_torch.stream.native_bus import NativeBus, native_available
    from fmda_tpu_torch.stream.native_join import native_join_available
    from fmda_tpu_torch.train.checkpoint import save_checkpoint

    quiet_planes()
    phase_t0 = time.perf_counter()
    cfg = FrameworkConfig(
        train=TrainConfig(batch_size=BATCH, chunk_size=TRAIN_CHUNK, epochs=1,
                          seed=SEED),
        engine=EngineConfig(join_backend="native"))
    fc, window = cfg.features, cfg.train.window
    threshold = cfg.train.prob_threshold

    # -- the native path is the one that runs ---------------------------------
    t0 = time.perf_counter()
    built = native_available() and native_join_available()
    build_s = time.perf_counter() - t0
    check(built, "the native bus or join scheduler did not build")
    check(type(default_bus(cfg)) is NativeBus,
          "default_bus did not build the native ring bus")
    paths = {name: f"{directory}/app_{name}.sqlite"
             for name in ("native", "python")}
    app = Application(cfg, warehouse=Warehouse(fc, dataclasses.replace(
        cfg.warehouse, path=paths["native"])), device=device)
    check(type(app.bus) is NativeBus and app.engine.join_backend == "native"
          and app.engine._core is not None,
          f"the app runs {type(app.bus).__name__} and the "
          f"{app.engine.join_backend} join")

    # -- engine replay, python against native -----------------------------------
    per_day = 5 * BARS_PER_DAY
    messages = list(synthetic_session_messages(fc, SyntheticMarketConfig(
        seed=SEED, n_days=PIPELINE_DAYS + 1)))
    corpus, live = (messages[:PIPELINE_DAYS * per_day],
                    messages[PIPELINE_DAYS * per_day:])
    replay = {"native": land_corpus(app.bus, app.engine, corpus, per_day)}
    py_wh = Warehouse(fc, dataclasses.replace(cfg.warehouse,
                                              path=paths["python"]))
    py_engine = StreamEngine(
        InProcessBus(cfg.bus.topics, capacity=cfg.bus.capacity), py_wh, fc,
        metrics=MetricsRegistry())
    check(py_engine.join_backend == "python", "the python engine's join")
    replay["python"] = land_corpus(py_engine.bus, py_engine, corpus, per_day)
    same = landed_equal(app.warehouse, py_wh)
    n_rows = PIPELINE_DAYS * BARS_PER_DAY
    emit("app engine replay", days=PIPELINE_DAYS, rows=len(app.warehouse),
         native_build_s=build_s, landed_bit_identical=same,
         **{f"{name}_{k}": v for name, r in replay.items()
            for k, v in r.items()},
         native_over_python_rows_per_s=replay["native"]["rows_per_s"]
         / replay["python"]["rows_per_s"])
    check(same, "native and python landings differ")
    check(len(app.warehouse) == n_rows
          and replay["native"]["stats"]["dropped"] == 0,
          f"the native corpus landed {len(app.warehouse)} rows")
    py_wh.close()

    # -- train on it, then serve the next day bar by bar ------------------------
    start_path()
    t0 = time.perf_counter()
    state, history, dataset = app.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = launch_counts()
    ckpt = save_checkpoint(f"{directory}/app_ckpt", state,
                           dataset.final_norm_params)
    train_chunks, val_chunks, _ = dataset.split(cfg.train.val_size,
                                                cfg.train.test_size)
    n_train = sum(len(WindowBatches(dataset, i, BATCH)) for i in train_chunks)
    n_val = sum(len(WindowBatches(dataset, i, BATCH)) for i in val_chunks)
    tr = history["train"][-1]
    emit("app train", steps=n_train, val_batches=n_val, seconds=train_s,
         loss=tr.loss, accuracy=tr.accuracy, launches=train_counts)
    check_launches(train_counts, train_launches("gru", n_train, n_val),
                   "app train")
    check(math.isfinite(tr.loss), "app train: non-finite loss")

    ssm_setup = serving_setup(app.warehouse, "ssm", False)
    app_consumers(app, ckpt, ssm_setup, window, threshold)
    offsets = {name: app.bus.end_offset(topic)
               for name, topic in APP_TOPICS.items()}
    start_path()
    tick_ms, served, stamps = [], 0, []
    for b in range(BARS_PER_DAY):
        bar = live[b * 5:(b + 1) * 5]
        for topic, msg in bar:
            app.bus.publish(topic, msg)
        t = time.perf_counter()
        out = app.run_tick()
        tick_ms.append((time.perf_counter() - t) * 1e3)
        check(out["emitted"] == 1, f"bar {b} landed {out['emitted']} rows")
        served += out["served"]
        stamps.append(bar[0][1]["Timestamp"])
    torch.cuda.synchronize()
    live_counts = launch_counts()
    card = app_predictions(app.bus, offsets)
    stats, stages = app.stats, app.stage_timings
    expected_live = {"gru_scan_fwd": 2 * BARS_PER_DAY * 2,
                     "ssm_tick": n_rows + BARS_PER_DAY}

    # the same consumers on the CPU, over the same warehouse
    cpu_app = Application(cfg, bus=InProcessBus(
        tuple(cfg.bus.topics) + tuple(APP_TOPICS.values())),
        warehouse=app.warehouse, device="cpu")
    app_consumers(cpu_app, ckpt, ssm_setup, window, threshold)
    cpu_offsets = {name: 0 for name in APP_TOPICS}
    for ts in stamps:
        cpu_app.bus.publish(TOPIC_PREDICT_TIMESTAMP, {"Timestamp": ts})
    t0 = time.perf_counter()
    cpu_app.run_tick()
    cpu_s = time.perf_counter() - t0
    cpu = app_predictions(cpu_app.bus, cpu_offsets)
    cpu_app.close()
    errs = {name: max(float(np.abs(a[1] - b[1]).max())
                      for a, b in zip(card[name], cpu[name]))
            for name in APP_TOPICS}
    emit("app live day", bars=BARS_PER_DAY, consumers=list(APP_TOPICS),
         served=served, run_tick_ms_p50=statistics.median(tick_ms),
         run_tick_ms_p99=p99(tick_ms), run_tick_ms_mean=statistics.fmean(
             tick_ms), stats_keys=sorted(stats),
         stage_timings=stages, launches=live_counts, cpu_seconds=cpu_s,
         max_abs_err_vs_cpu=errs, tol=PATH_TOL)
    check(served == BARS_PER_DAY * len(APP_TOPICS),
          f"app served {served} for {BARS_PER_DAY} bars")
    check(all([ts for ts, _ in card[n]] == stamps
              and [ts for ts, _ in cpu[n]] == stamps for n in APP_TOPICS),
          "a consumer served other timestamps than the bars'")
    check(all(e <= PATH_TOL for e in errs.values()),
          f"app: card and CPU consumers disagree {errs}")
    check(tuple(sorted(stats)) == APP_STATS_KEYS
          and tuple(sorted(stages)) == APP_STAGE_KEYS,
          f"app stats {sorted(stats)}, stage timings {sorted(stages)}")
    check_launches(live_counts, expected_live, "app live day")
    app.close()

    # -- the CLI through the Application ---------------------------------------
    start_path()
    rc, text = cli_output(["serve-fleet", "--role", "solo", "--cell", "ssm"])
    fleet_counts = launch_counts()
    out = json.loads(text) if rc == 0 else {}
    flushes = out.get("counters", {}).get("flushes")
    rc_status, status_text = cli_output(["status", "--warehouse",
                                         paths["native"]])
    emit("app cli", serve_fleet_rc=rc, ticks_served=out.get("ticks_served"),
         ticks_per_s=out.get("ticks_per_s"), flushes=flushes,
         launches=fleet_counts, status_rc=rc_status,
         status=status_text.splitlines()[:1])
    check(rc == 0 and out.get("cell") == "ssm",
          f"serve-fleet --cell ssm exited {rc}")
    check_launches(fleet_counts, {"ssm_tick": flushes}, "app serve-fleet")
    check(rc_status == 0 and status_text.startswith("status: ok"),
          f"status without --endpoint exited {rc_status}")
    app.warehouse.close()
    emit("app done", seconds=time.perf_counter() - phase_t0)
    counts = {k: train_counts[k] + live_counts[k] + fleet_counts[k]
              for k in train_counts}
    return counts, paths["native"]


#: the replay phase: the shape of the reference bench's replay cells
#: (bench.py phase_replay_throughput): 16 tickers x 96 rounds, bucket 16,
#: the live loop at a 25 ms cadence
REPLAY_TICKERS = 16
REPLAY_ROUNDS = 96
REPLAY_BUCKET = 16
REPLAY_CADENCE_S = 0.025
#: the warehouse backfill: the newest rows of the app phase's warehouse
REPLAY_WAREHOUSE_ROWS = 1600
#: serve-fleet --continuous-train --swap-guard: a 14-day corpus (1,092
#: rows, two tail pages), no validation split, so a round's forwards,
#: backwards and weight gradients are its steps
GUARD_ARGS = ["--sessions", "16", "--ticks", "20", "--continuous-train",
              "--continuous-days", "14", "--train-rounds", "2",
              "--swap-guard"]
GUARD_TRAIN = {"chunk_size": 100, "batch_size": 64, "val_size": 0.0,
               "test_size": 0.0, "continuous_poll_s": 0.01}


def replay_gateway(model_cfg, state, device, n_tickers=REPLAY_TICKERS):
    from fmda_tpu_torch.runtime import BatcherConfig, FleetGateway, SessionPool

    pool = SessionPool(model_cfg, state, capacity=n_tickers, window=30,
                       device=device)
    return FleetGateway(pool, None, batcher_config=BatcherConfig(
        bucket_sizes=(n_tickers,), max_linger_s=0.002))


def by_session(results):
    return sorted(results, key=lambda r: (r.session_id, r.seq))


def shadow_check(wh_path: str, device: str) -> dict:
    """The hot-swap guardrail over the app phase's warehouse: an
    incumbent gru whose head bias decides each label as the majority of
    the scored rows does, the candidate the same weights (passes) and the
    head negated (refused at the default margin); on the card and on the
    CPU, the same verdicts and accuracies."""
    from fmda_tpu_torch.config import FrameworkConfig
    from fmda_tpu_torch.eval.shadow import ShadowEvaluator
    from fmda_tpu_torch.stream import Warehouse

    cfg = FrameworkConfig()
    wh = Warehouse(cfg.features, dataclasses.replace(cfg.warehouse,
                                                     path=wh_path))
    q = cfg.quality
    scored = q.swap_eval_rounds * q.swap_eval_sessions
    last = len(wh) - cfg.features.max_lead
    on = wh.fetch_targets(range(last - scored + 1, last + 1)).mean(axis=0)
    model_cfg = model_config("gru", bidirectional=False, dropout=0.0)
    from fmda_tpu_torch.models import build_model

    incumbent = build_model(model_cfg, generator=torch.Generator().manual_seed(
        SEED)).state_dict()
    incumbent["linear.bias"] = torch.as_tensor(
        np.where(on > 0.5, 5.0, -5.0), dtype=torch.float32)
    negated = {k: v.clone() for k, v in incumbent.items()}
    negated["linear.bias"].neg_()
    negated["linear.weight"].neg_()
    verdicts, seconds = {}, {}
    for side, dev in (("card", device), ("cpu", "cpu")):
        guard = ShadowEvaluator(
            incumbent, model_config=model_cfg, warehouse=wh,
            quality_config=q, max_lead=cfg.features.max_lead,
            window=cfg.runtime.window,
            row_transform=wh.joined_row_transform, device=dev)
        t0 = time.perf_counter()
        verdicts[side] = [guard(incumbent), guard(negated)]
        seconds[side] = time.perf_counter() - t0
    wh.close()
    (same, neg), cpu = verdicts["card"], verdicts["cpu"]
    check(same[0] is True and same[1]["scored"] and same[1]["joined"]
          == scored, f"shadow: the incumbent against itself {same}")
    check(neg[0] is False, f"shadow: the negated head passed {neg}")
    check([same, neg] == cpu, f"shadow: card {[same, neg]}, CPU {cpu}")
    return dict(same=same, negated=neg, card_seconds=seconds["card"],
                cpu_seconds=seconds["cpu"])


def phase_replay(wh_path: str, directory: str, device: str = "cuda",
                 cell: str = "gru"):
    """Historical replay for one carried-state family at full width:

    - ``ReplayDriver`` over ``SyntheticHistory`` (REPLAY_TICKERS x
      REPLAY_ROUNDS) through a FleetGateway at bucket REPLAY_BUCKET, and
      ``run_live_reference`` at REPLAY_CADENCE_S: ticks/s and rows/s of
      each, the results sorted by (session, seq) byte-equal, and again
      through the binary and the json wire dialects;
    - the halfway hot swap to the seed + 1 weights: no session dropped, no
      tick lost, seqs contiguous, the results before the swap the
      swap-free run's bytes, after it the new weights';
    - the replay's probabilities against the same replay on the CPU;
    - ``WarehouseHistory`` over the newest REPLAY_WAREHOUSE_ROWS rows of
      the app phase's warehouse with a QualityEvaluator: conservation;
    - for gru, the ShadowEvaluator (:func:`shadow_check`) and ``serve-fleet
      --continuous-train --swap-guard``.

    Launches: kernel 5 once an ssm flush, none for gru's pool; the guarded
    loop's scans one a training step.  Returns the path's launch counts."""
    from fmda_tpu_torch.config import FrameworkConfig
    from fmda_tpu_torch.models import build_model
    from fmda_tpu_torch.obs.quality import QualityEvaluator
    from fmda_tpu_torch.replay import (
        ReplayDriver, SyntheticHistory, WarehouseHistory, run_live_reference)
    from fmda_tpu_torch.stream import Warehouse

    quiet_planes()
    phase_t0 = time.perf_counter()
    cfg = FrameworkConfig()
    model_cfg = model_config(cell, bidirectional=False, dropout=0.0)

    def seeded(seed):
        return build_model(model_cfg, generator=torch.Generator().manual_seed(
            seed)).state_dict()

    state, swap_state = seeded(SEED), seeded(SEED + 1)
    source = SyntheticHistory(REPLAY_TICKERS, REPLAY_ROUNDS,
                              model_cfg.n_features, seed=SEED)
    ReplayDriver(replay_gateway(model_cfg, state, device),
                 SyntheticHistory(REPLAY_TICKERS, 2, model_cfg.n_features,
                                  seed=SEED)).run()  # warm-up
    start_path()
    flushes = 0

    def replay(dialect=None, on_round=None, gateway=None):
        nonlocal flushes
        gateway = gateway or replay_gateway(model_cfg, state, device)
        driver = ReplayDriver(gateway, source, wire_dialect=dialect,
                              collect=True, on_round=on_round)
        out = driver.run()
        flushes += out["counters"]["flushes"]
        return out, by_session(driver.results)

    runs = {"replay": replay()}
    live = run_live_reference(replay_gateway(model_cfg, state, device),
                              source, cadence_s=REPLAY_CADENCE_S,
                              collect=True)
    flushes += live["counters"]["flushes"]
    live_results = by_session(live["results"])
    for dialect in ("binary", "json"):
        runs[dialect] = replay(dialect)

    def same_bytes(a, b):
        return len(a) == len(b) and all(
            (x.session_id, x.seq) == (y.session_id, y.seq)
            and x.probabilities.tobytes() == y.probabilities.tobytes()
            for x, y in zip(a, b))

    identity = {name: same_bytes(results, live_results)
                for name, (_, results) in runs.items()}

    # the halfway hot swap
    swap_at = REPLAY_ROUNDS // 2
    swap_gateway = replay_gateway(model_cfg, state, device)
    swapped = {}

    def on_round(r):
        if not swapped and r + 1 >= swap_at:
            swapped["version"] = swap_gateway.hot_swap(swap_state)

    swap_out, swap_results = replay(on_round=on_round, gateway=swap_gateway)
    plain = runs["replay"][1]
    n_ticks = REPLAY_TICKERS * REPLAY_ROUNDS
    seqs_ok = all(
        [r.seq for r in swap_results if r.session_id == f"T{i:04d}"]
        == list(range(REPLAY_ROUNDS)) for i in range(REPLAY_TICKERS))
    before_same = all(
        x.probabilities.tobytes() == y.probabilities.tobytes()
        and y.weights_version is None
        for x, y in zip(plain, swap_results) if y.seq < swap_at)
    after = [(x, y) for x, y in zip(plain, swap_results) if y.seq >= swap_at]
    after_new = (all(y.weights_version == 1 for _, y in after)
                 and any(not np.array_equal(x.probabilities, y.probabilities)
                         for x, y in after))
    c = swap_out["counters"]
    lost = n_ticks - swap_out["ticks_served"]

    # the warehoused backfill, with the label join
    wh = Warehouse(cfg.features, dataclasses.replace(cfg.warehouse,
                                                     path=wh_path))
    quality = QualityEvaluator(cfg.quality, warehouse=wh,
                               max_lead=cfg.features.max_lead)
    history = WarehouseHistory(
        wh, REPLAY_TICKERS, start_ts=wh.recent_timestamps(
            REPLAY_WAREHOUSE_ROWS)[-1],
        row_transform=wh.joined_row_transform())
    wh_gateway = replay_gateway(model_cfg, state, device)
    wh_out = ReplayDriver(wh_gateway, history, quality=quality).run()
    flushes += wh_out["counters"]["flushes"]
    quality.join()
    conservation = quality.conservation()
    wh.close()
    counts = launch_counts()  # the card's replays end here

    # the card against the CPU
    cpu_driver = ReplayDriver(replay_gateway(model_cfg, state, "cpu"), source,
                              collect=True)
    cpu_driver.run()
    cpu_results = by_session(cpu_driver.results)
    err = max(float(np.abs(x.probabilities - y.probabilities).max())
              for x, y in zip(plain, cpu_results))
    rep = runs["replay"][0]
    emit("replay", cell=cell, tickers=REPLAY_TICKERS, rounds=REPLAY_ROUNDS,
         bucket=REPLAY_BUCKET, cadence_s=REPLAY_CADENCE_S,
         replay_ticks_per_s=rep["ticks_per_s"],
         replay_rows_per_s=rep["rows_per_s"],
         live_ticks_per_s=live["ticks_per_s"],
         live_rows_per_s=live["ticks_submitted"] / live["wall_s"],
         replay_over_live=rep["ticks_per_s"] / live["ticks_per_s"],
         dialect_ticks_per_s={d: runs[d][0]["ticks_per_s"]
                              for d in ("binary", "json")},
         identity=identity, hot_swap=dict(
             round=swap_at, version=swapped.get("version"), lost=lost,
             seqs_contiguous=seqs_ok, before_same=before_same,
             after_new=after_new, counters=c),
         max_abs_err_vs_cpu=err, tol=PATH_TOL,
         warehouse=dict(rows=wh_out["rows_replayed"],
                        rounds=wh_out["rounds"],
                        rows_per_s=wh_out["rows_per_s"],
                        conservation=conservation),
         flushes=flushes, launches=counts)
    check(all(identity.values()) and len(live_results) == n_ticks,
          f"{cell} replay against live: {identity}")
    check(swapped.get("version") == 1 and lost == 0 and seqs_ok
          and before_same and after_new
          and c.get("rejected_sessions", 0) == 0,
          f"{cell} hot swap: version {swapped}, lost {lost}, seqs "
          f"{seqs_ok}, before {before_same}, after {after_new}")
    check(len(cpu_results) == n_ticks and err <= PATH_TOL,
          f"{cell} replay: card and CPU disagree ({err})")
    check(conservation["captured"] == wh_out["rows_replayed"]
          == REPLAY_WAREHOUSE_ROWS
          and conservation["captured"] == conservation["joined"]
          + conservation["expired"] + conservation["shed"]
          + conservation["pending"] and conservation["joined"] > 0,
          f"{cell} warehouse replay: conservation {conservation}")
    check_launches(counts, {"ssm_tick": flushes} if cell == "ssm" else {},
                   f"{cell} replay")
    if cell != "gru":
        emit("replay done", cell=cell,
             seconds=time.perf_counter() - phase_t0)
        return counts

    emit("replay shadow", **shadow_check(wh_path, device))
    config = f"{directory}/guard.json"
    with open(config, "w") as fh:
        json.dump({"train": GUARD_TRAIN}, fh)
    start_path()
    rc, text = cli_output(["serve-fleet", "--role", "solo", "--config",
                           config, "--train-checkpoint-dir",
                           f"{directory}/guard_ckpt"] + GUARD_ARGS)
    guard_counts = launch_counts()
    out = json.loads(text) if rc == 0 else {}
    ct = out.get("continuous_train", {})
    steps = int(re.search(r"step_(\d+)", ct["checkpoints"][-1]).group(1)) \
        if ct.get("checkpoints") else 0
    emit("replay swap guard", rc=rc, rounds=ct.get("rounds"),
         swaps_accepted=ct.get("swaps_accepted"),
         swaps_refused=ct.get("swaps_refused"),
         verdicts=ct.get("swap_guard"), steps=steps,
         ticks_served=out.get("ticks_served"), launches=guard_counts)
    check(rc == 0 and ct.get("rounds") == 2
          and len(ct.get("swap_guard", [])) == 2
          and ct["swaps_accepted"] + ct["swaps_refused"] == 2,
          f"serve-fleet --swap-guard exited {rc}: {ct}")
    check_launches(guard_counts, {"gru_scan_fwd": steps,
                                  "gru_scan_bwd": steps, "scan_dw": steps},
                   "replay swap guard")
    emit("replay done", cell=cell, seconds=time.perf_counter() - phase_t0)
    return {k: counts[k] + guard_counts[k] for k in counts}


#: the remat check: bench.py's long-context training shape (T = 1024,
#: batch 16, 10 book levels a side)
REMAT_SHAPE = dict(batch=16, window=1024, levels=10)


def remat_step(cell: str, remat: bool, device: str) -> tuple:
    """One training forward and backward of a full-width model (dropout
    0) at REMAT_SHAPE: the parameter gradients, the peak of allocated
    memory (reset before) and the launches."""
    from fmda_tpu_torch.config import FeatureConfig, TrainConfig
    from fmda_tpu_torch.data.pipeline import Batch
    from fmda_tpu_torch.train import Trainer

    s = REMAT_SHAPE
    n_features = len(FeatureConfig(bid_levels=s["levels"],
                                   ask_levels=s["levels"]).x_fields())
    model_cfg = model_config(cell, n_features=n_features, dropout=0.0,
                             remat=remat)
    trainer = Trainer(model_cfg, TrainConfig(batch_size=s["batch"],
                                             window=s["window"]),
                      weight=np.full(4, 2.0, np.float32),
                      pos_weight=np.full(4, 3.0, np.float32), device=device)
    state = trainer.init_state()
    rng = np.random.default_rng(SEED)
    batch = Batch(*(torch.as_tensor(a, device=device) for a in (
        rng.normal(size=(s["batch"], s["window"], n_features)).astype(
            np.float32),
        (rng.uniform(size=(s["batch"], 4)) > 0.7).astype(np.float32),
        np.ones(s["batch"], np.float32))))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_path()
    trainer.accumulate_gradients(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = launch_counts()
    grads = {k: p.grad.detach().cpu() for k, p in
             state.model.named_parameters()}
    return grads, peak, counts


def phase_remat(device: str = "cuda"):
    """``model.remat`` on the card at REMAT_SHAPE: an attn step with remat
    and one without, the gradients within PATH_TOL and the peak of
    allocated memory lower with remat (checked); gru's two peaks (its
    kernel pair keeps only ``hs`` either way; not checked).  Returns the
    launch counts of the four steps."""
    quiet_planes()
    t0 = time.perf_counter()
    total, peaks, errs = {}, {}, {}
    for cell in ("attn", "gru"):
        runs = {}
        for remat in (False, True):
            grads, peak, counts = remat_step(cell, remat, device)
            runs[remat] = grads
            peaks[f"{cell}_{'remat' if remat else 'plain'}"] = peak
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            # attn: the forward once more under remat (the recompute), the
            # T = 1024 backward the two sweeps; gru two scans each way, the
            # kernel pair never recomputed (the CPU's plain scans are)
            if cell == "attn":
                want = {"flash_fwd": 2 if remat else 1, "flash_dkv": 1,
                        "flash_dq": 1}
            else:
                again = remat and torch.device(device).type == "cpu"
                want = {"gru_scan_fwd": 4 if again else 2,
                        "gru_scan_bwd": 2, "scan_dw": 2}
            check_launches(counts, want, f"remat {cell} {remat}")
        errs[cell] = max(float((runs[False][k] - runs[True][k]).abs().max())
                         for k in runs[False])
    emit("remat", shape=REMAT_SHAPE, peak_bytes=peaks,
         attn_saved_bytes=peaks["attn_plain"] - peaks["attn_remat"],
         grad_max_abs_err=errs, tol=PATH_TOL, launches=total,
         seconds=time.perf_counter() - t0)
    check(errs["attn"] <= PATH_TOL and errs["gru"] <= PATH_TOL,
          f"remat: gradients differ {errs}")
    check(peaks["attn_remat"] < peaks["attn_plain"],
          f"remat: attn peak {peaks['attn_remat']} not below "
          f"{peaks['attn_plain']}")
    return total


MULTIHOST_SESSIONS = 64  # a worker (weak scaling)
MULTIHOST_ROUNDS = 100
MULTIHOST_BUCKETS = (8, 32, 64)
MULTIHOST_CAPACITY = 128  # a worker
MULTIHOST_WORKERS = (1, 4)
#: router-side loss counters; each worker's inbox_records_lost rides its
#: goodbye stats
MULTIHOST_LOSSES = ("results_missing", "routed_ticks_lost",
                    "migration_buffer_shed")
#: the gru migration load (FleetLoadConfig's default: 64 sessions x 100
#: rounds), the third worker added at MIGRATION_ADD_AT
MIGRATION_ADD_AT = 50
MULTIHOST_CLI_HOLD_S = 6.0


class RecordingRouter:
    """A fleet router whose served results are kept per session, in the
    order the router hands them out; every other attribute is the
    router's."""

    def __init__(self, router):
        self.router = router
        self.results = {}

    def __getattr__(self, name):
        return getattr(self.router, name)

    def _keep(self, out):
        for res in out:
            self.results.setdefault(res.session_id, []).append(
                (res.seq, np.asarray(res.probabilities, np.float32)))
        return out

    def pump(self, **kw):
        return self._keep(self.router.pump(**kw))

    def drain(self):
        return self._keep(self.router.drain())


def multihost_config(cell: str):
    from fmda_tpu_torch.config import FrameworkConfig

    base = FrameworkConfig()
    return dataclasses.replace(
        base, model=dataclasses.replace(base.model, cell=cell),
        fleet=dataclasses.replace(base.fleet, wire_format="binary"))


def multihost_topology(cell: str, n_workers: int, device: str):
    from fmda_tpu_torch.fleet.launcher import launch_local_fleet

    return launch_local_fleet(
        n_workers=n_workers, config=multihost_config(cell), hidden=32,
        seed=SEED, capacity_per_worker=MULTIHOST_CAPACITY,
        bucket_sizes=MULTIHOST_BUCKETS, window=30,
        device=None if device == "cuda" else device)


def worker_launches(stats: dict, cell: str, what: str, device: str) -> dict:
    """Each worker's kernel launches by kernel, off its goodbye stats (the
    change in its process's counts since its warm-up), against its
    flushes: kernel 5 (``ssm_tick``) once a flush and no other kernel in
    an ssm worker on the card, no kernel at all in a gru worker (nor on
    the CPU); the gateway's per-bucket count agrees.  Returns each
    kernel's launches summed over the workers."""
    total = {}
    for wid, st in stats.items():
        by_kernel = st.get("kernel_launches", {})
        by_bucket = sum(st.get("kernel_launches_by_bucket", {}).values())
        flushes = st.get("flushes", 0)
        want = flushes if cell == "ssm" and device == "cuda" else 0
        others = {k: n for k, n in by_kernel.items()
                  if k != "ssm_tick" and n}
        check("ssm_tick" in by_kernel and by_kernel["ssm_tick"] == want
              and by_bucket == want and not others
              and (cell != "ssm" or flushes > 0),
              f"{what}: worker {wid} launched {by_kernel} (by bucket "
              f"{by_bucket}) over {flushes} flushes, expected ssm_tick "
              f"{want} and no other kernel")
        total = add_counts(total, by_kernel)
    return total


def add_counts(a: dict, b: dict) -> dict:
    """Two kernel -> launches maps, added."""
    return {k: a.get(k, 0) + b.get(k, 0) for k in sorted(set(a) | set(b))}


def multihost_losses(out: dict, stats: dict) -> dict:
    counters = out.get("counters", {})
    losses = {k: counters.get(k, 0) for k in MULTIHOST_LOSSES}
    losses.update({f"{w}.inbox_records_lost": s.get("inbox_records_lost", 0)
                   for w, s in stats.items()})
    return losses


def multihost_weak_scaling(device: str) -> tuple:
    """ssm at 1 and 4 worker processes, MULTIHOST_SESSIONS a worker:
    every tick served, no loss counted, kernel 5 once a flush in each
    worker.  Returns (the workers' launches by kernel, the lines'
    numbers)."""
    from fmda_tpu_torch.runtime.loadgen import (
        FleetLoadConfig,
        run_fleet_load,
    )

    launches, per = {}, {}
    for n in MULTIHOST_WORKERS:
        t0 = time.perf_counter()
        topo = multihost_topology("ssm", n, device)
        started_s = time.perf_counter() - t0
        try:
            out = run_fleet_load(topo.router, FleetLoadConfig(
                n_sessions=MULTIHOST_SESSIONS * n, n_ticks=MULTIHOST_ROUNDS,
                seed=SEED))
        finally:
            stats = topo.shutdown()
        losses = multihost_losses(out, stats)
        lat = out["latency"]
        per[n] = out["ticks_per_s"]
        n_launched = worker_launches(stats, "ssm", f"multihost ssm {n}w",
                                     device)
        launches = add_counts(launches, n_launched)
        emit("multihost ssm", workers=n, bus=type(topo.bus).__name__,
             sessions=out["sessions"], rounds=out["rounds"],
             ticks_submitted=out["ticks_submitted"],
             ticks_served=out["ticks_served"], ticks_per_s=out["ticks_per_s"],
             route_p50_ms=lat.get("route", {}).get("p50_ms"),
             total_p50_ms=lat.get("total", {}).get("p50_ms"),
             total_p99_ms=lat.get("total", {}).get("p99_ms"),
             losses=losses, ssm_tick_launches=n_launched["ssm_tick"],
             kernel_launches={w: s.get("kernel_launches")
                              for w, s in stats.items()},
             worker_flushes={w: s.get("flushes") for w, s in stats.items()},
             kernel_launches_by_bucket={
                 w: s.get("kernel_launches_by_bucket")
                 for w, s in stats.items()},
             start_s=started_s, seconds=time.perf_counter() - t0)
        check(out["ticks_served"] == out["ticks_submitted"]
              and sum(s.get("ticks_served", 0) for s in stats.values())
              == out["ticks_submitted"],
              f"multihost ssm {n}w: served {out['ticks_served']} of "
              f"{out['ticks_submitted']}")
        check(not any(losses.values()), f"multihost ssm {n}w: {losses}")
    return launches, {"ticks_per_s": per, "ratio_4_to_1":
                      per[4] / per[1] if per[1] else None}


def multihost_migration(device: str) -> dict:
    """gru: 2 workers under the default load, a third added mid-load by
    ``add_worker()``; every session's published seqs 0..99 in order (no
    drop, duplicate or reorder), no state lost, and the probabilities
    against an unmigrated 1-worker run of the same load."""
    from fmda_tpu_torch.runtime.loadgen import (
        FleetLoadConfig,
        run_fleet_load,
    )

    load = FleetLoadConfig(seed=SEED)
    runs = {}
    for n, grow in ((1, False), (2, True)):
        t0 = time.perf_counter()
        topo = multihost_topology("gru", n, device)
        router = RecordingRouter(topo.router)
        added = []

        def on_round(r, topo=topo, router=router, added=added, grow=grow):
            if not (grow and r + 1 == MIGRATION_ADD_AT):
                return
            # the new worker process boots for seconds: the load waits
            # for its hello (serving on), then the rest of the load runs
            # through the rebalance it starts
            added.append(topo.add_worker())
            deadline = time.monotonic() + 180.0
            while (added[-1] not in topo.router.membership.live()
                   and time.monotonic() < deadline):
                router.pump()
                time.sleep(0.005)

        try:
            out = run_fleet_load(router, load, on_round=on_round)
            # before the shutdown, whose goodbyes move sessions again
            counters = dict(topo.router.metrics.counters)
        finally:
            stats = topo.shutdown()
        worker_launches(stats, "gru", f"multihost gru {n}w", device)
        runs[n] = (router.results, counters, stats,
                   time.perf_counter() - t0, added)
    ref, _, _, _, _ = runs[1]
    got, counters, stats, seconds, added = runs[2]
    in_order = all([s for s, _ in got.get(sid, [])]
                   == list(range(load.n_ticks)) for sid in ref)
    migrated = counters.get("migrations_completed", 0)
    diffs = [float(np.abs(a - b).max()) for sid in ref
             for (_, a), (_, b) in zip(got[sid], ref[sid])]
    err = max(diffs) if diffs else None
    emit("multihost gru migration", workers=f"2 + {added}",
         sessions=load.n_sessions, rounds=load.n_ticks,
         migrations_completed=migrated,
         migration_replayed_ticks=counters.get("migration_replayed_ticks",
                                               0),
         sessions_lost_state=counters.get("sessions_lost_state", 0),
         seqs_in_order=in_order,
         bit_identical_to_unmigrated=err == 0.0,
         max_abs_diff_vs_unmigrated=err, tol=PATH_TOL,
         worker_sessions={w: s.get("active_sessions")
                          for w, s in stats.items()},
         seconds=seconds)
    check(added and added[0] and migrated > 0,
          f"multihost gru: the added worker moved nothing ({counters})")
    check(in_order, "multihost gru: a session's published seqs dropped, "
          "duplicated or reordered across the migration")
    check(counters.get("sessions_lost_state", 0) == 0,
          "multihost gru: sessions lost state")
    check(err is not None and err <= PATH_TOL,
          f"multihost gru: migrated run differs from the unmigrated one by "
          f"{err}")
    return {"migrations": migrated, "max_abs_diff": err}


def multihost_cli(directory: str, device: str) -> int:
    """``serve-fleet --role local`` once, in a subprocess, 2 ssm workers:
    exit 0, every tick served, a trace file a process stitched by ``trace
    --merge``, and ``status --endpoint`` answering off the router's
    telemetry server while the run holds it.  Returns its workers'
    launches by kernel."""
    import socket

    trace_dir = os.path.join(directory, "multihost_traces")
    pm_dir = os.path.join(directory, "multihost_postmortem")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = [sys.executable, "-m", "fmda_tpu_torch", "serve-fleet",
            "--role", "local", "--workers", "2", "--cell", "ssm",
            "--no-controller", "--postmortem-dir", pm_dir,
            "--trace-dir", trace_dir, "--metrics-port", str(port),
            "--metrics-hold-s", str(MULTIHOST_CLI_HOLD_S)]
    if device != "cuda":
        argv += ["--device", device]
    err_path = os.path.join(directory, "multihost_cli.err")
    t0 = time.perf_counter()
    with open(err_path, "w") as err_fh:
        proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=err_fh,
                                text=True, cwd=os.path.dirname(
                                    os.path.abspath(__file__)))
    try:
        status = None
        deadline = time.monotonic() + 300.0
        while time.monotonic() < deadline and proc.poll() is None:
            with open(err_path) as fh:
                if "holding fleet telemetry endpoint" in fh.read():
                    status = cli_output(["status", "--endpoint",
                                         f"127.0.0.1:{port}"])
                    break
            time.sleep(0.2)
        stdout, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(err_path) as fh:
        err_tail = fh.read()[-3000:]
    check(proc.returncode == 0,
          f"serve-fleet --role local exited {proc.returncode}: {err_tail}")
    out = json.loads(stdout)
    merged = os.path.join(directory, "multihost_merged.json")
    merge_rc, _ = cli_output(["trace", "--merge", trace_dir, "--out",
                              merged])
    by_trace = {}
    with open(merged) as fh:
        for ev in json.load(fh)["traceEvents"]:
            if ev.get("ph") == "X":
                by_trace.setdefault(ev["args"]["trace_id"], set()).add(
                    ev["name"])
    stitched = sum({"tick", "route", "serve"} <= names
                   for names in by_trace.values())
    launched = worker_launches(out["worker_stats"], "ssm",
                               "multihost cli", device)
    emit("multihost cli", argv=argv[3:], rc=proc.returncode,
         ticks_submitted=out["ticks_submitted"],
         ticks_served=out["ticks_served"], ticks_per_s=out["ticks_per_s"],
         trace_files=sorted(os.listdir(trace_dir)), merge_rc=merge_rc,
         stitched_traces=stitched,
         status_rc=None if status is None else status[0],
         status_head=None if status is None else status[1][:200],
         alerts=out.get("alerts"), ssm_tick_launches=launched["ssm_tick"],
         seconds=time.perf_counter() - t0)
    check(out["ticks_served"] == out["ticks_submitted"],
          f"multihost cli: served {out['ticks_served']} of "
          f"{out['ticks_submitted']}")
    check(sorted(os.listdir(trace_dir)) == ["router.json", "w0.json",
                                            "w1.json"]
          and merge_rc == 0 and stitched > 0,
          f"multihost cli: traces {os.listdir(trace_dir)} merge rc "
          f"{merge_rc}, {stitched} stitched")
    check(status is not None and status[0] in (0, 1)
          and status[1].startswith("status: "),
          f"multihost cli: status --endpoint did not answer: {status}")
    return launched


def phase_multihost(directory: str, device: str = "cuda") -> dict:
    """The multi-process fleet on one card (one CUDA context a worker
    process): ssm weak scaling at 1 and 4 workers, gru live migration to
    an added worker, and the ``--role local`` CLI.  The smoke's own
    process is the router and launches nothing (checked); the kernels'
    launches are the workers' own, by kernel, off their goodbye stats.
    Returns the path's launch counts."""
    quiet_planes()
    t0 = time.perf_counter()
    start_path()
    workers, scaling = multihost_weak_scaling(device)
    migration = multihost_migration(device)
    workers = add_counts(workers, multihost_cli(directory, device))
    here = launch_counts()
    check_launches(here, {}, "multihost (the router's own process)")
    emit("multihost", kernel_launches_in_workers=workers,
         ticks_per_s_by_workers=scaling["ticks_per_s"],
         ratio_4_to_1=scaling["ratio_4_to_1"],
         migration=migration, cpu_count=os.cpu_count(),
         seconds=time.perf_counter() - t0,
         total_elapsed_s=time.perf_counter() - START)
    return workers


#: the control phase's capacity model, the reference bench's shape
#: (``bench.py`` phase ``control_capacity_model``): ssm, buckets 8/32,
#: linger 2 ms, SLO 50 ms, seed 0, sessions x duty, 60 rounds a cell
CAPACITY_BUCKETS = (8, 32)
CAPACITY_LINGER_MS = 2.0
CAPACITY_SLO_MS = 50.0
CAPACITY_SESSIONS = (8, 16, 32)
CAPACITY_DUTY = (0.25, 0.5, 1.0)
CAPACITY_ROUNDS = 60
#: the reference's artifact vocabulary (``fmda_tpu/control/capacity.py``),
#: kept here as literals: the port's constants must equal them
CAPACITY_REF_SCHEMA = "fmda.control.capacity/1"
CAPACITY_REF_KEYS = ("schema", "slo_p99_ms", "rounds", "grid",
                     "max_sustainable", "controller_ab")
CAPACITY_REF_CELL_KEYS = ("sessions", "duty", "submitted", "served", "shed",
                          "p99_ms", "ticks_per_s", "ok")
#: per-tenant QoS through the CLI: two classes, the telemetry and control
#: cadences short enough for the loop to decide inside the load
QOS_MIX = "gold:1,standard:4"
QOS_CONFIG = {
    "control": {"tenant_classes": ["gold", "standard"],
                "tenant_weights": [3.0, 1.0],
                "tenant_quota_frac": [1.0, 0.5], "interval_s": 0.1},
    "slo": {"interval_s": 0.1},
}
QOS_TICKS = 300
QOS_HOLD_S = 4.0
#: the elastic soak at full width, everything else the reference's default
ELASTIC_SESSIONS = 8
#: the elastic soak's retire threshold here (the reference's default is
#: 0.5): the autoscaler retires the spike's worker once the fast window's
#: p99 stays under this share of the calibrated target.  That p99 is the
#: worst of ~100 cool-down ticks in a 2 s window on a host the workers, the
#: router and the caller share; at 0.5 the retire waited 27-125 s after
#: the scale-up for 4 s without one slow tick (one NVIDIA H100 80GB HBM3 at
#: 700.00 W, 8 host cores).  0.75 still lies far under the spike's p99 (8x
#: the target and more).  The fixed run replays the schedule unpaced.
ELASTIC_SCALE_DOWN_FRAC = 0.75
#: the fleet soak's plan (the reference bench's ``runtime_chaos_soak``)
CHAOS_PLAN_KW = dict(workers=["w0", "w1"], worker_kills=1, revive_after=10,
                     router_restarts=1, link_partitions=1, bus_blips=1,
                     delays=2, delay_s=0.02, settle_steps=12)
CHAOS_STEPS = 60
CHAOS_SESSIONS = 12
#: the pipeline soak (the reference bench's ``pipeline_chaos_soak``)
PIPELINE_CHAOS_ROUNDS = 30


def bucket_one_launches(stats: dict, what: str, device: str) -> dict:
    """A soak's workers at bucket 1: kernel 5 once a flush, every launch
    at bucket 1 (the warm-up's buckets), no other kernel
    (:func:`worker_launches`).  Returns the launches by kernel."""
    for wid, st in stats.items():
        buckets = set(st.get("kernel_launches_by_bucket", {}))
        check(buckets <= {"1"},
              f"{what}: worker {wid} launched at buckets {sorted(buckets)}")
    return worker_launches(stats, "ssm", what, device)


def control_capacity(device: str) -> dict:
    """(a) ``run_capacity_model`` over real ssm pools on the card: the
    reference's schema and keys, served + shed = submitted in every cell,
    kernel 5 once a gateway flush (plus each pool's warm-up, one a
    bucket), every other kernel 0.  Returns this process's launches."""
    from fmda_tpu_torch.control.capacity import (
        CAPACITY_KEYS,
        CAPACITY_SCHEMA,
        CELL_KEYS,
        pool_gateway_factory,
        run_capacity_model,
    )

    from fmda_tpu_torch.models import build_model

    cfg = model_config("ssm", bidirectional=False, dropout=0.0)
    state = build_model(
        cfg, generator=torch.Generator().manual_seed(SEED)).state_dict()
    pools, gateways = [], []
    factory = pool_gateway_factory(
        cfg, state, window=30, bucket_sizes=CAPACITY_BUCKETS,
        max_linger_ms=CAPACITY_LINGER_MS, device=device, pools=pools)

    def recorded(n_sessions):
        gateways.append(factory(n_sessions))
        return gateways[-1]

    start_path()
    t0 = time.perf_counter()
    artifact = run_capacity_model(
        recorded, slo_p99_ms=CAPACITY_SLO_MS,
        session_grid=CAPACITY_SESSIONS, duty_grid=CAPACITY_DUTY,
        rounds=CAPACITY_ROUNDS, seed=SEED)
    seconds = time.perf_counter() - t0
    launched = launch_counts()
    flushes = sum(g.metrics.counters.get("flushes", 0) for g in gateways)
    by_bucket = sum(sum(g.kernel_launches_by_bucket.values())
                    for g in gateways)
    warmups = len(pools) * len(CAPACITY_BUCKETS)
    on_card = device == "cuda"
    check_launches(launched, {"ssm_tick": flushes + warmups if on_card
                              else 0}, "control capacity")
    check(by_bucket == (flushes if on_card else 0),
          f"control capacity: gateways booked {by_bucket} launches by "
          f"bucket over {flushes} flushes")
    leaks = [c for c in artifact["grid"]
             if c["served"] + c["shed"] != c["submitted"]]
    ab = artifact["controller_ab"] or {}
    try:
        load1 = os.getloadavg()[0]
    except OSError:
        load1 = None
    emit("control capacity", cell="ssm", buckets=list(CAPACITY_BUCKETS),
         slo_p99_ms=CAPACITY_SLO_MS, rounds=CAPACITY_ROUNDS,
         grid=[{k: c[k] for k in ("sessions", "duty", "submitted", "served",
                                  "shed", "p99_ms", "ticks_per_s", "ok")}
               for c in artifact["grid"]],
         max_sustainable=artifact["max_sustainable"],
         ab_fixed_p99_ms=ab.get("fixed_p99_ms"),
         ab_adaptive_p99_ms=ab.get("adaptive_p99_ms"),
         ab_improved=ab.get("improved"), ab_decisions=ab.get("decisions"),
         ab_converged=ab.get("converged"), load1=load1,
         cpu_count=os.cpu_count(), gateways=len(gateways), flushes=flushes,
         ssm_tick_launches=launched.get("ssm_tick", 0), seconds=seconds)
    check(artifact["schema"] == CAPACITY_SCHEMA == CAPACITY_REF_SCHEMA
          and tuple(artifact) == CAPACITY_KEYS == CAPACITY_REF_KEYS
          and CELL_KEYS == CAPACITY_REF_CELL_KEYS
          and all(tuple(c) == CAPACITY_REF_CELL_KEYS
                  for c in artifact["grid"]),
          f"control capacity: artifact keys {tuple(artifact)}")
    check(not leaks, f"control capacity: ticks leaked in {leaks}")
    check(len(artifact["grid"]) == len(CAPACITY_SESSIONS)
          * len(CAPACITY_DUTY) and ab.get("fixed_p99_ms") is not None,
          f"control capacity: grid {len(artifact['grid'])} cells, A/B {ab}")
    return launched


def control_qos_cli(directory: str, device: str) -> dict:
    """(b) ``serve-fleet --role local --workers 2 --cell ssm --tenant-mix
    gold:1,standard:4`` with the controller (the default) and QoS_CONFIG,
    in a subprocess: exit 0, every tick accounted for, per-class admits
    and sheds folded off the heartbeats, a non-empty decision ring, and
    ``status --endpoint`` printing the control section off its telemetry
    server.  Returns the workers' launches by kernel."""
    import socket

    cfg_path = os.path.join(directory, "qos.json")
    with open(cfg_path, "w") as fh:
        json.dump(QOS_CONFIG, fh)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = [sys.executable, "-m", "fmda_tpu_torch", "serve-fleet",
            "--role", "local", "--workers", "2", "--cell", "ssm",
            "--tenant-mix", QOS_MIX, "--config", cfg_path,
            "--ticks", str(QOS_TICKS), "--metrics-port", str(port),
            "--metrics-hold-s", str(QOS_HOLD_S)]
    if device != "cuda":
        argv += ["--device", device]
    err_path = os.path.join(directory, "control_qos.err")
    t0 = time.perf_counter()
    with open(err_path, "w") as err_fh:
        proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=err_fh,
                                text=True, cwd=os.path.dirname(
                                    os.path.abspath(__file__)))
    try:
        status = None
        deadline = time.monotonic() + 300.0
        while time.monotonic() < deadline and proc.poll() is None:
            with open(err_path) as fh:
                if "holding fleet telemetry endpoint" in fh.read():
                    status = cli_output(["status", "--endpoint",
                                         f"127.0.0.1:{port}"])
                    break
            time.sleep(0.2)
        stdout, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(err_path) as fh:
        err_tail = fh.read()[-3000:]
    check(proc.returncode == 0,
          f"serve-fleet --tenant-mix exited {proc.returncode}: {err_tail}")
    out = json.loads(stdout)
    control = out.get("control", {})
    tenants = control.get("tenants", {})
    admitted = {k: v for k, v in tenants.items()
                if k.startswith("admitted_class_")}
    shed = {k: v for k, v in tenants.items() if k.startswith("shed_class_")}
    from fmda_tpu_torch.chaos.soak import LOSS_COUNTERS

    counters = out.get("counters", {})
    losses = {k: counters.get(k, 0)
              for k in sorted(set(MULTIHOST_LOSSES) | set(LOSS_COUNTERS))}
    worker_served = sum(s.get("ticks_served", 0)
                        for s in out["worker_stats"].values())
    launched = worker_launches(out["worker_stats"], "ssm", "control qos",
                               device)
    emit("control qos", argv=argv[3:], rc=proc.returncode,
         ticks_submitted=out["ticks_submitted"],
         ticks_served=out["ticks_served"], ticks_per_s=out["ticks_per_s"],
         tenants=tenants, submitted_by_class=out.get("submitted_by_class"),
         losses=losses, decisions=len(control.get("decisions", [])),
         last_decisions=control.get("decisions", [])[-3:],
         batching=control.get("batching"),
         autoscale=control.get("autoscale"),
         status_rc=None if status is None else status[0],
         status_control=None if status is None else [
             ln for ln in status[1].splitlines()
             if ln.startswith("control:")],
         ssm_tick_launches=launched["ssm_tick"],
         seconds=time.perf_counter() - t0)
    check(set(admitted) == {"admitted_class_gold", "admitted_class_standard"}
          and all(admitted.values()),
          f"control qos: per-class admits {tenants}")
    check(out["ticks_served"] + sum(losses.values())
          == out["ticks_submitted"]
          and sum(admitted.values()) - sum(shed.values()) == worker_served,
          f"control qos: {out['ticks_served']} served + {losses} of "
          f"{out['ticks_submitted']}; admitted {admitted}, shed {shed}, "
          f"workers served {worker_served}")
    check(control.get("decisions"),
          f"control qos: empty decision ring ({control})")
    check(status is not None and status[0] in (0, 1)
          and any(ln.startswith("control: target p99")
                  for ln in status[1].splitlines()),
          f"control qos: status --endpoint printed no control section: "
          f"{status}")
    return launched


def control_elastic(device: str) -> dict:
    """(c) ``run_elastic_soak`` at ssm, H 32, window 30, 1..2 workers, 8
    sessions, compared with the fixed fleet: every gate (scaled up and
    down, no session lost, all served after, bit-identical), kernel 5
    once a flush at bucket 1 in every worker.  Returns the workers'
    launches by kernel."""
    from fmda_tpu_torch.control import run_elastic_soak

    t0 = time.perf_counter()
    report = run_elastic_soak(
        n_sessions=ELASTIC_SESSIONS, hidden=32, window=30, min_workers=1,
        max_workers=2, compare_fixed=True, config=multihost_config("ssm"),
        device=None if device == "cuda" else device,
        scale_down_frac=ELASTIC_SCALE_DOWN_FRAC, pace_fixed=False)
    launched = bucket_one_launches(report["worker_stats"], "control elastic",
                                   device)
    emit("control elastic", cell="ssm", sessions=ELASTIC_SESSIONS,
         scale_down_frac=ELASTIC_SCALE_DOWN_FRAC,
         pace_fixed=False,
         gates=report["gates"], schedule=report["schedule"],
         target_p99_ms=report["target_p99_ms"],
         ticks_submitted=report["ticks_submitted"],
         ticks_served=report["ticks_served"], losses=report["losses"],
         max_live=report["max_live"], final_live=report["final_live"],
         decisions=report["decisions"], identity=report.get("identity"),
         kernel_launches={w: s.get("kernel_launches")
                          for w, s in report["worker_stats"].items()},
         worker_flushes={w: s.get("flushes")
                         for w, s in report["worker_stats"].items()},
         ssm_tick_launches=launched["ssm_tick"], cpu_count=os.cpu_count(),
         seconds=time.perf_counter() - t0)
    check(report["gates_ok"] and report["identity"]["ok"],
          f"control elastic: gates {report['gates']}")
    return launched


def phase_control(directory: str, device: str = "cuda") -> dict:
    """The control plane on the card: the capacity model over real pools,
    per-tenant QoS through the CLI with the controller attached, and the
    elastic soak.  Returns the path's launches by kernel (this process's
    and the workers')."""
    from fmda_tpu_torch.chaos import configure_chaos

    quiet_planes()
    t0 = time.perf_counter()
    try:
        here = control_capacity(device)
        start_path()
        workers = add_counts(control_qos_cli(directory, device),
                             control_elastic(device))
        check_launches(launch_counts(), {},
                       "control (the router's own process)")
    finally:
        configure_chaos(enabled=False)
    total = add_counts(here, workers)
    emit("control", kernel_launches=total,
         seconds=time.perf_counter() - t0,
         total_elapsed_s=time.perf_counter() - START)
    return total


def chaos_fleet(device: str) -> dict:
    """(d) ``run_chaos_soak`` under the reference bench's plan (a worker
    killed and revived, a router takeover, a link partition, a bus blip,
    delays) at ssm, H 32, window 30, 12 sessions, against the unfaulted
    run: every gate, nothing unaccounted, the clean sessions bit for bit,
    kernel 5 once a flush at bucket 1 in every worker.  Returns the
    workers' launches by kernel."""
    from fmda_tpu_torch.chaos import FaultPlan, run_chaos_soak

    plan = FaultPlan.generate(SEED, CHAOS_STEPS, **CHAOS_PLAN_KW)
    t0 = time.perf_counter()
    report = run_chaos_soak(
        plan, n_workers=2, n_sessions=CHAOS_SESSIONS, hidden=32, window=30,
        compare_unfaulted=True, config=multihost_config("ssm"),
        device=None if device == "cuda" else device)
    launched = bucket_one_launches(report["worker_stats"], "chaos fleet",
                                   device)
    emit("chaos fleet", cell="ssm", sessions=CHAOS_SESSIONS,
         plan=report["plan"], chaos_injected=report["chaos_injected"],
         gates=report["gates"], ticks_submitted=report["ticks_submitted"],
         ticks_served=report["ticks_served"], losses=report["losses"],
         unaccounted=report["unaccounted"], identity=report["identity"],
         recovery=report["recovery"], takeovers=report["takeovers"],
         tainted=report["tainted_sessions"],
         kernel_launches={w: s.get("kernel_launches")
                          for w, s in report["worker_stats"].items()},
         worker_flushes={w: s.get("flushes")
                         for w, s in report["worker_stats"].items()},
         ssm_tick_launches=launched["ssm_tick"],
         seconds=time.perf_counter() - t0)
    check(report["gates_ok"] and report["unaccounted"] == 0
          and report["identity"]["ok"]
          and report["identity"]["clean_sessions"] > 0,
          f"chaos fleet: gates {report['gates']}, unaccounted "
          f"{report['unaccounted']}, identity {report['identity']}")
    return launched


def pipeline_soak_recorded(device, *, compare_unfaulted: bool) -> tuple:
    """``run_pipeline_soak`` at the reference bench's shape with the
    Predictor (gru, H 32, window 30) on ``device``, every prediction it
    served recorded: (report, {timestamp: probabilities}, predictions)."""
    from fmda_tpu_torch.chaos import pipeline

    served, made = {}, []
    build = pipeline._build_predictor

    def recording(*args, **kw):
        pred = build(*args, **kw)
        poll = pred.poll

        def recorded():
            out = poll()
            made.extend(out)
            served.update({p.timestamp: np.asarray(p.probabilities,
                                                   np.float64)
                           for p in out})
            return out

        pred.poll = recorded
        return pred

    pipeline._build_predictor = recording
    try:
        report = pipeline.run_pipeline_soak(
            pipeline.generate_pipeline_plan(SEED, PIPELINE_CHAOS_ROUNDS),
            seed=SEED, rounds=PIPELINE_CHAOS_ROUNDS, predictor=True,
            window=30, hidden=32, compare_unfaulted=compare_unfaulted,
            device=device)
    finally:
        pipeline._build_predictor = build
    return report, served, len(made)


def chaos_pipeline(device: str) -> dict:
    """(e) ``run_pipeline_soak`` (``generate_pipeline_plan(0, 30)``, the
    Predictor a gru at H 32, window 30 on the card, the unfaulted replay):
    every gate, the landed rows bit for bit (``identity_ok``), kernel 1
    twice a prediction served and no other kernel, the probabilities
    against the same soak with the Predictor on the CPU; then
    ``chaos-pipeline --rounds 30`` exits 0.  Returns the soak's
    launches."""
    t0 = time.perf_counter()
    start_path()
    report, served, n_made = pipeline_soak_recorded(
        device, compare_unfaulted=True)
    launched = launch_counts()
    seconds = time.perf_counter() - t0
    check_launches(launched, {"gru_scan_fwd": 2 * n_made
                              if device == "cuda" else 0}, "chaos pipeline")
    _, served_cpu, _ = pipeline_soak_recorded("cpu", compare_unfaulted=False)
    diffs = [float(np.abs(served[ts] - served_cpu[ts]).max())
             for ts in served if ts in served_cpu]
    err = max(diffs) if diffs else None
    t_cli = time.perf_counter()
    rc, text = cli_output(["chaos-pipeline", "--rounds",
                           str(PIPELINE_CHAOS_ROUNDS)]
                          + ([] if device == "cuda" else ["--device", device]))
    cli_seconds = time.perf_counter() - t_cli
    emit("chaos pipeline", cell="gru", rounds=PIPELINE_CHAOS_ROUNDS,
         plan=report["plan"], chaos_injected=report["chaos_injected"],
         gates=report["gates"], ingested=report["ingested"],
         landed=report["landed"], losses=report["losses"],
         degraded_rows=report["degraded_rows"], journal=report["journal"],
         engine_restarts=report["engine_restarts"],
         identity=report.get("identity"), predictions=n_made,
         served=report["served"], gru_scan_fwd_launches=launched.get(
             "gru_scan_fwd", 0),
         max_abs_err_vs_cpu=err, compared=len(diffs), tol=PATH_TOL,
         seconds=seconds, cli_rc=rc, cli_gates_ok=json.loads(text).get(
             "gates_ok") if rc in (0, 1) else None,
         cli_seconds=cli_seconds)
    check(report["gates_ok"] and report["identity"]["ok"]
          and report["gates"]["post_chaos_probes_served"],
          f"chaos pipeline: gates {report['gates']}")
    check(n_made > 0 and err is not None and err <= PATH_TOL
          and len(diffs) == len(served) == len(served_cpu),
          f"chaos pipeline: {len(diffs)} of {len(served)} predictions "
          f"against the CPU's {len(served_cpu)}, max diff {err}")
    check(rc == 0, f"chaos-pipeline --rounds {PIPELINE_CHAOS_ROUNDS} "
          f"exited {rc}")
    return launched


def phase_chaos(device: str = "cuda") -> dict:
    """The chaos soaks on the card: the fleet soak (multi-process, ssm)
    and the data-plane soak (engine, journal, Predictor).  The smoke's own
    process launches nothing in the fleet soak (checked).  Returns the
    path's launches by kernel."""
    from fmda_tpu_torch.chaos import configure_chaos

    quiet_planes()
    t0 = time.perf_counter()
    try:
        start_path()
        workers = chaos_fleet(device)
        check_launches(launch_counts(), {},
                       "chaos fleet (the router's own process)")
        total = add_counts(workers, chaos_pipeline(device))
    finally:
        configure_chaos(enabled=False)
    emit("chaos", kernel_launches=total, seconds=time.perf_counter() - t0,
         total_elapsed_s=time.perf_counter() - START)
    return total


#: phase 21's sequence-parallel cell, the reference bench's
#: ``phase_longctx_sp`` (``bench.py:1271-1345``) at its own shapes: a
#: (dp, sp) world of rank processes on the one card, B = 64, T = 1024, 10
#: book levels a side (F = 120), H = 32, bidirectional, 1 layer, dropout
#: 0, remat; weighted BCE, clip 50, Adam 1e-3; each M a warm-up step and
#: PAR_STEPS timed ones
PAR_DP, PAR_SP = 2, 4
PAR_BATCH, PAR_SEQ, PAR_LEVELS = 64, 1024, 10
PAR_MICROBATCHES = (1, 2, 4)
PAR_STEPS = 4
#: the causal ring's smaller depth: (B, N, T, D) over the same mesh
PAR_CAUSAL = (4, 4, 256, 8)
#: the dp world's ranks (two of the sp world's processes)
PAR_DP_WORLD = 2
#: a world's own limit (s): ranks start, load the library, run, end
PAR_WORLD_TIMEOUT = 240
PARALLEL_RANK_ARG = "--parallel-rank"


def par_config(cell: str):
    """The sp cell's model: the bench's longctx shape, ``cell`` gru or
    attn (4 heads of 8)."""
    from fmda_tpu_torch.config import FeatureConfig

    features = len(FeatureConfig(bid_levels=PAR_LEVELS,
                                 ask_levels=PAR_LEVELS).x_fields())
    return model_config(cell, n_features=features, dropout=0.0,
                        spatial_dropout=False, remat=True)


def par_spec(device: str) -> dict:
    """The sp world's shapes and device, as its job file hands them to the
    rank processes (a CPU rehearsal cuts them in the parent)."""
    return dict(kind="sp", device=device, batch=PAR_BATCH, seq=PAR_SEQ,
                steps=PAR_STEPS, micro=list(PAR_MICROBATCHES),
                causal=list(PAR_CAUSAL))


def par_inputs(spec: dict, n_features: int):
    """The sp cell's global batch, from SEED: (x (B, T, F), y (B, C))."""
    r = np.random.default_rng(SEED)
    x = r.normal(size=(spec["batch"], spec["seq"], n_features)).astype(
        np.float32)
    y = (r.uniform(size=(spec["batch"], 4)) > 0.7).astype(np.float32)
    return x, y


def par_causal_inputs(spec: dict):
    r = np.random.default_rng(SEED + 1)
    return [r.normal(size=spec["causal"]).astype(np.float32)
            for _ in "qkvg"]


def par_sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def par_model(cfg, device):
    from fmda_tpu_torch.models import build_model

    return build_model(cfg, generator=torch.Generator().manual_seed(
        SEED)).to(device)


def par_state(model) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in
            model.state_dict().items()}


def sp_rank_run(mesh, spec: dict, cfg, n_microbatches: int,
                inputs) -> dict:
    """One rank's gradient of the initial params (``make_sp_grad_fn``, the
    step's own, summed over the world, before the clip), then its warm-up
    and ``spec["steps"]`` timed steps of the sp train step on its block of
    ``inputs`` (the global (x, y)): its losses, mean step ms, gradient,
    final params and launches."""
    import torch.distributed as dist

    from fmda_tpu_torch.parallel import (
        ClippedAdam, make_sp_grad_fn, make_sp_train_step, shard_train_inputs)

    x, y, _ = shard_train_inputs(mesh, *inputs, {})
    model = par_model(cfg, mesh.device)
    opt = ClippedAdam(1e-3, 50.0)
    state = opt.init(model)
    grad_fn = make_sp_grad_fn(mesh, cfg, spec["seq"],
                              n_microbatches=n_microbatches)
    step = make_sp_train_step(mesh, cfg, spec["seq"], opt,
                              n_microbatches=n_microbatches)
    start_path()
    grad_fn(model, x, y)
    grads = {k: p.grad.cpu().numpy() for k, p in model.named_parameters()}
    losses = [step(model, state, x, y)]
    dist.barrier()
    par_sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(spec["steps"]):
        losses.append(step(model, state, x, y))
    par_sync(mesh.device)
    step_ms = (time.perf_counter() - t0) * 1e3 / spec["steps"]
    return dict(losses=[float(v) for v in losses], step_ms=step_ms,
                launches=launch_counts(), params=par_state(model),
                grads=grads)


def sp_rank_causal(mesh, spec: dict) -> dict:
    """The causal ring at the smaller depth: this rank's output block and
    its blocks' gradients, and the launches (a future block none)."""
    from fmda_tpu_torch.parallel import make_ring_attention
    from fmda_tpu_torch.parallel.collectives import wait_sends

    q, k, v, g = (torch.from_numpy(a).to(mesh.device)
                  for a in par_causal_inputs(spec))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    fn = make_ring_attention(mesh, causal=True)
    start_path()
    out = fn(q, k, v)
    b, _, t, _ = spec["causal"]
    d, s = mesh.coords
    rows = slice(d * b // PAR_DP, (d + 1) * b // PAR_DP)
    cols = slice(s * t // PAR_SP, (s + 1) * t // PAR_SP)
    (out * g[rows, :, cols]).sum().backward()
    wait_sends()
    par_sync(mesh.device)
    return dict(launches=launch_counts(), out=out.detach().cpu().numpy(),
                grads=[x.grad.cpu().numpy() for x in (q, k, v)])


def dp_rank_run(mesh, job: dict, batches, weights) -> dict:
    """A dp Trainer's steps over ``batches`` (global host batches): the
    global losses, final params and launches."""
    from fmda_tpu_torch.config import TrainConfig
    from fmda_tpu_torch.train import Trainer

    trainer = Trainer(model_config("gru", dropout=0.0),
                      TrainConfig(**job["train_cfg"]), weight=weights[0],
                      pos_weight=weights[1], mesh=mesh)
    state = trainer.init_state()
    start_path()
    losses = [trainer.train_step(state, trainer.place(b))[0]
              for b in batches]
    par_sync(mesh.device)
    return dict(losses=[float(v) for v in losses],
                launches=launch_counts(), params=par_state(state.model))


def parallel_rank(rank: int, world: int, store: str, job_path: str) -> int:
    """A rank process of phase 21: joins the 8-rank world, loads the
    library the ``build`` phase built (building nothing), runs the sp
    steps; then the world ends, and ranks 0 and 1 join a world of 2 of
    their own for the dp steps.  Writes its results beside the job
    file."""
    import torch.distributed as dist

    from fmda_tpu_torch.config import MeshConfig
    from fmda_tpu_torch.data.pipeline import Batch
    from fmda_tpu_torch.ops import _cuda_lib
    from fmda_tpu_torch.parallel import build_mesh, initialize

    with open(job_path) as fh:
        job = json.load(fh)
    device = job["device"]
    check(device != "cuda" or _cuda_lib.library_path().exists(),
          "a rank process would build the kernels: the build phase's "
          "library is missing")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    initialize(store, world, rank, device=device)
    mesh = build_mesh(MeshConfig(dp=PAR_DP, sp=PAR_SP))
    out: dict = {"rank": rank, "coords": list(mesh.coords),
                 "init_seconds": time.perf_counter() - t_start}
    arrays: dict = {}
    inputs = par_inputs(job, par_config("gru").n_features)
    for cell, ms in (("gru", job["micro"]), ("attn", (1,))):
        for m in ms:
            run = sp_rank_run(mesh, job, par_config(cell), m, inputs)
            for k, v in run.pop("params").items():
                arrays[f"{cell}{m}/{k}"] = v
            for k, v in run.pop("grads").items():
                arrays[f"grad/{cell}{m}/{k}"] = v
            out[f"{cell}{m}"] = run
    causal = sp_rank_causal(mesh, job)
    arrays["causal_out"] = causal.pop("out")
    for c, grad in zip("qkv", causal.pop("grads")):
        arrays[f"causal_d{c}"] = grad
    out["causal"] = causal
    out["sp_seconds"] = time.perf_counter() - t_start
    dist.destroy_process_group()
    if rank < PAR_DP_WORLD:
        t_dp = time.perf_counter()
        initialize(job["dp_store"], PAR_DP_WORLD, rank, device=device)
        dp_mesh = build_mesh(MeshConfig(dp=PAR_DP_WORLD, sp=1))
        data = np.load(job["batches"])
        for name in ("train", "multi"):
            weights = (data[f"{name}_weight"], data[f"{name}_pos_weight"])
            batches = [Batch(*(data[f"{name}{i}_{f}"] for f in Batch._fields))
                       for i in range(int(data[f"{name}_n"]))]
            job["train_cfg"] = job[f"{name}_cfg"]
            run = dp_rank_run(dp_mesh, job, batches, weights)
            for k, v in run.pop("params").items():
                arrays[f"{name}/{k}"] = v
            out[name] = run
        out["dp_seconds"] = time.perf_counter() - t_dp
    out["built_here"] = _cuda_lib.build_info.get("seconds") is not None
    base = os.path.dirname(job_path)
    np.savez(os.path.join(base, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(base, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    return 0


def run_parallel_world(base: str, world: int, job: dict):
    """Start a world of ``world`` rank processes of this script on the
    card (gloo: they share it) with ``job`` in ``base``, join it within
    PAR_WORLD_TIMEOUT, and return each rank's (results, arrays) and the
    world's seconds."""
    from fmda_tpu_torch.parallel import launch_world

    job_path = os.path.join(base, "job.json")
    with open(job_path, "w") as fh:
        json.dump(job, fh)
    script = os.path.abspath(__file__)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    try:
        results = launch_world(
            lambda r: [sys.executable, script, PARALLEL_RANK_ARG, str(r),
                       str(world), f"file://{base}/store", job_path],
            world, timeout=PAR_WORLD_TIMEOUT, env=env,
            cwd=os.path.dirname(script))
    except TimeoutError as e:
        check(False, f"parallel: {e}")
    seconds = time.perf_counter() - t0
    failed = [r for r in results if r.returncode != 0]
    check(not failed, "parallel: " + "\n".join(
        f"rank {r.rank} exit {r.returncode}: {r.stderr[-1500:]}"
        for r in failed))
    ranks = []
    for r in range(world):
        with open(os.path.join(base, f"rank{r}.json")) as fh:
            ranks.append((json.load(fh), dict(np.load(
                os.path.join(base, f"rank{r}.npz")))))
    check(not any(res["built_here"] for res, _ in ranks),
          "parallel: a rank process built the kernels")
    return ranks, seconds


def unsharded_steps(cfg, x, y, n_steps: int, device: str):
    """The sp cell's steps unsharded in this process, from the same params:
    (losses, final params, mean ms of the steps after the first, the first
    step's gradient before the clip)."""
    from fmda_tpu_torch.parallel import ClippedAdam
    from fmda_tpu_torch.train import clip_by_global_norm
    from fmda_tpu_torch.train.losses import weighted_bce_with_logits

    model = par_model(cfg, device)
    opt = ClippedAdam(1e-3, 50.0)
    state = opt.init(model)
    xd, yd = (torch.from_numpy(a).to(device) for a in (x, y))
    losses, t0 = [], None
    for i in range(n_steps):
        if i == 1:
            par_sync(device)
            t0 = time.perf_counter()
        state.zero_grad(set_to_none=True)
        loss = weighted_bce_with_logits(model(xd), yd)
        loss.backward()
        if i == 0:
            grads = {k: p.grad.cpu().numpy()
                     for k, p in model.named_parameters()}
        clip_by_global_norm([p.grad for p in model.parameters()], opt.clip)
        state.step()
        losses.append(loss.detach())
    par_sync(device)
    step_ms = (time.perf_counter() - t0) * 1e3 / (n_steps - 1)
    return [float(v) for v in losses], par_state(model), step_ms, grads


def par_param_err(cfg, got: dict, want: dict, prefix: str,
                  steps: int) -> float:
    """The largest difference of two param trees; attn's key bias is held
    to Adam's drift instead (``steps_vs_cpu`` says why)."""
    h = cfg.hidden_size
    err = 0.0
    for k, w in want.items():
        g = got[prefix + k]
        if k.endswith("qkv.bias"):
            check(max(np.abs(g[h:2 * h]).max(), np.abs(w[h:2 * h]).max())
                  <= steps * 1e-3, f"{k}: the key bias drifted")
            g, w = (np.concatenate([a[:h], a[2 * h:]]) for a in (g, w))
        err = max(err, float(np.abs(g - w).max()))
    return err


def ranks_agree(ranks, prefix: str) -> bool:
    """Every rank's params under ``prefix``, the same bits."""
    keys = [k for k in ranks[0][1] if k.startswith(prefix)]
    return bool(keys) and all(np.array_equal(ranks[0][1][k], arr[k])
                              for _, arr in ranks[1:] for k in keys)


def sp_launches(m: int, calls: int) -> dict:
    """What a rank launches over ``calls`` forwards and backwards (the
    gradient and the steps) of the sp gru step at M microbatches: a
    direction's stage M times a call, kernel 1 forward and again for
    remat's recompute, kernel 2 (and its weight gradient) once a stage in
    the backward."""
    stages = 2 * m
    return {"gru_scan_fwd": 2 * stages * calls,
            "gru_scan_bwd": stages * calls, "scan_dw": stages * calls}


def ring_launches(calls: int) -> dict:
    """What a rank launches over ``calls`` forwards and backwards of the
    ring attn step: kernel 6 once a fold (sp folds a layer a call); the
    backward's sweeps once a fold each (T/sp = 256 is past the fused
    kernel's 128)."""
    folds = PAR_SP * calls
    return {"flash_fwd": folds, "flash_dkv": folds, "flash_dq": folds}


def par_grad_err(ranks, prefix: str, want: dict) -> tuple:
    """(largest difference, largest element of ``want``) of rank 0's
    gradient under ``prefix`` and the unsharded one, and whether every
    rank holds the same bits."""
    got = ranks[0][1]
    err = max(float(np.abs(got[prefix + k] - w).max())
              for k, w in want.items())
    scale = max(float(np.abs(w).max()) for w in want.values())
    same = all(np.array_equal(got[prefix + k], arr[prefix + k])
               for _, arr in ranks[1:] for k in want)
    return err, scale, same


def parallel_sp(ranks, refs, spec: dict, world_s: float,
                device: str) -> dict:
    """The 8-rank world's sp gru steps at each M, its ring attn steps and
    its causal ring, each held to the same work unsharded in this process
    (``refs``: :func:`unsharded_steps` of gru and attn).  Returns their
    launches."""
    from fmda_tpu_torch.ops import attention_kernel

    on_card = torch.device(device).type == "cuda"
    n_steps = 1 + spec["steps"]
    gru_cfg, attn_cfg = par_config("gru"), par_config("attn")
    totals: dict = {}
    ref_losses, ref_params, ref_ms, ref_grads = refs["gru"]
    by_m = {}
    for m in spec["micro"]:
        runs = [res[f"gru{m}"] for res, _ in ranks]
        step_ms = max(r["step_ms"] for r in runs)
        loss_err = max(abs(a - b) for r in runs
                       for a, b in zip(r["losses"], ref_losses))
        param_err = par_param_err(gru_cfg, ranks[0][1], ref_params,
                                  f"gru{m}/", n_steps)
        grad_err, grad_scale, grad_same = par_grad_err(
            ranks, f"grad/gru{m}/", ref_grads)
        want = sp_launches(m, 1 + n_steps) if on_card else {}
        for r, run in enumerate(runs):
            check_launches(run["launches"], want,
                           f"parallel sp gru M={m} rank {r}")
            totals = add_counts(totals, run["launches"])
        by_m[m] = dict(step_ms=step_ms,
                       seq_per_s=spec["batch"] / step_ms * 1e3,
                       grad_max_abs_err=grad_err,
                       grad_largest=grad_scale,
                       grad_same_bits_on_every_rank=grad_same,
                       loss_max_abs_err=loss_err,
                       param_max_abs_err=param_err,
                       losses=runs[0]["losses"],
                       launches_per_rank=want,
                       params_same_bits_on_every_rank=ranks_agree(
                           ranks, f"gru{m}/"))
    for m in spec["micro"]:
        by_m[m]["speedup_vs_M1"] = by_m[1]["step_ms"] / by_m[m]["step_ms"]
        by_m[m]["model_speedup"] = PAR_SP * m / (PAR_SP + m - 1)
    emit("parallel sp gru", mesh=f"dp={PAR_DP} sp={PAR_SP}",
         backend="gloo", ranks=PAR_DP * PAR_SP, remat=True,
         shape={"B": spec["batch"], "T": spec["seq"],
                "F": gru_cfg.n_features,
                "H": gru_cfg.hidden_size},
         by_microbatches=by_m, unsharded_step_ms=ref_ms,
         world_seconds=world_s,
         rank_sp_seconds=max(res["sp_seconds"] for res, _ in ranks),
         rank_init_seconds=max(res["init_seconds"] for res, _ in ranks),
         tol=TRAIN_TOL)
    for m, row in by_m.items():
        check(row["grad_max_abs_err"] <= TRAIN_TOL * row["grad_largest"]
              and row["grad_same_bits_on_every_rank"],
              f"parallel sp gru M={m}: the sharded gradient and the "
              "unsharded disagree")
        check(row["loss_max_abs_err"] <= TRAIN_TOL
              and row["param_max_abs_err"] <= TRAIN_TOL,
              f"parallel sp gru M={m}: the sharded steps and the unsharded "
              "disagree")
        check(row["params_same_bits_on_every_rank"],
              f"parallel sp gru M={m}: the ranks' params differ")

    ref_losses, ref_params, ref_ms, ref_grads = refs["attn"]
    runs = [res["attn1"] for res, _ in ranks]
    grad_err, grad_scale, grad_same = par_grad_err(ranks, "grad/attn1/",
                                                   ref_grads)
    plan = attention_kernel.flash_bwd_plan(
        spec["batch"] // PAR_DP * attn_cfg.n_heads, attn_cfg.n_heads,
        spec["seq"] // PAR_SP, attn_cfg.hidden_size // attn_cfg.n_heads,
        torch.float32)
    want = ring_launches(1 + n_steps) if on_card else {}
    for r, run in enumerate(runs):
        check_launches(run["launches"], want,
                       f"parallel ring attn rank {r}")
        totals = add_counts(totals, run["launches"])
    loss_err = max(abs(a - b) for r in runs
                   for a, b in zip(r["losses"], ref_losses))
    param_err = par_param_err(attn_cfg, ranks[0][1], ref_params, "attn1/",
                              n_steps)
    step_ms = max(r["step_ms"] for r in runs)
    emit("parallel ring attn", mesh=f"dp={PAR_DP} sp={PAR_SP}",
         heads=attn_cfg.n_heads, remat=True, step_ms=step_ms,
         seq_per_s=spec["batch"] / step_ms * 1e3, unsharded_step_ms=ref_ms,
         ring_over_unsharded=step_ms / ref_ms, grad_max_abs_err=grad_err,
         grad_largest=grad_scale, grad_same_bits_on_every_rank=grad_same,
         loss_max_abs_err=loss_err,
         param_max_abs_err=param_err, losses=runs[0]["losses"],
         launches_per_rank=want, backward_plan=plan,
         params_same_bits_on_every_rank=ranks_agree(ranks, "attn1/"),
         tol=TRAIN_TOL)
    check(not plan["fused"], "the ring's backward at T/sp = 256 fused")
    check(grad_err <= TRAIN_TOL * grad_scale and grad_same,
          "parallel ring attn: the ring's gradient and the unsharded "
          "disagree")
    check(loss_err <= TRAIN_TOL and param_err <= TRAIN_TOL,
          "parallel ring attn: the ring steps and the unsharded disagree")
    check(ranks_agree(ranks, "attn1/"), "parallel ring attn: ranks differ")

    # the causal ring at the smaller depth, against the flash op unsharded
    q, k, v, g = (torch.from_numpy(a).to(device)
                  for a in par_causal_inputs(spec))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    want = attention_kernel.flash_attention(q, k, v, causal=True)
    (want * g).sum().backward()
    b, _, t, _ = spec["causal"]
    out_err = grad_err = 0.0
    folds = {}
    for r, (res, arr) in enumerate(ranks):
        d, s = res["coords"]
        rows = slice(d * b // PAR_DP, (d + 1) * b // PAR_DP)
        cols = slice(s * t // PAR_SP, (s + 1) * t // PAR_SP)
        out_err = max(out_err, float(np.abs(
            arr["causal_out"] - want[rows, :, cols].detach().cpu().numpy()
        ).max()))
        # rank (d, s) folds the blocks of ranks 0..s: the later ones are
        # wholly in its future and launch nothing; T/sp = 64 fuses
        expect = {"flash_fwd": s + 1, "flash_bwd": s + 1} if on_card else {}
        check_launches(res["causal"]["launches"], expect,
                       f"parallel ring causal rank {r}")
        totals = add_counts(totals, res["causal"]["launches"])
        folds[r] = s + 1
    for c, x_ in zip("qkv", (q, k, v)):
        summed = sum(arr[f"causal_d{c}"] for _, arr in ranks)
        grad_err = max(grad_err, float(np.abs(
            summed - x_.grad.cpu().numpy()).max()))
    emit("parallel ring causal", shape=spec["causal"], folds_by_rank=folds,
         out_max_abs_err=out_err, grad_max_abs_err=grad_err, tol=F32_TOL)
    check(out_err <= F32_TOL and grad_err <= F32_TOL,
          "parallel ring causal: the ring and the unsharded flash disagree")
    return totals


def write_dp_batches(path: str, dp_batches: dict) -> dict:
    """The dp steps' global batches and weights into ``path``; returns
    each run's TrainConfig, as the rank processes' job takes it."""
    arrays, cfgs = {}, {}
    for name, (batches, weights, train_cfg) in dp_batches.items():
        arrays[f"{name}_n"] = np.array(len(batches))
        for i, b in enumerate(batches):
            for f in b._fields:
                arrays[f"{name}{i}_{f}"] = getattr(b, f)
        arrays[f"{name}_weight"], arrays[f"{name}_pos_weight"] = weights
        cfgs[f"{name}_cfg"] = dataclasses.asdict(train_cfg)
    np.savez(path, **arrays)
    return cfgs


def parallel_dp(ranks, dp_batches: dict, device: str) -> dict:
    """The 2-rank world's dp Trainer steps over the ``train vs cpu``
    phase's first batches of 256 and ``train multi vs cpu``'s first mixed
    batches of 800, each held to the same steps in one process on the
    card.  Returns their launches."""
    from fmda_tpu_torch.train import Trainer

    on_card = torch.device(device).type == "cuda"
    totals, rows = {}, {}
    for name, (batches, weights, train_cfg) in dp_batches.items():
        trainer = Trainer(model_config("gru", dropout=0.0), train_cfg,
                          weight=weights[0], pos_weight=weights[1],
                          device=device)
        state = trainer.init_state()
        losses = [float(trainer.train_step(state, trainer.place(b))[0])
                  for b in batches]
        want = par_state(state.model)
        runs = [res[name] for res, _ in ranks]
        loss_err = max(abs(a - b) for r in runs
                       for a, b in zip(r["losses"], losses))
        param_err = max(float(np.abs(ranks[0][1][f"{name}/{k}"] - w).max())
                        for k, w in want.items())
        per_step = {"gru_scan_fwd": 2, "gru_scan_bwd": 2, "scan_dw": 2}
        expect = ({k: v * len(batches) for k, v in per_step.items()}
                  if on_card else {})
        for r, run in enumerate(runs):
            check_launches(run["launches"], expect,
                           f"parallel dp {name} rank {r}")
            totals = add_counts(totals, run["launches"])
        rows[name] = dict(steps=len(batches), batch=train_cfg.batch_size,
                          rows_a_rank=train_cfg.batch_size // PAR_DP_WORLD,
                          loss_max_abs_err=loss_err,
                          param_max_abs_err=param_err,
                          first_loss=losses[0], last_loss=losses[-1],
                          launches_per_rank=expect,
                          params_same_bits_on_every_rank=ranks_agree(
                              ranks, f"{name}/"))
    emit("parallel dp train", ranks=PAR_DP_WORLD, runs=rows,
         world_seconds=max(res["dp_seconds"] for res, _ in ranks),
         tol=TRAIN_TOL)
    for name, row in rows.items():
        check(row["loss_max_abs_err"] <= TRAIN_TOL
              and row["param_max_abs_err"] <= TRAIN_TOL,
              f"parallel dp {name}: the dp steps and the single process "
              "disagree")
        check(row["params_same_bits_on_every_rank"],
              f"parallel dp {name}: the ranks' params differ")
    return totals


def start_shard_pool_cli(device: str):
    """``serve-fleet --role solo --cell ssm --shard-pool`` started in a
    subprocess (it runs beside the dp world: neither is timed)."""
    argv = [sys.executable, "-m", "fmda_tpu_torch", "serve-fleet", "--role",
            "solo", "--cell", "ssm", "--shard-pool"]
    if device != "cuda":
        argv += ["--device", device]
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, time.perf_counter()


def finish_shard_pool_cli(started) -> tuple:
    """(exit code, its JSON, stderr, seconds) of the started CLI; killed
    on its limit."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    rc = proc.returncode
    return (rc, json.loads(out) if rc == 0 else {}, err,
            time.perf_counter() - t0)


def parallel_pool(directory: str, device: str, cli: tuple) -> dict:
    """The sharded SessionPool in this process, over a local mesh of two
    blocks on the one card: 64 sessions dealt round the blocks, 100
    flushes at bucket 64 against the unsharded pool (ssm the same bits,
    kernel 5 once a block a flush; gru within PATH_TOL); a 1-device mesh
    the unsharded pool's bits; ``serve-fleet --shard-pool``.  Returns the
    sharded ssm pool's launches."""
    from fmda_tpu_torch.config import MeshConfig
    from fmda_tpu_torch.data.normalize import NormParams
    from fmda_tpu_torch.models import build_model
    from fmda_tpu_torch.parallel import build_mesh
    from fmda_tpu_torch.runtime import SessionPool

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    meshes = {"2 blocks": build_mesh(MeshConfig(dp=2), devices=[dev, dev]),
              "1 device": build_mesh(MeshConfig(dp=1), devices=[dev])}
    gen = np.random.default_rng(SEED)
    rows, out, totals = {}, {}, {}
    for cell in ("ssm", "gru"):
        model_cfg = model_config(cell, bidirectional=False, dropout=0.0)
        state = build_model(model_cfg, generator=torch.Generator().manual_seed(
            SEED)).state_dict()
        f = model_cfg.n_features
        mins = gen.normal(size=(POOL_SESSIONS, f)).astype(np.float32)
        norms = [NormParams(mins[i], mins[i] + 2.0)
                 for i in range(POOL_SESSIONS)]
        ticks = gen.normal(size=(POOL_FULL_FLUSHES, POOL_SESSIONS, f)).astype(
            np.float32)
        probs = {}
        for name, mesh in (("unsharded", None), *meshes.items()):
            pool = SessionPool(model_cfg, state, capacity=128, window=30,
                               device=device, mesh=mesh)
            ids = [f"S{i}" for i in range(POOL_SESSIONS)]
            handles = [pool.alloc(s, norms[i]) for i, s in enumerate(ids)]
            slots = np.array([h.slot for h in handles], np.int32)
            start_path()
            t0 = time.perf_counter()
            got = [pool.step(slots, ticks[i])
                   for i in range(POOL_FULL_FLUSHES)]
            secs = time.perf_counter() - t0
            counts = launch_counts()
            probs[name] = np.stack(got)
            rows[f"{cell} {name}"] = dict(
                blocks=pool.n_shards, n_slots=pool.n_slots,
                lanes_by_block=np.bincount(
                    slots // (pool.n_slots // pool.n_shards),
                    minlength=pool.n_shards).tolist(),
                flush_ms=secs * 1e3 / POOL_FULL_FLUSHES, launches=counts)
            if cell == "ssm":
                check_launches(counts, {"ssm_tick": pool.n_shards
                                        * POOL_FULL_FLUSHES} if on_card
                               else {}, f"parallel shard pool {cell} {name}")
                if name == "2 blocks":
                    totals = add_counts(totals, counts)
            else:
                check_launches(counts, {}, f"parallel shard pool gru {name}")
        out[cell] = dict(
            sharded_max_abs_err=float(np.abs(
                probs["2 blocks"] - probs["unsharded"]).max()),
            sharded_same_bits=bool(np.array_equal(probs["2 blocks"],
                                                  probs["unsharded"])),
            one_device_same_bits=bool(np.array_equal(probs["1 device"],
                                                     probs["unsharded"])))
    rc, cli_out, cli_err, cli_s = cli
    emit("parallel shard pool", pools=rows, agreement=out,
         cli_exit=rc, cli_seconds=cli_s,
         cli_ticks_served=cli_out.get("ticks_served"), tol=PATH_TOL)
    check(out["ssm"]["sharded_same_bits"],
          "parallel shard pool: the ssm pool's blocks changed its bits")
    check(out["gru"]["sharded_max_abs_err"] <= PATH_TOL,
          "parallel shard pool: the sharded gru pool disagrees")
    check(all(v["one_device_same_bits"] for v in out.values()),
          "parallel shard pool: a 1-device mesh is not the unsharded pool")
    check(rc == 0 and cli_out.get("ticks_served", 0) > 0,
          f"serve-fleet --shard-pool failed: {cli_err[-2000:]}")
    return totals


def phase_parallel(directory: str, dp_batches: dict,
                   device: str = "cuda") -> dict:
    """Phase 21: the sp gru and ring attn steps in an 8-rank world, the dp
    Trainer in a 2-rank world, the sharded pool here.  Returns the path's
    launches (the ranks' and the sharded pool's), by kernel."""
    quiet_planes()
    t0 = time.perf_counter()
    spec = par_spec(device)
    gru_cfg = par_config("gru")
    x, y = par_inputs(spec, gru_cfg.n_features)
    # the same sp steps unsharded, timed before the world starts
    refs = {cfg.cell: unsharded_steps(cfg, x, y, 1 + spec["steps"], device)
            for cfg in (gru_cfg, par_config("attn"))}
    base = os.path.join(directory, "parallel")
    os.makedirs(base, exist_ok=True)
    spec.update(write_dp_batches(os.path.join(base, "dp_batches.npz"),
                                 dp_batches),
                batches=os.path.join(base, "dp_batches.npz"),
                dp_store=f"file://{base}/dp_store")
    ranks, world_s = run_parallel_world(base, PAR_DP * PAR_SP, spec)
    cli = start_shard_pool_cli(device)  # beside the untimed checks
    totals = add_counts(parallel_sp(ranks, refs, spec, world_s, device),
                        parallel_dp(ranks[:PAR_DP_WORLD], dp_batches,
                                    device))
    totals = add_counts(totals, parallel_pool(
        directory, device, finish_shard_pool_cli(cli)))
    emit("parallel", kernel_launches=totals,
         seconds=time.perf_counter() - t0,
         total_elapsed_s=time.perf_counter() - START)
    return totals


#: what an entry of the summary line carries of its kernel at a shape
TIMES = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def kernel_entry(name, replaces, source, rows, launches, by_path):
    """One kernel's entry of the summary line, at the main shape
    (256, 30, 32) float32, forward direction; ``b800`` the same at the
    multi-ticker mixed batch."""
    def plain_case(batch):
        return next(r for r in rows if r["batch"] == batch
                    and r["hidden"] == 32 and r["dtype"] == "float32"
                    and not (r["reverse"] or r["masked"]
                             or r["nonzero_h0"] or r.get("strided")))

    main_shape, mixed = plain_case(BATCH), plain_case(MULTI_BATCH)
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["dtype"] == "float32"),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        # the backward scans' two parts, each timed alone; the forwards'
        # branch
        **{k: main_shape[k] for k in ("sweep_ms", "dw_ms", "branch")
           if k in main_shape},
        "shape": [BATCH, 30, 32],
        "b800": {k: mixed[k] for k in TIMES},
    }


def ssm_entry(tick_rows, step_rows, by_path, step_by_path):
    """Kernel 5's entry of the summary line: the fused tick, at the pool's
    bucket 64, one layer, float32; the step kernel that keeps the Pallas
    kernel's contract, off every path now (``step_by_path``, its counts on
    the paths, checked to be 0), rides along as ``step_kernel`` at (64, 32)
    float32."""
    main_tick = next(r for r in tick_rows if r["batch"] == POOL_SESSIONS
                     and r["n_layers"] == 1 and r["dtype"] == "float32"
                     and r["hidden"] == 32 and not r["padded"])
    main_step = next(r for r in step_rows if r["batch"] == POOL_SESSIONS
                     and r["hidden"] == 32 and r["dtype"] == "float32"
                     and not r["strided"])

    def numbers(main, rows):
        return {"max_abs_err": max(r["max_abs_err"] for r in rows
                                   if r["dtype"] == "float32"),
                **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")}}

    return {
        "name": "ssm_tick",
        "route": "cuda",
        "source": SSM_SOURCE,
        "replaces": SSM_REPLACES,
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        **numbers(main_tick, tick_rows),
        "shape": [POOL_SESSIONS, 1, 108, 32],
        "step_kernel": {"name": "ssm_step", "route": "cuda",
                        "source": SSM_SOURCE, "replaces": SSM_REPLACES,
                        "launches": sum(step_by_path.values()),
                        "launches_by_path": step_by_path,
                        **numbers(main_step, step_rows),
                        "shape": [POOL_SESSIONS, 32]},
    }


def flash_entry(name, rows, by_path):
    """Kernel 6's, 7's or 8's entry of the summary line, or the fused
    backward's (7 and 8 in one launch), at the model's (256, 4, 30, 8)
    float32, not causal, no mask (``b800``: at batch 800); its library_ms
    is SDPA's forward (kernel 6) or its backward, which computes dq, dk
    and dv in one call."""
    _, n, t, d = FLASH_MAIN

    def plain_case(batch):
        return next(r for r in rows if r["kernel"] == name
                    and (r["batch"], r["heads"], r["seq"], r["d"])
                    == (batch, n, t, d) and r["dtype"] == "float32"
                    and not (r["causal"] or r["masked"]))

    main_shape, mixed = plain_case(BATCH), plain_case(MULTI_BATCH)
    return {
        "name": name,
        "route": "cuda",
        "source": FLASH_SOURCES[name],
        "replaces": FLASH_REPLACES[name],
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["kernel"] == name
                           and r["dtype"] == "float32"),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "shape": list(FLASH_MAIN),
        "b800": {k: mixed[k] for k in TIMES},
        **({"also_replaces": FLASH_REPLACES["flash_dq"]}
           if name == "flash_bwd" else {}),
    }


def ptxas_summary(log: str) -> dict:
    """ptxas's report per kernel instance, as ``{"<source>:<kernel><dtype,
    flags>": "<registers> regs, <bytes> B spilled"}``, and the largest
    spill in bytes."""
    kernels, name = {}, None
    for ln in log.splitlines():
        entry = re.search(r"entry function '([^']+)'", ln)
        if entry:
            mangled = entry.group(1)
            src = re.search(r"_\d+_(\w+?)_cu_", mangled)
            # the name follows its length; template arguments follow "I":
            # a class (the forwards' cell), the dtype, then bools and ints
            kern = re.search(r"(?<=\d)((?:[a-z]+_)+kernel)(?:I(?:NS_\d+"
                             r"([A-Za-z]+?)E)?(f|13__nv_bfloat16)"
                             r"((?:L[bi]\d+E)*))?", mangled)
            name = mangled[:60]
            if src and kern:
                args = [kern.group(2)] if kern.group(2) else []
                if kern.group(3):
                    args.append("bf16" if kern.group(3) == "13__nv_bfloat16"
                                else "f32")
                args += re.findall(r"L[bi](\d+)E", kern.group(4) or "")
                name = (f"{src.group(1)}:{kern.group(1)}"
                        + (f"<{','.join(args)}>" if args else ""))
            kernels[name] = {}
        elif name is not None:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", ln)
            regs = re.search(r"Used (\d+) registers", ln)
            if spill:
                kernels[name]["spill"] = int(spill.group(1)) + int(
                    spill.group(2))
            if regs:
                kernels[name]["regs"] = int(regs.group(1))
    summary = {k: f"{v.get('regs')} regs, {v.get('spill', 0)} B spilled"
               for k, v in kernels.items()}
    return dict(ptxas=summary, max_spill_bytes=max(
        (v.get("spill", 0) for v in kernels.values()), default=0))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script measures the "
              "card and has nothing to do without one", file=sys.stderr)
        return 2
    from fmda_tpu_torch.config import FrameworkConfig
    from fmda_tpu_torch.ops import _cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit("device", card=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, tf32="off (matmul and cudnn)")
    phase_lint()

    scans = scan_specs()
    t0 = time.perf_counter()
    lib = _cuda_lib.build()
    ptxas = ptxas_summary(str(_cuda_lib.build_info.get("log", "")))
    emit("build", kernels=[f"{s.name}_scan_{k}" for s in scans
                           for k in ("fwd", "bwd")]
         + ["ssm_step", "ssm_tick", *FLASH_REPLACES, *WIDE_KERNELS,
            *PERSIST_KERNELS, STEP_KERNEL, BWD_KERNEL],
         sources=[str(p.name) for p in _cuda_lib.SOURCES], library=str(lib),
         nvcc_seconds=_cuda_lib.build_info.get("seconds"),
         seconds=time.perf_counter() - t0, target="sm_90a", **ptxas)
    spills = {k: v for k, v in ptxas["ptxas"].items()
              if k.startswith(("flash_attn:", "flash_bwd:"))
              and not v.endswith(" 0 B spilled")}
    check(not spills, f"flash backward instances spill: {spills}")

    n_features = FrameworkConfig().model.n_features
    rows = {s.name: (phase_kernel(s, n_features),
                     phase_kernel_bwd(s, n_features)) for s in scans}
    ssm_rows = phase_kernel_ssm()
    tick_rows = phase_kernel_ssm_tick()
    flash_rows = phase_kernel_flash()
    t_wide = time.perf_counter()
    phase_wide_rule()
    wide_rows = phase_wide_kernels()
    step_rows = phase_wide_step()
    wide_bwd_rows = phase_wide_bwd_step()
    route_rows = phase_wide_route(n_features)
    wide_s = time.perf_counter() - t_wide
    serve, train, stream, stream_bi, pool = {}, {}, {}, {}, {}
    fleet, predictor_fleet, train_multi, continuous = {}, {}, {}, {}
    dp_batches = {}  # the gru train cells' batches, the dp world's steps
    _cuda_lib.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_cuda_lib.BUILD_ROOT) as tmp:
        t_wide = time.perf_counter()
        wide = {cell: phase_wide_path(tmp, cell=cell)
                for cell in ("gru", "lstm")}
        wide_s += time.perf_counter() - t_wide
        emit("wide", seconds=wide_s, budget_s=WIDE_BUDGET_S)
        check(wide_s <= WIDE_BUDGET_S,
              f"the wide phase took {wide_s:.1f} s, over its "
              f"{WIDE_BUDGET_S} s")
        wh = make_warehouse(tmp)
        for cell in ("gru", "lstm", "attn", "ssm"):
            serve[cell] = phase_path(wh, tmp, cell=cell)
            train[cell], _, dataset, weights = phase_train(wh, tmp,
                                                           cell=cell)
            vs_cpu = phase_train_vs_cpu(dataset, weights, cell=cell)
            if cell == "gru":
                dp_batches["train"] = vs_cpu
        for cell in ("gru", "lstm", "ssm"):
            stream[cell] = phase_stream(wh, cell=cell)
            if cell != "ssm":
                stream_bi[cell] = phase_stream(wh, cell=cell,
                                               bidirectional=True)
            pool[cell] = phase_pool(wh, cell=cell)
            fleet[cell] = phase_fleet(cell=cell)
        for cell in ("gru", "lstm", "attn", "ssm"):
            predictor_fleet[cell] = phase_predictor_fleet(wh, cell=cell)
        wh.close()
        sources, weights = multi_sources()
        for cell in ("gru", "lstm", "attn", "ssm"):
            train_multi[cell], vs_cpu = phase_train_multi(
                sources, weights, cell=cell)
            if cell == "gru":
                dp_batches["multi"] = vs_cpu
        for wh in sources.values():
            wh.close()
        for cell in ("gru", "ssm"):
            continuous[cell] = phase_continuous(tmp, cell=cell)
        traced_day = {}
        pipeline = phase_pipeline(
            tmp, traced_day=lambda live: traced_day.update(
                obs_traced_day(live)))
        obs = phase_obs(tick_rows, traced_day)
        app, app_wh = phase_app(tmp)
        replay = {cell: phase_replay(app_wh, tmp, cell=cell)
                  for cell in ("gru", "ssm")}
        remat = phase_remat()
        multihost = phase_multihost(tmp)
        control = phase_control(tmp)
        chaos = phase_chaos()
        parallel = phase_parallel(tmp, dp_batches)

    def later(name):
        """A kernel's launches on the app, replay and remat paths."""
        return {"app": app.get(name, 0),
                "replay": sum(r.get(name, 0) for r in replay.values()),
                "remat": remat.get(name, 0)}

    entries = []
    for s in scans:
        fwd, bwd = f"{s.name}_scan_fwd", f"{s.name}_scan_bwd"
        by_path = {"serve": serve[s.name][fwd], "train": train[s.name][fwd],
                   "stream_bidirectional": stream_bi[s.name][fwd],
                   "fleet": fleet[s.name][fwd],
                   "predictor_fleet": predictor_fleet[s.name][fwd],
                   "train_multi": train_multi[s.name][fwd],
                   "continuous": continuous.get(s.name, {}).get(fwd, 0),
                   "pipeline": pipeline[fwd], "obs": obs[fwd],
                   **later(fwd), "chaos": chaos.get(fwd, 0),
                   "parallel": parallel.get(fwd, 0)}
        bwd_by_path = {"serve": serve[s.name][bwd],
                       "train": train[s.name][bwd],
                       "fleet": fleet[s.name][bwd],
                       "predictor_fleet": predictor_fleet[s.name][bwd],
                       "train_multi": train_multi[s.name][bwd],
                       "continuous": continuous.get(s.name, {}).get(bwd, 0),
                       "pipeline": pipeline[bwd], **later(bwd),
                       "parallel": parallel.get(bwd, 0)}
        fwd_rows, bwd_rows = rows[s.name]
        entries += [
            kernel_entry(fwd, s.replaces[0], s.source, fwd_rows,
                         sum(by_path.values()), by_path),
            kernel_entry(bwd, s.replaces[1], s.source, bwd_rows,
                         sum(bwd_by_path.values()), bwd_by_path),
        ]
    entries.append(ssm_entry(tick_rows, ssm_rows, *(
        {"stream": stream["ssm"][k], "pool": pool["ssm"][k],
         "serve": serve["ssm"][k], "fleet": fleet["ssm"][k],
         "predictor_fleet": predictor_fleet["ssm"][k],
         "train_multi": train_multi["ssm"][k],
         "continuous": continuous["ssm"][k], "pipeline": pipeline[k],
         "obs": obs[k], **later(k), "multihost": multihost[k],
         "control": control.get(k, 0), "chaos": chaos.get(k, 0),
         "parallel": parallel.get(k, 0)}
        for k in ("ssm_tick", "ssm_step"))))
    entries += [flash_entry(name, flash_rows,
                            {"serve": serve["attn"][name],
                             "train": train["attn"][name],
                             "fleet": sum(fleet[c][name] for c in fleet),
                             "predictor_fleet":
                                 predictor_fleet["attn"][name],
                             "train_multi": train_multi["attn"][name],
                             "continuous": sum(continuous[c][name]
                                               for c in continuous),
                             "pipeline": pipeline[name], **later(name),
                             "parallel": parallel.get(name, 0)})
                for name in FLASH_REPLACES]
    entries += [wide_entry(name, wide_rows,
                           {"wide": wide[name.split("_")[0]][name]})
                for name in WIDE_KERNELS]
    entries += [persist_entry(name, wide_rows, route_rows,
                              {"wide": wide["lstm"][name]})
                for name in PERSIST_KERNELS]
    entries.append(step_entry(step_rows, {"wide": wide["gru"][STEP_KERNEL]}))
    entries.append(bwd_entry(wide_bwd_rows,
                             {"wide": wide["gru"][BWD_KERNEL]}))
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [DEVICE_TRACE_ARG]:
        sys.exit(device_trace_child(sys.argv[2]))
    if sys.argv[1:2] == [PARALLEL_RANK_ARG]:
        sys.exit(parallel_rank(int(sys.argv[2]), int(sys.argv[3]),
                               sys.argv[4], sys.argv[5]))
    sys.exit(main())
