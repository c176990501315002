#!/usr/bin/env python3
"""Chip smoke for fmda_tpu_torch: the quickest proof that the port starts,
builds its kernels, serves and trains correctly on a CUDA card (an H100).

    python3 chip_smoke.py            # from the repository root, one card

Phases, each printed as one JSON line, each fatal on failure:

1. ``device``: the card, its power limit, the torch/CUDA versions.
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
   session's bits alone and in a bucket of 64; the flash kernels at the
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
4. ``path``: the window-re-scan serving path at full width
   (``FrameworkConfig()``: H=32, F=108, window 30, float32) over a
   20,000-row warehouse: ``backtest`` at batch 256, then 64 signals through
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
   signal 2,000 rows in (a catch-up of 2,000 ticks), then 64 signals one
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

Phases 4-6 run for the BiGRU (``cell="gru"``, the default), the BiLSTM
(``cell="lstm"``), the TemporalTransformer (``cell="attn"``: the flash
kernels) and the bidirectional gated SSM (``cell="ssm"``: parallel mode,
no kernel); phases 7 and 8 for gru, lstm and ssm (``stream
bidirectional`` for gru and lstm).  Their lines carry
``cell``.  Every kernel's launch count is reset just before each path and
read just after it, and must equal what the path should launch, every
other kernel's 0 (``scan_dw`` counts the backward scans' weight-gradient
kernel, once a backward call).  Then the ``{"kernels": [...]}`` summary,
the card line, and as the last line ``{"ok": true, "device": {...}}``.  TF32 is off
for matmuls and cuDNN, so float32 means float32 everywhere.  Exits
non-zero, and prints no result, without a card or outside the repository.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
WAREHOUSE_ROWS = 20_000
SIGNALS = 64
BATCH = 256
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
REPS = 60
#: the device sleep before a primed call: ~1 ms, longer than a kernel
#: wrapper's host time; a cuDNN call through autograd can take longer than
#: that to enqueue on a busy host, so the library yardstick gets ~10 ms
PRIME_CYCLES = 2_000_000
LIBRARY_PRIME_CYCLES = 20_000_000
# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bandwidth,
# float32 outside the tensor cores, and bf16 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_TC_FLOP_PER_S = 989e12


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


def time_ms(fn, *, prime: bool, prime_cycles: int = PRIME_CYCLES) -> float:
    """Median of REPS CUDA-event times of one call, after warm-up.

    ``prime`` queues a device sleep of ``prime_cycles`` before each call,
    so the host's launch overhead hides behind it whenever it is shorter:
    the result is then the device time of the call.  Unprimed, it is the
    time the caller waits for the call on an idle card."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(REPS)]
    for start, end in pairs:
        if prime:
            torch.cuda._sleep(prime_cycles)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def roofline_ms(bytes_moved, product_flops, elementwise_flops, itemsize):
    """(bound_ms, bound_by): the larger of the bytes' time at the card's
    memory rate and the operations' time.  The products' operands are in
    the I/O dtype: float32 products run at the float32 rate beside the
    element-wise algebra; bf16 products (f32 accumulation) at the tensor
    cores' rate, alongside the element-wise algebra at the float32 rate."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_elem = elementwise_flops / PEAK_F32_FLOP_PER_S * 1e3
    if itemsize == 2:
        t_ops = max(product_flops / PEAK_BF16_TC_FLOP_PER_S * 1e3, t_elem)
    else:
        t_ops = product_flops / PEAK_F32_FLOP_PER_S * 1e3 + t_elem
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


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
        Scan("gru", gru_kernel, 3, 1, 10, 30, torch.nn.GRU,
             "fmda_tpu_torch/csrc/gru_scan.cu",
             ("fmda_tpu/ops/pallas_gru.py:147",
              "fmda_tpu/ops/pallas_gru.py:252")),
        # LSTM: 4 gate adds, 4 nonlinearities, c' = f c + i g, tanh(c'),
        # o tanh(c'); the backward's recompute and cotangent algebra
        Scan("lstm", lstm_kernel, 4, 2, 14, 40, torch.nn.LSTM,
             "fmda_tpu_torch/csrc/lstm_scan.cu",
             ("fmda_tpu/ops/pallas_lstm.py:80",
              "fmda_tpu/ops/pallas_lstm.py:195")),
    )


def scan_bound(batch, steps, hidden, itemsize, masked, *, gates=3,
               states=1, elementwise=10):
    """Least time for the forward scan on this card: each input read
    once, each output written once (xp, the initial states and the
    weights in; the per-step hiddens, and cell states for the LSTM, and
    the final states out), against the hidden product's and gates'
    FLOPs."""
    bytes_moved = itemsize * (
        batch * steps * gates * hidden          # xp in
        + states * batch * steps * hidden       # hs (and cs) out
        + 2 * states * batch * hidden           # initial in, final out
        + gates * hidden * hidden + gates * hidden)  # W_hh, b_hh in
    bytes_moved += batch * steps if masked else 0
    # 2*gH*H per (row, step) for h . W_hh^T, `elementwise` per (row, step,
    # unit) for the gate algebra (a transcendental counted as one)
    return roofline_ms(bytes_moved,
                       2 * batch * steps * gates * hidden * hidden,
                       elementwise * batch * steps * hidden, itemsize)


def scan_bwd_bound(batch, steps, hidden, itemsize, masked, *, gates=3,
                   states=1, elementwise=30):
    """Least time for the backward scan: xp, hs (and cs), dhs, the initial
    states, W_hh, b_hh (I/O dtype), the final states' cotangents and the
    mask read once; dxp (I/O dtype), the initial states' gradients, dW_hh
    and db_hh (float32) written once; against its FLOPs (the gate
    recompute's, the dh chain's and the dW_hh products, 6·B·T·gH·H in
    all, and `elementwise` per (row, step, unit) of gate and cotangent
    algebra)."""
    bt = batch * steps
    bytes_moved = itemsize * (
        bt * (gates * hidden + states * hidden + hidden + gates * hidden)
        + states * batch * hidden + gates * hidden * hidden + gates * hidden)
    bytes_moved += 4 * (2 * states * batch * hidden + gates * hidden * hidden
                        + gates * hidden)
    bytes_moved += bt if masked else 0
    return roofline_ms(bytes_moved, 6 * gates * hidden * hidden * bt,
                       elementwise * bt * hidden, itemsize)


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
             dict(base, batch=1), dict(base, hidden=128)]
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
#: operations per (row, unit) of the tick, a transcendental counted as one:
#: 11 for a, s' and h, 4 for each EMA; the EMA rates' sigmoids once a unit
SSM_OPS = 19


def ssm_bound(batch, hidden, itemsize):
    """Least time for one tick on this card: xp (B, 3H), the three carries
    and the four (H,) vectors read once, four (B, H) outputs written once,
    against the tick's element-wise operations (no product)."""
    return roofline_ms(itemsize * (10 * batch * hidden + 4 * hidden), 0,
                       SSM_OPS * batch * hidden + 2 * hidden, itemsize)


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


def tick_bound(batch, n_layers, feats, hidden, classes, itemsize):
    """Least time for one fused tick on this card: the rows, the slots,
    the lanes' norm rows, every layer's weights and the head read once, the
    lanes' state read and written once, pos read and written, the
    probabilities written; against the projections' and the head's
    products and the step's and the norm's element-wise operations."""
    g = 3 * hidden
    weights = (g * (feats + hidden * (n_layers - 1)) + 7 * hidden * n_layers
               + classes * (g + 1))
    bytes_moved = (4 * batch * feats + 4 * batch + 2 * 4 * batch * feats
                   + itemsize * weights
                   + 2 * itemsize * 3 * n_layers * batch * hidden
                   + 2 * 8 * batch + 4 * batch * classes)
    products = 2 * batch * (g * (feats + hidden * (n_layers - 1))
                            + classes * g)
    elementwise = (batch * (SSM_OPS * hidden * n_layers + 2 * feats
                            + 2 * classes) + 2 * hidden * n_layers)
    return roofline_ms(bytes_moved, products, elementwise, itemsize)


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
#: products per visible (query, key) pair, in units of D: the forward's
#: q.k and p.v; the dK/dV sweep's q.k, do.v, p^T do and ds^T q; the dQ
#: sweep's q.k, do.v and ds k; the fused backward's q.k, do.v, p^T do,
#: ds^T q and ds k
FLASH_FLOPS = {"flash_fwd": 4, "flash_dkv": 8, "flash_dq": 6, "flash_bwd": 10}
#: the backward kernels' outputs of (B*N, T, D)
FLASH_BWD_OUTPUTS = {"flash_dkv": 2, "flash_dq": 1, "flash_bwd": 3}


def flash_cases():
    """The serving and training shape in f32 and bf16, causal or not, with
    and without a key mask (ragged valid lengths, one row fully hidden);
    the Predictor's batch 1; the long-context (16, 4, 1024, 8), causal or
    not; the D envelope at 64 and 512, in f32 and bf16."""
    b, n, t, d = FLASH_MAIN
    base = dict(batch=b, heads=n, seq=t, d=d, dtype=torch.float32,
                causal=False, masked=False)
    return ([dict(base, dtype=dtype, causal=causal, masked=masked)
             for dtype in (torch.float32, torch.bfloat16)
             for causal in (False, True) for masked in (False, True)]
            + [dict(base, batch=1)]
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


def flash_bound(kernel, c, itemsize, pairs, masked):
    """Least time for one kernel on this card: its inputs read once (q, k,
    v; the backward also do, lse and delta; the key mask) and its outputs
    written once (o and lse; dk and dv; dq; dq, dk and dv), against its
    products' FLOPs over the visible pairs."""
    bntd = c["batch"] * c["heads"] * c["seq"] * c["d"]
    bnt = c["batch"] * c["heads"] * c["seq"]
    if kernel == "flash_fwd":
        bytes_moved = itemsize * 4 * bntd + 4 * bnt
    else:
        n_out = FLASH_BWD_OUTPUTS[kernel]
        bytes_moved = itemsize * (4 + n_out) * bntd + 2 * 4 * bnt
    bytes_moved += c["batch"] * c["seq"] if masked else 0
    return roofline_ms(bytes_moved, FLASH_FLOPS[kernel] * c["d"] * pairs, 0,
                       itemsize)


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


def device_share(fn) -> dict:
    """Kernel time on the card while ``fn`` runs, from torch.profiler's
    CUDA activity, against the wall time (profiler on, so the wall time
    is inflated and the share a lower bound), ``device_ops``, the kernels
    and copies the card ran, and ``port_kernels_ms``, the device time of
    each of the port's kernels.  ``busy_share`` is None when the
    profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    from fmda_tpu_torch.ops import (
        attention_kernel, gru_kernel, lstm_kernel, scan_dw, ssm_kernel)

    return {"gru_scan_fwd": gru_kernel.launches,
            "gru_scan_bwd": gru_kernel.bwd_launches,
            "lstm_scan_fwd": lstm_kernel.launches,
            "lstm_scan_bwd": lstm_kernel.bwd_launches,
            "scan_dw": scan_dw.launches,
            "ssm_step": ssm_kernel.launches,
            "ssm_tick": ssm_kernel.tick_launches,
            "flash_fwd": attention_kernel.fwd_launches,
            "flash_dkv": attention_kernel.dkv_launches,
            "flash_dq": attention_kernel.dq_launches,
            "flash_bwd": attention_kernel.bwd_launches}


def start_path() -> None:
    """A path starts: every kernel's launch count to 0."""
    from fmda_tpu_torch.ops import (
        attention_kernel, gru_kernel, lstm_kernel, scan_dw, ssm_kernel)

    for m in (gru_kernel, lstm_kernel):
        m.launches = m.bwd_launches = 0
    ssm_kernel.launches = ssm_kernel.tick_launches = scan_dw.launches = 0
    attention_kernel.fwd_launches = attention_kernel.dkv_launches = 0
    attention_kernel.dq_launches = attention_kernel.bwd_launches = 0


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
            lambda: run_backtest(device)), predictor=device_share(
            lambda: serve(device)))

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
          "longer splits Trainer.train_step")
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

    # a second epoch replays the placed batches: its steps, timed whole
    # and under the profiler
    t0 = time.perf_counter()
    state, _, _ = trainer.fit(wh, dataset=dataset, initial_state=state)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    emit("train replay epoch", cell=cell, seconds=replay_s,
         ms_per_batch=replay_s * 1e3 / (n_train + n_val),
         samples_per_s=n_windows / replay_s)
    if torch.device(device).type == "cuda":
        emit("train device share", cell=cell, batches=n_train + n_val,
             epoch=device_share(lambda: trainer.fit(
                 wh, dataset=dataset, initial_state=state)))
    emit("train breakdown", cell=cell, **train_breakdown(trainer, state, dataset,
                                              train_chunks, device))

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
    final params compared."""
    from fmda_tpu_torch.config import TrainConfig
    from fmda_tpu_torch.data.pipeline import WindowBatches
    from fmda_tpu_torch.train import Trainer

    model_cfg = model_config(cell, dropout=0.0)
    train_cfg = TrainConfig(batch_size=BATCH, chunk_size=TRAIN_CHUNK)
    train_chunks, _, _ = dataset.split(train_cfg.val_size,
                                       train_cfg.test_size)
    host = [b for idx in train_chunks[:3]
            for b in WindowBatches(dataset, idx, BATCH)]
    host = host[:TRAIN_VS_CPU_STEPS]
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
    emit("train vs cpu", cell=cell, steps=len(host), loss_max_abs_err=loss_err,
         param_max_abs_err=param_err, params_moved=moved,
         first_loss=g_loss[0], last_loss=g_loss[-1], card_seconds=g_s,
         cpu_seconds=c_s, key_bias_max=key_bias_max, tol=TRAIN_TOL)
    check(len(host) == TRAIN_VS_CPU_STEPS, f"only {len(host)} batches")
    check(loss_err <= TRAIN_TOL and param_err <= TRAIN_TOL,
          "training on the card and on the CPU disagree")


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


def kernel_entry(name, replaces, source, rows, launches, by_path):
    """One kernel's entry of the summary line, at the main shape
    (256, 30, 32) float32, forward direction."""
    main_shape = next(r for r in rows if r["batch"] == BATCH
                      and r["hidden"] == 32 and r["dtype"] == "float32"
                      and not (r["reverse"] or r["masked"]
                               or r["nonzero_h0"] or r.get("strided")))
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
    float32, not causal, no mask; its library_ms is SDPA's forward (kernel
    6) or its backward, which computes dq, dk and dv in one call."""
    b, n, t, d = FLASH_MAIN
    main_shape = next(r for r in rows if r["kernel"] == name
                      and (r["batch"], r["heads"], r["seq"], r["d"])
                      == (b, n, t, d) and r["dtype"] == "float32"
                      and not (r["causal"] or r["masked"]))
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

    scans = scan_specs()
    t0 = time.perf_counter()
    lib = _cuda_lib.build()
    ptxas = ptxas_summary(str(_cuda_lib.build_info.get("log", "")))
    emit("build", kernels=[f"{s.name}_scan_{k}" for s in scans
                           for k in ("fwd", "bwd")]
         + ["ssm_step", "ssm_tick", *FLASH_REPLACES],
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
    serve, train, stream, stream_bi, pool = {}, {}, {}, {}, {}
    _cuda_lib.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_cuda_lib.BUILD_ROOT) as tmp:
        wh = make_warehouse(tmp)
        for cell in ("gru", "lstm", "attn", "ssm"):
            serve[cell] = phase_path(wh, tmp, cell=cell)
            train[cell], _, dataset, weights = phase_train(wh, tmp,
                                                           cell=cell)
            phase_train_vs_cpu(dataset, weights, cell=cell)
        for cell in ("gru", "lstm", "ssm"):
            stream[cell] = phase_stream(wh, cell=cell)
            if cell != "ssm":
                stream_bi[cell] = phase_stream(wh, cell=cell,
                                               bidirectional=True)
            pool[cell] = phase_pool(wh, cell=cell)
        wh.close()

    entries = []
    for s in scans:
        fwd, bwd = f"{s.name}_scan_fwd", f"{s.name}_scan_bwd"
        by_path = {"serve": serve[s.name][fwd], "train": train[s.name][fwd],
                   "stream_bidirectional": stream_bi[s.name][fwd]}
        fwd_rows, bwd_rows = rows[s.name]
        entries += [
            kernel_entry(fwd, s.replaces[0], s.source, fwd_rows,
                         sum(by_path.values()), by_path),
            kernel_entry(bwd, s.replaces[1], s.source, bwd_rows,
                         train[s.name][bwd],
                         {"serve": serve[s.name][bwd],
                          "train": train[s.name][bwd]}),
        ]
    entries.append(ssm_entry(tick_rows, ssm_rows, *(
        {"stream": stream["ssm"][k], "pool": pool["ssm"][k],
         "serve": serve["ssm"][k]} for k in ("ssm_tick", "ssm_step"))))
    entries += [flash_entry(name, flash_rows,
                            {"serve": serve["attn"][name],
                             "train": train["attn"][name]})
                for name in FLASH_REPLACES]
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
