#!/usr/bin/env python3
"""Where the GRU and LSTM kernel pairs and the wide scan route cross, on the
card.

    python3 experiments/torch_wide_crossover.py [--out FILE]   # repo root

For gru and lstm, H in {128, 256, 512, 1024}, B in {1, 256, 512}, T = 30,
float32 and bfloat16: the kernel pair (``gru_scan`` / ``lstm_scan``:
kernels 1 and 2, or 3 and 4, with ``scan_dw``) against the wide route
(``gru_wide_scan`` / ``lstm_wide_scan``: a cuBLAS product and a fused gate
kernel a step), the forward alone (inference) and the forward with its
backward (autograd, cotangents on every output).  Each is timed as device
ms (CUDA events around a call behind a primed queue:
``chip_smoke.time_ms``) and as the time a caller waits on an idle card
(unprimed).  The pair runs where its hidden limit allows (GRU 1024, LSTM
512).  Each line carries the forward plan's branch, ``kernel_supported``'s
verdict and the faster route of the forward and of the forward + backward,
by device time and by call time.  Then the wide route's weight gradient at
flagship_wide's (512, 30, 1024) bf16: one product over the B T rows
against ``scan_dw``'s kernel.  One JSON line each, also written to FILE
when ``--out`` names one; the last line a summary: the shapes where a
caller of the route ``kernel_supported`` picks waits longer than one of
the other (the rule's criterion), with the forward plan's branch (the
rule sends the device branch to the wide route whatever the wait).  Needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the repository root's timing helpers)

HIDDEN = (128, 256, 512, 1024)
BATCH = (1, 256, 512)
STEPS = 30
DTYPES = (torch.float32, torch.bfloat16)
#: the repetitions a time is the median of (chip_smoke's REPS is 20)
REPS = 10
#: the times each route is compared by
KEYS = ("fwd_ms", "fwd_call_ms", "fwd_bwd_ms", "fwd_bwd_call_ms")


def scan_args(cell, batch, hidden, dtype, gen, dev):
    """(xp, h0[, c0], W_hh, b_hh) needing gradients, and cotangents of
    every output, uniform from ``gen``."""
    gh = (3 if cell == "gru" else 4) * hidden
    states = 1 if cell == "gru" else 2

    def rand(*shape, s=1.0):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * s).to(dtype)

    args = [rand(batch, STEPS, gh, s=2.0),
            *[rand(batch, hidden, s=0.5) for _ in range(states)],
            rand(gh, hidden, s=1.0 / math.sqrt(hidden)),
            rand(gh, s=1.0 / math.sqrt(hidden))]
    cots = [rand(batch, hidden, s=chip_smoke.COT_SCALE)
            for _ in range(states)]
    cots.append(rand(batch, STEPS, hidden, s=chip_smoke.COT_SCALE))
    return [a.requires_grad_() for a in args], cots


def timings(cell, scan, args, cots) -> dict:
    """Forward and forward + backward, device and call ms."""
    detached = [a.detach() for a in args]

    def fwd():
        return chip_smoke.wide_scan_outputs(cell, scan, detached, False)

    def fwd_bwd():
        return torch.autograd.grad(
            chip_smoke.wide_scan_outputs(cell, scan, args, False), args,
            cots)

    prime = chip_smoke.LIBRARY_PRIME_CYCLES
    out = {}
    with torch.inference_mode():
        out["fwd_ms"] = chip_smoke.time_ms(fwd, prime=True,
                                           prime_cycles=prime)
        out["fwd_call_ms"] = chip_smoke.time_ms(fwd, prime=False)
    out["fwd_bwd_ms"] = chip_smoke.time_ms(fwd_bwd, prime=True,
                                           prime_cycles=prime)
    out["fwd_bwd_call_ms"] = chip_smoke.time_ms(fwd_bwd, prime=False)
    return out


def dw_line(dev) -> dict:
    """The wide route's weight gradient at (512, 30, 1024) bf16: its one
    product over the B T rows against scan_dw's kernel on the same
    operands (the GRU's dhh as dg)."""
    from fmda_tpu_torch.ops.scan_dw import h_prev_of, scan_dw

    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 9)
    b, h, dtype = 512, 1024, torch.bfloat16

    def rand(*shape):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1).to(
            dtype)

    dg, h0, hs = rand(b, STEPS, 3 * h), rand(b, h), rand(b, STEPS, h)
    with torch.inference_mode():
        h_prevs = h_prev_of(h0, hs)

        def product():
            return torch.mm(dg.reshape(-1, 3 * h).t(),
                            h_prevs.reshape(-1, h))

        got, want = product().float(), scan_dw(dg, h0, hs)[0]
        err = float((got - want).abs().max() / want.abs().max())
        return dict(phase="dw", batch=b, steps=STEPS, hidden=h,
                    dtype="bfloat16", product_ms=chip_smoke.time_ms(
                        product, prime=True),
                    scan_dw_ms=chip_smoke.time_ms(
                        lambda: scan_dw(dg, h0, hs), prime=True),
                    max_rel_diff=err)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None,
                        help="also write the JSON lines to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_wide_crossover: no CUDA device", file=sys.stderr)
        return 2
    from fmda_tpu_torch.ops import _cuda_lib, gru, lstm, wide_scan

    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.REPS = REPS
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 10)
    card = chip_smoke.card_line()
    slower = []
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out or os.devnull, "w") as out:
        def emit(line):
            text = json.dumps(dict(card=card, **line))
            print(text, flush=True)
            out.write(text + "\n")

        cells = {"gru": (gru, gru.gru_scan, wide_scan.gru_wide_scan, 1024),
                 "lstm": (lstm, lstm.lstm_scan, wide_scan.lstm_wide_scan,
                          512)}
        for cell, (ops, pair, route, limit) in cells.items():
            for dtype in DTYPES:
                itemsize = torch.tensor([], dtype=dtype).element_size()
                for hidden in HIDDEN:
                    for batch in BATCH:
                        a, cots = scan_args(cell, batch, hidden, dtype, gen,
                                            dev)
                        line = dict(cell=cell, batch=batch, steps=STEPS,
                                    hidden=hidden,
                                    dtype=str(dtype).replace("torch.", ""),
                                    kernel_supported=ops.kernel_supported(
                                        batch, STEPS, hidden, itemsize))
                        line["wide"] = timings(cell, route, a, cots)
                        if hidden <= limit:
                            line["branch"] = _cuda_lib.fwd_plan(
                                cell, batch, hidden, dtype, 0)["branch"]
                            line["pair"] = timings(cell, pair, a, cots)
                        for key in KEYS:
                            line[f"faster_by_{key}"] = (
                                "kernel_pair" if "pair" in line
                                and line["pair"][key] < line["wide"][key]
                                else "wide")
                        picked = ("kernel_pair" if line["kernel_supported"]
                                  else "wide")
                        lost = [key for key in KEYS if "call" in key
                                and line[f"faster_by_{key}"] != picked]
                        if lost:
                            slower.append(dict(
                                {k: line.get(k) for k in (
                                    "cell", "batch", "hidden", "dtype",
                                    "branch")}, slower_by=lost))
                        emit(line)
                        del a, cots
                        torch.cuda.empty_cache()
        emit(dw_line(dev))
        emit(dict(phase="summary", picked_slower_by_call_ms=slower))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
