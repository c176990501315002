#!/usr/bin/env python3
"""Where a step of the GRU and LSTM forward scans goes, part by part.

    python3 experiments/torch_scan_fwd_profile.py   # repository root, one card
    python3 experiments/torch_scan_fwd_profile.py --host-only [--root DIR]

Builds fmda_tpu_torch's CUDA library a second time with
``-DFMDA_PROFILE_SWEEP`` (``csrc/scan_common.cuh``: the forward then reads
``clock64()`` between the parts of a step) and runs each forward once at
the stream's (1, 30, 32), the serving and training shape (256, 30, 32), in
float32 and bfloat16, and at (256, 30, 128) float32.  For each it prints
one JSON line: the branch the launcher's plan took, the clock cycles per
step of the hidden product with its lane sums, the gate algebra with the
stores, the barrier and the loop's own work (the next step's loads
included), as block 0's first thread saw them, and the clock rate (cycles
over the loop's nanoseconds).  Beside it, the forward's device time from
the normal build (CUDA events, queue primed) and ``host_us``, the
wrapper's host time a call (the mean over HOST_CALLS calls queued back to
back; where a call is longer on the card than on the host, the card's
rate instead).  ``--host-only`` prints
only ``host_us``, for the tree at ``--root`` (default: this one), so that
two trees' wrappers can be compared in one call.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = argparse.ArgumentParser()
ARGS.add_argument("--host-only", action="store_true")
ARGS.add_argument("--root", default=REPO)
OPTS = ARGS.parse_args()
sys.path.insert(0, os.path.abspath(OPTS.root))

import chip_smoke  # noqa: E402  (the tree's timing helpers)

#: the profile's slots 0..4 for a forward (slot 3 is the sweeps' dh chain)
PARTS = ("product", "gates_and_stores", "barrier", None, "loop")
SHAPES = ((1, 32, torch.float32), (chip_smoke.BATCH, 32, torch.float32),
          (chip_smoke.BATCH, 32, torch.bfloat16),
          (chip_smoke.BATCH, 128, torch.float32))
STEPS = 30
HOST_CALLS = 500


def host_us(fn) -> float:
    """The wrapper's host time a call, in microseconds."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / HOST_CALLS * 1e6


def cases():
    """(scan, (B, H, dtype), the forward's arguments), nonzero h0."""
    dev = torch.device("cuda")
    for scan in chip_smoke.scan_specs():
        for batch, hidden, dtype in SHAPES:
            c = dict(batch=batch, steps=STEPS, hidden=hidden, dtype=dtype,
                     reverse=False, masked=False, h0=True)
            gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
            args, _, _ = chip_smoke.scan_case_inputs(scan, c, gen, dev)
            yield scan, (batch, hidden, dtype), args


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_scan_fwd_profile: no CUDA device", file=sys.stderr)
        return 2
    from fmda_tpu_torch.ops import _cuda_lib

    card = chip_smoke.card_line()
    all_cases = list(cases())
    fwd_ms, plans, host = {}, {}, {}
    for scan, shape, args in all_cases:
        fwd = scan.fn("fwd")
        with torch.inference_mode():
            host[scan.name, shape] = host_us(lambda: fwd(*args))
            if OPTS.host_only:
                print(json.dumps(dict(
                    kernel=f"{scan.name}_scan_fwd", root=OPTS.root,
                    dtype=str(shape[2]).replace("torch.", ""),
                    batch=shape[0], steps=STEPS, hidden=shape[1],
                    host_us=host[scan.name, shape], card=card)), flush=True)
                continue
            fwd_ms[scan.name, shape] = chip_smoke.time_ms(
                lambda: fwd(*args), prime=True)
        plans[scan.name, shape] = _cuda_lib.fwd_plan(scan.name, *shape[:2],
                                                     shape[2], 0)
    if OPTS.host_only:
        return 0

    _cuda_lib._lib = None  # load the profiling build beside the normal one
    _cuda_lib.NVCC_FLAGS = _cuda_lib.NVCC_FLAGS + ("-DFMDA_PROFILE_SWEEP",)
    lib = _cuda_lib.load()
    buf = (ctypes.c_longlong * 16)()
    for scan, shape, args in all_cases:
        with torch.inference_mode():
            scan.fn("fwd")(*args)
        torch.cuda.synchronize()
        read = getattr(lib, f"fmda_{scan.name}_sweep_prof")
        read.argtypes = [ctypes.c_void_p]
        check = read(buf)
        if check != 0:
            raise SystemExit(f"reading the profile failed ({check})")
        v = list(buf)
        batch, hidden, dtype = shape
        line = dict(kernel=f"{scan.name}_scan_fwd",
                    dtype=str(dtype).replace("torch.", ""), batch=batch,
                    steps=STEPS, hidden=hidden,
                    plan=plans[scan.name, shape],
                    cycles_per_step={p: v[k] / STEPS
                                     for k, p in enumerate(PARTS) if p},
                    loop_cycles=v[5], clock_ghz=v[5] / max(v[6], 1),
                    fwd_ms=fwd_ms[scan.name, shape],
                    host_us=host[scan.name, shape], card=card)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
