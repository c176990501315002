#!/usr/bin/env python3
"""Where a step of the GRU and LSTM backward sweeps goes, part by part.

    python3 experiments/torch_scan_sweep_profile.py   # repository root, one card

Builds fmda_tpu_torch's CUDA library a second time with
``-DFMDA_PROFILE_SWEEP`` (``csrc/scan_common.cuh``: each sweep then reads
``clock64()`` between the parts of a step) and runs each sweep once at the
training shape (256, 30, 32) in float32 and bfloat16.  For each it prints
one JSON line: the clock cycles per step of the gate recompute with its
lane sums, the gate and cotangent algebra with the outputs, the barrier,
the dh chain and the loop's own work, as block 0's first thread saw them,
and the clock rate (cycles over the loop's nanoseconds).  Beside it, the
sweep's device time from the normal build (CUDA events, queue primed).
Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the repository root's timing helpers)

PARTS = ("recompute", "gates_and_outputs", "barrier", "dh_chain", "loop")


def cases():
    """(scan, dtype, the sweep's arguments) at (256, 30, 32), nonzero h0."""
    dev = torch.device("cuda")
    for scan in chip_smoke.scan_specs():
        for dtype in (torch.float32, torch.bfloat16):
            c = dict(batch=chip_smoke.BATCH, steps=30, hidden=32, dtype=dtype,
                     reverse=False, masked=False, h0=True)
            gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
            args, _, rand = chip_smoke.scan_case_inputs(scan, c, gen, dev)
            d_lasts = [rand(c["batch"], 32, s=chip_smoke.COT_SCALE)
                       for _ in range(scan.states)]
            dhs = rand(c["batch"], 30, 32, s=chip_smoke.COT_SCALE)
            with torch.inference_mode():
                seqs = scan.fn("fwd")(*args)[scan.states:]
            yield scan, dtype, (*args, *seqs, *d_lasts, dhs)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_scan_sweep_profile: no CUDA device", file=sys.stderr)
        return 2
    from fmda_tpu_torch.ops import _cuda_lib

    card = chip_smoke.card_line()
    all_cases = list(cases())
    sweep_ms = {}
    for scan, dtype, bargs in all_cases:
        sweep = scan.fn("bwd_sweep")
        with torch.inference_mode():
            sweep_ms[scan.name, dtype] = chip_smoke.time_ms(
                lambda: sweep(*bargs), prime=True)

    _cuda_lib._lib = None  # load the profiling build beside the normal one
    _cuda_lib.NVCC_FLAGS = _cuda_lib.NVCC_FLAGS + ("-DFMDA_PROFILE_SWEEP",)
    lib = _cuda_lib.load()
    buf = (ctypes.c_longlong * 16)()
    for scan, dtype, bargs in all_cases:
        with torch.inference_mode():
            scan.fn("bwd_sweep")(*bargs)
        torch.cuda.synchronize()
        read = getattr(lib, f"fmda_{scan.name}_sweep_prof")
        read.argtypes = [ctypes.c_void_p]
        check = read(buf)
        if check != 0:
            raise SystemExit(f"reading the profile failed ({check})")
        v = list(buf)
        steps = 30
        line = dict(kernel=f"{scan.name}_scan_sweep",
                    dtype=str(dtype).replace("torch.", ""), batch=256,
                    steps=steps, hidden=32,
                    cycles_per_step={p: v[k] / steps
                                     for k, p in enumerate(PARTS)},
                    loop_cycles=v[5], clock_ghz=v[5] / max(v[6], 1),
                    sweep_ms=sweep_ms[scan.name, dtype], card=card)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
