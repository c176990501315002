#!/usr/bin/env python3
"""Where a backward scan call's device time goes, kernel by kernel.

    python3 experiments/torch_scan_bwd_split.py      # repository root, one card

For each of ``gru_scan_bwd`` and ``lstm_scan_bwd`` (fmda_tpu_torch's CUDA
backward scans) at the training shape (256, 30, 32), in float32 and
bfloat16, it prints one JSON line: the call's device time (CUDA events,
queue primed: ``chip_smoke.time_ms``) and, from ``torch.profiler``, each
CUDA kernel the call launches with its mean device time per call.  The
split says how much of the call is the serial sweep and how much the
weight-gradient work after it.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import re
import sys
from collections import defaultdict

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the repository root's timing helpers)

CALLS = 50


def kernel_split(fn) -> dict:
    """Mean device ms per call of each kernel ``fn`` launches, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    split = defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        found = re.search(r"(\w+_kernel)", evt.key)
        name = found.group(1) if found else evt.key[:60]
        split[name] += evt.self_device_time_total / 1e3 / CALLS
    return dict(split)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_scan_bwd_split: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    for scan in chip_smoke.scan_specs():
        for dtype in (torch.float32, torch.bfloat16):
            c = dict(batch=chip_smoke.BATCH, steps=30, hidden=32,
                     dtype=dtype, reverse=False, masked=False, h0=False)
            dev = torch.device("cuda")
            gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
            args, mask, rand = chip_smoke.scan_case_inputs(scan, c, gen, dev)
            b, t, h = c["batch"], c["steps"], c["hidden"]
            d_lasts = [rand(b, h, s=chip_smoke.COT_SCALE)
                       for _ in range(scan.states)]
            dhs = rand(b, t, h, s=chip_smoke.COT_SCALE)
            bwd = scan.fn("bwd")
            with torch.inference_mode():
                seqs = scan.fn("fwd")(*args, mask=mask)[scan.states:]
                bargs = (*args, *seqs, *d_lasts, dhs)
                call = lambda: bwd(*bargs, mask=mask)  # noqa: E731
                ms = chip_smoke.time_ms(call, prime=True)
                split = kernel_split(call)
            line = dict(kernel=f"{scan.name}_scan_bwd", batch=b, steps=t,
                        hidden=h, dtype=str(dtype).replace("torch.", ""),
                        ms=ms, kernels_ms=split,
                        kernels_sum_ms=sum(split.values()), card=card)
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
