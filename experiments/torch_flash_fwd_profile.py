#!/usr/bin/env python3
"""Where the flash forward's time goes, part by part.

    python3 experiments/torch_flash_fwd_profile.py   # repository root, one card

Times the forward (``attention_kernel.flash_fwd``: device time, queue
primed, CUDA events) at the model's (256, 4, 30, 8), the Predictor's
(1, 4, 30, 8), the long context (16, 4, 1024, 8) and D = 64, in float32
and in bfloat16.  Then builds fmda_tpu_torch's
CUDA library a second time with ``-DFMDA_PROFILE_SWEEP``
(``csrc/flash_fwd.cu`` then reads ``clock64()`` between the parts of a
query tile) and runs each case once more: the clock cycles of the set-up
and resident staging, the q tile, the scores and masks, the softmax, and
p v with the stores, as CTA 0's first and last threads saw them, and the
clock rate (cycles over the kernel's nanoseconds).  One JSON line a case,
with the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the tree's timing helpers)

PARTS = ("setup", "q_tile", "scores", "softmax", "pv_and_stores")
SHAPES = ((256, 4, 30, 8), (1, 4, 30, 8), (16, 4, 1024, 8), (8, 2, 256, 64))
CASES = [(shape, dtype) for shape in SHAPES
         for dtype in (torch.float32, torch.bfloat16)]


def inputs(shape, dtype):
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for _ in range(3)]


def run(ak, shape, dtype):
    q, k, v = inputs(shape, dtype)
    with torch.inference_mode():
        return chip_smoke.time_ms(lambda: ak.flash_fwd(q, k, v), prime=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_fwd_profile: no CUDA device", file=sys.stderr)
        return 2
    from fmda_tpu_torch.ops import _cuda_lib
    from fmda_tpu_torch.ops import attention_kernel as ak

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    times = {case: run(ak, *case) for case in CASES}

    _cuda_lib._lib = None  # load the profiling build beside the normal one
    _cuda_lib.NVCC_FLAGS = _cuda_lib.NVCC_FLAGS + ("-DFMDA_PROFILE_SWEEP",)
    lib = _cuda_lib.load()
    read = lib.fmda_flash_fwd_prof
    read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_longlong * 16)()
    for case in CASES:
        shape, dtype = case
        run(ak, shape, dtype)
        torch.cuda.synchronize()
        check = read(buf)
        if check != 0:
            raise SystemExit(f"reading the profile failed ({check})")
        v = list(buf)
        b, n, t, d = shape
        print(json.dumps(dict(
            kernel="flash_fwd", shape=list(shape),
            dtype=str(dtype).replace("torch.", ""),
            plan=ak.flash_fwd_plan(b * n, n, t, d, dtype), ms=times[case],
            first_thread_cycles=dict(zip(PARTS, v[0:5])),
            last_thread_cycles=dict(zip(PARTS, v[8:13])),
            total_cycles=v[5], clock_ghz=v[5] / max(v[6], 1), card=card)),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
