#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 21 (``parallel``) alone: the library's build,
the 20,000-row warehouse and the 50 multi-ticker warehouses it steps
again, then the phase.

    python3 experiments/torch_parallel_phase.py            # on the card
    python3 experiments/torch_parallel_phase.py --rehearse # CPU, cut small

``--rehearse`` runs on the CPU at cut shapes, the kernels' plain versions
and the flash backward's plan stubbed (the launch counts expected there
are 0): a check of the control flow, not a measurement.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def dp_batches(wh, sources, multi_weights):
    """The smoke's ``train vs cpu`` and ``train multi vs cpu`` gru batches,
    as :func:`chip_smoke.steps_vs_cpu` returns them."""
    from fmda_tpu_torch.config import FrameworkConfig, TrainConfig
    from fmda_tpu_torch.data.pipeline import ChunkDataset, WindowBatches
    from fmda_tpu_torch.train import (
        MultiTickerDataset,
        imbalance_weights_from_source,
    )

    fc = FrameworkConfig().features
    levels = dict(bid_levels=fc.bid_levels, ask_levels=fc.ask_levels)
    tc = TrainConfig(batch_size=cs.BATCH, chunk_size=cs.TRAIN_CHUNK)
    ds = ChunkDataset(wh, tc.chunk_size, tc.window, **levels)
    train, _, _ = ds.split(tc.val_size, tc.test_size)
    host = [b for idx in train[:3] for b in WindowBatches(ds, idx, cs.BATCH)]
    mtc = TrainConfig(batch_size=cs.MULTI_BATCH, chunk_size=cs.MULTI_CHUNK,
                      window=30, epochs=1)
    mtd = MultiTickerDataset(sources, cs.MULTI_CHUNK, mtc.window, **levels)
    mixed, _, _ = cs.mixed_pass(mtd, mtd.splits(mtc.val_size,
                                                 mtc.test_size)[0])
    return {"train": (host[:cs.TRAIN_VS_CPU_STEPS],
                      imbalance_weights_from_source(wh), tc),
            "multi": (mixed[:cs.MULTI_VS_CPU_STEPS], multi_weights, mtc)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--rehearse", action="store_true")
    args = parser.parse_args()
    device = "cpu" if args.rehearse else "cuda"
    if args.rehearse:
        from fmda_tpu_torch.ops import attention_kernel

        attention_kernel.flash_bwd_plan = lambda *a, **k: {"fused": False}
        cs.WAREHOUSE_ROWS = 6000
        cs.PAR_BATCH, cs.PAR_SEQ, cs.PAR_STEPS = 8, 64, 2
        cs.PAR_CAUSAL = (2, 2, 32, 8)
        cs.POOL_FULL_FLUSHES = 5
        cs.MULTI_TICKERS, cs.MULTI_ROWS = 4, 600
        cs.MULTI_BATCH = cs.MULTI_TICKERS * cs.MULTI_PER_TICKER
    else:
        import torch

        from fmda_tpu_torch.ops import _cuda_lib

        if not torch.cuda.is_available():
            print("no card: run with --rehearse on the CPU", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(cs.card_line(), flush=True)
        t0 = time.perf_counter()
        _cuda_lib.build()
        cs.emit("build", seconds=time.perf_counter() - t0)
    from fmda_tpu_torch.ops import _cuda_lib

    _cuda_lib.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_cuda_lib.BUILD_ROOT) as tmp:
        wh = cs.make_warehouse(tmp)
        sources, multi_weights = cs.multi_sources()
        batches = dp_batches(wh, sources, multi_weights)
        for w in (wh, *sources.values()):
            w.close()
        cs.phase_parallel(tmp, batches, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
