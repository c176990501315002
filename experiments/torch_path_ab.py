#!/usr/bin/env python3
"""Two trees of the repository, each driving the GRU and LSTM serving,
training and bidirectional streaming paths on one card, in turns.

    python3 experiments/torch_path_ab.py OLD NEW   # repository roots, one card

Runs ``chip_smoke.py``'s ``phase_path``, ``phase_train`` and
``phase_stream(..., bidirectional=True)`` for ``cell`` in gru and lstm, in
a fresh process per run, from each tree in the order OLD, NEW, NEW, OLD, so
that a drift of the host during the call falls on both.  Each tree builds
its own kernels (under its own ``build/``).  Prints every phase line with
``tree`` (``old`` or ``new``) and ``run`` added, then one ``summary`` line
per metric: each tree's values and their spread.  Host times spread
between calls and hosts, so compare the trees only inside one call.  Needs
a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

ORDER = ("old", "new", "new", "old")
CELLS = ("gru", "lstm")
#: (phase, key path) of the metrics the summary lists
METRICS = (
    ("path backtest", ("rows_per_s",)),
    ("path predictor", ("p50_ms",)),
    ("path device share", ("backtest", "device_ms")),
    ("train fit", ("samples_per_s",)),
    ("train breakdown", ("mean_step_ms",)),
    ("train device share", ("epoch", "device_ms")),
    ("stream bidirectional", ("catchup_ticks_per_s",)),
    ("stream bidirectional", ("p50_ms",)),
    ("stream bidirectional breakdown", ("tick_ms",)),
    ("stream bidirectional breakdown", ("device_share", "device_ms")),
)


def run_one(root: str) -> int:
    """The paths from the tree at ``root``, in this process."""
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke
    from fmda_tpu_torch.ops import _cuda_lib

    if not torch.cuda.is_available():
        print("torch_path_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda_lib.build()
    _cuda_lib.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_cuda_lib.BUILD_ROOT) as tmp:
        wh = chip_smoke.make_warehouse(tmp)
        for cell in CELLS:
            chip_smoke.phase_path(wh, tmp, cell=cell)
            chip_smoke.phase_train(wh, tmp, cell=cell)
            chip_smoke.phase_stream(wh, cell=cell, bidirectional=True)
        wh.close()
    return 0


def value(line: dict, keys) -> float:
    for k in keys:
        line = line[k]
    return line


def main(old: str, new: str) -> int:
    roots = {"old": os.path.abspath(old), "new": os.path.abspath(new)}
    lines = []
    for run, tree in enumerate(ORDER):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one",
             roots[tree]], capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        for ln in out.stdout.splitlines():
            if ln.startswith('{"phase"'):
                line = dict(json.loads(ln), tree=tree, run=run)
                lines.append(line)
                print(json.dumps(line), flush=True)
    for phase, keys in METRICS:
        for cell in CELLS:
            got = {tree: [value(ln, keys) for ln in lines
                          if ln["phase"] == phase and ln.get("cell") == cell
                          and ln["tree"] == tree] for tree in roots}
            print(json.dumps({"summary": phase, "metric": ".".join(keys),
                              "cell": cell, **got}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        sys.exit(run_one(sys.argv[2]))
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2]))
