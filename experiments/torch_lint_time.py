#!/usr/bin/env python3
"""Where the static-analysis gate's time goes, on this host.

    python3 experiments/torch_lint_time.py

Prints one JSON line each, host clocks in seconds:

- ``import_torch``: a fresh interpreter's ``import torch``, twice (the
  drift rule's resolver process pays it every run), and a bare
  interpreter's start;
- ``lint``: ``python -m fmda_tpu_torch lint`` in a subprocess, with
  ``--no-drift`` once and whole twice (the drift rule's resolver imports
  torch while the other rules run);
- ``rules``: the parse, then each rule of the catalog alone over the
  parsed tree in this process (the drift rule alone waits for its
  resolver's whole import: nothing overlaps it here).

Host only: nothing here touches a device.  The GPU host is the one
that counts (``chip_smoke.py``'s ``lint`` line holds the gate to 15 s
there); run it on that host beside ``chip_smoke.py``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def timed_run(argv) -> float:
    t0 = time.perf_counter()
    subprocess.run(argv, check=True, cwd=ROOT, stdout=subprocess.DEVNULL)
    return time.perf_counter() - t0


def main() -> int:
    py = sys.executable
    print(json.dumps({
        "import_torch": [timed_run([py, "-c", "import torch"])
                         for _ in range(2)],
        "bare_interpreter": timed_run([py, "-c", "pass"]),
        "cpus": os.cpu_count()}), flush=True)
    lint = [py, "-m", "fmda_tpu_torch", "lint"]
    print(json.dumps({"lint": {
        "no_drift": timed_run(lint + ["--no-drift"]),
        "whole": [timed_run(lint) for _ in range(2)]}}), flush=True)

    from fmda_tpu_torch.analysis import (
        collect_modules, default_rules, run_rules)

    t0 = time.perf_counter()
    ctx = collect_modules()
    rules = {"parse": time.perf_counter() - t0}
    for rule in default_rules():
        t0 = time.perf_counter()
        run_rules([rule], ctx)
        rules[rule.id] = time.perf_counter() - t0
    print(json.dumps({"rules": rules, "modules": len(ctx.modules)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
