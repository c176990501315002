"""Four fleet workers that build the kernel library at once, on the card.

Each worker process of a local topology builds the CUDA library at its
first launch (``fmda_tpu_torch.ops._cuda_lib.build``: every source
compiled under a per-process temporary name, the library renamed into
place).  Run with a cold ``build/fmda_tpu_torch/`` (a chip call's copy
has none), this starts four ssm workers together, so all four build at
once, then serves 256 sessions x 10 rounds through them and checks that
one library is left, that every tick is served and that each worker
launched kernel 5 once a flush.  Prints one JSON line: the seconds the
four took to join (their builds included), the ticks and the launches.

    python3 experiments/torch_multihost_cold_build.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from fmda_tpu_torch.ops import _cuda_lib  # noqa: E402
from fmda_tpu_torch.runtime.loadgen import (  # noqa: E402
    FleetLoadConfig,
    run_fleet_load,
)


def main() -> int:
    cold = not _cuda_lib.library_path().exists()
    t0 = time.perf_counter()
    topo = cs.multihost_topology("ssm", 4, "cuda")
    joined_s = time.perf_counter() - t0
    try:
        out = run_fleet_load(topo.router, FleetLoadConfig(
            n_sessions=4 * cs.MULTIHOST_SESSIONS, n_ticks=10, seed=cs.SEED))
    finally:
        stats = topo.shutdown()
    launches = cs.worker_launches(stats, "ssm", "cold build", "cuda")
    libs = sorted(p.name for p in _cuda_lib.library_path().parent.iterdir())
    print(json.dumps({
        "card": cs.card_line(), "cold": cold, "joined_s": joined_s,
        "ticks_submitted": out["ticks_submitted"],
        "ticks_served": out["ticks_served"], "ssm_tick_launches": launches,
        "worker_flushes": {w: s.get("flushes") for w, s in stats.items()},
        "build_dir": libs}))
    cs.check(out["ticks_served"] == out["ticks_submitted"],
             "cold build: ticks lost")
    cs.check(libs == ["libfmda_scans.log", "libfmda_scans.so"],
             f"cold build: left {libs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
