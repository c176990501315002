#!/usr/bin/env python3
"""Two trees of the repository, each driving some of the port's paths on
one card, in turns.

    python3 experiments/torch_path_ab.py OLD NEW [--paths a,b,...]
        [--rounds N]

OLD and NEW are repository roots; one card.  The paths (default: all),
each a phase of ``chip_smoke.py``:

- ``scans``: ``phase_path``, ``phase_train`` and ``phase_stream(...,
  bidirectional=True)`` for gru and lstm;
- ``ssm_stream``: ``phase_stream`` for ssm (the solo carried-state core);
- ``pool``: ``phase_pool`` for gru, lstm and ssm (the session pool);
- ``attn_serve``: ``phase_path`` for attn (backtest and Predictor);
- ``fleet``: the default fleet load (``FLEET_LOADS["default"]``: 64
  sessions x 100 rounds, pipeline depth 1, tracing off) through
  ``fleet_run``, FLEET_AB_LOADS loads each for gru and ssm, each load's
  ticks/s a line (``fleet ab``);
- ``trace``: tracing's cost on the gru default fleet load
  (``obs_trace_cost``: tracing off, at 1 % and at 100 %, alternating in
  the process), its line and its check's verdict (``trace ab check``,
  the run going on past a failed check).

Each tree runs in a fresh process per run, in the order OLD, NEW, NEW, OLD
(``--rounds N``: that order N times), so that a drift of the host during
the call falls on both.  Each tree
builds its own kernels (under its own ``build/``).  Prints every phase line
with ``tree`` (``old`` or ``new``) and ``run`` added, then one ``summary``
line per metric and cell: each tree's values (null where a tree's line
lacks the metric).  Host times spread between calls and hosts, so compare
the trees only inside one call.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

ORDER = ("old", "new", "new", "old")
PATHS = ("scans", "ssm_stream", "pool", "attn_serve", "fleet", "trace")
#: default fleet loads a ``fleet`` run makes for each family
FLEET_AB_LOADS = 10
POOL_CELLS = ("gru", "lstm", "ssm")
#: (path, phase, key path, cells) of the metrics the summary lists; the key
#: ``flash_fwd_ms`` is the flash forward's device time in the profiled
#: backtest
METRICS = (
    ("scans", "path backtest", ("rows_per_s",), ("gru", "lstm")),
    ("scans", "path predictor", ("p50_ms",), ("gru", "lstm")),
    ("scans", "path device share", ("backtest", "device_ms"),
     ("gru", "lstm")),
    ("scans", "train fit", ("samples_per_s",), ("gru", "lstm")),
    ("scans", "train breakdown", ("mean_step_ms",), ("gru", "lstm")),
    ("scans", "train device share", ("epoch", "device_ms"), ("gru", "lstm")),
    ("scans", "stream bidirectional", ("catchup_ticks_per_s",),
     ("gru", "lstm")),
    ("scans", "stream bidirectional", ("p50_ms",), ("gru", "lstm")),
    ("scans", "stream bidirectional breakdown", ("tick_ms",),
     ("gru", "lstm")),
    ("scans", "stream bidirectional breakdown",
     ("device_share", "device_ms"), ("gru", "lstm")),
    ("ssm_stream", "stream", ("catchup_ticks_per_s",), ("ssm",)),
    ("ssm_stream", "stream", ("p50_ms",), ("ssm",)),
    ("ssm_stream", "stream breakdown", ("tick_ms",), ("ssm",)),
    ("ssm_stream", "stream breakdown", ("device_share", "busy_share"),
     ("ssm",)),
    ("ssm_stream", "stream breakdown", ("device_share", "device_ops"),
     ("ssm",)),
    ("pool", "pool", ("bucket64_p50_ms",), POOL_CELLS),
    ("pool", "pool", ("bucket64_p99_ms",), POOL_CELLS),
    ("pool", "pool", ("session_ticks_per_s",), POOL_CELLS),
    ("pool", "pool device share", ("wall_ms",), POOL_CELLS),
    ("pool", "pool device share", ("device_ms",), POOL_CELLS),
    ("pool", "pool device share", ("busy_share",), POOL_CELLS),
    ("pool", "pool device share", ("device_ops",), POOL_CELLS),
    ("attn_serve", "path backtest", ("rows_per_s",), ("attn",)),
    ("attn_serve", "path predictor", ("p50_ms",), ("attn",)),
    ("attn_serve", "path device share", ("backtest", "busy_share"),
     ("attn",)),
    ("attn_serve", "path device share", ("backtest", "flash_fwd_ms"),
     ("attn",)),
    ("fleet", "fleet ab", ("ticks_per_s",), ("gru", "ssm")),
    ("trace", "obs tracing cost", ("ratio_1pct",), ("gru",)),
    ("trace", "obs tracing cost", ("ratio_100pct",), ("gru",)),
    ("trace", "obs tracing cost", ("settings", "off", "median_ticks_per_s"),
     ("gru",)),
)


def run_one(root: str, paths) -> int:
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
        if set(paths) <= {"fleet", "trace"}:  # these need no warehouse
            if "fleet" in paths:
                fleet_ab(chip_smoke, torch)
            if "trace" in paths:
                trace_ab(chip_smoke, torch)
            return 0
        wh = chip_smoke.make_warehouse(tmp)
        if "scans" in paths:
            for cell in ("gru", "lstm"):
                chip_smoke.phase_path(wh, tmp, cell=cell)
                chip_smoke.phase_train(wh, tmp, cell=cell)
                chip_smoke.phase_stream(wh, cell=cell, bidirectional=True)
        if "ssm_stream" in paths:
            chip_smoke.phase_stream(wh, cell="ssm")
        if "pool" in paths:
            for cell in POOL_CELLS:
                chip_smoke.phase_pool(wh, cell=cell)
        if "attn_serve" in paths:
            chip_smoke.phase_path(wh, tmp, cell="attn")
        wh.close()
    if "fleet" in paths:
        fleet_ab(chip_smoke, torch)
    if "trace" in paths:
        trace_ab(chip_smoke, torch)
    return 0


def trace_ab(chip_smoke, torch) -> None:
    """The tree's own ``obs_trace_cost`` for gru, after one short warm-up
    load; a failed check is printed as a line, not raised."""
    from fmda_tpu_torch.models import build_model

    model_cfg = chip_smoke.model_config("gru", bidirectional=False,
                                        dropout=0.0)
    state = build_model(model_cfg, generator=torch.Generator().manual_seed(
        chip_smoke.SEED)).state_dict()
    chip_smoke.fleet_run(model_cfg, state, dict(n_sessions=8, n_ticks=2),
                         device="cuda", depth=1)
    try:
        chip_smoke.obs_trace_cost({"gru": (model_cfg, state)}, "cuda")
        verdict = "passed"
    except SystemExit as e:
        verdict = str(e)
    chip_smoke.emit("trace ab check", cell="gru", verdict=verdict)


def fleet_ab(chip_smoke, torch) -> None:
    """FLEET_AB_LOADS default fleet loads for gru and ssm through the
    tree's own ``fleet_run``, after one short warm-up load."""
    from fmda_tpu_torch.models import build_model

    for cell in ("gru", "ssm"):
        model_cfg = chip_smoke.model_config(cell, bidirectional=False,
                                            dropout=0.0)
        state = build_model(model_cfg, generator=torch.Generator(
        ).manual_seed(chip_smoke.SEED)).state_dict()
        chip_smoke.fleet_run(model_cfg, state,
                             dict(n_sessions=8, n_ticks=2), device="cuda",
                             depth=1)
        for load in range(FLEET_AB_LOADS):
            out = chip_smoke.fleet_run(
                model_cfg, state, chip_smoke.FLEET_LOADS["default"],
                device="cuda", depth=1)[0]
            chip_smoke.emit("fleet ab", cell=cell, load=load,
                            ticks_per_s=out["ticks_served"] / out["wall_s"])


def value(line: dict, keys):
    """The metric at ``keys`` in a phase line, None where it is missing."""
    if keys[-1] == "flash_fwd_ms":  # the forward kernel's profiled time
        share = line.get(keys[0], {})
        if "port_kernels_ms" in share:
            return share["port_kernels_ms"].get("flash_fwd_kernel", 0.0)
        return sum(ms for name, ms in share.get("top_kernels_ms", {}).items()
                   if "flash_fwd" in name)
    for k in keys:
        if not isinstance(line, dict) or k not in line:
            return None
        line = line[k]
    return line


def main(old: str, new: str, paths, rounds: int = 1) -> int:
    roots = {"old": os.path.abspath(old), "new": os.path.abspath(new)}
    lines = []
    for run, tree in enumerate(ORDER * rounds):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one",
             roots[tree], ",".join(paths)], capture_output=True, text=True,
            timeout=900)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        for ln in out.stdout.splitlines():
            if ln.startswith('{"phase"'):
                line = dict(json.loads(ln), tree=tree, run=run)
                lines.append(line)
                print(json.dumps(line), flush=True)
    for path, phase, keys, cells in METRICS:
        if path not in paths:
            continue
        for cell in cells:
            got = {tree: [value(ln, keys) for ln in lines
                          if ln["phase"] == phase and ln.get("cell") == cell
                          and ln["tree"] == tree] for tree in roots}
            print(json.dumps({"summary": phase, "metric": ".".join(keys),
                              "cell": cell, **got}), flush=True)
    return 0


def parse_paths(arg: str):
    paths = tuple(arg.split(","))
    unknown = set(paths) - set(PATHS)
    if unknown:
        raise SystemExit(f"unknown paths {sorted(unknown)}; choose from "
                         f"{PATHS}")
    return paths


if __name__ == "__main__":
    args = sys.argv[1:]
    if len(args) == 3 and args[0] == "--one":
        sys.exit(run_one(args[1], parse_paths(args[2])))
    paths, rounds = PATHS, 1
    while len(args) >= 4 and args[-2] in ("--paths", "--rounds"):
        if args[-2] == "--paths":
            paths = parse_paths(args[-1])
        else:
            rounds = int(args[-1])
        args = args[:-2]
    if len(args) != 2 or rounds < 1:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(args[0], args[1], paths, rounds))
