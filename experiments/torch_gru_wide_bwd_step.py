#!/usr/bin/env python3
"""The fused GRU backward step (``csrc/gru_wide_bwd_step.cu``) on the card:
held to its plain version at every layout its plan can take, at both tile
widths, then timed beside the route it replaces.

    python3 experiments/torch_gru_wide_bwd_step.py [--quick] [--profile]
        [--train-ab PARENT [--rounds N]] [--out FILE]

First the library's plan against its Python copy (``gru_wide_bwd_step.
bwd_step_plan`` on the figures the query reports) and ptxas's registers
and spills of the kernel.  Then, at (B, 1024) bf16 for B in {1, 256, 483,
512} (tiles of 128 units) and at (3, 192) and (512, 192) (of 64;
``--quick``: (512, 1024), (1, 1024), (512, 192)): the kernel at every
layout that lays the shape out (one CTA a cluster, W_hh^T multicast over clusters of 2 along
the batch, K split over clusters of 2, 4, 8), masked and not, a step with
a product and a direction's first step (none), against
``gru_wide_bwd_step_reference`` on the same card tensors, a second call the
same bits; and the route's backward (``gru_wide_scan_bwd``, T = 30) both
directions, masked and not, against the same backward through the plain
versions.  Without ``--quick``, at (512, 30, 1024) and (1, 30, 1024) bf16:
a backward direction's device ms (the queue primed) and what a caller
waits (unprimed) through the fused step, through the pair it replaced (W2
and a cuBLAS ``mm`` a step), and both captured once into a CUDA graph and
replayed (a yardstick: the port captures no graph); a lone step and a step
of a sweep of each.  ``--profile`` builds the kernel with its clock marks
(``-DFMDA_PROFILE_STEP``) and prints a step's split into the ring's first
slot, the product and the epilogue at B = 1, 256, 512 instead.
``--train-ab PARENT`` runs ``experiments/torch_wide_train_step.py`` (a
``flagship_wide`` gru training step) on the package unpacked at PARENT and
on this checkout in turns, parent, change, change, parent, ``--rounds``
times (default 3), instead.  One JSON line each, also written to FILE when
``--out`` names one.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the repository root's timing helpers)

STEPS = 30
HIDDEN = 1024
#: (batch, hidden): the tile of 128 units at H = 1024, of 64 at H = 192
CHECK_SHAPES = ((1, 1024), (256, 1024), (483, 1024), (512, 1024), (3, 192),
                (512, 192))
QUICK = ((512, 1024), (1, 1024), (512, 192))
TIME_BATCHES = (512, 1)
PLAN_CASES = ((1, 1024), (16, 1024), (64, 1024), (128, 1024), (256, 1024),
              (483, 1024), (512, 1024), (800, 1024), (1, 2048), (512, 2048),
              (8, 512), (256, 512), (3, 48), (512, 96))
REPS = 10
PROFILE_RUNS = 50


def layouts(batch, hidden):
    """Every plan that lays (batch, hidden) out: tiles of 64 units, one CTA
    a cluster, W_hh^T multicast over 2 along an even number of batch tiles,
    K = 3 H split over 2, 4 or 8 CTAs; where H is a multiple of 128, tiles
    of 128 units with K split over 2, 4 or 8."""
    from fmda_tpu_torch.ops.gru_wide_bwd_step import bwd_smem

    tiles_m, k_total = -(-batch // 64), 3 * hidden // 64
    out = []
    for units, mcast, split in ((64, 1, 1), (64, 2, 1), (64, 1, 2),
                                (64, 1, 4), (64, 1, 8), (128, 1, 2),
                                (128, 1, 4), (128, 1, 8)):
        if ((mcast > 1 and tiles_m % 2) or k_total % split
                or hidden % units):
            continue
        out.append(dict(tiles_m=tiles_m, tiles_n=hidden // units,
                        mcast=mcast, split=split, cluster=mcast * split,
                        k_steps=k_total // split,
                        grid=tiles_m * hidden // units * split,
                        smem=bwd_smem(units)))
    return out


def check_step(batch, hidden, gen, dev):
    """The kernel at every layout, masked and not, with a product (step 0
    of a two-step direction) and without (a direction's first step),
    against the plain step; a second call the same bits."""
    from fmda_tpu_torch.ops import gru_wide_bwd_step as bw

    rows = []
    for plan in layouts(batch, hidden):
        for masked in (False, True):
            for t_next in (1, None):
                ops, _ = chip_smoke.bwd_direction(batch, hidden, 2, masked,
                                                  gen, dev)
                xp, hh, hp, dhs, mask, w_t, direct, dg = ops
                direct0 = direct.clone()

                def call():
                    direct.copy_(direct0)
                    bw.gru_wide_bwd_step(*ops, 0, t_next, plan)
                    return [dg[:, 0].clone(), direct.clone()]

                with torch.inference_mode():
                    got = call()
                    again = call()
                    want = list(bw.gru_wide_bwd_step_reference(
                        xp[:, 0], hh[:, 0], hp[:, 0], direct0,
                        None if t_next is None else bw.dhh_of(dg[:, 1]), w_t,
                        dhs[:, 0], None if mask is None else mask[:, 0],
                        plan))
                    torch.cuda.synchronize()
                errs, rels = chip_smoke.persist_errors(got, want)
                row = dict(batch=batch, hidden=hidden, plan=plan,
                           masked=masked, product=t_next is not None,
                           max_abs_err=max(errs), max_rel_err=max(rels),
                           bits_equal_share=float(
                               (got[0] == want[0]).float().mean()),
                           same_bits=all(torch.equal(g, a)
                                         for g, a in zip(got, again)),
                           finite=all(bool(torch.isfinite(g.float()).all())
                                      for g in got))
                row["ok"] = (row["same_bits"] and row["finite"]
                             and chip_smoke.persist_agrees(row,
                                                           torch.bfloat16))
                rows.append(row)
    return rows


def check_scan(batch, hidden, gen, dev):
    """The route's backward through the fused step against the same
    backward through the plain versions, both directions, masked and not:
    each gradient within 2e-2 of its largest entry."""
    from fmda_tpu_torch.ops import wide_scan as ws

    rows = []
    for masked in (False, True):
        for reverse in (False, True):
            (xp, h0, w, b), cots = chip_smoke.wide_scan_inputs(
                "gru", batch, hidden, torch.bfloat16, gen, dev)
            mask = chip_smoke.persist_mask(batch, gen, dev) if masked else None
            with torch.inference_mode():
                _, hs = ws.gru_wide_scan_fwd(xp, h0, w, b, reverse=reverse,
                                             mask=mask)
                args = (xp, h0, w, b, hs, cots[0], cots[1])
                got = ws.gru_wide_scan_bwd(*args, reverse=reverse, mask=mask)
                with chip_smoke.plain_wide_gates():
                    want = ws.gru_wide_scan_bwd(*args, reverse=reverse,
                                                mask=mask)
                torch.cuda.synchronize()
            errs, rels = chip_smoke.persist_errors(got, want)
            row = dict(batch=batch, hidden=hidden, masked=masked,
                       reverse=reverse, max_abs_err=max(errs),
                       max_rel_err=max(rels), rel_errs=rels)
            # relative to each gradient's largest entry (dW_hh sums B T
            # rows), as chip_smoke's ``wide bwd step scan``
            row["ok"] = max(rels) <= chip_smoke.BF16_TOL
            rows.append(row)
    return rows


def time_directions(batch, hidden, gen, dev):
    """A backward direction (``gru_wide_scan_bwd`` at T = 30: the
    recomputed hh, the sweep, dh0 and the weight gradients): device ms and
    a caller's wait through the fused step and through the pair, each also
    captured into a CUDA graph and replayed (the replay's outputs against
    the uncaptured call's, bit for bit)."""
    from fmda_tpu_torch.ops import wide_scan as ws

    (xp, h0, w, b), cots = chip_smoke.wide_scan_inputs(
        "gru", batch, hidden, torch.bfloat16, gen, dev)
    primed = dict(prime=True, prime_cycles=chip_smoke.LIBRARY_PRIME_CYCLES,
                  reps=REPS)
    with torch.inference_mode():
        _, hs = ws.gru_wide_scan_fwd(xp, h0, w, b)
    args = (xp, h0, w, b, hs, cots[0], cots[1])

    def bwd():
        with torch.inference_mode():
            return list(ws.gru_wide_scan_bwd(*args))

    row = dict(batch=batch, steps=STEPS, hidden=hidden, dtype="bfloat16")
    for route in ("fused", "pair"):
        ctx = (chip_smoke.pair_gru_bwd() if route == "pair"
               else contextlib.nullcontext())
        with ctx:
            row[f"{route}_bwd_ms"] = chip_smoke.time_ms(bwd, **primed)
            row[f"{route}_bwd_call_ms"] = chip_smoke.time_ms(
                bwd, prime=False, reps=REPS)
            try:
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    for _ in range(3):
                        bwd()
                torch.cuda.current_stream().wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    static = bwd()
                graph.replay()
                want = bwd()
                torch.cuda.synchronize()
                key = f"graph_{route}_bwd"
                row[f"{key}_same_bits"] = all(
                    torch.equal(g, x) for g, x in zip(static, want))
                row[f"{key}_ms"] = chip_smoke.time_ms(graph.replay, **primed)
                row[f"{key}_call_ms"] = chip_smoke.time_ms(
                    graph.replay, prime=False, reps=REPS)
                del graph, static
            except RuntimeError as exc:  # a capture the card refuses
                row[f"graph_{route}_bwd_error"] = str(exc)[:300]
    return row


def time_steps(batch, hidden, gen, dev):
    """A lone step and a step of a sweep (``chip_smoke.bwd_step_times``,
    ``bwd_sweep_times``) beside the bound."""
    from fmda_tpu_torch.ops import gru_wide_bwd_step as bw
    from fmda_tpu_torch.ops.cost import gru_wide_bwd_step_bound

    ops, w = chip_smoke.bwd_direction(batch, hidden, 2, False, gen, dev)
    xp, hh, hp, dhs, _, w_t, direct, dg = ops
    direct0 = direct.clone()
    plan = bw.gru_wide_bwd_step_plan(batch, hidden, torch.bfloat16, dev)

    def call():
        direct.copy_(direct0)
        bw.gru_wide_bwd_step(*ops, 0, 1, plan)

    def plain():
        return bw.gru_wide_bwd_step_reference(
            xp[:, 0], hh[:, 0], hp[:, 0], direct0, bw.dhh_of(dg[:, 1]), w_t,
            dhs[:, 0], None, plan)

    row = dict(batch=batch, hidden=hidden, plan=plan)
    with torch.inference_mode():
        row.update(chip_smoke.bwd_step_times(ops, w, call, plain))
    row["bound_ms"], row["bound_by"] = gru_wide_bwd_step_bound(
        batch, hidden, 2, False)
    row.update(chip_smoke.bwd_sweep_times(batch, hidden, gen, dev))
    return row


def profile_step(batch, hidden, gen, dev):
    """The kernel built with -DFMDA_PROFILE_STEP: CTA 0's clock marks of a
    step with a product, medians over PROFILE_RUNS launches, in
    microseconds from the consumers' start: the first slot landed, the
    product done, the epilogue done; the copy warp past its wait for the
    previous grid, its last issue; the consumers' end."""
    from fmda_tpu_torch.ops import _cuda_lib
    from fmda_tpu_torch.ops import gru_wide_bwd_step as bw

    lib = _cuda_lib.load()
    ops, _ = chip_smoke.bwd_direction(batch, hidden, 2, False, gen, dev)
    plan = bw.gru_wide_bwd_step_plan(batch, hidden, torch.bfloat16, dev)
    buf = (ctypes.c_ulonglong * 8)()
    marks = {k: [] for k in ("first_slot", "product", "epilogue",
                             "copy_ready", "copy_last", "end")}
    with torch.inference_mode():
        for _ in range(PROFILE_RUNS):
            bw.gru_wide_bwd_step(*ops, 0, 1, plan)
            torch.cuda.synchronize()
            _cuda_lib.raise_on(lib, lib.fmda_bwd_step_prof(buf), "profile")
            t0 = buf[0]
            for k, col in (("first_slot", 1), ("product", 2),
                           ("epilogue", 3), ("copy_ready", 4),
                           ("copy_last", 5), ("end", 6)):
                marks[k].append((buf[col] - t0) / 1e3)
    return dict(batch=batch, hidden=hidden, plan=plan,
                **{f"{k}_us": statistics.median(v) for k, v in marks.items()})


def train_ab(parent: str, rounds: int, emit) -> None:
    """``torch_wide_train_step.py`` on the parent and on this checkout in
    turns (parent, change, change, parent), ``rounds`` times, one process
    each: each run's line, then the medians of each side."""
    script = os.path.join(REPO, "experiments", "torch_wide_train_step.py")
    sides = {"parent": os.path.abspath(parent), "change": REPO}
    runs = {k: [] for k in sides}
    for _ in range(rounds):
        for side in ("parent", "change", "change", "parent"):
            out = subprocess.run(
                [sys.executable, script, "--root", sides[side]],
                capture_output=True, text=True, timeout=600)
            line = json.loads(out.stdout.strip().splitlines()[-1])
            runs[side].append(line)
            emit({"phase": "train_step", "side": side, **line})
    emit({"phase": "train_ab", **{
        f"{side}_{k}": statistics.median(r[k] for r in rs)
        for side, rs in runs.items() for k in ("device_ms", "wait_ms")},
        "pairs_change_faster": sum(
            c["wait_ms"] < p["wait_ms"]
            for c, p in zip(runs["change"], runs["parent"]))})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="build with -DFMDA_PROFILE_STEP and print the step "
                    "profile only")
    ap.add_argument("--train-ab", metavar="PARENT",
                    help="time a flagship_wide gru training step on the "
                    "package at PARENT and on this checkout, in turns")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_gru_wide_bwd_step: no CUDA device", file=sys.stderr)
        return 2
    from fmda_tpu_torch.ops import _cuda_lib
    from fmda_tpu_torch.ops import gru_wide_bwd_step as bw

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = open(args.out, "w") if args.out else None

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()

    if args.train_ab:
        emit({"phase": "card", "card": chip_smoke.card_line()})
        train_ab(args.train_ab, args.rounds, emit)
        return 0
    defines = ["FMDA_PROFILE_STEP"] if args.profile else []
    _cuda_lib.NVCC_FLAGS = _cuda_lib.NVCC_FLAGS + tuple(
        f"-D{name}" for name in defines)
    _cuda_lib.build()
    ptxas = chip_smoke.ptxas_summary(str(_cuda_lib.build_info.get("log", "")))
    emit({"phase": "build", "card": chip_smoke.card_line(),
          "defines": defines,
          "nvcc_seconds": _cuda_lib.build_info.get("seconds"),
          "ptxas": {k: v for k, v in ptxas["ptxas"].items()
                    if "step" in k}})
    ok = True
    dev = torch.device("cuda")
    for batch, hidden in PLAN_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            plan, figures = bw.bwd_step_plan_query(batch, hidden, dtype, 0)
            mirror = bw.bwd_step_plan(
                batch, hidden, torch.tensor([], dtype=dtype).element_size(),
                **figures)
            ok &= mirror == plan
            emit({"phase": "plan", "batch": batch, "hidden": hidden,
                  "dtype": str(dtype).replace("torch.", ""), "plan": plan,
                  "mirror_same": mirror == plan, "figures": figures})
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.profile:
        for batch in (1, 256, 512):
            emit({"phase": "profile", **profile_step(batch, HIDDEN, gen,
                                                     dev)})
        return 0
    for batch, hidden in (QUICK if args.quick else CHECK_SHAPES):
        for row in check_step(batch, hidden, gen, dev) + check_scan(
                batch, hidden, gen, dev):
            ok &= row["ok"]
            emit({"phase": "check", **row})
    if not args.quick:
        for batch in TIME_BATCHES:
            emit({"phase": "step", **time_steps(batch, HIDDEN, gen, dev)})
            row = time_directions(batch, HIDDEN, gen, dev)
            ok &= all(v for k, v in row.items() if k.endswith("same_bits"))
            emit({"phase": "direction", **row})
    emit({"phase": "done", "ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
