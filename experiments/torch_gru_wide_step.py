#!/usr/bin/env python3
"""The fused GRU step (``csrc/gru_wide_step.cu``) on the card: held to its
plain version at every layout its plan can take, then timed beside the
routes it replaces.

    python3 experiments/torch_gru_wide_step.py [--quick] [--profile]
                                               [--first-step N] [--out FILE]

First the library's plan against its Python copy (``gru_wide_step.
step_plan`` on the figures the query reports) and ptxas's registers and
spills of the kernel.  Then, at (B, 1024) bf16 for B in {1, 256, 512}
(``--quick``: 1 and 512): the kernel at every layout that lays the shape
out (one CTA a cluster, W_hh multicast over clusters of 2 along the
batch, K split over clusters of 2, 4, 8), masked and not, against
``gru_wide_step_reference`` on the same card tensors, a second call the
same bits; and the route's scan (``gru_wide_scan_fwd``, T = 30) both
directions against the same scan through the plain step.  Without
``--quick``, at those shapes and (256, 512) f32 (which the plan hands
back): a step's device ms (the fused kernel, its bound, the pair: the
``addmm`` and W1, each alone, and ``_thnn_fused_gru_cell`` in W1's
place); the route's scan forward and forward + backward, device ms (the
queue primed) and what a caller waits (unprimed), for the fused route,
the pair, the pair with ``_thnn_fused_gru_cell`` (its own autograd) and
cuDNN's layer; both per-step routes captured once into a CUDA graph and
replayed (a yardstick: the port captures no graph); and the route's scan
and gradients against a float64 scan beside the pair's
(``chip_smoke.gru_step_witness``).  ``--profile`` builds the kernel with
its clock marks (``-DFMDA_PROFILE_STEP``) and prints a step's split into
the ring's first slot, the product and the epilogue at B = 1, 256, 512
instead; ``--first-step N`` prints the gru wide path's first step on N
batches against the plain versions with the BLAS-order product, the
fused route's distance beside the pair's (``first_step_readings``),
instead.  One JSON line each, also written to FILE when ``--out`` names
one.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import statistics
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the repository root's timing helpers)

STEPS = 30
SHAPES = ((1, 1024, torch.bfloat16), (256, 1024, torch.bfloat16),
          (512, 1024, torch.bfloat16), (256, 512, torch.float32))
QUICK = ((512, 1024, torch.bfloat16), (1, 1024, torch.bfloat16))
PLAN_CASES = ((1, 1024), (16, 1024), (64, 1024), (128, 1024), (256, 1024),
              (483, 1024), (512, 1024), (800, 1024), (1, 2048), (512, 2048),
              (8, 512), (256, 512), (3, 48), (512, 96))
REPS = 10
PROFILE_RUNS = 50


def dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def layouts(batch, hidden):
    """Every plan that lays (batch, hidden) out: one CTA a cluster, W_hh
    multicast over 2 along an even number of batch tiles, K split over 2,
    4 or 8 CTAs."""
    from fmda_tpu_torch.ops.gru_wide_step import STEP_SMEM, STEP_TILE

    tiles_m, tiles_n = -(-batch // STEP_TILE), hidden // STEP_TILE
    k_steps = hidden // STEP_TILE
    out = []
    for mcast, split in ((1, 1), (2, 1), (1, 2), (1, 4), (1, 8)):
        if (mcast > 1 and tiles_m % 2) or k_steps % split:
            continue
        out.append(dict(tiles_m=tiles_m, tiles_n=tiles_n, mcast=mcast,
                        split=split, cluster=mcast * split,
                        k_steps=k_steps // split,
                        grid=tiles_m * tiles_n * split, smem=STEP_SMEM))
    return out


def step_operands(batch, hidden, gen, dev, masked):
    """One step's operands in bf16, xp_t a strided (B, 3H) view of a (B, T,
    3H) tensor, h_{t-1} a strided view of hs, as the route hands them."""
    def rand(*shape, s=1.0):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * s).to(torch.bfloat16)

    gh = 3 * hidden
    xp = rand(batch, STEPS, gh, s=2.0)
    hs = rand(batch, STEPS, hidden, s=0.5)
    w, b = rand(gh, hidden, s=hidden ** -0.5), rand(gh, s=hidden ** -0.5)
    mask = ((torch.rand(batch, generator=gen, device=dev) > 0.33)
            .to(torch.uint8) if masked else None)
    return xp[:, 3], hs[:, 2], w, b, mask


def check_step(batch, hidden, gen, dev):
    """The kernel at every layout, masked and not, against the plain step;
    a second call the same bits."""
    from fmda_tpu_torch.ops import gru_wide_step as st

    rows = []
    for plan in layouts(batch, hidden):
        for masked in (False, True):
            xp_t, h, w, b, mask = step_operands(batch, hidden, gen, dev,
                                                masked)
            out = torch.empty(batch, hidden, dtype=torch.bfloat16,
                              device=dev)
            with torch.inference_mode():
                got = st.gru_wide_step_fwd(xp_t, h, w, b, mask, out,
                                           plan).clone()
                again = st.gru_wide_step_fwd(xp_t, h, w, b, mask, out, plan)
                want = st.gru_wide_step_reference(xp_t, h, w, b, mask, plan)
                torch.cuda.synchronize()
            errs, rels = chip_smoke.persist_errors([got], [want])
            row = dict(batch=batch, hidden=hidden, plan=plan, masked=masked,
                       max_abs_err=errs[0], max_rel_err=rels[0],
                       bits_equal_share=float((got == want).float().mean()),
                       same_bits=torch.equal(got, again),
                       finite=bool(torch.isfinite(got.float()).all()))
            row["ok"] = (row["same_bits"] and row["finite"]
                         and chip_smoke.persist_agrees(row, torch.bfloat16))
            rows.append(row)
    return rows


def check_scan(batch, hidden, gen, dev):
    """The route's scan through the fused step against the same scan
    through the plain step, both directions, masked and not."""
    from fmda_tpu_torch.ops import wide_scan as ws

    rows = []
    for masked in (False, True):
        for reverse in (False, True):
            (xp, h0, w, b), _ = chip_smoke.wide_scan_inputs(
                "gru", batch, hidden, torch.bfloat16, gen, dev)
            mask = chip_smoke.persist_mask(batch, gen, dev) if masked else None
            with torch.inference_mode():
                got = ws.gru_wide_scan_fwd(xp, h0, w, b, reverse=reverse,
                                           mask=mask)
                with chip_smoke.plain_wide_gates():
                    want = ws.gru_wide_scan_fwd(xp, h0, w, b,
                                                reverse=reverse, mask=mask)
                torch.cuda.synchronize()
            errs, rels = chip_smoke.persist_errors(got, want)
            row = dict(batch=batch, hidden=hidden, masked=masked,
                       reverse=reverse, max_abs_err=max(errs),
                       max_rel_err=max(rels), rel_errs=rels)
            row["ok"] = chip_smoke.persist_agrees(row, torch.bfloat16)
            rows.append(row)
    return rows


def thnn_gru_scan(xp, h0, w, b):
    """The pair with ``_thnn_fused_gru_cell`` in W1's place, forward: an
    ``addmm`` and the cell a step (autograd gives its own backward)."""
    h, hs = h0, []
    for t in range(xp.shape[1]):
        hh = torch.addmm(b, h, w.t())
        h, _ = torch.ops.aten._thnn_fused_gru_cell(xp[:, t], hh, h, None, None)
        hs.append(h)
    return h, torch.stack(hs, dim=1)


def time_step(batch, hidden, dtype, gen, dev):
    """A step's device ms: the fused kernel (where the plan lays it out)
    beside its bound, and the pair: the addmm and W1 alone and together,
    and ``_thnn_fused_gru_cell`` in W1's place."""
    from fmda_tpu_torch.ops import gru_wide_step as st
    from fmda_tpu_torch.ops import wide_scan as ws
    from fmda_tpu_torch.ops.cost import gru_wide_step_bound

    itemsize = torch.tensor([], dtype=dtype).element_size()
    xp_t, h, w, b, _ = step_operands(batch, hidden, gen, dev, False)
    xp_t, h, w, b = (t.to(dtype) for t in (xp_t, h, w, b))
    out = torch.empty(batch, hidden, dtype=dtype, device=dev)
    hh = torch.empty(batch, 3 * hidden, dtype=dtype, device=dev)
    prime = dict(prime=True, prime_cycles=chip_smoke.PRIME_CYCLES, reps=REPS)
    plan = st.gru_wide_step_plan(batch, hidden, dtype, dev)
    row = dict(batch=batch, hidden=hidden, dtype=dtype_name(dtype), plan=plan)
    with torch.inference_mode():
        if plan is not None:
            h = h.contiguous()
            row["step_ms"] = chip_smoke.time_ms(
                lambda: st.gru_wide_step_fwd(xp_t, h, w, b, None, out, plan),
                **prime)
            row["bound_ms"], row["bound_by"] = gru_wide_step_bound(
                batch, hidden, itemsize, False)
        row["addmm_ms"] = chip_smoke.time_ms(
            lambda: torch.addmm(b, h, w.t(), out=hh), **prime)
        row["w1_ms"] = chip_smoke.time_ms(
            lambda: ws.gru_wide_gates(xp_t, hh, h, None, out), **prime)
        row["pair_ms"] = chip_smoke.time_ms(
            lambda: ws.gru_wide_gates(xp_t, torch.addmm(b, h, w.t(), out=hh),
                                      h, None, out), **prime)
        row["thnn_cell_ms"] = chip_smoke.time_ms(
            lambda: torch.ops.aten._thnn_fused_gru_cell(xp_t, hh, h, None,
                                                        None), **prime)
        row["thnn_pair_ms"] = chip_smoke.time_ms(
            lambda: torch.ops.aten._thnn_fused_gru_cell(
                xp_t, torch.addmm(b, h, w.t(), out=hh), h, None, None),
            **prime)
    return row


def time_route(batch, hidden, dtype, gen, dev, n_features):
    """A direction's scan, forward and forward + backward, device ms and
    what a caller waits: the fused route, the pair, the pair with
    ``_thnn_fused_gru_cell``, cuDNN's layer (projection included)."""
    from fmda_tpu_torch.ops import wide_scan as ws

    args, cots = chip_smoke.wide_scan_inputs("gru", batch, hidden, dtype,
                                             gen, dev, grad=True)
    detached = [a.detach() for a in args]
    routes = {"fused": ws.gru_wide_scan, "thnn": thnn_gru_scan}
    row = dict(batch=batch, steps=STEPS, hidden=hidden,
               dtype=dtype_name(dtype))
    primed = dict(prime=True, prime_cycles=chip_smoke.LIBRARY_PRIME_CYCLES,
                  reps=REPS)
    for name in ("fused", "pair", "thnn"):
        scan = routes.get(name, ws.gru_wide_scan)
        ctx = (chip_smoke.pair_gru() if name == "pair"
               else contextlib.nullcontext())

        def fwd():
            with torch.inference_mode():
                return scan(*detached)

        def fwd_bwd():
            return torch.autograd.grad(list(scan(*args)), args, cots)

        with ctx:
            row[f"{name}_ms"] = chip_smoke.time_ms(fwd, **primed)
            row[f"{name}_call_ms"] = chip_smoke.time_ms(fwd, prime=False,
                                                        reps=REPS)
            row[f"{name}_fwd_bwd_ms"] = chip_smoke.time_ms(fwd_bwd, **primed)
            row[f"{name}_fwd_bwd_call_ms"] = chip_smoke.time_ms(
                fwd_bwd, prime=False, reps=REPS)
    spec = next(s for s in chip_smoke.scan_specs() if s.name == "gru")
    lib, x = chip_smoke.library_layer(
        spec, dict(batch=batch, steps=STEPS, hidden=hidden, dtype=dtype),
        n_features, gen, dev, grad=True)
    with torch.inference_mode():
        row["cudnn_ms"] = chip_smoke.time_ms(lambda: lib(x), **primed)
    probe = lib(x)
    cot = [torch.rand_like(probe[0]) * 0.1, torch.rand_like(probe[1]) * 0.1]
    row["cudnn_fwd_bwd_ms"] = chip_smoke.time_ms(
        lambda: torch.autograd.grad(list(lib(x)), [x, *lib.parameters()],
                                    cot), **primed)
    return row


def time_graphs(batch, hidden, gen, dev):
    """Both per-step routes (the fused step; the pair) captured once into a
    CUDA graph, forward and forward + backward, then replayed: device ms
    and what a caller waits, and the replay's outputs against the route
    uncaptured."""
    from fmda_tpu_torch.ops import wide_scan as ws

    args, cots = chip_smoke.wide_scan_inputs("gru", batch, hidden,
                                             torch.bfloat16, gen, dev,
                                             grad=True)
    detached = [a.detach() for a in args]

    def fwd():
        with torch.no_grad():
            return list(ws.gru_wide_scan(*detached))

    def fwd_bwd():
        h, hs = ws.gru_wide_scan(*args)
        return [h.detach(), hs.detach(),
                *torch.autograd.grad([h, hs], args, cots)]

    row = dict(batch=batch, steps=STEPS, hidden=hidden, dtype="bfloat16")
    for route in ("fused", "pair"):
        ctx = (chip_smoke.pair_gru() if route == "pair"
               else contextlib.nullcontext())
        with ctx:
            for name, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    for _ in range(3):
                        fn()
                torch.cuda.current_stream().wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    static = fn()
                graph.replay()
                want = fn()
                torch.cuda.synchronize()
                key = f"graph_{route}_{name}"
                row[f"{key}_same_bits"] = all(
                    torch.equal(g, w_) for g, w_ in zip(static, want))
                row[f"{key}_ms"] = chip_smoke.time_ms(
                    graph.replay, prime=True,
                    prime_cycles=chip_smoke.LIBRARY_PRIME_CYCLES, reps=REPS)
                row[f"{key}_call_ms"] = chip_smoke.time_ms(
                    graph.replay, prime=False, reps=REPS)
                del graph, static
    return row


def profile_step(batch, hidden, gen, dev):
    """The kernel built with -DFMDA_PROFILE_STEP: CTA 0's clock marks of a
    step, medians over PROFILE_RUNS launches, in microseconds from the
    consumers' start: the first slot landed, the product done, the
    epilogue done; the copy warp past its wait for the previous grid, its
    last issue; the CTA's end."""
    from fmda_tpu_torch.ops import _cuda_lib
    from fmda_tpu_torch.ops import gru_wide_step as st

    lib = _cuda_lib.load()
    xp_t, h, w, b, _ = step_operands(batch, hidden, gen, dev, False)
    h = h.contiguous()
    out = torch.empty_like(h)
    plan = st.gru_wide_step_plan(batch, hidden, torch.bfloat16, dev)
    buf = (ctypes.c_ulonglong * 8)()
    marks = {k: [] for k in ("first_slot", "product", "epilogue",
                             "copy_ready", "copy_last", "end")}
    with torch.inference_mode():
        for _ in range(PROFILE_RUNS):
            st.gru_wide_step_fwd(xp_t, h, w, b, None, out, plan)
            torch.cuda.synchronize()
            _cuda_lib.raise_on(lib, lib.fmda_step_prof(buf), "profile")
            t0 = buf[0]
            for k, col in (("first_slot", 1), ("product", 2),
                           ("epilogue", 3), ("copy_ready", 4),
                           ("copy_last", 5), ("end", 6)):
                marks[k].append((buf[col] - t0) / 1e3)
    return dict(batch=batch, hidden=hidden, plan=plan,
                **{f"{k}_us": statistics.median(v) for k, v in marks.items()})


def first_step_readings(dev, n_batches: int) -> list:
    """The gru wide path's first step (``chip_smoke.wide_trainer``'s
    flagship_wide set-up, seed 0) on its first ``n_batches`` training
    batches, each with the dropout generator where the last left it:
    ``chip_smoke.first_step_blas``'s distances of the fused route and the
    pair from the plain versions with the BLAS-order product, the readings
    ``chip_smoke.FIRST_STEP_RMS_RATIO`` is set from."""
    import tempfile

    from fmda_tpu_torch.data.pipeline import WindowBatches

    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        _, _, train_cfg, wh, trainer, dataset = chip_smoke.wide_trainer(
            tmp, str(dev), "gru")
        train_chunks = dataset.split(train_cfg.val_size,
                                     train_cfg.test_size)[0]
        state = trainer.init_state()
        names = [n for n, q in state.model.named_parameters()
                 if q.requires_grad]
        batches = (b for i in train_chunks
                   for b in WindowBatches(dataset, i, train_cfg.batch_size))
        for index, host in zip(range(n_batches), batches):
            batch = trainer.place(host)
            rng = state.generator.get_state()
            loss_k, grads_k = chip_smoke.wide_grads(trainer, state, batch,
                                                    rng)
            row = chip_smoke.first_step_blas(trainer, state, batch, rng,
                                             loss_k, grads_k)
            rows.append(dict(batch_index=index, valid=int(host.mask.sum()),
                             params=names, **row))
        wh.close()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="build with -DFMDA_PROFILE_STEP and print the step "
                    "profile only")
    ap.add_argument("--first-step", type=int, default=0, metavar="N",
                    help="print the first-step readings on N batches only")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_gru_wide_step: no CUDA device", file=sys.stderr)
        return 2
    from fmda_tpu_torch.config import FrameworkConfig
    from fmda_tpu_torch.ops import _cuda_lib
    from fmda_tpu_torch.ops import gru_wide_step as st

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = open(args.out, "w") if args.out else None

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()

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
            plan, figures = st.step_plan_query(batch, hidden, dtype, 0)
            mirror = st.step_plan(
                batch, hidden, torch.tensor([], dtype=dtype).element_size(),
                **figures)
            ok &= mirror == plan
            emit({"phase": "plan", "batch": batch, "hidden": hidden,
                  "dtype": dtype_name(dtype), "plan": plan,
                  "mirror_same": mirror == plan, "figures": figures})
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.first_step:
        rows = first_step_readings(dev, args.first_step)
        for row in rows:
            emit({"phase": "first_step", **row})
        emit({"phase": "first_step_summary",
              "pooled_ratio_max": max(r["pooled_ratio"] for r in rows),
              "rms_ratio_max": max(max(r["rms_ratio"]) for r in rows),
              "bound": chip_smoke.FIRST_STEP_RMS_RATIO})
        return 0
    if args.profile:
        for batch in (1, 256, 512):
            emit({"phase": "profile", **profile_step(batch, 1024, gen, dev)})
        return 0
    shapes = QUICK if args.quick else SHAPES
    for batch, hidden, dtype in shapes:
        if dtype != torch.bfloat16:
            continue
        for row in check_step(batch, hidden, gen, dev) + check_scan(
                batch, hidden, gen, dev):
            ok &= row["ok"]
            emit({"phase": "check", **row})
    for batch, hidden, dtype in shapes:
        emit({"phase": "step", **time_step(batch, hidden, dtype, gen, dev)})
    if not args.quick:
        n_features = FrameworkConfig().model.n_features
        for batch, hidden, dtype in SHAPES:
            emit({"phase": "route", **time_route(batch, hidden, dtype, gen,
                                                 dev, n_features)})
        for batch, hidden, _ in SHAPES[:3]:
            row = time_graphs(batch, hidden, gen, dev)
            ok &= all(v for k, v in row.items() if k.endswith("same_bits"))
            emit({"phase": "graph", **row})
        for batch, hidden, _ in SHAPES[:3]:
            for masked in (False, True):
                row = chip_smoke.gru_step_witness(batch, hidden,
                                                  torch.bfloat16, masked,
                                                  gen, dev)
                emit({"phase": "witness", **row})
    emit({"phase": "done", "ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
