#!/usr/bin/env python3
"""The persistent LSTM scans (``csrc/lstm_persist.cu``) on the card: each
held to its plain version, then timed beside the per-step route they
replace.

    python3 experiments/torch_lstm_persist.py [--quick] [--profile]
                                              [--out FILE]

First the library's plan against its Python copy (``_cuda_lib.
persist_plan`` on the figures the query reports) and ptxas's registers
and spills of the kernels.  Then, at (B, 1024) bf16 for B in {1, 256,
512} and (256, 512) f32 (``--quick``: (512, 1024) bf16, (256, 512) f32
and (1, 1024) bf16, no times), T = 30: the forward (``lstm_persist_fwd``)
and the backward sweep (``lstm_persist_bwd``) against
``lstm_persist_scan_reference`` / ``lstm_persist_sweep_reference`` on the
same card tensors, masked and not, both directions, every output, a
second call the same bits.  Without ``--quick``, one line a shape: the
persistent route's scan (``lstm_wide_scan``) forward and forward +
backward, device ms (the queue primed) and what a caller waits (unprimed),
beside the same scan through the per-step kernels (the plan forced off:
W3 and W4, a cuBLAS product a step), each kernel's own device ms, its
bound (``scan_bound`` for the forward, ``persist_sweep_bound`` for the
sweep) and the L2 bytes a step its plan reads; then the kernels at each
cluster size the card allows for the shape (a plan made as if only that
size existed), their outputs against the chosen plan's; then the
route's scan and gradients through the persistent and through the
per-step kernels against a float64 scan (``chip_smoke.persist_witness``),
masked and not; then the per-step route captured once into a CUDA graph
and replayed (``time_graphs``: a yardstick, the port captures no graph)
at B = 1, 256, 512.  One JSON line each, also written to FILE when
``--out`` names one.
``--profile`` builds the kernels with their step profile and prints it
instead (``profile_steps``).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the repository root's timing helpers)
from fmda_tpu_torch.ops.cost import persist_l2_bytes  # noqa: E402

STEPS = 30
SHAPES = ((1, 1024, torch.bfloat16), (256, 1024, torch.bfloat16),
          (512, 1024, torch.bfloat16), (256, 512, torch.float32))
QUICK = ((512, 1024, torch.bfloat16), (256, 512, torch.float32),
         (1, 1024, torch.bfloat16))
REPS = 10


def dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def scan_inputs(batch, hidden, dtype, gen, dev, masked):
    gh = 4 * hidden

    def rand(*shape, s=1.0):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * s).to(dtype)

    xp = rand(batch, STEPS, gh, s=2.0)
    h0, c0 = rand(batch, hidden, s=0.5), rand(batch, hidden, s=0.5)
    w = rand(gh, hidden, s=hidden ** -0.5)
    b = rand(gh, s=hidden ** -0.5)
    mask = None
    if masked:
        lengths = torch.randint(1, STEPS + 1, (batch,), generator=gen,
                                device=dev)
        mask = (torch.arange(STEPS, device=dev)[None, :]
                < lengths[:, None]).to(torch.uint8)
    return xp, h0, c0, w, b, mask


def max_err(got, want):
    return max((g.float() - w.float()).abs().max().item()
               for g, w in zip(got, want))


def check_kernels(batch, hidden, dtype, gen, dev):
    """Each kernel against its plain version, masked and not, both
    directions; a second call the same bits."""
    from fmda_tpu_torch.ops import wide_scan as ws
    from fmda_tpu_torch.ops.scan_dw import h_prev_of

    plan = ws.lstm_persist_plan(batch, hidden, dtype, dev)
    tol = chip_smoke.F32_TOL if dtype == torch.float32 else chip_smoke.BF16_TOL
    rows = []
    for masked in (False, True):
        for reverse in (False, True):
            xp, h0, c0, w, b, mask = scan_inputs(batch, hidden, dtype, gen,
                                                 dev, masked)
            with torch.inference_mode():
                got = ws.lstm_persist_fwd(xp, h0, c0, w, b, plan,
                                          reverse=reverse, mask=mask)
                again = ws.lstm_persist_fwd(xp, h0, c0, w, b, plan,
                                            reverse=reverse, mask=mask)
                want = ws.lstm_persist_scan_reference(
                    xp, h0, c0, w, b, plan, reverse=reverse, mask=mask)
                hs, cs = want
                hh = ws._recompute_hh(h_prev_of(h0, hs, reverse=reverse),
                                      w, b)
                dhs = (torch.rand(hs.shape, generator=gen, device=dev)
                       * 0.2 - 0.1).to(dtype)
                dh_last = torch.rand(h0.shape, generator=gen,
                                     device=dev) * 0.2 - 0.1
                dc_last = torch.rand(h0.shape, generator=gen,
                                     device=dev) * 0.2 - 0.1
                args = (xp, hh, c0, cs, w, dhs, dh_last, dc_last, plan)
                bgot = ws.lstm_persist_bwd(*args, reverse=reverse, mask=mask)
                bagain = ws.lstm_persist_bwd(*args, reverse=reverse,
                                             mask=mask)
                bwant = ws.lstm_persist_sweep_reference(
                    *args, reverse=reverse, mask=mask)
                torch.cuda.synchronize()
            ferrs, frels = chip_smoke.persist_errors(got, want)
            berrs, brels = chip_smoke.persist_errors(bgot, bwant)
            row = dict(
                batch=batch, hidden=hidden, dtype=dtype_name(dtype),
                masked=masked, reverse=reverse, tol=tol,
                max_abs_cs=want[1].float().abs().max().item(),
                fwd_max_abs_err=max(ferrs), fwd_rel_errs=frels,
                bwd_max_abs_err=max(berrs), bwd_errs=berrs,
                bwd_rel_errs=brels,
                fwd_same_bits=all(torch.equal(g, a)
                                  for g, a in zip(got, again)),
                bwd_same_bits=all(torch.equal(g, a)
                                  for g, a in zip(bgot, bagain)),
                finite=all(bool(torch.isfinite(t.float()).all())
                           for t in (*got, *bgot)))
            row["ok"] = (row["finite"] and row["fwd_same_bits"]
                         and row["bwd_same_bits"] and all(
                             chip_smoke.persist_agrees(
                                 dict(max_abs_err=max(e), max_rel_err=max(r)),
                                 dtype)
                             for e, r in ((ferrs, frels), (berrs, brels))))
            rows.append(row)
    return plan, rows


class per_step_route:
    """Inside, the LSTM route's plan is forced off: every scan runs the
    per-step kernels (W3, W4)."""

    def __enter__(self):
        from fmda_tpu_torch.ops import wide_scan as ws

        self._saved = ws.lstm_persist_plan
        ws.lstm_persist_plan = lambda *a, **k: None
        return self

    def __exit__(self, *exc):
        from fmda_tpu_torch.ops import wide_scan as ws

        ws.lstm_persist_plan = self._saved
        return False


def time_shape(batch, hidden, dtype, gen, dev):
    """The route's scan, persistent and per-step, forward and with its
    backward; the kernels alone; bounds and L2 bytes."""
    from fmda_tpu_torch.ops import wide_scan as ws
    from fmda_tpu_torch.ops.cost import (
        persist_sweep_bound, scan_bound, scan_bwd_bound)
    from fmda_tpu_torch.ops.scan_dw import h_prev_of

    itemsize = torch.tensor([], dtype=dtype).element_size()
    plan = ws.lstm_persist_plan(batch, hidden, dtype, dev)
    xp, h0, c0, w, b, _ = scan_inputs(batch, hidden, dtype, gen, dev, False)
    args = [t.requires_grad_() for t in (xp, h0, c0, w, b)]
    with torch.no_grad():
        outs = ws.lstm_wide_scan(*args)
    cots = [torch.rand_like(t) * 0.2 - 0.1 for t in (*outs[0], outs[1])]

    def fwd():
        with torch.inference_mode():
            return ws.lstm_wide_scan(*[a.detach() for a in args])

    def fwd_bwd():
        (h, c), hs = ws.lstm_wide_scan(*args)
        return torch.autograd.grad([h, c, hs], args, cots)

    def timed(prefix):
        prime = dict(prime=True, prime_cycles=chip_smoke.LIBRARY_PRIME_CYCLES,
                     reps=REPS)
        return {f"{prefix}fwd_ms": chip_smoke.time_ms(fwd, **prime),
                f"{prefix}fwd_call_ms": chip_smoke.time_ms(fwd, prime=False,
                                                           reps=REPS),
                f"{prefix}fwd_bwd_ms": chip_smoke.time_ms(fwd_bwd, **prime),
                f"{prefix}fwd_bwd_call_ms": chip_smoke.time_ms(
                    fwd_bwd, prime=False, reps=REPS)}

    row = dict(batch=batch, steps=STEPS, hidden=hidden,
               dtype=dtype_name(dtype), plan=plan)
    row.update(timed(""))
    with per_step_route():
        row.update(timed("per_step_"))
    with torch.inference_mode():
        d = [a.detach() for a in args]
        hs, cs = ws.lstm_persist_fwd(*d, plan)
        hh = ws._recompute_hh(h_prev_of(d[1], hs), d[3], d[4])
        dhs = cots[2].detach()
        sweep = (d[0], hh, d[2], cs, d[3], dhs, cots[0].float(),
                 cots[1].float(), plan)
        prime = dict(prime=True, prime_cycles=chip_smoke.PRIME_CYCLES,
                     reps=REPS)
        row["kernel_fwd_ms"] = chip_smoke.time_ms(
            lambda: ws.lstm_persist_fwd(*d, plan), **prime)
        row["kernel_bwd_ms"] = chip_smoke.time_ms(
            lambda: ws.lstm_persist_bwd(*sweep), **prime)
    shapes = dict(gates=4, states=2, elementwise=14)
    row["fwd_bound_ms"], row["fwd_bound_by"] = scan_bound(
        batch, STEPS, hidden, itemsize, False, **shapes)
    row["sweep_bound_ms"], row["sweep_bound_by"] = persist_sweep_bound(
        batch, STEPS, hidden, itemsize, False)
    shapes["elementwise"] = 40
    row["bwd_bound_ms"], _ = scan_bwd_bound(batch, STEPS, hidden, itemsize,
                                            False, **shapes)
    row["l2_bytes_step_fwd"] = persist_l2_bytes(plan, batch, hidden,
                                                 itemsize, False)
    row["l2_bytes_step_bwd"] = persist_l2_bytes(plan, batch, hidden,
                                                 itemsize, True)
    return row


def time_layouts(batch, hidden, dtype, gen, dev):
    """The kernels at every cluster size the card allows for this shape
    (the plan made as if only that size existed, run on the real card),
    each against the chosen plan's outputs (the same bits where the
    layouts split K alike; within the kernels' tolerance), with the L2
    bytes a step it reads."""
    from fmda_tpu_torch.ops import _cuda_lib
    from fmda_tpu_torch.ops import wide_scan as ws
    from fmda_tpu_torch.ops.scan_dw import h_prev_of

    itemsize = torch.tensor([], dtype=dtype).element_size()
    chosen, figures = _cuda_lib.persist_plan_query(batch, hidden, dtype, 0)
    xp, h0, c0, w, b, mask = scan_inputs(batch, hidden, dtype, gen, dev,
                                         True)
    rows = []
    with torch.inference_mode():
        want = ws.lstm_persist_fwd(xp, h0, c0, w, b, chosen, mask=mask)
        hh = ws._recompute_hh(h_prev_of(h0, want[0]), w, b)
        dhs = (torch.rand(want[0].shape, generator=gen, device=dev) * 0.2
               - 0.1).to(dtype)
        dlast = torch.rand(h0.shape, generator=gen, device=dev) * 0.2 - 0.1
        sweep = (xp, hh, c0, want[1], w, dhs, dlast, dlast)
        bwant = ws.lstm_persist_bwd(*sweep, chosen, mask=mask)
        for c in _cuda_lib.PERSIST_CLUSTERS:
            only = dict(figures, clusters={k: (v if k == c else 0)
                                           for k, v in
                                           figures["clusters"].items()})
            plan = _cuda_lib.persist_plan(batch, hidden, itemsize, **only)
            if plan is None:
                continue
            got = ws.lstm_persist_fwd(xp, h0, c0, w, b, plan, mask=mask)
            bgot = ws.lstm_persist_bwd(*sweep, plan, mask=mask)
            prime = dict(prime=True, prime_cycles=chip_smoke.PRIME_CYCLES,
                         reps=REPS)
            rows.append(dict(
                batch=batch, hidden=hidden, dtype=dtype_name(dtype),
                cluster=c, plan=plan, chosen=plan == chosen,
                same_bits=all(torch.equal(g, h_) for g, h_ in
                              zip((*got, *bgot), (*want, *bwant))),
                max_abs_diff=max((g.float() - h_.float()).abs().max().item()
                                 for g, h_ in zip((*got, *bgot),
                                                  (*want, *bwant))),
                kernel_fwd_ms=chip_smoke.time_ms(
                    lambda: ws.lstm_persist_fwd(xp, h0, c0, w, b, plan,
                                                mask=mask), **prime),
                kernel_bwd_ms=chip_smoke.time_ms(
                    lambda: ws.lstm_persist_bwd(*sweep, plan, mask=mask),
                    **prime),
                l2_bytes_step_fwd=persist_l2_bytes(plan, batch, hidden,
                                                    itemsize, False),
                l2_bytes_step_bwd=persist_l2_bytes(plan, batch, hidden,
                                                    itemsize, True)))
    return rows


def profile_steps(batch, hidden, dtype, gen, dev):
    """The kernels built with -DFMDA_PROFILE_PERSIST: CTA 0's stamps of
    each step, as medians over the steps in microseconds: the step, its
    first chunk's wait after the step starts, the gap between chunks, a
    chunk's copy from issue to the consumer's wake, the epilogue and the
    grid barrier."""
    import ctypes
    import statistics

    from fmda_tpu_torch.ops import _cuda_lib
    from fmda_tpu_torch.ops import wide_scan as ws
    from fmda_tpu_torch.ops.scan_dw import h_prev_of

    lib = _cuda_lib.load()
    plan = ws.lstm_persist_plan(batch, hidden, dtype, dev)
    xp, h0, c0, w, b, _ = scan_inputs(batch, hidden, dtype, gen, dev, False)
    rows = []
    cols = 200
    with torch.inference_mode():
        hs, cs = ws.lstm_persist_fwd(xp, h0, c0, w, b, plan)
        hh = ws._recompute_hh(h_prev_of(h0, hs), w, b)
        dl = torch.zeros(h0.shape, device=dev)
        for name, call, nch in (
                ("lstm_persist_fwd",
                 lambda: ws.lstm_persist_fwd(xp, h0, c0, w, b, plan),
                 hidden // plan["chunk"]),
                ("lstm_persist_bwd",
                 lambda: ws.lstm_persist_bwd(xp, hh, c0, cs, w, hs, dl, dl,
                                             plan),
                 4 * hidden // plan["chunk"])):
            call()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (64 * cols))()
            _cuda_lib.raise_on(lib, lib.fmda_persist_prof(buf), "profile")
            st = [list(buf[i * cols:(i + 1) * cols]) for i in range(STEPS)]
            steps = range(2, STEPS - 1)
            us = lambda v: statistics.median(v) / 1e3  # noqa: E731
            rows.append(dict(
                kernel=name, batch=batch, hidden=hidden,
                dtype=dtype_name(dtype), chunks=nch,
                step_us=us([st[s][130] - st[s - 1][130] for s in steps]),
                first_chunk_us=us([st[s][0] - st[s][192] for s in steps]),
                chunk_gap_us=us([st[s][k + 1] - st[s][k] for s in steps
                                 for k in range(nch - 1)]),
                copy_us=us([st[s][k] - st[s][64 + k] for s in steps
                            for k in range(min(nch, 64))]),
                issue_gap_us=us([st[s][65 + k] - st[s][64 + k] for s in steps
                                 for k in range(min(nch, 64) - 1)]),
                product_us=us([st[s][128 + k] - st[s][k] for s in steps
                               for k in range(min(nch, 64))]),
                epilogue_us=us([st[s][193] - st[s][128 + min(nch, 64) - 1]
                                for s in steps]),
                barrier_us=us([st[s][194] - st[s][193] for s in steps]),
                stamps_step_2=[v - st[2][192] for v in st[2]]))
    return rows


def time_graphs(batch, hidden, dtype, gen, dev):
    """The per-step route (the plan forced off: W3, W4 and cuBLAS's
    products, 2 T host calls a direction) captured once into a CUDA graph,
    forward and forward + backward, then replayed: device ms (the queue
    primed) and what a caller waits (unprimed), and the replay's outputs
    against the same route uncaptured on the same inputs.  A yardstick
    for the persistent scans' one launch: the port captures no graph."""
    from fmda_tpu_torch.ops import wide_scan as ws

    xp, h0, c0, w, b, _ = scan_inputs(batch, hidden, dtype, gen, dev, False)
    args = [t.requires_grad_() for t in (xp, h0, c0, w, b)]
    detached = [a.detach() for a in args]
    cots = [(torch.rand(s, generator=gen, device=dev) * 0.2 - 0.1).to(dtype)
            for s in (h0.shape, h0.shape, (batch, STEPS, hidden))]

    def fwd():
        with torch.no_grad():
            (h, c), hs = ws.lstm_wide_scan(*detached)
        return [h, c, hs]

    def fwd_bwd():
        (h, c), hs = ws.lstm_wide_scan(*args)
        return [h.detach(), c.detach(), hs.detach(),
                *torch.autograd.grad([h, c, hs], args, cots)]

    row = dict(batch=batch, steps=STEPS, hidden=hidden,
               dtype=dtype_name(dtype))
    with per_step_route():
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
            row[f"graph_{name}_same_bits"] = all(
                torch.equal(g, w_) for g, w_ in zip(static, want))
            row[f"graph_{name}_max_abs_diff"] = max_err(static, want)
            row[f"graph_{name}_ms"] = chip_smoke.time_ms(
                graph.replay, prime=True,
                prime_cycles=chip_smoke.LIBRARY_PRIME_CYCLES, reps=REPS)
            row[f"graph_{name}_call_ms"] = chip_smoke.time_ms(
                graph.replay, prime=False, reps=REPS)
            del graph, static
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="build with -DFMDA_PROFILE_PERSIST and print the "
                    "step profile at B = 1 and 512 only")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_lstm_persist: no CUDA device", file=sys.stderr)
        return 2
    from fmda_tpu_torch.ops import _cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = open(args.out, "w") if args.out else None

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()

    if args.profile:
        _cuda_lib.NVCC_FLAGS = _cuda_lib.NVCC_FLAGS + (
            "-DFMDA_PROFILE_PERSIST",)
    _cuda_lib.build()
    ptxas = chip_smoke.ptxas_summary(str(_cuda_lib.build_info.get("log", "")))
    emit({"phase": "build", "card": chip_smoke.card_line(),
          "nvcc_seconds": _cuda_lib.build_info.get("seconds"),
          "ptxas": {k: v for k, v in ptxas["ptxas"].items()
                    if "persist" in k}})
    ok = True
    dev = torch.device("cuda")
    for batch, hidden, dtype in SHAPES + QUICK:
        plan, figures = _cuda_lib.persist_plan_query(batch, hidden, dtype, 0)
        mirror = _cuda_lib.persist_plan(
            batch, hidden, torch.tensor([], dtype=dtype).element_size(),
            **figures)
        same = (plan is None) == (mirror is None) and (
            plan is None or all(plan[k] == mirror[k]
                                for k in _cuda_lib.PERSIST_FIELDS))
        ok &= same
        emit({"phase": "plan", "batch": batch, "hidden": hidden,
              "dtype": dtype_name(dtype), "plan": plan, "mirror_same": same,
              "figures": figures})
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.profile:
        for batch, hidden, dtype in ((1, 1024, torch.bfloat16),
                                     (16, 1024, torch.bfloat16),
                                     (512, 1024, torch.bfloat16)):
            for row in profile_steps(batch, hidden, dtype, gen, dev):
                emit({"phase": "profile", **row})
        return 0
    for batch, hidden, dtype in QUICK if args.quick else SHAPES:
        _, rows = check_kernels(batch, hidden, dtype, gen, dev)
        for row in rows:
            ok &= row["ok"]
            emit({"phase": "check", **row})
    if not args.quick:
        for batch, hidden, dtype in SHAPES:
            emit({"phase": "time", **time_shape(batch, hidden, dtype, gen,
                                                dev)})
            for row in time_layouts(batch, hidden, dtype, gen, dev):
                ok &= row["max_abs_diff"] <= (1e-5 if dtype == torch.float32
                                              else 2e-2)
                emit({"phase": "layout", **row})
        for batch, hidden, dtype in SHAPES:
            for masked in (False, True):
                row = chip_smoke.persist_witness(batch, hidden, dtype,
                                                 masked, gen, dev)
                emit({"phase": "witness", **row})
        for batch, hidden, dtype in SHAPES[:3]:
            row = time_graphs(batch, hidden, dtype, gen, dev)
            ok &= row["graph_fwd_same_bits"] and row["graph_fwd_bwd_same_bits"]
            emit({"phase": "graph", **row})
    emit({"phase": "done", "ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
