#!/usr/bin/env python3
"""Chip smoke for fmda_tpu_torch: the quickest proof that the port starts,
builds its kernels and serves correctly on a CUDA card (an H100).

    python3 chip_smoke.py            # from the repository root, one card

Phases, each printed as one JSON line, each fatal on failure:

1. ``device``: the card, its power limit, the torch/CUDA versions.
2. ``build``: nvcc builds every kernel of the serving path from
   ``fmda_tpu_torch/csrc`` for sm_90a.
3. ``kernel``: each kernel against its plain PyTorch version on the card,
   at the serving shapes, with times, the roofline bound and the library
   yardstick beside it.
4. ``path``: the window-re-scan serving path at full width
   (``FrameworkConfig()``: BiGRU H=32, F=108, window 30, float32) over a
   20,000-row warehouse: ``backtest`` at batch 256, then 64 signals through
   ``Predictor.from_checkpoint(...).poll()``, both recomputed on the CPU
   and compared.  Launch counts are reset just before the path and read
   just after it.

Then the ``{"kernels": [...]}`` summary, the card line, and as the last
line ``{"ok": true, "device": {...}}``.  TF32 is off for matmuls and cuDNN,
so float32 means float32 everywhere.  Exits non-zero, and prints no result,
without a card or outside the repository.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

import torch

SEED = 0
WAREHOUSE_ROWS = 20_000
SIGNALS = 64
BATCH = 256
F32_TOL = 1e-5
BF16_TOL = 2e-2
PATH_TOL = 1e-5
REPS = 60
# published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and float32
# outside the tensor cores (the scan kernel's arithmetic is f32 FMAs)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, message: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {message}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, *, prime: bool) -> float:
    """Median of REPS CUDA-event times of one call, after warm-up.

    ``prime`` queues a ~1 ms device sleep before each call, so the host's
    launch overhead hides behind it whenever it is shorter: the result is
    then the device time of the call.  Unprimed, it is the time the caller
    waits for the call on an idle card."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(REPS)]
    for start, end in pairs:
        if prime:
            torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def scan_bound(batch, steps, hidden, itemsize, masked):
    """Least time for the scan on this card: each input read once, each
    output written once, against the hidden product's and gates' FLOPs."""
    bytes_moved = itemsize * (
        batch * steps * 3 * hidden      # xp in
        + batch * steps * hidden        # hs out
        + 2 * batch * hidden            # h0 in, h_last out
        + 3 * hidden * hidden + 3 * hidden)  # W_hh, b_hh in
    bytes_moved += batch * steps if masked else 0
    # 2*3H*H per (row, step) for h . W_hh^T, ~10 per (row, step, unit) for
    # the gate algebra (a transcendental counted as one)
    flops = 2 * batch * steps * 3 * hidden * hidden + 10 * batch * steps * hidden
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else
                                   "operations")


def phase_kernel(gru_kernel, n_features: int):
    """gru_scan_fwd against gru_scan_reference on the card."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = []
    for batch, steps, hidden in ((1, 30, 32), (256, 30, 32), (256, 30, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            for reverse in (False, True):
                cases.append(dict(batch=batch, steps=steps, hidden=hidden,
                                  dtype=dtype, reverse=reverse,
                                  masked=False, h0=False))
    cases.append(dict(batch=256, steps=30, hidden=32, dtype=torch.float32,
                      reverse=True, masked=True, h0=False))
    cases.append(dict(batch=256, steps=30, hidden=32, dtype=torch.float32,
                      reverse=False, masked=False, h0=True))
    results = []
    for c in cases:
        b, t, h, dtype = c["batch"], c["steps"], c["hidden"], c["dtype"]
        scale = 1.0 / math.sqrt(h)

        def rand(*shape, s=1.0):
            return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                    * s).to(dtype)

        xp = rand(b, t, 3 * h, s=2.0)
        h0 = rand(b, h, s=0.5) if c["h0"] else torch.zeros(b, h, dtype=dtype,
                                                           device=dev)
        w, bias = rand(3 * h, h, s=scale), rand(3 * h, s=scale)
        mask = None
        if c["masked"]:  # ragged valid lengths 1..T
            lengths = torch.randint(1, t + 1, (b,), generator=gen, device=dev)
            mask = torch.arange(t, device=dev)[None, :] < lengths[:, None]
        args = (xp, h0, w, bias)
        kw = dict(reverse=c["reverse"], mask=mask)
        with torch.inference_mode():
            k_last, k_hs = gru_kernel.gru_scan_fwd(*args, **kw)
            r_last, r_hs = gru_kernel.gru_scan_reference(*args, **kw)
            torch.cuda.synchronize()
            err = max((k_hs.float() - r_hs.float()).abs().max().item(),
                      (k_last.float() - r_last.float()).abs().max().item())
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            finite = bool(torch.isfinite(k_hs.float()).all())
            ms = time_ms(lambda: gru_kernel.gru_scan_fwd(*args, **kw),
                         prime=True)
            call_ms = time_ms(lambda: gru_kernel.gru_scan_fwd(*args, **kw),
                              prime=False)
            plain_ms = time_ms(
                lambda: gru_kernel.gru_scan_reference(*args, **kw),
                prime=True)
            library_ms = None
            if not (c["reverse"] or c["masked"] or c["h0"]):
                # yardstick only, never called by the port: cuDNN's GRU on
                # the same layer, input projection included
                lib = torch.nn.GRU(n_features, h, batch_first=True).to(
                    dev, dtype)
                x = torch.rand((b, t, n_features), generator=gen,
                               device=dev).to(dtype)
                library_ms = time_ms(lambda: lib(x), prime=True)
        bound_ms, bound_by = scan_bound(b, t, h, xp.element_size(),
                                        c["masked"])
        row = dict(batch=b, steps=t, hidden=h,
                   dtype=str(dtype).replace("torch.", ""),
                   reverse=c["reverse"], masked=c["masked"],
                   nonzero_h0=c["h0"], max_abs_err=err, tol=tol,
                   ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        emit("kernel gru_scan_fwd", **row)
        check(finite, f"non-finite kernel output in {row}")
        check(err <= tol, f"kernel disagrees with its plain version: {row}")
        results.append(row)
    return results


def breakdown(wh, ckpt, model_cfg, window, norm, stamps, device):
    """Where a signal's and a backtest batch's time goes: the warehouse on
    the host against the forward on the card (host clock, each forward
    ended by a synchronize; medians over the signals or batches)."""
    from fmda_tpu_torch.data.normalize import normalize
    from fmda_tpu_torch.data.windows import window_index_matrix
    from fmda_tpu_torch.serve.predictor import load_model, make_batched_forward
    from fmda_tpu_torch.train.checkpoint import restore_checkpoint

    def median_ms(fn, items):
        out = []
        for item in items:
            t = time.perf_counter()
            fn(item)
            out.append((time.perf_counter() - t) * 1e3)
        return statistics.median(out)

    def on_device(fn):
        def run(item):
            fn(item)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
        return run

    tree, _ = restore_checkpoint(ckpt)
    model = load_model(model_cfg, tree["params"], torch.device(device))
    forward = make_batched_forward(model)
    x_min = torch.as_tensor(norm.x_min, device=device)
    x_range = torch.as_tensor(norm.x_max - norm.x_min, device=device)
    ids = [wh.id_for_timestamp(ts) for ts in stamps]
    windows = [wh.fetch(range(i - window + 1, i + 1))[None] for i in ids]
    t = time.perf_counter()
    rows = normalize(wh.fetch(range(1, len(wh) + 1)), norm)
    fetch_all_s = time.perf_counter() - t
    widx = window_index_matrix(len(rows), window)
    starts = range(0, len(widx) - BATCH + 1, BATCH)
    batches = [rows[widx[s:s + BATCH]] for s in starts]
    with torch.inference_mode():
        return dict(
            signal_lookup_ms=median_ms(wh.id_for_timestamp, stamps),
            signal_fetch_ms=median_ms(
                lambda i: wh.fetch(range(i - window + 1, i + 1)), ids),
            signal_forward_ms=median_ms(on_device(
                lambda x: forward(x_min, x_range,
                                  torch.from_numpy(x).to(device)).cpu()),
                windows),
            backtest_fetch_normalize_s=fetch_all_s,
            batch_gather_ms=median_ms(lambda s: rows[widx[s:s + BATCH]],
                                      starts),
            batch_forward_ms=median_ms(on_device(
                lambda x: model(torch.from_numpy(x).to(device))), batches))


def device_share(fn) -> dict:
    """Kernel time on the card while ``fn`` runs, from torch.profiler's
    CUDA activity, against the wall time (profiler on, so the wall time
    is inflated and the share a lower bound).  ``busy_share`` is None when
    the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    per_kernel = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            per_kernel[evt.key] = evt.self_device_time_total / 1e3
    device_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:4]
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms if device_ms else None,
                top_kernels_ms={k[:60]: v for k, v in top})


def phase_path(gru_kernel, device: str = "cuda"):
    """The serving slice at full width, on the card and again on the CPU."""
    from fmda_tpu_torch.config import (
        DEFAULT_TOPICS, FrameworkConfig, TOPIC_PREDICT_TIMESTAMP,
        TOPIC_PREDICTION)
    from fmda_tpu_torch.data.normalize import chunk_norm_params
    from fmda_tpu_torch.data.synthetic import random_walk_rows
    from fmda_tpu_torch.models import build_model
    from fmda_tpu_torch.serve import Predictor, backtest_from_checkpoint
    from fmda_tpu_torch.serve.backtest import trading_summary
    from fmda_tpu_torch.stream import InProcessBus, Warehouse
    from fmda_tpu_torch.train.checkpoint import save_checkpoint

    cfg = FrameworkConfig()
    fc, model_cfg, window = cfg.features, cfg.model, cfg.train.window
    threshold = cfg.train.prob_threshold
    gru_kernel.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=gru_kernel.BUILD_ROOT) as tmp:
        t0 = time.perf_counter()
        wh = Warehouse(fc, dataclasses.replace(cfg.warehouse,
                                               path=f"{tmp}/wh.sqlite"))
        wh.insert_rows(random_walk_rows(fc.table_columns(), WAREHOUSE_ROWS,
                                        seed=SEED))
        n = len(wh)
        x_all = wh.fetch(range(1, n + 1))
        norm = chunk_norm_params(x_all, wh.x_fields, bid_levels=fc.bid_levels,
                                 ask_levels=fc.ask_levels)
        model = build_model(
            model_cfg, generator=torch.Generator().manual_seed(SEED))
        ckpt = save_checkpoint(f"{tmp}/ckpt", model.state_dict(), norm)
        setup_s = time.perf_counter() - t0
        check(len(wh.x_fields) == model_cfg.n_features,
              f"warehouse serves {len(wh.x_fields)} features, model takes "
              f"{model_cfg.n_features}")
        emit("path setup", rows=n, features=len(wh.x_fields),
             model=str(model_cfg), window=window, seconds=setup_s)

        def run_backtest(device, **kw):
            return backtest_from_checkpoint(
                wh, ckpt, model_cfg, window=window, threshold=threshold,
                batch_size=BATCH, device=device, **kw)

        stamps = [ts for _, ts in wh.timestamps_after(n - SIGNALS)]

        def serve(device):
            bus = InProcessBus(DEFAULT_TOPICS)
            predictor = Predictor.from_checkpoint(
                ckpt, bus, wh, model_cfg, window=window, threshold=threshold,
                from_end=False, max_staleness_s=None, device=device)
            preds, lat_ms = [], []
            for ts in stamps:
                bus.publish(TOPIC_PREDICT_TIMESTAMP, {"Timestamp": ts})
                t = time.perf_counter()
                preds += predictor.poll()
                lat_ms.append((time.perf_counter() - t) * 1e3)
            published = len(bus.consumer(TOPIC_PREDICTION).poll())
            return preds, lat_ms, published, predictor.serve_errors

        # warm-up: cuBLAS handles and module loads, before the counted run
        run_backtest(device, ids=(window, window + BATCH))
        torch.cuda.synchronize()

        gru_kernel.launches = 0  # the main path starts here
        t0 = time.perf_counter()
        gpu_bt = run_backtest(device)
        torch.cuda.synchronize()
        bt_s = time.perf_counter() - t0
        bt_launches = gru_kernel.launches
        gpu_preds, lat_ms, published, errors = serve(device)
        path_launches = gru_kernel.launches
        pred_launches = path_launches - bt_launches  # the main path ends here

        served = len(gpu_bt.probabilities)
        m = gpu_bt.metrics
        emit("path backtest", rows=served, batch=BATCH,
             batches=math.ceil(served / BATCH), seconds=bt_s,
             rows_per_s=served / bt_s, launches=bt_launches,
             accuracy=float(m.accuracy), hamming=float(m.hamming),
             fbeta=[float(v) for v in m.fbeta],
             overall_edge=trading_summary(gpu_bt)["overall"].edge)
        check(served == n - window + 1, f"backtest served {served} rows")
        check(bt_launches == 2 * math.ceil(served / BATCH),
              f"backtest launched the scan kernel {bt_launches} times, "
              f"expected {2 * math.ceil(served / BATCH)}")
        check(bool(torch.isfinite(torch.from_numpy(gpu_bt.probabilities))
                   .all()), "non-finite backtest probabilities")
        emit("path predictor", signals=SIGNALS, served=len(gpu_preds),
             published=published, serve_errors=errors,
             launches=pred_launches, p50_ms=statistics.median(lat_ms),
             p99_ms=sorted(lat_ms)[math.ceil(0.99 * len(lat_ms)) - 1],
             mean_ms=statistics.fmean(lat_ms))
        check(len(gpu_preds) == SIGNALS and published == SIGNALS,
              f"{len(gpu_preds)} predictions served, {published} published, "
              f"of {SIGNALS} signals")
        check(pred_launches == 2 * SIGNALS,
              f"predictor launched the scan kernel {pred_launches} times, "
              f"expected {2 * SIGNALS}")
        emit("path breakdown", **breakdown(wh, ckpt, model_cfg, window,
                                           norm, stamps, device))
        if torch.device(device).type == "cuda":
            emit("path device share", backtest=device_share(
                lambda: run_backtest(device)), predictor=device_share(
                lambda: serve(device)))

        # the same port on the CPU: plain versions, no kernel
        cpu_bt = run_backtest("cpu")
        cpu_preds, _, _, _ = serve("cpu")
        bt_err = float(abs(gpu_bt.probabilities - cpu_bt.probabilities).max())
        pr_err = max(abs(a - b) for g, c in zip(gpu_preds, cpu_preds)
                     for a, b in zip(g.probabilities, c.probabilities))
        same_labels = ([p.labels for p in gpu_preds]
                       == [p.labels for p in cpu_preds])
        same_metrics = all(
            (a == b).all() for a, b in zip(gpu_bt.metrics, cpu_bt.metrics))
        emit("path vs cpu", backtest_max_abs_err=bt_err,
             predictor_max_abs_err=pr_err, labels_equal=same_labels,
             backtest_metrics_equal=bool(same_metrics), tol=PATH_TOL)
        check(bt_err <= PATH_TOL and pr_err <= PATH_TOL,
              "GPU and CPU probabilities disagree")
        check(same_labels, "GPU and CPU predicted labels differ")
        wh.close()
    return path_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script measures the "
              "card and has nothing to do without one", file=sys.stderr)
        return 2
    from fmda_tpu_torch.config import FrameworkConfig
    from fmda_tpu_torch.ops import gru_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit("device", card=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, tf32="off (matmul and cudnn)")

    t0 = time.perf_counter()
    lib = gru_kernel.build()
    ptxas = [ln.strip() for ln in str(gru_kernel.build_info.get("log", ""))
             .splitlines() if "registers" in ln or "spill" in ln]
    emit("build", kernel="gru_scan_fwd", library=str(lib),
         nvcc_seconds=gru_kernel.build_info.get("seconds"),
         seconds=time.perf_counter() - t0, target="sm_90a", ptxas=ptxas)

    n_features = FrameworkConfig().model.n_features
    rows = phase_kernel(gru_kernel, n_features)
    launches = phase_path(gru_kernel)

    main_shape = next(r for r in rows if r["batch"] == BATCH
                      and r["hidden"] == 32 and r["dtype"] == "float32"
                      and not (r["reverse"] or r["masked"] or r["nonzero_h0"]))
    print(json.dumps({"kernels": [{
        "name": "gru_scan_fwd",
        "route": "cuda",
        "source": "fmda_tpu_torch/csrc/gru_scan.cu",
        "replaces": "fmda_tpu/ops/pallas_gru.py:147",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["dtype"] == "float32"),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "shape": [BATCH, 30, 32],
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
