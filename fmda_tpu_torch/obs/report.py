"""The observability commands of ``python -m fmda_tpu_torch``: ``status``,
``trace``, ``perf`` and ``quality``, with their printers, as
``fmda_tpu.cli`` has them.

- ``status --endpoint HOST:PORT [...]`` scrapes running endpoints'
  ``/snapshot`` and ``/healthz`` and prints the snapshot, the health
  verdict and the device and quality summaries; several endpoints report
  each one and the aggregate verdict; ``--watch N`` redraws every N
  seconds.  An endpoint that serves ``/alerts`` (a router's fleet
  telemetry, :mod:`fmda_tpu_torch.obs.aggregate`) adds the SLO alert
  table, and ``status`` exits 1 while an alert fires.  The reference's
  status also reads ``/control``, which waits with the control plane
  (ROADMAP queue 1, item 7c).  ``status`` without an endpoint builds an
  :class:`~fmda_tpu_torch.app.Application` over the configured warehouse
  (``--warehouse`` overrides its path), its endpoint off, and prints that
  application's snapshot and health.
- ``trace`` groups Chrome/Perfetto trace files (``serve-fleet
  --trace-out``), a running endpoint's ``/trace``, or several per-process
  files stitched by trace id (``--merge``) into per-trace stage
  breakdowns: the same text as the reference's for the same file.
- ``perf`` renders the device report (``/device``, or a saved one): the
  kernel ledger, MFU, device memory, and the host profiler's hottest
  stacks.
- ``quality`` renders the label-join evaluator's ``/quality`` document.

Every command reads over HTTP or from files (local ``status``: the
warehouse file): none touches the card.
"""

from __future__ import annotations

import json
import math
import os
import sys


def _base(endpoint: str) -> str:
    return (endpoint if "://" in endpoint
            else f"http://{endpoint}").rstrip("/")


def _fetch_json(url: str):
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


# -- status -------------------------------------------------------------------


def _fmt_bytes(n: float) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0:
            return (f"{int(n)}B" if unit == "B" else f"{n:.1f}{unit}")
        n /= 1024.0
    return f"{n:.1f}TiB"


def _perf_summary(snapshot: dict) -> dict:
    """The device facts inside ``status``: MFU, arithmetic intensity,
    kernel launches, the build's seconds, the memory watermark and the
    leak verdict; {} when the snapshot has none."""
    by_name: dict = {}
    for kind in ("counters", "gauges"):
        for s in snapshot.get(kind, []):
            by_name.setdefault(s["name"], []).append(float(s["value"]))

    def agg(fn, name):
        vals = by_name.get(name)
        return fn(vals) if vals else None

    out = {}
    for key, fn, name in (
            ("mfu", max, "device_mfu"),
            ("arithmetic_intensity", max, "device_arithmetic_intensity"),
            ("kernel_launches", sum, "kernel_launches_total"),
            ("build_seconds", max, "kernel_build_seconds"),
            ("memory_watermark_bytes", max,
             "device_memory_watermark_bytes"),
            ("memory_leak_suspected", max, "device_memory_leak_suspected")):
        value = agg(fn, name)
        if value is not None:
            out[key] = value
    return out


def _print_perf_summary(perf: dict) -> None:
    parts = []
    if "mfu" in perf:
        parts.append(f"mfu {perf['mfu'] * 100:.2f}%")
    if "kernel_launches" in perf:
        parts.append(f"kernel launches {int(perf['kernel_launches'])}")
    if "build_seconds" in perf:
        parts.append(f"nvcc {perf['build_seconds']:.1f}s")
    if "memory_watermark_bytes" in perf:
        parts.append(
            f"mem watermark {_fmt_bytes(perf['memory_watermark_bytes'])}")
    if perf.get("memory_leak_suspected"):
        parts.append("LEAK SUSPECTED")
    print("perf: " + " | ".join(parts))


def _quality_summary(snapshot: dict) -> dict:
    """The model-quality section of ``status``: present once the
    label-join evaluator has published at least one joined window."""
    out: dict = {"versions": {}}
    for s in snapshot.get("gauges", []):
        name, labels = s["name"], s.get("labels", {})
        if name == "quality_subset_accuracy":
            v = labels.get("version", "?")
            out["versions"].setdefault(v, {})["accuracy"] = float(s["value"])
        elif name == "quality_hamming_loss":
            v = labels.get("version", "?")
            out["versions"].setdefault(v, {})["hamming"] = float(s["value"])
        elif name == "quality_pending":
            out["pending"] = float(s["value"])
        elif name == "quality_drift_score":
            out["drift"] = float(s["value"])
    for s in snapshot.get("counters", []):
        if s["name"] in ("quality_joined_total", "quality_join_expired_total",
                         "quality_captures_shed_total"):
            out[s["name"]] = out.get(s["name"], 0.0) + float(s["value"])
    if not out["versions"] and "quality_joined_total" not in out:
        return {}
    return out


def _print_quality_summary(quality: dict) -> None:
    parts = []
    joined = quality.get("quality_joined_total")
    if joined is not None:
        parts.append(f"joined {int(joined)}")
    for v, m in sorted(quality.get("versions", {}).items()):
        acc = m.get("accuracy")
        ham = m.get("hamming")
        seg = f"v{v} acc {acc:.3f}" if acc is not None else f"v{v}"
        if ham is not None:
            seg += f" hamming {ham:.3f}"
        parts.append(seg)
    if "drift" in quality:
        parts.append(f"drift psi {quality['drift']:.3f}")
    if quality.get("pending"):
        parts.append(f"pending {int(quality['pending'])}")
    expired = quality.get("quality_join_expired_total", 0.0)
    shed = quality.get("quality_captures_shed_total", 0.0)
    if expired or shed:
        parts.append(f"lost {int(expired)} expired / {int(shed)} shed")
    print("quality: " + " | ".join(parts))


def print_status(snapshot: dict, health: dict, alerts: dict = None) -> None:
    """Human-readable registry snapshot + health verdict (+ the SLO
    alert table when the endpoint serves ``/alerts``)."""

    def key(s):
        labels = ",".join(f"{k}={v}" for k, v in
                          sorted(s.get("labels", {}).items()))
        return f"{s['name']}{{{labels}}}" if labels else s["name"]

    print(f"status: {health['status']}")
    for name, check in sorted(health.get("checks", {}).items()):
        mark = "ok  " if check["ok"] else "FAIL"
        print(f"  {mark} {name:<14} {check['detail']}")
    if alerts and alerts.get("alerts"):
        print(f"slo alerts (burn threshold "
              f"{alerts.get('burn_threshold')}x):")
        for name, a in sorted(alerts["alerts"].items()):
            mark = "FIRE" if a.get("state") == "firing" else "ok  "
            print(f"  {mark} {name:<16} "
                  f"fast {a.get('burn_fast', 0):>8.2f}x  "
                  f"slow {a.get('burn_slow', 0):>8.2f}x  "
                  f"{a.get('detail', '')}")
    perf = _perf_summary(snapshot)
    if perf:
        _print_perf_summary(perf)
    quality = _quality_summary(snapshot)
    if quality:
        _print_quality_summary(quality)
    for kind in ("counters", "gauges"):
        samples = sorted(snapshot.get(kind, []), key=key)
        if samples:
            print(f"{kind}:")
            for s in samples:
                v = float(s["value"])
                # a NaN or infinite gauge prints as it is
                v = int(v) if math.isfinite(v) and v == int(v) else round(v, 6)
                print(f"  {key(s):<52} {v}")
    hists = sorted(snapshot.get("histograms", []), key=key)
    if hists:
        print("latency:")
        print(f"  {'series':<52} {'count':>8} {'p50_ms':>9} "
              f"{'p99_ms':>9} {'mean_ms':>9}")
        for s in hists:
            n = s["count"]
            mean_ms = (s["sum_s"] / n * 1e3) if n else 0.0
            print(f"  {key(s):<52} {n:>8} {s['p50_s'] * 1e3:>9.3f} "
                  f"{s['p99_s'] * 1e3:>9.3f} {mean_ms:>9.3f}")


def scrape_endpoint(endpoint: str):
    """GET /snapshot + /healthz off one endpoint; raises on transport
    failure."""
    import urllib.error

    base = _base(endpoint)
    snapshot = _fetch_json(base + "/snapshot")
    try:
        health = _fetch_json(base + "/healthz")
    except urllib.error.HTTPError as e:
        # 503 = degraded; the body still carries the check detail
        health = json.loads(e.read())
    return snapshot, health


def scrape_alerts(endpoint: str):
    """GET /alerts off one endpoint; None where it serves none (a
    worker's endpoint, or a process with no fleet telemetry)."""
    import urllib.error

    try:
        return _fetch_json(_base(endpoint) + "/alerts")
    except (urllib.error.URLError, OSError, json.JSONDecodeError):
        return None


def _status_multi(endpoints) -> int:
    """Every endpoint's health, then the aggregate verdict: exit 0 iff
    every endpoint answered ok (an unreachable one is degraded, not a
    crash)."""
    import urllib.error

    per = {}
    for ep in endpoints:
        try:
            per[ep] = scrape_endpoint(ep) + (scrape_alerts(ep),)
        except (urllib.error.URLError, OSError,
                json.JSONDecodeError) as e:
            per[ep] = (None, {"status": "unreachable", "checks": {},
                              "error": str(e)}, None)
    n_ok = 0
    for ep, (snapshot, health, alerts) in per.items():
        status = health.get("status")
        print(f"===== {ep}: {status} =====")
        if status == "unreachable":
            print(f"  {health.get('error')}")
            continue
        if status == "ok":
            n_ok += 1
        print_status(snapshot, health, alerts)
    aggregate = "ok" if n_ok == len(endpoints) else "degraded"
    print(f"aggregate: {aggregate} ({n_ok}/{len(endpoints)} endpoints ok)")
    return 0 if aggregate == "ok" else 1


def _local_status(args):
    """A local application's snapshot and health: an
    :class:`~fmda_tpu_torch.app.Application` over the config's warehouse
    (``--warehouse`` overrides its path), its scrape endpoint off (a config
    with the endpoint on belongs to the daemon this command inspects)."""
    import dataclasses

    from fmda_tpu_torch.__main__ import _config
    from fmda_tpu_torch.app import Application

    cfg = _config(args)
    if args.warehouse:
        cfg = dataclasses.replace(cfg, warehouse=dataclasses.replace(
            cfg.warehouse, path=args.warehouse))
    cfg = dataclasses.replace(cfg, observability=dataclasses.replace(
        cfg.observability, endpoint_enabled=False))
    app = Application(cfg)
    try:
        return app.observability.snapshot(), app.observability.health()
    finally:
        app.close()
        app.warehouse.close()


def _status_once(args) -> int:
    import urllib.error

    alerts = None
    if not args.endpoint:
        snapshot, health = _local_status(args)
    elif len(args.endpoint) > 1:
        return _status_multi(args.endpoint)
    else:
        try:
            snapshot, health = scrape_endpoint(args.endpoint[0])
        except (urllib.error.URLError, OSError, json.JSONDecodeError) as e:
            print(f"cannot scrape {args.endpoint[0]}: {e}", file=sys.stderr)
            return 2
        alerts = scrape_alerts(args.endpoint[0])
    print_status(snapshot, health, alerts)
    firing = bool(alerts and alerts.get("firing"))
    return 0 if health.get("status") == "ok" and not firing else 1


def cmd_status(args) -> int:
    """Observability snapshot: off running endpoints (``--endpoint``, one
    or several), or of a local application over the configured warehouse;
    ``--watch N`` re-scrapes every N seconds until Ctrl-C."""
    if not args.watch:
        return _status_once(args)
    import time

    try:
        while True:
            if sys.stdout.isatty():
                print("\x1b[2J\x1b[H", end="")  # redraw in place
            _status_once(args)
            print(f"-- every {args.watch:g}s (Ctrl-C to exit) --",
                  flush=True)
            time.sleep(args.watch)
    except KeyboardInterrupt:
        return 0


# -- trace --------------------------------------------------------------------


def _merge_paths(args_merge):
    """Each --merge argument as files: a file, a directory of *.json
    trace files, or a glob pattern.  (paths, error message)."""
    import glob

    paths = []
    for arg in args_merge:
        if os.path.isdir(arg):
            expanded = sorted(glob.glob(os.path.join(arg, "*.json")))
            if not expanded:
                return None, f"no *.json trace files in directory {arg}"
        elif glob.has_magic(arg):
            expanded = sorted(glob.glob(arg))
            if not expanded:
                return None, f"glob {arg!r} matched nothing"
        else:
            expanded = [arg]
        paths.extend(expanded)
    return paths, ""


def cmd_trace(args) -> int:
    """Per-stage latency attribution for recorded tick traces.  Input is
    Chrome/Perfetto trace_event JSON: a ``serve-fleet --trace-out`` file,
    a running endpoint's ``/trace``, or several per-process files
    stitched by trace id (``--merge``)."""
    import urllib.error

    from fmda_tpu_torch.obs.trace import (
        format_trace,
        group_chrome_traces,
        merge_chrome_traces,
    )

    if args.merge:
        paths, err = _merge_paths(args.merge)
        if paths is None:
            print(err, file=sys.stderr)
            return 2
        docs = []
        for path in paths:
            try:
                with open(path) as fh:
                    docs.append(json.load(fh))
            except (OSError, json.JSONDecodeError) as e:
                print(f"cannot read {path}: {e}", file=sys.stderr)
                return 2
        doc = merge_chrome_traces(docs)
        if args.out:
            try:
                with open(args.out, "w") as fh:
                    json.dump(doc, fh)
            except OSError as e:
                print(f"cannot write {args.out}: {e}", file=sys.stderr)
                return 2
            n_traces = len(group_chrome_traces(doc))
            print(f"merged {len(paths)} trace files "
                  f"({n_traces} traces) -> {args.out} "
                  "(load at https://ui.perfetto.dev)", file=sys.stderr)
            return 0
    elif args.endpoint:
        base = _base(args.endpoint)
        try:
            doc = _fetch_json(base + "/trace")
        except (urllib.error.URLError, OSError, json.JSONDecodeError) as e:
            print(f"cannot scrape {base}/trace: {e}", file=sys.stderr)
            return 2
    elif args.input:
        try:
            with open(args.input) as fh:
                doc = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            print(f"cannot read {args.input}: {e}", file=sys.stderr)
            return 2
    else:
        print("pass --input FILE (a serve-fleet --trace-out file), "
              "--endpoint HOST:PORT (a running /trace endpoint), or "
              "--merge FILE FILE... (stitch per-process trace files)",
              file=sys.stderr)
        return 2
    traces = group_chrome_traces(doc)
    if args.min_ms is not None:
        traces = [t for t in traces if t["e2e_ms"] >= args.min_ms]
    if args.slowest is not None:
        traces = sorted(
            traces, key=lambda t: t["e2e_ms"], reverse=True)[:args.slowest]
    else:
        traces = traces[-args.last:]
    if not traces:
        print("no traces matched (is tracing enabled and sampled?)",
              file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(traces, indent=2))
    else:
        print("\n".join(format_trace(t) for t in traces))
    return 0


# -- perf ---------------------------------------------------------------------


def cmd_perf(args) -> int:
    """The device report: the kernel ledger (launches, sampled device
    time, FLOPs and bytes by kernel), MFU, device memory, and the host
    profiler's hottest stacks.  Input is a running endpoint's ``/device``
    (+ ``/profile``) or a saved device report (or a bare ledger dump)."""
    import urllib.error

    profile_text = None
    if args.endpoint:
        base = _base(args.endpoint)
        try:
            doc = _fetch_json(base + "/device")
        except (urllib.error.URLError, OSError, json.JSONDecodeError) as e:
            print(f"cannot scrape {base}/device: {e}", file=sys.stderr)
            return 2
        try:
            import urllib.request

            with urllib.request.urlopen(base + "/profile", timeout=10) as r:
                profile_text = r.read().decode("utf-8", "replace")
        except (urllib.error.URLError, OSError):
            profile_text = None  # no profiler attached: the report stands
    elif args.input:
        try:
            with open(args.input) as fh:
                doc = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            print(f"cannot read {args.input}: {e}", file=sys.stderr)
            return 2
    else:
        print("pass --endpoint HOST:PORT (a running /device endpoint) "
              "or --input FILE (a saved device report or ledger dump)",
              file=sys.stderr)
        return 2
    if args.profile:
        try:
            with open(args.profile) as fh:
                profile_text = fh.read()
        except OSError as e:
            print(f"cannot read {args.profile}: {e}", file=sys.stderr)
            return 2
    # a bare ledger dump renders like a report with only the ledger
    if "ledger" not in doc and "kernels" in doc:
        doc = {"ledger": doc}
    if args.json:
        if profile_text is not None:
            doc = {**doc, "profile_folded": profile_text}
        print(json.dumps(doc, indent=2))
        return 0
    print_perf_report(doc, profile_text, top=args.top)
    return 0


def print_perf_report(doc: dict, profile_text, *, top: int) -> None:
    ledger = doc.get("ledger") or {}
    by_kernel: dict = {}
    for k in ledger.get("kernels") or []:
        acc = by_kernel.setdefault(k["kernel"], dict(
            launches=0, sampled=0, ms=0.0, min_ms=None, flops=0.0,
            bytes=0.0))
        if k["device_ms_min"] is not None:
            acc["min_ms"] = min(acc["min_ms"] or k["device_ms_min"],
                                k["device_ms_min"])
        acc["launches"] += k["launches"]
        acc["sampled"] += k["sampled"]
        acc["ms"] += k["device_ms_sampled"]
        acc["flops"] += k["launches"] * k["flops"]
        acc["bytes"] += k["launches"] * k["bytes_moved"]
    nvcc = ledger.get("nvcc_seconds")
    print("kernel ledger"
          + (f" (backend {ledger['backend']})"
             if ledger.get("backend") else "") + ":")
    print(f"  launches {ledger.get('launches_total', 0)}"
          f" | sampled {ledger.get('sampled_launches_total', 0)}"
          f" (1 in {ledger.get('sample_every', '-')}, "
          f"{ledger.get('pending_samples', 0)} pending)"
          f" | nvcc " + ("-" if nvcc is None else f"{nvcc:.1f}s"))
    if "mfu" in doc:
        print(f"  mfu {float(doc['mfu']) * 100:.3f}%"
              f" | arithmetic intensity "
              f"{float(doc.get('arithmetic_intensity', 0.0)):.2f} FLOP/B")
    if by_kernel:
        rows = sorted(by_kernel.items(), key=lambda kv: -kv[1]["launches"])
        print(f"  top {min(top, len(rows))} kernels by launches:")
        print(f"    {'kernel':<16} {'launches':>9} {'sampled':>8} "
              f"{'mean_ms':>9} {'min_ms':>9} {'gflops':>10} {'mbytes':>10}")
        for name, acc in rows[:top]:
            mean = (f"{acc['ms'] / acc['sampled']:>9.4f}"
                    if acc["sampled"] else f"{'-':>9}")
            least = (f"{acc['min_ms']:>9.4f}" if acc["min_ms"] is not None
                     else f"{'-':>9}")
            print(f"    {name:<16} {acc['launches']:>9} {acc['sampled']:>8} "
                  f"{mean} {least} {acc['flops'] / 1e9:>10.3f} "
                  f"{acc['bytes'] / 1e6:>10.3f}")
    memory = doc.get("memory") or {}
    if memory.get("samples"):
        leak = " | LEAK SUSPECTED" if memory.get("leak_suspected") else ""
        alloc = memory.get("allocated_bytes")
        print("device memory:")
        print("  allocated "
              + ("-" if alloc is None else _fmt_bytes(alloc))
              + f" | watermark {_fmt_bytes(memory.get('watermark_bytes', 0))}"
              f" | owners {_fmt_bytes(memory.get('owners_bytes', 0))}"
              f" | samples {memory.get('samples', 0)}{leak}")
        for owner, nbytes in sorted((memory.get("by_owner") or {}).items()):
            print(f"    {owner:<44} {_fmt_bytes(nbytes)}")
    if profile_text:
        from fmda_tpu_torch.obs.pyprof import HostProfiler

        stacks = sorted(HostProfiler.parse_folded(profile_text).items(),
                        key=lambda kv: -kv[1])
        if stacks:
            total = sum(n for _, n in stacks)
            print(f"hottest host stacks ({total} samples):")
            for stack, n in stacks[:top]:
                frames = stack.split(";")
                leaf = frames[-1] if frames else stack
                root = frames[0] if frames else ""
                print(f"  {n:>7}  {root} ... {leaf}"
                      if len(frames) > 2 else f"  {n:>7}  {stack}")


# -- quality ------------------------------------------------------------------


def cmd_quality(args) -> int:
    """The model-quality report: per-weights-version live accuracy and
    F-beta off the label-join evaluator, drift scores, and the
    capture/join conservation ledger.  Input is a running endpoint's
    ``/quality``, a bundle directory's ``quality.json``, or a saved
    document (``--artifact``)."""
    import urllib.error

    if args.endpoint:
        base = _base(args.endpoint)
        try:
            doc = _fetch_json(base + "/quality")
        except (urllib.error.URLError, OSError, json.JSONDecodeError) as e:
            print(f"cannot scrape {base}/quality: {e}", file=sys.stderr)
            return 2
    else:
        path = (os.path.join(args.bundle, "quality.json") if args.bundle
                else args.artifact)
        if path is None:
            print("pass --endpoint HOST:PORT (a running /quality "
                  "endpoint), --bundle DIR (a directory holding "
                  "quality.json), or --artifact FILE (a saved /quality "
                  "document)", file=sys.stderr)
            return 2
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            print(f"cannot read {path}: {e}", file=sys.stderr)
            return 2
    if args.json:
        print(json.dumps(doc, indent=2))
        return 0
    print_quality_report(doc)
    return 0


def print_quality_report(doc: dict) -> None:
    if not doc.get("enabled", True):
        print("quality evaluation disabled ([quality] enabled=false "
              "or no evaluator attached)")
        return
    labels = doc.get("labels") or []
    overall = doc.get("overall") or {}
    beta = doc.get("beta", 0.5)
    print(f"model quality (threshold {doc.get('threshold')}, "
          f"F-beta beta={beta:g}, label lag {doc.get('max_lead')} rows):")
    cons = doc.get("conservation") or {}
    print(f"  captured {cons.get('captured', 0)} = "
          f"joined {cons.get('joined', 0)} + expired {cons.get('expired', 0)}"
          f" + shed {cons.get('shed', 0)} + pending {cons.get('pending', 0)}"
          f" (join errors: {doc.get('join_errors', 0)})")
    rows = [("overall", overall)]
    rows += [(f"v{v}", s) for v, s in sorted(
        (doc.get("versions") or {}).items())]
    print(f"  {'version':<10} {'n':>7} {'accuracy':>9} {'hamming':>9} "
          + " ".join(f"F:{label}" for label in labels))
    for name, s in rows:
        if not s or not s.get("n"):
            print(f"  {name:<10} {'0':>7} {'-':>9} {'-':>9}")
            continue
        fbeta = " ".join(
            f"{f:>8.3f}" for f in (s.get("fbeta") or []))
        print(f"  {name:<10} {s['n']:>7} {s['subset_accuracy']:>9.4f} "
              f"{s['hamming_loss']:>9.4f} {fbeta}")
    drift = doc.get("drift")
    if drift:
        print(f"  drift: max PSI {drift.get('max_psi', 0.0):.4f} over "
              f"{drift.get('rows', 0)} sampled rows "
              f"(prediction PSI {drift.get('prediction_psi')})")


def add_parsers(sub, common) -> None:
    """The four commands' parsers, with the reference's flags."""
    p = sub.add_parser(
        "status", parents=[common],
        help="pretty-print running endpoints' snapshot + health verdict")
    p.add_argument("--endpoint", default=None, metavar="HOST:PORT",
                   nargs="+",
                   help="scrape running endpoints' /snapshot + /healthz "
                        "instead of building a local app; several "
                        "endpoints report each one + the aggregate health")
    p.add_argument("--warehouse", default=None,
                   help="warehouse file for the local snapshot (default: "
                        "config's path)")
    p.add_argument("--watch", type=float, default=None, metavar="N",
                   help="re-scrape and redraw every N seconds until "
                        "Ctrl-C (clean exit 0)")
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser(
        "trace", parents=[common],
        help="per-stage latency attribution for recorded tick traces")
    p.add_argument("--input", default=None, metavar="FILE",
                   help="Chrome/Perfetto trace_event JSON file "
                        "(serve-fleet --trace-out)")
    p.add_argument("--endpoint", default=None, metavar="HOST:PORT",
                   help="scrape a running endpoint's /trace instead")
    p.add_argument("--merge", nargs="+", default=None, metavar="PATH",
                   help="stitch per-process --trace-out files into one "
                        "trace by trace id; each PATH may be a file, a "
                        "glob, or a directory of *.json trace files; with "
                        "--out writes the merged Perfetto JSON, without "
                        "it shows the attribution over the merged document")
    p.add_argument("--out", default=None, metavar="FILE",
                   help="write the --merge result to this file")
    p.add_argument("--last", type=int, default=10,
                   help="show the newest N traces (default 10)")
    p.add_argument("--slowest", type=int, default=None, metavar="N",
                   help="show the N slowest traces by e2e duration "
                        "instead of the newest")
    p.add_argument("--min-ms", type=float, default=None,
                   help="only traces with e2e duration >= this (ms)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output (grouped trace dicts)")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser(
        "perf", parents=[common],
        help="device report: kernel ledger, MFU, device memory, hottest "
             "host stacks")
    p.add_argument("--endpoint", default=None, metavar="HOST:PORT",
                   help="scrape a running endpoint's /device (+ /profile)")
    p.add_argument("--input", default=None, metavar="FILE",
                   help="a saved device report or kernel-ledger dump")
    p.add_argument("--profile", default=None, metavar="FILE",
                   help="folded-stack profile text to report the hottest "
                        "stacks from; --endpoint fetches /profile")
    p.add_argument("--top", type=int, default=10,
                   help="rows per table (default 10)")
    p.add_argument("--json", action="store_true",
                   help="the device report document (plus profile_folded "
                        "when present)")
    p.set_defaults(fn=cmd_perf)

    p = sub.add_parser(
        "quality", parents=[common],
        help="model-quality report: per-weights-version live accuracy and "
             "F-beta, drift, capture/join conservation")
    p.add_argument("--endpoint", default=None, metavar="HOST:PORT",
                   help="scrape a running endpoint's /quality")
    p.add_argument("--bundle", default=None, metavar="DIR",
                   help="read DIR/quality.json instead")
    p.add_argument("--artifact", default=None, metavar="FILE",
                   help="read a saved /quality document instead")
    p.add_argument("--json", action="store_true",
                   help="the /quality document verbatim")
    p.set_defaults(fn=cmd_quality)
