"""The port's multi-process serving tier, spawned for real, on the CPU.

- ``launch_local_fleet`` with one worker process (``--device cpu``): 8
  sessions x 12 ticks all answered exactly once across the process
  boundary, the worker's final stats off its goodbye, and the per-process
  trace files of the topology merged by ``trace --merge`` into journeys
  that cross it.
- The CLI roles: ``--role local`` end to end, a broker and a router that
  run without torch, a worker started by hand joining a router started by
  hand, and every refusal with the ROADMAP item it names.

Every subprocess has its own timeout.
"""

import json
import os
import socket
import subprocess
import sys
import time

import pytest

from fmda_tpu_torch.__main__ import main as port_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: a small serving stack: H 8, window 4, F 108 (the feature schema)
SMALL = ["--hidden", "8", "--window", "4", "--device", "cpu"]
#: spawned CPU workers take one thread each: several workers of a test,
#: beside the suite's other processes, must not starve each other past
#: the heartbeat timeout
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(argv, timeout=120):
    return subprocess.run([sys.executable, "-m", "fmda_tpu_torch"] + argv,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=timeout, env={**os.environ, **ONE_THREAD})


def test_local_topology_end_to_end_with_trace_merge(tmp_path, monkeypatch):
    from fmda_tpu_torch.fleet.launcher import launch_local_fleet
    from fmda_tpu_torch.obs.trace import configure_tracing, default_tracer
    from fmda_tpu_torch.runtime import FleetLoadConfig, run_fleet_load

    for key, value in ONE_THREAD.items():
        monkeypatch.setenv(key, value)  # the spawned worker's
    trace_dir = tmp_path / "traces"
    configure_tracing(enabled=True, sample_rate=1.0)
    try:
        topo = launch_local_fleet(
            n_workers=1, hidden=8, capacity_per_worker=16,
            bucket_sizes=(4, 16), seed=0, trace_dir=str(trace_dir),
            device="cpu", wait_timeout_s=120.0)
        try:
            out = run_fleet_load(topo.router, FleetLoadConfig(
                n_sessions=8, n_ticks=12, seed=0))
        finally:
            stats = topo.shutdown(timeout_s=60.0)
        with open(trace_dir / "router.json", "w") as fh:
            json.dump(default_tracer().chrome(), fh)
    finally:
        # the process-default tracer outlives the test: leave it off and
        # empty for the tests after it
        configure_tracing(enabled=False)
        default_tracer().clear()

    assert out["ticks_served"] == out["ticks_submitted"] == 96
    assert out["counters"].get("results_missing", 0) == 0
    assert out["counters"].get("results_unmatched", 0) == 0
    w0 = stats["w0"]
    assert w0["ticks_served"] == 96
    # where the reference's beat carries compile_count: kernel launches
    # per bucket, 0 on the CPU (the kernels' plain versions run)
    assert "compile_count" not in w0
    assert set(w0["kernel_launches_by_bucket"].values()) == {0}
    assert set(w0["kernel_launches_by_bucket"]) <= {"4", "16"}
    # and by kernel, since the warm-up: every kernel named, none launched
    assert "ssm_tick" in w0["kernel_launches"]
    assert set(w0["kernel_launches"].values()) == {0}

    merged = tmp_path / "merged.json"
    assert port_main(["trace", "--merge", str(trace_dir), "--out",
                      str(merged)]) == 0
    by_trace = {}
    for ev in json.loads(merged.read_text())["traceEvents"]:
        if ev.get("ph") == "X":
            by_trace.setdefault(ev["args"]["trace_id"], set()).add(
                ev["name"])
    stitched = [names for names in by_trace.values()
                if {"tick", "serve", "route"} <= names]
    assert stitched, "no cross-process journey stitched"
    assert {"queued", "dispatch", "device", "publish"} <= stitched[0]


def test_local_role_cli_serves_every_tick(tmp_path):
    trace_dir, pm_dir = tmp_path / "traces", tmp_path / "pm"
    proc = _run(["serve-fleet", "--role", "local", "--no-controller",
                 "--workers", "2", "--cell", "ssm", "--sessions", "8",
                 "--ticks", "6", "--trace-dir", str(trace_dir),
                 "--postmortem-dir", str(pm_dir)] + SMALL, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout)
    assert out["ticks_served"] == out["ticks_submitted"] == 48
    assert out["workers"] == 2 and sorted(out["worker_stats"]) == [
        "w0", "w1"]
    assert sum(s["ticks_served"] for s in out["worker_stats"].values()) \
        == 48
    assert out["alerts"] == []
    assert "fleet_e2e_p99_ms" in out["fleet"]
    assert sorted(os.listdir(trace_dir)) == ["router.json", "w0.json",
                                             "w1.json"]


def test_router_and_broker_roles_run_without_torch():
    code = (
        "import json, sys\n"
        "from fmda_tpu_torch.__main__ import main\n"
        "rc = main(sys.argv[1:])\n"
        "print(json.dumps({'rc': rc, 'torch': 'torch' in sys.modules}))\n")
    port = _free_port()
    for argv in (["serve-fleet", "--role", "broker", "--listen", str(port),
                  "--duration-s", "0.3"],
                 ["serve-fleet", "--role", "router", "--no-controller",
                  "--listen", "0", "--duration-s", "0.3"]):
        proc = subprocess.run([sys.executable, "-c", code] + argv, cwd=REPO,
                              capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr[-2000:]
        last = json.loads(proc.stdout.strip().splitlines()[-1])
        assert last == {"rc": 0, "torch": False}
        if "broker" in argv:
            assert f"BROKER 127.0.0.1:{port}" in proc.stdout


def test_worker_started_by_hand_joins_a_router_started_by_hand(tmp_path):
    port = _free_port()
    router = subprocess.Popen(
        [sys.executable, "-m", "fmda_tpu_torch", "serve-fleet", "--role",
         "router", "--no-controller", "--listen", str(port), "--workers",
         "1", "--duration-s", "6"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env={**os.environ, **ONE_THREAD})
    try:
        deadline = time.monotonic() + 60.0
        while True:  # the router's bus server listens before the worker dials
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1).close()
                break
            except OSError:
                assert time.monotonic() < deadline and router.poll() is None
                time.sleep(0.1)
        worker = _run(["serve-fleet", "--role", "worker", "--worker-id",
                       "w0", "--connect", f"127.0.0.1:{port}",
                       "--sessions", "4", "--duration-s", "30"] + SMALL,
                      timeout=90)
        out, err = router.communicate(timeout=60)
    finally:
        if router.poll() is None:
            router.kill()
    assert router.returncode == 0, err[-2000:]
    assert worker.returncode == 0, worker.stderr[-2000:]
    summary = json.loads(out)
    # the worker joined, and its goodbye brought its final stats back
    assert "w0" in summary["worker_stats"]
    stats = json.loads(worker.stdout)
    assert stats["worker"] == "w0" and stats["device"] == "cpu"


@pytest.mark.parametrize("argv,item", [
    (["--role", "local", "--no-controller", "--shard-pool"], "item 8"),
    (["--role", "worker", "--shard-pool"], "item 8"),
])
def test_roles_refuse_what_waits_and_name_its_item(capsys, argv, item):
    assert port_main(["serve-fleet"] + argv + SMALL) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and f"ROADMAP queue 1, {item}" in err


@pytest.mark.parametrize("section", ["control", "slo"])
def test_router_runs_static_when_the_config_turns_control_off(
        tmp_path, capsys, section):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({section: {"enabled": False}}))
    assert port_main(["serve-fleet", "--role", "router", "--config",
                      str(cfg), "--listen", "0", "--duration-s",
                      "0.2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["workers"] == [] and ("alerts" in out) == (section != "slo")


def test_worker_role_needs_its_id_and_router(capsys):
    assert port_main(["serve-fleet", "--role", "worker"] + SMALL) == 2
    assert "--worker-id" in capsys.readouterr().err


def test_replay_composes_with_local_only(capsys):
    for role in ("router", "worker", "broker"):
        assert port_main(["serve-fleet", "--role", role, "--replay"]
                         + SMALL) == 2
        assert "--role solo or --role local" in capsys.readouterr().err
    assert port_main(["serve-fleet", "--role", "local", "--no-controller",
                      "--continuous-train"] + SMALL) == 2
    assert "--role solo" in capsys.readouterr().err


def test_local_role_replay_hot_swaps_every_worker(tmp_path):
    """``--replay --hot-swap`` on the local role: the backfill runs
    through the router and the checkpoint is broadcast halfway; every
    worker acks the same version (spread 0), every tick served."""
    cfg = tmp_path / "replay.json"
    cfg.write_text(json.dumps({"replay": {"n_tickers": 8, "n_rounds": 12}}))
    proc = _run(["serve-fleet", "--role", "local", "--no-controller",
                 "--workers", "2", "--replay", "--hot-swap", "--config",
                 str(cfg)] + SMALL, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout)
    swap = out["hot_swap"]
    assert swap["workers_told"] == 2 and swap["round"] == 6
    assert swap["weights_versions"] == {"w0": 1, "w1": 1}
    assert swap["weights_version_spread"] == 0
    assert out["ticks_served"] == 96
