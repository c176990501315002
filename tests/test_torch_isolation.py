"""fmda_tpu_torch stands alone: no JAX, and nothing of fmda_tpu.

A clean interpreter imports every module of the port and must find no
``jax``, ``flax``, ``orbax`` or ``fmda_tpu`` module loaded; an AST scan
holds ``chip_smoke.py`` (which runs where JAX is not installed) to the
same.  And the port's entry points never fall back to the CPU unasked.
"""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import fmda_tpu_torch
from fmda_tpu_torch.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "fmda_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(fmda_tpu_torch.__path__,
                                              "fmda_tpu_torch."))


def test_every_port_module_imports_without_jax_or_fmda_tpu():
    modules = _port_modules()
    for name in ("ops._cuda_lib", "ops.gru_kernel", "ops.lstm_kernel",
                 "ops.lstm", "models.bilstm", "serve.predictor",
                 "train.trainer", "train.losses", "train.checkpoint",
                 "data.pipeline", "__main__", "ops.ssm", "ops.ssm_kernel",
                 "models.ssm", "serve.streaming", "runtime",
                 "runtime.session_pool", "ops.attention",
                 "ops.attention_kernel", "models.attn", "ops.scan_dw",
                 "stream.codec", "stream.bus", "stream.warehouse",
                 "obs", "obs.registry", "utils.tracing", "utils.timeutils",
                 "runtime.batcher", "runtime.metrics", "runtime.gateway",
                 "runtime.predictor_pool", "runtime.loadgen",
                 "stream.engine", "stream.journal", "ops.microstructure",
                 "data.synthetic", "utils.jsonutils", "ingest",
                 "ingest.htmldom", "ingest.transport", "ingest.clients",
                 "ingest.scrapers", "ingest.session", "obs.prometheus",
                 "obs.trace", "obs.events", "obs.server", "obs.pyprof",
                 "obs.device", "obs.quality", "obs.observability",
                 "obs.report", "ops.cost", "app", "stream._native",
                 "stream.native_bus", "stream.native_join",
                 "stream.kafka_bus", "stream.mysql_warehouse", "replay",
                 "replay.history", "replay.driver", "replay.reference",
                 "eval.shadow", "fleet", "fleet.hashring",
                 "fleet.membership", "fleet.state", "fleet.wire",
                 "fleet.router", "fleet.worker", "fleet.launcher", "chaos",
                 "chaos.plan", "chaos.inject", "obs.tsdb", "obs.slo",
                 "obs.recorder", "obs.aggregate", "_lazy"):
        assert f"fmda_tpu_torch.{name}" in modules
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = [name for name in json.loads(proc.stdout)
              if _forbidden(name)]
    assert loaded == []


#: the modules a router-role process imports, the counterpart of the
#: reference's ``fmda_tpu.analysis.hygiene.ROUTER_ROLE_MODULES``, with the
#: fleet telemetry and chaos it runs beside them
ROUTER_ROLE_MODULES = (
    "fleet", "fleet.hashring", "fleet.launcher", "fleet.membership",
    "fleet.router", "fleet.state", "fleet.wire", "chaos", "chaos.plan",
    "chaos.inject", "obs.tsdb", "obs.slo", "obs.recorder", "obs.aggregate",
    "config", "__main__", "_lazy",
)


def test_router_role_modules_import_without_torch():
    """A router is a bus-only host: a clean interpreter imports every
    router-role module (and the package itself) without loading torch."""
    mods = ", ".join(f"fmda_tpu_torch.{m}" for m in ROUTER_ROLE_MODULES)
    code = (f"import sys, fmda_tpu_torch, {mods}\n"
            "sys.exit(1 if 'torch' in sys.modules else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("path", ["chip_smoke.py", "fmda_tpu_torch"])
def test_sources_import_nothing_of_jax_or_fmda_tpu(path):
    root = os.path.join(REPO, path)
    files = [root] if root.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(root)
        for f in fs if f.endswith(".py")]
    assert files
    for file in files:
        with open(file) as fh:
            tree = ast.parse(fh.read(), file)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{file}:{node.lineno} imports {bad}"


def test_resolve_device_defaults_to_the_card_and_never_falls_back(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_entry_points_raise_without_a_card(monkeypatch):
    from fmda_tpu_torch.config import DEFAULT_TOPICS, ModelConfig
    from fmda_tpu_torch.data.normalize import NormParams
    from fmda_tpu_torch.serve import Predictor, backtest
    from fmda_tpu_torch.stream import InProcessBus

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(hidden_size=4, n_features=3)
    norm = NormParams(np.zeros(3, np.float32), np.ones(3, np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(InProcessBus(DEFAULT_TOPICS), None, cfg, {}, norm,
                  window=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        backtest(None, cfg, {}, norm, window=2)


def test_streaming_entry_points_raise_without_a_card(monkeypatch):
    from fmda_tpu_torch.config import ModelConfig
    from fmda_tpu_torch.data.normalize import NormParams
    from fmda_tpu_torch.runtime import SessionPool
    from fmda_tpu_torch.serve import (
        StreamingBiGRU, StreamingBiGRUBidirectional)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    norm = NormParams(np.zeros(3, np.float32), np.ones(3, np.float32))
    for cell in ("gru", "lstm", "ssm"):
        uni = ModelConfig(hidden_size=4, n_features=3, cell=cell,
                          bidirectional=False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StreamingBiGRU(uni, {}, norm, window=2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SessionPool(uni, {}, capacity=2, window=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingBiGRUBidirectional(
            ModelConfig(hidden_size=4, n_features=3), {}, norm, window=2)


def test_trainer_and_train_command_raise_without_a_card(monkeypatch,
                                                       tmp_path):
    from fmda_tpu_torch.__main__ import main as port_main
    from fmda_tpu_torch.config import ModelConfig, TrainConfig
    from fmda_tpu_torch.train import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(hidden_size=4, n_features=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, TrainConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_main(["train", "--warehouse", str(tmp_path / "wh.sqlite")])
    assert not (tmp_path / "wh.sqlite").exists()  # refused before any I/O
    Trainer(cfg, TrainConfig(), device="cpu")


def test_fleet_entry_points_raise_without_a_card(monkeypatch):
    from fmda_tpu_torch.__main__ import main as port_main
    from fmda_tpu_torch.config import ModelConfig
    from fmda_tpu_torch.data.normalize import NormParams
    from fmda_tpu_torch.runtime import PredictorPool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    norm = NormParams(np.zeros(3, np.float32), np.ones(3, np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PredictorPool(ModelConfig(hidden_size=4, n_features=3), {}, norm,
                      window=2)
    for extra in ([], ["--predictor"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_main(["serve-fleet", "--sessions", "2", "--ticks", "1"]
                      + extra)
    # a fleet worker opens its pool on the card: refused before it dials
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_main(["serve-fleet", "--role", "worker", "--worker-id", "w0",
                   "--connect", "127.0.0.1:1"])


def test_demo_raises_without_a_card_and_ingest_needs_none(monkeypatch,
                                                         tmp_path):
    from fmda_tpu_torch.__main__ import main as port_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_main(["demo", "--days", "1", "--checkpoint-dir",
                   str(tmp_path / "ckpt")])
    assert not (tmp_path / "ckpt").exists()  # refused before any work
    # the engine and the acquisition layer are host code
    assert port_main(["ingest", "--warehouse", str(tmp_path / "w.sqlite"),
                      "--synthetic-days", "1"]) == 0


def test_kernel_is_not_built_at_import():
    code = (
        "import fmda_tpu_torch.ops._cuda_lib as lib, fmda_tpu_torch.serve\n"
        "import fmda_tpu_torch.ops.gru_kernel as g\n"
        "import fmda_tpu_torch.ops.lstm_kernel as l\n"
        "import fmda_tpu_torch.ops.ssm_kernel as s\n"
        "import fmda_tpu_torch.ops.attention_kernel as a\n"
        "import fmda_tpu_torch.ops.scan_dw as d\n"
        "import fmda_tpu_torch.train, fmda_tpu_torch.__main__\n"
        "import fmda_tpu_torch.runtime, fmda_tpu_torch.stream\n"
        "import fmda_tpu_torch.ingest, fmda_tpu_torch.data.synthetic\n"
        "import fmda_tpu_torch.runtime.gateway, "
        "fmda_tpu_torch.runtime.predictor_pool, "
        "fmda_tpu_torch.runtime.loadgen, fmda_tpu_torch.stream.codec\n"
        "from fmda_tpu_torch.ops import launch_counts\n"
        "assert set(launch_counts().values()) == {0}\n"
        "assert lib._lib is None and lib.build_info == {}, lib.build_info\n"
        "assert g.launches == g.bwd_launches == 0\n"
        "assert l.launches == l.bwd_launches == 0\n"
        "assert s.launches == s.tick_launches == 0\n"
        "assert a.fwd_launches == a.dkv_launches == a.dq_launches == 0\n"
        "assert a.bwd_launches == 0\n"
        "assert d.launches == 0\n"
        "assert 'triton' not in __import__('sys').modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]

