"""fmda_tpu_torch's serving path against the JAX package's, on the CPU,
for each cell family (``cell="gru"``, ``"lstm"``, ``"ssm"`` and ``"attn"``).

The JAX package's ``Warehouse`` writes a SQLite file and the port reads
the same file; the JAX ``Predictor`` and ``backtest`` and the port's run on
the same rows with weights cross-loaded from flax.  Probabilities agree to
1e-5 (float32 logits through two frameworks), labels and metrics exactly.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fmda_tpu.config import DEFAULT_TOPICS as JAX_TOPICS
from fmda_tpu.config import FeatureConfig as JaxFeatureConfig
from fmda_tpu.config import ModelConfig as JaxModelConfig
from fmda_tpu.config import WarehouseConfig as JaxWarehouseConfig
from fmda_tpu.data.normalize import chunk_norm_params as jax_chunk_norm_params
from fmda_tpu.models import build_model as jax_build_model
from fmda_tpu.serve import Predictor as JaxPredictor
from fmda_tpu.serve import backtest as jax_backtest
from fmda_tpu.stream import InProcessBus as JaxBus
from fmda_tpu.stream import Warehouse as JaxWarehouse

from fmda_tpu_torch.__main__ import main as port_main
from fmda_tpu_torch.config import (
    DEFAULT_TOPICS,
    FeatureConfig,
    ModelConfig,
    TOPIC_PREDICT_TIMESTAMP,
    TOPIC_PREDICTION,
    WarehouseConfig,
)
from fmda_tpu_torch.data.normalize import chunk_norm_params
from fmda_tpu_torch.data.synthetic import random_walk_rows
from fmda_tpu_torch.interop import params_from_flax
from fmda_tpu_torch.serve import Predictor, backtest, trading_summary
from fmda_tpu_torch.stream import InProcessBus, Warehouse
from fmda_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
WINDOW = 6
HIDDEN = 8
#: a narrow schema: 2-level book, one economic event, no COT feed
FEATURES = dict(get_cot=False, bid_levels=2, ask_levels=2,
                event_list=("Core CPI",))


def _rows(n=80, seed=0):
    return random_walk_rows(FeatureConfig(**FEATURES).table_columns(), n,
                            seed=seed)


def _jax_warehouse(path, rows):
    wh = JaxWarehouse(JaxFeatureConfig(**FEATURES),
                      JaxWarehouseConfig(path=str(path)))
    wh.insert_rows(rows)
    return wh


def _port_warehouse(path):
    return Warehouse(FeatureConfig(**FEATURES),
                     WarehouseConfig(path=str(path)))


def _models(n_features, cell="gru", seed=0):
    fields = dict(hidden_size=HIDDEN, n_features=n_features, dropout=0.0,
                  cell=cell)
    jax_cfg = JaxModelConfig(**fields)
    params = jax.device_get(jax_build_model(jax_cfg).init(
        {"params": jax.random.PRNGKey(seed)},
        jnp.zeros((1, WINDOW, n_features)))["params"])
    port_cfg = ModelConfig(**fields)
    return jax_cfg, params, port_cfg, params_from_flax(params)


@pytest.fixture(params=["gru", "lstm", "ssm", "attn"])
def served(tmp_path, request):
    """A JAX-written warehouse file, opened by both packages, with norm
    stats and cross-loaded weights of each cell family (the bidirectional
    GatedSSM re-scans each window in parallel mode, with no kernel; the
    TemporalTransformer re-encodes it through the flash op)."""
    path = tmp_path / "wh.sqlite"
    jax_wh = _jax_warehouse(path, _rows())
    port_wh = _port_warehouse(path)
    n = len(port_wh)
    x = port_wh.fetch(range(1, n + 1))
    norm = chunk_norm_params(x, port_wh.x_fields, bid_levels=2, ask_levels=2)
    jax_norm = jax_chunk_norm_params(x, jax_wh.x_fields, bid_levels=2,
                                     ask_levels=2)
    np.testing.assert_array_equal(norm.x_min, jax_norm.x_min)
    np.testing.assert_array_equal(norm.x_max, jax_norm.x_max)
    models = _models(len(port_wh.x_fields), request.param)
    yield jax_wh, port_wh, norm, models
    jax_wh.close()
    port_wh.close()


@pytest.mark.parametrize("late_row", [False, True])
def test_port_warehouse_reads_the_jax_warehouse_file(tmp_path, late_row):
    path = tmp_path / "wh.sqlite"
    rows = _rows(70, seed=1)
    writer = _jax_warehouse(path, rows[:40])
    port = _port_warehouse(path)
    port.fetch(range(1, 41))  # caches built, then extended below
    tail = rows[40:]
    if late_row:  # an older timestamp landing after newer ones
        tail = tail[:5] + [dict(rows[38], Timestamp="2024-01-02 09:31:00")] \
            + tail[5:]
    writer.insert_rows(tail)
    n = len(writer)
    assert len(port) == n
    assert port.x_fields == writer.x_fields
    ids = range(1, n + 1)
    np.testing.assert_array_equal(port.fetch(ids), writer.fetch(ids))
    np.testing.assert_array_equal(port.fetch_targets(ids),
                                  writer.fetch_targets(ids))
    for ts in (rows[0]["Timestamp"], rows[39]["Timestamp"],
               rows[-1]["Timestamp"], "1999-01-01 00:00:00"):
        assert port.id_for_timestamp(ts) == writer.id_for_timestamp(ts)
    assert port.timestamps_after(n - 3) == writer.timestamps_after(n - 3)
    writer.close()
    port.close()


def test_port_predictor_matches_jax_predictor(served):
    jax_wh, port_wh, norm, (jax_cfg, params, port_cfg, state) = served
    jax_bus, port_bus = JaxBus(JAX_TOPICS), InProcessBus(DEFAULT_TOPICS)
    common = dict(window=WINDOW, from_end=False, max_staleness_s=None)
    jax_pred = JaxPredictor(jax_bus, jax_wh, jax_cfg, params, norm, **common)
    port_pred = Predictor(port_bus, port_wh, port_cfg, state, norm,
                          device="cpu", **common)
    n = len(port_wh)
    stamps = [ts for _, ts in port_wh.timestamps_after(n - 8)]
    # a row without a full window and an unknown timestamp are skipped
    stamps += [port_wh.timestamps_after(1)[0][1], "1999-01-01 00:00:00"]
    for ts in stamps:
        jax_bus.publish(TOPIC_PREDICT_TIMESTAMP, {"Timestamp": ts})
        port_bus.publish(TOPIC_PREDICT_TIMESTAMP, {"Timestamp": ts})
    want, got = jax_pred.poll(), port_pred.poll()
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.timestamp == w.timestamp
        assert g.labels == w.labels and g.label_indices == w.label_indices
        np.testing.assert_allclose(g.probabilities, w.probabilities, atol=TOL)
    published = port_bus.consumer(TOPIC_PREDICTION).poll()
    assert [r.value["timestamp"] for r in published] == stamps[:8]
    assert set(published[0].value) == {
        "timestamp", "probabilities", "prob_threshold", "pred_indices",
        "pred_labels"}
    assert port_pred.poll() == []


def test_port_backtest_matches_jax_backtest(served):
    jax_wh, port_wh, norm, (jax_cfg, params, port_cfg, state) = served
    want = jax_backtest(jax_wh, jax_cfg, params, norm, window=WINDOW,
                        batch_size=16)
    got = backtest(port_wh, port_cfg, state, norm, window=WINDOW,
                   batch_size=16, device="cpu")
    assert got.first_row_id == want.first_row_id == WINDOW
    np.testing.assert_allclose(got.probabilities, want.probabilities,
                               atol=TOL)
    np.testing.assert_array_equal(got.targets, want.targets)
    for g, w in zip(got.metrics, want.metrics):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert trading_summary(got) == pytest.approx(trading_summary(want))


def test_backtest_id_range_validation(served):
    _, port_wh, norm, (_, _, port_cfg, state) = served
    r = backtest(port_wh, port_cfg, state, norm, window=WINDOW, ids=(10, 20),
                 device="cpu")
    assert r.probabilities.shape == (11, 4)
    with pytest.raises(ValueError, match="invalid"):
        backtest(port_wh, port_cfg, state, norm, window=WINDOW,
                 ids=(10, 999), device="cpu")
    with pytest.raises(ValueError, match="trailing window"):
        backtest(port_wh, port_cfg, state, norm, window=WINDOW,
                 ids=(1, 20), device="cpu")


def test_checkpoint_round_trip(tmp_path, served):
    _, _, norm, (_, _, _, state) = served
    assert latest_checkpoint(str(tmp_path / "none")) is None
    save_checkpoint(str(tmp_path / "ckpt"), state, norm, step=3)
    path = save_checkpoint(str(tmp_path / "ckpt"), state, norm, step=12)
    assert latest_checkpoint(str(tmp_path / "ckpt")) == path
    tree, restored = restore_checkpoint(path)
    assert tree["step"] == 12
    assert tree["params"].keys() == state.keys()
    for k in state:
        assert torch.equal(tree["params"][k], state[k])
    np.testing.assert_array_equal(restored.x_min, norm.x_min)
    np.testing.assert_array_equal(restored.x_max, norm.x_max)
    with pytest.raises(ValueError, match="not an fmda_tpu_torch checkpoint"):
        torch.save({"params": state}, str(tmp_path / "foreign.pt"))
        restore_checkpoint(str(tmp_path / "foreign.pt"))


def _cli_fixture(tmp_path, served):
    _, port_wh, norm, (_, _, port_cfg, state) = served
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), state, norm)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "features": FEATURES,
        "model": {"hidden_size": HIDDEN, "dropout": 0.0,
                  "cell": port_cfg.cell},
        "train": {"window": WINDOW, "epochs": 3},  # epochs: train only
        "runtime": {"window": 30, "max_linger_ms": 2.0},  # a key skipped
        "fleet": {"n_workers": 2},  # a section this package skips
    }))
    return port_wh.config.path, ckpt, str(cfg), len(port_wh)


def test_cli_backtest_on_the_cpu(tmp_path, served):
    wh, ckpt, cfg, n = _cli_fixture(tmp_path, served)
    proc = subprocess.run(
        [sys.executable, "-m", "fmda_tpu_torch", "backtest", "--device",
         "cpu", "--config", cfg, "--warehouse", wh, "--checkpoint", ckpt],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith(f"backtest over {n - WINDOW + 1} rows: ")
    assert [ln.split()[0] for ln in lines[2:]] == [
        "up1", "up2", "down1", "down2", "overall"]


def test_cli_serve_once_from_start(tmp_path, served, capsys):
    wh, ckpt, cfg, n = _cli_fixture(tmp_path, served)
    rc = port_main(["serve", "--device", "cpu", "--config", cfg,
                    "--warehouse", wh, "--checkpoint", ckpt, "--once",
                    "--from-start"])
    assert rc == 0
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(out) == n - WINDOW + 1
    assert set(out[0]) == {"timestamp", "probabilities", "labels"}
