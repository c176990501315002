"""The data plane slice as a whole, fmda_tpu_torch against ``fmda_tpu``:
the synthetic feeds through each package's bus, engine and warehouse,
then a live day bar by bar into each package's ``Predictor`` (weights
carried across from flax by ``interop.params_from_flax``), probabilities
within 1e-5 (float32); the port's ``StreamingPredictor`` on the same bus;
and the CLI's ``demo`` and ``ingest`` (synthetic and ``--replay``) against
the reference's row counts and schemas."""

import dataclasses
import datetime as dt
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fmda_tpu.cli import main as jax_main
from fmda_tpu.config import DEFAULT_TOPICS as JAX_TOPICS
from fmda_tpu.config import FeatureConfig as JaxFeatureConfig
from fmda_tpu.config import ModelConfig as JaxModelConfig
from fmda_tpu.config import WarehouseConfig as JaxWarehouseConfig
from fmda_tpu.data.synthetic import SyntheticMarketConfig as JaxMarket
from fmda_tpu.data.synthetic import build_corpus as jax_build_corpus
from fmda_tpu.models import build_model as jax_build_model
from fmda_tpu.serve import Predictor as JaxPredictor
from fmda_tpu.stream import InProcessBus as JaxBus
from fmda_tpu.stream import StreamEngine as JaxEngine
from fmda_tpu.stream import Warehouse as JaxWarehouse

from fmda_tpu_torch.__main__ import main as port_main
from fmda_tpu_torch.config import (
    DEFAULT_TOPICS,
    TOPIC_PREDICTION,
    FeatureConfig,
    ModelConfig,
    WarehouseConfig,
)
from fmda_tpu_torch.data.normalize import chunk_norm_params
from fmda_tpu_torch.data.synthetic import (
    BARS_PER_DAY,
    SyntheticMarketConfig,
    synthetic_session_messages,
)
from fmda_tpu_torch.interop import params_from_flax
from fmda_tpu_torch.serve import (
    Predictor,
    StreamingBiGRU,
    StreamingPredictor,
)
from fmda_tpu_torch.stream import InProcessBus, StreamEngine, Warehouse
from fmda_tpu_torch.train.checkpoint import latest_checkpoint

TOL = 1e-5
HISTORY_DAYS = 3
LIVE_BARS = 12
WINDOW = 30
HIDDEN = 8


def _messages():
    """The history days and the live day's bars, each bar its five feed
    messages."""
    msgs = list(synthetic_session_messages(
        FeatureConfig(),
        SyntheticMarketConfig(seed=5, n_days=HISTORY_DAYS + 1)))
    per_day = 5 * BARS_PER_DAY
    history = [msgs[d * per_day:(d + 1) * per_day]
               for d in range(HISTORY_DAYS)]
    live = msgs[HISTORY_DAYS * per_day:]
    return history, [live[5 * b:5 * b + 5] for b in range(LIVE_BARS)]


def test_bus_engine_warehouse_predictor_matches_the_reference():
    history, bars = _messages()
    jax_fc, fc = JaxFeatureConfig(), FeatureConfig()
    jax_bus, bus = JaxBus(JAX_TOPICS), InProcessBus(DEFAULT_TOPICS)
    jax_wh = JaxWarehouse(jax_fc, JaxWarehouseConfig(path=":memory:"))
    wh = Warehouse(fc, WarehouseConfig(path=":memory:"))
    jax_eng, eng = JaxEngine(jax_bus, jax_wh, jax_fc), StreamEngine(bus, wh, fc)
    for day in history:  # one step a day, as build_corpus steps
        for topic, msg in day:
            jax_bus.publish(topic, msg)
            bus.publish(topic, msg)
        jax_eng.step()
        eng.step()
    n = len(wh)
    assert n == len(jax_wh) == HISTORY_DAYS * BARS_PER_DAY
    np.testing.assert_array_equal(wh.fetch(range(1, n + 1)),
                                  jax_wh.fetch(range(1, n + 1)))

    norm = chunk_norm_params(wh.fetch(range(1, n + 1)), wh.x_fields,
                             bid_levels=fc.bid_levels,
                             ask_levels=fc.ask_levels)
    fields = dict(hidden_size=HIDDEN, n_features=len(wh.x_fields),
                  dropout=0.0)
    jax_cfg = JaxModelConfig(**fields)
    params = jax.device_get(jax_build_model(jax_cfg).init(
        {"params": jax.random.PRNGKey(3)},
        jnp.zeros((1, WINDOW, fields["n_features"])))["params"])
    common = dict(window=WINDOW, from_end=True, max_staleness_s=None)
    jax_pred = JaxPredictor(jax_bus, jax_wh, jax_cfg, params, norm, **common)
    pred = Predictor(bus, wh, ModelConfig(**fields), params_from_flax(params),
                     norm, device="cpu", **common)
    stream_cfg = ModelConfig(**{**fields, "bidirectional": False})
    stream_params = params_from_flax(jax.device_get(jax_build_model(
        JaxModelConfig(**{**fields, "bidirectional": False})).init(
        {"params": jax.random.PRNGKey(4)},
        jnp.zeros((1, WINDOW, fields["n_features"])))["params"]))
    streaming = StreamingPredictor(
        bus, wh, StreamingBiGRU(stream_cfg, stream_params, norm,
                                window=WINDOW, device="cpu"), from_end=True)

    served, jax_served, streamed = [], [], []
    for bar in bars:  # the live day, bar by bar
        for topic, msg in bar:
            jax_bus.publish(topic, msg)
            bus.publish(topic, msg)
        assert jax_eng.step() == eng.step() == 1
        served += pred.poll()
        jax_served += jax_pred.poll()
        streamed += streaming.poll()
    assert len(served) == len(jax_served) == len(streamed) == LIVE_BARS
    for ours, ref in zip(served, jax_served):
        assert ours.timestamp == ref.timestamp
        np.testing.assert_allclose(ours.probabilities, ref.probabilities,
                                   rtol=0, atol=TOL)
        assert ours.labels == ref.labels
    assert [s[0] for s in streamed] == [p.timestamp for p in served]
    assert all(np.isfinite(s[1]).all() for s in streamed)
    assert eng.stats == jax_eng.stats
    # both Predictors and the streaming one publish on the prediction topic
    published = bus.read(TOPIC_PREDICTION, 0)
    assert len(published) == 2 * LIVE_BARS
    ref_published = [r.value for r in jax_bus.read(TOPIC_PREDICTION, 0)]
    assert len(ref_published) == LIVE_BARS
    # a bar's Predictor message first, then the streaming one
    for ours, ref in zip([r.value for r in published][::2], ref_published):
        assert ours.keys() == ref.keys()
        assert ours["timestamp"] == ref["timestamp"]
        assert ours["pred_labels"] == list(ref["pred_labels"])
        np.testing.assert_allclose(ours["probabilities"],
                                   ref["probabilities"], rtol=0, atol=TOL)


def test_demo_command_lands_the_reference_corpus(tmp_path, capsys):
    ckpt_dir = tmp_path / "ckpt"
    assert port_main(["demo", "--days", "8", "--epochs", "1", "--device",
                      "cpu", "--checkpoint-dir", str(ckpt_dir)]) == 0
    out = capsys.readouterr().out
    ref_wh, ref_stats = jax_build_corpus(JaxFeatureConfig(),
                                         JaxMarket(seed=0, n_days=8))
    assert out.startswith(f"corpus: {len(ref_wh)} rows ({ref_stats})")
    assert len(ref_wh) == 8 * BARS_PER_DAY
    assert f"backtest over {len(ref_wh) - WINDOW + 1} rows" in out
    ckpt = latest_checkpoint(str(ckpt_dir))
    assert ckpt is not None and f"checkpoint: {ckpt}" in out


def test_ingest_command_matches_the_reference(tmp_path, capsys):
    ours, ref = tmp_path / "port.sqlite", tmp_path / "ref.sqlite"
    assert port_main(["ingest", "--warehouse", str(ours),
                      "--synthetic-days", "4", "--device", "cpu"]) == 0
    assert jax_main(["ingest", "--warehouse", str(ref),
                     "--synthetic-days", "4"]) == 0
    port_line, ref_line = capsys.readouterr().out.strip().splitlines()[-2:]
    assert port_line.replace(str(ours), "W") == ref_line.replace(str(ref), "W")
    port_wh = Warehouse(FeatureConfig(), WarehouseConfig(path=str(ours)))
    ref_wh = JaxWarehouse(JaxFeatureConfig(),
                          JaxWarehouseConfig(path=str(ref)))
    n = len(ref_wh)
    assert len(port_wh) == n == 4 * BARS_PER_DAY
    assert port_wh.x_fields == ref_wh.x_fields
    np.testing.assert_array_equal(port_wh.fetch(range(1, n + 1)),
                                  ref_wh.fetch(range(1, n + 1)))
    # the same seed again lands nothing (the engine dedupes by timestamp)
    assert port_main(["ingest", "--warehouse", str(ours),
                      "--synthetic-days", "4"]) == 0
    assert len(port_wh) == n
    assert port_main(["ingest", "--warehouse", str(ours)]) == 2
    port_wh.close()
    ref_wh.close()


def test_ingest_replay_matches_the_reference(tmp_path, capsys):
    """A recorded session (a RecordingTransport file) replayed through
    the acquisition layer by both CLIs lands the same rows."""
    from test_torch_ingest import _fixtures

    import fmda_tpu_torch.ingest as ingest

    recording = str(tmp_path / "session.json")
    with ingest.RecordingTransport(ingest.ReplayTransport(_fixtures()),
                                   recording) as rec:
        for url in ("https://api.tradier.com/v1/markets/calendar",
                    "https://cloud.iexapis.com/v1/deep/book?symbols=spy&"
                    "token=REAL&format=json",
                    "https://www.alphavantage.co/query?function="
                    "TIME_SERIES_INTRADAY&symbol=SPY&interval=5min&apikey="
                    "REAL&datatype=json",
                    "https://www.investing.com/economic-calendar/",
                    "https://www.cnbc.com/quotes/?symbol=.VIX",
                    "https://www.tradingster.com/cot",
                    "https://www.tradingster.com/cot/tff/13874A"):
            rec.get(url)
    ours, ref = tmp_path / "port.sqlite", tmp_path / "ref.sqlite"
    args = ["--replay", recording, "--ticks", "6"]
    assert port_main(["ingest", "--warehouse", str(ours)] + args) == 0
    assert jax_main(["ingest", "--warehouse", str(ref)] + args) == 0
    port_wh = Warehouse(FeatureConfig(), WarehouseConfig(path=str(ours)))
    ref_wh = JaxWarehouse(JaxFeatureConfig(),
                          JaxWarehouseConfig(path=str(ref)))
    n = len(ref_wh)
    assert len(port_wh) == n == 6
    assert port_wh.timestamps() == ref_wh.timestamps()
    np.testing.assert_array_equal(port_wh.fetch(range(1, n + 1)),
                                  ref_wh.fetch(range(1, n + 1)))
    # a start the recording's calendar does not open: nothing replayed
    assert port_main(["ingest", "--warehouse", str(ours), "--replay",
                      recording, "--replay-start",
                      "2020-02-08 09:30:00"]) == 2
    port_wh.close()
    ref_wh.close()


def test_ingest_wires_the_journal_and_refuses_the_native_join(tmp_path,
                                                              capsys):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "warehouse": {"journal_path": str(tmp_path / "journal"),
                      "journal_format": "binary"}}))
    assert port_main(["ingest", "--config", str(cfg), "--warehouse",
                      str(tmp_path / "w.sqlite"), "--synthetic-days", "1",
                      "--engine-checkpoint",
                      str(tmp_path / "engine.json")]) == 0
    state = json.loads((tmp_path / "engine.json").read_text())
    assert state["emitted"] == BARS_PER_DAY
    # the native join is ported: the same day lands through it, and the
    # rows are the python join's
    cfg.write_text(json.dumps({"engine": {"join_backend": "native"}}))
    capsys.readouterr()
    assert port_main(["ingest", "--config", str(cfg), "--warehouse",
                      str(tmp_path / "w2.sqlite"),
                      "--synthetic-days", "1"]) == 0
    assert f"w2.sqlite: {BARS_PER_DAY} rows" in capsys.readouterr().out
    fc = FeatureConfig()
    native = Warehouse(fc, WarehouseConfig(path=str(tmp_path / "w2.sqlite")))
    python = Warehouse(fc, WarehouseConfig(path=str(tmp_path / "w.sqlite")))
    assert native.timestamps() == python.timestamps()
    ids = range(1, BARS_PER_DAY + 1)
    np.testing.assert_array_equal(native.fetch(ids), python.fetch(ids))
    native.close()
    python.close()


def test_ingest_stack_follows_the_config(tmp_path):
    """``ingest``'s stack is the Application the config builds: the
    journal wrap, the engine's knobs, the bus's topics and retention."""
    from fmda_tpu_torch.app import Application
    from fmda_tpu_torch.config import config_from_dict
    from fmda_tpu_torch.stream import BufferedWarehouse

    def ingest_stack(cfg):
        app = Application(cfg)
        app.close()
        return app.bus, app.warehouse, app.engine

    cfg = config_from_dict({
        "bus": {"capacity": 1000},
        "warehouse": {"path": str(tmp_path / "w.sqlite"),
                      "journal_path": str(tmp_path / "journal"),
                      "journal_bound": 7, "journal_format": "binary"},
        "engine": {"checkpoint_every": 3, "staleness_deadline_s": 600}})
    bus, wh, eng = ingest_stack(cfg)
    assert isinstance(wh, BufferedWarehouse)
    assert (wh._bound, wh._fmt) == (7, "binary")
    assert set(bus.topics()) == set(DEFAULT_TOPICS)
    for i in range(1001):  # bus.capacity records retained a topic
        bus.publish("vix", {"i": i})
    assert bus.read("vix", 0)[0].value == {"i": 1}
    assert (eng.checkpoint_every, eng.staleness_deadline_s) == (3, 600)
    wh.close()
    bus, wh, eng = ingest_stack(dataclasses.replace(
        cfg, warehouse=WarehouseConfig(path=":memory:")))
    assert isinstance(wh, Warehouse)
