"""fmda_tpu_torch's composition root against ``fmda_tpu.app.Application``.

Both packages' applications, built from the same config, acquire the
same fake session (the reference app tests' clients) tick by tick; their
engine stats, warehouse rows and served counts must be equal, and their
attached consumers (a carried-state streaming predictor and the batched
Predictor, on weights cross-loaded through ``interop.params_from_flax``)
must publish probabilities within 1e-5 (float32).  Then the supervised
loop, ``default_bus``, the stage timings, the fleet attachment, training,
the solo Predictor from a port checkpoint, and ``ingest`` through the
app."""

import datetime as dt
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fmda_tpu.app import Application as JaxApplication
from fmda_tpu.config import FrameworkConfig as JaxFrameworkConfig
from fmda_tpu.config import ModelConfig as JaxModelConfig
from fmda_tpu.config import TrainConfig as JaxTrainConfig
from fmda_tpu.config import WarehouseConfig as JaxWarehouseConfig
from fmda_tpu.data.normalize import NormParams as JaxNormParams
from fmda_tpu.models import build_model as jax_build_model
from fmda_tpu.serve import StreamingBiGRU as JaxStreamingBiGRU
import fmda_tpu.ingest as jax_ingest

import fmda_tpu_torch.ingest as port_ingest
from fmda_tpu_torch.__main__ import main as port_main
from fmda_tpu_torch.app import Application, default_bus
from fmda_tpu_torch.config import (
    TOPIC_PREDICTION,
    FeatureConfig,
    FrameworkConfig,
    ModelConfig,
    TrainConfig,
    WarehouseConfig,
    config_from_dict,
)
from fmda_tpu_torch.data.normalize import NormParams
from fmda_tpu_torch.interop import params_from_flax
from fmda_tpu_torch.serve import StreamingBiGRU
from fmda_tpu_torch.stream import InProcessBus, Warehouse
from fmda_tpu_torch.stream.native_bus import NativeBus, native_available
from fmda_tpu_torch.train.checkpoint import save_checkpoint

from test_torch_adapters import SMALL

TOL = 1e-5
WINDOW = 3
HIDDEN = 4


def _configs():
    train = dict(batch_size=8, window=WINDOW, chunk_size=20, epochs=1)
    from fmda_tpu.config import FeatureConfig as JaxFeatureConfig

    jax_cfg = JaxFrameworkConfig(
        features=JaxFeatureConfig(**SMALL),
        warehouse=JaxWarehouseConfig(path=":memory:"),
        model=JaxModelConfig(hidden_size=HIDDEN, dropout=0.0,
                             use_pallas=False),
        train=JaxTrainConfig(**train))
    port_cfg = FrameworkConfig(
        features=FeatureConfig(**SMALL),
        warehouse=WarehouseConfig(path=":memory:"),
        model=ModelConfig(hidden_size=HIDDEN, dropout=0.0),
        train=TrainConfig(**train))
    return jax_cfg, port_cfg


class _FakeSession:
    """Deterministic stand-ins for the ingestion clients (the reference
    app tests'), over one package's client classes."""

    def __init__(self, fc, ingest):
        self.fc, self.ingest, self.tick = fc, ingest, 0

    def now(self):
        return dt.datetime(2020, 2, 7, 9, 30, 0) + dt.timedelta(
            minutes=5 * self.tick)

    def clients(self):
        outer = self

        class Transport:
            def get(self, url, headers=None):
                i = outer.tick
                ts = outer.now().strftime("%Y-%m-%d %H:%M:%S")
                if "deep/book" in url:
                    book = {
                        "bids": [{"price": 100.0 - lv * 0.1 + i,
                                  "size": 50 + lv}
                                 for lv in range(outer.fc.bid_levels)],
                        "asks": [{"price": 100.2 + lv * 0.1 + i,
                                  "size": 40 + lv}
                                 for lv in range(outer.fc.ask_levels)]}
                    return json.dumps({"SPY": book}).encode()
                if "alphavantage" in url:
                    return json.dumps({"Meta Data": {}, "S": {ts: {
                        "1. open": f"{100 + i}", "2. high": f"{101 + i}",
                        "3. low": f"{99 + i}", "4. close": f"{100.5 + i}",
                        "5. volume": "1000"}}}).encode()
                if "calendar" in url:
                    return json.dumps({"calendar": {"days": {"day": [
                        {"date": outer.now().strftime("%Y-%m-%d"),
                         "status": "open",
                         "open": {"start": "09:30", "end": "16:00"}}]}}}
                    ).encode()
                if "cnbc" in url:
                    return b'<span class="last original">16.0</span>'
                raise ValueError(url)

        t, m = Transport(), self.ingest
        return dict(iex=m.IEXClient("tok", t),
                    alpha_vantage=m.AlphaVantageClient("tok", t),
                    calendar=m.TradierCalendarClient("tok", t),
                    vix_scraper=m.VIXScraper(t), now_fn=self.now)


def _tick(app, fake):
    """One acquisition tick, the indicator template published first (the
    small config has one event)."""
    msg = app.config.features.empty_ind_message()
    msg["Timestamp"] = fake.now().strftime("%Y-%m-%d %H:%M:%S")
    app.bus.publish("ind", msg)
    out = app.run_tick()
    fake.tick += 1
    return out


def _flax_params(cfg, n_features, *, seed=0):
    return jax.device_get(jax_build_model(cfg).init(
        {"params": jax.random.PRNGKey(seed)},
        jnp.zeros((1, WINDOW, n_features)))["params"])


def test_application_full_loop_matches_the_reference():
    jax_cfg, port_cfg = _configs()
    apps = {"jax": JaxApplication(jax_cfg),
            "port": Application(port_cfg, device="cpu")}
    fakes = {"jax": _FakeSession(jax_cfg.features, jax_ingest),
             "port": _FakeSession(port_cfg.features, port_ingest)}
    for name, app in apps.items():
        app.attach_session(**fakes[name].clients())
        for _ in range(30):
            _tick(app, fakes[name])
    ref, ours = apps["jax"], apps["port"]
    assert ours.stats == ref.stats
    assert ours.stats["warehouse_rows"] == 30
    # the key sets chip_smoke.py holds the card's run to are the
    # reference's
    import chip_smoke

    assert tuple(sorted(ref.stats)) == chip_smoke.APP_STATS_KEYS
    assert tuple(sorted(ref.stage_timings)) == chip_smoke.APP_STAGE_KEYS
    assert sorted(ours.stage_timings) == sorted(ref.stage_timings)
    assert ours.stats["dropped"] == 0
    n = len(ours.warehouse)
    assert ours.warehouse.timestamps() == ref.warehouse.timestamps()
    np.testing.assert_array_equal(ours.warehouse.fetch(range(1, n + 1)),
                                  ref.warehouse.fetch(range(1, n + 1)))

    # the consumers, on one set of weights: a carried-state stream and
    # the batched Predictor
    f = len(ours.warehouse.x_fields)
    norm = (np.zeros(f, np.float32), np.ones(f, np.float32))
    uni = dict(hidden_size=HIDDEN, n_features=f, output_size=4,
               dropout=0.0, bidirectional=False)
    stream_params = _flax_params(JaxModelConfig(use_pallas=False, **uni), f)
    bi = dict(uni, bidirectional=True)
    fleet_params = _flax_params(JaxModelConfig(use_pallas=False, **bi), f,
                                seed=1)
    ref.attach_streaming_predictor(JaxStreamingBiGRU(
        JaxModelConfig(use_pallas=False, **uni), stream_params,
        JaxNormParams(*norm), window=WINDOW), from_end=True)
    ours.attach_streaming_predictor(StreamingBiGRU(
        ModelConfig(**uni), params_from_flax(stream_params),
        NormParams(*norm), window=WINDOW, device="cpu"), from_end=True)
    ref.attach_predictor_fleet(JaxModelConfig(use_pallas=False, **bi),
                               fleet_params, JaxNormParams(*norm),
                               max_staleness_s=None)
    ours.attach_predictor_fleet(ModelConfig(**bi),
                                params_from_flax(fleet_params),
                                NormParams(*norm), max_staleness_s=None)
    served = {name: [] for name in apps}
    for name, app in apps.items():
        offset = app.bus.end_offset(TOPIC_PREDICTION)
        for _ in range(4):
            served[name].append(_tick(app, fakes[name])["served"])
        served[name] = (served[name], app.bus.read(TOPIC_PREDICTION, offset))
    assert served["port"][0] == served["jax"][0]
    assert sum(served["port"][0]) == 2 * 4
    ours_msgs, ref_msgs = served["port"][1], served["jax"][1]
    assert len(ours_msgs) == len(ref_msgs) == 8
    for a, b in zip(ours_msgs, ref_msgs):
        assert a.value["timestamp"] == b.value["timestamp"]
        np.testing.assert_allclose(a.value["probabilities"],
                                   b.value["probabilities"], atol=TOL,
                                   rtol=0)
    assert ours.stats == ref.stats
    for app in apps.values():
        app.close()


def test_application_trains_and_serves_its_checkpoint(tmp_path):
    """``train`` on what was acquired, the checkpoint written, then the
    solo Predictor from it on the app's bus."""
    _, cfg = _configs()
    app = Application(cfg, device="cpu")
    fake = _FakeSession(cfg.features, port_ingest)
    app.attach_session(**fake.clients())
    for _ in range(30):
        _tick(app, fake)
    state, history, dataset = app.train()
    assert np.isfinite(history["train"][0].loss)
    ckpt = save_checkpoint(str(tmp_path), state, dataset.final_norm_params)
    predictor = app.attach_predictor_from_checkpoint(
        ckpt, window=WINDOW, max_staleness_s=None)
    assert predictor in app.predictors
    outs = [_tick(app, fake) for _ in range(3)]
    assert [o["served"] for o in outs] == [1, 1, 1]
    assert app.stats["warehouse_rows"] == 33
    app.close()


def test_application_attaches_a_fleet_sized_by_the_runtime_config():
    cfg = config_from_dict({"runtime": {"capacity": 16, "bucket_sizes": [4],
                                        "max_linger_ms": 0.0}})
    app = Application(cfg, device="cpu")
    model_cfg = ModelConfig(hidden_size=4, n_features=6, bidirectional=False,
                            dropout=0.0)
    from fmda_tpu_torch.models import build_model

    gateway = app.attach_fleet(model_cfg, build_model(model_cfg).state_dict())
    assert app.fleet is gateway and gateway.pool.capacity == 16
    for i in range(4):
        gateway.open_session(f"s{i}")
        gateway.submit(f"s{i}", np.ones(6, np.float32))
    assert len(gateway.pump(force=True)) + len(gateway.drain()) == 4
    assert app.stats["fleet"]["counters"]["ticks_served"] == 4
    assert any(k.startswith("fleet.") for k in app.stage_timings)
    app.close()


def test_run_forever_supervision():
    """Failing ticks back off exponentially and recover; persistent
    failure raises after max_restarts, each failure an event."""
    _, cfg = _configs()
    app = Application(cfg, device="cpu")
    calls, sleeps = {"n": 0}, []
    original = app.run_tick

    def flaky_tick():
        calls["n"] += 1
        if calls["n"] in (2, 3):
            raise RuntimeError("transient")
        return original()

    app.run_tick = flaky_tick
    app.run_forever(interval_s=1.0, max_restarts=5, sleep_fn=sleeps.append,
                    should_stop=lambda: calls["n"] >= 6)
    assert calls["n"] >= 6
    assert sleeps[:4] == [1.0, 2.0, 4.0, 1.0]
    errors = [e for e in app.observability.events.tail()
              if e["kind"] == "app.tick_error"]
    assert [e["consecutive"] for e in errors] == [1, 2]

    app2 = Application(cfg, device="cpu")
    app2.run_tick = lambda: (_ for _ in ()).throw(RuntimeError("down"))
    with pytest.raises(RuntimeError, match="down"):
        app2.run_forever(max_restarts=2, sleep_fn=lambda s: None)
    for a in (app, app2):
        a.close()


def test_default_bus_and_the_defaults():
    app = Application()
    assert app.stats["warehouse_rows"] == 0
    assert len(app.warehouse.x_fields) == 108
    expected = NativeBus if native_available() else InProcessBus
    assert type(app.bus) is expected and type(default_bus(app.config)) is \
        expected
    app.bus.publish("deep", {"Timestamp": "2020-01-01 00:00:00"})
    with pytest.raises(KeyError):
        app.bus.publish("bogus", {})
    app.run_tick()
    timings = app.stage_timings
    assert {"ingest", "join"} <= set(timings)
    assert all(t["count"] >= 1 for t in timings.values())
    assert set(app.stats) == set(JaxApplication().stats)
    app.close()


def test_default_bus_falls_back_to_the_python_bus(monkeypatch, caplog):
    import fmda_tpu_torch.stream.native_bus as native_bus

    monkeypatch.setattr(native_bus, "native_available", lambda: False)
    bus = default_bus(config_from_dict({"bus": {"capacity": 9}}))
    assert type(bus) is InProcessBus and bus._capacity == 9
    assert "native bus unavailable" in caplog.text


def test_engine_config_selects_the_native_join():
    from fmda_tpu_torch.data.synthetic import (
        SyntheticMarketConfig, synthetic_session_messages)
    from fmda_tpu_torch.stream.native_join import native_join_available

    if not native_join_available():
        pytest.skip("no host C++ compiler")
    results = {}
    for backend in ("python", "native"):
        cfg = config_from_dict({"engine": {"join_backend": backend}})
        app = Application(cfg)
        assert app.engine.join_backend == backend
        for topic, msg in synthetic_session_messages(
                cfg.features, SyntheticMarketConfig(seed=4, n_days=1)):
            app.bus.publish(topic, msg)
        app.engine.step()
        results[backend] = (dict(app.engine.stats),
                            app.warehouse.timestamps())
        app.close()
    assert results["python"] == results["native"]
    assert results["python"][0]["emitted"] == 78


def test_a_model_method_needs_the_card_unless_told(monkeypatch):
    """The application itself needs no card (ingest runs none); a method
    that builds a model resolves the device and names ``device="cpu"``."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    app = Application()
    model_cfg = ModelConfig(hidden_size=4, n_features=6, bidirectional=False,
                            dropout=0.0)
    from fmda_tpu_torch.models import build_model

    with pytest.raises(RuntimeError, match="device='cpu'"):
        app.attach_fleet(model_cfg, build_model(model_cfg).state_dict())
    app.close()


def test_ingest_runs_through_the_application(tmp_path, capsys):
    from fmda_tpu.cli import main as jax_main

    ours, ref = str(tmp_path / "ours.sqlite"), str(tmp_path / "ref.sqlite")
    assert port_main(["ingest", "--warehouse", ours,
                      "--synthetic-days", "2"]) == 0
    assert jax_main(["ingest", "--warehouse", ref,
                     "--synthetic-days", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"warehouse {ours}: 156 rows; engine ")
    fc = FeatureConfig()
    a, b = (Warehouse(fc, WarehouseConfig(path=p)) for p in (ours, ref))
    assert a.timestamps() == b.timestamps()
    np.testing.assert_array_equal(a.fetch(range(1, 157)),
                                  b.fetch(range(1, 157)))
    a.close()
    b.close()
