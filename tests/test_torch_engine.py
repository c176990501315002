"""fmda_tpu_torch's StreamEngine against ``fmda_tpu``'s on the same
messages: the synthetic corpus at full width (8 days, seeds 0 and 1), the
golden day, and the reference engine's own cases (late streams, watermark
drops, checkpoint resume with pending joins, idempotent replay, dedupe,
the per-message parse fallback, lag and watermark ages, degraded mode),
each scenario run through both packages and compared: warehouse rows and
targets bit for bit, signal messages and ``stats`` equal.  A checkpoint
the reference writes is restored by the port."""

import datetime as dt
import json
import os
import types

import numpy as np
import pytest

import fmda_tpu.stream.engine as jax_engine_mod
from fmda_tpu.config import FeatureConfig as JaxFeatureConfig
from fmda_tpu.config import WarehouseConfig as JaxWarehouseConfig
from fmda_tpu.data.synthetic import SyntheticMarketConfig as JaxMarket
from fmda_tpu.data.synthetic import (
    synthetic_session_messages as jax_session_messages)
from fmda_tpu.stream import InProcessBus as JaxBus
from fmda_tpu.stream import StreamEngine as JaxEngine
from fmda_tpu.stream import Warehouse as JaxWarehouse

import fmda_tpu_torch.stream.engine as engine_mod
from fmda_tpu_torch.config import (
    DEFAULT_TOPICS,
    TOPIC_DEEP,
    TOPIC_PREDICT_TIMESTAMP,
    TOPIC_VIX,
    TOPIC_VOLUME,
    FeatureConfig,
    WarehouseConfig,
)
from fmda_tpu_torch.data.synthetic import (
    SyntheticMarketConfig,
    synthetic_session_messages,
)
from fmda_tpu_torch.obs.registry import MetricsRegistry
from fmda_tpu_torch.stream import InProcessBus, StreamEngine, Warehouse

from test_stream import _session_messages

DATA = os.path.join(os.path.dirname(__file__), "data")

#: the reference engine tests' narrow schema
SMALL = dict(bid_levels=2, ask_levels=2, event_list=("Core CPI",),
             volume_ma_periods=(3,), price_ma_periods=(3,),
             delta_ma_periods=(2,), bollinger_period=3, stoch_preceding=2,
             atr_preceding=2, target_lead1=2, target_lead2=3, get_cot=False)

JAX = types.SimpleNamespace(
    name="fmda_tpu", FeatureConfig=JaxFeatureConfig,
    WarehouseConfig=JaxWarehouseConfig, Bus=JaxBus, Warehouse=JaxWarehouse,
    Engine=JaxEngine, module=jax_engine_mod)
PORT = types.SimpleNamespace(
    name="fmda_tpu_torch", FeatureConfig=FeatureConfig,
    WarehouseConfig=WarehouseConfig, Bus=InProcessBus, Warehouse=Warehouse,
    Engine=StreamEngine, module=engine_mod)


def _stack(ns, features=None, **engine_kw):
    fc = ns.FeatureConfig(**(SMALL if features is None else features))
    bus = ns.Bus(DEFAULT_TOPICS)
    wh = ns.Warehouse(fc, ns.WarehouseConfig(path=":memory:"))
    return fc, bus, wh, ns.Engine(bus, wh, fc, **engine_kw)


def _landed(wh, bus, eng):
    """Everything a run left behind, comparable across the packages."""
    n = len(wh)
    ids = range(1, n + 1)
    targets = (wh.fetch_targets(ids) if "4_close" in wh.x_fields
               else None)
    return dict(
        x_fields=tuple(wh.x_fields), timestamps=wh.timestamps(),
        x=wh.fetch(ids) if n else None, y=targets,
        signals=[r.value for r in bus.read(TOPIC_PREDICT_TIMESTAMP, 0)],
        stats=eng.stats)


def _assert_same(ours, ref):
    assert ours.keys() == ref.keys()
    for key in ref:
        if isinstance(ref[key], np.ndarray):
            assert ours[key].dtype == ref[key].dtype
            np.testing.assert_array_equal(ours[key], ref[key])
        else:
            assert ours[key] == ref[key], key


def _both(scenario):
    """Run ``scenario(ns)`` for both packages; their results equal."""
    ref, ours = scenario(JAX), scenario(PORT)
    if isinstance(ref, dict):
        _assert_same(ours, ref)
    else:
        assert ours == ref
    return ours


# -- the synthetic corpus at full width ----------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_lands_the_synthetic_corpus_as_the_reference(seed):
    """8 days at full width (108 features), the messages published in
    uneven batches with a step after each, then the rest at once."""
    msgs = list(synthetic_session_messages(
        FeatureConfig(), SyntheticMarketConfig(seed=seed, n_days=8)))
    assert msgs == list(jax_session_messages(
        JaxFeatureConfig(), JaxMarket(seed=seed, n_days=8)))

    def run(ns):
        fc, bus, wh, eng = _stack(ns, features={})
        for i, (topic, msg) in enumerate(msgs):
            bus.publish(topic, msg)
            if i % 997 == 0:
                eng.step()
        eng.step()
        return _landed(wh, bus, eng)

    out = _both(run)
    assert len(out["x_fields"]) == 108
    assert len(out["timestamps"]) == 8 * 78
    assert out["stats"]["emitted"] == 8 * 78
    assert out["stats"]["dropped"] == out["stats"]["bad_messages"] == 0


def test_engine_reproduces_the_golden_day():
    with open(os.path.join(DATA, "golden_day.jsonl")) as fh:
        messages = [json.loads(line) for line in fh]
    expected = np.load(os.path.join(DATA, "golden_day_expected.npz"),
                       allow_pickle=False)
    fc, bus, wh, eng = _stack(PORT)
    for msg in messages:
        bus.publish(msg["topic"], msg["value"])
    eng.step()
    n = len(expected["x"])
    assert len(wh) == n
    assert tuple(expected["fields"]) == wh.x_fields
    np.testing.assert_allclose(wh.fetch(range(1, n + 1)), expected["x"],
                               atol=1e-6)
    np.testing.assert_allclose(wh.fetch_targets(range(1, n + 1)),
                               expected["y"], atol=0)


# -- the reference engine's cases, held to the reference -----------------------


def test_replay_joins_all_ticks():
    def run(ns):
        fc, bus, wh, eng = _stack(ns)
        for topic, msg in _session_messages(6):
            bus.publish(topic, msg)
        assert eng.step() == 6
        return _landed(wh, bus, eng)

    out = _both(run)
    assert out["signals"][0] == {"Timestamp": "2020-02-07 09:30:00"}
    assert len(out["signals"]) == 6


def test_late_stream_is_waited_for_then_joins():
    def run(ns):
        fc, bus, wh, eng = _stack(ns)
        held = None
        for topic, msg in _session_messages(2):
            if topic == TOPIC_VIX and held is None:
                held = (topic, msg)
                continue
            bus.publish(topic, msg)
        eng.step()
        first = (eng.stats["pending"], len(wh))
        bus.publish(*held)
        eng.step()
        return first, _landed(wh, bus, eng)

    ref, ours = run(JAX), run(PORT)
    assert ours[0] == ref[0] == (1, 1)
    _assert_same(ours[1], ref[1])
    assert ours[1]["stats"]["pending"] == 0


def test_unjoinable_tick_drops_past_the_watermark():
    def run(ns):
        fc, bus, wh, eng = _stack(ns)
        for topic, msg in _session_messages(4):
            if topic == TOPIC_VIX and msg["Timestamp"].startswith(
                    "2020-02-07 09:30"):
                continue
            bus.publish(topic, msg)
        eng.step()
        return _landed(wh, bus, eng)

    out = _both(run)
    assert out["stats"]["dropped"] == 1 and len(out["timestamps"]) == 3


def test_checkpoint_resume_keeps_pending_joins(tmp_path):
    """A restart between poll and join keeps the pending book row; a
    restart after the joins re-emits nothing and new data flows."""
    def run(ns):
        path = str(tmp_path / f"{ns.name}.json")
        fc, bus, wh, eng = _stack(ns, checkpoint_path=path)
        held = []
        for topic, msg in _session_messages(3):
            if topic == TOPIC_VIX and msg["Timestamp"].startswith(
                    "2020-02-07 09:4"):
                held.append((topic, msg))
                continue
            bus.publish(topic, msg)
        eng.step()
        before = (eng.stats["pending"], len(wh))
        eng2 = ns.Engine(bus, wh, fc, checkpoint_path=path)
        restored = eng2.stats["pending"]
        for h in held:
            bus.publish(*h)
        emitted = eng2.step()
        eng3 = ns.Engine(bus, wh, fc, checkpoint_path=path)
        again = eng3.step()
        for topic, msg in _session_messages(1, start="2020-02-07 10:30:00"):
            bus.publish(topic, msg)
        later = eng3.step()
        return before, restored, emitted, again, later, _landed(wh, bus, eng3)

    ref, ours = run(JAX), run(PORT)
    assert ours[:5] == ref[:5] == ((1, 2), 1, 1, 0, 1)
    _assert_same(ours[5], ref[5])


def test_resume_replay_is_idempotent(tmp_path):
    def run(ns):
        path = str(tmp_path / f"{ns.name}.json")
        fc, bus, wh, eng = _stack(ns, checkpoint_path=path,
                                  checkpoint_every=50)
        for topic, msg in _session_messages(4):
            bus.publish(topic, msg)
        eng.step()
        eng.step()  # quiesced and dirty: the checkpoint is written here
        for topic, msg in _session_messages(3, start="2020-02-07 10:00:00"):
            bus.publish(topic, msg)
        eng.step()  # lands 3 more; the checkpoint is stale now
        eng2 = ns.Engine(bus, wh, fc, checkpoint_path=path,
                         checkpoint_every=50)
        eng2.step()
        return _landed(wh, bus, eng2)

    out = _both(run)
    assert len(out["timestamps"]) == len(set(out["timestamps"])) == 7


@pytest.mark.parametrize("seed_limit", [None, 4])
def test_dedupe_without_a_checkpoint(monkeypatch, seed_limit):
    """Duplicate feed messages land once, and a fresh engine without a
    checkpoint replays everything and lands nothing, also when the replay
    reaches deeper than the bounded in-memory seed."""
    if seed_limit is not None:
        monkeypatch.setattr(JaxEngine, "_LANDED_SEED_LIMIT", seed_limit)
        monkeypatch.setattr(StreamEngine, "_LANDED_SEED_LIMIT", seed_limit)
    n = 12 if seed_limit else 3

    def run(ns):
        fc, bus, wh, eng = _stack(ns)
        msgs = _session_messages(n)
        for topic, msg in msgs:
            bus.publish(topic, msg)
        eng.step()
        for topic, msg in msgs:
            bus.publish(topic, msg)
        eng.step()
        eng2 = ns.Engine(bus, wh, fc)
        seeded = (len(eng2._landed_ts), eng2._landed_seed_floor)
        eng2.step()
        return seeded, _landed(wh, bus, eng2)

    ref, ours = run(JAX), run(PORT)
    assert ours[0] == ref[0]
    _assert_same(ours[1], ref[1])
    assert len(ours[1]["timestamps"]) == len(set(ours[1]["timestamps"])) == n
    if seed_limit:
        assert ours[0][0] == seed_limit and ours[0][1] is not None


def test_batched_parse_falls_back_per_message(monkeypatch):
    msgs = _session_messages(3)
    poison = next(m["Timestamp"] for t, m in msgs if t == TOPIC_DEEP)

    def poisoned(real):
        def deep_features(bids, bid_sizes, asks, ask_sizes, times):
            if any(t.strftime("%Y-%m-%d %H:%M:%S") == poison for t in times):
                raise ValueError("poisoned row")
            return real(bids, bid_sizes, asks, ask_sizes, times)
        return deep_features

    for ns in (JAX, PORT):
        monkeypatch.setattr(ns.module, "deep_features",
                            poisoned(ns.module.deep_features))

    def run(ns):
        fc, bus, wh, eng = _stack(ns)
        for topic, msg in msgs:
            bus.publish(topic, msg)
        eng.step()
        return _landed(wh, bus, eng)

    out = _both(run)
    assert poison not in out["timestamps"] and len(out["timestamps"]) == 2
    assert out["stats"]["bad_messages"] == 1


def test_malformed_messages_are_counted():
    def run(ns):
        fc, bus, wh, eng = _stack(ns)
        for topic, msg in _session_messages(2):
            bus.publish(topic, msg)
        bus.publish(TOPIC_DEEP, {"Timestamp": "not a time"})
        bus.publish(TOPIC_DEEP, {"Timestamp": "2020-02-07 11:00:00",
                                 "bids_0": 5})
        bus.publish(TOPIC_VOLUME, {"4_close": 1.0})
        eng.step()
        return _landed(wh, bus, eng)

    assert _both(run)["stats"]["bad_messages"] == 3


def test_lag_and_watermark_age():
    def run(ns):
        fc, bus, wh, eng = _stack(ns)
        seen = [eng.stats]
        for topic, msg in _session_messages(3):
            bus.publish(topic, msg)
        seen.append(eng.stats)
        eng.step()
        seen.append(eng.stats)
        return seen

    seen = _both(run)
    assert all(v is None for v in seen[0]["watermark_age_s"].values())
    assert set(seen[1]["consumer_lag"].values()) == {3}
    assert set(seen[2]["watermark_age_s"].values()) == {250}


def test_watermark_age_flags_a_quiet_feed():
    def run(ns):
        fc, bus, wh, eng = _stack(ns)
        for topic, msg in _session_messages(4):
            if topic == TOPIC_VIX and not msg["Timestamp"].startswith(
                    "2020-02-07 09:30"):
                continue
            bus.publish(topic, msg)
        eng.step()
        return eng.stats

    ages = _both(run)["watermark_age_s"]
    assert ages[TOPIC_VIX] - ages[TOPIC_VOLUME] == 900


def test_degraded_mode_under_a_staleness_deadline():
    """The VIX feed goes quiet for a stretch: with a deadline, book ticks
    join on the feed's last-known values (counted per topic) instead of
    stalling, and the feed re-joins when it comes back."""
    msgs = _session_messages(24)
    outage = {f"2020-02-07 {h:02d}:{m:02d}" for h, m in (
        (10, 5), (10, 10), (10, 15), (10, 20), (10, 25), (10, 30))}

    def run(ns):
        fc, bus, wh, eng = _stack(ns, staleness_deadline_s=400)
        steps = []
        for i, (topic, msg) in enumerate(msgs):
            if topic == TOPIC_VIX and msg["Timestamp"][:16] in outage:
                continue
            bus.publish(topic, msg)
            if i % 4 == 3:
                eng.step()
                steps.append((eng.stats["degraded_streams"],
                              eng.stats["pending"]))
        eng.step()
        return steps, eng.degraded_row_timestamps, _landed(wh, bus, eng)

    ref, ours = run(JAX), run(PORT)
    assert ours[:2] == ref[:2]
    _assert_same(ours[2], ref[2])
    stats = ours[2]["stats"]
    assert stats["degraded_rows"][TOPIC_VIX] > 0
    assert stats["degraded_streams"] == []
    assert any(TOPIC_VIX in d for d, _ in ours[0])
    assert len(ours[1]) == stats["degraded_rows"][TOPIC_VIX]


# -- checkpoints across the packages, and what is not ported -------------------


def test_port_restores_a_reference_checkpoint(tmp_path):
    """The reference engine checkpoints with joins pending; the port's
    engine restores that file and lands the same rows next as the
    reference's restored engine."""
    msgs = _session_messages(5)
    held = [(t, m) for t, m in msgs if t == TOPIC_VIX][2:]
    first = [(t, m) for t, m in msgs if (t, m) not in held]
    path = str(tmp_path / "engine.json")
    fc, bus, wh, eng = _stack(JAX, checkpoint_path=path)
    for topic, msg in first:
        bus.publish(topic, msg)
    eng.step()
    assert eng.stats["pending"] == 3 and len(wh) == 2
    with open(path) as fh:
        state = json.load(fh)

    def resume(ns):
        copy = str(tmp_path / f"{ns.name}-copy.json")
        with open(copy, "w") as fh:
            json.dump(state, fh)
        fc, bus, wh, _ = _stack(ns)
        for topic, msg in first:  # the bus the checkpoint's offsets index
            bus.publish(topic, msg)
        eng = ns.Engine(bus, wh, fc, checkpoint_path=copy)
        restored = eng.stats
        for topic, msg in held:
            bus.publish(topic, msg)
        eng.step()
        return restored, _landed(wh, bus, eng)

    ref, ours = resume(JAX), resume(PORT)
    assert ours[0] == ref[0]
    assert ours[0]["pending"] == 3 and ours[0]["emitted"] == 2
    _assert_same(ours[1], ref[1])
    assert len(ours[1]["timestamps"]) == 3
    # and the port's own checkpoint file is the reference's JSON layout
    with open(str(tmp_path / "fmda_tpu_torch-copy.json")) as fh:
        ours_state = json.load(fh)
    with open(str(tmp_path / "fmda_tpu-copy.json")) as fh:
        assert json.load(fh) == ours_state


def test_corrupt_checkpoint_is_a_counted_fresh_start(tmp_path):
    def run(ns):
        path = str(tmp_path / f"{ns.name}.json")
        with open(path, "w") as fh:
            fh.write('{"offsets": {"deep": ')
        fc, bus, wh, eng = _stack(ns, checkpoint_path=path)
        for topic, msg in _session_messages(2):
            bus.publish(topic, msg)
        eng.step()
        return os.path.exists(path + ".corrupt"), _landed(wh, bus, eng)

    ref, ours = run(JAX), run(PORT)
    assert ours[0] is ref[0] is True
    _assert_same(ours[1], ref[1])
    assert ours[1]["stats"]["checkpoint_corrupt"] == 1


def test_step_histogram_and_stage_timer():
    registry = MetricsRegistry()
    fc, bus, wh, eng = _stack(PORT, metrics=registry)
    for topic, msg in _session_messages(3):
        bus.publish(topic, msg)
    eng.step()
    eng.step()
    hist = registry.histogram("engine_step_seconds")
    assert hist.n == 2
    assert {"ingest", "join", "land", "signal"} <= set(eng.timer.summary())


def test_native_join_backend_names_its_roadmap_item():
    """``join_backend="native"`` runs the C++ scheduler now (ROADMAP queue
    1, item 4 is done): the port's native engine lands what the
    reference's native engine lands, bit for bit; an unknown backend is
    still refused by name."""
    from fmda_tpu.stream.native_join import native_join_available

    if not native_join_available():
        pytest.skip("no host C++ compiler for the reference's native join")
    results = []
    for ns in (JAX, PORT):
        fc, bus, wh, eng = _stack(ns, join_backend="native")
        for topic, msg in _session_messages(6):
            bus.publish(topic, msg)
        eng.step()
        results.append(_landed(wh, bus, eng))
    _assert_same(results[1], results[0])
    assert eng.join_backend == "native" and eng._core is not None
    with pytest.raises(ValueError, match="join_backend 'nope'"):
        _stack(PORT, join_backend="nope")
