"""fmda_tpu_torch's native host components against ``fmda_tpu``'s: the C++
ring bus (``NativeBus``) and the C++ join scheduler (``join_backend=
"native"``), both built from the repository's ``native/`` sources by the
host's ``g++`` into ``build/fmda_tpu_torch/native/``.

The bus: the same offsets, records, retention and consumers as the
reference's ``NativeBus`` and ``InProcessBus`` on the same publishes
(``tests/test_native_bus.py``'s cases), and the per-topic counters of
``bind_metrics``.  The join: bit for bit the port's python join and the
reference engine's, on the synthetic corpus; the loud fallback to the
python join under a staleness deadline; a checkpoint resumed."""

import os

import numpy as np
import pytest

from fmda_tpu.config import FeatureConfig as JaxFeatureConfig
from fmda_tpu.config import WarehouseConfig as JaxWarehouseConfig
from fmda_tpu.data.synthetic import SyntheticMarketConfig as JaxMarket
from fmda_tpu.data.synthetic import (
    synthetic_session_messages as jax_session_messages)
from fmda_tpu.stream import InProcessBus as JaxBus
from fmda_tpu.stream import StreamEngine as JaxEngine
from fmda_tpu.stream import Warehouse as JaxWarehouse
from fmda_tpu.stream.native_bus import NativeBus as JaxNativeBus
from fmda_tpu.stream.native_bus import native_available as jax_native

from fmda_tpu_torch.config import (
    DEFAULT_TOPICS,
    TOPIC_PREDICT_TIMESTAMP,
    FeatureConfig,
    WarehouseConfig,
)
from fmda_tpu_torch.data.synthetic import (
    SyntheticMarketConfig,
    synthetic_session_messages,
)
from fmda_tpu_torch.obs.registry import MetricsRegistry
from fmda_tpu_torch.stream import InProcessBus, StreamEngine, Warehouse
from fmda_tpu_torch.stream import _native
from fmda_tpu_torch.stream.native_bus import NativeBus, native_available
from fmda_tpu_torch.stream.native_join import native_join_available

from test_stream import _session_messages

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _native_built():
    """Built here, in a test, not while the module is imported."""
    if not (native_available() and native_join_available()
            and jax_native()):
        pytest.skip("no host C++ compiler")


def _drive(bus):
    """The reference tests' publishes, reads and consumers on one bus;
    everything observable, as plain data."""
    out = {"offsets": [bus.publish("a", {"x": i}) for i in range(3)]}
    c = bus.consumer("a")
    out["poll1"] = [(r.offset, r.value) for r in c.poll()]
    out["poll2"] = c.poll()
    bus.publish("a", {"x": 3})
    out["poll3"] = [(r.offset, r.value) for r in c.poll()]
    tail = bus.consumer("a", from_end=True)
    out["tail_empty"] = tail.poll()
    out["many"] = bus.publish_many("a", [{"i": i} for i in range(4)])
    out["many_empty"] = bus.publish_many("a", [])
    out["tail"] = [(r.offset, r.value) for r in tail.poll()]
    out["read"] = [(r.offset, r.value)
                   for r in bus.read("a", 2, max_records=3)]
    out["end"] = (bus.end_offset("a"), bus.end_offset("b"))
    with pytest.raises(KeyError):
        bus.publish("nope", {})
    with pytest.raises(KeyError):
        bus.publish_many("nope", [{}])
    bus.add_topic("c")
    bus.add_topic("a")  # an existing topic keeps its log
    out["after_add"] = (bus.end_offset("a"), bus.end_offset("c"))
    out["array"] = bus.read("a", bus.publish(
        "a", {"row": np.arange(3, dtype=np.float32)}))[0].value["row"]
    return out


@pytest.mark.parametrize("reference", [JaxNativeBus, JaxBus])
def test_native_bus_matches_the_reference_buses(reference):
    ours, ref = _drive(NativeBus(["a", "b"])), _drive(reference(["a", "b"]))
    array = ours.pop("array")
    np.testing.assert_array_equal(array, ref.pop("array"))
    assert array.dtype == np.float32
    assert ours == ref


def test_native_bus_retention_as_the_reference():
    for max_records in (4, 1000):
        runs = []
        for cls in (NativeBus, JaxNativeBus):
            bus = cls(["a"], arena_bytes=256 if max_records == 1000
                      else 1 << 22, max_records=max_records)
            for i in range(100):
                bus.publish("a", {"i": i, "pad": "x" * 40})
            runs.append(([(r.offset, r.value) for r in bus.read("a", 0)],
                         bus.base_offset("a"), bus.end_offset("a")))
        assert runs[0] == runs[1]
        records, base, end = runs[0]
        assert end == 100 and base == records[0][0] == 100 - len(records)
        assert [v["i"] for _, v in records] == list(range(base, 100))
    assert runs[0][1] > 90  # the 256-byte arena kept only the newest


def test_native_bus_refuses_oversized_records():
    with pytest.raises(RuntimeError, match="too"):
        NativeBus(["a"], arena_bytes=64).publish("a", {"pad": "x" * 200})
    bus = NativeBus(["a"])
    with pytest.raises(RuntimeError, match="record limit"):
        bus.publish("a", {"pad": "x" * (bus.READ_BUF_BYTES + 1)})


@pytest.mark.parametrize("cls", [NativeBus, InProcessBus])
def test_bind_metrics_counts_publishes_and_consumer_reads(cls):
    registry = MetricsRegistry()
    bus = cls(["a", "b"])
    bus.publish("a", {"x": 0})  # before the bind: not counted
    bus.bind_metrics(registry)
    bus.publish("a", {"x": 1})
    bus.publish_many("b", [{"x": i} for i in range(3)])
    consumer = bus.consumer("a")
    assert len(consumer.poll()) == 2
    bus.read("b", 0)  # a bare read is no consumer's
    bus.add_topic("c")
    bus.publish("c", {})
    bus.consumer("c").poll()

    def value(name, topic):
        return registry.counter(name, topic=topic).value

    assert [value("bus_published_total", t) for t in "abc"] == [1, 3, 1]
    assert [value("bus_consumed_total", t) for t in "abc"] == [2, 0, 1]


def _corpus_run(engine_cls, bus_cls, wh_cls, fc_cls, wc_cls, messages,
                **engine_kw):
    fc = fc_cls()
    bus = bus_cls(DEFAULT_TOPICS)
    wh = wh_cls(fc, wc_cls(path=":memory:"))
    engine = engine_cls(bus, wh, fc, **engine_kw)
    per_day = 5 * 78
    for i, (topic, msg) in enumerate(messages):
        bus.publish(topic, msg)
        if (i + 1) % per_day == 0:
            engine.step()
    engine.step()
    n = len(wh)
    out = dict(timestamps=wh.timestamps(), x=wh.fetch(range(1, n + 1)),
               y=wh.fetch_targets(range(1, n + 1)),
               signals=[r.value for r in
                        bus.read(TOPIC_PREDICT_TIMESTAMP, 0)],
               stats=engine.stats)
    wh.close()
    return out, engine


def _assert_landed_equal(ours, ref):
    assert ours.keys() == ref.keys()
    for key in ref:
        if isinstance(ref[key], np.ndarray):
            assert ours[key].dtype == ref[key].dtype
            np.testing.assert_array_equal(ours[key], ref[key])
        else:
            assert ours[key] == ref[key], key


@pytest.mark.parametrize("seed", [0, 1])
def test_native_join_bit_equal_to_python_and_the_reference(seed):
    """Four synthetic days, a step a day: the port's native join (on its
    native bus) lands the port's python join's rows, signals and stats,
    and the reference's native engine's."""
    days = 4
    port_msgs = list(synthetic_session_messages(
        FeatureConfig(), SyntheticMarketConfig(seed=seed, n_days=days)))
    jax_msgs = list(jax_session_messages(
        JaxFeatureConfig(), JaxMarket(seed=seed, n_days=days)))
    native, engine = _corpus_run(StreamEngine, NativeBus, Warehouse,
                                 FeatureConfig, WarehouseConfig, port_msgs,
                                 join_backend="native")
    assert engine.join_backend == "native" and engine._core is not None
    python, engine = _corpus_run(StreamEngine, InProcessBus, Warehouse,
                                 FeatureConfig, WarehouseConfig, port_msgs)
    assert engine.join_backend == "python" and engine._core is None
    ref, _ = _corpus_run(JaxEngine, JaxNativeBus, JaxWarehouse,
                         JaxFeatureConfig, JaxWarehouseConfig, jax_msgs,
                         join_backend="native")
    assert native["stats"]["emitted"] == days * 78
    _assert_landed_equal(native, python)
    _assert_landed_equal(native, ref)


def test_native_join_drops_and_resumes_as_python(tmp_path):
    """The reference engine tests' late-stream session (rows dropped past
    the watermark) and a checkpoint resumed mid-join, native against
    python: the same rows and counters."""
    small = dict(bid_levels=2, ask_levels=2, event_list=("Core CPI",),
                 volume_ma_periods=(3,), price_ma_periods=(3,),
                 delta_ma_periods=(2,), bollinger_period=3,
                 stoch_preceding=2, atr_preceding=2, target_lead1=2,
                 target_lead2=3, get_cot=False)
    results = {}
    for backend in ("python", "native"):
        fc = FeatureConfig(**small)
        path = str(tmp_path / f"{backend}.json")
        bus = InProcessBus(DEFAULT_TOPICS)
        wh = Warehouse(fc, WarehouseConfig(path=":memory:"))
        messages = list(_session_messages(10))
        half = len(messages) // 2
        engine = StreamEngine(bus, wh, fc, checkpoint_path=path,
                              join_backend=backend)
        for topic, msg in messages[:half]:
            bus.publish(topic, msg)
        engine.step()
        resumed = StreamEngine(bus, wh, fc, checkpoint_path=path,
                               join_backend=backend)
        for topic, msg in messages[half:]:
            bus.publish(topic, msg)
        resumed.step()
        results[backend] = (wh.timestamps(), wh.fetch(range(1, len(wh) + 1)),
                            resumed.stats["emitted"],
                            resumed.stats["dropped"])
        assert resumed.join_backend == backend
    assert results["native"][0] == results["python"][0]
    np.testing.assert_array_equal(results["native"][1], results["python"][1])
    assert results["native"][2:] == results["python"][2:]


def test_staleness_deadline_falls_back_to_the_python_join(caplog):
    fc = FeatureConfig()
    engine = StreamEngine(InProcessBus(DEFAULT_TOPICS),
                          Warehouse(fc, WarehouseConfig(path=":memory:")),
                          fc, join_backend="native",
                          staleness_deadline_s=600)
    assert engine.join_backend == "python" and engine._core is None
    assert "python join scheduler" in caplog.text


def test_native_build_writes_only_under_the_build_tree(tmp_path,
                                                       monkeypatch):
    """A fresh build goes to ``build/fmda_tpu_torch/native/<hash>/`` (a
    temporary root here) by way of a temporary name, and ``native/``
    gains no file."""
    native_dir = os.path.join(REPO, "native")
    before = sorted(os.listdir(native_dir))
    monkeypatch.setattr(_native, "BUILD_ROOT", tmp_path / "native")
    monkeypatch.setattr(_native, "_loaded", {})
    lib = _native.build_and_load("libjoincore.so", RuntimeError)
    assert lib.jc_create is not None
    built = [os.path.relpath(os.path.join(d, f), tmp_path)
             for d, _, fs in os.walk(tmp_path) for f in fs]
    path = _native.library_path("libjoincore.so")
    assert built == [os.path.relpath(path, tmp_path)]
    assert path.parent.parent == tmp_path / "native"
    assert sorted(os.listdir(native_dir)) == before
    assert str(_native.BUILD_ROOT).startswith(str(tmp_path))


def test_a_failed_build_names_the_compiler_error(tmp_path, monkeypatch):
    monkeypatch.setattr(_native, "BUILD_ROOT", tmp_path / "native")
    monkeypatch.setattr(_native, "_loaded", {})
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot build libringbus.so"):
        _native.build_and_load("libringbus.so", RuntimeError)
    assert not list(tmp_path.rglob("*.so"))
