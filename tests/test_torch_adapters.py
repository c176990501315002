"""fmda_tpu_torch's deployment adapters against ``fmda_tpu``'s, on the
repository's client-library fakes (``tests/fake_kafka.py``,
``tests/fake_mysql.py``): no broker or server runs here.

``KafkaBus`` and ``MySQLWarehouse`` run one scenario each through both
packages, and the fakes' journals (every client call and payload, every
SQL statement) must be equal, as must what each returns; the schema's SQL
codegen text equals the reference's for the default and a reshaped
``FeatureConfig``; the MySQL bulk reader yields what the port's SQLite
warehouse yields for the same landed rows."""

import dataclasses
import sys

import numpy as np
import pytest

import fake_kafka
import fake_mysql
import fmda_tpu.stream.mysql_warehouse as jax_sql
from fmda_tpu.config import FeatureConfig as JaxFeatureConfig
from fmda_tpu.config import WarehouseConfig as JaxWarehouseConfig
from fmda_tpu.stream.kafka_bus import KafkaBus as JaxKafkaBus

import fmda_tpu_torch.stream.mysql_warehouse as port_sql
from fmda_tpu_torch.config import (
    DEFAULT_TOPICS,
    TOPIC_PREDICT_TIMESTAMP,
    BusConfig,
    FeatureConfig,
    WarehouseConfig,
    config_from_dict,
)
from fmda_tpu_torch.stream import StreamEngine, Warehouse
from fmda_tpu_torch.stream.journal import BufferedWarehouse
from fmda_tpu_torch.stream.kafka_bus import KafkaBus
from fmda_tpu_torch.stream.mysql_warehouse import MySQLWarehouse

from test_stream import _session_messages

#: the reference's small schema, as keyword arguments for either package
SMALL = dict(bid_levels=2, ask_levels=2, event_list=("Core CPI",),
             volume_ma_periods=(3,), price_ma_periods=(3,),
             delta_ma_periods=(2,), bollinger_period=3, stoch_preceding=2,
             atr_preceding=2, target_lead1=2, target_lead2=3,
             get_cot=False)
RESHAPED = dict(bid_levels=3, ask_levels=4, get_vix=False, get_cot=False,
                event_list=("Core CPI", "Retail Sales"),
                volume_ma_periods=(4, 9), price_ma_periods=(5,),
                delta_ma_periods=(), bollinger_period=7, bollinger_std=3,
                stochastic_oscillator=False, atr_preceding=9)


@pytest.fixture
def kafka_env(monkeypatch):
    fake_kafka.reset()
    monkeypatch.setitem(sys.modules, "kafka", fake_kafka)
    yield
    fake_kafka.reset()


@pytest.fixture
def mysql_env(monkeypatch):
    fake_mysql.SERVER = fake_mysql.FakeServer()
    monkeypatch.setitem(sys.modules, "mysql", fake_mysql)
    monkeypatch.setitem(sys.modules, "mysql.connector", fake_mysql.connector)
    yield


# ---------------------------------------------------------------------------
# Kafka
# ---------------------------------------------------------------------------


def _kafka_scenario(bus):
    out = [bus.publish("a", {"x": 1}), bus.publish("a", {"x": 2}),
           bus.end_offset("a"), bus.end_offset("b")]
    out.append([(r.offset, r.value) for r in bus.read("a", 0)])
    out.append([r.value for r in bus.read("a", 1, max_records=1)])
    out.append(bus.publish_many("b", [{"x": i} for i in range(3)]))
    c = bus.consumer("a")
    out.append(len(c.poll()))
    out.append(c.poll())
    tail = bus.consumer("a", from_end=True)
    out.append(tail.poll())
    bus.publish("a", {"row": np.arange(3, dtype=np.float32), "x": 4})
    got = tail.poll()[0].value
    out.append((got["x"], got["row"].dtype.str, got["row"].tolist()))
    bus.add_topic("c")
    out.append(bus.publish("c", {}))
    with pytest.raises(KeyError):
        bus.publish("nope", {})
    return out


def test_kafka_bus_matches_the_reference_call_for_call(kafka_env):
    ours = _kafka_scenario(KafkaBus(["a", "b"]))
    journal = list(fake_kafka.JOURNAL)
    fake_kafka.reset()
    ref = _kafka_scenario(JaxKafkaBus(["a", "b"]))
    assert ours == ref
    assert journal == list(fake_kafka.JOURNAL)


def test_kafka_bus_drives_the_engine_and_reads_bus_servers(kafka_env):
    """The streaming engine over the adapter; the broker list comes from
    ``bus.servers``."""
    cfg = config_from_dict({"bus": {"servers": ["k1:9092", "k2:9092"]}})
    assert cfg.bus.servers == ("k1:9092", "k2:9092")
    bus = KafkaBus.from_config(cfg.bus)
    assert bus._servers == ["k1:9092", "k2:9092"]
    assert bus.topics() == BusConfig().topics
    fc = FeatureConfig(**SMALL)
    wh = Warehouse(fc, WarehouseConfig(path=":memory:"))
    engine = StreamEngine(bus, wh, fc)
    for topic, msg in _session_messages(5):
        bus.publish(topic, msg)
    engine.step()
    assert len(wh) == 5 and engine.stats["dropped"] == 0
    signals = bus.read(TOPIC_PREDICT_TIMESTAMP, 0)
    assert [s.value["Timestamp"] for s in signals] == wh.timestamps()


def test_kafka_bus_without_the_client_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "kafka", None)
    with pytest.raises(RuntimeError, match="kafka-python"):
        KafkaBus(DEFAULT_TOPICS)


# ---------------------------------------------------------------------------
# MySQL
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [{}, SMALL, RESHAPED],
                         ids=["default", "small", "reshaped"])
def test_sql_codegen_text_equals_the_reference(shape):
    fc, ref_fc = FeatureConfig(**shape), JaxFeatureConfig(**shape)
    table = "stock_data_joined"
    for name in ("create_table_sql", "all_view_sql", "join_statement_sql",
                 "insert_sql", "join_from_clause", "bollinger_view_sql",
                 "stochastic_view_sql", "atr_view_sql", "target_view_sql"):
        assert getattr(port_sql, name)(fc, table) == \
            getattr(jax_sql, name)(ref_fc, table), name
    assert port_sql.join_select_fields(fc) == \
        jax_sql.join_select_fields(ref_fc)
    assert port_sql.ma_view_sql("vol_MA", "5_volume", (6, 20), table,
                                "vol_MA") == jax_sql.ma_view_sql(
        "vol_MA", "5_volume", (6, 20), table, "vol_MA")
    assert port_sql.price_change_view_sql(table) == \
        jax_sql.price_change_view_sql(table)


def _mysql_scenario(wh_cls, fc, wc):
    """Bootstrap, land, probe, seed the join view and fetch; returns what
    the client answered and the server's statement journal."""
    wh = wh_cls(fc, wc)
    server = fake_mysql.SERVER
    row = {c: 1.0 for c in fc.table_columns()}
    out = [wh.healthy(),
           wh.insert_rows([{**row, "Timestamp": "2020-02-07 09:30:00"},
                           {**row, "Timestamp": "2020-02-07 09:35:00"}]),
           wh.has_timestamp("2020-02-07 09:30:00"),
           wh.has_timestamp("1999-01-01 00:00:00"),
           wh.recent_timestamps(1),
           wh.ids_for_timestamps(["2020-02-07 09:35:00", "nope"])]
    n_fields = len(fc.x_fields())
    server.seed(join_rows={i: [float(i) * 10 + j for j in range(n_fields)]
                           for i in range(1, 8)},
                target_rows={i: [i % 2, 0.0, 1.0, i % 3]
                             for i in range(1, 8)})
    out += [len(wh), wh.fetch([5, 2, 7]).tolist(),
            wh.fetch([2, 2, 3]).tolist(),
            wh.fetch_targets([5, 2, 7]).tolist(),
            wh.fetch_windows([4, 6], 3).tolist(), tuple(wh.x_fields)]
    with pytest.raises(IndexError, match="no rows"):
        wh.fetch([2, 99])
    with pytest.raises(KeyError, match="unknown feature columns"):
        wh.insert_rows([{**row, "bogus": 1.0}])
    return out, list(server.statements), server.commits


@pytest.mark.parametrize("shape", [{}, SMALL], ids=["default", "small"])
def test_mysql_warehouse_matches_the_reference(mysql_env, shape):
    wc = dict(backend="mysql", database_name="db", user="u", password="p",
              hostname="db.local", port=3307)
    ours = _mysql_scenario(MySQLWarehouse, FeatureConfig(**shape),
                           WarehouseConfig(**wc))
    fake_mysql.SERVER = fake_mysql.FakeServer()
    ref = _mysql_scenario(jax_sql.MySQLWarehouse, JaxFeatureConfig(**shape),
                          JaxWarehouseConfig(**wc))
    assert ours == ref
    assert "CREATE DATABASE IF NOT EXISTS db" in ours[1]


def test_mysql_connection_fields_are_read(mysql_env, monkeypatch):
    seen = {}
    connect = fake_mysql.connector.connect

    def spy(**kw):
        seen.update(kw)
        return connect(**kw)

    monkeypatch.setattr(fake_mysql.connector, "connect", spy)
    cfg = config_from_dict({"warehouse": {
        "backend": "mysql", "user": "u", "password": "p",
        "hostname": "db.local", "port": 3307, "database_name": "db"}})
    MySQLWarehouse(cfg.features, cfg.warehouse)
    assert seen == dict(host="db.local", port=3307, user="u", password="p")
    assert fake_mysql.SERVER.current_db == "db"
    assert dataclasses.asdict(WarehouseConfig()) == dataclasses.asdict(
        JaxWarehouseConfig())


def test_mysql_without_the_client_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "mysql", None)
    monkeypatch.setitem(sys.modules, "mysql.connector", None)
    with pytest.raises(RuntimeError, match="mysql-connector-python"):
        MySQLWarehouse(FeatureConfig())


@pytest.mark.parametrize("chunk", [3, 7, 100])
def test_mysql_row_chunks_equal_the_sqlite_warehouse(mysql_env, chunk):
    """The bulk reader over MySQL yields what the port's SQLite
    warehouse yields for the same landed rows, chunk for chunk."""
    fc = FeatureConfig(**SMALL)
    embedded = Warehouse(fc, WarehouseConfig(path=":memory:"))
    remote = MySQLWarehouse(fc, WarehouseConfig(backend="mysql"))
    rng = np.random.default_rng(0)
    rows = [{"Timestamp": f"2020-01-02 {9 + i // 12:02d}:{i % 12 * 5:02d}:00",
             **{c: float(v) for c, v in zip(
                 fc.table_columns(), rng.normal(size=len(fc.table_columns())))}}
            for i in range(20)]
    embedded.insert_rows(rows)
    remote.insert_rows(rows)
    ours = list(remote.iter_row_chunks(chunk=chunk))
    theirs = list(embedded.iter_row_chunks(chunk=chunk))
    assert [ts for ts, _ in ours] == [ts for ts, _ in theirs]
    for (_, a), (_, b) in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    bounded = list(remote.iter_row_chunks(
        rows[3]["Timestamp"], rows[9]["Timestamp"], chunk))
    assert sum(len(ts) for ts, _ in bounded) == 7
    with pytest.raises(ValueError, match="chunk"):
        list(remote.iter_row_chunks(chunk=0))
    embedded.close()


def test_journal_fronts_a_mysql_outage(mysql_env, tmp_path):
    fc = FeatureConfig(**SMALL)
    wh = BufferedWarehouse(
        MySQLWarehouse(fc, WarehouseConfig(backend="mysql")),
        str(tmp_path / "j.jsonl"))
    row = {c: 1.0 for c in fc.table_columns()}
    fake_mysql.SERVER.down = True
    assert not wh.healthy()
    assert wh.insert_rows([{**row, "Timestamp": "2020-02-07 09:30:00"}]) == 1
    assert wh.journal_pending == 1
    fake_mysql.SERVER.down = False
    assert wh.drain_journal() == 1 and wh.journal_pending == 0
    assert wh.has_timestamp("2020-02-07 09:30:00")
