"""fmda_tpu_torch's batched Predictor on the CPU: the warehouse's batched
reads against the reference warehouse's on one SQLite file (ID holes and
missing timestamps included), a bucket-1 flush bit for bit the port's solo
Predictor, ring flushes bit for bit fetch flushes, the solo path's skips
counted, and the PredictorGateway against ``fmda_tpu.runtime``'s for gru,
lstm, attn and ssm: the same predictions within 1e-5 (float32), the same
counters and ring hits.
"""

import json
import sqlite3

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fmda_tpu.config import DEFAULT_TOPICS as JAX_TOPICS
from fmda_tpu.config import FeatureConfig as JaxFeatureConfig
from fmda_tpu.config import ModelConfig as JaxModelConfig
from fmda_tpu.config import WarehouseConfig as JaxWarehouseConfig
from fmda_tpu.data.normalize import NormParams as JaxNormParams
from fmda_tpu.models import build_model as jax_build_model
from fmda_tpu.runtime import BatcherConfig as JaxBatcherConfig
from fmda_tpu.runtime import PredictorGateway as JaxPredictorGateway
from fmda_tpu.runtime import PredictorPool as JaxPredictorPool
from fmda_tpu.stream import InProcessBus as JaxBus
from fmda_tpu.stream import Warehouse as JaxWarehouse

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
from fmda_tpu_torch.runtime import (
    BatcherConfig,
    PredictorGateway,
    PredictorLoadConfig,
    PredictorPool,
    run_predictor_load,
)
from fmda_tpu_torch.serve import Predictor
from fmda_tpu_torch.stream import InProcessBus, Warehouse

TOL = 1e-5
WINDOW, HIDDEN = 6, 8
CELLS = ["gru", "lstm", "attn", "ssm"]
#: a narrow schema: 2-level book, one economic event, no COT feed
FEATURES = dict(get_cot=False, bid_levels=2, ask_levels=2,
                event_list=("Core CPI",))
#: rows deleted from the file before reading: autoincrement IDs with holes
HOLES = (5, 6, 20)


@pytest.fixture
def warehouses(tmp_path):
    """The reference's warehouse writes 60 rows (one repeated timestamp)
    to a file, three rows are deleted (ID holes); both packages open it."""
    path = tmp_path / "wh.sqlite"
    rows = random_walk_rows(FeatureConfig(**FEATURES).table_columns(), 60,
                            seed=0)
    rows.append(dict(rows[30], **{"1_open": 1.0}))  # a repeated timestamp
    jax_wh = JaxWarehouse(JaxFeatureConfig(**FEATURES),
                          JaxWarehouseConfig(path=str(path)))
    jax_wh.insert_rows(rows)
    jax_wh.close()
    with sqlite3.connect(path) as conn:
        conn.execute("DELETE FROM stock_data_joined WHERE ID IN "
                     f"({', '.join(map(str, HOLES))})")
    jax_wh = JaxWarehouse(JaxFeatureConfig(**FEATURES),
                          JaxWarehouseConfig(path=str(path)))
    port_wh = Warehouse(FeatureConfig(**FEATURES),
                        WarehouseConfig(path=str(path)))
    yield jax_wh, port_wh
    jax_wh.close()
    port_wh.close()


def _models(wh, cell="gru", seed=0):
    n_features = len(wh.x_fields)
    fields = dict(hidden_size=HIDDEN, n_features=n_features, output_size=4,
                  dropout=0.0, cell=cell)
    jax_cfg = JaxModelConfig(use_pallas=False, **fields)
    params = jax.device_get(jax_build_model(jax_cfg).init(
        {"params": jax.random.PRNGKey(seed)},
        jnp.zeros((1, WINDOW, n_features)))["params"])
    x = wh.fetch(range(1, len(wh) + 1))
    norm = chunk_norm_params(x, wh.x_fields, bid_levels=2, ask_levels=2)
    return jax_cfg, params, ModelConfig(**fields), params_from_flax(params), \
        norm


def _gateway(wh, cfg, state, norm, *, buckets=(1,), use_ring=False,
             pipeline_depth=1, bus=None, **kw):
    pool = PredictorPool(cfg, state, norm, window=WINDOW, use_ring=use_ring,
                         device="cpu")
    return PredictorGateway(
        pool, bus or InProcessBus(DEFAULT_TOPICS), wh,
        batcher_config=BatcherConfig(bucket_sizes=buckets, max_linger_s=0.0),
        from_end=False, max_staleness_s=None, pipeline_depth=pipeline_depth,
        **kw)


def _signal(bus, ts):
    bus.publish(TOPIC_PREDICT_TIMESTAMP, {"Timestamp": ts})


# ---------------------------------------------------------------------------
# the batched warehouse reads
# ---------------------------------------------------------------------------


def test_timestamps_and_ids_for_timestamps_match_the_reference(warehouses):
    jax_wh, wh = warehouses
    ts_all = wh.timestamps()
    assert ts_all == jax_wh.timestamps() and len(ts_all) == 61 - len(HOLES)
    repeated = ts_all[-1]  # also the timestamp of an earlier row
    assert ts_all.count(repeated) == 2
    queries = [ts_all[4], "2099-01-01 00:00:00", ts_all[0], ts_all[-2],
               repeated, ts_all[4]]
    got = wh.ids_for_timestamps(queries)
    assert got == jax_wh.ids_for_timestamps(queries)
    assert got == [wh.id_for_timestamp(ts) for ts in queries]
    assert got[1] is None and got[0] == got[-1]
    # the repeated timestamp names its newest row (the last position)
    assert got[4] == len(wh)
    assert wh.ids_for_timestamps([]) == []


def test_fetch_windows_match_the_reference_and_stacked_fetches(warehouses):
    jax_wh, wh = warehouses
    ids = [WINDOW, 9, 9, len(wh)]  # duplicates allowed
    got = wh.fetch_windows(ids, WINDOW)
    assert got.shape == (4, WINDOW, len(wh.x_fields))
    np.testing.assert_array_equal(got, jax_wh.fetch_windows(ids, WINDOW))
    for i, rid in enumerate(ids):
        np.testing.assert_array_equal(
            got[i], wh.fetch(range(rid - WINDOW + 1, rid + 1)))
    assert wh.fetch_windows([], WINDOW).shape == (0, WINDOW,
                                                  len(wh.x_fields))
    with pytest.raises(IndexError):
        wh.fetch_windows([WINDOW - 1], WINDOW)
    with pytest.raises(IndexError):
        wh.fetch_windows([len(wh) + 1], WINDOW)
    with pytest.raises(ValueError, match="window"):
        wh.fetch_windows([9], 0)


# ---------------------------------------------------------------------------
# the numerical contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", CELLS)
def test_bucket1_bit_identical_to_the_solo_predictor(warehouses, cell):
    _, wh = warehouses
    _, _, cfg, state, norm = _models(wh, cell)
    solo_bus = InProcessBus(DEFAULT_TOPICS)
    solo = Predictor(solo_bus, wh, cfg, state, norm, window=WINDOW,
                     from_end=False, max_staleness_s=None, device="cpu")
    gw = _gateway(wh, cfg, state, norm, buckets=(1,))
    for ts in wh.timestamps():
        _signal(solo_bus, ts)
        _signal(gw.bus, ts)
    solo_preds, batched = solo.poll(), gw.poll()
    # every row past the first WINDOW - 1 (the repeated timestamp's two
    # signals both name its newest row)
    assert len(batched) == len(wh) - (WINDOW - 1)
    assert solo_preds == batched  # every field, floats exactly
    assert ([m.value for m in solo_bus.consumer(TOPIC_PREDICTION).poll()]
            == [m.value for m in gw.bus.consumer(TOPIC_PREDICTION).poll()])
    assert gw.kernel_launches_by_bucket == {1: 0}  # the CPU
    assert gw.metrics.counters["signals_served"] == len(batched)


@pytest.mark.parametrize("cell", ["gru", "attn"])
def test_ring_path_bit_identical_to_fetch_path(warehouses, cell):
    _, wh = warehouses
    _, _, cfg, state, norm = _models(wh, cell)
    fetch = _gateway(wh, cfg, state, norm, buckets=(2, 4))
    ring = _gateway(wh, cfg, state, norm, buckets=(2, 4), use_ring=True)
    ts_all = wh.timestamps()
    preds = {False: [], True: []}
    bursts = [ts_all[8:12], ts_all[12:16], ts_all[16:19],
              ts_all[20:24],  # a gap: the ring misses and re-seeds
              ts_all[24:26]]
    for burst in bursts:
        for gw, key in ((fetch, False), (ring, True)):
            for ts in burst:
                _signal(gw.bus, ts)
            preds[key].extend(gw.poll())
    assert preds[True] == preds[False]
    c = ring.metrics.counters
    assert (c["ring_hits"], c["ring_misses"]) == (3, 2)
    assert "ring_hits" not in fetch.metrics.counters


def test_overlap_pipeline_bit_identical_to_serial(warehouses):
    _, wh = warehouses
    _, _, cfg, state, norm = _models(wh)
    gws = [_gateway(wh, cfg, state, norm, buckets=(2,), pipeline_depth=d)
           for d in (0, 1)]
    ts_all = wh.timestamps()
    outs = {0: [], 1: []}
    for i in range(0, len(ts_all), 6):
        for d, gw in enumerate(gws):
            for ts in ts_all[i:i + 6]:
                _signal(gw.bus, ts)
            outs[d].extend(gw.poll())
    assert outs[0] == outs[1]
    assert gws[1].metrics.counters["overlapped_flushes"] > 0
    assert gws[0].metrics.counters.get("overlapped_flushes", 0) == 0


# ---------------------------------------------------------------------------
# the solo path's skips, shedding, failures
# ---------------------------------------------------------------------------


def test_missing_rows_short_history_and_stale_signals_counted(warehouses):
    import datetime as dt

    _, wh = warehouses
    _, _, cfg, state, norm = _models(wh)
    gw = _gateway(wh, cfg, state, norm, buckets=(8,))
    ts_all = wh.timestamps()
    gw.max_staleness_s = 240
    gw.now_fn = lambda: dt.datetime.strptime(ts_all[9], "%Y-%m-%d %H:%M:%S")
    fresh_missing = ts_all[9][:-2] + "30"  # between bars: no row
    for ts in (ts_all[0], ts_all[9], fresh_missing, ts_all[2]):
        _signal(gw.bus, ts)
    preds = gw.poll()
    assert [p.timestamp for p in preds] == [ts_all[9]]
    c = gw.metrics.counters
    assert (c["stale_signals"], c["missing_rows"], c["signals_served"]) == (
        2, 1, 1)
    gw.max_staleness_s = None
    _signal(gw.bus, ts_all[2])  # row 3 < the window
    _signal(gw.bus, "")
    assert gw.poll() == []
    assert c["short_history"] == 1
    for ts in ("1999-01-01 00:00:00", "1999-01-01 00:05:00"):
        _signal(gw.bus, ts)
    assert gw.poll() == [] and c["missing_rows"] == 3
    assert c["flushes"] == 1  # an all-skipped flush dispatches nothing


def test_overload_sheds_oldest_signals_counted(warehouses):
    _, wh = warehouses
    _, _, cfg, state, norm = _models(wh)
    gw = _gateway(wh, cfg, state, norm, buckets=(4,), queue_bound=3)
    ts_all = wh.timestamps()
    for ts in ts_all[8:14]:
        gw.submit(ts)
    assert len(gw.batcher) == 3 and gw.saturated
    assert gw.metrics.counters["shed_oldest"] == 3
    assert [p.timestamp for p in gw.drain()] == ts_all[11:14]


def test_pump_failure_never_strands_the_inflight_flush(warehouses):
    _, wh = warehouses
    _, _, cfg, state, norm = _models(wh)

    class FailOnceBus(InProcessBus):
        def __init__(self, topics):
            super().__init__(topics)
            self.failed = False

        def publish_many(self, topic, values):
            if not self.failed:
                self.failed = True
                raise RuntimeError("transport hiccup")
            return super().publish_many(topic, values)

    bus = FailOnceBus(DEFAULT_TOPICS)
    gw = _gateway(wh, cfg, state, norm, buckets=(2,), bus=bus)
    ts_all = wh.timestamps()
    for ts in ts_all[8:12]:
        _signal(bus, ts)
    with pytest.raises(RuntimeError, match="transport hiccup"):
        gw.poll()
    assert gw.metrics.counters["flush_results_lost"] == 2
    assert gw.metrics.counters["signals_served"] == 2
    assert [m.value["timestamp"] for m in
            bus.consumer(TOPIC_PREDICTION).poll()] == ts_all[10:12]
    for ts in ts_all[12:14]:
        _signal(bus, ts)
    assert [p.timestamp for p in gw.poll()] == ts_all[12:14]


def test_gather_failure_drops_flush_counted_and_keeps_serving(warehouses):
    _, wh = warehouses
    _, _, cfg, state, norm = _models(wh)
    gw = _gateway(wh, cfg, state, norm, buckets=(4,))
    ts_all = wh.timestamps()
    real, calls = wh.fetch_windows, {"n": 0}

    def flaky(ids, window):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("db went away")
        return real(ids, window)

    gw._fetch_windows = flaky
    for ts in ts_all[8:11]:
        _signal(gw.bus, ts)
    assert gw.poll() == []
    c = gw.metrics.counters
    assert (c["gather_errors"], c["signals_dropped_on_error"]) == (1, 3)
    for ts in ts_all[11:14]:
        _signal(gw.bus, ts)
    assert [p.timestamp for p in gw.poll()] == ts_all[11:14]


def test_gateway_and_pool_refuse_bad_construction(warehouses):
    _, wh = warehouses
    _, _, cfg, state, norm = _models(wh)
    pool = PredictorPool(cfg, state, norm, window=WINDOW, device="cpu")
    with pytest.raises(ValueError, match="prediction"):
        PredictorGateway(pool, InProcessBus(("vix",)), wh)
    with pytest.raises(ValueError, match="pipeline_depth"):
        PredictorGateway(pool, InProcessBus(DEFAULT_TOPICS), wh,
                         pipeline_depth=2)
    with pytest.raises(ValueError, match="queue_bound"):
        PredictorGateway(pool, InProcessBus(DEFAULT_TOPICS), wh,
                         queue_bound=0)
    with pytest.raises(ValueError, match="window"):
        PredictorPool(cfg, state, norm, window=0, device="cpu")
    with pytest.raises(RuntimeError, match="not seeded"):
        pool.ring_forward_device(np.zeros((2, pool.n_features), np.float32),
                                 2, 10)


def test_per_signal_lookup_when_the_warehouse_has_no_batched_reads(
        warehouses):
    _, wh = warehouses
    _, _, cfg, state, norm = _models(wh)
    batched = _gateway(wh, cfg, state, norm, buckets=(4,))
    plain = _gateway(wh, cfg, state, norm, buckets=(4,))
    plain._ids_for = plain._fetch_windows = None
    out = []
    for gw in (batched, plain):
        for ts in wh.timestamps()[8:16]:
            _signal(gw.bus, ts)
        out.append(gw.poll())
    assert out[0] == out[1] and len(out[0]) == 8


# ---------------------------------------------------------------------------
# against the JAX package's PredictorGateway
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_ring", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_gateway_matches_the_jax_gateway(warehouses, cell, use_ring):
    """The same signals in bursts (a gap, a missing timestamp, a
    short-history row among them) through both gateways: the same
    predictions in the same order within 1e-5, the same labels, and the
    same counters, ring hits and misses included."""
    jax_wh, wh = warehouses
    jax_cfg, params, cfg, state, norm = _models(wh, cell)
    jax_pool = JaxPredictorPool(jax_cfg, params,
                                JaxNormParams(norm.x_min, norm.x_max),
                                window=WINDOW, use_ring=use_ring)
    jax_gw = JaxPredictorGateway(
        jax_pool, JaxBus(JAX_TOPICS), jax_wh,
        batcher_config=JaxBatcherConfig(bucket_sizes=(2, 4, 8),
                                        max_linger_s=0.0),
        from_end=False, max_staleness_s=None)
    gw = _gateway(wh, cfg, state, norm, buckets=(2, 4, 8), use_ring=use_ring)
    ts_all = wh.timestamps()
    bursts = [ts_all[5:9], ts_all[9:16], ts_all[17:20] + ["2099-01-01"],
              [ts_all[2]] + ts_all[20:23], ts_all[23:30], ts_all[30:31]]
    for burst in bursts:
        for g in (jax_gw, gw):
            for ts in burst:
                g.bus.publish(TOPIC_PREDICT_TIMESTAMP, {"Timestamp": ts})
        theirs, ours = jax_gw.poll(), gw.poll()
        assert [p.timestamp for p in ours] == [p.timestamp for p in theirs]
        for a, b in zip(ours, theirs):
            assert a.labels == b.labels and a.label_indices == b.label_indices
            np.testing.assert_allclose(a.probabilities, b.probabilities,
                                       atol=TOL)
    ours_c, theirs_c = gw.metrics.counters, jax_gw.metrics.counters
    assert dict(ours_c) == dict(theirs_c)
    assert ours_c["missing_rows"] == ours_c["short_history"] == 1
    if use_ring:
        assert ours_c["ring_hits"] > 0 and ours_c["ring_misses"] > 1


# ---------------------------------------------------------------------------
# the load generator and the CLI
# ---------------------------------------------------------------------------


def test_run_predictor_load_end_to_end(warehouses):
    _, wh = warehouses
    _, _, cfg, state, norm = _models(wh, "attn")
    gw = _gateway(wh, cfg, state, norm, buckets=(8, 32), use_ring=True)
    gw._consumer.seek_to_end()
    out = run_predictor_load(gw, wh.timestamps()[WINDOW - 1:],
                             PredictorLoadConfig(n_signals=40, burst=16))
    assert out["signals_submitted"] == out["signals_served"] == 40
    assert out["kernel_launches_by_bucket"] == {"8": 0, "32": 0}
    assert out["latency"]["total"]["count"] == 40
    assert set(out["latency"]) >= {"gather", "dispatch", "device", "total"}
    # flushes of 16, 16 and 8: the first seeds the ring; the second holds
    # the repeated timestamp, whose signal names the newest row and so
    # breaks the run of positions (a miss); the third continues it
    c = out["counters"]
    assert (c["ring_misses"], c["ring_hits"]) == (2, 1)


def test_run_predictor_load_ragged_bursts_land_in_every_bucket(warehouses):
    """Bursts of 3, 6 and 20 signals in turn over buckets (4, 8, 16): every
    bucket flushes, some padded, and the predictions are those of bursts
    of one size, within TOL."""
    _, wh = warehouses
    _, _, cfg, state, norm = _models(wh, "gru")
    stamps = wh.timestamps()[WINDOW - 1:]
    runs = {}
    for bursts in ((), (3, 6, 20)):
        gw = _gateway(wh, cfg, state, norm, buckets=(4, 8, 16))
        gw._consumer.seek_to_end()
        out = run_predictor_load(gw, stamps,
                                 PredictorLoadConfig(burst=8, bursts=bursts))
        runs[bursts] = out, {
            m.value["timestamp"]: m.value["probabilities"]
            for m in gw.bus.consumer(TOPIC_PREDICTION).poll()}
    (steady, steady_p), (ragged, ragged_p) = runs[()], runs[(3, 6, 20)]
    assert ragged["bursts"] == [3, 6, 20] and "bursts" not in steady
    assert ragged["signals_served"] == steady["signals_served"] == len(stamps)
    c = ragged["counters"]
    assert all(c[f"flushes_bucket_{b}"] > 0 for b in (4, 8, 16))
    assert c["padded_lanes"] > 0
    assert ragged["kernel_launches_by_bucket"] == {"4": 0, "8": 0, "16": 0}
    assert ragged_p.keys() == steady_p.keys()
    for ts, p in ragged_p.items():
        np.testing.assert_allclose(p, steady_p[ts], rtol=0, atol=TOL)


@pytest.mark.parametrize("fields", [dict(burst=0), dict(bursts=(4, 0))])
def test_predictor_load_refuses_empty_bursts(fields):
    with pytest.raises(ValueError, match="bursts must be >= 1"):
        PredictorLoadConfig(**fields)


@pytest.mark.parametrize("extra", [[], ["--ring", "--serial"]])
def test_serve_fleet_predictor_cli(capsys, extra):
    from fmda_tpu_torch.__main__ import main

    assert main(["serve-fleet", "--predictor", "--predictor-days", "1",
                 "--signals", "40", "--burst", "16", "--hidden", "4",
                 "--window", "6", "--bucket-sizes", "8", "--device", "cpu"]
                + extra) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["signals_served"] == out["signals_submitted"] == 40
    assert out["ring"] is bool(extra)
    assert out["device"] == "cpu"
    assert {"latency", "counters", "gauges", "host_stages",
            "kernel_launches_by_bucket"} <= set(out)
    assert out["counters"].get("overlapped_flushes", 0) == (0 if extra else 2)
