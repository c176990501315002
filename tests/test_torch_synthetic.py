"""fmda_tpu_torch's synthetic corpus against ``fmda_tpu``'s: the feed
message streams (topic for topic, dict for dict), ``build_corpus``'s
warehouses and engine stats, and the norm-params JSON artifact read and
written across the two packages."""

import dataclasses
import importlib
import json

import numpy as np
import pytest

from fmda_tpu.config import FeatureConfig as JaxFeatureConfig
from fmda_tpu.config import WarehouseConfig as JaxWarehouseConfig
from fmda_tpu.data.synthetic import SyntheticMarketConfig as JaxMarket
from fmda_tpu.data.synthetic import build_corpus as jax_build_corpus
from fmda_tpu.data.synthetic import (
    synthetic_session_messages as jax_session_messages)

from fmda_tpu_torch.config import FeatureConfig, WarehouseConfig
from fmda_tpu_torch.data import (
    NormParams,
    chunk_norm_params,
    load_norm_params,
    save_norm_params,
)
from fmda_tpu_torch.data.synthetic import (
    BARS_PER_DAY,
    SyntheticMarketConfig,
    build_corpus,
    synthetic_session_messages,
)

#: the module (``fmda_tpu.data`` exports a function of the same name)
jax_normalize = importlib.import_module("fmda_tpu.data.normalize")

NARROW = dict(bid_levels=3, ask_levels=2, event_list=("Core CPI", "Retail Sales"),
              get_cot=False)


@pytest.mark.parametrize("features,market", [
    ({}, dict(seed=0, n_days=3)),
    ({}, dict(seed=1, n_days=2, start_date="2020-02-28", bars_per_day=20)),
    (NARROW, dict(seed=2, n_days=2, noise=0.9, start_price=10.0)),
])
def test_message_streams_equal_the_reference(features, market):
    ours = list(synthetic_session_messages(
        FeatureConfig(**features), SyntheticMarketConfig(**market)))
    ref = list(jax_session_messages(
        JaxFeatureConfig(**features), JaxMarket(**market)))
    assert len(ours) == len(ref) == 5 * market["n_days"] * market.get(
        "bars_per_day", BARS_PER_DAY)
    for (topic, msg), (ref_topic, ref_msg) in zip(ours, ref):
        assert topic == ref_topic
        assert msg == ref_msg
        assert json.dumps(msg) == json.dumps(ref_msg)  # key order too


def test_market_config_fields_are_the_reference():
    assert ([(f.name, f.default) for f in
             dataclasses.fields(SyntheticMarketConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(JaxMarket)])


@pytest.mark.parametrize("seed,features", [(0, {}), (3, NARROW)])
def test_build_corpus_equals_the_reference(seed, features):
    market = dict(seed=seed, n_days=6)
    wh, stats = build_corpus(FeatureConfig(**features),
                             SyntheticMarketConfig(**market))
    ref_wh, ref_stats = jax_build_corpus(JaxFeatureConfig(**features),
                                         JaxMarket(**market))
    n = len(ref_wh)
    assert len(wh) == n == 6 * BARS_PER_DAY
    assert stats == ref_stats and stats["dropped"] == 0
    assert wh.x_fields == ref_wh.x_fields
    assert wh.timestamps() == ref_wh.timestamps()
    np.testing.assert_array_equal(wh.fetch(range(1, n + 1)),
                                  ref_wh.fetch(range(1, n + 1)))
    np.testing.assert_array_equal(wh.fetch_targets(range(1, n + 1)),
                                  ref_wh.fetch_targets(range(1, n + 1)))
    assert wh.raw_rows_for(wh.timestamps()) == ref_wh.raw_rows_for(
        ref_wh.timestamps())


def test_build_corpus_into_a_file_reads_back_in_the_reference(tmp_path):
    """A corpus the port lands in a file is the file the reference lands:
    the reference's warehouse opens it and serves the same rows."""
    path = str(tmp_path / "corpus.sqlite")
    wh, _ = build_corpus(FeatureConfig(), SyntheticMarketConfig(n_days=2),
                         WarehouseConfig(path=path))
    n = len(wh)
    wh.close()
    from fmda_tpu.stream import Warehouse as JaxWarehouse

    ref_file = JaxWarehouse(JaxFeatureConfig(), JaxWarehouseConfig(path=path))
    ref_mem, _ = jax_build_corpus(JaxFeatureConfig(), JaxMarket(n_days=2))
    np.testing.assert_array_equal(ref_file.fetch(range(1, n + 1)),
                                  ref_mem.fetch(range(1, n + 1)))
    ref_file.close()


def test_norm_params_json_crosses_both_ways(tmp_path):
    wh, _ = build_corpus(FeatureConfig(), SyntheticMarketConfig(n_days=2))
    fc = FeatureConfig()
    x = wh.fetch(range(1, len(wh) + 1))
    ours = chunk_norm_params(x, wh.x_fields, bid_levels=fc.bid_levels,
                             ask_levels=fc.ask_levels)
    ref = jax_normalize.chunk_norm_params(
        x, wh.x_fields, bid_levels=fc.bid_levels, ask_levels=fc.ask_levels)
    np.testing.assert_array_equal(ours.x_min, ref.x_min)
    np.testing.assert_array_equal(ours.x_max, ref.x_max)

    port_file, ref_file = tmp_path / "port.json", tmp_path / "ref.json"
    save_norm_params(str(port_file), ours, wh.x_fields)
    jax_normalize.save_norm_params(str(ref_file), ref, wh.x_fields)
    assert port_file.read_bytes() == ref_file.read_bytes()
    for loaded in (load_norm_params(str(ref_file)),
                   jax_normalize.load_norm_params(str(port_file))):
        assert loaded.x_min.dtype == loaded.x_max.dtype == np.float32
        np.testing.assert_array_equal(loaded.x_min, ours.x_min)
        np.testing.assert_array_equal(loaded.x_max, ours.x_max)
    assert list(json.loads(port_file.read_text())) == list(wh.x_fields)
    assert isinstance(load_norm_params(str(port_file)), NormParams)
