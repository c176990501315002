"""fmda_tpu_torch's replay plane and hot-swap guardrail against
``fmda_tpu.replay`` and ``fmda_tpu.eval.shadow``.

- The history sources: ``SyntheticHistory`` draws what the reference's
  draws (the same numpy streams in the same order), ``WarehouseHistory``
  groups the same landed rows into the same rounds: batches bit-equal.
- ``ReplayDriver`` through the port's ``FleetGateway`` against the
  reference's through JAX's: the same results, probabilities within
  1e-5 (float32); within the port, replay against the cadence-paced live
  loop byte for byte in every wire dialect.
- The halfway hot swap: no session dropped, no tick lost, seqs
  contiguous, the results before the swap the swap-free run's bytes,
  after it the new weights'.
- ``ShadowEvaluator``: the verdicts and accuracies of the reference's on
  the same warehouse and weights.
- The CLI's ``--replay``, ``--hot-swap`` and ``[replay]``."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fmda_tpu.config import FeatureConfig as JaxFeatureConfig
from fmda_tpu.config import ModelConfig as JaxModelConfig
from fmda_tpu.config import QualityConfig as JaxQualityConfig
from fmda_tpu.config import ReplayConfig as JaxReplayConfig
from fmda_tpu.data.synthetic import SyntheticMarketConfig as JaxMarket
from fmda_tpu.data.synthetic import build_corpus as jax_build_corpus
from fmda_tpu.eval.shadow import ShadowEvaluator as JaxShadowEvaluator
from fmda_tpu.models import build_model as jax_build_model
from fmda_tpu.replay import ReplayDriver as JaxReplayDriver
from fmda_tpu.replay import SyntheticHistory as JaxSyntheticHistory
from fmda_tpu.replay import WarehouseHistory as JaxWarehouseHistory
from fmda_tpu.runtime import BatcherConfig as JaxBatcherConfig
from fmda_tpu.runtime import FleetGateway as JaxFleetGateway
from fmda_tpu.runtime import SessionPool as JaxSessionPool

from fmda_tpu_torch.__main__ import main as port_main
from fmda_tpu_torch.config import (
    TOPIC_FLEET_PREDICTION,
    FeatureConfig,
    ModelConfig,
    QualityConfig,
    ReplayConfig,
    WarehouseConfig,
    config_from_dict,
)
from fmda_tpu_torch.data.synthetic import SyntheticMarketConfig, build_corpus
from fmda_tpu_torch.eval.shadow import ShadowEvaluator
from fmda_tpu_torch.interop import params_from_flax
from fmda_tpu_torch.replay import (
    ReplayDriver,
    SyntheticHistory,
    WarehouseHistory,
    run_live_reference,
)
from fmda_tpu_torch.replay.history import parse_epoch
from fmda_tpu_torch.runtime import BatcherConfig, FleetGateway, SessionPool
from fmda_tpu_torch.stream import InProcessBus, Warehouse

TOL = 1e-5
FEATS, WINDOW, HIDDEN = 6, 4, 5


def _setup(cell="gru", seed=0, feats=FEATS):
    fields = dict(hidden_size=HIDDEN, n_features=feats, output_size=4,
                  dropout=0.0, bidirectional=False, cell=cell)
    jax_cfg = JaxModelConfig(use_pallas=False, **fields)
    params = jax.device_get(jax_build_model(jax_cfg).init(
        {"params": jax.random.PRNGKey(seed)},
        jnp.zeros((1, WINDOW, feats)))["params"])
    return jax_cfg, params, ModelConfig(**fields), params_from_flax(params)


def _gateway(cfg, state, *, capacity=8, buckets=(8,), bus=None):
    pool = SessionPool(cfg, state, capacity=capacity, window=WINDOW,
                       device="cpu")
    return FleetGateway(pool, bus, batcher_config=BatcherConfig(
        bucket_sizes=buckets, max_linger_s=0.001))


def _jax_gateway(cfg, params, *, capacity=8, buckets=(8,)):
    pool = JaxSessionPool(cfg, params, capacity=capacity, window=WINDOW)
    return JaxFleetGateway(pool, None, batcher_config=JaxBatcherConfig(
        bucket_sizes=buckets, max_linger_s=0.001))


def _sorted(results):
    return sorted(results, key=lambda r: (r.session_id, r.seq))


def _batches_equal(ours, ref):
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert a.virtual_ts == b.virtual_ts
        assert a.timestamps == b.timestamps
        for field in ("tickers", "rows"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype and np.array_equal(x, y)


# ---------------------------------------------------------------------------
# history sources
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("duty", [1.0, 0.4])
def test_synthetic_history_is_the_references_draws(duty):
    kw = dict(seed=3, duty=duty, step_s=30.0)
    ours = SyntheticHistory(5, 12, FEATS, **kw)
    ref = JaxSyntheticHistory(5, 12, FEATS, **kw)
    _batches_equal(list(ours), list(ref))
    _batches_equal(list(ours), list(ours))  # re-iterates bit for bit
    for a, b in zip(ours.norms, ref.norms):
        np.testing.assert_array_equal(a.x_min, b.x_min)
        np.testing.assert_array_equal(a.x_max, b.x_max)
    with pytest.raises(ValueError, match="duty"):
        SyntheticHistory(2, 2, FEATS, duty=0.0)


def _corpora(days=3):
    ours, _ = build_corpus(FeatureConfig(),
                           SyntheticMarketConfig(seed=0, n_days=days))
    ref, _ = jax_build_corpus(JaxFeatureConfig(),
                              JaxMarket(seed=0, n_days=days))
    return ours, ref


def test_warehouse_history_is_the_references_rounds():
    ours_wh, ref_wh = _corpora()
    width = len(FeatureConfig().table_columns())
    ts = ours_wh.timestamps()
    for kw in (dict(chunk=50), dict(chunk=7, start_ts=ts[20],
                                    end_ts=ts[100])):
        _batches_equal(
            list(WarehouseHistory(ours_wh, 5, n_features=width, **kw)),
            list(JaxWarehouseHistory(ref_wh, 5, n_features=width, **kw)))
    # the joined x_fields view through the warehouse's row transform
    _batches_equal(
        list(WarehouseHistory(ours_wh, 4, chunk=64,
                              row_transform=ours_wh.joined_row_transform())),
        list(JaxWarehouseHistory(ref_wh, 4, chunk=64,
                                 row_transform=ref_wh.joined_row_transform())))
    with pytest.raises(ValueError, match="row_transform"):
        list(WarehouseHistory(ours_wh, 4, n_features=width - 1))
    assert parse_epoch("2020-01-02 13:30:00") == 1577971800.0
    assert parse_epoch("not a time", 5.0) == 5.0
    ours_wh.close()
    ref_wh.close()


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", ["gru", "ssm"])
def test_replay_matches_the_reference_driver(cell):
    jax_cfg, params, cfg, state = _setup(cell)
    source = SyntheticHistory(6, 10, FEATS, seed=2)
    ours = ReplayDriver(_gateway(cfg, state), source, collect=True)
    ref = JaxReplayDriver(_jax_gateway(jax_cfg, params),
                          JaxSyntheticHistory(6, 10, FEATS, seed=2),
                          collect=True)
    out, ref_out = ours.run(), ref.run()
    for key in ("sessions", "rounds", "rows_replayed", "ticks_served",
                "virtual_start_epoch", "virtual_watermark_epoch",
                "virtual_span_s", "max_ticker_lag_s", "wire_dialect"):
        assert out[key] == ref_out[key], key
    assert out["counters"] == ref_out["counters"]
    a, b = _sorted(ours.results), _sorted(ref.results)
    assert len(a) == len(b) == 60
    for x, y in zip(a, b):
        assert (x.session_id, x.seq, x.labels) == \
            (y.session_id, y.seq, y.labels)
        np.testing.assert_allclose(x.probabilities, y.probabilities,
                                   atol=TOL, rtol=0)
    assert out["kernel_launches_by_bucket"] == {"8": 0}  # the CPU's


@pytest.mark.parametrize("cell", ["gru", "ssm"])
@pytest.mark.parametrize("dialect", [None, "binary", "json"])
def test_replay_bit_identical_to_live_serving(cell, dialect):
    _, _, cfg, state = _setup(cell)
    source = SyntheticHistory(6, 10, FEATS, seed=2)
    driver = ReplayDriver(_gateway(cfg, state), source,
                          wire_dialect=dialect, collect=True)
    summary = driver.run()
    live = run_live_reference(_gateway(cfg, state), source, collect=True)
    a, b = _sorted(driver.results), _sorted(live["results"])
    assert len(a) == len(b) == 60
    for x, y in zip(a, b):
        assert (x.session_id, x.seq) == (y.session_id, y.seq)
        assert x.probabilities.tobytes() == y.probabilities.tobytes()
        assert x.labels == y.labels
    assert summary["rows_replayed"] == summary["ticks_served"] == 60
    assert live["ticks_submitted"] == live["ticks_served"] == 60


def test_replay_driver_rejects_unknown_dialect_and_reports_progress():
    _, _, cfg, state = _setup()
    with pytest.raises(ValueError, match="wire_dialect"):
        ReplayDriver(_gateway(cfg, state), SyntheticHistory(2, 2, FEATS),
                     wire_dialect="xml")
    gateway = _gateway(cfg, state)
    out = ReplayDriver(gateway, SyntheticHistory(3, 40, FEATS, step_s=60.0)
                       ).run()
    gauges = gateway.metrics.summary()["gauges"]
    assert gauges["replay_active"] == 0.0
    assert gauges["replay_virtual_watermark"] == \
        out["virtual_watermark_epoch"]
    assert out["virtual_span_s"] == 39 * 60.0


def test_hot_swap_mid_replay_zero_drop_and_exact_seq_split():
    _, _, cfg, state = _setup()
    _, _, _, state2 = _setup(seed=9)
    tickers, rounds, swap_at = 6, 12, 6
    source = SyntheticHistory(tickers, rounds, FEATS, seed=4)
    ref = ReplayDriver(_gateway(cfg, state), source, collect=True)
    ref.run()
    bus = InProcessBus((TOPIC_FLEET_PREDICTION,))
    gateway = _gateway(cfg, state, bus=bus)
    swapped = {}

    def on_round(r):
        if not swapped and r + 1 >= swap_at:
            swapped["version"] = gateway.hot_swap(state2)

    driver = ReplayDriver(gateway, source, collect=True, on_round=on_round)
    out = driver.run()
    assert swapped["version"] == 1
    a, c = _sorted(ref.results), _sorted(driver.results)
    assert len(c) == out["ticks_served"] == tickers * rounds
    for i in range(tickers):
        assert [r.seq for r in c if r.session_id == f"T{i:04d}"] == \
            list(range(rounds))
    for x, y in zip(a, c):
        if y.seq < swap_at:
            assert x.probabilities.tobytes() == y.probabilities.tobytes()
            assert y.weights_version is None
        else:
            assert y.weights_version == 1
    assert any(not np.array_equal(x.probabilities, y.probabilities)
               for x, y in zip(a, c) if y.seq >= swap_at)
    published = [m.value for m in bus.read(TOPIC_FLEET_PREDICTION, 0)]
    assert len(published) == tickers * rounds
    assert all(("weights_version" in m) == (m["seq"] >= swap_at)
               for m in published)
    assert gateway.metrics.summary()["counters"].get("dropped", 0) == 0


# ---------------------------------------------------------------------------
# the shadow evaluator
# ---------------------------------------------------------------------------


def _shadow_params(wh, scored=0):
    """A seeded gru whose head bias decides every label as the majority of
    the ``scored`` newest rows with final targets does (+5 where a label
    is mostly on, -5 where mostly off), so it scores well on them, and the
    same with the head negated, which scores badly; ``scored=0``: bias
    0."""
    jax_cfg, params, cfg, _ = _setup(feats=len(wh.x_fields))
    params = jax.tree_util.tree_map(np.array, params)
    bias = np.zeros_like(params["linear"]["bias"])
    if scored:
        last = len(wh) - FeatureConfig().max_lead
        on = wh.fetch_targets(range(last - scored + 1, last + 1))
        bias = np.where(on.mean(axis=0) > 0.5, 5.0, -5.0).astype(bias.dtype)
    params["linear"]["bias"] = bias
    negated = jax.tree_util.tree_map(np.array, params)
    negated["linear"]["bias"] = -negated["linear"]["bias"]
    negated["linear"]["kernel"] = -negated["linear"]["kernel"]
    return jax_cfg, cfg, params, negated


def test_shadow_evaluator_verdicts_equal_the_reference():
    ours_wh, ref_wh = _corpora()
    quality = dict(swap_eval_rounds=12, swap_eval_sessions=4)
    jax_cfg, cfg, params, negated = _shadow_params(ours_wh, 12 * 4)
    kw = dict(max_lead=FeatureConfig().max_lead, window=WINDOW)
    ours = ShadowEvaluator(
        params_from_flax(params), model_config=cfg, warehouse=ours_wh,
        quality_config=QualityConfig(**quality),
        row_transform=ours_wh.joined_row_transform, device="cpu", **kw)
    ref = JaxShadowEvaluator(
        params, model_config=jax_cfg, warehouse=ref_wh,
        quality_config=JaxQualityConfig(**quality),
        row_transform=ref_wh.joined_row_transform, **kw)
    verdicts = []
    for candidate in (params, negated):
        verdicts.append((ours(params_from_flax(candidate)), ref(candidate)))
    (same, same_ref), (neg, neg_ref) = verdicts
    assert same == same_ref and neg == neg_ref
    assert same[0] is True and same[1]["scored"] is True
    assert same[1]["joined"] == 12 * 4
    assert neg[0] is False
    assert neg[1]["candidate_accuracy"] + neg[1]["margin"] < \
        neg[1]["incumbent_accuracy"]
    ours_wh.close()
    ref_wh.close()


def test_shadow_evaluator_passes_unscored_on_an_empty_warehouse():
    fc = FeatureConfig()
    wh = Warehouse(fc, WarehouseConfig(path=":memory:"))
    _, cfg, params, _ = _shadow_params(wh)
    ok, detail = ShadowEvaluator(
        params_from_flax(params), model_config=cfg, warehouse=wh,
        row_transform=wh.joined_row_transform, device="cpu")(
            params_from_flax(params))
    assert ok is True and detail["scored"] is False
    assert detail["joined"] == 0
    wh.close()


# ---------------------------------------------------------------------------
# config and CLI
# ---------------------------------------------------------------------------


def test_replay_config_is_the_references():
    assert dataclasses.asdict(ReplayConfig()) == dataclasses.asdict(
        JaxReplayConfig())
    for bad in (dict(source="kafka"), dict(wire_dialect="xml"),
                dict(n_tickers=0), dict(duty=1.5)):
        with pytest.raises(ValueError):
            ReplayConfig(**bad)
        with pytest.raises(ValueError):
            JaxReplayConfig(**bad)
    cfg = config_from_dict({"replay": {"source": "warehouse",
                                       "n_tickers": 3, "chunk": 16,
                                       "wire_dialect": "json"}})
    assert (cfg.replay.source, cfg.replay.n_tickers, cfg.replay.chunk,
            cfg.replay.wire_dialect) == ("warehouse", 3, 16, "json")
    q = config_from_dict({"quality": {"swap_margin": 0.1,
                                      "swap_eval_rounds": 5}}).quality
    assert (q.swap_margin, q.swap_eval_rounds) == (0.1, 5)


FLEET = ["serve-fleet", "--role", "solo", "--hidden", "4", "--window", "3",
         "--device", "cpu"]


@pytest.mark.parametrize("cell", ["gru", "ssm"])
def test_serve_fleet_replay_with_a_hot_swap(tmp_path, capsys, cell):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"replay": {
        "n_tickers": 6, "n_rounds": 10, "wire_dialect": "binary"}}))
    assert port_main(FLEET + ["--config", str(cfg), "--cell", cell,
                              "--replay", "--hot-swap"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["rows_replayed"] == out["ticks_served"] == 60
    assert out["hot_swap"] == {"round": 5, "weights_version": 1}
    assert out["replay"] == {"source": "synthetic", "n_tickers": 6}
    assert out["wire_dialect"] == "binary" and out["cell"] == cell
    assert out["kernel_launches_by_bucket"]


def test_serve_fleet_replays_a_warehouse_with_quality(tmp_path, capsys):
    path = str(tmp_path / "w.sqlite")
    assert port_main(["ingest", "--warehouse", path,
                      "--synthetic-days", "2"]) == 0
    capsys.readouterr()
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "warehouse": {"path": path},
        "replay": {"source": "warehouse", "n_tickers": 4, "chunk": 64}}))
    assert port_main(FLEET + ["--config", str(cfg), "--replay"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["rows_replayed"] == out["ticks_served"] == 156
    conservation = out["quality"]["conservation"]
    assert conservation["captured"] == 156
    assert conservation["captured"] == (
        conservation["joined"] + conservation["pending"]
        + conservation["expired"] + conservation["shed"])
    assert conservation["joined"] > 0
