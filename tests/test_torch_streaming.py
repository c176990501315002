"""fmda_tpu_torch's carried-state streaming serving against the JAX
package's, on the CPU.

``StreamingBiGRU`` (gru, lstm, ssm; 1 and 2 layers),
``StreamingBiGRUBidirectional`` (gru, lstm) and ``StreamingPredictor`` (with
a gap catch-up) run the same numpy rows as ``fmda_tpu.serve.streaming``'s,
with weights cross-loaded from flax and non-identity norms: probabilities
agree to 1e-5 (float32 through two frameworks).  The ssm core is also held
to the port's own ``GatedSSM`` forward (the family's train/serve duality,
2e-5), and the carried-state model arguments of the BiGRU and BiLSTM to
one full window and to JAX's.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmda_tpu.config import DEFAULT_TOPICS as JAX_TOPICS
from fmda_tpu.config import FeatureConfig as JaxFeatureConfig
from fmda_tpu.config import ModelConfig as JaxModelConfig
from fmda_tpu.config import WarehouseConfig as JaxWarehouseConfig
from fmda_tpu.data.normalize import NormParams as JaxNormParams
from fmda_tpu.models import build_model as jax_build_model
from fmda_tpu.serve.streaming import StreamingBiGRU as JaxStreamingBiGRU
from fmda_tpu.serve.streaming import (
    StreamingBiGRUBidirectional as JaxStreamingBiGRUBidirectional,
)
from fmda_tpu.serve.streaming import StreamingPredictor as JaxStreamingPredictor
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
from fmda_tpu_torch.data.normalize import NormParams
from fmda_tpu_torch.data.synthetic import random_walk_rows
from fmda_tpu_torch.interop import params_from_flax
from fmda_tpu_torch.models import BiGRUState, BiLSTMState, build_model
from fmda_tpu_torch.ops import ssm_kernel
from fmda_tpu_torch.serve import (
    StreamingBiGRU,
    StreamingBiGRUBidirectional,
    StreamingPredictor,
)
from fmda_tpu_torch.serve.streaming import _recurrent_cell_ops
from fmda_tpu_torch.stream import InProcessBus, Warehouse

TOL = 1e-5
DUALITY_TOL = 2e-5
#: bfloat16 compute against the JAX package's: the two frameworks round
#: the bf16 arithmetic at other places
BF16_TOL = 2e-2
FEATS, HIDDEN, WINDOW = 6, 5, 4


def _setup(cell, *, n_layers=1, bidirectional=False, feats=FEATS, seed=0):
    fields = dict(hidden_size=HIDDEN, n_features=feats, output_size=4,
                  dropout=0.0, bidirectional=bidirectional, cell=cell,
                  n_layers=n_layers)
    jax_cfg = JaxModelConfig(use_pallas=False, **fields)
    params = jax.device_get(jax_build_model(jax_cfg).init(
        {"params": jax.random.PRNGKey(seed)},
        jnp.zeros((1, WINDOW, feats)))["params"])
    return jax_cfg, params, ModelConfig(**fields), params_from_flax(params)


def _norm(feats=FEATS, seed=1):
    r = np.random.default_rng(seed)
    x_min = r.normal(size=feats).astype(np.float32)
    x_max = x_min + r.uniform(1.0, 5.0, size=feats).astype(np.float32)
    return x_min, x_max


def _rows(n, feats=FEATS, seed=2):
    return (3.0 * np.random.default_rng(seed).normal(size=(n, feats))
            ).astype(np.float32)


@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("cell", ["gru", "lstm", "ssm"])
def test_streaming_core_matches_jax(cell, n_layers):
    jax_cfg, params, cfg, state = _setup(cell, n_layers=n_layers)
    x_min, x_max = _norm()
    jax_core = JaxStreamingBiGRU(jax_cfg, params, JaxNormParams(x_min, x_max),
                                 window=WINDOW)
    core = StreamingBiGRU(cfg, state, NormParams(x_min, x_max),
                          window=WINDOW, device="cpu")
    rows = _rows(42)
    for t, row in enumerate(rows):
        got, want = core.step(row), jax_core.step(row)
        assert got.shape == (1, 4) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=TOL, err_msg=f"tick {t}")
    assert core.ticks_seen == jax_core.ticks_seen == len(rows)
    assert ssm_kernel.launches == 0  # CPU tensors: the plain version
    core.reset()
    assert core.ticks_seen == 0
    jax_core.reset()
    np.testing.assert_allclose(core.step(rows[0]), jax_core.step(rows[0]),
                               atol=TOL)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_bidirectional_streaming_core_matches_jax(cell):
    jax_cfg, params, cfg, state = _setup(cell, bidirectional=True)
    x_min, x_max = _norm()
    jax_core = JaxStreamingBiGRUBidirectional(
        jax_cfg, params, JaxNormParams(x_min, x_max), window=WINDOW, batch=2)
    core = StreamingBiGRUBidirectional(cfg, state, NormParams(x_min, x_max),
                                       window=WINDOW, batch=2, device="cpu")
    rows = _rows(2 * 41).reshape(41, 2, FEATS)
    for t, row in enumerate(rows):
        np.testing.assert_allclose(core.step(row), jax_core.step(row),
                                   atol=TOL, err_msg=f"tick {t}")
    assert core.ticks_seen == 41


def _full_width_bf16(cell, *, bidirectional=False, seed=0):
    """Full width (H = 32, F = 108, window 30), dtype bfloat16, weights
    cross-loaded; and seeded norms and 40 rows."""
    fields = dict(hidden_size=32, n_features=108, output_size=4,
                  dropout=0.0, bidirectional=bidirectional, cell=cell,
                  dtype="bfloat16")
    jax_cfg = JaxModelConfig(use_pallas=False, **fields)
    params = jax.device_get(jax_build_model(jax_cfg).init(
        {"params": jax.random.PRNGKey(seed)},
        jnp.zeros((1, 30, 108)))["params"])
    return (jax_cfg, params, ModelConfig(**fields), params_from_flax(params),
            _norm(108), _rows(40, 108))


@pytest.mark.parametrize("cell", ["gru", "lstm", "ssm"])
def test_streaming_core_matches_jax_in_bf16(cell):
    """40 ticks of the carried-state core in bfloat16 at full width: the
    probabilities within 2e-2 of the JAX core's."""
    jax_cfg, params, cfg, state, (x_min, x_max), rows = _full_width_bf16(
        cell)
    jax_core = JaxStreamingBiGRU(jax_cfg, params, JaxNormParams(x_min, x_max),
                                 window=30)
    core = StreamingBiGRU(cfg, state, NormParams(x_min, x_max), window=30,
                          device="cpu")
    for t, row in enumerate(rows):
        np.testing.assert_allclose(
            core.step(row), np.asarray(jax_core.step(row), np.float32),
            atol=BF16_TOL, rtol=0, err_msg=f"tick {t}")


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_bidirectional_streaming_core_matches_jax_in_bf16(cell):
    jax_cfg, params, cfg, state, (x_min, x_max), rows = _full_width_bf16(
        cell, bidirectional=True)
    jax_core = JaxStreamingBiGRUBidirectional(
        jax_cfg, params, JaxNormParams(x_min, x_max), window=30)
    core = StreamingBiGRUBidirectional(cfg, state, NormParams(x_min, x_max),
                                       window=30, device="cpu")
    for t, row in enumerate(rows):
        np.testing.assert_allclose(
            core.step(row), np.asarray(jax_core.step(row), np.float32),
            atol=BF16_TOL, rtol=0, err_msg=f"tick {t}")


def _warehouse_pair(tmp_path, n=60):
    """A JAX-written warehouse file, opened by both packages (a narrow
    schema: 2-level book, one economic event, no COT feed)."""
    features = dict(get_cot=False, bid_levels=2, ask_levels=2,
                    event_list=("Core CPI",))
    path = str(tmp_path / "wh.sqlite")
    rows = random_walk_rows(FeatureConfig(**features).table_columns(), n,
                            seed=3)
    jax_wh = JaxWarehouse(JaxFeatureConfig(**features),
                          JaxWarehouseConfig(path=path))
    jax_wh.insert_rows(rows)
    return jax_wh, Warehouse(FeatureConfig(**features),
                             WarehouseConfig(path=path))


@pytest.mark.parametrize("cell,bidirectional", [
    ("gru", False), ("ssm", False), ("lstm", True)])
def test_streaming_predictor_with_gap_catchup_matches_jax(
        tmp_path, cell, bidirectional):
    jax_wh, wh = _warehouse_pair(tmp_path)
    feats = len(wh.x_fields)
    jax_cfg, params, cfg, state = _setup(cell, bidirectional=bidirectional,
                                         feats=feats)
    x = wh.fetch(range(1, len(wh) + 1))
    x_min, x_max = x.min(axis=0), x.max(axis=0) + 1.0
    jax_cls = (JaxStreamingBiGRUBidirectional if bidirectional
               else JaxStreamingBiGRU)
    cls = StreamingBiGRUBidirectional if bidirectional else StreamingBiGRU
    jax_core = jax_cls(jax_cfg, params, JaxNormParams(x_min, x_max),
                       window=WINDOW)
    core = cls(cfg, state, NormParams(x_min, x_max), window=WINDOW,
               device="cpu")
    jax_bus, bus = JaxBus(JAX_TOPICS), InProcessBus(DEFAULT_TOPICS)
    jax_pred = JaxStreamingPredictor(jax_bus, jax_wh, jax_core,
                                     from_end=False)
    pred = StreamingPredictor(bus, wh, core, from_end=False)
    stamps = dict(wh.timestamps_after(0))
    # a first signal 10 rows in (catch-up), 5 in a row, a gap to row 31,
    # an old row (skipped) and an unknown timestamp (skipped)
    ids = [10, 11, 12, 13, 14, 15, 31, 12]
    for i in ids:
        jax_bus.publish(TOPIC_PREDICT_TIMESTAMP, {"Timestamp": stamps[i]})
        bus.publish(TOPIC_PREDICT_TIMESTAMP, {"Timestamp": stamps[i],
                                              "trace": f"t{i}"})
    bus.publish(TOPIC_PREDICT_TIMESTAMP, {"Timestamp": "1999-01-01 00:00:00"})
    want, got = jax_pred.poll(), pred.poll()
    assert len(got) == len(want) == 7
    assert core.ticks_seen == 31
    for (gts, gp, gl), (wts, wp, wl) in zip(got, want):
        assert gts == wts and gl == wl
        np.testing.assert_allclose(gp, wp, atol=TOL)
    published = [r.value for r in bus.consumer(TOPIC_PREDICTION).poll()]
    assert [m["timestamp"] for m in published] == [stamps[i]
                                                   for i in ids[:7]]
    assert published[0]["trace"] == "t10"
    assert set(published[0]) == {
        "timestamp", "probabilities", "prob_threshold", "pred_indices",
        "pred_labels", "trace"}
    jax_wh.close()
    wh.close()


def test_catchup_fetches_in_chunks(tmp_path, monkeypatch):
    jax_wh, wh = _warehouse_pair(tmp_path)
    jax_wh.close()
    _, _, cfg, state = _setup("ssm", feats=len(wh.x_fields))
    core = StreamingBiGRU(cfg, state, NormParams(*_norm(len(wh.x_fields))),
                          window=WINDOW, device="cpu")
    bus = InProcessBus(DEFAULT_TOPICS)
    pred = StreamingPredictor(bus, wh, core, from_end=False)
    monkeypatch.setattr(pred, "CATCHUP_CHUNK", 16)
    calls = []
    real_fetch = wh.fetch
    monkeypatch.setattr(wh, "fetch",
                        lambda ids: calls.append(len(ids)) or real_fetch(ids))
    bus.publish(TOPIC_PREDICT_TIMESTAMP,
                {"Timestamp": dict(wh.timestamps_after(0))[40]})
    assert len(pred.poll()) == 1
    assert calls == [16, 16, 8] and core.ticks_seen == 40
    wh.close()


@pytest.mark.parametrize("n_layers", [1, 2])
def test_ssm_duality_model_forward_equals_stepped_core(n_layers):
    """The port's own GatedSSM forward (parallel mode) over T rows equals
    the ssm core (the O(1) cache) stepped T times, on shared params."""
    cfg = ModelConfig(hidden_size=HIDDEN, n_features=FEATS, dropout=0.0,
                      bidirectional=False, cell="ssm", n_layers=n_layers)
    model = build_model(cfg, generator=torch.Generator().manual_seed(4))
    model.eval()
    rows = _rows(20, seed=8) / 3.0
    with torch.inference_mode():
        want = torch.sigmoid(model(torch.from_numpy(rows)[None]))[0].numpy()
    core = StreamingBiGRU(
        cfg, model.state_dict(),
        NormParams(np.zeros(FEATS, np.float32), np.ones(FEATS, np.float32)),
        window=5, device="cpu")  # window is irrelevant: no ring
    for row in rows:
        got = core.step(row)[0]
    np.testing.assert_allclose(got, want, atol=DUALITY_TOL)


def test_ssm_core_carries_no_window_state():
    _, _, cfg, state = _setup("ssm", n_layers=2)
    core = StreamingBiGRU(cfg, state, NormParams(*_norm()), window=30,
                          batch=3, device="cpu")
    assert core._ring.shape == (3, 0, HIDDEN)
    assert len(core._h) == 2
    for layer in core._h:
        assert len(layer) == 3
        for c in layer:
            assert c.shape == (3, HIDDEN)


def _norm_params():
    return NormParams(np.zeros(3, np.float32), np.ones(3, np.float32))


@pytest.mark.parametrize("case", [
    "bidirectional_ssm", "attn_ops", "attn_core", "bidirectional_in_uni",
    "uni_in_bidirectional", "stacked_bidirectional"])
def test_refusals_raise_as_jax_does(case):
    def cfg(**kw):
        base = dict(hidden_size=4, n_features=3, output_size=4)
        return ModelConfig(**{**base, **kw})

    norm = _norm_params()
    if case == "bidirectional_ssm":
        with pytest.raises(ValueError, match="no bidirectional carried"):
            StreamingBiGRUBidirectional(cfg(cell="ssm"), {}, norm, window=4,
                                        device="cpu")
    elif case == "attn_ops":
        with pytest.raises(ValueError, match="window-re-scan Predictor"):
            _recurrent_cell_ops("attn")
    elif case == "attn_core":
        # the port's ModelConfig refuses attn itself; a config object that
        # did not come through it still meets the streaming core's check
        attn = types.SimpleNamespace(cell="attn", bidirectional=False)
        with pytest.raises(ValueError, match="Predictor"):
            StreamingBiGRU(attn, {}, norm, window=2, device="cpu")
    elif case == "bidirectional_in_uni":
        with pytest.raises(ValueError, match="bidirectional"):
            StreamingBiGRU(cfg(), {}, norm, window=2, device="cpu")
    elif case == "uni_in_bidirectional":
        with pytest.raises(ValueError, match="StreamingBiGRU"):
            StreamingBiGRUBidirectional(cfg(bidirectional=False), {}, norm,
                                        window=2, device="cpu")
    else:
        with pytest.raises(ValueError, match="Predictor"):
            StreamingBiGRUBidirectional(cfg(n_layers=2), {}, norm, window=2,
                                        device="cpu")


@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_carried_state_arguments_match_full_window_and_jax(cell, n_layers):
    jax_cfg, params, cfg, state = _setup(cell, n_layers=n_layers)
    jax_model = jax_build_model(jax_cfg)
    model = build_model(cfg)
    model.load_state_dict(state, strict=True)
    model.eval()
    x = _rows(2 * 10, seed=9).reshape(2, 10, FEATS) / 3.0
    xt = torch.from_numpy(x)
    state_type = {"gru": BiGRUState, "lstm": BiLSTMState}[cell]
    _, jfull = jax_model.apply({"params": params}, x, return_state=True)
    _, jhalf = jax_model.apply({"params": params}, x[:, :6],
                               return_state=True)
    jlogits, jres = jax_model.apply({"params": params}, x[:, 6:], jhalf,
                                    return_state=True)
    with torch.inference_mode():
        _, full = model(xt, return_state=True)
        _, half = model(xt[:, :6], return_state=True)
        assert isinstance(half, state_type)
        logits, resumed = model(xt[:, 6:], state=half, return_state=True)
    for field in state_type._fields:
        got = getattr(resumed, field)
        assert got.shape == (n_layers, 1, 2, HIDDEN)
        np.testing.assert_allclose(got.numpy(), getattr(full, field).numpy(),
                                   atol=TOL)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(getattr(jres, field)), atol=TOL)
        np.testing.assert_allclose(getattr(full, field).numpy(),
                                   np.asarray(getattr(jfull, field)),
                                   atol=TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_carried_state_into_a_bidirectional_model_is_refused(cell):
    _, _, cfg, state = _setup(cell, bidirectional=True)
    model = build_model(cfg)
    model.load_state_dict(state)
    model.eval()
    x = torch.zeros(1, 4, FEATS)
    with torch.inference_mode():
        _, st = model(x, return_state=True)  # returned, as JAX returns it
        assert st.hidden.shape == (1, 2, 1, HIDDEN)
        with pytest.raises(ValueError, match="bidirectional=False"):
            model(x, state=st)
