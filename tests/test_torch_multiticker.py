"""fmda_tpu_torch's multi-ticker training against the JAX package's, on
the CPU.

The same numpy-seeded tickers go through the port's
``MultiTickerDataset`` and ``fmda_tpu``'s (splits, rounds and every mixed
batch bit for bit), then through ``Trainer.fit_multi`` on both sides from
the same initial params (the JAX init cross-loaded with
``interop.params_from_flax``) at dropout 0: chunk-interleaved and mixed
batches for the GRU, mixed batches for the LSTM, the SSM and the
attention family.
"""

import jax
import numpy as np
import pytest

from fmda_tpu.config import ModelConfig as JaxModelConfig
from fmda_tpu.config import TrainConfig as JaxTrainConfig
from fmda_tpu.data.source import ArraySource as JaxArraySource
from fmda_tpu.train import MultiTickerDataset as JaxMultiTickerDataset
from fmda_tpu.train import Trainer as JaxTrainer

from fmda_tpu_torch.config import ModelConfig, TrainConfig
from fmda_tpu_torch.data import ArraySource
from fmda_tpu_torch.interop import params_from_flax
from fmda_tpu_torch.train import (
    MultiTickerDataset,
    Trainer,
    imbalance_weights_from_source,
)

TICKERS, N_ROWS, N_FEATURES, N_CLASSES = 3, 200, 6, 4
HIDDEN, WINDOW, CHUNK, BATCH, PER_TICKER = 8, 4, 40, 16, 5
#: per-epoch metrics after ~20 Adam steps from the same params: float32
#: sums in two frameworks differ in the last bits, compounded by the steps
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4


def _tickers(seed=0, n_rows=N_ROWS):
    """{ticker: (x, y, fields)}, each ticker on its own price scale."""
    r = np.random.default_rng(seed)
    fields = [f"f{i}" for i in range(N_FEATURES)]
    out = {}
    for t in range(TICKERS):
        scale = 10.0 ** t
        x = (scale * r.normal(size=(n_rows, N_FEATURES))).astype(np.float32)
        y = (r.random((n_rows, N_CLASSES)) < 0.3).astype(np.float32)
        out[f"TK{t}"] = (x, y, fields)
    return out


def _sources(data, cls):
    return {t: cls(*v) for t, v in data.items()}


def test_dataset_splits_rounds_and_mixed_batches_match_jax():
    data = _tickers()
    port = MultiTickerDataset(_sources(data, ArraySource), CHUNK, WINDOW)
    ref = JaxMultiTickerDataset(_sources(data, JaxArraySource), CHUNK, WINDOW)
    assert port.tickers == ref.tickers
    for val, test in ((0.1, 0.1), (0.2, 0.2), (0.0, 0.0)):
        splits = port.splits(val, test)
        assert splits == ref.splits(val, test)
        for chunks in splits:
            assert port.rounds(chunks) == ref.rounds(chunks)
    train, _, _ = port.splits(0.1, 0.1)
    n = 0
    for rc in port.rounds(train):
        got = list(port.mixed_batches(rc, PER_TICKER))
        want = list(ref.mixed_batches(rc, PER_TICKER))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.x.shape == (TICKERS * PER_TICKER, WINDOW, N_FEATURES)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
            n += 1
    assert n > 0
    for t, (tc, c) in enumerate(train[:TICKERS]):
        for g, w in zip(port.batches(tc, c, BATCH),
                        ref.batches(tc, c, BATCH)):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    got, want = port.final_norm_params(), ref.final_norm_params()
    assert got.keys() == want.keys()
    for t in got:
        np.testing.assert_array_equal(got[t].x_min, want[t].x_min)
        np.testing.assert_array_equal(got[t].x_max, want[t].x_max)


def test_absent_tickers_are_zero_filled_with_mask_zero():
    """A ticker with fewer rows runs out first: its slots of the later
    mixed batches are zeros with mask 0, and the batch keeps its shape."""
    data = _tickers(seed=1)
    x, y, fields = data["TK0"]
    data["TK0"] = (x[:90], y[:90], fields)
    port = MultiTickerDataset(_sources(data, ArraySource), CHUNK, WINDOW)
    ref = JaxMultiTickerDataset(_sources(data, JaxArraySource), CHUNK, WINDOW)
    rounds = port.rounds(port.splits(0.0, 0.0)[0])
    assert rounds == ref.rounds(ref.splits(0.0, 0.0)[0])
    assert "TK0" not in rounds[-1]
    for rc in rounds:
        for g, w in zip(port.mixed_batches(rc, PER_TICKER),
                        ref.mixed_batches(rc, PER_TICKER)):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    last = list(port.mixed_batches(rounds[-1], PER_TICKER))[-1]
    assert last.x.shape[0] == TICKERS * PER_TICKER
    assert not last.mask[:PER_TICKER].any() and not last.x[:PER_TICKER].any()


def test_tickers_must_share_one_schema():
    data = _tickers()
    x, y, _ = data["TK1"]
    data["TK1"] = (x, y, [f"g{i}" for i in range(N_FEATURES)])
    for cls, source in ((MultiTickerDataset, ArraySource),
                        (JaxMultiTickerDataset, JaxArraySource)):
        with pytest.raises(ValueError, match="share one feature schema"):
            cls(_sources(data, source), CHUNK, WINDOW)
    with pytest.raises(ValueError, match="no sources"):
        MultiTickerDataset({}, CHUNK, WINDOW)


def _compared(cell, state, final, steps, lr):
    """(name, port, jax) params to compare; attn's key bias is held to
    Adam's drift instead (see tests/test_torch_train.py: the softmax
    cancels it, so both frameworks step on rounding noise)."""
    out = []
    for name, p in state.model.state_dict().items():
        got_p, want_p = p.numpy(), final[name].numpy()
        if cell == "attn" and name.endswith("qkv.bias"):
            h = HIDDEN
            for b_k in (got_p[h:2 * h], want_p[h:2 * h]):
                assert np.abs(b_k).max() <= steps * lr, (name, b_k)
            got_p, want_p = (np.concatenate([a[:h], a[2 * h:]])
                             for a in (got_p, want_p))
        out.append((name, got_p, want_p))
    return out


@pytest.mark.parametrize("cell,per_ticker", [
    ("gru", None), ("gru", PER_TICKER), ("lstm", PER_TICKER),
    ("ssm", PER_TICKER), ("attn", PER_TICKER)])
def test_fit_multi_tracks_the_jax_fit_multi(monkeypatch, cell, per_ticker):
    """Two epochs from the same initial params at dropout 0: per-epoch
    train and val metrics within LOSS_TOL, final params within PARAM_TOL."""
    data = _tickers(seed=2)
    model = dict(hidden_size=HIDDEN, n_features=N_FEATURES, dropout=0.0,
                 cell=cell)
    if cell == "attn":
        model["attn_dropout"] = 0.0
    tc = dict(batch_size=BATCH, window=WINDOW, chunk_size=CHUNK, epochs=2)
    weight, pos_weight = imbalance_weights_from_source(
        ArraySource(*data["TK0"]))
    jax_trainer = JaxTrainer(JaxModelConfig(**model, use_pallas=False),
                             JaxTrainConfig(**tc), weight=weight,
                             pos_weight=pos_weight)
    # fit_multi's own initial params: PRNGKey(seed) split into (init, step)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(0))
    init = params_from_flax(
        jax.device_get(jax_trainer.init_state(init_rng).params))
    jax_state, want, ref_mtd = jax_trainer.fit_multi(
        _sources(data, JaxArraySource), mixed_batch_per_ticker=per_ticker)

    trainer = Trainer(ModelConfig(**model), TrainConfig(**tc), weight=weight,
                      pos_weight=pos_weight, device="cpu")
    fresh = trainer.init_state
    monkeypatch.setattr(trainer, "init_state", lambda: fresh(init))
    state, got, mtd = trainer.fit_multi(
        _sources(data, ArraySource), mixed_batch_per_ticker=per_ticker)
    assert isinstance(mtd, MultiTickerDataset)
    assert state.step == int(jax_state.step) > 0
    for split in ("train", "val"):
        assert len(got[split]) == len(want[split]) == 2
        for g, w in zip(got[split], want[split]):
            np.testing.assert_allclose(
                [g.loss, g.accuracy, g.hamming],
                [w.loss, w.accuracy, w.hamming], atol=LOSS_TOL)
            np.testing.assert_allclose(g.fbeta, w.fbeta, atol=LOSS_TOL)
    final = params_from_flax(jax.device_get(jax_state.params))
    for name, g, w in _compared(cell, state, final, state.step,
                                trainer.train_cfg.learning_rate):
        np.testing.assert_allclose(g, w, atol=PARAM_TOL, err_msg=name)
    if per_ticker:  # every step one mixed batch of every ticker
        rounds = mtd.rounds(mtd.splits(0.1, 0.1)[0])
        per_epoch = sum(max(len(mtd.batches(t, c, per_ticker))
                            for t, c in rc.items()) for rc in rounds)
        assert state.step == 2 * per_epoch


def test_fit_records_epochs_in_the_default_registry():
    from fmda_tpu_torch.obs import default_registry

    reg = default_registry()
    before = reg.counter("train_epochs_total").value
    n_before = reg.histogram("train_epoch_seconds").n
    x, y, fields = _tickers()["TK0"]
    Trainer(ModelConfig(hidden_size=HIDDEN, n_features=N_FEATURES),
            TrainConfig(batch_size=BATCH, window=WINDOW, chunk_size=CHUNK,
                        epochs=2), device="cpu").fit(ArraySource(x, y, fields))
    assert reg.counter("train_epochs_total").value == before + 2
    assert reg.histogram("train_epoch_seconds").n == n_before + 2


def test_registry_snapshot_matches_the_reference():
    """The same updates through the port's and the reference's
    MetricsRegistry give the same snapshot, sample for sample; the same
    (name, labels) is the same instrument."""
    from fmda_tpu.obs.registry import MetricsRegistry as JaxRegistry

    from fmda_tpu_torch.obs import MetricsRegistry

    def drive(reg):
        reg.counter("swaps_total", outcome="accepted").inc()
        reg.counter("swaps_total", outcome="accepted").inc(2.5)
        reg.counter("swaps_total", outcome="refused").inc()
        reg.gauge("weights_version").set(3)
        hist = reg.histogram("round_seconds", cell="gru")
        assert hist is reg.histogram("round_seconds", cell="gru")
        for s in np.random.default_rng(0).exponential(0.05, 200):
            hist.observe(float(s))
        return reg.snapshot()

    assert drive(MetricsRegistry()) == drive(JaxRegistry())
