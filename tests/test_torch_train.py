"""fmda_tpu_torch's training path against the JAX package's, on the CPU.

The same numpy-seeded data goes through the port's losses, window
arithmetic, batch padding and clip and through ``fmda_tpu``'s; the port's
``Trainer`` starts from the JAX trainer's initial params (cross-loaded
with ``interop.params_from_flax``) and at dropout 0 tracks
``fmda_tpu.train.Trainer`` (lax.scan path, CPU).  Then the port's own
contracts: gradient accumulation, exact resume, checkpoint formats, the
input pipeline, and ``python -m fmda_tpu_torch train`` followed by a
backtest of its checkpoint.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fmda_tpu.config import ModelConfig as JaxModelConfig
from fmda_tpu.config import TrainConfig as JaxTrainConfig
from fmda_tpu.data.pipeline import ChunkDataset as JaxChunkDataset
from fmda_tpu.data.pipeline import WindowBatches as JaxWindowBatches
from fmda_tpu.data.source import ArraySource as JaxArraySource
from fmda_tpu.data.windows import chunk_ranges as jax_chunk_ranges
from fmda_tpu.data.windows import train_val_test_split as jax_split
from fmda_tpu.train import Trainer as JaxTrainer
from fmda_tpu.train import losses as jax_losses

from fmda_tpu_torch.__main__ import main as port_main
from fmda_tpu_torch.config import (
    FeatureConfig,
    ModelConfig,
    TrainConfig,
    WarehouseConfig,
)
from fmda_tpu_torch.data import (
    ArraySource,
    ChunkDataset,
    WindowBatches,
    background_compose,
    chunk_ranges,
    prefetch_batches,
    train_val_test_split,
)
from fmda_tpu_torch.data.synthetic import random_walk_rows
from fmda_tpu_torch.interop import params_from_flax
from fmda_tpu_torch.stream import Warehouse
from fmda_tpu_torch.train import (
    Trainer,
    class_weights,
    clip_by_global_norm,
    imbalance_weights_from_source,
    restore_checkpoint,
    save_checkpoint,
    weighted_bce_sums,
    weighted_bce_with_logits,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-6
#: the two trainers after 16 Adam steps (params move by ~1e-2): float32
#: sums in two frameworks differ in the last bits each step, and the
#: steps compound it
TRAIN_TOL = 1e-5
BF16_TOL = 2e-2
N_ROWS, N_FEATURES, N_CLASSES = 150, 6, 4
HIDDEN, WINDOW, CHUNK, BATCH = 8, 6, 40, 16


def _data(seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(N_ROWS, N_FEATURES)).astype(np.float32)
    y = (r.random((N_ROWS, N_CLASSES)) < 0.3).astype(np.float32)
    return x, y, [f"f{i}" for i in range(N_FEATURES)]


def _logits_case(seed=1, batch=12):
    r = np.random.default_rng(seed)
    logits = (3 * r.normal(size=(batch, N_CLASSES))).astype(np.float32)
    y = (r.random((batch, N_CLASSES)) < 0.4).astype(np.float32)
    weight = r.uniform(0.5, 3, size=N_CLASSES).astype(np.float32)
    pos_weight = r.uniform(0.5, 3, size=N_CLASSES).astype(np.float32)
    mask = np.ones(batch, np.float32)
    mask[-5:] = 0.0  # a padded tail
    return logits, y, weight, pos_weight, mask


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(weighted, masked):
    logits, y, weight, pos_weight, mask = _logits_case()
    kw = dict(weight=weight, pos_weight=pos_weight) if weighted else {}
    if masked:
        kw["example_mask"] = mask
    t = {k: torch.from_numpy(v) for k, v in kw.items()}
    args = (torch.from_numpy(logits), torch.from_numpy(y))
    jargs = (jnp.asarray(logits), jnp.asarray(y))
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    np.testing.assert_allclose(
        weighted_bce_with_logits(*args, **t).numpy(),
        np.asarray(jax_losses.weighted_bce_with_logits(*jargs, **jkw)),
        rtol=LOSS_TOL)
    got = weighted_bce_sums(*args, **t)
    want = jax_losses.weighted_bce_sums(*jargs, **jkw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=LOSS_TOL)


def test_class_weights_and_imbalance_weights_match_jax():
    x, y, fields = _data()
    counts = y.sum(axis=0)
    for g, w in zip(class_weights(counts, len(y)),
                    jax_losses.class_weights(counts, len(y))):
        np.testing.assert_array_equal(g, w)
    from fmda_tpu.train.trainer import (
        imbalance_weights_from_source as jax_imbalance)

    for g, w in zip(imbalance_weights_from_source(ArraySource(x, y, fields)),
                    jax_imbalance(JaxArraySource(x, y, fields))):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_rows,chunk,window", [
    (150, 40, 6), (20_000, 2048, 30), (35, 100, 30), (400, 100, 99)])
def test_chunk_ranges_and_split_match_jax(n_rows, chunk, window):
    ranges = chunk_ranges(n_rows, chunk, window)
    assert ranges == jax_chunk_ranges(n_rows, chunk, window)
    for val, test in ((0.1, 0.1), (0.0, 0.0), (0.3, 0.2)):
        assert train_val_test_split(len(ranges), val, test) == jax_split(
            len(ranges), val, test)
    with pytest.raises(ValueError):
        chunk_ranges(n_rows, chunk, n_rows)


def test_window_batches_pad_and_mask_match_jax():
    x, y, fields = _data()
    port = ChunkDataset(ArraySource(x, y, fields), CHUNK, WINDOW)
    ref = JaxChunkDataset(JaxArraySource(x, y, fields), CHUNK, WINDOW)
    assert len(port) == len(ref) == 4
    for idx in range(len(port)):
        got = list(WindowBatches(port, idx, BATCH))
        want = list(JaxWindowBatches(ref, idx, BATCH))
        assert len(got) == len(want) == len(WindowBatches(port, idx, BATCH))
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        assert got[-1].mask.sum() < BATCH  # the tail is padded and masked
        np.testing.assert_array_equal(port.final_norm_params.x_max,
                                      ref.final_norm_params.x_max)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_optax(max_norm):
    r = np.random.default_rng(2)
    grads = [r.normal(size=s).astype(np.float32) for s in ((5, 3), (7,))]
    tensors = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm(tensors, max_norm)
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    np.testing.assert_allclose(norm.numpy(), optax.global_norm(grads),
                               rtol=1e-6)
    for t, w, g in zip(tensors, want, grads):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6)
        if max_norm > 1:  # below the threshold nothing moves at all
            np.testing.assert_array_equal(t.numpy(), g)


def _configs(**train):
    model = dict(hidden_size=HIDDEN, n_features=N_FEATURES, dropout=0.0)
    tc = dict(batch_size=BATCH, window=WINDOW, chunk_size=CHUNK, epochs=2)
    tc.update(train)
    return model, tc


@pytest.mark.parametrize("cell", ["gru", "lstm", "ssm", "attn"])
def test_trainer_tracks_the_jax_trainer(cell):
    """Two epochs (16 steps) from the same initial params at dropout 0:
    per-epoch train and val metrics and the final params agree."""
    x, y, fields = _data()
    model, tc = _configs()
    model["cell"] = cell
    if cell == "attn":  # the encoder blocks' residual dropout too
        model["attn_dropout"] = 0.0
    weight, pos_weight = imbalance_weights_from_source(
        ArraySource(x, y, fields))
    jax_trainer = JaxTrainer(JaxModelConfig(**model, use_pallas=False),
                             JaxTrainConfig(**tc), weight=weight,
                             pos_weight=pos_weight)
    # fit's own initial params: PRNGKey(seed) split into (init, step)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(0))
    init = jax.device_get(jax_trainer.init_state(init_rng).params)
    jax_state, want, _ = jax_trainer.fit(JaxArraySource(x, y, fields))

    trainer = Trainer(ModelConfig(**model), TrainConfig(**tc),
                      weight=weight, pos_weight=pos_weight, device="cpu")
    state, got, _ = trainer.fit(
        ArraySource(x, y, fields),
        initial_state=trainer.init_state(params_from_flax(init)))
    assert state.step == int(jax_state.step) == 16
    for split in ("train", "val"):
        for g, w in zip(got[split], want[split]):
            np.testing.assert_allclose(
                [g.loss, g.accuracy, g.hamming],
                [w.loss, w.accuracy, w.hamming], atol=TRAIN_TOL)
            np.testing.assert_allclose(g.fbeta, w.fbeta, atol=TRAIN_TOL)
    final = params_from_flax(jax.device_get(jax_state.params))
    for name, p in state.model.state_dict().items():
        got_p, want_p = p.numpy(), final[name].numpy()
        if name.endswith("qkv.bias"):
            # The key bias adds q . b_k to every score of a query, which
            # the softmax cancels: its gradient is 0 in exact arithmetic,
            # so both frameworks feed Adam rounding noise, which Adam
            # scales to steps of up to the learning rate.  It changes no
            # output (the losses above agree); it stays within the drift
            # Adam allows, and the query and value biases are compared.
            h = HIDDEN
            drift = state.step * TrainConfig(**tc).learning_rate
            for b_k in (got_p[h:2 * h], want_p[h:2 * h]):
                assert np.abs(b_k).max() <= drift, (name, b_k)
            got_p, want_p = (np.concatenate([a[:h], a[2 * h:]])
                             for a in (got_p, want_p))
        np.testing.assert_allclose(got_p, want_p, atol=TRAIN_TOL,
                                   err_msg=name)


def test_attn_trainer_tracks_the_jax_trainer_in_bf16():
    """The attn family's 16 steps with ``dtype="bfloat16"`` (params float32
    on both sides, dropout 0): per-epoch losses within 2e-2, the bf16
    tolerance; the params within Adam's drift bound, 16 steps x lr, since
    each framework rounds the bf16 compute at other places and Adam scales
    what the gradients then differ by to steps of up to lr."""
    _check_bf16_trainer(cell="attn", attn_dropout=0.0)


@pytest.mark.parametrize("cell", ["gru", "lstm", "ssm"])
def test_trainer_tracks_the_jax_trainer_in_bf16(cell):
    """The recurrent families' 16 steps in bfloat16, held as the attn
    family's are above."""
    _check_bf16_trainer(cell=cell)


def _check_bf16_trainer(**model_fields):
    x, y, fields = _data()
    model, tc = _configs()
    model.update(dtype="bfloat16", **model_fields)
    weight, pos_weight = imbalance_weights_from_source(
        ArraySource(x, y, fields))
    jax_trainer = JaxTrainer(JaxModelConfig(**model, use_pallas=False),
                             JaxTrainConfig(**tc), weight=weight,
                             pos_weight=pos_weight)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(0))
    init = jax.device_get(jax_trainer.init_state(init_rng).params)
    jax_state, want, _ = jax_trainer.fit(JaxArraySource(x, y, fields))
    trainer = Trainer(ModelConfig(**model), TrainConfig(**tc),
                      weight=weight, pos_weight=pos_weight, device="cpu")
    state, got, _ = trainer.fit(
        ArraySource(x, y, fields),
        initial_state=trainer.init_state(params_from_flax(init)))
    assert state.step == int(jax_state.step) == 16
    for split in ("train", "val"):
        np.testing.assert_allclose([g.loss for g in got[split]],
                                   [w.loss for w in want[split]],
                                   atol=BF16_TOL)
    drift = state.step * TrainConfig(**tc).learning_rate
    final = params_from_flax(jax.device_get(jax_state.params))
    for name, p in state.model.state_dict().items():
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.numpy(), final[name].numpy(),
                                   atol=drift, rtol=0, err_msg=name)


def test_accum_steps_2_equals_accum_steps_1():
    x, y, fields = _data(seed=3)
    model, tc = _configs(epochs=1)
    states = []
    for k in (1, 2):
        trainer = Trainer(ModelConfig(**model),
                          TrainConfig(**tc, accum_steps=k), device="cpu")
        state, history, _ = trainer.fit(ArraySource(x, y, fields))
        states.append((state.model.state_dict(), history["train"][0]))
    (p1, h1), (p2, h2) = states
    np.testing.assert_allclose(h1.loss, h2.loss, rtol=1e-6)
    assert (h1.accuracy, h1.hamming) == (h2.accuracy, h2.hamming)
    for name in p1:
        np.testing.assert_allclose(p1[name].numpy(), p2[name].numpy(),
                                   atol=1e-6, err_msg=name)


def test_fit_resumes_exactly_from_a_checkpoint(tmp_path):
    """Two epochs in one fit equal one epoch, a checkpoint, a restore and
    one more epoch, dropout (0.5, spatial) included."""
    x, y, fields = _data(seed=4)
    model, tc = _configs()
    model["dropout"] = 0.5
    mc, cfg = ModelConfig(**model), TrainConfig(**tc)
    whole, whole_hist, _ = Trainer(mc, cfg, device="cpu").fit(
        ArraySource(x, y, fields), epochs=2)

    first, _, dataset = Trainer(mc, cfg, device="cpu").fit(
        ArraySource(x, y, fields), epochs=1)
    path = save_checkpoint(str(tmp_path), first, dataset.final_norm_params)
    assert os.path.basename(path) == "step_00000008.pt"
    resumed_trainer = Trainer(mc, cfg, device="cpu")
    resumed, hist, _ = resumed_trainer.fit(
        ArraySource(x, y, fields), epochs=1,
        initial_state=resumed_trainer.restore_state(path))
    assert resumed.step == whole.step == 16
    assert hist["train"][0].loss == whole_hist["train"][1].loss
    for name, p in whole.model.state_dict().items():
        assert torch.equal(p, resumed.model.state_dict()[name]), name


def test_weights_only_checkpoints_serve_but_do_not_resume(tmp_path):
    x, y, fields = _data()
    model, tc = _configs()
    trainer = Trainer(ModelConfig(**model), TrainConfig(**tc), device="cpu")
    params = trainer.init_state().model.state_dict()
    legacy = str(tmp_path / "legacy.pt")
    torch.save({"format": "fmda_tpu_torch.checkpoint/1", "params": params,
                "step": 0}, legacy)
    tree, norm = restore_checkpoint(legacy)
    assert norm is None and tree["params"].keys() == params.keys()
    weights_only = save_checkpoint(str(tmp_path), params)
    for path in (legacy, weights_only):
        with pytest.raises(ValueError, match="weights only"):
            trainer.restore_state(path)


def test_later_epochs_replay_the_placed_batches():
    x, y, fields = _data(seed=5)
    model, tc = _configs()
    results = []
    for cache in (0, 64):
        trainer = Trainer(ModelConfig(**model),
                          TrainConfig(**tc, cache_chunks=cache), device="cpu")
        state, history, dataset = trainer.fit(ArraySource(x, y, fields))
        results.append((state.model.state_dict(), history))
        assert len(trainer._placed_cache) == (2 if cache else 0)
    (p0, h0), (p1, h1) = results
    assert [e.loss for e in h0["train"]] == [e.loss for e in h1["train"]]
    for name in p0:
        assert torch.equal(p0[name], p1[name]), name


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetch_batches_yields_every_batch_in_order(depth):
    x, y, fields = _data()
    dataset = ChunkDataset(ArraySource(x, y, fields), CHUNK, WINDOW)
    host = [b for i in range(len(dataset))
            for b in WindowBatches(dataset, i, BATCH)]
    placed = list(prefetch_batches(iter(host), lambda b: b._replace(
        x=torch.from_numpy(b.x)), depth=depth))
    assert len(placed) == len(host)
    for p, h in zip(placed, host):
        np.testing.assert_array_equal(p.x.numpy(), h.x)
        np.testing.assert_array_equal(p.mask, h.mask)


def test_background_compose_relays_the_composer_error():
    def composer():
        yield 1
        raise RuntimeError("bad chunk")

    it = background_compose(composer(), depth=1)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="bad chunk"):
        next(it)


#: a narrow schema: 2-level book, one economic event, no COT feed
FEATURES = dict(get_cot=False, bid_levels=2, ask_levels=2,
                event_list=("Core CPI",))


@pytest.mark.parametrize("cell", ["gru", "lstm", "ssm", "attn"])
def test_cli_train_then_backtest_its_checkpoint(tmp_path, capsys, cell):
    wh_path = str(tmp_path / "wh.sqlite")
    wh = Warehouse(FeatureConfig(**FEATURES), WarehouseConfig(path=wh_path))
    wh.insert_rows(random_walk_rows(FeatureConfig(**FEATURES).table_columns(),
                                    120, seed=6))
    n = len(wh)
    wh.close()
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "features": FEATURES,
        "model": {"hidden_size": HIDDEN, "cell": cell},
        "train": {"window": WINDOW, "chunk_size": CHUNK},
    }))
    ckpt_dir = str(tmp_path / "ckpt")
    proc = subprocess.run(
        [sys.executable, "-m", "fmda_tpu_torch", "train", "--device", "cpu",
         "--config", str(cfg), "--warehouse", wh_path, "--epochs", "1",
         "--batch-size", str(BATCH), "--seed", "3", "--checkpoint-dir",
         ckpt_dir],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("trained 1 epochs: loss=")
    assert lines[0].endswith("(device=cpu)")
    ckpt = lines[1].removeprefix("checkpoint: ")
    assert os.path.dirname(ckpt) == ckpt_dir and os.path.exists(ckpt)
    tree, norm = restore_checkpoint(ckpt)
    assert tree["step"] > 0 and "opt_state" in tree and norm is not None
    # the checkpoint holds the configured family's weights
    name, rows = {"gru": ("weight_hh_l0", 3), "lstm": ("weight_hh_l0", 4),
                  "ssm": ("weight_ih_l0", 3),
                  "attn": ("block_0.qkv.weight", 3)}[cell]
    assert tree["params"][name].shape[0] == rows * HIDDEN

    rc = port_main(["backtest", "--device", "cpu", "--config", str(cfg),
                    "--warehouse", wh_path, "--checkpoint", ckpt])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"backtest over {n - WINDOW + 1} rows: ")


def _cli_warehouse(tmp_path, n_rows, seed=6):
    wh_path = str(tmp_path / "wh.sqlite")
    wh = Warehouse(FeatureConfig(**FEATURES), WarehouseConfig(path=wh_path))
    wh.insert_rows(random_walk_rows(FeatureConfig(**FEATURES).table_columns(),
                                    n_rows, seed=seed))
    wh.close()
    return wh_path


def test_cli_train_writes_the_drift_profile_beside_its_checkpoint(
        tmp_path, capsys):
    from fmda_tpu_torch.eval import build_profile, load_profile
    from fmda_tpu_torch.eval import profile_path_for

    wh_path = _cli_warehouse(tmp_path, 120)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "features": FEATURES, "model": {"hidden_size": HIDDEN},
        "train": {"window": WINDOW, "chunk_size": CHUNK},
        "quality": {"drift_bins": 6}}))
    assert port_main([
        "train", "--device", "cpu", "--config", str(cfg), "--warehouse",
        wh_path, "--epochs", "1", "--batch-size", str(BATCH),
        "--checkpoint-dir", str(tmp_path / "ckpt")]) == 0
    lines = capsys.readouterr().out.splitlines()
    ckpt = lines[1].removeprefix("checkpoint: ")
    path = lines[2].removeprefix("drift reference profile: ")
    assert path == profile_path_for(ckpt) and os.path.exists(path)
    wh = Warehouse(FeatureConfig(**FEATURES), WarehouseConfig(path=wh_path))
    ids = range(1, len(wh) + 1)
    want = build_profile(wh.fetch(ids), wh.fetch_targets(ids), bins=6,
                         columns=list(wh.x_fields))
    assert load_profile(path) == json.loads(json.dumps(want))


def test_cli_train_continuous_runs_bounded_rounds(tmp_path, capsys):
    """1,100 rows tailed in pages of 1,024: a round on the first page, and
    the 76 left over drain into a second when the tail quiesces."""
    wh_path = _cli_warehouse(tmp_path, 1100, seed=7)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "features": FEATURES, "model": {"hidden_size": HIDDEN},
        "train": {"window": WINDOW, "chunk_size": 100, "batch_size": 64,
                  "continuous_poll_s": 0.01}}))
    ckpt_dir = tmp_path / "ckpt"
    assert port_main([
        "train", "--device", "cpu", "--config", str(cfg), "--warehouse",
        wh_path, "--continuous", "--max-rounds", "2", "--checkpoint-dir",
        str(ckpt_dir)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ("continuous train: 2 round(s), 1100 rows seen, "
                        "2 checkpoint(s) (device=cpu)")
    ckpts = [ln.removeprefix("checkpoint: ") for ln in lines[1:]]
    assert len(ckpts) == 2
    for ckpt in ckpts:
        assert os.path.dirname(ckpt) == str(ckpt_dir)
        tree, norm = restore_checkpoint(ckpt)
        assert "opt_state" in tree and norm is not None
        assert os.path.exists(ckpt.removesuffix(".pt")
                              + ".quality_profile.json")
