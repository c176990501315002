"""Parts of the reference's training modules the port had left out, against
the JAX package on the CPU.

- ``prefetch_batches(stall_observer=)`` (``fmda_tpu/data/pipeline.py``):
  the same batches, one observation a pull, at every depth;
- the Trainer's ``train_input_stall_seconds`` histogram: one epoch of the
  same source observes one wait per batch in both trainers;
- ``Application.train(mesh=)`` and ``ContinuousTrainer(mesh=, dp_axis=)``
  hand their mesh to the Trainer, as the reference's do (a mesh of ranks
  needs a ``torch.distributed`` world: the dp trainer itself is held to
  the reference in ``tests/test_torch_dp_train.py``; here the hand-over
  is checked on both packages with the Trainer recorded in place).
"""

import numpy as np
import pytest

from fmda_tpu.config import FrameworkConfig as JaxFrameworkConfig
from fmda_tpu.config import ModelConfig as JaxModelConfig
from fmda_tpu.config import TrainConfig as JaxTrainConfig
from fmda_tpu.data.pipeline import ChunkDataset as JaxChunkDataset
from fmda_tpu.data.pipeline import WindowBatches as JaxWindowBatches
from fmda_tpu.data.pipeline import prefetch_batches as jax_prefetch_batches
from fmda_tpu.data.source import ArraySource as JaxArraySource
from fmda_tpu.obs.registry import default_registry as jax_registry
from fmda_tpu.train import Trainer as JaxTrainer

from fmda_tpu_torch.config import FrameworkConfig, ModelConfig, TrainConfig
from fmda_tpu_torch.data import (
    ArraySource, ChunkDataset, WindowBatches, prefetch_batches)
from fmda_tpu_torch.obs.registry import default_registry
from fmda_tpu_torch.train import Trainer

N_ROWS, N_FEATURES, N_CLASSES = 150, 6, 4
HIDDEN, WINDOW, CHUNK, BATCH = 8, 6, 40, 16
STALL = "train_input_stall_seconds"


def _data(seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(N_ROWS, N_FEATURES)).astype(np.float32)
    y = (r.random((N_ROWS, N_CLASSES)) < 0.3).astype(np.float32)
    return x, y, [f"f{i}" for i in range(N_FEATURES)]


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetch_stall_observer_matches_the_reference(depth):
    x, y, fields = _data()
    ours = ChunkDataset(ArraySource(x, y, fields), CHUNK, WINDOW)
    theirs = JaxChunkDataset(JaxArraySource(x, y, fields), CHUNK, WINDOW)
    host = [b for i in range(len(ours))
            for b in WindowBatches(ours, i, BATCH)]
    jax_host = [b for i in range(len(theirs))
                for b in JaxWindowBatches(theirs, i, BATCH)]
    seen, jax_seen = [], []
    got = list(prefetch_batches(iter(host), lambda b: b, depth=depth,
                                stall_observer=seen.append))
    want = list(jax_prefetch_batches(iter(jax_host), lambda b: b,
                                     depth=depth,
                                     stall_observer=jax_seen.append))
    assert len(got) == len(want) == len(host)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.x, w.x)
        np.testing.assert_array_equal(g.mask, w.mask)
    assert len(seen) == len(jax_seen) == len(host)
    assert all(s >= 0.0 for s in seen)


def test_prefetch_without_an_observer_observes_nothing():
    x, y, fields = _data(seed=1)
    dataset = ChunkDataset(ArraySource(x, y, fields), CHUNK, WINDOW)
    host = list(WindowBatches(dataset, 0, BATCH))
    assert len(list(prefetch_batches(iter(host), lambda b: b))) == len(host)


def test_trainer_stall_histogram_matches_the_reference():
    """One epoch over the same source: each trainer observes one input
    wait per batch it pulls (train and val), into its process registry's
    ``train_input_stall_seconds``."""
    x, y, fields = _data(seed=2)
    model = dict(hidden_size=HIDDEN, n_features=N_FEATURES, dropout=0.0)
    tc = dict(batch_size=BATCH, window=WINDOW, chunk_size=CHUNK, epochs=1)
    dataset = ChunkDataset(ArraySource(x, y, fields), CHUNK, WINDOW)
    train, val, _ = dataset.split(0.1, 0.1)
    n_batches = sum(len(WindowBatches(dataset, i, BATCH))
                    for i in (*train, *val))

    def count(registry):
        return registry.histogram(STALL).summary()["count"]

    before = count(default_registry()), count(jax_registry())
    Trainer(ModelConfig(**model), TrainConfig(**tc), device="cpu").fit(
        ArraySource(x, y, fields))
    JaxTrainer(JaxModelConfig(**model, use_pallas=False),
               JaxTrainConfig(**tc)).fit(JaxArraySource(x, y, fields))
    after = count(default_registry()), count(jax_registry())
    assert after[0] - before[0] == after[1] - before[1] == n_batches


class _Recorded(Exception):
    """Raised by a recording Trainer, once its arguments are kept."""


def _recording_trainer(seen):
    def trainer(*args, **kwargs):
        seen.append(kwargs)
        raise _Recorded
    return trainer


def test_application_train_hands_its_mesh_to_the_trainer(monkeypatch):
    import fmda_tpu.train.trainer as jax_trainer_mod
    import fmda_tpu_torch.train.trainer as trainer_mod
    from fmda_tpu.app import Application as JaxApplication
    from fmda_tpu_torch.app import Application

    mesh = object()
    seen, jax_seen = [], []
    monkeypatch.setattr(trainer_mod, "Trainer", _recording_trainer(seen))
    monkeypatch.setattr(jax_trainer_mod, "Trainer",
                        _recording_trainer(jax_seen))
    weights = dict(weight=np.ones(N_CLASSES, np.float32),
                   pos_weight=np.ones(N_CLASSES, np.float32))
    for app, got in ((Application(FrameworkConfig(), device="cpu"), seen),
                     (JaxApplication(JaxFrameworkConfig()), jax_seen)):
        with pytest.raises(_Recorded):
            app.train(mesh=mesh, **weights)
        assert got[-1]["mesh"] is mesh
    # without a mesh the port's trainer keeps the app's device
    with pytest.raises(_Recorded):
        Application(FrameworkConfig(), device="cpu").train(**weights)
    assert seen[-1]["mesh"] is None and seen[-1]["device"] == "cpu"


def test_continuous_trainer_hands_its_mesh_to_the_trainer(monkeypatch,
                                                          tmp_path):
    import fmda_tpu.train.continuous as jax_continuous
    import fmda_tpu_torch.train.continuous as continuous

    mesh = object()
    seen, jax_seen = [], []
    monkeypatch.setattr(continuous, "Trainer", _recording_trainer(seen))
    monkeypatch.setattr(jax_continuous, "Trainer",
                        _recording_trainer(jax_seen))
    x, y, fields = _data(seed=3)
    model = dict(hidden_size=HIDDEN, n_features=N_FEATURES)
    for cls, source, cfgs, got in (
            (continuous.ContinuousTrainer, ArraySource(x, y, fields),
             (ModelConfig(**model), TrainConfig()), seen),
            (jax_continuous.ContinuousTrainer,
             JaxArraySource(x, y, fields),
             (JaxModelConfig(**model), JaxTrainConfig()), jax_seen)):
        with pytest.raises(_Recorded):
            cls(source, *cfgs, checkpoint_dir=str(tmp_path), mesh=mesh,
                dp_axis="data")
        assert got[-1]["mesh"] is mesh and got[-1]["dp_axis"] == "data"
