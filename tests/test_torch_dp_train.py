"""Data-parallel training in ``fmda_tpu_torch``: ``Trainer(mesh=)`` and
the dp path of ``fit_multi``, against ``fmda_tpu``'s dp Trainer and the
port's own single process, on the CPU.

The port's side runs in one spawned world of 2 gloo ranks that imports
only the port (``tests/test_torch_parallel.py`` says how: one module
fixture, every case, a 180 s limit on the world), dp = 2, every rank
walking the same global batches and taking its rows of each.  The JAX dp
Trainer runs here over 2 of the virtual CPU devices, the port's single
process here too, all from the JAX trainer's initial params at dropout 0.
Cases (two epochs each; per-epoch train and val metrics and the final
params within 1e-4, every rank's params the same bits):

- ``Trainer.fit`` for gru and lstm, chunks whose last batch is padded and
  masked (so the two ranks' masks differ and the masked mean's global
  normalizer matters);
- ``Trainer.fit_multi``, chunk-interleaved and mixed (4 windows of each of
  3 tickers a step).
"""

import json
import os
import sys

import jax
import numpy as np
import pytest

from fmda_tpu.config import MeshConfig as JaxMeshConfig
from fmda_tpu.config import ModelConfig as JaxModelConfig
from fmda_tpu.config import TrainConfig as JaxTrainConfig
from fmda_tpu.data.source import ArraySource as JaxArraySource
from fmda_tpu.parallel import build_mesh as jax_build_mesh
from fmda_tpu.train import Trainer as JaxTrainer

from fmda_tpu_torch.config import ModelConfig, TrainConfig
from fmda_tpu_torch.data import ArraySource
from fmda_tpu_torch.interop import params_from_flax
from fmda_tpu_torch.parallel import launch_world
from fmda_tpu_torch.train import Trainer, imbalance_weights_from_source

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_TOL = 1e-4
WORLD = 2
WORLD_TIMEOUT = 180
N_ROWS, N_FEATURES, N_CLASSES = 150, 6, 4
TICKERS = 3
HIDDEN, WINDOW, CHUNK, BATCH, PER_TICKER = 8, 4, 40, 16, 4
#: name -> (cell, "fit" or "multi", mixed windows a ticker or None)
CASES = {"fit_gru": ("gru", "fit", None), "fit_lstm": ("lstm", "fit", None),
         "multi_gru": ("gru", "multi", None),
         "multi_mixed": ("gru", "multi", PER_TICKER)}

_WORKER = r'''
import json, sys
import numpy as np
import torch

rank, world, store, inputs, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                       sys.argv[3], sys.argv[4], sys.argv[5])
from fmda_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from fmda_tpu_torch.data import ArraySource
from fmda_tpu_torch.parallel import build_mesh, initialize
from fmda_tpu_torch.train import Trainer

initialize(store, world, rank, device="cpu")
data = dict(np.load(inputs))
spec = json.loads(str(data.pop("spec")))
mesh = build_mesh(MeshConfig(dp=2, sp=1), device="cpu")
fields = [f"f{i}" for i in range(data["x"].shape[-1])]
res = {}
for name, (cell, kind, per_ticker) in spec["cases"].items():
    init = {k[len(name) + 1:]: torch.from_numpy(v)
            for k, v in data.items() if k.startswith(name + "/")}
    trainer = Trainer(ModelConfig(**spec["model"], cell=cell),
                      TrainConfig(**spec["train"]), weight=data["w"],
                      pos_weight=data["pw"], mesh=mesh)
    if kind == "fit":
        state, hist, _ = trainer.fit(
            ArraySource(data["x"], data["y"], fields),
            initial_state=trainer.init_state(init))
    else:
        fresh = trainer.init_state
        trainer.init_state = lambda: fresh(init)
        state, hist, _ = trainer.fit_multi(
            {f"TK{t}": ArraySource(data["tx"][t], data["ty"][t], fields)
             for t in range(data["tx"].shape[0])},
            mixed_batch_per_ticker=per_ticker)
    res[name + "_steps"] = np.array(state.step)
    for split in ("train", "val"):
        res[f"{name}_{split}"] = np.array(
            [[m.loss, m.accuracy, m.hamming, *m.fbeta] for m in hist[split]])
    for k, v in state.model.state_dict().items():
        res[f"{name}_final/{k}"] = v.numpy()
res["dropout_seed"] = np.array(trainer.init_state().generator.initial_seed())
np.savez(f"{out_dir}/rank{rank}.npz", **res)
'''


def _configs():
    return (dict(hidden_size=HIDDEN, n_features=N_FEATURES, dropout=0.0),
            dict(batch_size=BATCH, window=WINDOW, chunk_size=CHUNK,
                 epochs=2))


def _data():
    r = np.random.default_rng(0)
    x = r.normal(size=(N_ROWS, N_FEATURES)).astype(np.float32)
    y = (r.random((N_ROWS, N_CLASSES)) < 0.3).astype(np.float32)
    tx = np.stack([(10.0 ** t) * r.normal(size=(N_ROWS, N_FEATURES))
                   for t in range(TICKERS)]).astype(np.float32)
    ty = (r.random((TICKERS, N_ROWS, N_CLASSES)) < 0.3).astype(np.float32)
    return x, y, tx, ty


def _metrics(hist, split):
    return np.array([[m.loss, m.accuracy, m.hamming, *m.fbeta]
                     for m in hist[split]])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    x, y, tx, ty = _data()
    fields = [f"f{i}" for i in range(N_FEATURES)]
    weight, pos_weight = imbalance_weights_from_source(
        ArraySource(x, y, fields))
    model, tc = _configs()
    inputs = {"spec": json.dumps({"cases": CASES, "model": model,
                                  "train": tc}),
              "x": x, "y": y, "tx": tx, "ty": ty, "w": weight,
              "pw": pos_weight}
    mesh = jax_build_mesh(JaxMeshConfig(dp=2, sp=1),
                          devices=jax.devices()[:2])
    want = {}
    for name, (cell, kind, per_ticker) in CASES.items():
        jcfg = JaxModelConfig(**model, cell=cell, use_pallas=False)
        jax_trainer = JaxTrainer(jcfg, JaxTrainConfig(**tc), weight=weight,
                                 pos_weight=pos_weight, mesh=mesh)
        # fit's own initial params: PRNGKey(seed) split into (init, step)
        init_rng, _ = jax.random.split(jax.random.PRNGKey(0))
        init = params_from_flax(
            jax.device_get(jax_trainer.init_state(init_rng).params))
        inputs.update({f"{name}/{k}": v.numpy() for k, v in init.items()})
        single = Trainer(ModelConfig(**model, cell=cell), TrainConfig(**tc),
                         weight=weight, pos_weight=pos_weight, device="cpu")
        if kind == "fit":
            jstate, jhist, _ = jax_trainer.fit(JaxArraySource(x, y, fields))
            sstate, shist, _ = single.fit(
                ArraySource(x, y, fields),
                initial_state=single.init_state(init))
        else:
            jstate, jhist, _ = jax_trainer.fit_multi(
                {f"TK{t}": JaxArraySource(tx[t], ty[t], fields)
                 for t in range(TICKERS)},
                mixed_batch_per_ticker=per_ticker)
            fresh = single.init_state
            single.init_state = lambda fresh=fresh, init=init: fresh(init)
            sstate, shist, _ = single.fit_multi(
                {f"TK{t}": ArraySource(tx[t], ty[t], fields)
                 for t in range(TICKERS)},
                mixed_batch_per_ticker=per_ticker)
        want[name] = dict(
            steps=int(jstate.step),
            jax=(jhist, {k: v.numpy() for k, v in params_from_flax(
                jax.device_get(jstate.params)).items()}),
            single=(shist, {k: v.numpy()
                            for k, v in sstate.model.state_dict().items()}))
    tmp = tmp_path_factory.mktemp("dp_world")
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "worker.py").write_text(_WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    try:
        results = launch_world(
            lambda r: [sys.executable, str(tmp / "worker.py"), str(r),
                       str(WORLD), f"file://{tmp}/store",
                       str(tmp / "inputs.npz"), str(tmp)],
            WORLD, timeout=WORLD_TIMEOUT, env=env, cwd=REPO)
    except TimeoutError as e:
        pytest.fail(f"the world did not end in {WORLD_TIMEOUT} s: {e}")
    failed = [r for r in results if r.returncode != 0]
    assert not failed, "\n".join(f"rank {r.rank}:\n{r.stderr[-1500:]}"
                                  for r in failed)
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return dict(ranks=ranks, want=want)


@pytest.mark.parametrize("name", list(CASES))
def test_dp_training_matches_jax_dp_and_the_single_process(world, name):
    ranks, want = world["ranks"], world["want"][name]
    for r in ranks:
        assert int(r[name + "_steps"]) == want["steps"] > 0
    for hist, final in (want["jax"], want["single"]):
        for split in ("train", "val"):
            for r in ranks:
                np.testing.assert_allclose(r[f"{name}_{split}"],
                                           _metrics(hist, split),
                                           atol=TRAIN_TOL, err_msg=split)
        for k, w in final.items():
            got = [r[f"{name}_final/{k}"] for r in ranks]
            assert all(np.array_equal(got[0], g) for g in got[1:]), k
            np.testing.assert_allclose(got[0], w, atol=TRAIN_TOL,
                                       err_msg=k)


def test_each_rank_draws_its_own_dropout_stream(world):
    """Every rank walks the same batches but draws its own rows' dropout
    masks: its stream is seeded ``train.seed + 1 + dp index``."""
    seed = TrainConfig().seed
    assert [int(r["dropout_seed"]) for r in world["ranks"]] == [
        seed + 1 + r for r in range(WORLD)]


def test_a_one_rank_mesh_is_the_meshless_step_bit_for_bit():
    """dp = 1: the mesh's Trainer takes the meshless path, the same bits."""
    from fmda_tpu_torch.parallel import build_mesh

    x, y, _, _ = _data()
    fields = [f"f{i}" for i in range(N_FEATURES)]
    model, tc = _configs()
    tc["epochs"] = 1
    runs = []
    for mesh in (None, build_mesh(device="cpu")):
        trainer = Trainer(ModelConfig(**model), TrainConfig(**tc),
                          device="cpu", mesh=mesh)
        state, hist, _ = trainer.fit(ArraySource(x, y, fields))
        runs.append((hist["train"][0].loss, state.model.state_dict()))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert np.array_equal(v.numpy(), runs[1][1][k].numpy()), k


def test_trainer_refuses_a_local_mesh():
    from fmda_tpu_torch.config import MeshConfig
    from fmda_tpu_torch.parallel import build_mesh

    model, tc = _configs()
    with pytest.raises(ValueError, match="mesh of ranks"):
        Trainer(ModelConfig(**model), TrainConfig(**tc),
                mesh=build_mesh(MeshConfig(dp=2), devices=["cpu", "cpu"]))
