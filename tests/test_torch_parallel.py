"""``fmda_tpu_torch.parallel`` against ``fmda_tpu.parallel`` on the CPU.

The port's side runs in one spawned world of 4 gloo ranks (one process a
rank, ``OMP_NUM_THREADS=1``, a ``file://`` store under the module's tmp
dir) that imports only the port: the module fixture writes every case's
numpy-seeded inputs to an ``.npz``, the ranks run every case and write
their results, and the world joins under its own 180 s limit (on the
limit its ranks are killed and the fixture fails).  The JAX side runs here,
on ``conftest.py``'s 8 virtual CPU devices.  Cases:

- the collectives, values and gradients, against their definitions;
- ``sp_gru_scan`` and the pipelined scan (M = 1, 2; forward and reverse;
  sp = 4) against JAX's ``sp_gru_scan`` and ``gru_scan``, gradients
  against ``jax.vjp`` of ``gru_scan``: 1e-5;
- ``make_sp_forward`` at dp = 2 x sp = 2 (1 and 2 layers, both
  directions, M = 1 and 2): logits against JAX's ``make_sp_forward`` and
  ``BiGRU.apply``, gradients against ``jax.grad`` of the unsharded model:
  1e-5;
- 3 steps of ``make_sp_train_step`` (gru pipelined, attn with remat)
  against JAX's on the same mesh shape: 1e-4; the ranks' params the same
  bits; the step's gradient of the initial params (``make_sp_grad_fn``,
  summed over the world, before the clip) against ``jax.grad`` of the
  unsharded loss: 1e-5;
- the reference's 2-host harness (``tests/test_distributed.py``) as 2
  hosts x 2 ranks: the sp step, the attn step and a dp-only Trainer step,
  the ranks' losses bit-equal and within 1e-5 of JAX's.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from fmda_tpu.compat import shard_map
from fmda_tpu.config import MeshConfig as JaxMeshConfig
from fmda_tpu.config import ModelConfig as JaxModelConfig
from fmda_tpu.models import build_model as jax_build_model
from fmda_tpu.ops.gru import gru_scan as jax_gru_scan
from fmda_tpu.parallel import build_mesh as jax_build_mesh
from fmda_tpu.parallel import sp_gru_scan as jax_sp_gru_scan
from fmda_tpu.parallel import sp_gru_scan_pipelined as jax_sp_pipelined
from fmda_tpu.parallel.seq_parallel import make_sp_forward as jax_sp_forward
from fmda_tpu.parallel.sp_train import (
    make_sp_train_step as jax_sp_train_step,
)
from fmda_tpu.parallel.sp_train import shard_train_inputs as jax_shard_inputs

from fmda_tpu_torch.config import MeshConfig, ModelConfig
from fmda_tpu_torch.interop import params_from_flax
from fmda_tpu_torch.parallel import (
    ClippedAdam,
    batch_sharding,
    build_mesh,
    launch_world,
    make_sp_train_step,
    sequence_sharding,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
TRAIN_TOL = 1e-4
WORLD = 4
#: Each spawned world's own limit (s).
WORLD_TIMEOUT = 180
C = 4  # classes

# collectives: (B, H) values a rank
COLL = (3, 5)
# the scans: batch, time (sp = 4 blocks of 8), hidden
SCAN_B, SCAN_T, SCAN_H = 4, 32, 8
SCAN_CASES = [(m, rev) for m in (1, 2) for rev in (False, True)]
# the sp forward: batch 4 (2 dp rows of 2), time 16 (2 sp blocks of 8)
FWD_B, FWD_T, FWD_F, FWD_H = 4, 16, 6, 8
FWD_CASES = [(1, True, 1), (2, True, 1), (2, False, 1), (1, True, 2),
             (2, False, 2)]  # (n_layers, bidirectional, M)
# the train steps: batch 4, time 16
STEP_CASES = {"gru": dict(n_microbatches=2), "attn": dict(remat=True)}
STEPS = 3
# the 2-host harness: tests/test_distributed.py's shapes
HOST_B, HOST_T, HOST_F, HOST_H = 4, 8, 12, 8

_WORKER = r'''
import json, sys
import numpy as np
import torch

rank, world, store, inputs, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                       sys.argv[3], sys.argv[4], sys.argv[5])
from fmda_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from fmda_tpu_torch.data.pipeline import Batch
from fmda_tpu_torch.models import build_model
from fmda_tpu_torch.parallel import (
    ClippedAdam, all_gather, all_reduce_mean, all_reduce_sum, build_mesh,
    initialize, make_sp_forward, make_sp_grad_fn, make_sp_train_step,
    ring_shift,
    shard_train_inputs, shard_train_inputs_multihost, shift_left,
    shift_right, sp_gru_scan, sp_gru_scan_pipelined)
from fmda_tpu_torch.parallel.collectives import wait_sends
from fmda_tpu_torch.train import Trainer

initialize(store, world, rank, device="cpu")
import torch.distributed as dist

data = dict(np.load(inputs))
spec = json.loads(str(data.pop("spec")))
res = {}
t = torch.from_numpy


def params(prefix):
    return {k[len(prefix):]: t(v) for k, v in data.items()
            if k.startswith(prefix)}


def summed_grads(tensors):
    """Each tensor's gradient summed over the world (0 where a rank's
    graph did not reach it)."""
    out = []
    for x in tensors:
        g = torch.zeros_like(x) if x.grad is None else x.grad.clone()
        dist.all_reduce(g)
        out.append(g.numpy())
    return out


# -- the collectives over the sp axis of a 1 x 4 mesh
mesh = build_mesh(MeshConfig(dp=1, sp=4), device="cpu")
axis = mesh.axis("sp")
ops = {
    "sum": lambda x: all_reduce_sum(x, axis),
    "mean": lambda x: all_reduce_mean(x, axis),
    "gather": lambda x: all_gather(x, axis),
    "gather_tiled": lambda x: all_gather(x, axis, dim=1, tiled=True),
    "ring": lambda x: ring_shift(x, axis),
    "ring_back": lambda x: ring_shift(x, axis, shift=-1),
    "right": lambda x: shift_right(x, axis, fill),
    "left": lambda x: shift_left(x, axis, fill),
}
for name, op in ops.items():
    x = t(data["coll_x"][rank]).requires_grad_(True)
    fill = t(data["coll_fill"]).requires_grad_(True)
    y = op(x)
    g = t(data[f"coll_g_{name}"][rank])
    (y * g).sum().backward()
    wait_sends()
    res[f"coll_{name}"] = y.detach().numpy()
    res[f"coll_{name}_dx"] = x.grad.numpy()
    res[f"coll_{name}_dfill"] = (np.zeros_like(data["coll_fill"])
                                 if fill.grad is None else fill.grad.numpy())

# -- the scans, sp = 4
blk = data["scan_xp"].shape[1] // 4
for m, reverse in spec["scan"]:
    key = f"scan_{m}_{int(reverse)}"
    xp = t(data["scan_xp"][:, rank * blk:(rank + 1) * blk]).requires_grad_()
    h0 = t(data["scan_h0"]).requires_grad_()
    w_hh = t(data["scan_w_hh"]).requires_grad_()
    b_hh = t(data["scan_b_hh"]).requires_grad_()
    if m == 1:
        h_last, hs = sp_gru_scan(xp, h0, w_hh, b_hh, axis, reverse=reverse)
    else:
        h_last, hs = sp_gru_scan_pipelined(xp, h0, w_hh, b_hh, axis,
                                           n_microbatches=m, reverse=reverse)
    g_hs = t(data["scan_g_hs"][:, rank * blk:(rank + 1) * blk])
    # h_last is every rank's: each seeds its share
    ((hs * g_hs).sum() + (h_last * t(data["scan_g_h"])).sum() / 4).backward()
    wait_sends()
    res[key + "_h_last"] = h_last.detach().numpy()
    res[key + "_hs"] = hs.detach().numpy()
    res[key + "_dxp"] = xp.grad.numpy()
    res[key + "_dh0"], res[key + "_dw"], res[key + "_db"] = summed_grads(
        [h0, w_hh, b_hh])

# -- the sp forward, dp = 2 x sp = 2
mesh = build_mesh(MeshConfig(dp=2, sp=2), device="cpu")
d, s = mesh.coords
for layers, bidi, m in spec["fwd"]:
    key = f"fwd_{layers}_{int(bidi)}_{m}"
    cfg = ModelConfig(hidden_size=spec["fwd_h"], n_features=spec["fwd_f"],
                      output_size=4, dropout=0.0, n_layers=layers,
                      bidirectional=bidi)
    model = build_model(cfg)
    model.load_state_dict(params(key + "/"))
    forward = make_sp_forward(mesh, cfg, spec["fwd_t"], n_microbatches=m)
    rows, steps = slice(2 * d, 2 * d + 2), slice(8 * s, 8 * s + 8)
    logits = forward(model, t(data["fwd_x"][rows, steps]))
    (logits * t(data["fwd_r"][rows])).sum().div(2).backward()
    wait_sends()
    res[key + "_logits"] = logits.detach().numpy()
    for (name, p), g in zip(model.named_parameters(), summed_grads(
            list(model.parameters()))):
        res[f"{key}_grad/{name}"] = g

# -- the train steps, dp = 2 x sp = 2
for cell, kw in spec["steps"].items():
    cfg = ModelConfig(hidden_size=spec["fwd_h"], n_features=spec["fwd_f"],
                      output_size=4, dropout=0.0, cell=cell, n_heads=2,
                      remat=kw.get("remat", False))
    model = build_model(cfg)
    x, y, p = shard_train_inputs(mesh, data["step_x"], data["step_y"],
                                 params(f"step_{cell}/"))
    model.load_state_dict(p)
    opt = ClippedAdam(1e-3, 50.0)
    state = opt.init(model)
    grad_fn = make_sp_grad_fn(
        mesh, cfg, spec["fwd_t"], weight=t(data["step_w"]),
        pos_weight=t(data["step_pw"]),
        n_microbatches=kw.get("n_microbatches", 1))
    res[f"step_{cell}_loss0"] = np.array(float(grad_fn(model, x, y)))
    for name, p_ in model.named_parameters():
        res[f"step_{cell}_grad0/{name}"] = p_.grad.numpy().copy()
    step = make_sp_train_step(
        mesh, cfg, spec["fwd_t"], opt, weight=t(data["step_w"]),
        pos_weight=t(data["step_pw"]),
        n_microbatches=kw.get("n_microbatches", 1))
    res[f"step_{cell}_losses"] = np.array(
        [float(step(model, state, x, y)) for _ in range(spec["n_steps"])])
    for name, v in model.state_dict().items():
        res[f"step_{cell}_final/{name}"] = v.numpy()

# -- the 2-host harness: 2 hosts x 2 ranks
host = rank // 2
lo, hi = 2 * host, 2 * host + 2  # this host's rows of the global batch
xg, yg = data["host_x"], data["host_y"]
hmesh = build_mesh(MeshConfig(dp=2, sp=2, processes=2), device="cpu")
for cell in ("gru", "attn"):
    cfg = ModelConfig(hidden_size=8, n_features=12, output_size=4,
                      dropout=0.0, spatial_dropout=False, cell=cell,
                      n_heads=2)
    model = build_model(cfg)
    x, y, p = shard_train_inputs_multihost(hmesh, xg[lo:hi], yg[lo:hi],
                                           params(f"host_{cell}/"))
    model.load_state_dict(p)
    opt = ClippedAdam(1e-3, 50.0)
    step = make_sp_train_step(hmesh, cfg, xg.shape[1], opt,
                              weight=torch.ones(4), pos_weight=torch.ones(4))
    res[f"host_{cell}_loss"] = np.array(float(step(model, opt.init(model),
                                                   x, y)))
dp_mesh = build_mesh(MeshConfig(dp=4, sp=1, processes=2), device="cpu")
cfg = ModelConfig(hidden_size=8, n_features=12, output_size=4, dropout=0.0)
trainer = Trainer(cfg, TrainConfig(batch_size=4, window=xg.shape[1]),
                  weight=np.ones(4, np.float32),
                  pos_weight=np.ones(4, np.float32), mesh=dp_mesh)
state = trainer.init_state(params("host_gru/"))
placed = trainer.place(Batch(xg, yg, np.ones(4, np.float32)))
loss, _ = trainer.train_step(state, placed)
res["host_trainer_loss"] = np.array(float(loss))
np.savez(f"{out_dir}/rank{rank}.npz", **res)
print("done", rank)
'''


def _jax_params(cfg, seed, steps):
    model = jax_build_model(cfg)
    return model, jax.device_get(model.init(
        {"params": jax.random.PRNGKey(seed)},
        jnp.zeros((1, steps, cfg.n_features)))["params"])


def _flat(prefix, flax_params):
    return {f"{prefix}/{k}": v.numpy()
            for k, v in params_from_flax(flax_params).items()}


def run_world(tmp, worker, inputs, world=WORLD):
    """Write the inputs, run ``worker`` in a world of ``world`` gloo ranks,
    and return each rank's results."""
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "worker.py").write_text(worker)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    try:
        results = launch_world(
            lambda r: [sys.executable, str(tmp / "worker.py"), str(r),
                       str(world), f"file://{tmp}/store", str(
                           tmp / "inputs.npz"), str(tmp)],
            world, timeout=WORLD_TIMEOUT, env=env, cwd=REPO)
    except TimeoutError as e:
        pytest.fail(f"the world did not end in {WORLD_TIMEOUT} s: {e}")
    failed = [r for r in results if r.returncode != 0]
    assert not failed, "\n".join(f"rank {r.rank}:\n{r.stderr[-1500:]}"
                                  for r in failed)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case's inputs, JAX's parameters for them, and the ranks'
    results."""
    import json

    rng = np.random.default_rng(0)
    f32 = np.float32
    inputs = {"spec": json.dumps({
        "scan": SCAN_CASES, "fwd": FWD_CASES, "fwd_h": FWD_H,
        "fwd_f": FWD_F, "fwd_t": FWD_T, "steps": STEP_CASES,
        "n_steps": STEPS})}
    inputs["coll_x"] = rng.normal(size=(WORLD,) + COLL).astype(f32)
    inputs["coll_fill"] = rng.normal(size=COLL).astype(f32)
    for name, shape in (("sum", COLL), ("mean", COLL),
                        ("gather", (WORLD,) + COLL),
                        ("gather_tiled", (COLL[0], WORLD * COLL[1])),
                        ("ring", COLL), ("ring_back", COLL),
                        ("right", COLL), ("left", COLL)):
        inputs[f"coll_g_{name}"] = rng.normal(
            size=(WORLD,) + shape).astype(f32)
    inputs["scan_xp"] = rng.normal(size=(SCAN_B, SCAN_T, 3 * SCAN_H)).astype(
        f32)
    inputs["scan_h0"] = (0.3 * rng.normal(size=(SCAN_B, SCAN_H))).astype(f32)
    inputs["scan_w_hh"] = (0.3 * rng.normal(
        size=(3 * SCAN_H, SCAN_H))).astype(f32)
    inputs["scan_b_hh"] = (0.1 * rng.normal(size=(3 * SCAN_H,))).astype(f32)
    inputs["scan_g_hs"] = rng.normal(size=(SCAN_B, SCAN_T, SCAN_H)).astype(f32)
    inputs["scan_g_h"] = rng.normal(size=(SCAN_B, SCAN_H)).astype(f32)
    inputs["fwd_x"] = rng.normal(size=(FWD_B, FWD_T, FWD_F)).astype(f32)
    inputs["fwd_r"] = rng.normal(size=(FWD_B, C)).astype(f32)
    jax_fwd = {}
    for i, (layers, bidi, m) in enumerate(FWD_CASES):
        cfg = JaxModelConfig(hidden_size=FWD_H, n_features=FWD_F,
                             output_size=C, dropout=0.0, use_pallas=False,
                             n_layers=layers, bidirectional=bidi)
        model, params = _jax_params(cfg, 10 + i, FWD_T)
        key = f"fwd_{layers}_{int(bidi)}_{m}"
        jax_fwd[key] = (cfg, model, params)
        inputs.update(_flat(key, params))
    inputs["step_x"] = rng.normal(size=(FWD_B, FWD_T, FWD_F)).astype(f32)
    inputs["step_y"] = (rng.random((FWD_B, C)) < 0.4).astype(f32)
    inputs["step_w"] = rng.uniform(0.5, 2.0, C).astype(f32)
    inputs["step_pw"] = rng.uniform(0.5, 2.0, C).astype(f32)
    jax_steps = {}
    for i, cell in enumerate(STEP_CASES):
        cfg = JaxModelConfig(hidden_size=FWD_H, n_features=FWD_F,
                             output_size=C, dropout=0.0, use_pallas=False,
                             cell=cell, n_heads=2,
                             remat=STEP_CASES[cell].get("remat", False))
        _, params = _jax_params(cfg, 20 + i, FWD_T)
        jax_steps[cell] = (cfg, params)
        inputs.update(_flat(f"step_{cell}", params))
    xg = np.random.default_rng(0).normal(
        size=(HOST_B, HOST_T, HOST_F)).astype(f32)
    inputs["host_x"] = xg
    inputs["host_y"] = (xg[:, -1, :4] > 0).astype(f32)
    jax_host = {}
    for cell, seed in (("gru", 0), ("attn", 1)):
        cfg = JaxModelConfig(hidden_size=HOST_H, n_features=HOST_F,
                             output_size=C, dropout=0.0,
                             spatial_dropout=False, use_pallas=False,
                             cell=cell, n_heads=2)
        _, params = _jax_params(cfg, seed, HOST_T)
        jax_host[cell] = (cfg, params)
        inputs.update(_flat(f"host_{cell}", params))
    tmp = tmp_path_factory.mktemp("parallel_world")
    ranks = run_world(tmp, _WORKER, inputs)
    return dict(inputs=inputs, ranks=ranks, jax_fwd=jax_fwd,
                jax_steps=jax_steps, jax_host=jax_host)


# -- the mesh, in this process ----------------------------------------------


def test_a_world_of_one_process_is_the_one_by_one_mesh():
    mesh = build_mesh(device="cpu")
    assert (mesh.dp, mesh.sp, mesh.rank, mesh.coords) == (1, 1, 0, (0, 0))
    assert mesh.shape == {"dp": 1, "sp": 1}
    assert mesh.axis("sp").group is None and mesh.axis("dp").size == 1
    x = torch.arange(6.0).reshape(2, 3)
    from fmda_tpu_torch.parallel import all_gather, all_reduce_sum

    assert torch.equal(all_reduce_sum(x, mesh.axis("sp")), x)
    assert torch.equal(all_gather(x, mesh.axis("dp"))[0], x)


@pytest.mark.parametrize("cfg,match", [
    (MeshConfig(sp=2), "does not divide device count 1"),
    (MeshConfig(processes=2), "call fmda_tpu_torch.parallel.initialize"),
    (MeshConfig(dp=2), "needs 2 devices, have 1"),
])
def test_process_mesh_keeps_the_reference_checks(cfg, match):
    with pytest.raises(ValueError, match=match):
        build_mesh(cfg, device="cpu")


def test_local_mesh_shapes_match_the_reference():
    devices = ["cpu"] * 8
    for cfg, shape in ((MeshConfig(dp=-1, sp=2), (4, 2)),
                       (MeshConfig(dp=8, sp=1), (8, 1))):
        mesh = build_mesh(cfg, devices=devices)
        ref = jax_build_mesh(JaxMeshConfig(dp=cfg.dp, sp=cfg.sp))
        assert (mesh.dp, mesh.sp) == ref.devices.shape == shape
        assert mesh.axis_names == ref.axis_names and mesh.local
    with pytest.raises(ValueError, match="devices"):
        build_mesh(MeshConfig(dp=16, sp=1), devices=devices)
    with pytest.raises(ValueError, match="local mesh"):
        build_mesh(MeshConfig(), devices=devices).axis("dp")


def test_shardings_cut_the_reference_blocks():
    mesh = build_mesh(device="cpu")
    x = np.arange(24).reshape(2, 3, 4)
    assert np.array_equal(sequence_sharding(mesh).local(x), x)
    assert batch_sharding(mesh).spec == ("dp",)


# -- the world's results -----------------------------------------------------


def _ranks(world, key):
    return [r[key] for r in world["ranks"]]


@pytest.mark.parametrize("name", ["sum", "mean", "gather", "gather_tiled",
                                  "ring", "ring_back", "right", "left"])
def test_collectives_match_their_definitions(world, name):
    """Each value and each gradient (the adjoint: the cotangents summed,
    or sent the other way) against its definition."""
    x, fill = world["inputs"]["coll_x"], world["inputs"]["coll_fill"]
    g = world["inputs"][f"coll_g_{name}"]
    n = WORLD
    want, dx, dfill = [], [], [np.zeros_like(fill)] * n
    for r in range(n):
        if name in ("sum", "mean"):
            scale = 1.0 if name == "sum" else 1.0 / n
            want.append(x.sum(0) * scale)
            dx.append(g.sum(0) * scale)
        elif name == "gather":
            want.append(x)
            dx.append(g[:, r].sum(0))
        elif name == "gather_tiled":
            want.append(np.concatenate(list(x), axis=1))
            cols = slice(r * COLL[1], (r + 1) * COLL[1])
            dx.append(g[:, :, cols].sum(0))
        elif name in ("ring", "ring_back"):
            shift = 1 if name == "ring" else -1
            want.append(x[(r - shift) % n])
            dx.append(g[(r + shift) % n])
        else:
            shift = 1 if name == "right" else -1
            src, dst = r - shift, r + shift
            want.append(x[src] if 0 <= src < n else fill)
            dx.append(g[dst] if 0 <= dst < n else np.zeros_like(x[r]))
            if not 0 <= src < n:
                dfill = dfill[:r] + [g[r]] + dfill[r + 1:]
    for r in range(n):
        np.testing.assert_allclose(_ranks(world, f"coll_{name}")[r], want[r],
                                   atol=TOL)
        np.testing.assert_allclose(_ranks(world, f"coll_{name}_dx")[r],
                                   dx[r], atol=TOL)
        np.testing.assert_allclose(_ranks(world, f"coll_{name}_dfill")[r],
                                   dfill[r], atol=TOL)


@pytest.mark.parametrize("m,reverse", SCAN_CASES)
def test_sp_scans_match_jax_sp_scan_and_gru_scan(world, m, reverse):
    """The port's sp scan, sp = 4, against JAX's sp scan on 4 devices and
    the unsharded ``gru_scan``; its gradients against ``jax.vjp`` of the
    unsharded scan."""
    inp = world["inputs"]
    xp, h0, w, b = (jnp.asarray(inp[k]) for k in (
        "scan_xp", "scan_h0", "scan_w_hh", "scan_b_hh"))
    mesh = jax_build_mesh(JaxMeshConfig(dp=1, sp=4),
                          devices=jax.devices()[:4])

    @jax.jit
    @lambda f: shard_map(f, mesh=mesh, in_specs=(P(), P(None, "sp")),
                         out_specs=(P(), P(None, "sp")), check_vma=False)
    def sharded(h0_, xp_local):
        if m == 1:
            return jax_sp_gru_scan(xp_local, h0_, w, b, "sp",
                                   reverse=reverse)
        return jax_sp_pipelined(xp_local, h0_, w, b, "sp",
                                n_microbatches=m, reverse=reverse)

    jh, jhs = sharded(h0, jax.device_put(xp, NamedSharding(
        mesh, P(None, "sp"))))
    (h_ref, hs_ref), vjp = jax.vjp(
        lambda xp_, h0_, w_, b_: jax_gru_scan(xp_, h0_, w_, b_,
                                              reverse=reverse),
        xp, h0, w, b)
    dxp, dh0, dw, db = vjp((jnp.asarray(inp["scan_g_h"]),
                            jnp.asarray(inp["scan_g_hs"])))
    key = f"scan_{m}_{int(reverse)}"
    blk = SCAN_T // WORLD
    for r in range(WORLD):
        cols = slice(r * blk, (r + 1) * blk)
        for want in (jh, h_ref):
            np.testing.assert_allclose(_ranks(world, key + "_h_last")[r],
                                       np.asarray(want), atol=TOL)
        for want in (jhs, hs_ref):
            np.testing.assert_allclose(_ranks(world, key + "_hs")[r],
                                       np.asarray(want)[:, cols], atol=TOL)
        np.testing.assert_allclose(_ranks(world, key + "_dxp")[r],
                                   np.asarray(dxp)[:, cols], atol=TOL)
        for name, want in (("_dh0", dh0), ("_dw", dw), ("_db", db)):
            np.testing.assert_allclose(_ranks(world, key + name)[r],
                                       np.asarray(want), atol=TOL)


@pytest.mark.parametrize("layers,bidi,m", FWD_CASES)
def test_sp_forward_and_gradients_match_jax(world, layers, bidi, m):
    """Logits against JAX's ``make_sp_forward`` on a 2 x 2 mesh and
    ``BiGRU.apply``; each rank's summed gradients against ``jax.grad`` of
    the unsharded model."""
    key = f"fwd_{layers}_{int(bidi)}_{m}"
    cfg, model, params = world["jax_fwd"][key]
    x = jnp.asarray(world["inputs"]["fwd_x"])
    r_cot = jnp.asarray(world["inputs"]["fwd_r"])
    expected = model.apply({"params": params}, x)
    mesh = jax_build_mesh(JaxMeshConfig(dp=2, sp=2),
                          devices=jax.devices()[:4])
    sp_logits = jax.jit(jax_sp_forward(mesh, cfg, FWD_T, n_microbatches=m))(
        params, jax.device_put(x, NamedSharding(mesh, P("dp", "sp"))))
    grads = jax.grad(lambda p: jnp.sum(model.apply({"params": p}, x)
                                       * r_cot))(params)
    want_grads = {k: v.numpy() for k, v in params_from_flax(
        jax.device_get(grads)).items()}
    for r in range(WORLD):
        rows = slice(2 * (r // 2), 2 * (r // 2) + 2)
        for want in (expected, sp_logits):
            np.testing.assert_allclose(_ranks(world, key + "_logits")[r],
                                       np.asarray(want)[rows], atol=TOL)
        for name, want in want_grads.items():
            np.testing.assert_allclose(
                _ranks(world, f"{key}_grad/{name}")[r], want, atol=TOL,
                err_msg=name)


@pytest.mark.parametrize("cell", list(STEP_CASES))
def test_sp_train_steps_match_jax(world, cell):
    """3 steps of the port's sp step against JAX's ``make_sp_train_step``
    on a 2 x 2 mesh from the same params: losses and final params within
    1e-4; every rank's params the same bits."""
    cfg, params = world["jax_steps"][cell]
    inp = world["inputs"]
    mesh = jax_build_mesh(JaxMeshConfig(dp=2, sp=2),
                          devices=jax.devices()[:4])
    optimizer = optax.chain(optax.clip_by_global_norm(50.0),
                            optax.adam(1e-3))
    step = jax_sp_train_step(
        mesh, cfg, FWD_T, optimizer, weight=jnp.asarray(inp["step_w"]),
        pos_weight=jnp.asarray(inp["step_pw"]),
        n_microbatches=STEP_CASES[cell].get("n_microbatches", 1))
    x, y, p, o = jax_shard_inputs(mesh, inp["step_x"], inp["step_y"],
                                  params, optimizer.init(params))
    losses = []
    for _ in range(STEPS):
        p, o, loss = step(p, o, x, y)
        losses.append(float(loss))
    final = {k: v.numpy() for k, v in params_from_flax(
        jax.device_get(p)).items()}
    ranks = world["ranks"]
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r][f"step_{cell}_losses"], losses,
                                   atol=TRAIN_TOL)
    for name, want in final.items():
        got = [ranks[r][f"step_{cell}_final/{name}"] for r in range(WORLD)]
        assert all(np.array_equal(got[0], g) for g in got[1:]), name
        if name.endswith("qkv.bias"):
            # the key bias: a null direction of the softmax, so Adam steps
            # on rounding noise (tests/test_torch_train.py); within the
            # drift Adam allows, the query and value biases compared
            h = FWD_H
            for b_k in (got[0][h:2 * h], want[h:2 * h]):
                assert np.abs(b_k).max() <= STEPS * 1e-3, name
            got[0], want = (np.concatenate([a[:h], a[2 * h:]])
                            for a in (got[0], want))
        np.testing.assert_allclose(got[0], want, atol=TRAIN_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("cell", list(STEP_CASES))
def test_sp_train_step_gradient_matches_jax_grad(world, cell):
    """The sp step's gradient of the initial params on a 2 x 2 mesh
    (``make_sp_grad_fn``: the step's forward and backward, summed over the
    world, before the clip) against ``jax.grad`` of the unsharded loss,
    1e-5, and its loss against the unsharded loss: a gradient counted sp
    times, or divided by sp once too often, fails here, where Adam's
    update would hide it from the steps' test."""
    from fmda_tpu.train.losses import weighted_bce_with_logits

    cfg, params = world["jax_steps"][cell]
    inp = world["inputs"]
    model = jax_build_model(cfg)

    def loss_fn(p):
        return weighted_bce_with_logits(
            model.apply({"params": p}, jnp.asarray(inp["step_x"])),
            jnp.asarray(inp["step_y"]), weight=jnp.asarray(inp["step_w"]),
            pos_weight=jnp.asarray(inp["step_pw"]))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    want = {k: v.numpy() for k, v in params_from_flax(
        jax.device_get(grads)).items()}
    for r in range(WORLD):
        got = world["ranks"][r]
        np.testing.assert_allclose(float(got[f"step_{cell}_loss0"]),
                                   float(loss), atol=TOL)
        for name, w in want.items():
            np.testing.assert_allclose(got[f"step_{cell}_grad0/{name}"], w,
                                       atol=TOL, err_msg=name)


def test_two_hosts_of_two_ranks_agree_bit_for_bit(world):
    """The reference's 2-process harness, as 2 hosts x 2 ranks: the sp
    step and the ring-attention step over dp = 2 x sp = 2 (dp across the
    hosts), and a dp-only Trainer step over dp = 4: every rank's loss the
    same bits, and each within 1e-5 of JAX's on 4 devices."""
    ranks, inp = world["ranks"], world["inputs"]
    for key in ("host_gru_loss", "host_attn_loss", "host_trainer_loss"):
        losses = [float(r[key]) for r in ranks]
        assert len(set(losses)) == 1 and np.isfinite(losses[0]), key
    mesh = jax_build_mesh(JaxMeshConfig(dp=2, sp=2),
                          devices=jax.devices()[:4])
    optimizer = optax.chain(optax.clip_by_global_norm(50.0),
                            optax.adam(1e-3))
    for cell in ("gru", "attn"):
        cfg, params = world["jax_host"][cell]
        step = jax_sp_train_step(mesh, cfg, HOST_T, optimizer,
                                 weight=jnp.ones(4), pos_weight=jnp.ones(4))
        x, y, p, o = jax_shard_inputs(mesh, inp["host_x"], inp["host_y"],
                                      params, optimizer.init(params))
        _, _, loss = step(p, o, x, y)
        np.testing.assert_allclose(float(ranks[0][f"host_{cell}_loss"]),
                                   float(loss), atol=TOL)
    # the dp Trainer's first step: the plain loss of the initial params
    from fmda_tpu.train.losses import weighted_bce_with_logits

    cfg, params = world["jax_host"]["gru"]
    logits = jax_build_model(cfg).apply({"params": params},
                                        jnp.asarray(inp["host_x"]))
    want = weighted_bce_with_logits(logits, jnp.asarray(inp["host_y"]),
                                    weight=jnp.ones(4),
                                    pos_weight=jnp.ones(4))
    np.testing.assert_allclose(float(ranks[0]["host_trainer_loss"]),
                               float(want), atol=TOL)


def test_sp_train_step_refusals_and_dropout_warning(caplog):
    mesh = build_mesh(device="cpu")
    opt = ClippedAdam()
    with pytest.raises(ValueError, match="cell='gru'"):
        make_sp_train_step(mesh, ModelConfig(cell="lstm", n_features=4), 8,
                           opt)
    with pytest.raises(ValueError, match="no pipeline bubble"):
        make_sp_train_step(mesh, ModelConfig(cell="attn", n_features=4,
                                             dropout=0.0), 8, opt,
                           n_microbatches=2)
    with caplog.at_level("WARNING", logger="fmda_tpu_torch.parallel"):
        make_sp_train_step(mesh, ModelConfig(n_features=4, dropout=0.5), 8,
                           opt)
    assert "dropout=0.50 is ignored" in caplog.text
