"""``fmda_tpu_torch.parallel.ring_attention`` against
``fmda_tpu.parallel.ring_attention`` on the CPU.

The port's side runs in one spawned world of 4 gloo ranks that imports
only the port (``tests/test_torch_parallel.py`` says how: one module
fixture, every case, a 180 s limit on the world).  There every fold is the
flash op's plain version, on the self-shaped (T/sp, T/sp) block; the JAX
side runs here on the virtual CPU devices.  Cases, values and gradients
(each rank's input gradients summed over the world):

- the ring, causal and not, on 1 x 4 and 2 x 2 meshes, against JAX's
  ``make_ring_attention`` with its jnp fold and against ``mha``: 1e-5;
- the ring at T/sp = 128 against JAX's ring with ``flash_interpret=True``
  (the Pallas kernels in interpret mode) and ``mha``: values 1e-5,
  gradients 5e-5 (the reference's own bound for that fold);
- ``sp_attn_apply`` (1 and 2 layers, causal, remat) at dp = 2 x sp = 2
  against JAX's ``make_attn_sp_forward`` and ``TemporalTransformer``:
  logits and the params' gradients against ``jax.grad`` of the unsharded
  model, 1e-5.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from fmda_tpu.config import MeshConfig as JaxMeshConfig
from fmda_tpu.config import ModelConfig as JaxModelConfig
from fmda_tpu.models import build_model as jax_build_model
from fmda_tpu.ops.attention import mha as jax_mha
from fmda_tpu.parallel import build_mesh as jax_build_mesh
from fmda_tpu.parallel.ring_attention import (
    make_attn_sp_forward as jax_attn_sp_forward,
)
from fmda_tpu.parallel.ring_attention import (
    make_ring_attention as jax_make_ring,
)

from fmda_tpu_torch.interop import params_from_flax
from fmda_tpu_torch.parallel import launch_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
#: gradients through T/sp = 128 folds (the reference's bound there)
FLASH_GRAD_TOL = 5e-5
WORLD = 4
WORLD_TIMEOUT = 180

#: name -> (B, N, T, D, (dp, sp), causal, JAX fold through the flash
#: kernels in interpret mode)
RING_CASES = {
    "s14": (2, 2, 16, 4, (1, 4), False, False),
    "s14c": (2, 2, 16, 4, (1, 4), True, False),
    "s22": (4, 2, 16, 4, (2, 2), False, False),
    "s22c": (4, 2, 16, 4, (2, 2), True, False),
    "f14": (1, 2, 512, 8, (1, 4), False, True),
    "f14c": (1, 2, 512, 8, (1, 4), True, True),
}
ATTN_B, ATTN_T, ATTN_F, ATTN_H = 4, 16, 6, 8
#: name -> (n_layers, causal, remat)
ATTN_CASES = {"a1": (1, False, False), "a1c": (1, True, True),
              "a2": (2, False, True)}

_WORKER = r'''
import json, sys
import numpy as np
import torch

rank, world, store, inputs, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                       sys.argv[3], sys.argv[4], sys.argv[5])
from fmda_tpu_torch.config import MeshConfig, ModelConfig
from fmda_tpu_torch.models import build_model
from fmda_tpu_torch.parallel import (
    build_mesh, initialize, make_attn_sp_forward, make_ring_attention)
from fmda_tpu_torch.parallel.collectives import wait_sends

initialize(store, world, rank, device="cpu")
import torch.distributed as dist

data = dict(np.load(inputs))
spec = json.loads(str(data.pop("spec")))
res = {}
t = torch.from_numpy


def summed(x):
    g = torch.zeros_like(x) if x.grad is None else x.grad.clone()
    dist.all_reduce(g)
    return g.numpy()


meshes = {}
for name, (b, n, steps, d, shape, causal, _) in spec["ring"].items():
    shape = tuple(shape)
    if shape not in meshes:
        meshes[shape] = build_mesh(MeshConfig(dp=shape[0], sp=shape[1]),
                                   device="cpu")
    mesh = meshes[shape]
    q, k, v = (t(data[f"{name}_{c}"]).requires_grad_() for c in "qkv")
    fn = make_ring_attention(mesh, causal=causal)
    out = fn(q, k, v)
    dp, sp = mesh.coords
    rows = slice(dp * (b // shape[0]), (dp + 1) * (b // shape[0]))
    cols = slice(sp * (steps // shape[1]), (sp + 1) * (steps // shape[1]))
    (out * t(data[f"{name}_g"])[rows, :, cols]).sum().backward()
    wait_sends()
    res[name] = out.detach().numpy()
    for c, x in zip("qkv", (q, k, v)):
        res[f"{name}_d{c}"] = summed(x)

mesh = build_mesh(MeshConfig(dp=2, sp=2), device="cpu")
dp, sp = mesh.coords
bl, tl = spec["attn_b"] // 2, spec["attn_t"] // 2
for name, (layers, causal, remat) in spec["attn"].items():
    cfg = ModelConfig(hidden_size=spec["attn_h"], n_features=spec["attn_f"],
                      output_size=4, dropout=0.0, cell="attn", n_heads=2,
                      n_layers=layers, attn_causal=causal, remat=remat)
    model = build_model(cfg)
    model.load_state_dict({k[len(name) + 1:]: t(v) for k, v in data.items()
                           if k.startswith(name + "/")})
    forward = make_attn_sp_forward(mesh, cfg, spec["attn_t"])
    rows = slice(dp * bl, (dp + 1) * bl)
    logits = forward(model, t(data["attn_x"][rows, sp * tl:(sp + 1) * tl]))
    (logits * t(data["attn_r"][rows])).sum().div(2).backward()
    wait_sends()
    res[name + "_logits"] = logits.detach().numpy()
    for pname, p in model.named_parameters():
        res[f"{name}_grad/{pname}"] = summed(p)
np.savez(f"{out_dir}/rank{rank}.npz", **res)
'''


def run_world(tmp, inputs):
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
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(0)
    f32 = np.float32
    inputs = {"spec": json.dumps({
        "ring": RING_CASES, "attn": ATTN_CASES, "attn_b": ATTN_B,
        "attn_t": ATTN_T, "attn_f": ATTN_F, "attn_h": ATTN_H})}
    for name, (b, n, t, d, *_) in RING_CASES.items():
        for c in "qkvg":
            inputs[f"{name}_{c}"] = rng.normal(size=(b, n, t, d)).astype(f32)
    inputs["attn_x"] = rng.normal(size=(ATTN_B, ATTN_T, ATTN_F)).astype(f32)
    inputs["attn_r"] = rng.normal(size=(ATTN_B, 4)).astype(f32)
    jax_models = {}
    for i, (name, (layers, causal, remat)) in enumerate(ATTN_CASES.items()):
        cfg = JaxModelConfig(hidden_size=ATTN_H, n_features=ATTN_F,
                             output_size=4, dropout=0.0, cell="attn",
                             n_heads=2, n_layers=layers, attn_causal=causal,
                             remat=remat, use_pallas=False)
        model = jax_build_model(cfg)
        params = jax.device_get(model.init(
            {"params": jax.random.PRNGKey(30 + i)},
            jnp.zeros((1, ATTN_T, ATTN_F)))["params"])
        jax_models[name] = (cfg, model, params)
        inputs.update({f"{name}/{k}": v.numpy()
                       for k, v in params_from_flax(params).items()})
    ranks = run_world(tmp_path_factory.mktemp("ring_world"), inputs)
    return dict(inputs=inputs, ranks=ranks, jax_models=jax_models)


def _block(mesh_shape, rank, b, t):
    dp, sp = mesh_shape
    d, s = divmod(rank, sp)
    return (slice(d * b // dp, (d + 1) * b // dp), slice(None),
            slice(s * t // sp, (s + 1) * t // sp))


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_matches_jax_ring_and_mha(world, name):
    b, n, t, d, shape, causal, interpret = RING_CASES[name]
    q, k, v, g = (jnp.asarray(world["inputs"][f"{name}_{c}"])
                  for c in "qkvg")
    mesh = jax_build_mesh(JaxMeshConfig(dp=shape[0], sp=shape[1]),
                          devices=jax.devices()[:WORLD])
    ring = jax_make_ring(mesh, causal=causal, use_flash=interpret,
                         flash_interpret=interpret)
    want = [ring(q, k, v)]
    _, vjp = jax.vjp(lambda *a: jax_mha(*a, causal=causal), q, k, v)
    want_grads = [vjp(g)]
    want.append(jax_mha(q, k, v, causal=causal))
    if not interpret or causal:  # the interpret-mode ring's vjp: causal
        _, ring_vjp = jax.vjp(ring, q, k, v)
        want_grads.append(ring_vjp(g))
    grad_tol = FLASH_GRAD_TOL if interpret else TOL
    for r, got in enumerate(world["ranks"]):
        blk = _block(shape, r, b, t)
        for w in want:
            np.testing.assert_allclose(got[name], np.asarray(w)[blk],
                                       atol=TOL)
        for grads in want_grads:
            for c, w in zip("qkv", grads):
                np.testing.assert_allclose(got[f"{name}_d{c}"],
                                           np.asarray(w), atol=grad_tol,
                                           err_msg=f"d{c}")


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_sp_attn_apply_matches_jax_and_the_model(world, name):
    cfg, model, params = world["jax_models"][name]
    x = jnp.asarray(world["inputs"]["attn_x"])
    r_cot = jnp.asarray(world["inputs"]["attn_r"])
    mesh = jax_build_mesh(JaxMeshConfig(dp=2, sp=2),
                          devices=jax.devices()[:WORLD])
    sp_logits = jax.jit(jax_attn_sp_forward(mesh, cfg, ATTN_T))(
        params, jax.device_put(x, NamedSharding(mesh, P("dp", "sp"))))
    expected = model.apply({"params": params}, x)
    grads = params_from_flax(jax.device_get(jax.grad(
        lambda p: jnp.sum(model.apply({"params": p}, x) * r_cot))(params)))
    for r, got in enumerate(world["ranks"]):
        rows = slice(2 * (r // 2), 2 * (r // 2) + 2)
        for want in (sp_logits, expected):
            np.testing.assert_allclose(got[name + "_logits"],
                                       np.asarray(want)[rows], atol=TOL)
        for pname, want in grads.items():
            np.testing.assert_allclose(got[f"{name}_grad/{pname}"],
                                       want.numpy(), atol=TOL,
                                       err_msg=pname)
