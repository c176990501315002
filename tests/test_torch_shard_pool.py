"""The sharded ``SessionPool`` of ``fmda_tpu_torch`` on the CPU: its slots
split into equal blocks over a local mesh (one process; the device list
repeats the CPU, standing in for several devices, as ``conftest.py``'s 8
virtual CPU devices stand in for chips on the JAX side).

- against ``fmda_tpu``'s pool sharded over those 8 devices, through
  alloc/free/reuse churn, per session (the port deals its sessions round
  the blocks, so its slot numbers differ): 1e-5, every cell; the same
  ``n_slots`` padding;
- against the port's unsharded pool: 1e-6 (a block steps fewer lanes, so
  its batched products may sum in another order);
- a 1-device mesh is ``mesh=None``, bit for bit, slots included;
- ``Application.attach_fleet`` with ``runtime.shard_pool``, and
  ``serve-fleet --shard-pool``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fmda_tpu.config import MeshConfig as JaxMeshConfig
from fmda_tpu.config import ModelConfig as JaxModelConfig
from fmda_tpu.data.normalize import NormParams as JaxNormParams
from fmda_tpu.models import build_model as jax_build_model
from fmda_tpu.parallel.mesh import build_mesh as jax_build_mesh
from fmda_tpu.runtime import SessionPool as JaxSessionPool

from fmda_tpu_torch.config import MeshConfig, ModelConfig
from fmda_tpu_torch.data.normalize import NormParams
from fmda_tpu_torch.interop import params_from_flax
from fmda_tpu_torch.parallel import build_mesh
from fmda_tpu_torch.runtime import SessionPool

TOL = 1e-5
UNSHARDED_TOL = 1e-6
FEATS, HIDDEN, WINDOW, CAP = 6, 5, 4, 5
CELLS = ["gru", "lstm", "ssm"]
N_DEVICES = 8


def _setup(cell, n_layers=1):
    fields = dict(hidden_size=HIDDEN, n_features=FEATS, output_size=4,
                  dropout=0.0, bidirectional=False, cell=cell,
                  n_layers=n_layers)
    jax_cfg = JaxModelConfig(use_pallas=False, **fields)
    params = jax.device_get(jax_build_model(jax_cfg).init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, WINDOW, FEATS)))["params"])
    return jax_cfg, params, ModelConfig(**fields), params_from_flax(params)


def _norms(n, seed):
    rng = np.random.default_rng(seed)
    mins = rng.normal(size=(n, FEATS)).astype(np.float32)
    maxs = mins + rng.uniform(1.0, 5.0, size=(n, FEATS)).astype(np.float32)
    return [(mins[i], maxs[i]) for i in range(n)]


def _local_mesh(n=N_DEVICES):
    return build_mesh(MeshConfig(), devices=["cpu"] * n)


def _flush(pools, ids, rows, padding=0):
    """Step the sessions ``ids`` of every pool (plus ``padding`` padded
    lanes): each pool's probabilities of those sessions."""
    out = []
    for pool in pools:
        slots = [pool.handle_for(s).slot for s in ids]
        slots += [pool.padding_slot] * padding
        lanes = np.concatenate([rows, np.zeros((padding, FEATS), np.float32)])
        out.append(pool.step(np.asarray(slots, np.int32), lanes)[:len(ids)])
    return out


@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("cell", CELLS)
def test_sharded_pool_matches_the_jax_sharded_pool(cell, n_layers):
    """The reference's sharded-pool check (``tests/test_runtime.py``) on
    both packages: flushes of random subsets, padded lanes, a session
    freed and its slot reused."""
    jax_cfg, params, cfg, state = _setup(cell, n_layers)
    jax_pool = JaxSessionPool(jax_cfg, params, capacity=CAP, window=WINDOW,
                              mesh=jax_build_mesh(JaxMeshConfig()))
    pool = SessionPool(cfg, state, capacity=CAP, window=WINDOW,
                       device="cpu", mesh=_local_mesh())
    unsharded = SessionPool(cfg, state, capacity=CAP, window=WINDOW,
                            device="cpu")
    assert pool.n_shards == jax_pool.n_shards == N_DEVICES
    assert pool.n_slots == jax_pool.n_slots == 8  # 6 slots padded to 8
    norms = _norms(CAP, seed=12)
    for i in range(CAP):
        jax_pool.alloc(f"T{i}", JaxNormParams(*norms[i]))
        for p in (pool, unsharded):
            p.alloc(f"T{i}", NormParams(*norms[i]))
    rng = np.random.default_rng(13)
    ids = [f"T{i}" for i in range(CAP)]
    for k in range(6):
        live = list(rng.permutation(ids)[:int(rng.integers(1, CAP + 1))])
        rows = rng.normal(size=(len(live), FEATS)).astype(np.float32)
        got, want, flat = _flush([pool, jax_pool, unsharded], live, rows,
                                 padding=k % 3)
        np.testing.assert_allclose(got, want, atol=TOL, err_msg=str(k))
        np.testing.assert_allclose(got, flat, atol=UNSHARDED_TOL)
    # churn: free T0, reuse its slot for T9 from zeroed state
    for p in (pool, jax_pool, unsharded):
        h = p.handle_for("T0")
        p.free(h)
        again = p.alloc("T9", (JaxNormParams if p is jax_pool
                               else NormParams)(*norms[0]))
        assert again.slot == h.slot and again.generation == h.generation + 1
    rows = rng.normal(size=(2, FEATS)).astype(np.float32)
    got, want, flat = _flush([pool, jax_pool, unsharded], ["T9", "T3"], rows)
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_allclose(got, flat, atol=UNSHARDED_TOL)
    for s in ("T9", "T3"):
        assert pool.ticks_seen(pool.handle_for(s)) == jax_pool.ticks_seen(
            jax_pool.handle_for(s))


def test_sessions_are_dealt_round_the_blocks():
    _, _, cfg, state = _setup("ssm")
    pool = SessionPool(cfg, state, capacity=128, window=WINDOW,
                       device="cpu", mesh=_local_mesh(2))
    assert (pool.n_slots, pool.padding_slot) == (130, 128)
    slots = [pool.alloc(f"S{i}").slot for i in range(64)]
    blocks = [s // 65 for s in slots]
    assert blocks.count(0) == blocks.count(1) == 32
    assert blocks[:4] == [0, 1, 0, 1]
    with pytest.raises(ValueError, match="local mesh"):
        SessionPool(cfg, state, capacity=4, window=WINDOW,
                    mesh=build_mesh(device="cpu"))


@pytest.mark.parametrize("cell", CELLS)
def test_one_device_mesh_is_the_unsharded_pool_bit_for_bit(cell):
    _, _, cfg, state = _setup(cell)
    pools = [SessionPool(cfg, state, capacity=3, window=WINDOW,
                         device="cpu", mesh=mesh)
             for mesh in (_local_mesh(1), None)]
    assert [p.n_shards for p in pools] == [1, 1]
    assert pools[0].n_slots == pools[1].n_slots == 4
    handles = [[p.alloc(s) for s in ("a", "b")] for p in pools]
    assert [h.slot for h in handles[0]] == [h.slot for h in handles[1]]
    rng = np.random.default_rng(14)
    for _ in range(4):
        rows = rng.normal(size=(2, FEATS)).astype(np.float32)
        a, b = _flush(pools, ["a", "b"], rows, padding=1)
        np.testing.assert_array_equal(a, b)


def test_attach_fleet_shards_the_pool_and_serves_through_it():
    """``runtime.shard_pool`` through ``Application.attach_fleet``: the
    pool's mesh comes from ``[mesh]`` over the visible devices (the CPU:
    one device, so one block, as the reference documents for a
    1-device mesh) and the gateway serves through it."""
    from fmda_tpu_torch.app import Application
    from fmda_tpu_torch.config import FrameworkConfig, RuntimeConfig

    _, _, cfg, state = _setup("gru")
    app_cfg = dataclasses.replace(
        FrameworkConfig(),
        runtime=RuntimeConfig(capacity=8, window=4, bucket_sizes=(8,),
                              shard_pool=True, pipeline_depth=0))
    app = Application(app_cfg, device="cpu")
    try:
        gw = app.attach_fleet(cfg, state)
        assert gw.pool.mesh is not None and gw.pool.n_shards == 1
        assert gw.pipeline_depth == 0
        gw.open_session("a")
        gw.submit("a", np.zeros(cfg.n_features, np.float32))
        assert [r.session_id for r in gw.drain()] == ["a"]
    finally:
        app.close()
    # [mesh] asking for more devices than are visible refuses, as the
    # reference's build_mesh does
    bad = dataclasses.replace(app_cfg, mesh=MeshConfig(dp=2))
    app = Application(bad, device="cpu")
    try:
        with pytest.raises(ValueError, match="needs 2 devices"):
            app.attach_fleet(cfg, state)
    finally:
        app.close()


def test_serve_fleet_shard_pool_runs(capsys):
    from fmda_tpu_torch.__main__ import main

    assert main(["serve-fleet", "--role", "solo", "--cell", "ssm",
                 "--shard-pool", "--sessions", "4", "--ticks", "3",
                 "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["ticks_served"] == 12
