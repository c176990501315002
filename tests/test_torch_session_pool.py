"""fmda_tpu_torch's SessionPool, on the CPU: slot lifecycle, generation
guards, export/import and weight swaps, and its probabilities against
``fmda_tpu.runtime.SessionPool``'s (weights cross-loaded from flax, per-slot
norms, flushes that mix live and padded lanes at two bucket sizes) to 1e-5,
and against the port's own solo core to 1e-6 (float32; a batched product
sums in another order than a single row's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmda_tpu.config import ModelConfig as JaxModelConfig
from fmda_tpu.data.normalize import NormParams as JaxNormParams
from fmda_tpu.models import build_model as jax_build_model
from fmda_tpu.runtime import SessionPool as JaxSessionPool

from fmda_tpu_torch.config import ModelConfig, RuntimeConfig
from fmda_tpu_torch.data.normalize import NormParams
from fmda_tpu_torch.interop import params_from_flax
from fmda_tpu_torch.runtime import (
    PoolExhausted,
    SessionPool,
    StaleSessionError,
)
from fmda_tpu_torch.serve import StreamingBiGRU

TOL = 1e-5
SOLO_TOL = 1e-6
#: bfloat16 compute against the JAX package's: the two frameworks round
#: the bf16 arithmetic at other places
BF16_TOL = 2e-2
FEATS, HIDDEN, WINDOW = 6, 5, 4
CELLS = ["gru", "lstm", "ssm"]


def _setup(cell="gru", *, n_layers=1, seed=0):
    fields = dict(hidden_size=HIDDEN, n_features=FEATS, output_size=4,
                  dropout=0.0, bidirectional=False, cell=cell,
                  n_layers=n_layers)
    jax_cfg = JaxModelConfig(use_pallas=False, **fields)
    params = jax.device_get(jax_build_model(jax_cfg).init(
        {"params": jax.random.PRNGKey(seed)},
        jnp.zeros((1, WINDOW, FEATS)))["params"])
    return jax_cfg, params, ModelConfig(**fields), params_from_flax(params)


def _norms(n, seed=0):
    rng = np.random.default_rng(seed)
    mins = rng.normal(size=(n, FEATS)).astype(np.float32)
    maxs = mins + rng.uniform(1.0, 5.0, size=(n, FEATS)).astype(np.float32)
    return [(mins[i], maxs[i]) for i in range(n)]


def _pool(cell="gru", capacity=3, **kw):
    _, _, cfg, state = _setup(cell, **kw)
    return SessionPool(cfg, state, capacity=capacity, window=WINDOW,
                       device="cpu"), cfg, state


def test_runtime_config_defaults_match_the_jax_package():
    from fmda_tpu.config import RuntimeConfig as JaxRuntimeConfig

    ours, theirs = RuntimeConfig(), JaxRuntimeConfig()
    assert (ours.capacity, ours.window, ours.bucket_sizes) == (
        theirs.capacity, theirs.window, theirs.bucket_sizes) == (
        128, 30, (8, 32, 64, 128))


def test_pool_alloc_free_reuse_with_generation_guard():
    pool, _, _ = _pool(capacity=2)
    a = pool.alloc("a")
    b = pool.alloc("b")
    assert pool.n_active == 2 and pool.n_free == 0
    assert pool.active_mask.sum() == 2
    assert sorted(pool.session_ids()) == ["a", "b"]
    with pytest.raises(PoolExhausted):
        pool.alloc("c")
    pool.free(a)
    assert pool.n_active == 1 and pool.n_free == 1
    assert not pool.is_live(a)
    with pytest.raises(StaleSessionError):
        pool.ticks_seen(a)
    c = pool.alloc("c")
    assert c.slot == a.slot
    assert c.generation == a.generation + 1
    assert pool.is_live(c) and not pool.is_live(a)
    assert pool.handle_for("c") == c and pool.handle_for("a") is None
    with pytest.raises(StaleSessionError, match="re-allocated"):
        pool.free(a)
    with pytest.raises(ValueError, match="already allocated"):
        pool.alloc("b")
    pool.free(b)
    pool.free(c)
    assert pool.n_active == 0 and pool.n_free == 2


@pytest.mark.parametrize("cell", CELLS)
def test_reused_slot_carries_no_stale_state(cell):
    """A freed-and-reused slot serves its new session from zeroed state,
    bit for bit what a fresh pool serves."""
    pool, cfg, state = _pool(cell, capacity=1)
    fresh = SessionPool(cfg, state, capacity=1, window=WINDOW, device="cpu")
    rows = np.random.default_rng(2).normal(size=(5, FEATS)).astype(np.float32)
    norm = NormParams(*_norms(1)[0])
    a = pool.alloc("a", norm)
    for k in range(3):
        pool.step([a.slot], rows[k][None])
    assert pool.ticks_seen(a) == 3
    pool.free(a)
    b = pool.alloc("b", norm)
    f = fresh.alloc("f", norm)
    for k in range(5):
        np.testing.assert_array_equal(pool.step([b.slot], rows[k][None]),
                                      fresh.step([f.slot], rows[k][None]))
    assert pool.ticks_seen(b) == 5
    pool.reset(b)
    assert pool.ticks_seen(b) == 0


def test_pool_rejects_bidirectional_and_bad_capacity():
    _, _, cfg, state = _setup()
    import dataclasses

    with pytest.raises(ValueError, match="Predictor"):
        SessionPool(dataclasses.replace(cfg, bidirectional=True), state,
                    capacity=2, window=WINDOW, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        SessionPool(cfg, state, capacity=0, window=WINDOW, device="cpu")


def test_step_refuses_slots_outside_the_pool():
    pool, _, _ = _pool(capacity=2)
    rows = np.zeros((1, FEATS), np.float32)
    for bad in ([3], [-1], []):
        with pytest.raises(IndexError):
            pool.step(bad, rows[:len(bad)])


@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("cell", CELLS)
def test_pool_matches_jax_pool_with_padded_buckets(cell, n_layers):
    jax_cfg, params, cfg, state = _setup(cell, n_layers=n_layers)
    n = 5
    jax_pool = JaxSessionPool(jax_cfg, params, capacity=n, window=WINDOW)
    pool = SessionPool(cfg, state, capacity=n, window=WINDOW, device="cpu")
    norms = _norms(n, seed=5)
    jh = [jax_pool.alloc(f"T{i}", JaxNormParams(*norms[i])) for i in range(n)]
    th = [pool.alloc(f"T{i}", NormParams(*norms[i])) for i in range(n)]
    assert [h.slot for h in jh] == [h.slot for h in th]
    rng = np.random.default_rng(6)
    for k in range(8):
        live = np.flatnonzero(rng.random(n) < 0.7)
        bucket = 2 if len(live) <= 2 else 8
        slots = np.full(bucket, pool.padding_slot, np.int32)
        slots[:len(live)] = [th[i].slot for i in live]
        rows = rng.normal(size=(bucket, FEATS)).astype(np.float32)
        got = pool.step(slots, rows)
        want = jax_pool.step(slots, rows)
        assert got.shape == (bucket, 4)
        np.testing.assert_allclose(got[:len(live)], want[:len(live)],
                                   atol=TOL, err_msg=f"flush {k}")
    for a, b in zip(th, jh):
        assert pool.ticks_seen(a) == jax_pool.ticks_seen(b)


@pytest.mark.parametrize("cell", CELLS)
def test_pool_matches_jax_pool_in_bf16(cell):
    """40 flushes of a full-width (H = 32, F = 108, window 30) bfloat16
    pool, live and padded lanes mixed: the probabilities within 2e-2 of
    the JAX pool's."""
    fields = dict(hidden_size=32, n_features=108, output_size=4,
                  dropout=0.0, bidirectional=False, cell=cell,
                  dtype="bfloat16")
    jax_cfg = JaxModelConfig(use_pallas=False, **fields)
    params = jax.device_get(jax_build_model(jax_cfg).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 30, 108)))["params"])
    n = 4
    jax_pool = JaxSessionPool(jax_cfg, params, capacity=n, window=30)
    pool = SessionPool(ModelConfig(**fields), params_from_flax(params),
                       capacity=n, window=30, device="cpu")
    rng = np.random.default_rng(3)
    for i in range(n):
        lo = rng.normal(size=108).astype(np.float32)
        hi = lo + rng.uniform(1.0, 5.0, size=108).astype(np.float32)
        jax_pool.alloc(f"T{i}", JaxNormParams(lo, hi))
        pool.alloc(f"T{i}", NormParams(lo, hi))
    for k in range(40):
        live = np.flatnonzero(rng.random(n) < 0.75)
        slots = np.full(8, pool.padding_slot, np.int32)
        slots[:len(live)] = live
        rows = (3.0 * rng.normal(size=(8, 108))).astype(np.float32)
        got = pool.step(slots, rows)
        want = np.asarray(jax_pool.step(slots, rows), np.float32)
        np.testing.assert_allclose(got[:len(live)], want[:len(live)],
                                   atol=BF16_TOL, rtol=0,
                                   err_msg=f"flush {k}")


@pytest.mark.parametrize("cell", CELLS)
def test_pool_matches_solo_cores(cell):
    pool, cfg, state = _pool(cell, capacity=4)
    norms = _norms(4, seed=7)
    handles = [pool.alloc(f"s{i}", NormParams(*norms[i])) for i in range(4)]
    solos = [StreamingBiGRU(cfg, state, NormParams(*norms[i]), window=WINDOW,
                            device="cpu") for i in range(4)]
    rng = np.random.default_rng(8)
    for _ in range(9):
        live = np.flatnonzero(rng.random(4) < 0.75)
        if not len(live):
            continue
        slots = [handles[i].slot for i in live] + [pool.padding_slot] * 2
        rows = rng.normal(size=(len(slots), FEATS)).astype(np.float32)
        got = pool.step(slots, rows)
        for lane, i in enumerate(live):
            np.testing.assert_allclose(got[lane], solos[i].step(rows[lane])[0],
                                       atol=SOLO_TOL)


@pytest.mark.parametrize("cell", CELLS)
def test_export_import_is_bit_exact(cell):
    pool, cfg, state = _pool(cell, capacity=3, n_layers=2)
    other = SessionPool(cfg, state, capacity=2, window=WINDOW, device="cpu")
    rng = np.random.default_rng(9)
    a = pool.alloc("a", NormParams(*_norms(1, seed=9)[0]))
    pool.alloc("pad")  # the moved session need not sit at the same slot
    for _ in range(6):
        pool.step([a.slot], rng.normal(size=(1, FEATS)).astype(np.float32))
    snap = pool.export_slot(a)
    assert snap["pos"] == 6 and len(snap["carry"]) == 2
    assert snap["ring"].shape == ((WINDOW if cell != "ssm" else 0), HIDDEN)
    other.alloc("first")
    b = other.alloc("a")
    assert b.slot != a.slot
    other.import_slot(b, snap)
    assert other.ticks_seen(b) == 6
    for x, y in zip(pool.slot_norm(a), other.slot_norm(b)):
        np.testing.assert_array_equal(x, y)
    for _ in range(10):
        row = rng.normal(size=(1, FEATS)).astype(np.float32)
        np.testing.assert_array_equal(pool.step([a.slot], row),
                                      other.step([b.slot], row))
    with pytest.raises(ValueError, match="carry layers"):
        other.import_slot(b, dict(snap, carry=snap["carry"][:1]))


def test_swap_weights_serves_the_new_weights_and_refuses_misfits():
    pool, cfg, state = _pool("ssm", capacity=2)
    _, _, _, state2 = _setup("ssm", seed=1)
    a = pool.alloc("a")
    row = np.ones((1, FEATS), np.float32)
    pool.step([a.slot], row)
    before = pool.export_slot(a)
    bad_shape = dict(state2, d_l0=torch.zeros(HIDDEN + 1))
    bad_names = {k: v for k, v in state2.items() if k != "d_l0"}
    bad_dtype = dict(state2, d_l0=torch.zeros(HIDDEN, dtype=torch.int64))
    for bad, match in ((bad_shape, "d_l0"), (bad_names, "names"),
                       (bad_dtype, "floating")):
        with pytest.raises(ValueError, match=match):
            pool.swap_weights(bad)
    pool.swap_weights(state2)
    after = pool.export_slot(a)  # sessions untouched by the swap
    for x, y in zip(before["carry"][0], after["carry"][0]):
        assert torch.equal(x, y)
    got = pool.step([a.slot], row)
    # the same state in a pool built with the new weights serves the same
    other = SessionPool(cfg, state2, capacity=1, window=WINDOW, device="cpu")
    h = other.alloc("x")
    other.import_slot(h, before)
    np.testing.assert_array_equal(got, other.step([h.slot], row))
    assert pool.live_tree()[0]["d_l0"].dtype == torch.float32
