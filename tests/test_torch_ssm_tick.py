"""fmda_tpu_torch's fused SSM serve tick, on the CPU.

``ssm_serve_tick_reference`` (what the CUDA kernel's wrapper runs on CPU
tensors, and what ``chip_smoke.py`` holds the kernel to on the card) is the
whole tick of a pool flush: norms gathered and applied, every layer's
projection and step, the EMA head and its sigmoid, the state scattered in
place.  Here it runs the same numpy-seeded rows as the JAX package's
``SessionPool`` step for ``cell="ssm"`` (1 and 2 layers, per-slot norms,
padded buckets whose padding slot repeats) and as its solo streaming core
over several ticks, weights cross-loaded from flax.  Then the weight
packing, the in-place state and positions, and the launch path's refusals
(which run before the library is built, so they are reached here by
stubbing the wrapper's device test).

Tolerances: 1e-5 in float32 (other summation orders through two
frameworks); 2e-2 in bfloat16, where the two round at other places.
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
from fmda_tpu.serve.streaming import StreamingBiGRU as JaxStreamingBiGRU

from fmda_tpu_torch.config import ModelConfig
from fmda_tpu_torch.data.normalize import NormParams
from fmda_tpu_torch.interop import params_from_flax
from fmda_tpu_torch.ops import ssm_kernel
from fmda_tpu_torch.ops.ssm_kernel import (
    pack_tick_weights,
    ssm_serve_tick,
    ssm_serve_tick_reference,
)
from fmda_tpu_torch.runtime import SessionPool
from fmda_tpu_torch.serve import StreamingBiGRU
from fmda_tpu_torch.serve.streaming import _layer_weights, serving_params

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
FEATS, HIDDEN, WINDOW, CLASSES = 6, 5, 4, 4


def _setup(n_layers=1, dtype="float32", seed=0):
    fields = dict(hidden_size=HIDDEN, n_features=FEATS, output_size=CLASSES,
                  dropout=0.0, bidirectional=False, cell="ssm",
                  n_layers=n_layers, dtype=dtype)
    jax_cfg = JaxModelConfig(use_pallas=False, **fields)
    params = jax.device_get(jax_build_model(jax_cfg).init(
        {"params": jax.random.PRNGKey(seed)},
        jnp.zeros((1, WINDOW, FEATS)))["params"])
    return jax_cfg, params, ModelConfig(**fields), params_from_flax(params)


def _tick_weights(cfg, state_dict):
    params = serving_params(state_dict, getattr(torch, cfg.dtype),
                            torch.device("cpu"))
    layers = [_layer_weights(params, False, "ssm", layer)
              for layer in range(cfg.n_layers)]
    return pack_tick_weights(layers, (params["linear.weight"],
                                      params["linear.bias"]))


def _norms(n, seed=0):
    rng = np.random.default_rng(seed)
    mins = rng.normal(size=(n, FEATS)).astype(np.float32)
    maxs = mins + rng.uniform(1.0, 5.0, size=(n, FEATS)).astype(np.float32)
    return mins, maxs


class _Pool:
    """The plain tick over hand-built pool tensors: (S, F) norm tables,
    (L, 3, S, H) state, (S,) positions."""

    def __init__(self, cfg, state_dict, n_slots, mins, maxs):
        self.weights = _tick_weights(cfg, state_dict)
        self.x_min = torch.from_numpy(mins)
        self.x_range = torch.from_numpy(maxs - mins)
        self.state = torch.zeros((cfg.n_layers, 3, n_slots, HIDDEN),
                                 dtype=getattr(torch, cfg.dtype))
        self.pos = torch.zeros((n_slots,), dtype=torch.int64)

    def step(self, slots, rows):
        return ssm_serve_tick_reference(
            torch.from_numpy(rows), torch.as_tensor(slots, dtype=torch.int32),
            self.x_min, self.x_range, self.weights, self.state, self.pos)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_layers", [1, 2])
def test_tick_matches_the_jax_pool_with_padded_buckets(n_layers, dtype):
    jax_cfg, params, cfg, state_dict = _setup(n_layers, dtype)
    n = 5
    jax_pool = JaxSessionPool(jax_cfg, params, capacity=n, window=WINDOW)
    mins, maxs = _norms(n, seed=5)
    handles = [jax_pool.alloc(f"T{i}", JaxNormParams(mins[i], maxs[i]))
               for i in range(n)]
    assert [h.slot for h in handles] == list(range(n))
    pad = jax_pool.padding_slot
    ours = _Pool(cfg, state_dict, n + 1,
                 np.concatenate([mins, np.zeros((1, FEATS), np.float32)]),
                 np.concatenate([maxs, np.ones((1, FEATS), np.float32)]))
    rng = np.random.default_rng(6)
    for k in range(8):
        live = np.flatnonzero(rng.random(n) < 0.7)
        bucket = 2 if len(live) <= 2 else 8  # the padding slot repeats
        slots = np.full(bucket, pad, np.int32)
        slots[:len(live)] = live
        rows = rng.normal(size=(bucket, FEATS)).astype(np.float32)
        got = ours.step(slots, rows)
        want = jax_pool.step(slots, rows)
        assert got.shape == (bucket, CLASSES) and got.dtype == torch.float32
        np.testing.assert_allclose(got[:len(live)].numpy(),
                                   np.asarray(want, np.float32)[:len(live)],
                                   atol=TOL[dtype], err_msg=f"flush {k}")
    for i, h in enumerate(handles):
        assert int(ours.pos[i]) == jax_pool.ticks_seen(h)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_layers", [1, 2])
def test_tick_matches_the_jax_solo_core_over_ticks(n_layers, dtype):
    """The solo core's form of the tick: lane b is slot b, one norm for
    every lane (a one-row table)."""
    jax_cfg, params, cfg, state_dict = _setup(n_layers, dtype, seed=3)
    mins, maxs = _norms(1, seed=4)
    jax_core = JaxStreamingBiGRU(jax_cfg, params,
                                 JaxNormParams(mins[0], maxs[0]),
                                 window=WINDOW)
    ours = _Pool(cfg, state_dict, 1, mins, maxs)
    rows = np.random.default_rng(7).normal(size=(12, FEATS)).astype(
        np.float32)
    for t, row in enumerate(rows):
        got = ours.step([0], row[None])
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jax_core.step(row), np.float32),
                                   atol=TOL[dtype], err_msg=f"tick {t}")
    assert int(ours.pos[0]) == len(rows)


def test_the_port_pool_and_core_tick_as_the_plain_version_does():
    """SessionPool and StreamingBiGRU run the plain tick on CPU tensors:
    their probabilities equal hand-driven ones bit for bit, and no kernel
    is counted."""
    _, _, cfg, state_dict = _setup(2)
    mins, maxs = _norms(3, seed=8)
    pool = SessionPool(cfg, state_dict, capacity=3, window=WINDOW,
                       device="cpu")
    handles = [pool.alloc(f"s{i}", NormParams(mins[i], maxs[i]))
               for i in range(3)]
    ours = _Pool(cfg, state_dict, 4,
                 np.concatenate([mins, np.zeros((1, FEATS), np.float32)]),
                 np.concatenate([maxs, np.ones((1, FEATS), np.float32)]))
    core = StreamingBiGRU(cfg, state_dict, NormParams(mins[0], maxs[0]),
                          window=WINDOW, device="cpu")
    solo = _Pool(cfg, state_dict, 1, mins[:1], maxs[:1])
    rng = np.random.default_rng(9)
    before = ssm_kernel.tick_launches
    for _ in range(5):
        slots = np.array([h.slot for h in handles] + [pool.padding_slot] * 2)
        rows = rng.normal(size=(5, FEATS)).astype(np.float32)
        np.testing.assert_array_equal(pool.step(slots, rows)[:3],
                                      ours.step(slots, rows)[:3].numpy())
        np.testing.assert_array_equal(core.step(rows[0]),
                                      solo.step([0], rows[:1]).numpy())
    assert ssm_kernel.tick_launches == before == 0
    for i, h in enumerate(handles):
        assert pool.ticks_seen(h) == int(ours.pos[i]) == 5
    assert torch.equal(pool._blocks[0].state[:, :, :3],
                       ours.state[:, :, :3])
    assert torch.equal(core._state, solo.state)


def test_the_tick_updates_only_the_lanes_slots_in_place():
    _, _, cfg, state_dict = _setup(2)
    mins, maxs = _norms(4, seed=10)
    ours = _Pool(cfg, state_dict, 4, mins, maxs)
    ours.state.normal_(generator=torch.Generator().manual_seed(0))
    ours.pos += 7
    state0, pos0 = ours.state.clone(), ours.pos.clone()
    data_ptr = ours.state.data_ptr()
    rows = np.random.default_rng(11).normal(size=(2, FEATS)).astype(
        np.float32)
    ours.step([2, 0], rows)
    assert ours.state.data_ptr() == data_ptr
    assert torch.equal(ours.state[:, :, [1, 3]], state0[:, :, [1, 3]])
    assert not torch.equal(ours.state[:, :, 2], state0[:, :, 2])
    assert ours.pos.tolist() == [8, 7, 8, 7]
    assert pos0.tolist() == [7] * 4


def test_pack_tick_weights_is_one_buffer_in_the_kernels_order():
    _, _, cfg, state_dict = _setup(2)
    tw = _tick_weights(cfg, state_dict)
    g = 3 * HIDDEN
    expect = (g * FEATS + g + 4 * HIDDEN + g * HIDDEN + g + 4 * HIDDEN
              + CLASSES * g + CLASSES)
    assert tw.packed.shape == (expect,) and tw.packed.is_contiguous()
    packed = tw.packed
    # layer 0's W_ih first, transposed to (F, 3H)
    np.testing.assert_array_equal(
        packed[:g * FEATS].view(FEATS, g).numpy(),
        state_dict["weight_ih_l0"].numpy().T)
    for layer, w in enumerate(tw.layers):
        for name, t in zip(("weight_ih", "bias_ih", "a_base", "d", "rho_f",
                            "rho_s"), w):
            assert torch.equal(t, state_dict[f"{name}_l{layer}"])
            base = t.data_ptr() - packed.data_ptr()
            assert 0 <= base < packed.numel() * packed.element_size()
    assert torch.equal(tw.head[0], state_dict["linear.weight"])
    assert torch.equal(tw.head[1], state_dict["linear.bias"])
    assert tw.head[1].data_ptr() == packed[-CLASSES:].data_ptr()


def _launch_inputs(n_layers=2):
    _, _, cfg, state_dict = _setup(n_layers)
    mins, maxs = _norms(4, seed=12)
    ours = _Pool(cfg, state_dict, 4, mins, maxs)
    rows = torch.from_numpy(
        np.random.default_rng(13).normal(size=(3, FEATS)).astype(np.float32))
    slots = torch.tensor([0, 3, 3], dtype=torch.int32)
    return dict(rows=rows, slots=slots, x_min=ours.x_min,
                x_range=ours.x_range, weights=ours.weights,
                state=ours.state, pos=ours.pos)


@pytest.mark.parametrize("case", [
    "state_dtype", "weights_dtype", "rows_dtype", "slots_dtype", "pos_dtype",
    "rows_shape", "slots_shape", "norm_shape", "state_shape", "pos_shape",
    "packed_size", "layer_count", "slot_high", "slot_negative",
    "noncontiguous"])
def test_kernel_launch_refuses_what_the_kernel_does_not_take(case,
                                                              monkeypatch):
    """The launch path's checks, which run before the library is built:
    each refusal raises and counts no launch."""
    monkeypatch.setattr(ssm_kernel, "_on_cpu", lambda *a: False)
    kw = _launch_inputs()
    error = ValueError
    if case == "state_dtype":
        kw["state"], error = kw["state"].double(), TypeError
    elif case == "weights_dtype":
        kw["state"], error = kw["state"].bfloat16(), TypeError
    elif case == "rows_dtype":
        kw["rows"], error = kw["rows"].double(), TypeError
    elif case == "slots_dtype":
        kw["slots"], error = kw["slots"].long(), TypeError
    elif case == "pos_dtype":
        kw["pos"], error = kw["pos"].int(), TypeError
    elif case == "rows_shape":
        kw["rows"] = kw["rows"][:, :-1].contiguous()
    elif case == "slots_shape":
        kw["slots"] = kw["slots"][:2]
    elif case == "norm_shape":
        kw["x_min"] = kw["x_min"][:2]
    elif case == "state_shape":
        kw["state"] = kw["state"][:, :2].contiguous()
    elif case == "pos_shape":
        kw["pos"] = kw["pos"][:3]
    elif case == "packed_size":
        w = kw["weights"]
        kw["weights"] = w._replace(packed=w.packed[:-1])
    elif case == "layer_count":
        kw["state"] = kw["state"][:1].contiguous()
    elif case == "slot_high":
        kw["slots"], error = torch.tensor([0, 4, 3], dtype=torch.int32), \
            IndexError
    elif case == "slot_negative":
        kw["slots"], error = torch.tensor([-1, 0, 3], dtype=torch.int32), \
            IndexError
    else:
        kw["rows"] = torch.cat([kw["rows"], kw["rows"]], dim=1)[:, ::2]
    state0 = kw["state"].clone()
    with pytest.raises(error):
        ssm_serve_tick(**kw)
    assert ssm_kernel.tick_launches == 0
    assert torch.equal(kw["state"], state0)


def test_tick_refuses_mixed_devices_and_recording_inputs():
    kw = _launch_inputs(1)
    meta = dict(kw, rows=kw["rows"].to("meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        ssm_serve_tick(**meta)
    rec = dict(kw, rows=kw["rows"].clone().requires_grad_())
    with pytest.raises(NotImplementedError, match="inference_mode"):
        ssm_serve_tick(**rec)
    assert ssm_kernel.tick_launches == 0
