"""fmda_tpu_torch's SSM family against the JAX package's, on the CPU.

- The serve tick's plain version (what the CUDA kernel's wrapper runs on
  CPU tensors) against ``fmda_tpu.ops.ssm.ssm_cell_step`` (float32) and
  against ``ssm_cell_step_pallas`` in interpret mode (the TPU kernel, whose
  rounding the port copies; float32 and bfloat16), over repeated ticks
  from nonzero carries.
- The scans: ``ssm_scan``, ``linear_scan_parallel``, ``ssm_scan_parallel``
  and ``ema_pool_parallel``.
- ``GatedSSM`` weight for weight against ``fmda_tpu``'s (params cross over
  through ``params_from_flax``), eval mode.

Tolerances: 1e-5 in float32 (other summation orders; the doubling scan
reassociates the decay products differently from
``jax.lax.associative_scan``); 2e-2 in bfloat16, compared in the working
type.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmda_tpu.config import FrameworkConfig as JaxFrameworkConfig
from fmda_tpu.config import ModelConfig as JaxModelConfig
from fmda_tpu.models import build_model as jax_build_model
from fmda_tpu.ops import ssm as jax_ssm
from fmda_tpu.ops.pallas_ssm import ssm_cell_step_pallas

from fmda_tpu_torch.config import FrameworkConfig, ModelConfig
from fmda_tpu_torch.interop import load_flax_npz, params_from_flax, save_flax_npz
from fmda_tpu_torch.models import GatedSSM, SSMState, build_model
from fmda_tpu_torch.ops import ssm_kernel
from fmda_tpu_torch.ops.ssm import (
    SSMWeights,
    ema_pool_parallel,
    linear_scan_parallel,
    ssm_cell_step,
    ssm_cell_step_reference,
    ssm_scan,
    ssm_scan_parallel,
)

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _weights(hidden, feats=5, seed=0):
    """Numpy SSMWeights, the per-channel vectors away from their init so
    every term of the tick matters."""
    r = np.random.default_rng(seed)
    f32 = np.float32
    return (
        (0.3 * r.normal(size=(3 * hidden, feats))).astype(f32),
        (0.1 * r.normal(size=(3 * hidden,))).astype(f32),
        r.uniform(1.0, 3.0, size=(hidden,)).astype(f32),
        (0.3 * r.normal(size=(hidden,))).astype(f32),
        (0.5 * r.normal(size=(hidden,))).astype(f32),
        (0.5 * r.normal(size=(hidden,)) + 3.0).astype(f32),
    )


def _tick_inputs(batch, hidden, ticks, seed=0):
    """xp (ticks, B, 3H) and a nonzero carry (s, ef, es)."""
    r = np.random.default_rng(seed + 100)
    xp = r.normal(size=(ticks, batch, 3 * hidden)).astype(np.float32)
    carry = tuple(r.normal(size=(batch, hidden)).astype(np.float32)
                  for _ in range(3))
    return xp, carry


def _jax_w(w, dtype=jnp.float32):
    return jax_ssm.SSMWeights(*(jnp.asarray(a, dtype) for a in w))


def _port_w(w, dtype=torch.float32):
    return SSMWeights(*(torch.from_numpy(a).to(dtype) for a in w))


SHAPES = [(1, 32), (64, 32), (5, 7)]


@pytest.mark.parametrize("batch,hidden", SHAPES)
@pytest.mark.parametrize("against", ["jnp_f32", "pallas_f32", "pallas_bf16"])
def test_step_reference_matches_jax_over_ticks(batch, hidden, against):
    w = _weights(hidden, seed=batch)
    xp, carry = _tick_inputs(batch, hidden, ticks=4, seed=hidden)
    if against == "jnp_f32":
        jdtype, tdtype, tol = jnp.float32, torch.float32, F32_TOL
        jax_step = jax_ssm.ssm_cell_step
    else:
        bf16 = against.endswith("bf16")
        jdtype = jnp.bfloat16 if bf16 else jnp.float32
        tdtype = torch.bfloat16 if bf16 else torch.float32
        tol = BF16_TOL if bf16 else F32_TOL

        def jax_step(x, c, wj):
            return ssm_cell_step_pallas(x, c, wj, interpret=True)
    jw, tw = _jax_w(w, jdtype), _port_w(w, tdtype)
    jc = tuple(jnp.asarray(c, jdtype) for c in carry)
    tc = tuple(torch.from_numpy(c).to(tdtype) for c in carry)
    for t in range(xp.shape[0]):
        jh, jc = jax_step(jnp.asarray(xp[t], jdtype), jc, jw)
        th, tc = ssm_cell_step_reference(torch.from_numpy(xp[t]).to(tdtype),
                                         tc, tw)
        assert th.dtype == tdtype and all(c.dtype == tdtype for c in tc)
        for got, want in zip((th, *tc), (jh, *jc)):
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       atol=tol)


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    w = _port_w(_weights(6))
    xp, carry = _tick_inputs(3, 6, ticks=1)
    xp = torch.from_numpy(xp[0])
    carry = tuple(torch.from_numpy(c) for c in carry)
    before = ssm_kernel.launches
    got = ssm_cell_step(xp, carry, w)
    want = ssm_cell_step_reference(xp, carry, w)
    assert ssm_kernel.launches == before == 0
    for g, r in zip((got[0], *got[1]), (want[0], *want[1])):
        assert torch.equal(g, r)


def test_wrapper_refuses_inputs_that_record_a_gradient():
    w = _port_w(_weights(4))
    xp, carry = _tick_inputs(2, 4, ticks=1)
    xp = torch.from_numpy(xp[0]).requires_grad_()
    carry = tuple(torch.from_numpy(c) for c in carry)
    with pytest.raises(NotImplementedError, match="inference_mode"):
        ssm_cell_step(xp, carry, w)
    with torch.inference_mode():
        ssm_cell_step(xp.detach(), carry, w)


@pytest.mark.parametrize("case", ["dtype", "strided", "carry_shape",
                                  "vector_shape", "carry_arity"])
def test_kernel_launch_refuses_what_the_kernel_does_not_take(case):
    """The launch path's checks, which run before the library is built."""
    w = _port_w(_weights(4))
    xp, carry = _tick_inputs(2, 4, ticks=1)
    xp = torch.from_numpy(xp[0])
    carry = tuple(torch.from_numpy(c) for c in carry)
    error = ValueError
    if case == "dtype":
        xp, error = xp.double(), TypeError
    elif case == "strided":
        xp = torch.cat([xp, xp], dim=-1)[:, ::2]
    elif case == "carry_shape":
        carry = (carry[0][:1], *carry[1:])
    elif case == "vector_shape":
        w = w._replace(d=w.d[:3])
    else:
        carry = carry[:2]
    with pytest.raises(error):
        ssm_kernel._launch(xp, carry, w)
    assert ssm_kernel.launches == 0


@pytest.mark.parametrize("reverse", [False, True])
def test_sequential_scan_matches_jax(reverse):
    w = _weights(6)
    xp, carry = _tick_inputs(3, 6, ticks=1)
    x = np.random.default_rng(3).normal(size=(3, 9, 18)).astype(np.float32)
    jc, jhs = jax_ssm.ssm_scan(jnp.asarray(x), tuple(map(jnp.asarray, carry)),
                               _jax_w(w), reverse=reverse)
    tc, ths = ssm_scan(torch.from_numpy(x),
                       tuple(map(torch.from_numpy, carry)), _port_w(w),
                       reverse=reverse)
    np.testing.assert_allclose(ths.numpy(), np.asarray(jhs), atol=F32_TOL)
    for g, r in zip(tc, jc):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=F32_TOL)


@pytest.mark.parametrize("steps", [1, 2, 7, 30])
@pytest.mark.parametrize("with_x0", [False, True])
def test_linear_scan_parallel_matches_jax(steps, with_x0):
    r = np.random.default_rng(steps)
    a = r.uniform(0.5, 1.0, size=(3, steps, 5)).astype(np.float32)
    u = r.normal(size=(3, steps, 5)).astype(np.float32)
    x0 = r.normal(size=(3, 5)).astype(np.float32) if with_x0 else None
    want = jax_ssm.linear_scan_parallel(
        jnp.asarray(a), jnp.asarray(u),
        None if x0 is None else jnp.asarray(x0))
    got = linear_scan_parallel(torch.from_numpy(a), torch.from_numpy(u),
                               None if x0 is None else torch.from_numpy(x0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)
    # and the sequential recurrence it stands for
    x = np.zeros((3, 5), np.float32) if x0 is None else x0
    for t in range(steps):
        x = a[:, t] * x + u[:, t]
        np.testing.assert_allclose(got[:, t].numpy(), x, atol=F32_TOL)


def test_linear_scan_parallel_is_differentiable():
    a = torch.full((1, 4, 1), 0.5, requires_grad=True)
    u = torch.ones((1, 4, 1), requires_grad=True)
    x = linear_scan_parallel(a, u)
    x[:, -1].sum().backward()
    # x_3 = u_3 + a_3 u_2 + a_3 a_2 u_1 + a_3 a_2 a_1 u_0
    np.testing.assert_allclose(u.grad[0, :, 0].numpy(),
                               [0.125, 0.25, 0.5, 1.0])
    assert a.grad is not None and torch.isfinite(a.grad).all()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("with_s0", [False, True])
def test_ssm_scan_parallel_matches_jax(reverse, with_s0):
    w = _weights(6)
    r = np.random.default_rng(4)
    x = r.normal(size=(3, 11, 18)).astype(np.float32)
    s0 = r.normal(size=(3, 6)).astype(np.float32) if with_s0 else None
    jhs, js = jax_ssm.ssm_scan_parallel(
        jnp.asarray(x), _jax_w(w), None if s0 is None else jnp.asarray(s0),
        reverse=reverse)
    ths, ts = ssm_scan_parallel(
        torch.from_numpy(x), _port_w(w),
        None if s0 is None else torch.from_numpy(s0), reverse=reverse)
    np.testing.assert_allclose(ths.numpy(), np.asarray(jhs), atol=F32_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=F32_TOL)
    if not reverse:  # parallel mode against the stepped cache
        carry = (torch.zeros(3, 6) if s0 is None else torch.from_numpy(s0),
                 torch.zeros(3, 6), torch.zeros(3, 6))
        _, seq = ssm_scan(torch.from_numpy(x), carry, _port_w(w))
        np.testing.assert_allclose(ths.numpy(), seq.numpy(), atol=F32_TOL)


@pytest.mark.parametrize("with_ema0", [False, True])
def test_ema_pool_parallel_matches_jax(with_ema0):
    r = np.random.default_rng(5)
    hs = r.normal(size=(2, 13, 4)).astype(np.float32)
    rho = r.normal(size=(4,)).astype(np.float32)
    e0 = r.normal(size=(2, 4)).astype(np.float32) if with_ema0 else None
    want = jax_ssm.ema_pool_parallel(jnp.asarray(hs), jnp.asarray(rho),
                                     None if e0 is None else jnp.asarray(e0))
    got = ema_pool_parallel(torch.from_numpy(hs), torch.from_numpy(rho),
                            None if e0 is None else torch.from_numpy(e0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)


# -- the model -----------------------------------------------------------------


def _jax_params(cfg, seed=0, steps=7):
    model = jax_build_model(cfg)
    params = model.init({"params": jax.random.PRNGKey(seed)},
                        jnp.zeros((1, steps, cfg.n_features)))["params"]
    return model, jax.device_get(params)


def _port_model(cfg, flax_params):
    model = build_model(cfg)
    assert type(model) is GatedSSM
    model.load_state_dict(params_from_flax(flax_params), strict=True)
    return model.eval()


def _ragged_mask(batch, steps, seed=5):
    lengths = np.random.default_rng(seed).integers(1, steps + 1, size=batch)
    lengths[0] = steps
    return np.arange(steps)[None, :] < lengths[:, None]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("n_layers", [1, 2])
def test_gated_ssm_logits_match_jax(n_layers, bidirectional, masked):
    fields = dict(hidden_size=5, n_features=6, output_size=4,
                  n_layers=n_layers, bidirectional=bidirectional, cell="ssm")
    jax_model, params = _jax_params(JaxModelConfig(**fields))
    port = _port_model(ModelConfig(**fields), params)
    x = np.random.default_rng(n_layers + 2 * bidirectional).normal(
        size=(4, 9, 6)).astype(np.float32)
    mask = _ragged_mask(4, 9) if masked else None
    want = jax_model.apply({"params": params}, x,
                           mask=None if mask is None else jnp.asarray(mask))
    with torch.inference_mode():
        got = port(torch.from_numpy(x),
                   mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)


def test_full_width_gated_ssm_matches_jax():
    jax_cfg = dataclasses.replace(JaxFrameworkConfig().model, cell="ssm")
    cfg = dataclasses.replace(FrameworkConfig().model, cell="ssm")
    assert (cfg.hidden_size, cfg.n_features, cfg.n_layers,
            cfg.bidirectional) == (32, 108, 1, True)
    assert (cfg.ssm_decay_range, cfg.ssm_ema_init) == (
        jax_cfg.ssm_decay_range, jax_cfg.ssm_ema_init)
    jax_model, params = _jax_params(jax_cfg, seed=1, steps=30)
    port = _port_model(cfg, params)
    x = np.random.default_rng(6).normal(size=(4, 30, 108)).astype(np.float32)
    want = jax_model.apply({"params": params}, x)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)


@pytest.mark.parametrize("n_layers", [1, 2])
def test_chunked_state_carry_matches_full_window_and_jax(n_layers):
    fields = dict(hidden_size=5, n_features=6, output_size=4,
                  n_layers=n_layers, bidirectional=False, cell="ssm")
    jax_model, params = _jax_params(JaxModelConfig(**fields))
    port = _port_model(ModelConfig(**fields), params)
    x = np.random.default_rng(7).normal(size=(3, 12, 6)).astype(np.float32)
    xt = torch.from_numpy(x)
    _, jst = jax_model.apply({"params": params}, x[:, :7], return_state=True)
    jlogits = jax_model.apply({"params": params}, x[:, 7:], jst)
    with torch.inference_mode():
        full = port(xt)
        _, st = port(xt[:, :7], return_state=True)
        assert isinstance(st, SSMState)
        assert st.s.shape == (n_layers, 3, 5)
        chunked = port(xt[:, 7:], state=st)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), atol=F32_TOL)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(jlogits),
                               atol=F32_TOL)
    for g, w in zip(st, jst):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F32_TOL)


def test_bidirectional_state_is_refused():
    cfg = ModelConfig(hidden_size=4, n_features=3, cell="ssm")
    model = build_model(cfg).eval()
    x = torch.zeros(1, 4, 3)
    state = SSMState(torch.zeros(1, 1, 4), torch.zeros(1, 4),
                     torch.zeros(1, 4))
    with pytest.raises(ValueError, match="bidirectional=False"):
        model(x, state=state)
    with pytest.raises(ValueError, match="bidirectional=False"):
        model(x, return_state=True)


def test_ssm_interop_round_trip(tmp_path):
    cfg = JaxModelConfig(hidden_size=4, n_features=3, n_layers=2, cell="ssm")
    _, params = _jax_params(cfg)
    path = str(tmp_path / "params.npz")
    save_flax_npz({"params": params}, path)
    loaded = load_flax_npz(path)
    direct = params_from_flax(params)
    assert loaded.keys() == direct.keys()
    for k in direct:
        assert torch.equal(loaded[k], direct[k])
    # the per-channel vectors cross as they are, not transposed
    for k in ("a_base_l0", "d_l1_reverse", "rho_f_l0", "rho_s_l1"):
        np.testing.assert_array_equal(loaded[k].numpy(), params[k])
    assert loaded["linear.weight"].shape == (cfg.output_size, 3 * 4)
    port = build_model(ModelConfig(hidden_size=4, n_features=3, n_layers=2,
                                   cell="ssm"))
    port.load_state_dict(loaded, strict=True)
    assert set(port.state_dict()) == set(direct)


def test_init_is_seeded_and_follows_the_jax_init():
    cfg = ModelConfig(hidden_size=16, n_features=3, cell="ssm")
    a = build_model(cfg, generator=torch.Generator().manual_seed(7))
    b = build_model(cfg, generator=torch.Generator().manual_seed(7))
    lo, hi = cfg.ssm_decay_range
    for (name, p), q in zip(a.state_dict().items(),
                            b.state_dict().values()):
        assert torch.equal(p, q), name
        if name.startswith("a_base"):
            decay = torch.sigmoid(p)
            assert decay.min() >= lo - 1e-6 and decay.max() <= hi + 1e-6
        elif name.startswith("rho_f"):
            np.testing.assert_allclose(torch.sigmoid(p).numpy(),
                                       cfg.ssm_ema_init[0], rtol=1e-6)
        elif name.startswith("rho_s"):
            np.testing.assert_allclose(torch.sigmoid(p).numpy(),
                                       cfg.ssm_ema_init[1], rtol=1e-6)
        else:
            fan = 3 * 16 if name.startswith("linear.") else 16
            assert p.abs().max() <= 1.0 / np.sqrt(fan)
