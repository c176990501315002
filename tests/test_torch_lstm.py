"""fmda_tpu_torch's LSTM scan, forward and backward, against the JAX
package's, on the CPU.

The port's plain versions (what the CUDA kernels' wrappers run on CPU
tensors) are held to ``fmda_tpu.ops.lstm.lstm_scan`` (lax.scan, with and
without a mask) and to ``lstm_scan_pallas`` in interpret mode (the TPU
kernel pair, whose rounding the port copies), forward and through
``jax.vjp``, with nonzero h0, c0 and cotangents of all three outputs.
Tolerances: 1e-5 in float32 (the frameworks sum in different orders);
2e-2 in bfloat16, compared in the working type.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmda_tpu.ops.lstm import LSTMWeights as JaxLSTMWeights
from fmda_tpu.ops.lstm import lstm_layer as jax_lstm_layer
from fmda_tpu.ops.lstm import lstm_scan as jax_lstm_scan
from fmda_tpu.ops.pallas_lstm import lstm_scan_pallas

from fmda_tpu_torch.ops import lstm_kernel
from fmda_tpu_torch.ops.lstm import (
    LSTMWeights,
    lstm_layer,
    lstm_scan,
    lstm_scan_bwd,
    lstm_scan_bwd_reference,
    lstm_scan_fwd,
    lstm_scan_reference,
)

F32_TOL = 1e-5
BF16_TOL = 2e-2
B, T, H = 3, 7, 8
GRADS = ("dxp", "dh0", "dc0", "dw_hh", "db_hh")


def _inputs(batch=B, steps=T, hidden=H, *, seed=0):
    """xp, h0, c0, w_hh, b_hh and the cotangents dh_last, dc_last, dhs."""
    r = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(hidden)
    xp = r.normal(size=(batch, steps, 4 * hidden)).astype(np.float32)
    h0 = (0.5 * r.normal(size=(batch, hidden))).astype(np.float32)
    c0 = r.normal(size=(batch, hidden)).astype(np.float32)
    w = r.uniform(-s, s, size=(4 * hidden, hidden)).astype(np.float32)
    b = r.uniform(-s, s, size=(4 * hidden,)).astype(np.float32)
    dh_last = r.normal(size=(batch, hidden)).astype(np.float32)
    dc_last = r.normal(size=(batch, hidden)).astype(np.float32)
    dhs = r.normal(size=(batch, steps, hidden)).astype(np.float32)
    return (xp, h0, c0, w, b), (dh_last, dc_last, dhs)


def _ragged_mask(batch, steps, seed=1):
    lengths = np.random.default_rng(seed).integers(1, steps + 1, size=batch)
    lengths[0] = steps  # one full row beside the ragged ones
    return np.arange(steps)[None, :] < lengths[:, None]


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _port_fwd(arrays, dtype=torch.float32, **kw):
    """The port's forward: ((h_last, c_last), hs) as float32 numpy."""
    with torch.inference_mode():
        (h_last, c_last), hs = lstm_scan(*_torch(arrays, dtype), **kw)
    return [t.float().numpy() for t in (h_last, c_last, hs)]


def _jax_fwd(fn, arrays):
    (h_last, c_last), hs = fn(*arrays)
    return [np.asarray(t, np.float32) for t in (h_last, c_last, hs)]


def _port_bwd(arrays, cotangents, dtype=torch.float32, *, reverse,
              mask=None):
    """The port's plain backward, fed the port's plain forward's hs, cs."""
    xp, h0, c0, w, b = _torch(arrays, dtype)
    dh_last, dc_last, dhs = _torch(cotangents, dtype)
    m = None if mask is None else torch.from_numpy(mask)
    with torch.inference_mode():
        _, _, hs, cs = lstm_scan_reference(xp, h0, c0, w, b, reverse=reverse,
                                           mask=m)
        out = lstm_scan_bwd(xp, h0, c0, w, b, hs, cs, dh_last, dc_last, dhs,
                            reverse=reverse, mask=m)
    return [o.float().numpy() for o in out]


def _jax_vjp(fn, arrays, cotangents):
    _, vjp = jax.vjp(fn, *arrays)
    dh_last, dc_last, dhs = cotangents
    return [np.asarray(g, np.float32) for g in vjp(((dh_last, dc_last), dhs))]


def _assert_close(got, want, tol, names=GRADS):
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=tol, err_msg=name)


# -- forward ---------------------------------------------------------------


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_matches_lax_scan_and_pallas_interpret(reverse):
    arrays, _ = _inputs(seed=2)
    got = _port_fwd(arrays, reverse=reverse)
    names = ("h_last", "c_last", "hs")
    _assert_close(got, _jax_fwd(
        lambda *a: jax_lstm_scan(*a, reverse=reverse), arrays), F32_TOL,
        names)
    _assert_close(got, _jax_fwd(
        lambda *a: lstm_scan_pallas(*a, reverse=reverse, interpret=True),
        arrays), F32_TOL, names)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_bf16_matches_pallas_interpret(reverse):
    arrays, _ = _inputs(batch=4, steps=6, seed=3)
    got = _port_fwd(arrays, torch.bfloat16, reverse=reverse)
    bf16 = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    want = _jax_fwd(
        lambda *a: lstm_scan_pallas(*a, reverse=reverse, interpret=True),
        bf16)
    _assert_close(got, want, BF16_TOL, ("h_last", "c_last", "hs"))


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_ragged_mask_carries_h_and_c_through(reverse):
    arrays, _ = _inputs(seed=4)
    mask = _ragged_mask(B, T, seed=5)
    got = _port_fwd(arrays, reverse=reverse, mask=torch.from_numpy(mask))
    want = _jax_fwd(lambda *a: jax_lstm_scan(
        *a, reverse=reverse, mask=jnp.asarray(mask)), arrays)
    _assert_close(got, want, F32_TOL, ("h_last", "c_last", "hs"))


def test_plain_forward_emits_the_cell_states():
    """cs is the carried c after every step: c_last is its last processed
    entry, and a masked step repeats the carried value."""
    arrays, _ = _inputs(seed=6)
    mask = torch.from_numpy(_ragged_mask(B, T, seed=7))
    with torch.inference_mode():
        h_last, c_last, hs, cs = lstm_scan_reference(*_torch(arrays),
                                                     mask=mask)
    assert cs.shape == hs.shape == (B, T, H)
    lengths = mask.sum(dim=1)
    for row, n in enumerate(lengths.tolist()):
        assert torch.equal(c_last[row], cs[row, n - 1])
        assert torch.equal(cs[row, n - 1:], cs[row, n - 1].expand(T - n + 1,
                                                                 H))
        assert torch.equal(h_last[row], hs[row, -1])


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_matches_jax_lstm_layer(reverse):
    r = np.random.default_rng(8)
    x = r.normal(size=(3, 6, 5)).astype(np.float32)
    hidden = 4
    s = 1.0 / np.sqrt(hidden)
    weights = [r.uniform(-s, s, size=shape).astype(np.float32)
               for shape in ((16, 5), (16, 4), (16,), (16,))]
    with torch.inference_mode():
        (h_last, c_last), hs = lstm_layer(
            torch.from_numpy(x), LSTMWeights(*map(torch.from_numpy, weights)),
            reverse=reverse)
    (ref_h, ref_c), ref_hs = jax_lstm_layer(x, JaxLSTMWeights(*weights),
                                            reverse=reverse)
    _assert_close([h_last.numpy(), c_last.numpy(), hs.numpy()],
                  [np.asarray(ref_h), np.asarray(ref_c), np.asarray(ref_hs)],
                  F32_TOL, ("h_last", "c_last", "hs"))


# -- backward --------------------------------------------------------------


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_bwd_matches_vjp_of_lax_scan(reverse, masked):
    arrays, cotangents = _inputs(seed=9)
    mask = _ragged_mask(B, T, seed=10) if masked else None
    got = _port_bwd(arrays, cotangents, reverse=reverse, mask=mask)
    m = None if mask is None else jnp.asarray(mask)
    want = _jax_vjp(lambda *a: jax_lstm_scan(*a, reverse=reverse, mask=m),
                    arrays, cotangents)
    _assert_close(got, want, F32_TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_bwd_matches_vjp_of_pallas_interpret_f32(reverse):
    arrays, cotangents = _inputs(seed=11)
    got = _port_bwd(arrays, cotangents, reverse=reverse)
    want = _jax_vjp(
        lambda *a: lstm_scan_pallas(*a, reverse=reverse, interpret=True),
        arrays, cotangents)
    _assert_close(got, want, F32_TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_bwd_bf16_matches_vjp_of_pallas_interpret(reverse):
    arrays, cotangents = _inputs(batch=4, steps=6, seed=12)
    got = _port_bwd(arrays, cotangents, dtype=torch.bfloat16,
                    reverse=reverse)
    bf16 = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    cot = [jnp.asarray(a, jnp.bfloat16) for a in cotangents]
    want = _jax_vjp(
        lambda *a: lstm_scan_pallas(*a, reverse=reverse, interpret=True),
        bf16, cot)
    _assert_close(got, want, BF16_TOL)


def test_bwd_reads_a_nonzero_dc_last():
    """dc_last reaches dc0 through f at every step: a zero dc_last and a
    nonzero one give different gradients, and the difference is the vjp's."""
    arrays, (dh_last, dc_last, dhs) = _inputs(seed=13)
    zero = _port_bwd(arrays, (dh_last, np.zeros_like(dc_last), dhs),
                     reverse=False)
    full = _port_bwd(arrays, (dh_last, dc_last, dhs), reverse=False)
    assert np.abs(full[2] - zero[2]).max() > 1e-3  # dc0
    want = _jax_vjp(lambda *a: lstm_scan_pallas(*a, interpret=True), arrays,
                    (np.zeros_like(dh_last), dc_last, np.zeros_like(dhs)))
    _assert_close([f - z for f, z in zip(full, zero)], want, F32_TOL)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_lstm_scan_autograd_runs_the_kernel_pair_plain_versions(reverse,
                                                               masked):
    """The differentiable lstm_scan's gradients through
    torch.autograd.grad are the plain backward's, and match jax.vjp of
    the lax.scan path."""
    arrays, cotangents = _inputs(seed=14)
    mask = _ragged_mask(B, T, seed=15) if masked else None
    m = None if mask is None else torch.from_numpy(mask)
    inputs = [t.requires_grad_() for t in _torch(arrays)]
    (h_last, c_last), hs = lstm_scan(*inputs, reverse=reverse, mask=m)
    grads = torch.autograd.grad((h_last, c_last, hs), inputs,
                                _torch(cotangents))
    got = [g.numpy() for g in grads]
    want = _port_bwd(arrays, cotangents, reverse=reverse, mask=mask)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    jm = None if mask is None else jnp.asarray(mask)
    _assert_close(got, _jax_vjp(
        lambda *a: jax_lstm_scan(*a, reverse=reverse, mask=jm), arrays,
        cotangents), F32_TOL)


def test_lstm_scan_autograd_without_a_c_last_cotangent_uses_zeros():
    """BiLSTM reads h_last and hs only: autograd leaves c_last's cotangent
    undefined and the backward gets zeros."""
    arrays, (dh_last, dc_last, dhs) = _inputs(seed=16)
    inputs = [t.requires_grad_() for t in _torch(arrays)]
    (h_last, _), hs = lstm_scan(*inputs)
    grads = torch.autograd.grad(
        (h_last, hs), inputs, [torch.from_numpy(dh_last),
                               torch.from_numpy(dhs)])
    want = _port_bwd(arrays, (dh_last, np.zeros_like(dc_last), dhs),
                     reverse=False)
    for g, w in zip(grads, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_grads_match_jax_grad_of_lstm_layer(reverse):
    r = np.random.default_rng(17)
    x = r.normal(size=(3, 6, 5)).astype(np.float32)
    hidden = 4
    s = 1.0 / np.sqrt(hidden)
    weights = [r.uniform(-s, s, size=shape).astype(np.float32)
               for shape in ((16, 5), (16, 4), (16,), (16,))]
    probe = r.normal(size=(3, 6, hidden)).astype(np.float32)
    probe_last = r.normal(size=(3, hidden)).astype(np.float32)

    def jax_loss(w_ih, w_hh, b_ih, b_hh):
        (h_last, _), hs = jax_lstm_layer(
            x, JaxLSTMWeights(w_ih, w_hh, b_ih, b_hh), reverse=reverse)
        return jnp.sum(hs * probe) + jnp.sum(h_last * probe_last)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(*weights)
    params = [torch.from_numpy(w).requires_grad_() for w in weights]
    (h_last, _), hs = lstm_layer(torch.from_numpy(x), LSTMWeights(*params),
                                 reverse=reverse)
    loss = (hs * torch.from_numpy(probe)).sum() + (
        h_last * torch.from_numpy(probe_last)).sum()
    loss.backward()
    for name, p, w in zip(("w_ih", "w_hh", "b_ih", "b_hh"), params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                   atol=F32_TOL, err_msg=name)


# -- the wrappers' contracts ---------------------------------------------------


def test_wrappers_on_cpu_tensors_run_the_plain_versions_uncounted():
    arrays, cotangents = _inputs(seed=18)
    xp, h0, c0, w, b = _torch(arrays)
    dh_last, dc_last, dhs = _torch(cotangents)
    mask = torch.from_numpy(_ragged_mask(B, T))
    before = (lstm_kernel.launches, lstm_kernel.bwd_launches)
    with torch.inference_mode():
        fwd = lstm_scan_fwd(xp, h0, c0, w, b, reverse=True, mask=mask)
        ref = lstm_scan_reference(xp, h0, c0, w, b, reverse=True, mask=mask)
        _, _, hs, cs = fwd
        bwd = lstm_scan_bwd(xp, h0, c0, w, b, hs, cs, dh_last, dc_last, dhs,
                            reverse=True, mask=mask)
        bwd_ref = lstm_scan_bwd_reference(xp, h0, c0, w, b, hs, cs, dh_last,
                                          dc_last, dhs, reverse=True,
                                          mask=mask)
    assert (lstm_kernel.launches, lstm_kernel.bwd_launches) == before
    for g, w_ in zip((*fwd, *bwd), (*ref, *bwd_ref)):
        assert torch.equal(g, w_)


def test_raw_forward_refuses_inputs_that_require_grad():
    xp, h0, c0, w, b = _torch(_inputs()[0])
    w = w.requires_grad_()
    with pytest.raises(NotImplementedError, match="lstm_scan"):
        lstm_scan_fwd(xp, h0, c0, w, b)
    with torch.no_grad():  # nothing would record a gradient: allowed
        lstm_scan_fwd(xp, h0, c0, w, b)


def test_wrappers_refuse_mixed_devices():
    arrays, cotangents = _inputs(seed=19)
    xp, h0, c0, w, b = _torch(arrays)
    dh_last, dc_last, dhs = _torch(cotangents)
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        lstm_scan_fwd(xp, h0, c0.to("meta"), w, b)
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        lstm_scan_bwd(xp, h0, c0, w, b, dhs, dhs.to("meta"), dh_last,
                      dc_last, dhs)
