"""fmda_tpu_torch's GRU backward scan against the JAX package's, on the CPU.

The port's plain backward (what the CUDA backward kernel's wrapper runs on
CPU tensors) is held to ``jax.vjp`` of ``fmda_tpu.ops.gru.gru_scan``
(lax.scan), to ``jax.vjp`` of ``gru_scan_pallas`` in interpret mode (the
TPU kernel pair, whose bf16 rounding of ``dg_h`` the port copies) and to
torch autograd through the port's own plain forward.  Tolerances: 1e-5 in
float32 (the frameworks sum in different orders); 2e-2 in bfloat16,
compared in the working type.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmda_tpu.ops.gru import GRUWeights as JaxGRUWeights
from fmda_tpu.ops.gru import gru_layer as jax_gru_layer
from fmda_tpu.ops.gru import gru_scan as jax_gru_scan
from fmda_tpu.ops.pallas_gru import gru_scan_pallas

from fmda_tpu_torch.ops import gru_kernel
from fmda_tpu_torch.ops.gru import (
    GRUWeights,
    gru_layer,
    gru_scan,
    gru_scan_bwd,
    gru_scan_bwd_reference,
    gru_scan_reference,
)

F32_TOL = 1e-5
BF16_TOL = 2e-2
B, T, H = 3, 7, 8


def _inputs(batch=B, steps=T, hidden=H, *, seed=0, nonzero_h0=True):
    """xp, h0, w_hh, b_hh and the cotangents dh_last, dhs, from a seed."""
    r = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(hidden)
    xp = r.normal(size=(batch, steps, 3 * hidden)).astype(np.float32)
    h0 = (0.5 * r.normal(size=(batch, hidden)) if nonzero_h0
          else np.zeros((batch, hidden))).astype(np.float32)
    w = r.uniform(-s, s, size=(3 * hidden, hidden)).astype(np.float32)
    b = r.uniform(-s, s, size=(3 * hidden,)).astype(np.float32)
    dh_last = r.normal(size=(batch, hidden)).astype(np.float32)
    dhs = r.normal(size=(batch, steps, hidden)).astype(np.float32)
    return (xp, h0, w, b), (dh_last, dhs)


def _ragged_mask(batch, steps, seed=1):
    lengths = np.random.default_rng(seed).integers(1, steps + 1, size=batch)
    lengths[0] = steps
    return np.arange(steps)[None, :] < lengths[:, None]


def _port_bwd(arrays, cotangents, dtype=torch.float32, *, reverse,
              mask=None):
    """The port's plain backward, fed the port's plain forward's hs."""
    xp, h0, w, b = (torch.from_numpy(a).to(dtype) for a in arrays)
    dh_last, dhs = (torch.from_numpy(a).to(dtype) for a in cotangents)
    m = None if mask is None else torch.from_numpy(mask)
    with torch.inference_mode():
        _, hs = gru_scan_reference(xp, h0, w, b, reverse=reverse, mask=m)
        out = gru_scan_bwd(xp, h0, w, b, hs, dh_last, dhs, reverse=reverse,
                           mask=m)
    return [o.float().numpy() for o in out]


def _jax_vjp(fn, arrays, cotangents):
    _, vjp = jax.vjp(fn, *arrays)
    dh_last, dhs = cotangents
    return [np.asarray(g, np.float32) for g in vjp((dh_last, dhs))]


def _assert_close(got, want, tol):
    names = ("dxp", "dh0", "dw_hh", "db_hh")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=tol, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_bwd_matches_vjp_of_lax_scan(reverse, masked):
    arrays, cotangents = _inputs(seed=2)
    mask = _ragged_mask(B, T) if masked else None
    got = _port_bwd(arrays, cotangents, reverse=reverse, mask=mask)
    m = None if mask is None else jnp.asarray(mask)
    want = _jax_vjp(
        lambda *a: jax_gru_scan(*a, reverse=reverse, mask=m),
        arrays, cotangents)
    _assert_close(got, want, F32_TOL)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("nonzero_h0", [False, True])
def test_bwd_matches_vjp_of_pallas_interpret_f32(reverse, nonzero_h0):
    arrays, cotangents = _inputs(seed=3, nonzero_h0=nonzero_h0)
    got = _port_bwd(arrays, cotangents, reverse=reverse)
    want = _jax_vjp(
        lambda *a: gru_scan_pallas(*a, reverse=reverse, interpret=True),
        arrays, cotangents)
    _assert_close(got, want, F32_TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_bwd_bf16_matches_vjp_of_pallas_interpret(reverse):
    arrays, cotangents = _inputs(batch=4, steps=6, hidden=16, seed=4)
    got = _port_bwd(arrays, cotangents, dtype=torch.bfloat16,
                    reverse=reverse)
    bf16 = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    cot = [jnp.asarray(a, jnp.bfloat16) for a in cotangents]
    want = _jax_vjp(
        lambda *a: gru_scan_pallas(*a, reverse=reverse, interpret=True),
        bf16, cot)
    _assert_close(got, want, BF16_TOL)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_bwd_matches_torch_autograd_of_the_plain_forward(reverse, masked):
    arrays, cotangents = _inputs(seed=5)
    mask = _ragged_mask(B, T, seed=6) if masked else None
    got = _port_bwd(arrays, cotangents, reverse=reverse, mask=mask)
    inputs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    m = None if mask is None else torch.from_numpy(mask)
    h_last, hs = gru_scan_reference(*inputs, reverse=reverse, mask=m)
    want = torch.autograd.grad(
        (h_last, hs), inputs, [torch.from_numpy(c) for c in cotangents])
    _assert_close(got, [g.numpy() for g in want], F32_TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_autograd_runs_the_kernel_pair_plain_versions(reverse):
    """The differentiable gru_scan's gradients are the plain backward's,
    and an output autograd leaves without a cotangent counts as zeros."""
    arrays, (dh_last, dhs) = _inputs(seed=7)
    inputs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    h_last, hs = gru_scan(*inputs, reverse=reverse)
    grads = torch.autograd.grad(h_last, inputs, torch.from_numpy(dh_last))
    want = _port_bwd(arrays, (dh_last, np.zeros_like(dhs)), reverse=reverse)
    for g, w in zip(grads, want):
        np.testing.assert_array_equal(g.numpy(), w)
    with torch.inference_mode():  # no recording: the plain forward alone
        ref_last, ref_hs = gru_scan_reference(
            *(torch.from_numpy(a) for a in arrays), reverse=reverse)
    assert torch.equal(h_last.detach(), ref_last)
    assert torch.equal(hs.detach(), ref_hs)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_layer_grads_match_jax_grad_of_gru_layer(reverse):
    r = np.random.default_rng(8)
    x = r.normal(size=(3, 6, 5)).astype(np.float32)
    hidden = 4
    s = 1.0 / np.sqrt(hidden)
    weights = [r.uniform(-s, s, size=shape).astype(np.float32)
               for shape in ((12, 5), (12, 4), (12,), (12,))]
    probe = r.normal(size=(3, 6, hidden)).astype(np.float32)
    probe_last = r.normal(size=(3, hidden)).astype(np.float32)

    def jax_loss(w_ih, w_hh, b_ih, b_hh):
        h_last, hs = jax_gru_layer(x, JaxGRUWeights(w_ih, w_hh, b_ih, b_hh),
                                   reverse=reverse)
        return jnp.sum(hs * probe) + jnp.sum(h_last * probe_last)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(*weights)
    params = [torch.from_numpy(w).requires_grad_() for w in weights]
    h_last, hs = gru_layer(torch.from_numpy(x), GRUWeights(*params),
                           reverse=reverse)
    loss = (hs * torch.from_numpy(probe)).sum() + (
        h_last * torch.from_numpy(probe_last)).sum()
    loss.backward()
    for name, p, w in zip(("w_ih", "w_hh", "b_ih", "b_hh"), params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                   atol=F32_TOL, err_msg=name)


def test_bwd_wrapper_on_cpu_tensors_runs_the_plain_version_uncounted():
    arrays, cotangents = _inputs(seed=9)
    xp, h0, w, b = (torch.from_numpy(a) for a in arrays)
    dh_last, dhs = (torch.from_numpy(a) for a in cotangents)
    mask = torch.from_numpy(_ragged_mask(B, T))
    before = (gru_kernel.launches, gru_kernel.bwd_launches)
    with torch.inference_mode():
        _, hs = gru_kernel.gru_scan_fwd(xp, h0, w, b, mask=mask)
        got = gru_kernel.gru_scan_bwd(xp, h0, w, b, hs, dh_last, dhs,
                                      mask=mask)
        want = gru_scan_bwd_reference(xp, h0, w, b, hs, dh_last, dhs,
                                      mask=mask)
    assert (gru_kernel.launches, gru_kernel.bwd_launches) == before
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


def test_bwd_wrapper_refuses_mixed_devices():
    arrays, cotangents = _inputs(seed=10)
    xp, h0, w, b = (torch.from_numpy(a) for a in arrays)
    dh_last, dhs = (torch.from_numpy(a) for a in cotangents)
    hs = torch.zeros_like(dhs)
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        gru_kernel.gru_scan_bwd(xp, h0, w, b, hs.to("meta"), dh_last, dhs)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_autograd_with_a_mask(reverse):
    arrays, cotangents = _inputs(seed=11)
    mask = _ragged_mask(B, T, seed=12)
    inputs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    h_last, hs = gru_scan(*inputs, reverse=reverse,
                          mask=torch.from_numpy(mask))
    grads = torch.autograd.grad(
        (h_last, hs), inputs, [torch.from_numpy(c) for c in cotangents])
    want = _port_bwd(arrays, cotangents, reverse=reverse, mask=mask)
    for g, w in zip(grads, want):
        np.testing.assert_array_equal(g.numpy(), w)
