"""The two parts of fmda_tpu_torch's GRU and LSTM backward scans against the
JAX package's backward, on the CPU.

On the card a backward scan is two kernels: a serial sweep (dxp, dh0, and
dc0 for the LSTM; for the GRU also ``dgn``, dg_h's n slice), then the
weight gradient (``scan_dw``: dW_hh and db_hh from the sweep's output).
Here their plain versions (what the wrappers run on CPU tensors) are
composed and held to ``jax.vjp`` of ``fmda_tpu.ops.gru.gru_scan`` /
``fmda_tpu.ops.lstm.lstm_scan`` (lax.scan, with and without a mask) and of
``gru_scan_pallas`` / ``lstm_scan_pallas`` in interpret mode (the TPU
kernel pairs, whose rounding the port copies), in both directions, with
nonzero h0, c0, dh_last and dc_last.  Tolerances: 1e-5 in float32 (the
frameworks sum in different orders); 2e-2 in bfloat16, compared in the
working type.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmda_tpu.ops.gru import gru_scan as jax_gru_scan
from fmda_tpu.ops.lstm import lstm_scan as jax_lstm_scan
from fmda_tpu.ops.pallas_gru import gru_scan_pallas
from fmda_tpu.ops.pallas_lstm import lstm_scan_pallas

from fmda_tpu_torch.ops import gru_kernel, lstm_kernel, scan_dw

F32_TOL = 1e-5
BF16_TOL = 2e-2
#: (B, T, H): small, the model's window and width, one row, one step
SHAPES = [(3, 7, 16), (5, 30, 32), (1, 7, 8), (4, 1, 16)]
#: where the Pallas pair runs in bfloat16 too (interpret mode is slow)
BF16_SHAPES = [(3, 7, 16), (5, 30, 32)]
GATES = {"gru": 3, "lstm": 4}
NAMES = {"gru": ("dxp", "dh0", "dw_hh", "db_hh"),
         "lstm": ("dxp", "dh0", "dc0", "dw_hh", "db_hh")}


def _inputs(cell, batch, steps, hidden, *, seed):
    """The forward's inputs (xp, h0[, c0], w_hh, b_hh) and the cotangents
    of its outputs (h_last[, c_last], hs), from a seed, all nonzero."""
    r = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(hidden)
    gh = GATES[cell] * hidden
    states = 1 if cell == "gru" else 2
    xp = r.normal(size=(batch, steps, gh)).astype(np.float32)
    init = [(0.5 * r.normal(size=(batch, hidden))).astype(np.float32)
            for _ in range(states)]
    w = r.uniform(-s, s, size=(gh, hidden)).astype(np.float32)
    b = r.uniform(-s, s, size=(gh,)).astype(np.float32)
    lasts = [r.normal(size=(batch, hidden)).astype(np.float32)
             for _ in range(states)]
    dhs = r.normal(size=(batch, steps, hidden)).astype(np.float32)
    return (xp, *init, w, b), (*lasts, dhs)


def _ragged_mask(batch, steps, seed):
    lengths = np.random.default_rng(seed).integers(1, steps + 1, size=batch)
    lengths[0] = steps  # one full row beside the ragged ones
    return np.arange(steps)[None, :] < lengths[:, None]


def _parts(cell, arrays, cotangents, dtype=torch.float32, *, reverse,
           mask=None):
    """The port's sweep and weight gradient, run through their wrappers on
    CPU tensors (their plain versions), on the port's plain forward's hs
    (and cs).  Returns (the sweep's outputs, (dw_hh, db_hh), hs) as
    tensors; nothing is counted as a launch."""
    tensors = [torch.from_numpy(a).to(dtype) for a in arrays]
    cots = [torch.from_numpy(a).to(dtype) for a in cotangents]
    m = None if mask is None else torch.from_numpy(mask)
    before = (scan_dw.launches, gru_kernel.bwd_launches,
              lstm_kernel.bwd_launches)
    with torch.inference_mode():
        if cell == "gru":
            _, hs = gru_kernel.gru_scan_reference(*tensors, reverse=reverse,
                                                  mask=m)
            swept = gru_kernel.gru_scan_bwd_sweep(
                *tensors, hs, *cots, reverse=reverse, mask=m)
            dw = scan_dw.scan_dw(swept[0], tensors[1], hs, reverse=reverse,
                                 tail=swept[1])
        else:
            _, _, hs, cs = lstm_kernel.lstm_scan_reference(
                *tensors, reverse=reverse, mask=m)
            swept = lstm_kernel.lstm_scan_bwd_sweep(
                *tensors, hs, cs, *cots, reverse=reverse, mask=m)
            dw = scan_dw.scan_dw(swept[0], tensors[1], hs, reverse=reverse)
    assert (scan_dw.launches, gru_kernel.bwd_launches,
            lstm_kernel.bwd_launches) == before
    return swept, dw, hs


def _composed(cell, arrays, cotangents, dtype=torch.float32, *, reverse,
              mask=None):
    """The backward's gradients from the two parts, in the order jax.vjp
    gives them, as float32 numpy: (dxp, dh0[, dc0], dw_hh, db_hh), dh0,
    dc0, dw_hh and db_hh rounded to the working type as the backward
    returns them."""
    swept, (dw, db), _ = _parts(cell, arrays, cotangents, dtype,
                                reverse=reverse, mask=mask)
    states = swept[2:] if cell == "gru" else swept[1:]
    grads = [swept[0], *(s.to(dtype) for s in states), dw.to(dtype),
             db.to(dtype)]
    return [g.float().numpy() for g in grads]


def _jax_grads(cell, fn, arrays, cotangents, dtype=jnp.float32):
    args = [jnp.asarray(a, dtype) for a in arrays]
    cots = [jnp.asarray(a, dtype) for a in cotangents]
    _, vjp = jax.vjp(fn, *args)
    out = (vjp((cots[0], cots[1])) if cell == "gru"
           else vjp(((cots[0], cots[1]), cots[2])))
    return [np.asarray(g, np.float32) for g in out]


def _jax_fn(cell, *, reverse, mask=None, pallas=False):
    if pallas:
        fn = gru_scan_pallas if cell == "gru" else lstm_scan_pallas
        return lambda *a: fn(*a, reverse=reverse, interpret=True)
    fn = jax_gru_scan if cell == "gru" else jax_lstm_scan
    m = None if mask is None else jnp.asarray(mask)
    return lambda *a: fn(*a, reverse=reverse, mask=m)


def _assert_close(cell, got, want, tol):
    assert len(got) == len(want) == len(NAMES[cell])
    for name, g, w in zip(NAMES[cell], got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=tol, err_msg=name)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_parts_compose_to_vjp_of_lax_scan(cell, shape, reverse, masked):
    arrays, cotangents = _inputs(cell, *shape, seed=1)
    mask = _ragged_mask(*shape[:2], seed=2) if masked else None
    got = _composed(cell, arrays, cotangents, reverse=reverse, mask=mask)
    want = _jax_grads(cell, _jax_fn(cell, reverse=reverse, mask=mask),
                      arrays, cotangents)
    _assert_close(cell, got, want, F32_TOL)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_parts_compose_to_vjp_of_pallas_interpret_f32(cell, shape, reverse):
    arrays, cotangents = _inputs(cell, *shape, seed=3)
    got = _composed(cell, arrays, cotangents, reverse=reverse)
    want = _jax_grads(cell, _jax_fn(cell, reverse=reverse, pallas=True),
                      arrays, cotangents)
    _assert_close(cell, got, want, F32_TOL)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("shape", BF16_SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_parts_compose_to_vjp_of_pallas_interpret_bf16(cell, shape,
                                                      reverse):
    arrays, cotangents = _inputs(cell, *shape, seed=4)
    got = _composed(cell, arrays, cotangents, torch.bfloat16,
                    reverse=reverse)
    want = _jax_grads(cell, _jax_fn(cell, reverse=reverse, pallas=True),
                      arrays, cotangents, jnp.bfloat16)
    _assert_close(cell, got, want, BF16_TOL)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("reverse", [False, True])
def test_the_composition_is_the_backward(cell, reverse):
    """<cell>_scan_bwd on CPU tensors (its plain version) is the two parts
    composed, bit for bit."""
    arrays, cotangents = _inputs(cell, 3, 7, 16, seed=5)
    tensors = [torch.from_numpy(a) for a in arrays]
    cots = [torch.from_numpy(a) for a in cotangents]
    with torch.inference_mode():
        if cell == "gru":
            _, hs = gru_kernel.gru_scan_reference(*tensors, reverse=reverse)
            whole = gru_kernel.gru_scan_bwd(*tensors, hs, *cots,
                                            reverse=reverse)
        else:
            _, _, hs, cs = lstm_kernel.lstm_scan_reference(*tensors,
                                                           reverse=reverse)
            whole = lstm_kernel.lstm_scan_bwd(*tensors, hs, cs, *cots,
                                              reverse=reverse)
    got = _composed(cell, arrays, cotangents, reverse=reverse)
    for name, g, w in zip(NAMES[cell], got, whole):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_dw_operand_is_rounded_dn_pre_times_r_not_dxps_n_slice(
        reverse):
    """The GRU's hidden projection sees dn_pre through the reset gate: its
    weight gradient's n slice must come from the sweep's round(dn_pre r)
    (dgn).  dxp's n slice, round(dn_pre), misses JAX's dW_hh in bf16 by
    far more than the tolerance; dgn meets it."""
    batch, steps, hidden = 3, 7, 16
    arrays, cotangents = _inputs("gru", batch, steps, hidden, seed=6)
    swept, (dw, _), hs = _parts("gru", arrays, cotangents, torch.bfloat16,
                                reverse=reverse)
    h0 = torch.from_numpy(arrays[1]).to(torch.bfloat16)
    with torch.inference_mode():
        wrong, _ = scan_dw.scan_dw(swept[0], h0, hs, reverse=reverse)
    want = _jax_grads("gru", _jax_fn("gru", reverse=reverse, pallas=True),
                      arrays, cotangents, jnp.bfloat16)[2]
    n = slice(2 * hidden, 3 * hidden)
    right_err = np.abs(dw.to(torch.bfloat16).float().numpy() - want).max()
    wrong_err = np.abs(
        wrong.to(torch.bfloat16).float().numpy()[n] - want[n]).max()
    assert right_err <= BF16_TOL
    assert wrong_err > 10 * BF16_TOL
    # and the two operands differ exactly where the gate r is applied
    assert not torch.equal(swept[0][..., n], swept[1])


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("reverse", [False, True])
def test_masked_steps_add_nothing_to_dw_or_db(cell, reverse):
    """A masked step's gate gradient is written as zeros, and dW_hh and
    db_hh are the sums over the unmasked (b, t) rows alone."""
    batch, steps, hidden = 5, 30, 32
    arrays, cotangents = _inputs(cell, batch, steps, hidden, seed=7)
    mask = _ragged_mask(batch, steps, seed=8)
    swept, (dw, db), hs = _parts(cell, arrays, cotangents, reverse=reverse,
                                 mask=mask)
    dg = swept[0].numpy()
    if cell == "gru":
        dgn = swept[1].numpy()
        assert not dgn[~mask].any()
        dg = np.concatenate([dg[..., :2 * hidden], dgn], axis=-1)
    assert not swept[0].numpy()[~mask].any()
    h_prev = scan_dw.h_prev_of(torch.from_numpy(arrays[1]), hs,
                               reverse=reverse).numpy()
    kept = mask.reshape(-1)
    rows = dg.reshape(-1, dg.shape[-1])[kept].astype(np.float64)
    hp = h_prev.reshape(-1, hidden)[kept].astype(np.float64)
    np.testing.assert_allclose(dw.numpy(), rows.T @ hp, atol=F32_TOL)
    np.testing.assert_allclose(db.numpy(), rows.sum(axis=0), atol=F32_TOL)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_parts_take_an_empty_sequence(cell):
    """T = 0: no step, so dxp is empty, dh0 (and dc0) are the last states'
    cotangents and the weight gradient is zero."""
    arrays, cotangents = _inputs(cell, 3, 0, 8, seed=9)
    swept, (dw, db), _ = _parts(cell, arrays, cotangents, reverse=False)
    assert swept[0].shape == (3, 0, GATES[cell] * 8)
    states = swept[2:] if cell == "gru" else swept[1:]
    for got, want in zip(states, cotangents):
        np.testing.assert_array_equal(got.numpy(), want)
    assert not dw.any() and not db.any()
    assert dw.shape == (GATES[cell] * 8, 8) and db.shape == (GATES[cell] * 8,)


def test_scan_dw_refuses_mixed_devices():
    arrays, _ = _inputs("lstm", 2, 3, 4, seed=10)
    dg = torch.zeros(2, 3, 16)
    hs = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        scan_dw.scan_dw(dg, torch.from_numpy(arrays[1]), hs.to("meta"))
