"""The plain GRU and LSTM forward scans of fmda_tpu_torch against the JAX
package's, on the CPU, at the shapes that pick the forward kernels'
branches, scaled down.

On the card ``gru_scan_fwd`` / ``lstm_scan_fwd`` launch one kernel whose
plan picks W_hh in registers (H <= 32), in shared memory, in a two-CTA
cluster's shared memory or in device memory, with four lanes a hidden unit
(so H need not be a multiple of the lanes' 4-wide chunks, and a block's
last warp may be partial), and reads xp through its strides.  The card
holds each kernel to its plain version (``chip_smoke.py``); here the plain
versions, which the wrappers run on CPU tensors, are held to
``fmda_tpu.ops.gru.gru_scan`` / ``fmda_tpu.ops.lstm.lstm_scan`` (lax.scan,
with and without a mask) and to ``gru_scan_pallas`` /
``lstm_scan_pallas`` in interpret mode (the TPU kernels the CUDA ones
replace), in both directions, with nonzero h0 and c0: H = 1, 20 and 33,
T = 0 and 1, B = 1, and an xp sliced from a wider projection against its
contiguous copy.  Tolerances: 1e-5 in float32 (the frameworks sum in
different orders); 2e-2 in bfloat16, compared in the working type.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmda_tpu.ops.gru import gru_scan as jax_gru_scan
from fmda_tpu.ops.lstm import lstm_scan as jax_lstm_scan
from fmda_tpu.ops.pallas_gru import gru_scan_pallas
from fmda_tpu.ops.pallas_lstm import lstm_scan_pallas

from fmda_tpu_torch.ops import gru_kernel, lstm_kernel

F32_TOL = 1e-5
BF16_TOL = 2e-2
#: (B, T, H): one row at H = 1, 20 (not a multiple of the lanes' chunks)
#: and 33 (past the register layout, a partial last warp), one step, no
#: step, and a few rows at the model's window
SHAPES = [(1, 7, 1), (1, 7, 20), (1, 7, 33), (3, 1, 20), (2, 0, 33),
          (3, 30, 33)]
#: where the Pallas kernels run (interpret mode is slow; no empty scan)
PALLAS_SHAPES = [(1, 7, 1), (1, 7, 20), (1, 7, 33), (3, 1, 20)]
GATES = {"gru": 3, "lstm": 4}


def _inputs(cell, batch, steps, hidden, *, seed):
    """(xp, h0[, c0], w_hh, b_hh) as float32 numpy, from a seed, the
    initial states nonzero."""
    r = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(hidden)
    gh = GATES[cell] * hidden
    xp = r.normal(size=(batch, steps, gh)).astype(np.float32)
    init = [(0.5 * r.normal(size=(batch, hidden))).astype(np.float32)
            for _ in range(1 if cell == "gru" else 2)]
    w = r.uniform(-s, s, size=(gh, hidden)).astype(np.float32)
    b = r.uniform(-s, s, size=(gh,)).astype(np.float32)
    return (xp, *init, w, b)


def _ragged_mask(batch, steps, seed):
    if steps == 0:
        return np.zeros((batch, 0), bool)
    lengths = np.random.default_rng(seed).integers(1, steps + 1, size=batch)
    lengths[0] = steps
    return np.arange(steps)[None, :] < lengths[:, None]


def _port(cell, tensors, *, reverse, mask=None):
    """The port's forward through its wrapper on CPU tensors (the plain
    version): (h_last, [c_last,] hs), nothing counted as a launch."""
    module = gru_kernel if cell == "gru" else lstm_kernel
    before = module.launches
    with torch.inference_mode():
        out = getattr(module, f"{cell}_scan_fwd")(*tensors, reverse=reverse,
                                                  mask=mask)
    assert module.launches == before
    return out if cell == "gru" else (out[0], out[1], out[2])


def _jax(cell, arrays, dtype=jnp.float32, *, reverse, mask=None,
         pallas=False):
    """The JAX package's forward: (h_last, [c_last,] hs) as float32."""
    args = [jnp.asarray(a, dtype) for a in arrays]
    if pallas:
        fn = gru_scan_pallas if cell == "gru" else lstm_scan_pallas
        out = fn(*args, reverse=reverse, interpret=True)
    else:
        fn = jax_gru_scan if cell == "gru" else jax_lstm_scan
        out = fn(*args, reverse=reverse,
                 mask=None if mask is None else jnp.asarray(mask))
    flat = out if cell == "gru" else (*out[0], out[1])
    return [np.asarray(o, np.float32) for o in flat]


def _assert_close(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.float().numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=tol)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_forward_matches_lax_scan(cell, shape, reverse, masked):
    arrays = _inputs(cell, *shape, seed=sum(shape))
    mask = _ragged_mask(shape[0], shape[1], 7) if masked else None
    got = _port(cell, [torch.from_numpy(a) for a in arrays], reverse=reverse,
                mask=None if mask is None else torch.from_numpy(mask))
    _assert_close(got, _jax(cell, arrays, reverse=reverse, mask=mask),
                  F32_TOL)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("shape", PALLAS_SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_forward_matches_pallas_interpret_f32(cell, shape, reverse):
    arrays = _inputs(cell, *shape, seed=3 + sum(shape))
    got = _port(cell, [torch.from_numpy(a) for a in arrays], reverse=reverse)
    _assert_close(got, _jax(cell, arrays, reverse=reverse, pallas=True),
                  F32_TOL)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("shape", PALLAS_SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_forward_matches_pallas_interpret_bf16(cell, shape, reverse):
    """Both in bfloat16 (carries rounded each step, gate algebra in f32),
    compared in the working type."""
    arrays = _inputs(cell, *shape, seed=5 + sum(shape))
    got = _port(cell, [torch.from_numpy(a).to(torch.bfloat16)
                       for a in arrays], reverse=reverse)
    want = _jax(cell, arrays, jnp.bfloat16, reverse=reverse, pallas=True)
    for g in got:
        assert g.dtype == torch.bfloat16
    _assert_close(got, want, BF16_TOL)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("reverse", [False, True])
def test_strided_xp_matches_its_contiguous_copy(cell, reverse):
    """xp as a bidirectional layer hands it over, the second half of one
    (B, T, 2 gH) projection: the same bits as its contiguous copy, and the
    JAX forward of that copy."""
    batch, steps, hidden = 1, 30, 20
    gh = GATES[cell] * hidden
    arrays = _inputs(cell, batch, steps, hidden, seed=11)
    wide = np.random.default_rng(12).normal(
        size=(batch, steps, 2 * gh)).astype(np.float32)
    wide[..., gh:] = arrays[0]
    rest = [torch.from_numpy(a) for a in arrays[1:]]
    xp = torch.from_numpy(wide)[..., gh:]
    assert not xp.is_contiguous() and xp.stride(-1) == 1
    got = _port(cell, [xp, *rest], reverse=reverse)
    copy = _port(cell, [xp.contiguous(), *rest], reverse=reverse)
    for g, c in zip(got, copy):
        assert torch.equal(g, c)
    _assert_close(got, _jax(cell, arrays, reverse=reverse), F32_TOL)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_plain_forward_writes_the_cell_states_of_a_masked_scan(cell):
    """The LSTM's cs (which the backward reads) and either cell's hs repeat
    the carried state at masked steps, step by step."""
    batch, steps, hidden = 3, 9, 33
    arrays = _inputs(cell, batch, steps, hidden, seed=13)
    mask = _ragged_mask(batch, steps, 14)
    tensors = [torch.from_numpy(a) for a in arrays]
    module = gru_kernel if cell == "gru" else lstm_kernel
    with torch.inference_mode():
        out = getattr(module, f"{cell}_scan_reference")(
            *tensors, mask=torch.from_numpy(mask))
    seqs = out[1:] if cell == "gru" else out[2:]
    for seq in seqs:
        for b in range(batch):
            for t in range(1, steps):
                if not mask[b, t]:
                    assert torch.equal(seq[b, t], seq[b, t - 1])
