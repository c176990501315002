"""fmda_tpu_torch's GRU scan against the JAX package's, on the CPU.

The same numpy-seeded inputs go through the port's plain scan (what the
CUDA kernel's wrapper runs on CPU tensors), ``fmda_tpu.ops.gru.gru_scan``
(lax.scan) and ``gru_scan_pallas`` in interpret mode.  Tolerances: 1e-5
in float32 (two frameworks sum the hidden product in different orders);
2e-2 in bfloat16, compared in the working type, against the Pallas kernel
whose rounding the port copies (f32 gate algebra, carry rounded to bf16
each step).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fmda_tpu.ops.gru import GRUWeights as JaxGRUWeights
from fmda_tpu.ops.gru import gru_layer as jax_gru_layer
from fmda_tpu.ops.gru import gru_scan as jax_gru_scan
from fmda_tpu.ops.pallas_gru import gru_scan_pallas

from fmda_tpu_torch.ops import _cuda_lib, gru_kernel
from fmda_tpu_torch.ops.gru import GRUWeights, gru_layer, gru_scan

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _inputs(batch=4, steps=7, hidden=8, *, seed=0, nonzero_h0=False):
    r = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(hidden)
    xp = r.normal(size=(batch, steps, 3 * hidden)).astype(np.float32)
    h0 = (0.5 * r.normal(size=(batch, hidden)) if nonzero_h0
          else np.zeros((batch, hidden))).astype(np.float32)
    w = r.uniform(-s, s, size=(3 * hidden, hidden)).astype(np.float32)
    b = r.uniform(-s, s, size=(3 * hidden,)).astype(np.float32)
    return xp, h0, w, b


def _ragged_mask(batch, steps, seed=1):
    lengths = np.random.default_rng(seed).integers(1, steps + 1, size=batch)
    lengths[0] = steps  # one full row beside the ragged ones
    return np.arange(steps)[None, :] < lengths[:, None]


def _port(arrays, dtype=torch.float32, **kw):
    with torch.inference_mode():
        h_last, hs = gru_scan(*(torch.from_numpy(a).to(dtype) for a in arrays),
                              **kw)
    return h_last.float().numpy(), hs.float().numpy()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("nonzero_h0", [False, True])
def test_gru_scan_matches_lax_scan_and_pallas_interpret(reverse, nonzero_h0):
    arrays = _inputs(nonzero_h0=nonzero_h0)
    h_last, hs = _port(arrays, reverse=reverse)
    for ref_last, ref_hs in (
        jax_gru_scan(*arrays, reverse=reverse),
        gru_scan_pallas(*arrays, reverse=reverse, interpret=True),
    ):
        np.testing.assert_allclose(hs, np.asarray(ref_hs), atol=F32_TOL)
        np.testing.assert_allclose(h_last, np.asarray(ref_last), atol=F32_TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_ragged_mask_carries_hidden_through(reverse):
    arrays = _inputs(batch=5, steps=9, nonzero_h0=True, seed=2)
    mask = _ragged_mask(5, 9)
    h_last, hs = _port(arrays, reverse=reverse, mask=torch.from_numpy(mask))
    ref_last, ref_hs = jax_gru_scan(*arrays, reverse=reverse,
                                    mask=jnp.asarray(mask))
    np.testing.assert_allclose(hs, np.asarray(ref_hs), atol=F32_TOL)
    np.testing.assert_allclose(h_last, np.asarray(ref_last), atol=F32_TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_bf16_matches_pallas_interpret(reverse):
    arrays = _inputs(batch=8, steps=6, hidden=16, nonzero_h0=True, seed=3)
    h_last, hs = _port(arrays, dtype=torch.bfloat16, reverse=reverse)
    ref_last, ref_hs = gru_scan_pallas(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrays), reverse=reverse,
        interpret=True)
    np.testing.assert_allclose(
        hs, np.asarray(ref_hs, np.float32), atol=BF16_TOL)
    np.testing.assert_allclose(
        h_last, np.asarray(ref_last, np.float32), atol=BF16_TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_layer_matches_jax_gru_layer(reverse):
    r = np.random.default_rng(4)
    x = r.normal(size=(3, 6, 5)).astype(np.float32)
    hidden = 4
    s = 1.0 / np.sqrt(hidden)
    weights = [r.uniform(-s, s, size=shape).astype(np.float32)
               for shape in ((12, 5), (12, 4), (12,), (12,))]
    with torch.inference_mode():
        h_last, hs = gru_layer(
            torch.from_numpy(x),
            GRUWeights(*map(torch.from_numpy, weights)), reverse=reverse)
    ref_last, ref_hs = jax_gru_layer(x, JaxGRUWeights(*weights),
                                     reverse=reverse)
    np.testing.assert_allclose(hs.numpy(), np.asarray(ref_hs), atol=F32_TOL)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(ref_last),
                               atol=F32_TOL)


def test_wrapper_on_cpu_tensors_runs_the_plain_version_uncounted():
    tensors = [torch.from_numpy(a) for a in _inputs(nonzero_h0=True)]
    mask = torch.from_numpy(_ragged_mask(4, 7))
    before = gru_kernel.launches
    with torch.inference_mode():
        got = gru_kernel.gru_scan_fwd(*tensors, reverse=True, mask=mask)
        want = gru_kernel.gru_scan_reference(*tensors, reverse=True,
                                             mask=mask)
    assert gru_kernel.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_refuses_inputs_that_require_grad():
    xp, h0, w, b = (torch.from_numpy(a) for a in _inputs())
    w = w.requires_grad_()
    with pytest.raises(NotImplementedError, match="backward"):
        gru_kernel.gru_scan_fwd(xp, h0, w, b)
    with torch.no_grad():  # nothing would record a gradient: allowed
        gru_kernel.gru_scan_fwd(xp, h0, w, b)


def test_wrapper_refuses_mixed_devices():
    xp, h0, w, b = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        gru_kernel.gru_scan_fwd(xp, h0.to("meta"), w, b)


def test_kernel_build_is_keyed_by_source_content(tmp_path):
    src, header = tmp_path / "a.cu", tmp_path / "a.cuh"
    src.write_text("// one\n")
    header.write_text("// one\n")
    first = _cuda_lib.library_path((src, header))
    src.write_text("// two\n")
    second = _cuda_lib.library_path((src, header))
    header.write_text("// two\n")
    assert len({first, second, _cuda_lib.library_path((src, header))}) == 3
    assert first.parent.parent == _cuda_lib.BUILD_ROOT
    # every kernel source and the headers they share key the one library
    assert {p.name for p in _cuda_lib.SOURCES + _cuda_lib.HEADERS} == {
        "gru_scan.cu", "lstm_scan.cu", "scan_dw.cu", "ssm_step.cu",
        "flash_fwd.cu", "flash_fwd_plan.cc", "flash_attn.cu",
        "flash_bwd.cu", "flash_bwd_plan.cc", "scan_wide.cu",
        "gru_wide_step.cu", "lstm_persist.cu", "lstm_persist_plan.cc",
        "scan_common.cuh", "flash_fwd_plan.h", "flash_mma.cuh",
        "flash_bwd_common.cuh", "flash_bwd_plan.h", "lstm_persist_plan.h",
        "gru_wide_bwd_step.cu", "wide_tc.cuh"}
