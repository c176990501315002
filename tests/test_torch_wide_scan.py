"""fmda_tpu_torch's wide scan route against the JAX package's lax.scan path,
on the CPU.

Past the kernel pairs' envelope the port runs each recurrence as one cuBLAS
product and one fused gate kernel a step (``ops/wide_scan.py``,
``csrc/scan_wide.cu``), as the JAX package runs ``lax.scan`` past the
Pallas envelope.  Here the wrappers run the gate kernels' plain versions
(CPU tensors), and:

- the scans' forward and backward (dxp, dh0, dc0, dW_hh, db_hh) are held to
  ``fmda_tpu.ops.gru.gru_scan`` / ``lstm.lstm_scan`` and ``jax.grad`` of
  them, on numpy-seeded inputs at B = 3, T = 7, H = 48, both directions,
  masked and not, zero and nonzero h0 and c0;
- the plain gate-backward against autograd of the plain gate forward;
- ``kernel_supported`` pinned, and the sequence-parallel stage on the same
  rule;
- the BiGRU and BiLSTM at H = 1024 (B = 2, T = 5) against the JAX models,
  weights carried across by ``params_from_flax``, every step through the
  wide route;
- the bidirectional streaming core's re-scan at H = 1024 takes the wide
  route and matches the JAX core;
- the gate kernels' costs count only what each function needs;
- the elastic soak's defaults are the reference's.

Tolerances: 1e-5 in float32 (the frameworks sum in different orders); 2e-2
in bfloat16, compared in float32 (the frameworks round bf16 arithmetic at
other places: lax.scan rounds every op of its body, the port's kernels
only the carries and the gate gradients), the bf16 gradients relative to
each one's largest entry.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmda_tpu.config import FrameworkConfig as JaxFrameworkConfig
from fmda_tpu.models import build_model as jax_build_model
from fmda_tpu.ops.gru import gru_scan as jax_gru_scan
from fmda_tpu.ops.lstm import lstm_scan as jax_lstm_scan

from fmda_tpu_torch.config import FrameworkConfig
from fmda_tpu_torch.interop import params_from_flax
from fmda_tpu_torch.models import build_model
from fmda_tpu_torch.ops import _cuda_lib, gru, gru_kernel, lstm, lstm_kernel
from fmda_tpu_torch.ops import launch_counts, wide_scan

F32_TOL = 1e-5
BF16_TOL = 2e-2
B, T, H = 3, 7, 48
GATES = {"gru": 3, "lstm": 4}
DTYPES = {"float32": (torch.float32, jnp.float32, F32_TOL),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}


def _inputs(cell, *, nonzero_init, seed=0):
    """(xp, h0[, c0], w_hh, b_hh) and the cotangents of (h_last[, c_last],
    hs), float32 numpy from a seed."""
    r = np.random.default_rng(seed)
    gh, s = GATES[cell] * H, 1.0 / np.sqrt(H)
    states = 1 if cell == "gru" else 2
    xp = r.normal(size=(B, T, gh)).astype(np.float32)
    init = [(0.5 * r.normal(size=(B, H)) * nonzero_init).astype(np.float32)
            for _ in range(states)]
    w = r.uniform(-s, s, size=(gh, H)).astype(np.float32)
    b = r.uniform(-s, s, size=(gh,)).astype(np.float32)
    cots = [r.normal(size=(B, H)).astype(np.float32) for _ in range(states)]
    cots.append(r.normal(size=(B, T, H)).astype(np.float32))
    return [xp, *init, w, b], cots


def _mask(seed=3):
    lengths = np.random.default_rng(seed).integers(1, T + 1, size=B)
    lengths[0] = T
    return np.arange(T)[None, :] < lengths[:, None]


def _jax_outputs(cell, args, mask, reverse):
    m = None if mask is None else jnp.asarray(mask)
    if cell == "gru":
        h_last, hs = jax_gru_scan(*args, reverse=reverse, mask=m)
        return [h_last, hs]
    (h_last, c_last), hs = jax_lstm_scan(*args, reverse=reverse, mask=m)
    return [h_last, c_last, hs]


def _port_outputs(cell, args, mask, reverse):
    m = None if mask is None else torch.from_numpy(mask)
    if cell == "gru":
        return list(wide_scan.gru_wide_scan(*args, reverse=reverse, mask=m))
    (h_last, c_last), hs = wide_scan.lstm_wide_scan(*args, reverse=reverse,
                                                    mask=m)
    return [h_last, c_last, hs]


CASES = [(cell, reverse, masked, nonzero)
         for cell in ("gru", "lstm") for reverse in (False, True)
         for masked in (False, True) for nonzero in (False, True)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cell,reverse,masked,nonzero", CASES)
def test_wide_forward_matches_lax_scan(cell, reverse, masked, nonzero,
                                       dtype):
    tdtype, jdtype, tol = DTYPES[dtype]
    arrays, _ = _inputs(cell, nonzero_init=nonzero)
    mask = _mask() if masked else None
    want = _jax_outputs(cell, [jnp.asarray(a, jdtype) for a in arrays],
                        mask, reverse)
    with torch.inference_mode():
        got = _port_outputs(cell, [torch.from_numpy(a).to(tdtype)
                                   for a in arrays], mask, reverse)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == tdtype
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cell,reverse,masked,nonzero", CASES)
def test_wide_backward_matches_jax_grad(cell, reverse, masked, nonzero,
                                        dtype):
    """dxp, dh0 (, dc0), dW_hh and db_hh of the loss sum(cot * outputs),
    through the wide route's autograd Function, against jax.grad of the
    same loss through lax.scan, at unit cotangents.  In bfloat16 the
    port's inputs and cotangents are rounded to bf16 and jax.grad runs
    lax.scan in float32 on those same values: the bf16 problem's gradient.
    (jax.grad of the bf16 lax.scan itself carries dW_hh and db_hh across
    the steps in bf16 and misses that gradient by up to 0.038; the port,
    which sums them in one product, by at most 0.013.)  The port's bf16
    gradients come back in bf16, so each is held to the tolerance
    relative to its own largest entry (spacing past 4 is 0.031): a
    rounding misplaced in the bf16 backward moves an entry by far more
    than 2 % of the largest."""
    tdtype, jdtype, tol = DTYPES[dtype]
    arrays, cots = _inputs(cell, nonzero_init=nonzero, seed=1)
    mask = _mask(seed=5) if masked else None
    if tdtype is torch.bfloat16:  # the bf16 values, exactly, in float32
        arrays, cots = ([torch.from_numpy(a).to(tdtype).float().numpy()
                         for a in group] for group in (arrays, cots))
    jcots = [jnp.asarray(c) for c in cots]

    def loss(*args):
        outs = _jax_outputs(cell, args, mask, reverse)
        return sum(jnp.sum(o * c) for o, c in zip(outs, jcots))

    want = jax.grad(loss, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    args = [torch.from_numpy(a).to(tdtype).requires_grad_()
            for a in arrays]
    outs = _port_outputs(cell, args, mask, reverse)
    total = sum(torch.sum((o * torch.from_numpy(c).to(tdtype)).float())
                for o, c in zip(outs, cots))
    got = torch.autograd.grad(total, args)
    names = ["dxp", "dh0"] + (["dc0"] if cell == "lstm" else []) + [
        "dw_hh", "db_hh"]
    for name, g, w in zip(names, got, want):
        assert g.dtype == tdtype, name
        w = np.asarray(w, np.float32)
        scale = float(np.abs(w).max()) if tdtype is torch.bfloat16 else 1.0
        np.testing.assert_allclose(g.float().numpy(), w, atol=tol * scale,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("with_prod", [False, True])
def test_plain_gate_backward_matches_autograd(cell, masked, with_prod):
    """Each gate-backward plain version against autograd of its forward's
    plain version, in float32, from the step's cotangent (direct + prod +
    dhs_t) and, for the LSTM, the carried dc.  The LSTM's direct part is
    given as the scan gives it (at its first processed step, no product
    yet, or under a mask) and returned only under a mask: elsewhere
    autograd finds h_{t-1} no gradient."""
    r = np.random.default_rng(7)
    gh = GATES[cell] * H

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * r.normal(size=shape)).astype(
            np.float32))

    xp_t, hh_t, h_prev, c_prev = t(B, gh), t(B, gh), t(B, H, scale=0.5), \
        t(B, H, scale=0.5)
    direct, dhs_t, dc = t(B, H), t(B, H), t(B, H)
    prod = t(B, H) if with_prod else None
    mask_t = (torch.from_numpy(_mask()[:, 2].astype(np.uint8))
              if masked else None)
    dh = direct + dhs_t + (prod if with_prod else 0.0)
    leaves = [x.clone().requires_grad_() for x in (xp_t, hh_t, h_prev,
                                                   c_prev)]
    if cell == "gru":
        h = wide_scan.gru_wide_gates_reference(*leaves[:3], mask_t)
        want = torch.autograd.grad((h * dh).sum(), leaves[:3])
        got = wide_scan.gru_wide_gates_bwd_reference(
            xp_t, hh_t, h_prev, direct, prod, dhs_t, mask_t)
        pairs = list(zip(got, want))  # dxp, dhh, direct part of dh_{t-1}
    else:
        if with_prod and not masked:
            direct = None
            dh = dhs_t + prod
        h, c = wide_scan.lstm_wide_gates_reference(*leaves, mask_t)
        # h_{t-1} reaches a step that runs only through hh_t: no gradient
        want = [torch.zeros(B, H) if g is None else g
                for g in torch.autograd.grad(
                    (h * dh).sum() + (c * dc).sum(), leaves,
                    allow_unused=True)]
        with torch.no_grad():
            c_t = wide_scan.lstm_wide_gates_reference(
                xp_t, hh_t, h_prev, c_prev, mask_t)[1]
        dxp, new_direct, new_dc = wide_scan.lstm_wide_gates_bwd_reference(
            xp_t, hh_t, c_prev, c_t, direct, prod, dhs_t, dc, mask_t)
        pairs = [(dxp, want[0]), (dxp, want[1]), (new_dc, want[3])]
        if masked:
            pairs.append((new_direct, want[2]))
        else:
            assert new_direct is None
            assert not want[2].any()
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=F32_TOL)


@pytest.mark.parametrize("module", [gru_kernel, lstm_kernel])
def test_kernel_supported_pinned(module):
    supported = module.kernel_supported
    # the models' widths keep the kernel pair, at the train and serve
    # batches
    assert supported(256, 30, 32, 4) and supported(1, 30, 32, 4)
    assert supported(256, 30, 32, 2)
    # flagship_wide: H = 1024, bf16, batch 512
    assert not supported(512, 30, 1024, 2)
    assert not supported(512, 30, 1024, 4)
    # where the forward's plan would read W_hh from device memory
    assert not supported(256, 30, 512, 4)
    assert not supported(256, 30, 256, 4)
    # where the forward holds W_hh in shared memory or a cluster's
    assert supported(512, 30, 128, 2) and supported(1, 30, 128, 4)


def test_kernel_supported_off_the_device_branch():
    """The pair keeps the shapes where its forward holds W_hh on chip even
    where its backward sweep reads W_hh from L2 (the crossover's callers
    waited less there): GRU bf16 H = 256 and LSTM f32 H = 128, both on
    the cluster branch."""
    assert _cuda_lib.fwd_branch(3, 256, 2) == "cluster"
    assert gru_kernel.kernel_supported(256, 30, 256, 2)
    assert _cuda_lib.fwd_branch(4, 128, 4) == "cluster"
    assert lstm_kernel.kernel_supported(256, 30, 128, 4)


@pytest.mark.parametrize("hidden", [513, 768, 1024])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_lstm_above_512_takes_the_wide_route(hidden, itemsize):
    assert not lstm_kernel.kernel_supported(256, 30, hidden, itemsize)
    assert lstm.select_lstm_scan_fn((256, 30, hidden), itemsize) \
        is wide_scan.lstm_wide_scan


@pytest.mark.parametrize("gates,max_hidden", [(3, 1024), (4, 512)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_rule_is_never_true_on_the_device_branch(gates, max_hidden,
                                                 itemsize):
    """Wherever the forward's plan takes its device-memory branch, or the
    hidden limit is passed, the rule sends the scan to the wide route;
    everywhere else it keeps the kernel pair."""
    module = gru_kernel if gates == 3 else lstm_kernel
    for hidden in range(1, 1100, 7):
        branch = _cuda_lib.fwd_branch(gates, hidden, itemsize)
        assert module.kernel_supported(8, 30, hidden, itemsize) == (
            branch != "device" and hidden <= max_hidden)


def test_fwd_branch_pinned():
    """scan_common.cuh's plan, at the widths its comments name: registers
    at H <= 32, shared memory at GRU H = 128 f32, a cluster at LSTM H =
    128 f32, device memory at H = 512."""
    assert _cuda_lib.fwd_branch(3, 32, 4) == "reg"
    assert _cuda_lib.fwd_branch(3, 64, 4) == "smem"
    assert _cuda_lib.fwd_branch(3, 128, 4) == "smem"
    assert _cuda_lib.fwd_branch(4, 128, 4) == "cluster"
    assert _cuda_lib.fwd_branch(4, 128, 2) == "smem"
    assert _cuda_lib.fwd_branch(3, 512, 4) == "device"
    assert _cuda_lib.fwd_branch(4, 512, 2) == "device"


def test_sp_stage_uses_the_same_rule(monkeypatch):
    """The sequence-parallel stage's default recurrence is the routed
    scan, which asks ``select_scan_fn`` for the local block's shape."""
    from fmda_tpu_torch.parallel import seq_parallel

    for fn in (seq_parallel.sp_gru_scan, seq_parallel.sp_gru_scan_pipelined,
               seq_parallel.sp_bigru_layer_dirs, seq_parallel.sp_bigru_layer):
        assert inspect.signature(fn).parameters["scan_fn"].default \
            is gru.routed_gru_scan
    asked = []
    real = gru.select_scan_fn
    monkeypatch.setattr(gru, "select_scan_fn",
                        lambda shape, itemsize: asked.append(
                            (shape, itemsize)) or real(shape, itemsize))
    for hidden, route in ((32, gru.gru_scan), (1024, gru.gru_wide_scan)):
        xp = torch.zeros(2, 5, 3 * hidden)
        h0 = torch.zeros(2, hidden)
        w, b = torch.zeros(3 * hidden, hidden), torch.zeros(3 * hidden)
        with torch.inference_mode():
            gru.routed_gru_scan(xp, h0, w, b)
        assert asked[-1] == ((2, 5, hidden), 4)
        assert real(*asked[-1]) is route


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_wide_models_match_jax(cell, monkeypatch):
    """The BiGRU and BiLSTM at H = 1024 (the defaults otherwise: F = 108,
    one bidirectional layer), B = 2, T = 5, through the port's CPU path,
    against the JAX model on the same flax params; every step of both
    directions through the wide route: the GRU's gate step, the LSTM's
    persistent scan (its plan lays H = 1024 out), one a direction."""
    fields = dict(cell=cell, hidden_size=1024)
    jax_cfg = dataclasses.replace(JaxFrameworkConfig().model, **fields)
    cfg = dataclasses.replace(FrameworkConfig().model, **fields)
    jax_model = jax_build_model(jax_cfg)
    params = jax.device_get(jax_model.init(
        {"params": jax.random.PRNGKey(2)},
        jnp.zeros((1, 5, cfg.n_features)))["params"])
    port = build_model(cfg)
    port.load_state_dict(params_from_flax(params), strict=True)
    port.eval()
    name = "gru_wide_gates" if cell == "gru" else "lstm_persist_fwd"
    steps = []
    real = getattr(wide_scan, name)
    monkeypatch.setattr(wide_scan, name,
                        lambda *a, **k: steps.append(1) or real(*a, **k))
    x = np.random.default_rng(9).normal(
        size=(2, 5, cfg.n_features)).astype(np.float32)
    want = jax_model.apply({"params": params}, x)
    before = launch_counts()
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    # two directions of five gate steps, or of one persistent scan
    assert len(steps) == 2 * (5 if cell == "gru" else 1)
    assert launch_counts() == before  # CPU tensors launch nothing
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_bidirectional_stream_at_width_takes_the_wide_route(cell,
                                                            monkeypatch):
    """The bidirectional streaming core at H = 1024 (the LSTM's pair stops
    at 512): its backward re-scan asks the family's selector and takes the
    wide route, a gate step a ring slot, and the probabilities match the
    JAX core's tick by tick (the LSTM's re-scan one persistent scan a
    tick)."""
    from fmda_tpu.config import ModelConfig as JaxModelConfig
    from fmda_tpu.data.normalize import NormParams as JaxNormParams
    from fmda_tpu.serve.streaming import (
        StreamingBiGRUBidirectional as JaxStreamingBiGRUBidirectional)

    from fmda_tpu_torch.config import ModelConfig
    from fmda_tpu_torch.data.normalize import NormParams
    from fmda_tpu_torch.serve import StreamingBiGRUBidirectional

    feats, window, ticks = 6, 3, 5
    fields = dict(hidden_size=1024, n_features=feats, output_size=4,
                  dropout=0.0, bidirectional=True, cell=cell)
    jax_cfg = JaxModelConfig(use_pallas=False, **fields)
    params = jax.device_get(jax_build_model(jax_cfg).init(
        {"params": jax.random.PRNGKey(4)},
        jnp.zeros((1, window, feats)))["params"])
    r = np.random.default_rng(11)
    x_min = r.normal(size=feats).astype(np.float32)
    x_max = x_min + r.uniform(1.0, 5.0, size=feats).astype(np.float32)
    rows = (3.0 * r.normal(size=(ticks, feats))).astype(np.float32)
    jax_core = JaxStreamingBiGRUBidirectional(
        jax_cfg, params, JaxNormParams(x_min, x_max), window=window)
    core = StreamingBiGRUBidirectional(
        ModelConfig(**fields), params_from_flax(params),
        NormParams(x_min, x_max), window=window, device="cpu")
    name = "gru_wide_gates" if cell == "gru" else "lstm_persist_fwd"
    steps = []
    real = getattr(wide_scan, name)
    monkeypatch.setattr(wide_scan, name,
                        lambda *a, **k: steps.append(1) or real(*a, **k))
    for t, row in enumerate(rows):
        np.testing.assert_allclose(core.step(row), jax_core.step(row),
                                   atol=F32_TOL, err_msg=f"tick {t}")
    # the re-scan: a gate step a ring slot, or one persistent scan
    assert len(steps) == ticks * (window if cell == "gru" else 1)


@pytest.mark.parametrize("masked", [False, True])
def test_gate_costs_count_what_each_function_needs(masked):
    """Bytes of one step at (B, H) in bf16 (a mask adds its B bytes): the
    LSTM forward reads h_{t-1} only under a mask; the LSTM backward reads
    its float32 direct part only where it is given and writes it only
    under a mask; the GRU's reads and writes it always."""
    from fmda_tpu_torch.ops.cost import wide_gates_cost

    b, h, i = 4, 8, 2
    m = b if masked else 0

    def moved(cell, **kw):
        return wide_gates_cost(cell, b, h, i, masked, **kw).bytes_moved

    # forward: xp_t and hh_t, the states read, the states written
    assert moved("gru") == i * b * (2 * 3 * h + h + h) + m
    assert moved("lstm") == i * b * (2 * 4 * h + (2 if masked else 1) * h
                                     + 2 * h) + m
    # backward at a later step (a product given): xp_t, hh_t, the states,
    # dhs_t and the product read, dxp_t (and the GRU's dhh_t) written
    gru_io = i * b * (2 * 3 * h + 3 * h + 2 * 3 * h)
    lstm_io = i * b * (2 * 4 * h + 4 * h + 4 * h)
    assert moved("gru", backward=True) == gru_io + 4 * b * 2 * h + m
    assert moved("lstm", backward=True, direct=masked) == (
        lstm_io + 4 * b * (2 + (2 if masked else 0)) * h + m)
    # the first processed step: no product, the direct part (dh_last) read
    assert moved("lstm", backward=True, prod=False, direct=True) == (
        lstm_io - i * b * h + 4 * b * (3 + (1 if masked else 0)) * h + m)


def test_elastic_soak_defaults_are_the_references(monkeypatch):
    """run_elastic_soak() with no arguments runs both topologies at the
    reference's retire threshold (0.5), both paced."""
    from fmda_tpu_torch.control import elastic

    calls = []
    monkeypatch.setattr(elastic, "_run_topology",
                        lambda schedule, **kw: calls.append(kw) or dict(
                            schedule=[]))
    monkeypatch.setattr(elastic, "_gate_report",
                        lambda run, min_workers: dict(gates={}))
    monkeypatch.setattr(elastic, "_identity_verdict",
                        lambda a, b: dict(ok=True))
    report = elastic.run_elastic_soak()
    assert report["gates_ok"]
    assert [(kw["elastic"], kw["scale_down_frac"], kw["paced"])
            for kw in calls] == [(True, 0.5, True), (False, 0.5, True)]
