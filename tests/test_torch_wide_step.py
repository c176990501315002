"""fmda_tpu_torch's fused GRU step (``ops/gru_wide_step.py``,
``csrc/gru_wide_step.cu``) against the JAX package's lax.scan path, on the
CPU.

Where its plan lays a step out (bf16, H a multiple of 64), the GRU wide
route runs each forward step as one launch: the product h_{t-1} W_hh^T and
the gate algebra together.  Here the wrapper runs its plain version (CPU
tensors), and:

- the plan's Python copy is pinned at the H100's figures: which (B, H,
  dtype) it lays out, its tile and cluster at B = 1, 256 and 512, float32
  and a ragged H handed back;
- ``gru_wide_scan_fwd`` walks the fused route and matches
  ``fmda_tpu.ops.gru.gru_scan`` at B 1-8, H 64-128, T 5, both directions,
  masked and not, bf16 and float32 (the route forced where the card's plan
  hands the shape back), and ``jax.grad`` of it through the unchanged
  backward;
- the plain step rounds hh as the backward's ``_recompute_hh`` does;
- the BiGRU at H = 1024 in bf16 against the JAX model, every forward step
  on the fused route;
- the cost counts the product and W_hh once; the counter is registered and
  a CPU call launches nothing; a tensor off the CPU and off a card raises.

Tolerances as ``test_torch_wide_scan.py``'s: 1e-5 in float32, 2e-2 in
bfloat16 compared in float32 (bf16 gradients relative to each one's
largest entry).
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmda_tpu.config import FrameworkConfig as JaxFrameworkConfig
from fmda_tpu.models import build_model as jax_build_model
from fmda_tpu.ops.gru import gru_scan as jax_gru_scan

from fmda_tpu_torch.config import FrameworkConfig
from fmda_tpu_torch.interop import params_from_flax
from fmda_tpu_torch.models import build_model
from fmda_tpu_torch.ops import (
    LAUNCH_COUNTERS, _cuda_lib, gru_wide_step, launch_counts, wide_scan)
from fmda_tpu_torch.ops.cost import (
    LAUNCH_COSTS, gru_wide_step_bound, gru_wide_step_cost)

F32_TOL = 1e-5
BF16_TOL = 2e-2
T = 5
DTYPES = {"float32": (torch.float32, jnp.float32, F32_TOL),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}
H100 = _cuda_lib.H100_FIGURES
SMEM = gru_wide_step.STEP_SMEM


def _plan(**fields):
    return dict(fields, smem=SMEM)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,hidden,want", [
    # flagship_wide's step: 8 x 16 tiles, W_hh multicast along the batch
    (512, 1024, _plan(tiles_m=8, tiles_n=16, mcast=2, split=1, cluster=2,
                      k_steps=16, grid=128)),
    # a ragged last batch of the same epoch
    (483, 1024, _plan(tiles_m=8, tiles_n=16, mcast=2, split=1, cluster=2,
                      k_steps=16, grid=128)),
    # the Predictor's and the stream's B = 1: 16 tiles, K split over 4
    (1, 1024, _plan(tiles_m=1, tiles_n=16, mcast=1, split=4, cluster=4,
                    k_steps=4, grid=64)),
    (256, 1024, _plan(tiles_m=4, tiles_n=16, mcast=1, split=2, cluster=2,
                      k_steps=8, grid=128)),
    # an odd number of batch tiles past half the SMs: one CTA a cluster
    (800, 1024, _plan(tiles_m=13, tiles_n=16, mcast=1, split=1, cluster=1,
                      k_steps=16, grid=208)),
    (1, 64, _plan(tiles_m=1, tiles_n=1, mcast=1, split=1, cluster=1,
                  k_steps=1, grid=1)),
    (8, 512, _plan(tiles_m=1, tiles_n=8, mcast=1, split=8, cluster=8,
                   k_steps=1, grid=64)),
    (1, 2048, _plan(tiles_m=1, tiles_n=32, mcast=1, split=2, cluster=2,
                    k_steps=16, grid=64)),
])
def test_plan_pinned_at_the_h100(batch, hidden, want):
    assert gru_wide_step.step_plan(batch, hidden, 2, **H100) == want
    assert gru_wide_step.gru_wide_step_plan(
        batch, hidden, torch.bfloat16, torch.device("cpu")) == want


@pytest.mark.parametrize("batch,hidden,itemsize", [
    (512, 1024, 4), (1, 1024, 4), (256, 512, 4),  # float32: the pair's
    (512, 1000, 2), (512, 96, 2), (3, 48, 2), (512, 32, 2)])  # ragged H
def test_plan_hands_back_float32_and_ragged_widths(batch, hidden, itemsize):
    assert gru_wide_step.step_plan(batch, hidden, itemsize, **H100) is None


@pytest.mark.parametrize("batch", [1, 2, 63, 64, 65, 128, 256, 300, 512,
                                   1024, 2049])
@pytest.mark.parametrize("hidden", [64, 256, 1024, 2048])
def test_every_plan_fits_the_card(batch, hidden):
    """Every laid-out plan tiles the step exactly, splits K evenly, uses
    clusters the card holds and, where K is split, stays within one wave
    of the SMs."""
    p = gru_wide_step.step_plan(batch, hidden, 2, **H100)
    assert p["tiles_m"] * 64 >= batch > (p["tiles_m"] - 1) * 64
    assert p["tiles_n"] * 64 == hidden
    assert p["k_steps"] * p["split"] * 64 == hidden
    assert 1 in (p["mcast"], p["split"])
    assert p["cluster"] == p["mcast"] * p["split"] <= 8
    assert p["grid"] == p["tiles_m"] * p["tiles_n"] * p["split"]
    assert p["mcast"] == 1 or p["tiles_m"] % 2 == 0
    if p["split"] > 1:
        assert p["grid"] <= H100["sms"]
        assert p["tiles_m"] * p["tiles_n"] <= H100["clusters"][p["split"]]
    assert p["smem"] <= H100["smem"]


# ---------------------------------------------------------------------------
# the route against lax.scan and jax.grad
# ---------------------------------------------------------------------------


def _inputs(batch, hidden, *, seed):
    """(xp, h0, w_hh, b_hh) and the cotangents of (h_last, hs), float32
    numpy from a seed."""
    r = np.random.default_rng(seed)
    gh, s = 3 * hidden, 1.0 / np.sqrt(hidden)
    arrays = [r.normal(size=(batch, T, gh)).astype(np.float32),
              (0.5 * r.normal(size=(batch, hidden))).astype(np.float32),
              r.uniform(-s, s, size=(gh, hidden)).astype(np.float32),
              r.uniform(-s, s, size=(gh,)).astype(np.float32)]
    cots = [r.normal(size=(batch, hidden)).astype(np.float32),
            r.normal(size=(batch, T, hidden)).astype(np.float32)]
    return arrays, cots


def _mask(batch, seed):
    lengths = np.random.default_rng(seed).integers(1, T + 1, size=batch)
    lengths[0] = T
    return np.arange(T)[None, :] < lengths[:, None]


@pytest.fixture
def fused(monkeypatch):
    """The fused route forced on (the plan's answer ignored: CPU tensors
    run the plain version whatever the plan), and the wrapper's calls
    counted."""
    calls = []
    real = gru_wide_step.gru_wide_step_fwd
    monkeypatch.setattr(gru_wide_step, "gru_wide_step_plan",
                        lambda *a: _plan(tiles_m=1, tiles_n=1, mcast=1,
                                         split=1, cluster=1, k_steps=1,
                                         grid=1))
    monkeypatch.setattr(gru_wide_step, "gru_wide_step_fwd",
                        lambda *a: calls.append(1) or real(*a))
    return calls


CASES = [(batch, hidden, reverse, masked)
         for batch, hidden in ((1, 64), (3, 128), (8, 64), (5, 96))
         for reverse in (False, True) for masked in (False, True)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("batch,hidden,reverse,masked", CASES)
def test_fused_forward_matches_lax_scan(batch, hidden, reverse, masked,
                                        dtype, fused):
    tdtype, jdtype, tol = DTYPES[dtype]
    arrays, _ = _inputs(batch, hidden, seed=batch + hidden)
    mask = _mask(batch, seed=7) if masked else None
    h_last, hs = jax_gru_scan(*[jnp.asarray(a, jdtype) for a in arrays],
                              reverse=reverse,
                              mask=None if mask is None else jnp.asarray(mask))
    with torch.inference_mode():
        got = wide_scan.gru_wide_scan_fwd(
            *[torch.from_numpy(a).to(tdtype) for a in arrays],
            reverse=reverse,
            mask=None if mask is None else torch.from_numpy(mask))
    assert len(fused) == T  # one fused step a step
    for g, w in zip(got, (h_last, hs)):
        assert g.dtype == tdtype
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("batch,hidden,reverse,masked", CASES)
def test_backward_through_the_fused_forward_matches_jax_grad(
        batch, hidden, reverse, masked, dtype, fused):
    """dxp, dh0, dW_hh and db_hh of sum(cot * outputs) through the wide
    route's autograd Function, its forward on the fused step, against
    jax.grad of lax.scan (in bf16: run in float32 on the bf16 values, as
    ``test_torch_wide_scan.py`` does)."""
    tdtype, _, tol = DTYPES[dtype]
    arrays, cots = _inputs(batch, hidden, seed=2 * batch + hidden)
    mask = _mask(batch, seed=9) if masked else None
    if tdtype is torch.bfloat16:
        arrays, cots = ([torch.from_numpy(a).to(tdtype).float().numpy()
                         for a in group] for group in (arrays, cots))
    jcots = [jnp.asarray(c) for c in cots]

    def loss(*args):
        outs = jax_gru_scan(*args, reverse=reverse,
                            mask=None if mask is None else jnp.asarray(mask))
        return sum(jnp.sum(o * c) for o, c in zip(outs, jcots))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *[jnp.asarray(a) for a in arrays])
    args = [torch.from_numpy(a).to(tdtype).requires_grad_() for a in arrays]
    outs = wide_scan.gru_wide_scan(
        *args, reverse=reverse,
        mask=None if mask is None else torch.from_numpy(mask))
    total = sum(torch.sum((o * torch.from_numpy(c).to(tdtype)).float())
                for o, c in zip(outs, cots))
    got = torch.autograd.grad(total, args)
    assert len(fused) == T
    for name, g, w in zip(("dxp", "dh0", "dw_hh", "db_hh"), got, want):
        assert g.dtype == tdtype, name
        w = np.asarray(w, np.float32)
        scale = float(np.abs(w).max()) if tdtype is torch.bfloat16 else 1.0
        np.testing.assert_allclose(g.float().numpy(), w, atol=tol * scale,
                                   rtol=0, err_msg=name)


def test_the_route_takes_the_plan_and_the_pair_where_it_hands_back(
        monkeypatch):
    """Unforced: bf16 at H = 64 runs the fused step, float32 and bf16 at
    H = 96 the addmm and W1's plain version."""
    counts = {"step": 0, "gates": 0}
    real_step, real_gates = (gru_wide_step.gru_wide_step_fwd,
                             wide_scan.gru_wide_gates)

    def step(*a):
        counts["step"] += 1
        return real_step(*a)

    def gates(*a):
        counts["gates"] += 1
        return real_gates(*a)

    monkeypatch.setattr(gru_wide_step, "gru_wide_step_fwd", step)
    monkeypatch.setattr(wide_scan, "gru_wide_gates", gates)
    for hidden, dtype, route in ((64, torch.bfloat16, "step"),
                                 (64, torch.float32, "gates"),
                                 (96, torch.bfloat16, "gates")):
        arrays, _ = _inputs(2, hidden, seed=hidden)
        before = dict(counts)
        with torch.inference_mode():
            wide_scan.gru_wide_scan_fwd(
                *[torch.from_numpy(a).to(dtype) for a in arrays])
        assert counts[route] - before[route] == T, (hidden, dtype)
        assert sum(counts.values()) - sum(before.values()) == T


def test_plain_step_rounds_hh_as_the_backward_recomputes_it():
    """On values whose float32 sums are exact in any order, the plain
    step's output is bit for bit the gate algebra on the backward's
    recomputed hh (``_recompute_hh``: one bf16 addmm, rounded once), and
    on hh = round_bf16(h W_hh^T + b_hh) formed in float32."""
    r = np.random.default_rng(4)
    batch, hidden = 6, 64
    h = torch.from_numpy(r.integers(-4, 5, size=(batch, hidden)) / 4.0).to(
        torch.bfloat16)
    w = torch.from_numpy(r.integers(-8, 9, size=(3 * hidden, hidden)) / 64.0
                         ).to(torch.bfloat16)
    b = torch.from_numpy(r.integers(-8, 9, size=(3 * hidden,)) / 32.0).to(
        torch.bfloat16)
    xp_t = torch.from_numpy(r.normal(size=(batch, 3 * hidden))).to(
        torch.bfloat16)
    hh32 = h.float() @ w.float().t() + b.float()
    # the sums need more than bf16's 8 bits: the rounding is exercised
    assert not torch.equal(hh32, hh32.to(torch.bfloat16).float())
    hh = wide_scan._recompute_hh(h[:, None], w, b)[:, 0]
    assert torch.equal(hh, hh32.to(torch.bfloat16))
    got = gru_wide_step.gru_wide_step_reference(xp_t, h, w, b)
    assert torch.equal(got, wide_scan.gru_wide_gates_reference(xp_t, hh, h))
    mask = torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.uint8)
    held = gru_wide_step.gru_wide_step_reference(xp_t, h, w, b, mask)
    assert torch.equal(held[mask == 0], h[mask == 0])
    assert torch.equal(held[mask == 1], got[mask == 1])


def test_bigru_at_width_in_bf16_matches_jax(monkeypatch):
    """The BiGRU at H = 1024 in bf16 (F = 108, one bidirectional layer),
    B = 2, T = 5, through the port's CPU path, against the JAX model in
    bf16 on the same flax params: every forward step of both directions on
    the fused step (its plan lays H = 1024 bf16 out), none on W1."""
    fields = dict(cell="gru", hidden_size=1024, dtype="bfloat16")
    jax_cfg = dataclasses.replace(JaxFrameworkConfig().model, **fields)
    cfg = dataclasses.replace(FrameworkConfig().model, **fields)
    jax_model = jax_build_model(jax_cfg)
    params = jax.device_get(jax_model.init(
        {"params": jax.random.PRNGKey(3)},
        jnp.zeros((1, 5, cfg.n_features)))["params"])
    port = build_model(cfg)
    port.load_state_dict(params_from_flax(params), strict=True)
    port.eval()
    steps, gates = [], []
    real_step, real_gates = (gru_wide_step.gru_wide_step_fwd,
                             wide_scan.gru_wide_gates)
    monkeypatch.setattr(gru_wide_step, "gru_wide_step_fwd",
                        lambda *a: steps.append(1) or real_step(*a))
    monkeypatch.setattr(wide_scan, "gru_wide_gates",
                        lambda *a: gates.append(1) or real_gates(*a))
    x = np.random.default_rng(8).normal(
        size=(2, 5, cfg.n_features)).astype(np.float32)
    want = jax_model.apply({"params": params}, x)
    before = launch_counts()
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert len(steps) == 2 * 5 and not gates
    assert launch_counts() == before  # CPU tensors launch nothing
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=BF16_TOL)


# ---------------------------------------------------------------------------
# the wrapper, its counter and its cost
# ---------------------------------------------------------------------------


def test_counter_is_registered_and_zero_at_import():
    assert LAUNCH_COUNTERS["gru_wide_step_fwd"] == ("gru_wide_step",
                                                    "launches")
    code = ("from fmda_tpu_torch.ops import gru_wide_step as s, "
            "launch_counts\n"
            "assert s.launches == 0\n"
            "assert launch_counts()['gru_wide_step_fwd'] == 0\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_cpu_steps_launch_nothing_and_other_devices_raise():
    arrays, _ = _inputs(2, 64, seed=1)
    xp, h0, w, b = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    out = torch.empty_like(h0)
    plan = gru_wide_step.step_plan(2, 64, 2, **H100)
    before = launch_counts()
    with torch.inference_mode():
        gru_wide_step.gru_wide_step_fwd(xp[:, 0], h0, w, b, None, out, plan)
    assert launch_counts() == before
    assert torch.equal(out, gru_wide_step.gru_wide_step_reference(
        xp[:, 0], h0, w, b))
    meta = [t.to("meta") for t in (xp[:, 0], h0, w, b, out)]
    with pytest.raises(ValueError, match="CUDA device"):
        gru_wide_step.gru_wide_step_fwd(*meta[:4], None, meta[4], plan)


def test_launch_checks_refuse_what_the_kernel_cannot_read():
    h = torch.zeros(4, 64, dtype=torch.bfloat16)
    xp_t = torch.zeros(4, 192, dtype=torch.bfloat16)
    w = torch.zeros(192, 64, dtype=torch.bfloat16)
    b = torch.zeros(192, dtype=torch.bfloat16)
    assert gru_wide_step._check(xp_t, h, w, b, None, h.clone()) == (4, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        gru_wide_step._check(xp_t.float(), h, w, b, None, h.clone())
    with pytest.raises(ValueError, match="w_hh must be"):
        gru_wide_step._check(xp_t, h, w[:, :32], b, None, h.clone())
    with pytest.raises(ValueError, match="contiguous"):
        gru_wide_step._check(xp_t, h, w.t().contiguous().t(), b, None,
                             h.clone())
    with pytest.raises(ValueError, match="16-byte aligned"):
        gru_wide_step._check(xp_t, h, w, b, None,
                             torch.zeros(4, 72, dtype=torch.bfloat16)[:, 4:68])
    with pytest.raises(ValueError, match="mask_t"):
        gru_wide_step._check(xp_t, h, w, b, torch.ones(4, dtype=torch.bool),
                             h.clone())


@pytest.mark.parametrize("masked", [False, True])
def test_cost_counts_the_product_and_w_hh_once(masked):
    c = gru_wide_step_cost(512, 1024, 2, masked)
    assert c.product_flops == 2 * 512 * 1024 * 3072
    assert c.elementwise_flops == 10 * 512 * 1024
    assert c.bytes_moved == (2 * (3072 * 1024 + 3072
                                  + 512 * (3072 + 2 * 1024))
                             + (512 if masked else 0))
    # a row more moves its own xp_t, h_{t-1} and h_t, not W_hh again
    more = gru_wide_step_cost(513, 1024, 2, masked)
    assert more.bytes_moved - c.bytes_moved == 2 * 5 * 1024 + masked
    assert LAUNCH_COSTS["gru_wide_step_fwd"]((512, 1024, 2, masked)) == c
    bound, by = gru_wide_step_bound(512, 1024, 2, False)
    assert by == "bytes" and abs(bound - 0.003445) < 1e-5
    assert abs(gru_wide_step_bound(1, 1024, 2, False)[0] - 0.001883) < 1e-5


@pytest.mark.parametrize("split", [1, 2, 4])
def test_plain_step_sums_bf16_products_in_the_kernels_order(split):
    """In bf16 with a plan, the plain step's product is summed as the
    kernel sums it (a k16 block exactly, then rounded toward zero into its
    K-split rank's float32 sum, the ranks added in order): exact where
    every partial sum is, within float32's rounding of one BLAS product
    elsewhere, and the step's output within a bf16 ulp of the plain float32
    product's."""
    r = np.random.default_rng(split)
    batch, hidden = 5, 128
    h = torch.from_numpy(r.integers(-4, 5, size=(batch, hidden)) / 4.0).to(
        torch.bfloat16)
    w = torch.from_numpy(r.integers(-8, 9, size=(3 * hidden, hidden)) / 64.0
                         ).to(torch.bfloat16)
    exact = h.float() @ w.float().t()
    groups = gru_wide_step._step_groups(hidden, split)
    assert torch.equal(wide_scan._tc_product(h, w, groups), exact)
    h = torch.from_numpy(r.normal(size=(batch, hidden))).to(torch.bfloat16)
    w = torch.from_numpy(0.1 * r.normal(size=(3 * hidden, hidden))).to(
        torch.bfloat16)
    got = wide_scan._tc_product(h, w, groups)
    want = h.double() @ w.double().t()
    assert float((got.double() - want).abs().max()) < 1e-5
    xp_t = torch.from_numpy(r.normal(size=(batch, 3 * hidden))).to(
        torch.bfloat16)
    b = torch.zeros(3 * hidden, dtype=torch.bfloat16)
    plan = gru_wide_step.step_plan(batch, hidden, 2, **H100)
    plan["split"] = split
    ordered = gru_wide_step.gru_wide_step_reference(xp_t, h, w, b, None, plan)
    blas = gru_wide_step.gru_wide_step_reference(xp_t, h, w, b)
    assert float((ordered.float() - blas.float()).abs().max()) <= 2 ** -7


@pytest.mark.parametrize("hidden,split", [(64, 1), (128, 2), (1024, 8)])
def test_step_groups_are_contiguous_k_shares(hidden, split):
    """The fused step's K-split ranks take contiguous, equal shares of K's
    16-column k-steps in rank order, as its clusters split the product."""
    groups = gru_wide_step._step_groups(hidden, split)
    per = hidden // 16 // split
    assert groups == [r for r in range(split) for _ in range(per)]

