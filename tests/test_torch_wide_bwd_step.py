"""fmda_tpu_torch's fused GRU backward step (``ops/gru_wide_bwd_step.py``,
``csrc/gru_wide_bwd_step.cu``) against the JAX package's lax.scan path, on
the CPU.

Where its plan lays a step out (bf16, H a multiple of 64), the GRU wide
route runs each backward step as one launch: the product dhh_{t+1} W_hh and
the step's gate gradients together, the product never rounded.  Here the
wrapper runs its plain version (CPU tensors), and:

- the plan's Python copy is pinned at the H100's figures: its tiles and
  clusters at B = 1, 256, 483 and 512, float32 and ragged widths handed
  back, every plan within the card;
- the plain step equals the pair's plain composition (W2's plain version
  after the product rounded to bf16, as the ``mm`` rounds it) within what
  one bf16 rounding of the product moves, and exactly at a direction's
  first step (no product);
- ``gru_wide_scan``'s gradients through it match ``jax.grad`` of
  ``fmda_tpu.ops.gru.gru_scan`` at B 3 and 5, H 64 and 128, T 5, both
  directions, masked and not (bf16 within 2e-2 of each gradient's largest
  entry), and the float32 route, which the plan hands back to W2 and the
  ``mm``, within 1e-5;
- the weight gradients from the (B, T, 4 H) buffer equal those from dhh;
- the counter is registered and 0 at import, CPU calls launch nothing, a
  launch without a card's library raises; the launch checks refuse what
  the kernel cannot read; the cost counts W_hh once.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmda_tpu.ops.gru import gru_scan as jax_gru_scan

from fmda_tpu_torch.ops import (
    LAUNCH_COUNTERS, _cuda_lib, gru_wide_bwd_step as bw, gru_wide_step,
    launch_counts, wide_scan)
from fmda_tpu_torch.ops.cost import (
    LAUNCH_COSTS, gru_wide_bwd_step_bound, gru_wide_bwd_step_cost)
from fmda_tpu_torch.ops.scan_dw import h_prev_of

F32_TOL = 1e-5
BF16_TOL = 2e-2
T = 5
H100 = _cuda_lib.H100_FIGURES
SMEM = {64: 12 * 16384 + 256 + 1024, 128: 9 * 24576 + 256 + 1024}


def _plan(units=128, **fields):
    return dict(fields, smem=SMEM[units])


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,hidden,want", [
    # flagship_wide's step: 8 x 8 tiles of 64 rows x 128 units, K split
    # over clusters of 2 (128 CTAs; a 2 x 2 multicast cluster would need
    # 32 clusters of 4 at once, and the H100 holds 30)
    (512, 1024, _plan(tiles_m=8, tiles_n=8, mcast=1, split=2, cluster=2,
                      k_steps=24, grid=128)),
    # a ragged last batch of the same epoch: a last tile of 35 rows
    (483, 1024, _plan(tiles_m=8, tiles_n=8, mcast=1, split=2, cluster=2,
                      k_steps=24, grid=128)),
    # the Predictor's and the stream's B = 1: K = 3 H split over 8
    (1, 1024, _plan(tiles_m=1, tiles_n=8, mcast=1, split=8, cluster=8,
                    k_steps=6, grid=64)),
    # 32 tiles: 32 clusters of 4 are not resident at once, of 2 they are
    (256, 1024, _plan(tiles_m=4, tiles_n=8, mcast=1, split=2, cluster=2,
                      k_steps=24, grid=64)),
    # past half the SMs in tiles of 128 units, K is not split: tiles of 64;
    # an odd number of batch tiles: one CTA a cluster
    (800, 1024, _plan(64, tiles_m=13, tiles_n=16, mcast=1, split=1,
                      cluster=1, k_steps=48, grid=208)),
    # an even number: W_hh^T multicast along the batch
    (2048, 1024, _plan(64, tiles_m=32, tiles_n=16, mcast=2, split=1,
                       cluster=2, k_steps=48, grid=512)),
    # H = 128: one tile of 128 units, K = 384 split over 2
    (3, 128, _plan(tiles_m=1, tiles_n=1, mcast=1, split=2, cluster=2,
                   k_steps=3, grid=2)),
    # H not a multiple of 128: tiles of 64 units; K = 192 (three k-steps)
    # split by none of 8, 4, 2
    (1, 64, _plan(64, tiles_m=1, tiles_n=1, mcast=1, split=1, cluster=1,
                  k_steps=3, grid=1)),
    (3, 192, _plan(64, tiles_m=1, tiles_n=3, mcast=1, split=1, cluster=1,
                   k_steps=9, grid=3)),
    (8, 512, _plan(tiles_m=1, tiles_n=4, mcast=1, split=8, cluster=8,
                   k_steps=3, grid=32)),
    (1, 2048, _plan(tiles_m=1, tiles_n=16, mcast=1, split=4, cluster=4,
                    k_steps=24, grid=64)),
])
def test_plan_pinned_at_the_h100(batch, hidden, want):
    assert bw.bwd_step_plan(batch, hidden, 2, **H100) == want
    assert bw.gru_wide_bwd_step_plan(
        batch, hidden, torch.bfloat16, torch.device("cpu")) == want


@pytest.mark.parametrize("batch,hidden,itemsize", [
    (512, 1024, 4), (1, 1024, 4), (3, 64, 4),  # float32: W2 and the mm
    (512, 96, 2), (512, 1000, 2), (3, 48, 2), (0, 1024, 2)])
def test_plan_hands_back_float32_and_ragged_widths(batch, hidden, itemsize):
    assert bw.bwd_step_plan(batch, hidden, itemsize, **H100) is None


@pytest.mark.parametrize("batch", [1, 2, 63, 64, 65, 128, 256, 300, 483, 512,
                                   1024, 2049])
@pytest.mark.parametrize("hidden", [64, 192, 256, 1024, 2048])
def test_every_plan_fits_the_card(batch, hidden):
    """Every laid-out plan tiles the step exactly, splits K = 3 H evenly,
    uses clusters the card holds all at once where K is split, and fits a
    CTA's shared memory."""
    p = bw.bwd_step_plan(batch, hidden, 2, **H100)
    units = hidden // p["tiles_n"]
    # tiles of 128 units only where K is split (a K rank's epilogue share
    # is then 2 items a thread at most), and wherever that layout does
    assert units == 64 or (units == 128 and p["split"] > 1)
    wide = gru_wide_step.tile_plan(batch, hidden, 128, 3 * hidden // 64,
                                   SMEM[128], sms=H100["sms"],
                                   clusters=H100["clusters"])
    assert (units == 128) == (hidden % 128 == 0 and wide["split"] > 1)
    assert p["tiles_m"] * 64 >= batch > (p["tiles_m"] - 1) * 64
    assert p["tiles_n"] * units == hidden
    assert p["k_steps"] * p["split"] * 64 == 3 * hidden
    assert 1 in (p["mcast"], p["split"])
    assert p["cluster"] == p["mcast"] * p["split"] <= 8
    assert p["grid"] == p["tiles_m"] * p["tiles_n"] * p["split"]
    assert p["mcast"] == 1 or p["tiles_m"] % 2 == 0
    if p["split"] > 1:
        assert p["grid"] <= H100["sms"]
        assert p["tiles_m"] * p["tiles_n"] <= H100["clusters"][p["split"]]
    assert p["smem"] == SMEM[units] <= H100["smem"]


def test_the_plans_share_one_rule():
    """The forward's and the backward's plans are one layout rule
    (``wide_tc.cuh``'s ``tile_plan``): over K = H in tiles of 64 units, and
    over K = 3 H in tiles of 128 units where that splits K (else 64), in
    CTAs of the shared bytes each kernel's ring takes."""
    figures = dict(sms=H100["sms"], clusters=H100["clusters"])
    for batch, hidden in ((1, 1024), (256, 1024), (512, 1024), (8, 512),
                          (5, 192), (800, 1024)):
        fwd = gru_wide_step.step_plan(batch, hidden, 2, **H100)
        assert fwd == gru_wide_step.tile_plan(
            batch, hidden, 64, hidden // 64, gru_wide_step.STEP_SMEM,
            **figures)
        units = hidden // bw.bwd_step_plan(batch, hidden, 2,
                                           **H100)["tiles_n"]
        assert bw.bwd_smem(units) == SMEM[units]
        assert bw.bwd_step_plan(batch, hidden, 2, **H100) == (
            gru_wide_step.tile_plan(batch, hidden, units, 3 * hidden // 64,
                                    SMEM[units], **figures))


# ---------------------------------------------------------------------------
# the plain step
# ---------------------------------------------------------------------------


def _step_operands(batch, hidden, seed, masked):
    r = np.random.default_rng(seed)

    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    gh = 3 * hidden
    ops = dict(xp_t=bf(r.normal(size=(batch, gh))),
               hh_t=bf(r.normal(size=(batch, gh))),
               h_prev=bf(0.5 * r.normal(size=(batch, hidden))),
               direct=torch.from_numpy(
                   0.1 * r.normal(size=(batch, hidden))).float(),
               dhh_next=bf(0.1 * r.normal(size=(batch, gh))),
               w=bf(r.uniform(-1, 1, size=(gh, hidden)) / np.sqrt(hidden)),
               dhs_t=bf(0.1 * r.normal(size=(batch, hidden))))
    ops["mask_t"] = (torch.from_numpy(r.random(batch) > 0.3).to(torch.uint8)
                     if masked else None)
    return ops


def _ulp_share(t):
    return 2.0 ** -8 * t.float().abs()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("split", [1, 2, 4])
def test_plain_step_is_the_pair_within_one_rounding_of_the_product(
        masked, split):
    """The fused plain step keeps the product in float32; the pair (W2's
    plain version after ``dhh_{t+1} W_hh``) reads it rounded to bf16.  With
    the same product summed in the same order, every output is linear in
    dh, so the two differ by at most |d out / d dh| times that one rounding
    (at most half a bf16 ulp of the product, 2^-8 of it), plus each bf16
    output's own rounding (2^-8 of its magnitude, each side)."""
    batch, hidden = 5, 64
    o = _step_operands(batch, hidden, seed=split, masked=masked)
    w_t = o["w"].t().contiguous()
    plan = bw.bwd_step_plan(batch, hidden, 2, **H100)
    plan["split"] = split  # the product's order as a K split of `split`
    row, new_direct = bw.gru_wide_bwd_step_reference(
        o["xp_t"], o["hh_t"], o["h_prev"], o["direct"], o["dhh_next"], w_t,
        o["dhs_t"], o["mask_t"], plan)
    prod = wide_scan._tc_product(o["dhh_next"], w_t,
                                 gru_wide_step._step_groups(3 * hidden,
                                                            split))
    rounded = prod.to(torch.bfloat16)
    delta = (prod - rounded.float()).abs()
    assert float(delta.max()) > 0  # the rounding is exercised
    assert bool((delta <= 2.0 ** -8 * prod.abs()).all())
    dxp, dhh, direct = wide_scan.gru_wide_gates_bwd_reference(
        o["xp_t"], o["hh_t"], o["h_prev"], o["direct"], rounded, o["dhs_t"],
        o["mask_t"])
    # |d out / d dh| from the gates, as the plain versions recompute them
    x, a = o["xp_t"].float(), o["hh_t"].float()
    hp = o["h_prev"].float()
    r = torch.sigmoid(x[:, :hidden] + a[:, :hidden])
    z = torch.sigmoid(x[:, hidden:2 * hidden] + a[:, hidden:2 * hidden])
    n = torch.tanh(x[:, 2 * hidden:] + r * a[:, 2 * hidden:])
    c_n = (1 - z) * (1 - n * n)
    coef = dict(dr=c_n * (a[:, 2 * hidden:] * r * (1 - r)).abs(),
                dz=((hp - n) * z * (1 - z)).abs(), dn=c_n, gn=c_n * r,
                direct=z)
    got = dict(dr=row[:, :hidden], dz=row[:, hidden:2 * hidden],
               dn=row[:, 2 * hidden:3 * hidden], gn=row[:, 3 * hidden:],
               direct=new_direct)
    want = dict(dr=dxp[:, :hidden], dz=dxp[:, hidden:2 * hidden],
                dn=dxp[:, 2 * hidden:], gn=dhh[:, 2 * hidden:], direct=direct)
    if masked:  # a held row passes dh through: the coefficient is 1
        held = (o["mask_t"] == 0)[:, None]
        coef["direct"] = torch.where(held, 1.0, coef["direct"])
    for name in got:
        g, w = got[name].float(), want[name].float()
        bound = coef[name] * delta * 1.001 + _ulp_share(g) + _ulp_share(w)
        if name == "direct":  # float32: no bf16 rounding of its own
            bound = coef[name] * delta * 1.001 + 1e-6 * w.abs()
        assert bool(((g - w).abs() <= bound + 1e-12).all()), name


@pytest.mark.parametrize("masked", [False, True])
def test_first_processed_step_is_w2_exactly(masked):
    """Without a product the fused plain step is W2's plain version bit for
    bit: dxp, dhh's n block and the direct part."""
    o = _step_operands(4, 64, seed=11, masked=masked)
    row, new_direct = bw.gru_wide_bwd_step_reference(
        o["xp_t"], o["hh_t"], o["h_prev"], o["direct"], None,
        o["w"].t().contiguous(), o["dhs_t"], o["mask_t"])
    dxp, dhh, direct = wide_scan.gru_wide_gates_bwd_reference(
        o["xp_t"], o["hh_t"], o["h_prev"], o["direct"], None, o["dhs_t"],
        o["mask_t"])
    assert torch.equal(row[:, :192], dxp)
    assert torch.equal(bw.dhh_of(row), dhh)
    assert torch.equal(new_direct, direct)


def test_kernel_order_product_is_exact_on_exact_values():
    """On values whose float32 sums are exact in any order, the plain
    step's kernel-order product over K = 3 H is the plain product."""
    r = np.random.default_rng(3)
    batch, hidden = 4, 64
    a = torch.from_numpy(r.integers(-4, 5, size=(batch, 3 * hidden)) / 4.0
                         ).to(torch.bfloat16)
    w_t = torch.from_numpy(r.integers(-8, 9, size=(hidden, 3 * hidden))
                           / 64.0).to(torch.bfloat16)
    for split in (1, 2, 4):
        groups = gru_wide_step._step_groups(3 * hidden, split)
        assert torch.equal(wide_scan._tc_product(a, w_t, groups),
                           a.float() @ w_t.float().t())


# ---------------------------------------------------------------------------
# the route against jax.grad
# ---------------------------------------------------------------------------


def _inputs(batch, hidden, *, seed):
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
def counted(monkeypatch):
    """The fused backward step's and W2's wrapper calls, counted."""
    calls = {"step": 0, "w2": 0}
    real_step, real_w2 = bw.gru_wide_bwd_step, wide_scan.gru_wide_gates_bwd

    def step(*a):
        calls["step"] += 1
        return real_step(*a)

    def w2(*a):
        calls["w2"] += 1
        return real_w2(*a)

    monkeypatch.setattr(bw, "gru_wide_bwd_step", step)
    monkeypatch.setattr(wide_scan, "gru_wide_gates_bwd", w2)
    return calls


def _grads(arrays, cots, mask, reverse, tdtype):
    args = [torch.from_numpy(a).to(tdtype).requires_grad_() for a in arrays]
    outs = wide_scan.gru_wide_scan(
        *args, reverse=reverse,
        mask=None if mask is None else torch.from_numpy(mask))
    total = sum(torch.sum((o * torch.from_numpy(c).to(tdtype)).float())
                for o, c in zip(outs, cots))
    return torch.autograd.grad(total, args)


def _jax_grads(arrays, cots, mask, reverse):
    jcots = [jnp.asarray(c) for c in cots]

    def loss(*args):
        outs = jax_gru_scan(*args, reverse=reverse,
                            mask=None if mask is None else jnp.asarray(mask))
        return sum(jnp.sum(o * c) for o, c in zip(outs, jcots))

    return jax.grad(loss, argnums=(0, 1, 2, 3))(
        *[jnp.asarray(a) for a in arrays])


CASES = [(batch, hidden, reverse, masked)
         for batch, hidden in ((3, 64), (5, 128))
         for reverse in (False, True) for masked in (False, True)]


@pytest.mark.parametrize("batch,hidden,reverse,masked", CASES)
def test_fused_backward_matches_jax_grad_bf16(batch, hidden, reverse, masked,
                                              counted):
    """dxp, dh0, dW_hh and db_hh of sum(cot * outputs) through the route,
    its backward on the fused step (the plan lays bf16 at H = 64 and 128
    out), against jax.grad of lax.scan run in float32 on the bf16 values,
    each within 2e-2 of its largest entry."""
    arrays, cots = _inputs(batch, hidden, seed=3 * batch + hidden)
    arrays, cots = ([torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                     for a in group] for group in (arrays, cots))
    mask = _mask(batch, seed=5) if masked else None
    want = _jax_grads(arrays, cots, mask, reverse)
    got = _grads(arrays, cots, mask, reverse, torch.bfloat16)
    assert counted == {"step": T, "w2": 0}  # one fused step a step
    for name, g, w in zip(("dxp", "dh0", "dw_hh", "db_hh"), got, want):
        assert g.dtype == torch.bfloat16, name
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w,
                                   atol=BF16_TOL * float(np.abs(w).max()),
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("batch,hidden,reverse,masked", CASES)
def test_float32_route_stays_with_w2_within_1e5(batch, hidden, reverse,
                                                masked, counted):
    """float32: the plan hands every step back to W2 and the mm, whose
    gradients stay within 1e-5 of jax.grad."""
    arrays, cots = _inputs(batch, hidden, seed=7 * batch + hidden)
    mask = _mask(batch, seed=6) if masked else None
    want = _jax_grads(arrays, cots, mask, reverse)
    got = _grads(arrays, cots, mask, reverse, torch.float32)
    assert counted == {"step": 0, "w2": T}
    for name, g, w in zip(("dxp", "dh0", "dw_hh", "db_hh"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F32_TOL,
                                   rtol=0, err_msg=name)


def test_ragged_width_stays_with_w2(counted):
    """bf16 at H = 96 (not a multiple of 64): W2 and the mm, as before."""
    arrays, cots = _inputs(2, 96, seed=2)
    _grads(arrays, cots, None, False, torch.bfloat16)
    assert counted == {"step": 0, "w2": T}


def test_dxp_and_weight_gradients_from_the_buffer():
    """The fused route's dxp is the buffer's first 3 H columns, and its
    dW_hh and db_hh (two products into one result) equal the one product
    over dhh = [dr, dz, dn r] (``_weight_grads``)."""
    r = np.random.default_rng(9)
    batch, hidden = 3, 64
    dg = torch.from_numpy(r.integers(-8, 9, size=(batch, T, 4 * hidden))
                          / 16.0).to(torch.bfloat16)
    hp = torch.from_numpy(r.integers(-4, 5, size=(batch, T, hidden)) / 8.0
                          ).to(torch.bfloat16)
    w = torch.zeros(3 * hidden, hidden, dtype=torch.bfloat16)
    b = torch.zeros(3 * hidden, dtype=torch.bfloat16)
    dhh = bw.dhh_of(dg)
    assert torch.equal(dhh[..., :2 * hidden], dg[..., :2 * hidden])
    assert torch.equal(dhh[..., 2 * hidden:], dg[..., 3 * hidden:])
    got = wide_scan._gate_grads(dg, hp, w, b)
    want = wide_scan._weight_grads(dhh, hp, w, b)
    for g, x in zip(got, want):
        assert torch.equal(g, x)


def test_scan_writes_each_step_once_in_the_backward_order(monkeypatch):
    """The direction's steps run T - 1 down to 0 (0 up where the forward
    ran reversed), each reading the one before it, the first without a
    product; the last processed step is returned."""
    seen = []
    monkeypatch.setattr(bw, "gru_wide_bwd_step",
                        lambda *a: seen.append((a[8], a[9])))
    for reverse, order in ((False, [4, 3, 2, 1, 0]), (True, [0, 1, 2, 3, 4])):
        seen.clear()
        z = torch.zeros(2, T, 3, dtype=torch.bfloat16)
        last = bw.gru_wide_bwd_step_scan(z, z, z, z, None, z, z, z, {},
                                         reverse=reverse)
        assert [t for t, _ in seen] == order and last == order[-1]
        assert [p for _, p in seen] == [None] + order[:-1]


# ---------------------------------------------------------------------------
# the wrapper, its counter and its cost
# ---------------------------------------------------------------------------


def test_counter_is_registered_and_zero_at_import():
    assert LAUNCH_COUNTERS["gru_wide_bwd_step"] == ("gru_wide_bwd_step",
                                                    "launches")
    code = ("from fmda_tpu_torch.ops import gru_wide_bwd_step as s, "
            "launch_counts\n"
            "assert s.launches == 0\n"
            "assert launch_counts()['gru_wide_bwd_step'] == 0\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _direction(batch=2, hidden=64, seed=1):
    r = np.random.default_rng(seed)
    gh = 3 * hidden

    def bf(*shape, s=1.0):
        return torch.from_numpy(s * r.normal(size=shape)).to(torch.bfloat16)

    return dict(xp=bf(batch, T, gh), hh=bf(batch, T, gh),
                h_prevs=bf(batch, T, hidden, s=0.5),
                dhs=bf(batch, T, hidden, s=0.1), mask=None,
                w_t=bf(hidden, gh, s=hidden ** -0.5),
                direct=torch.zeros(batch, hidden),
                dg=torch.zeros(batch, T, 4 * hidden, dtype=torch.bfloat16))


def test_cpu_steps_launch_nothing_and_a_card_launch_without_the_library_raises(
        monkeypatch):
    d = _direction()
    plan = bw.bwd_step_plan(2, 64, 2, **H100)
    before = launch_counts()
    with torch.inference_mode():
        bw.gru_wide_bwd_step_scan(*d.values(), plan)
    assert launch_counts() == before
    assert bool(torch.isfinite(d["dg"].float()).all())
    assert float(d["dg"].float().abs().max()) > 0
    meta = {k: (v.to("meta") if v is not None else None)
            for k, v in d.items()}
    with pytest.raises(ValueError, match="CUDA device"):
        bw.gru_wide_bwd_step(*meta.values(), 0, None, plan)
    # tensors the wrapper takes for a card's: a launch or an error, never
    # the plain version (no fallback): without a built library it raises
    d = _direction()

    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(bw, "_on_cpu", lambda name, tensors: False)
    monkeypatch.setattr(_cuda_lib, "build", no_library)
    monkeypatch.setattr(_cuda_lib, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        bw.gru_wide_bwd_step_scan(*d.values(), plan)
    assert bw.launches == 0 and not bool(d["dg"].float().abs().max())


def test_launch_checks_refuse_what_the_kernel_cannot_read():
    d = _direction()
    assert bw._check(*d.values()) == (2, T, 64)

    def bad(**change):
        return list(dict(d, **change).values())

    with pytest.raises(TypeError, match="bfloat16"):
        bw._check(*bad(xp=d["xp"].float()))
    with pytest.raises(ValueError, match="w_t must be"):
        bw._check(*bad(w_t=d["w_t"][:, :96]))
    with pytest.raises(ValueError, match="contiguous"):
        bw._check(*bad(w_t=d["w_t"].t().contiguous().t()))
    with pytest.raises(ValueError, match="contiguous"):  # dg's steps
        bw._check(*bad(dg=torch.zeros(2, 4 * 64, T,
                                      dtype=torch.bfloat16).transpose(1, 2)))
    with pytest.raises(ValueError, match="multiples of 8"):
        bw._check(*bad(xp=torch.zeros(2, T, 196,
                                      dtype=torch.bfloat16)[..., :192]))
    with pytest.raises(ValueError, match="16-byte aligned"):
        bw._check(*bad(h_prevs=torch.zeros(2, T, 72,
                                           dtype=torch.bfloat16)[..., 4:68]))
    with pytest.raises(ValueError, match="direct"):
        bw._check(*bad(direct=torch.zeros(2, 64, dtype=torch.bfloat16)))
    with pytest.raises(ValueError, match="mask"):
        bw._check(*bad(mask=torch.ones(2, T, dtype=torch.bool)))


@pytest.mark.parametrize("masked", [False, True])
def test_cost_counts_w_hh_once(masked):
    c = gru_wide_bwd_step_cost(512, 1024, 2, masked)
    gh = 3072
    assert c.product_flops == 2 * 512 * gh * 1024
    assert c.elementwise_flops == 30 * 512 * 1024
    # W_hh and dhh_{t+1}; xp_t, hh_t, h_{t-1}, dhs_t; dxp_t and dn r
    # written; direct read and written in float32; the mask
    assert c.bytes_moved == (2 * (gh * 1024 + 512 * gh
                                  + 512 * (2 * gh + 2 * 1024)
                                  + 512 * (gh + 1024))
                             + 4 * 2 * 512 * 1024 + (512 if masked else 0))
    # a row more moves its own operands (dhh_{t+1}, xp_t, hh_t, dxp_t;
    # h_{t-1}, dhs_t, dn r; direct twice), not W_hh again
    more = gru_wide_bwd_step_cost(513, 1024, 2, masked)
    assert more.bytes_moved - c.bytes_moved == (2 * (4 * gh + 3 * 1024)
                                                + 8 * 1024 + masked)
    # the first processed step reads neither W_hh nor dhh_{t+1}
    first = gru_wide_bwd_step_cost(512, 1024, 2, masked, prod=False)
    assert c.bytes_moved - first.bytes_moved == 2 * (gh * 1024 + 512 * gh)
    assert first.product_flops == 0
    assert LAUNCH_COSTS["gru_wide_bwd_step"](
        (512, 1024, 2, masked, True)) == c
    bound, by = gru_wide_bwd_step_bound(512, 1024, 2, False)
    assert by == "bytes" and abs(bound - 0.0078252) < 1e-6
    assert gru_wide_bwd_step_bound(1, 1024, 2, False)[1] == "bytes"


def test_route_buffers_are_what_the_launch_checks_take(monkeypatch):
    """The route hands the fused direction operands its checks accept: a
    bf16 scan at (3, 5, 128) through ``gru_wide_scan_bwd`` with the checks
    run on every call."""
    seen = []
    real = bw.gru_wide_bwd_step_scan

    def scan(*a, **k):
        seen.append(bw._check(*a[:8]))
        return real(*a, **k)

    monkeypatch.setattr(bw, "gru_wide_bwd_step_scan", scan)
    arrays, cots = _inputs(3, 128, seed=4)
    xp, h0, w, b = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    _, hs = wide_scan.gru_wide_scan_fwd(xp, h0, w, b)
    mask = torch.from_numpy(_mask(3, 1))
    for reverse in (False, True):
        wide_scan.gru_wide_scan_bwd(
            xp[:, :, :], h0, w, b, hs, torch.ones(3, 128),
            torch.ones(1, 1, 128).expand(3, T, 128), reverse=reverse,
            mask=mask)
    assert seen == [(3, T, 128)] * 2
    # the direction's h_prevs are the states entering each step
    assert torch.equal(h_prev_of(h0, hs)[:, 1:], hs[:, :-1])
