"""The flash backward (fused dq, dk and dv, or the two sweeps), on the CPU.

``csrc/flash_bwd_plan.cc`` decides how a backward call runs on the card:
one launch of ``csrc/flash_bwd.cu``'s fused kernel where a CTA holds whole
heads (T <= 128, D <= 64), else ``csrc/flash_attn.cu``'s dK/dV and dQ
sweeps; and for either, the warps, CTAs, chunks and shared memory.  It is
plain C++, so these tests build it alone with the host's C++ compiler and
hold it to the kernels' rules across the envelope.  Then
``flash_bwd_reference`` against the two plain sweeps, the gradients of
``flash_attention_with_lse`` (which now run ``flash_bwd``) against
``jax.vjp`` of the JAX package's ``flash_attention_with_lse`` in interpret
mode and of its ``mha``, with a nonzero lse cotangent, and the launch
counts of CPU calls.  Inputs are numpy-seeded; tolerances 1e-5 in float32
and 2e-2 in bf16.
"""

import ctypes
import math
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmda_tpu.ops import attention as jax_attention
from fmda_tpu.ops.pallas_attention import (
    flash_attention_with_lse as jax_flash_with_lse,
)

from fmda_tpu_torch.ops import _cuda_lib
from fmda_tpu_torch.ops import attention_kernel as ak

_PLAN_SOURCE = _cuda_lib._CSRC / "flash_bwd_plan.cc"
_HEADER = (_cuda_lib._CSRC / "flash_bwd_plan.h").read_text()
_FWD_HEADER = (_cuda_lib._CSRC / "flash_fwd_plan.h").read_text()
SMEM_LIMIT = int(
    re.search(r"kSmemLimit = (\d+) \* 1024", _FWD_HEADER)[1]) * 1024
RESIDENT_SMEM = int(
    re.search(r"kResidentSmem = (\d+) \* 1024", _FWD_HEADER)[1]) * 1024
LDW = 16 + int(re.search(r"kLdw = kTile \+ (\d+);", _HEADER)[1])
TILE = 16

F32_TOL = 1e-5
BF16_TOL = 2e-2
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    """``flash_bwd_plan.cc`` alone, built by the host's C++ compiler."""
    out = tmp_path_factory.mktemp("flash_bwd_plan") / "libflash_bwd_plan.so"
    subprocess.run([shutil.which("c++") or "g++", "-std=c++17", "-O1",
                    "-shared", "-fPIC", "-o", str(out), str(_PLAN_SOURCE)],
                   check=True)
    return ctypes.CDLL(str(out))


@pytest.fixture
def bwd_plan(plan_lib):
    def plan(bn, n, t, d, dtype, sweeps=False):
        return ak.flash_bwd_plan(bn, n, t, d, dtype, sweeps=sweeps,
                                 lib=plan_lib)
    return plan


def _align(x):
    return -(-x // 16) * 16


def _smem(plan, item):
    """The bytes a CTA takes, reckoned from the kernels' regions apart
    from the plan's own reckoning, each 16-byte aligned."""
    warps = plan["threads"] // 32
    if plan["fused"]:  # a head: q, k, v, do, ds, lse, delta, key flags
        rows = plan["rows"]
        off = plan["units"] * _align((4 * plan["ld"] + plan["ldd"]) * rows
                                     * item + 2 * rows * 4 + rows)
    else:  # own rows, their vectors, the walked stages
        own, rows = plan["units"] * TILE, plan["rows"]
        off = _align(_align(2 * own * plan["ld"] * item) + 2 * own * 4 + own)
        off += plan["stages"] * _align(2 * rows * plan["ld"] * item
                                       + 2 * rows * 4 + rows)
    off = _align(off + (warps * 2 * TILE * LDW * 4 if item == 4 else 0))
    return _align(off + (warps * 4 * 32 * 16 if plan["split"] > 1 else 0))


def _owners(plan, bn, t):
    """{(head, tile, dims slice): warps} as the kernels map their warps:
    fused, warp w of unit u of CTA c owns tiles w, w + wph, ... of head
    c * units + u; a sweep's warp w of CTA c owns tile w // split of the
    CTA's units from row (c % per_head) * units * 16 of head c // per_head,
    dims slice w % split."""
    n_tiles = math.ceil(t / TILE)
    owned = {}
    for cta in range(plan["grid"]):
        for warp in range(plan["threads"] // 32):
            if plan["fused"]:
                unit, sub = divmod(warp, plan["wph"])
                head = cta * plan["units"] + unit
                keys = [(head, tile, 0) for tile in
                        range(sub, n_tiles, plan["wph"]) if head < bn]
            else:
                unit, ws = divmod(warp, plan["split"])
                per_head = math.ceil(t / (plan["units"] * TILE))
                head, part = divmod(cta, per_head)
                tile = part * plan["units"] + unit
                keys = [(head, tile, ws)] if tile < n_tiles else []
            for key in keys:
                owned[key] = owned.get(key, 0) + 1
    return owned


#: (B*N, N, T, D): the model's, the Predictor's, long context, the D
#: envelope, the fused edge, ragged and odd shapes
SHAPES = [(1024, 4, 30, 8), (4, 4, 30, 8), (64, 4, 1024, 8),
          (16, 2, 256, 64), (2, 1, 128, 512), (8, 2, 128, 64),
          (3, 3, 129, 65), (5, 5, 7, 3), (6, 2, 1, 1), (8, 4, 300, 200),
          (2, 2, 64, 100), (3, 1, 17, 257)]


@pytest.mark.parametrize("sweeps", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_fits_the_card_and_every_row_has_one_warp(bwd_plan, shape,
                                                       dtype, sweeps):
    bn, n, t, d = shape
    plan = bwd_plan(bn, n, t, d, dtype, sweeps)
    item = 2 if dtype == torch.bfloat16 else 4
    assert plan["fused"] == (not sweeps and t <= ak.SOFTMAX_BLOCK and d <= 64)
    assert plan["smem"] == _smem(plan, item)
    assert plan["smem"] <= SMEM_LIMIT and plan["smem"] % 16 == 0
    assert 32 <= plan["threads"] <= 256 and plan["threads"] % 32 == 0
    # dims: whole mma k-steps (16 bf16, 8 f32), a power of two, at most 64
    # a warp; `split` warps a tile where D > 64
    step = 16 if dtype == torch.bfloat16 else 8
    split = 2 ** max(0, math.ceil(math.log2(d / 64)))
    dw = 64 if split > 1 else max(step, 2 ** math.ceil(math.log2(d)))
    assert (plan["split"], plan["dw"]) == (split, dw)
    if plan["fused"]:  # whole heads, a head's tiles shared by its warps
        assert plan["split"] == 1 and plan["stages"] == 1
        assert plan["rows"] == _align(t)
        assert plan["threads"] == plan["units"] * plan["wph"] * 32
        assert 1 <= plan["wph"] <= math.ceil(t / TILE)
        assert plan["grid"] == math.ceil(bn / plan["units"])
        assert plan["units"] == 1 or plan["smem"] <= RESIDENT_SMEM
    else:  # tiles of one head; chunks of whole tiles
        assert plan["threads"] == plan["units"] * plan["split"] * 32
        assert plan["units"] == min(max(1, 4 // plan["split"]),
                                    math.ceil(t / TILE))
        assert plan["grid"] == bn * math.ceil(t / (TILE * plan["units"]))
        assert plan["rows"] % TILE == 0
        # two buffers where they fit
        two = _smem(dict(plan, stages=2), item)
        assert plan["stages"] == (2 if two <= SMEM_LIMIT else 1)
    owned = _owners(plan, bn, t)
    want = {(h, tile, ws) for h in range(bn)
            for tile in range(math.ceil(t / TILE))
            for ws in range(plan["split"])}
    assert set(owned) == want and set(owned.values()) == {1}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_strides_keep_fragment_reads_in_distinct_banks(bwd_plan, shape,
                                                       dtype):
    """16-byte rows for cp.async and ldmatrix; rows g = 0..7 of a fragment
    4 words apart mod 32 (q, k, v, do; the fused kernel's ds); the f32 B
    reads of rows 2 t4, t4 = 0..3, in distinct quarters of the banks."""
    item = 2 if dtype == torch.bfloat16 else 4
    for plan in (bwd_plan(*shape, dtype), bwd_plan(*shape, dtype, True)):
        lds = [plan["ld"]] + ([plan["ldd"]] if plan["fused"] else [])
        for ld in lds:
            assert ld * item % 16 == 0
            w = ld * item // 4
            assert sorted(g * w % 32 for g in range(8)) == list(
                range(0, 32, 4))
        if item == 4:
            w = plan["ld"]
            assert sorted(2 * t4 * w % 32 // 8 for t4 in range(4)) == [
                0, 1, 2, 3]
        assert plan["ld"] >= plan["split"] * plan["dw"]


def test_the_models_shape_fuses_four_heads_a_cta(bwd_plan):
    """(256, 4, 30, 8): one launch, four heads a CTA, two warps a head, one
    tile a warp in each phase; the sweeps take the same shape apart."""
    plan = bwd_plan(1024, 4, 30, 8, torch.float32)
    assert plan == dict(fused=True, split=1, dw=8, units=4, wph=2, rows=32,
                        stages=1, ld=12, ldd=36, grid=256,
                        smem=plan["smem"], threads=256)
    sweeps = bwd_plan(1024, 4, 30, 8, torch.float32, sweeps=True)
    assert not sweeps["fused"] and sweeps["units"] == 2


@pytest.mark.parametrize("t", [1, 16, 30, 128, 129, 1024])
@pytest.mark.parametrize("d", [1, 8, 64, 65, 512])
def test_fused_exactly_where_heads_are_resident(bwd_plan, t, d):
    for dtype in DTYPES:
        assert bwd_plan(4, 2, t, d, dtype)["fused"] == (t <= 128 and d <= 64)


def test_the_reported_fields_are_the_headers_in_order():
    n = int(re.search(r"kPlanFields = (\d+);", _HEADER)[1])
    body = re.search(r"struct Geometry \{(.*?)\};", _HEADER, re.S)[1]
    fields = re.findall(r"\w+", re.sub(r"//[^\n]*|\bint\b", "", body))
    assert tuple(fields[:n]) == ak.BWD_PLAN_FIELDS


@pytest.mark.parametrize("args, error", [
    ((4, 4, 30, 513, torch.float32), ValueError),
    ((4, 4, 0, 8, torch.float32), ValueError),
    ((6, 4, 30, 8, torch.float32), ValueError),
    ((4, 4, 30, 8, torch.float64), TypeError)])
def test_plan_refuses_what_the_kernels_do_not_take(bwd_plan, args, error):
    with pytest.raises(error):
        bwd_plan(*args)


# -- the plain version and the gradients -----------------------------------------


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _key_mask(b, t, seed):
    """Ragged valid lengths 1..T: every row sees at least its first key."""
    lengths = np.random.default_rng(seed).integers(1, t + 1, size=b)
    return np.arange(t)[None, :] < lengths[:, None]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_reference_is_the_two_plain_sweeps(dtype, causal, masked):
    b, n, t, d = 3, 2, 20, 8
    q, k, v, do = (torch.from_numpy(_normal((b, n, t, d), s)).to(dtype)
                   for s in range(4))
    key_mask = torch.from_numpy(_key_mask(b, t, 5)) if masked else None
    kw = dict(causal=causal, key_mask=key_mask)
    o, lse = ak.flash_fwd_reference(q, k, v, **kw)
    dlse = torch.from_numpy(_normal((b, n, t), 6, 0.5))
    args = (q, k, v, do, lse, ak.flash_delta(o, do, dlse))
    dq, dk, dv = ak.flash_bwd_reference(*args, **kw)
    want_dk, want_dv = ak.flash_dkv_reference(*args, **kw)
    assert torch.equal(dq, ak.flash_dq_reference(*args, **kw))
    assert torch.equal(dk, want_dk) and torch.equal(dv, want_dv)
    assert dq.dtype == dk.dtype == dv.dtype == dtype


def _jax_mha_with_lse(causal, mask):
    """``fmda_tpu.ops.attention.mha`` and the lse of its online state."""
    def fn(q, k, v):
        t = q.shape[-2]
        full = None
        if causal:
            full = jnp.arange(t)[:, None] >= jnp.arange(t)[None, :]
        if mask is not None:
            full = mask if full is None else full & mask
        o = jax_attention.mha(q, k, v, causal=causal, mask=mask)
        state = jax_attention.online_attention_block(
            jax_attention.init_online_state(q.shape[0], q.shape[1], t,
                                            q.shape[-1]), q, k, v, full)
        return o, state.m + jnp.log(state.l)
    return fn


#: (reference, (B, N, T, D), masked): JAX's mha at the model's window,
#: causal and masked; the Pallas kernels in interpret mode at one 128-key
#: block (no mask: outside their envelope)
GRAD_CASES = ([("mha", (4, 4, 30, 8), masked) for masked in (False, True)]
              + [("pallas", (2, 2, 128, 8), False)])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ref, shape, masked", GRAD_CASES)
def test_grads_through_flash_bwd_match_jax(monkeypatch, ref, shape, masked,
                                           dtype, causal):
    """o, lse and the three input gradients of sum(o do) + sum(lse dlse),
    the backward one call of ``flash_bwd``."""
    calls = []
    real = ak.flash_bwd

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(ak, "flash_bwd", spy)
    arrays = [_normal(shape, 10 + i) for i in range(3)]
    cot, dlse = _normal(shape, 13), _normal(shape[:-1], 14, scale=0.5)
    keep = _key_mask(shape[0], shape[2], 15) if masked else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if ref == "mha":
        fn = _jax_mha_with_lse(
            causal, None if keep is None
            else jnp.asarray(keep)[:, None, None, :])
    else:
        def fn(q, k, v):
            return jax_flash_with_lse(q, k, v, causal=causal, interpret=True)
    (o_want, lse_want), vjp = jax.vjp(
        fn, *[jnp.asarray(a).astype(jdt) for a in arrays])
    grads_want = vjp((jnp.asarray(cot).astype(jdt), jnp.asarray(dlse)))

    q, k, v = (torch.from_numpy(a).to(tdt).requires_grad_(True)
               for a in arrays)
    o, lse = ak.flash_attention_with_lse(
        q, k, v, causal=causal,
        key_mask=None if keep is None else torch.from_numpy(keep))
    ((o.float() * torch.from_numpy(cot).to(tdt).float()).sum()
     + (lse * torch.from_numpy(dlse)).sum()).backward()
    assert len(calls) == 1 and calls[0]["causal"] == causal
    tol = F32_TOL if dtype == "float32" else BF16_TOL

    def close(got, want, atol):
        np.testing.assert_allclose(
            got.detach().float().numpy(),
            np.asarray(jnp.asarray(want).astype(jnp.float32)), atol=atol,
            rtol=0)

    close(o, o_want, tol)
    close(lse, lse_want, F32_TOL if dtype == "float32" else 1e-4)
    for got, want in zip((q.grad, k.grad, v.grad), grads_want):
        assert got.dtype == tdt
        close(got, want, tol)


def test_cpu_calls_leave_every_counter_at_zero(monkeypatch):
    """The plain versions run on CPU tensors and launch nothing."""
    counters = ("fwd_launches", "dkv_launches", "dq_launches", "bwd_launches")
    for name in counters:
        monkeypatch.setattr(ak, name, 0)
    shape = (2, 2, 30, 8)
    q, k, v, do = (torch.from_numpy(_normal(shape, s)) for s in range(4))
    key_mask = torch.from_numpy(_key_mask(2, 30, 7))
    kw = dict(causal=True, key_mask=key_mask)
    o, lse = ak.flash_fwd(q, k, v, **kw)
    args = (q, k, v, do, lse, ak.flash_delta(o, do, torch.zeros(shape[:3])))
    ak.flash_dkv(*args, **kw)
    ak.flash_dq(*args, **kw)
    ak.flash_bwd(*args, **kw)
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    ak.flash_attention(qg, kg, vg, **kw).sum().backward()
    assert qg.grad is not None
    assert {name: getattr(ak, name) for name in counters} == dict.fromkeys(
        counters, 0)
