"""The flash forward's plan, on the CPU.

``csrc/flash_fwd_plan.cc`` lays out each launch of the forward kernel
(``csrc/flash_fwd.cu``): the warps that share a 16-row query tile and the
dims each holds, the query tiles a CTA holds, whether K and V stay resident
or stream through one or two buffers, the shared-memory strides and bytes.
It is plain C++, so these tests build it alone with the host's C++
compiler and read it through :func:`flash_fwd_plan`, as the card's library
is read, holding it to the rules the kernel relies on at the shapes the
paths and ``chip_smoke.py`` use and across the envelope.
"""

import ctypes
import math
import re
import shutil
import subprocess

import pytest
import torch

from fmda_tpu_torch.ops import _cuda_lib
from fmda_tpu_torch.ops import attention_kernel as ak

_PLAN_SOURCE = _cuda_lib._CSRC / "flash_fwd_plan.cc"
_PLAN_HEADER = _cuda_lib._CSRC / "flash_fwd_plan.h"
_HEADER = _PLAN_HEADER.read_text()
SMEM_LIMIT = int(re.search(r"kSmemLimit = (\d+) \* 1024", _HEADER)[1]) * 1024
RESIDENT_SMEM = int(
    re.search(r"kResidentSmem = (\d+) \* 1024", _HEADER)[1]) * 1024
P_PAD = int(re.search(r"kPadP = (\d+);", _HEADER)[1])

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    """``flash_fwd_plan.cc`` alone, built by the host's C++ compiler."""
    out = tmp_path_factory.mktemp("flash_plan") / "libflash_fwd_plan.so"
    subprocess.run([shutil.which("c++") or "g++", "-std=c++17", "-O1",
                    "-shared", "-fPIC", "-o", str(out), str(_PLAN_SOURCE)],
                   check=True)
    return ctypes.CDLL(str(out))


@pytest.fixture
def flash_fwd_plan(plan_lib):
    def plan(bn, n, t, d, dtype):
        return ak.flash_fwd_plan(bn, n, t, d, dtype, lib=plan_lib)
    return plan


def threads(plan):
    return plan["units"] * (plan["wph"] if plan["resident"]
                            else plan["split"]) * 32


def smem(item, split, units, wph, resident, keys, tk, stages, ldq, ldk, ldv):
    """The bytes a forward CTA takes, reckoned from the kernel's regions
    apart from the plan's own reckoning: the K and V tiles, the key flags,
    each warp's q tile, the f32 p buffers, the split warps' partial
    scores, each 16-byte aligned."""
    def align(x):
        return -(-x // 16) * 16
    regions = units if resident else 1
    warps = units * (wph if resident else split)
    off = align(regions * stages * tk * ldk * item)
    off = align(off + regions * stages * tk * ldv * item)
    off = align(off + regions * stages * tk)
    off = align(off + warps * 16 * ldq * item)
    off = align(off + (warps * 16 * (keys + P_PAD) * 4 if item == 4 else 0))
    return align(off + (units * 2048 * 4 if split > 1 else 0))


def plan_smem(plan, item, **override):
    keys = ("split", "units", "wph", "resident", "keys", "tk", "stages",
            "ldq", "ldk", "ldv")
    return smem(item, **{k: override.get(k, plan[k]) for k in keys})
#: (B*N, N, T, D): the model's, the Predictor's, long context, the D
#: envelope, ragged and odd shapes
SHAPES = [(1024, 4, 30, 8), (4, 4, 30, 8), (64, 4, 1024, 8),
          (16, 2, 256, 64), (2, 1, 128, 512), (3, 3, 129, 65),
          (5, 5, 7, 3), (6, 2, 1, 1), (4, 4, 128, 64), (8, 4, 300, 200),
          (2, 2, 64, 100), (3, 1, 17, 257)]


@pytest.mark.parametrize("d, split, dw_f32, dw_bf16", [
    (1, 1, 8, 16), (8, 1, 8, 16), (9, 1, 16, 16), (16, 1, 16, 16),
    (17, 1, 32, 32), (33, 1, 64, 64), (64, 1, 64, 64), (65, 2, 64, 64),
    (128, 2, 64, 64), (129, 4, 64, 64), (256, 4, 64, 64), (257, 8, 64, 64),
    (512, 8, 64, 64)])
def test_dims_go_to_whole_k_steps_and_at_most_64_a_warp(
        flash_fwd_plan, d, split, dw_f32, dw_bf16):
    for dtype, dw in ((torch.float32, dw_f32), (torch.bfloat16, dw_bf16)):
        plan = flash_fwd_plan(4, 2, 300, d, dtype)
        assert (plan["split"], plan["dw"]) == (split, dw)
        assert plan["split"] * plan["dw"] >= d


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_fits_the_card_and_covers_every_query_tile(flash_fwd_plan,
                                                        shape, dtype):
    bn, n, t, d = shape
    plan = flash_fwd_plan(bn, n, t, d, dtype)
    item = 2 if dtype == torch.bfloat16 else 4
    assert plan["smem"] == plan_smem(plan, item)
    assert plan["smem"] <= SMEM_LIMIT and plan["smem"] % 16 == 0
    assert 32 <= threads(plan) <= 256
    assert plan["tk"] % 16 == 0 and plan["stages"] in (1, 2)
    if plan["resident"]:  # each unit a whole head; every head has a unit
        assert plan["split"] == 1
        assert t <= plan["tk"] <= ak.SOFTMAX_BLOCK
        assert plan["stages"] == 1
        assert plan["grid"] == math.ceil(bn / plan["units"])
        assert plan["units"] == 1 or plan["smem"] <= RESIDENT_SMEM
        # the head's query tiles, shared by its warps: none idle
        assert 1 <= plan["wph"] <= math.ceil(t / 16)
        assert plan["units"] * plan["wph"] <= 8
        # a short window's scores fit 32 keys of registers
        assert plan["keys"] == (32 if t <= 32 and plan["dw"] <= 16 else 128)
    else:  # a block of keys is `split` tiles; every query row has a warp
        assert plan["tk"] == ak.SOFTMAX_BLOCK // plan["split"]
        assert plan["units"] == max(1, 4 // plan["split"])
        assert plan["wph"] == 1
        assert plan["keys"] == ak.SOFTMAX_BLOCK
        assert plan["grid"] == bn * math.ceil(t / (16 * plan["units"]))
        two = plan_smem(plan, item, stages=2)
        assert plan["stages"] == (2 if two <= SMEM_LIMIT else 1)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_strides_keep_fragment_reads_in_distinct_banks(flash_fwd_plan, shape,
                                                       dtype):
    """The row strides the kernel's loads rely on: 16-byte rows for
    cp.async and ldmatrix; for an mma fragment, 8 rows (K, q, bf16 V)
    or 4 rows (f32 V) 4 words apart in distinct banks."""
    plan = flash_fwd_plan(*shape, dtype)
    item = 2 if dtype == torch.bfloat16 else 4
    ldq, ldk, ldv = plan["ldq"], plan["ldk"], plan["ldv"]
    for ld in (ldq, ldk, ldv):
        assert ld * item % 16 == 0
    words = [ld * item // 4 for ld in (ldq, ldk)]
    if dtype == torch.bfloat16:
        words.append(ldv * item // 4)
    for w in words:  # rows g = 0..7 start 4 words apart, mod 32
        assert sorted(g * w % 32 for g in range(8)) == list(range(0, 32, 4))
    if dtype == torch.float32:  # V's B fragment: rows t4 = 0..3, 8 apart
        assert sorted(r * ldv % 32 for r in range(4)) == [0, 8, 16, 24]
    dims = plan["split"] * plan["dw"]
    assert ldk >= dims and ldv >= dims and ldq >= plan["dw"]


def test_the_models_shape_is_resident_four_heads_a_cta(flash_fwd_plan):
    """(256, 4, 30, 8): four heads a CTA, one query tile a warp."""
    plan = flash_fwd_plan(1024, 4, 30, 8, torch.float32)
    assert plan == dict(split=1, dw=8, units=4, wph=2, resident=True,
                        keys=32, tk=32, stages=1, ldq=12, ldk=12, ldv=8,
                        grid=256, smem=plan["smem"])
    assert threads(plan) == 256


def test_resident_units_shrink_to_the_budget(flash_fwd_plan):
    # T = 128 at D = 64 in f32: four resident heads would take ~290 KB
    plan = flash_fwd_plan(8, 2, 128, 64, torch.float32)
    assert plan["resident"] and (plan["units"], plan["wph"]) == (1, 8)
    plan = flash_fwd_plan(8, 2, 128, 64, torch.bfloat16)
    assert (plan["units"], plan["wph"]) == (2, 4)


def test_one_buffer_where_two_do_not_fit(flash_fwd_plan):
    assert flash_fwd_plan(2, 1, 128, 512, torch.float32)["stages"] == 1
    assert flash_fwd_plan(2, 1, 128, 512, torch.bfloat16)["stages"] == 2


def test_the_reported_fields_are_the_headers_in_order():
    """The query reports Geometry's first kPlanFields fields, and
    FWD_PLAN_FIELDS names them in that order."""
    n = int(re.search(r"kPlanFields = (\d+);", _HEADER)[1])
    body = re.search(r"struct Geometry \{(.*?)\};", _HEADER, re.S)[1]
    fields = re.findall(r"\w+", re.sub(r"//[^\n]*|\bint\b", "", body))
    assert tuple(fields[:n]) == ak.FWD_PLAN_FIELDS


@pytest.mark.parametrize("args, error", [
    ((4, 4, 30, 513, torch.float32), ValueError),
    ((4, 4, 0, 8, torch.float32), ValueError),
    ((6, 4, 30, 8, torch.float32), ValueError),
    ((4, 4, 30, 8, torch.float64), TypeError)])
def test_plan_refuses_what_the_kernel_does_not_take(flash_fwd_plan, args,
                                                    error):
    with pytest.raises(error):
        flash_fwd_plan(*args)
