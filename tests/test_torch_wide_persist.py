"""fmda_tpu_torch's persistent LSTM scans (the wide route's one launch a
direction, ``csrc/lstm_persist.cu``) on the CPU: their plan and their plain
versions.

- The plan's Python copy (``_cuda_lib.persist_plan``) pinned at the H100's
  figures: which (B, H, dtype) the persistent kernels take, with P, Q and
  the cluster at (512, 1024) bf16, (256, 512) f32 and B = 1, the
  hand-back past what the grid's shared memory holds; every plan within
  the card's figures.
- The route's choice: the plan decides before any call, the persistent
  scan where it lays the scan out, the per-step gate kernels elsewhere.
- The persistent scans' plain versions (``lstm_persist_scan_reference``,
  ``lstm_persist_sweep_reference``), driven through the route's autograd
  Function with a plan forced to several batch tiles and unit slices,
  against ``fmda_tpu.ops.lstm.lstm_scan`` and ``jax.grad`` of it on
  numpy-seeded inputs: forward and gradients (dxp, dh0, dc0, dW_hh,
  db_hh), masked and not, both directions.
- The launch counters are 0 at import, and CPU tensors launch nothing.

Tolerances as ``test_torch_wide_scan.py``'s: 1e-5 in float32; 2e-2 in
bfloat16, compared in float32, the gradients against jax.grad of lax.scan
in float32 on the bf16 values, each relative to its largest entry.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmda_tpu.ops.lstm import lstm_scan as jax_lstm_scan

from fmda_tpu_torch.ops import _cuda_lib, launch_counts, lstm, wide_scan
from fmda_tpu_torch.ops.cost import persist_sweep_cost, scan_cost

F32_TOL = 1e-5
BF16_TOL = 2e-2
B, T, H = 5, 6, 32
H100 = _cuda_lib.H100_FIGURES
#: a small card whose plan cuts (B, H) = (5, 32) into 4 slices of 8 units
#: (its batch tiles need B > 16: the forced plans below set them by hand)
SMALL = dict(sms=8, smem=65536, clusters={1: 8, 2: 4, 4: 2, 8: 1})
DTYPES = {"float32": (torch.float32, F32_TOL),
          "bfloat16": (torch.bfloat16, BF16_TOL)}


def _plan(**fields):
    return _cuda_lib.persist_plan(fields.pop("batch"), fields.pop("hidden"),
                                  fields.pop("itemsize"), **H100)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,hidden,itemsize,want", [
    # flagship_wide: 128 CTAs, a cluster each (one ran no slower than two
    # on the H100; the card holds 15 clusters of 8, not 16)
    (512, 1024, 2, dict(tiles=2, slices=64, units=16, cluster=1, chunk=64,
                        stages=3, mt=4, mt_bwd=2, rows=256, grid=128)),
    (256, 512, 4, dict(tiles=4, slices=32, units=16, cluster=1, chunk=128,
                       stages=3, mt=1, mt_bwd=1, rows=64, grid=128)),
    # the Predictor's and the stream's B = 1: every SM a slice of W_hh
    (1, 1024, 2, dict(tiles=1, slices=128, units=8, cluster=1, chunk=256,
                      stages=16, mt=1, mt_bwd=1, rows=1, grid=128)),
    (1, 1024, 4, dict(tiles=1, slices=128, units=8, cluster=1, chunk=128,
                      stages=12, mt=1, mt_bwd=1, rows=1, grid=128)),
    (256, 1024, 2, dict(tiles=2, slices=64, units=16, cluster=1, chunk=128,
                        stages=3, mt=2, mt_bwd=1, rows=128, grid=128)),
    # a larger cluster only where a CTA's share of a chunk would pass a
    # TMA box's 256 rows: one tile of 288 rows, 144 a CTA, multicast
    (288, 768, 4, dict(tiles=1, slices=96, units=8, cluster=2, rows=288,
                       rows_pad=288, grid=96)),
])
def test_plan_pinned_at_the_h100(batch, hidden, itemsize, want):
    plan = _plan(batch=batch, hidden=hidden, itemsize=itemsize)
    assert plan is not None
    assert {k: plan[k] for k in want} == want
    assert plan["smem"] <= H100["smem"]
    assert plan["rows_pad"] % 16 == 0 and plan["rows_pad"] >= plan["rows"]


@pytest.mark.parametrize("batch,hidden,itemsize", [
    (512, 2048, 2),   # W_hh 33.5 MB in bf16: more than the grid holds
    (512, 1600, 2),   # fits at B = 1 (below), not beside B = 512's ring
    (1, 1152, 4),     # past ~1,150 in f32
    (512, 1024, 4),   # f32 W_hh's slices leave room for one chunk of 512
    (512, 1030, 2),   # H not a multiple of 8 (the units' groups)
    (3, 48, 2),       # the 128-byte chunk (64 bf16 columns) divides 48
    (3, 48, 4),       # nor its 32 float32 columns
])
def test_plan_hands_back_past_the_limit(batch, hidden, itemsize):
    assert _plan(batch=batch, hidden=hidden, itemsize=itemsize) is None


def test_plan_at_b1_fits_where_the_ring_is_small():
    plan = _plan(batch=1, hidden=1600, itemsize=2)
    assert plan is not None and plan["slices"] == 100
    assert plan["cluster"] == 1  # the smallest cluster that fits


@pytest.mark.parametrize("itemsize", [2, 4])
def test_every_plan_fits_the_card(itemsize):
    """Whatever (B, H) it lays out, the plan keeps to the card's figures:
    the grid resident in clusters, the shared memory, the consumer warps,
    whole chunks and unit slices, a CTA's share of a chunk one TMA box."""
    for batch in (1, 2, 17, 64, 255, 256, 512, 800):
        for hidden in (64, 128, 256, 512, 768, 1024, 1536):
            plan = _plan(batch=batch, hidden=hidden, itemsize=itemsize)
            if plan is None:
                continue
            c = plan["cluster"]
            assert plan["grid"] == plan["tiles"] * plan["slices"]
            assert plan["grid"] <= H100["clusters"][c] * c
            assert plan["slices"] % c == 0
            assert plan["units"] * plan["slices"] == hidden
            assert hidden % plan["chunk"] == 0
            assert plan["chunk"] * itemsize // 128 in (1, 2, 4)
            assert plan["tiles"] * plan["rows"] >= batch
            assert (plan["tiles"] - 1) * plan["rows"] < batch
            assert plan["smem"] <= H100["smem"]
            assert plan["rows_pad"] // c <= _cuda_lib.PERSIST_MAX_BOX_ROWS
            mtiles, nt = plan["rows_pad"] // 16, plan["units"] // 8
            assert -(-mtiles // plan["mt"]) * nt <= _cuda_lib.PERSIST_WARPS
            assert -(-mtiles // plan["mt_bwd"]) <= _cuda_lib.PERSIST_WARPS
            assert plan["mt_bwd"] * nt <= _cuda_lib.PERSIST_MAX_BWD_TILES


@pytest.mark.parametrize("batch,hidden,itemsize,warps", [
    (1, 1024, 2, (1, 1)),     # one warp's product: 8 groups split K
    (512, 1024, 2, (8, 8)),   # every warp busy: no split
])
def test_small_batches_split_k_over_idle_warps(batch, hidden, itemsize,
                                               warps):
    """Where a step's product needs fewer consumer warps than the CTA has,
    the plan's shared memory holds the K-split's scratch (bf16): (ksplit
    - 1) groups of the product's warps, a lane's partial sums each; a
    float32 plan has none."""
    plan = _plan(batch=batch, hidden=hidden, itemsize=itemsize)
    mtiles, nt = plan["rows_pad"] // 16, plan["units"] // 8
    fwd_warps = -(-mtiles // plan["mt"]) * nt
    bwd_warps = -(-mtiles // plan["mt_bwd"])
    assert (fwd_warps, bwd_warps) == warps
    split = _cuda_lib.persist_ksplit
    assert split(1) == 8 and split(3) == 2 and split(8) == 1
    scratch = max((split(fwd_warps) - 1) * fwd_warps * 32 * 16 * plan["mt"],
                  (split(bwd_warps) - 1) * bwd_warps * 32 * 4
                  * plan["mt_bwd"] * nt) * 4
    slot = plan["chunk"] * itemsize * plan["rows_pad"]
    assert plan["smem"] == (plan["ring_off"] + plan["stages"] * slot
                            + _cuda_lib.PERSIST_BARRIER_BYTES + scratch
                            + _cuda_lib.PERSIST_ALIGN_BYTES)
    f32 = _plan(batch=batch, hidden=hidden, itemsize=4)
    if f32 is not None:
        f32_slot = f32["chunk"] * 4 * f32["rows_pad"]
        assert f32["smem"] == (f32["ring_off"] + f32["stages"] * f32_slot
                               + _cuda_lib.PERSIST_BARRIER_BYTES
                               + _cuda_lib.PERSIST_ALIGN_BYTES)


def test_the_lstm_route_decides_by_the_plan(monkeypatch):
    """The route asks the plan before any call: the persistent scan where
    it lays the scan out (H = 1024 f32 at B = 2), the per-step kernels
    where it does not (bf16 H = 48)."""
    calls = {"persist": 0, "steps": 0}
    real_fwd, real_gates = wide_scan.lstm_persist_fwd, wide_scan.lstm_wide_gates

    def persist(*a, **k):
        calls["persist"] += 1
        return real_fwd(*a, **k)

    def steps(*a, **k):
        calls["steps"] += 1
        return real_gates(*a, **k)

    monkeypatch.setattr(wide_scan, "lstm_persist_fwd", persist)
    monkeypatch.setattr(wide_scan, "lstm_wide_gates", steps)
    r = np.random.default_rng(0)
    for batch, hidden, dtype, want in ((2, 1024, torch.float32, (1, 0)),
                                       (2, 48, torch.bfloat16, (0, 3))):
        calls.update(persist=0, steps=0)
        xp = torch.from_numpy(r.normal(size=(batch, 3, 4 * hidden))).to(dtype)
        state = torch.zeros(batch, hidden, dtype=dtype)
        w = torch.zeros(4 * hidden, hidden, dtype=dtype)
        with torch.inference_mode():
            wide_scan.lstm_wide_scan(xp, state, state, w, w[:, 0])
        assert (calls["persist"], calls["steps"]) == want, (batch, hidden)


# ---------------------------------------------------------------------------
# the plain versions against the reference
# ---------------------------------------------------------------------------


def _forced_plan(tiles):
    """A plan of (B, H) = (5, 32) with ``tiles`` batch tiles and 4 slices
    of 8 units: the layout a smaller card would take, for the slicing."""
    plan = _cuda_lib.persist_plan(B, H, 4, **SMALL)
    assert plan is not None and plan["slices"] == 4 and plan["units"] == 8
    rows = -(-B // tiles)
    return dict(plan, tiles=tiles, rows=rows, rows_pad=16 * (-(-rows // 16)),
                grid=tiles * plan["slices"])


def _inputs(*, seed):
    r = np.random.default_rng(seed)
    gh, s = 4 * H, 1.0 / np.sqrt(H)
    xp = r.normal(size=(B, T, gh)).astype(np.float32)
    init = [(0.5 * r.normal(size=(B, H))).astype(np.float32)
            for _ in range(2)]
    w = r.uniform(-s, s, size=(gh, H)).astype(np.float32)
    b = r.uniform(-s, s, size=(gh,)).astype(np.float32)
    cots = [r.normal(size=(B, H)).astype(np.float32) for _ in range(2)]
    cots.append(r.normal(size=(B, T, H)).astype(np.float32))
    return [xp, *init, w, b], cots


def _mask(seed=3):
    lengths = np.random.default_rng(seed).integers(1, T + 1, size=B)
    lengths[0] = T
    return np.arange(T)[None, :] < lengths[:, None]


def _jax_outputs(args, mask, reverse):
    m = None if mask is None else jnp.asarray(mask)
    (h_last, c_last), hs = jax_lstm_scan(*args, reverse=reverse, mask=m)
    return [h_last, c_last, hs]


def _port_outputs(args, mask, reverse):
    m = None if mask is None else torch.from_numpy(mask)
    (h_last, c_last), hs = wide_scan.lstm_wide_scan(*args, reverse=reverse,
                                                    mask=m)
    return [h_last, c_last, hs]


CASES = [(tiles, reverse, masked) for tiles in (1, 2)
         for reverse in (False, True) for masked in (False, True)]


@pytest.fixture
def forced(monkeypatch):
    """Route every LSTM scan through the persistent path with a given plan,
    counting the wrappers' calls."""
    calls = []

    def force(plan):
        monkeypatch.setattr(wide_scan, "lstm_persist_plan",
                            lambda *a, **k: plan)
        for name in ("lstm_persist_fwd", "lstm_persist_bwd"):
            real = getattr(wide_scan, name)
            monkeypatch.setattr(
                wide_scan, name,
                lambda *a, _r=real, _n=name, **k: calls.append(_n)
                or _r(*a, **k))
        return calls

    return force


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tiles,reverse,masked", CASES)
def test_persistent_forward_matches_lax_scan(tiles, reverse, masked, dtype,
                                             forced):
    tdtype, tol = DTYPES[dtype]
    calls = forced(_forced_plan(tiles))
    arrays, _ = _inputs(seed=0)
    mask = _mask() if masked else None
    jdtype = jnp.float32 if tdtype is torch.float32 else jnp.bfloat16
    want = _jax_outputs([jnp.asarray(a, jdtype) for a in arrays], mask,
                        reverse)
    with torch.inference_mode():
        got = _port_outputs([torch.from_numpy(a).to(tdtype) for a in arrays],
                            mask, reverse)
    assert calls == ["lstm_persist_fwd"]
    for g, w in zip(got, want):
        assert g.dtype == tdtype
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tiles,reverse,masked", CASES)
def test_persistent_backward_matches_jax_grad(tiles, reverse, masked, dtype,
                                              forced):
    """dxp, dh0, dc0, dW_hh and db_hh of sum(cot * outputs) through the
    route's autograd Function on the persistent path, against jax.grad of
    lax.scan (in bf16: on the bf16 values, in float32, each gradient
    relative to its largest entry)."""
    tdtype, tol = DTYPES[dtype]
    calls = forced(_forced_plan(tiles))
    arrays, cots = _inputs(seed=1)
    mask = _mask(seed=5) if masked else None
    if tdtype is torch.bfloat16:
        arrays, cots = ([torch.from_numpy(a).to(tdtype).float().numpy()
                         for a in group] for group in (arrays, cots))
    jcots = [jnp.asarray(c) for c in cots]

    def loss(*args):
        outs = _jax_outputs(args, mask, reverse)
        return sum(jnp.sum(o * c) for o, c in zip(outs, jcots))

    want = jax.grad(loss, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    args = [torch.from_numpy(a).to(tdtype).requires_grad_() for a in arrays]
    outs = _port_outputs(args, mask, reverse)
    total = sum(torch.sum((o * torch.from_numpy(c).to(tdtype)).float())
                for o, c in zip(outs, cots))
    got = torch.autograd.grad(total, args)
    assert calls == ["lstm_persist_fwd", "lstm_persist_bwd"]
    for name, g, w in zip(["dxp", "dh0", "dc0", "dw_hh", "db_hh"], got, want):
        assert g.dtype == tdtype, name
        w = np.asarray(w, np.float32)
        scale = float(np.abs(w).max()) if tdtype is torch.bfloat16 else 1.0
        np.testing.assert_allclose(g.float().numpy(), w, atol=tol * scale,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_plain_versions_agree_across_layouts(masked):
    """The slicing is layout only: every plan of one scan gives the same
    values, the sweep's with them (within 1e-6: the CPU's products sum a
    row in an order that depends on how many rows they take)."""
    arrays, cots = _inputs(seed=2)
    xp, h0, c0, w, b = (torch.from_numpy(a) for a in arrays)
    mask = torch.from_numpy(_mask()).to(torch.uint8) if masked else None
    ref = None
    for tiles in (1, 2, 3):
        plan = _forced_plan(tiles)
        hs, cs = wide_scan.lstm_persist_scan_reference(xp, h0, c0, w, b, plan,
                                                       mask=mask)
        hh = wide_scan._recompute_hh(
            wide_scan.h_prev_of(h0, hs), w, b)
        swept = wide_scan.lstm_persist_sweep_reference(
            xp, hh, c0, cs, w, torch.from_numpy(cots[2]),
            torch.from_numpy(cots[0]), torch.from_numpy(cots[1]), plan,
            mask=mask)
        outs = [hs, cs, *swept]
        if ref is None:
            ref = outs
        for o, r in zip(outs, ref):
            np.testing.assert_allclose(o.numpy(), r.numpy(), atol=1e-6)


def test_lstm_layer_at_width_runs_the_persistent_scan(forced):
    """``lstm_layer`` above the pair's envelope reaches the persistent
    wrappers through ``select_lstm_scan_fn`` (H = 1024 is the wide
    route)."""
    calls = forced(_cuda_lib.persist_plan(2, 1024, 4, **H100))
    r = np.random.default_rng(4)
    feats, hidden = 6, 1024
    weights = lstm.LSTMWeights(*(torch.from_numpy(
        (0.03 * r.normal(size=shape)).astype(np.float32)) for shape in (
            (4 * hidden, feats), (4 * hidden, hidden), (4 * hidden,),
            (4 * hidden,))))
    x = torch.from_numpy(r.normal(size=(2, 3, feats)).astype(np.float32))
    with torch.inference_mode():
        (h_last, c_last), hs = lstm.lstm_layer(x, weights)
    assert calls == ["lstm_persist_fwd"]
    assert hs.shape == (2, 3, hidden) and torch.equal(h_last, hs[:, -1])


# ---------------------------------------------------------------------------
# counters and costs
# ---------------------------------------------------------------------------


def test_persist_counters_are_zero_at_import_and_cpu_launches_nothing():
    code = ("from fmda_tpu_torch.ops import wide_scan as w, launch_counts\n"
            "assert w.lstm_persist_fwd_launches == 0\n"
            "assert w.lstm_persist_bwd_launches == 0\n"
            "c = launch_counts()\n"
            "assert c['lstm_persist_fwd'] == c['lstm_persist_bwd'] == 0\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    arrays, _ = _inputs(seed=6)
    before = launch_counts()
    with torch.inference_mode():
        _port_outputs([torch.from_numpy(a) for a in arrays], None, False)
    assert launch_counts() == before


def test_persist_costs_count_the_sweep_and_the_scan():
    fwd = scan_cost(512, 30, 1024, 2, False, gates=4, states=2,
                    elementwise=14)
    assert fwd.product_flops == 2 * 512 * 30 * 4096 * 1024
    sweep = persist_sweep_cost(512, 30, 1024, 2, True)
    assert sweep.product_flops == 2 * 512 * 30 * 4096 * 1024
    assert sweep.elementwise_flops == 40 * 512 * 30 * 1024
    bt, gh = 512 * 30, 4096
    assert sweep.bytes_moved == (2 * (bt * (3 * gh + 2 * 1024) + 512 * 1024
                                      + gh * 1024)
                                 + 16 * 512 * 1024 + bt)
