"""fmda_tpu_torch's attention ops against the JAX package's, on the CPU.

The plain version of the flash kernels (what ``flash_attention_with_lse``
runs on CPU tensors: the forward's online softmax over 128-key blocks and
the explicit dK/dV and dQ backward) is held to ``fmda_tpu.ops.attention
.mha`` at the model's window (T = 30, where the reference never runs its
kernel) and to ``flash_attention_with_lse(interpret=True)``, the Pallas
kernels in interpret mode, at T = 128 and 256; then the online-softmax
primitives, the segment merge and the head reshapes.  Inputs are
numpy-seeded.  Tolerances: 1e-5 in float32 and 2e-2 in bf16 where the two
sides block the key axis alike, 2e-5 where they do not (the tolerance
``tests/test_pallas_attention.py`` itself uses between flash and ``mha``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmda_tpu.ops import attention as jax_attention
from fmda_tpu.ops.pallas_attention import (
    flash_attention_with_lse as jax_flash_with_lse,
)

from fmda_tpu_torch.ops import attention, attention_kernel
from fmda_tpu_torch.ops.attention_kernel import (
    NEG,
    flash_attention,
    flash_attention_with_lse,
)

F32_TOL = 1e-5
BF16_TOL = 2e-2
UNBLOCKED_TOL = 2e-5


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _qkv(shape, seed=0):
    return [_normal(shape, seed + i) for i in range(3)]


def _torch(arrays, dtype=torch.float32, grad=False):
    return [torch.from_numpy(a).to(dtype).requires_grad_(grad)
            for a in arrays]


def _jax(arrays, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x).astype(jnp.float32))


def _port_vjp(q, k, v, do, dlse=None, **kw):
    """The port's (o, lse) and the gradients of sum(o do) + sum(lse dlse)."""
    o, lse = flash_attention_with_lse(q, k, v, **kw)
    loss = (o.float() * do).sum()
    if dlse is not None:
        loss = loss + (lse * dlse).sum()
    loss.backward()
    return o, lse, (q.grad, k.grad, v.grad)


def _assert_close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_jax_mha_at_the_window(causal):
    """(B, N, T, D) = (4, 4, 30, 8): o and the three input gradients
    through a random cotangent, both sides one key block."""
    shape = (4, 4, 30, 8)
    arrays = _qkv(shape)
    cot = _normal(shape, 9)
    o_want, vjp = jax.vjp(
        lambda q, k, v: jax_attention.mha(q, k, v, causal=causal),
        *_jax(arrays))
    grads_want = vjp(jnp.asarray(cot))
    q, k, v = _torch(arrays, grad=True)
    o, _, grads = _port_vjp(q, k, v, torch.from_numpy(cot), causal=causal)
    _assert_close(o, o_want, F32_TOL)
    for g, w in zip(grads, grads_want):
        _assert_close(g, w, F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d_head", [8, 16])
@pytest.mark.parametrize("seq", [128, 256])
def test_flash_plain_matches_pallas_interpret(seq, d_head, causal, dtype):
    """Both outputs and the three gradients, with a nonzero lse cotangent,
    against the Pallas kernels in interpret mode (the same 128-key
    blocks)."""
    shape = (2, 2, seq, d_head)
    arrays = _qkv(shape, seed=seq + d_head)
    cot, dlse = _normal(shape, 7), _normal(shape[:-1], 8, scale=0.5)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    (o_want, lse_want), vjp = jax.vjp(
        lambda q, k, v: jax_flash_with_lse(q, k, v, causal=causal,
                                           interpret=True),
        *_jax(arrays, jdt))
    grads_want = vjp((jnp.asarray(cot).astype(jdt), jnp.asarray(dlse)))
    q, k, v = _torch(arrays, tdt, grad=True)
    o, lse, grads = _port_vjp(q, k, v, torch.from_numpy(cot).to(tdt),
                              torch.from_numpy(dlse), causal=causal)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert o.dtype == tdt and lse.dtype == torch.float32
    assert all(g.dtype == tdt for g in grads)
    _assert_close(o, o_want, tol)
    _assert_close(lse, lse_want, F32_TOL if dtype == "float32" else 1e-4)
    for g, w in zip(grads, grads_want):
        _assert_close(g, w, tol)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_key_mask_matches_jax_masked_mha(causal):
    """A (B, T) key mask against JAX's ``mha`` with the (B, 1, 1, T) mask
    the model builds; batch row 1 masks every key: o = 0 and lse = -1e30
    there, and no gradient flows from it."""
    b, n, t, d = 3, 2, 30, 8
    arrays = _qkv((b, n, t, d), seed=3)
    cot = _normal((b, n, t, d), 4)
    keep = np.arange(t)[None, :] < np.array([[25], [0], [30]])
    keep[2, ::3] = False
    o_want, vjp = jax.vjp(
        lambda q, k, v: jax_attention.mha(
            q, k, v, causal=causal, mask=jnp.asarray(keep)[:, None, None, :]),
        *_jax(arrays))
    grads_want = vjp(jnp.asarray(cot))
    q, k, v = _torch(arrays, grad=True)
    o, lse, grads = _port_vjp(q, k, v, torch.from_numpy(cot), causal=causal,
                              key_mask=torch.from_numpy(keep))
    _assert_close(o, o_want, F32_TOL)
    for g, w in zip(grads, grads_want):
        _assert_close(g, w, F32_TOL)
    # a query with no visible key (all of row 1; under causal, row 2's
    # query 0, whose only key is hidden) gives o = 0 and lse = -1e30
    seen = keep[:, None, :] & (np.tril(np.ones((t, t), bool)) if causal
                               else True)
    empty = torch.from_numpy(~seen.any(-1))[:, None].expand(b, n, t)
    assert bool(empty[1].all()) and int(empty.sum()) == (
        n * t + (n if causal else 0))
    assert torch.equal(o[empty], torch.zeros_like(o[empty]))
    assert torch.equal(lse[empty], torch.full_like(lse[empty], NEG))
    assert bool((lse[~empty] > -100).all())
    for g in grads[1:]:  # the hidden keys get no gradient
        assert torch.equal(g[1], torch.zeros_like(g[1]))


def test_flash_output_alone_is_the_with_lse_output():
    arrays = _qkv((2, 2, 30, 8), seed=11)
    o, _ = flash_attention_with_lse(*_torch(arrays), causal=True)
    assert torch.equal(flash_attention(*_torch(arrays), causal=True), o)


@pytest.mark.parametrize("case", ["cross_length", "wide_head", "mask_shape",
                                  "mixed_dtypes"])
def test_flash_refuses_what_is_outside_its_envelope(case):
    q, k, v = _torch(_qkv((2, 2, 8, 4)))
    kw = {}
    if case == "cross_length":
        k, v = k[:, :, :6], v[:, :, :6]
    elif case == "wide_head":
        q = k = v = torch.zeros(1, 1, 4, 513)
    elif case == "mask_shape":
        kw["key_mask"] = torch.ones(2, 1, 1, 8, dtype=torch.bool)
    if case == "mixed_dtypes":  # the kernels take one I/O dtype
        with pytest.raises(TypeError, match="all float32 or all bfloat16"):
            attention_kernel._folded("flash_fwd", q, k.bfloat16(), v, None)
        return
    with pytest.raises(ValueError, match="flash attention takes"):
        flash_attention_with_lse(q, k, v, **kw)


def test_raw_forward_refuses_to_record():
    q, k, v = _torch(_qkv((1, 1, 4, 4)), grad=True)
    with pytest.raises(NotImplementedError, match="flash_attention_with_lse"):
        attention_kernel.flash_fwd(q, k, v)


# -- the plain ops -------------------------------------------------------------


def _state_np(state):
    return [_np(x) for x in state]


def test_online_attention_block_over_two_blocks_matches_jax():
    """Two key blocks folded into one state, the first hiding every key
    from some queries (their m stays -inf until the second block)."""
    b, n, tq, d = 2, 3, 5, 4
    q = _normal((b, n, tq, d), 0)
    blocks = [(_normal((b, n, 6, d), 1), _normal((b, n, 6, d), 2)),
              (_normal((b, n, 7, d), 3), _normal((b, n, 7, d), 4))]
    mask0 = np.random.default_rng(5).random((b, 1, tq, 6)) < 0.6
    mask0[:, :, 0] = False
    masks = [mask0, None]
    j_state = jax_attention.init_online_state(b, n, tq, d)
    p_state = attention.init_online_state(b, n, tq, d)
    for (k, v), m in zip(blocks, masks):
        j_state = jax_attention.online_attention_block(
            j_state, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if m is None else jnp.asarray(m))
        p_state = attention.online_attention_block(
            p_state, torch.from_numpy(q), torch.from_numpy(k),
            torch.from_numpy(v), None if m is None else torch.from_numpy(m))
        for got, want in zip(_state_np(p_state), _state_np(j_state)):
            np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    assert np.isneginf(_np(attention.init_online_state(1, 1, 1, 1).m)).all()
    _assert_close(attention.finalize_online_state(p_state, torch.float32),
                  jax_attention.finalize_online_state(j_state, jnp.float32),
                  F32_TOL)


def test_finalize_gives_zeros_for_rows_without_a_key():
    state = attention.online_attention_block(
        attention.init_online_state(1, 1, 2, 3), torch.ones(1, 1, 2, 3),
        torch.ones(1, 1, 4, 3), torch.ones(1, 1, 4, 3),
        torch.tensor([[True] * 4, [False] * 4]))
    out = attention.finalize_online_state(state, torch.float32)
    assert torch.equal(out[0, 0, 1], torch.zeros(3))
    assert torch.allclose(out[0, 0, 0], torch.ones(3))


def test_merge_softmax_segments_matches_jax_and_one_call():
    """Two key segments merged through their lse equal attention over the
    union; two empty segments (lse = -1e30) merge to o = 0, no NaN."""
    b, n, t, d = 2, 2, 6, 4
    q = _normal((b, n, t, d), 0)
    k, v = _normal((b, n, 10, d), 1), _normal((b, n, 10, d), 2)
    segs = []
    for sl in (slice(0, 4), slice(4, 10)):
        state = attention.online_attention_block(
            attention.init_online_state(b, n, t, d), torch.from_numpy(q),
            torch.from_numpy(k[:, :, sl]), torch.from_numpy(v[:, :, sl]))
        segs.append((attention.finalize_online_state(state, torch.float32),
                     state.m + torch.log(state.l)))
    (o1, lse1), (o2, lse2) = segs
    o, lse = attention.merge_softmax_segments(o1, lse1, o2, lse2)
    j_o, j_lse = jax_attention.merge_softmax_segments(
        *(jnp.asarray(_np(x)) for x in (o1, lse1, o2, lse2)))
    _assert_close(o, j_o, F32_TOL)
    _assert_close(lse, j_lse, F32_TOL)
    whole = attention.mha(*(torch.from_numpy(x) for x in (q, k, v)))
    _assert_close(o, whole, F32_TOL)
    empty_o, empty_lse = torch.zeros(1, 3, d), torch.full((1, 3), NEG)
    o, lse = attention.merge_softmax_segments(empty_o, empty_lse, empty_o,
                                              empty_lse)
    assert torch.equal(o, torch.zeros_like(o))
    assert bool(torch.isfinite(lse).all())


def test_split_and_merge_heads_match_jax():
    x = _normal((2, 5, 12), 0)
    split = attention.split_heads(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(
        _np(split), np.asarray(jax_attention.split_heads(jnp.asarray(x), 3)))
    assert split.shape == (2, 3, 5, 4)
    np.testing.assert_array_equal(
        _np(attention.merge_heads(split)),
        np.asarray(jax_attention.merge_heads(jnp.asarray(_np(split)))))
    np.testing.assert_array_equal(_np(attention.merge_heads(split)), x)


@pytest.mark.parametrize("case", ["suffix_causal", "pair_mask",
                                  "key_mask_causal"])
def test_mha_matches_jax_mha(case):
    """The cross-length causal query block (suffix alignment) and a general
    (Tq, Tk) mask run the online-softmax block; a (B, 1, 1, T) key mask
    runs the flash op."""
    b, n, d = 2, 2, 4
    tq, tk = (3, 9) if case == "suffix_causal" else (9, 9)
    q = _normal((b, n, tq, d), 0)
    k, v = _normal((b, n, tk, d), 1), _normal((b, n, tk, d), 2)
    kw = dict(causal=case != "pair_mask")
    mask = None
    if case == "pair_mask":
        mask = np.random.default_rng(3).random((tq, tk)) < 0.7
    elif case == "key_mask_causal":
        mask = (np.arange(tk)[None, :] < np.array([[7], [9]]))[:, None, None]
    want = jax_attention.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             mask=None if mask is None else jnp.asarray(mask),
                             **kw)
    got = attention.mha(*(torch.from_numpy(x) for x in (q, k, v)),
                        mask=None if mask is None else torch.from_numpy(mask),
                        **kw)
    _assert_close(got, want, UNBLOCKED_TOL)


def test_mha_self_attention_is_the_flash_op():
    arrays = _qkv((2, 2, 30, 8), seed=12)
    got = attention.mha(*_torch(arrays), causal=True)
    assert torch.equal(got, flash_attention(*_torch(arrays), causal=True))


def test_bf16_rounding_points_follow_the_kernel():
    """In bf16 the probabilities are rounded before the product with v:
    the plain forward equals the float32 arithmetic on rounded p, not the
    float32 attention."""
    arrays = _qkv((1, 1, 16, 8), seed=13)
    q, k, v = _torch(arrays, torch.bfloat16)
    o, lse = flash_attention_with_lse(q, k, v)
    s = (q.float() @ k.float().transpose(-1, -2)) * (1 / math.sqrt(8))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    want = (p.bfloat16().float() @ v.float()) / p.sum(-1, keepdim=True)
    assert torch.equal(o, want.bfloat16())
    _assert_close(lse, (m[..., 0] + torch.log(p.sum(-1))), F32_TOL)
