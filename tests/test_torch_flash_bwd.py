"""Flash attention's backward on the CPU: the plain backward
`flash_attention_bwd_ref` and the autograd Function's CPU path of
`kernels.ops.flash_attention`, against `jax.grad` of the reference's
plain attention (`repro.kernels.flashattn_ref.attention_ref`, one head,
mapped over batch and heads; a KV head is repeated for its G query heads
inside the differentiated function, so its gradient sums them).

Inputs are float32 from numpy generators of fixed seeds. Tolerance:
rtol 1e-5 with atol 1e-6 of the gradient's largest magnitude (both sides
float32, sums in another order). The row log-sum-exp is held the same
way. The card's kernels are held to this plain backward in
`tests/test_torch_gpu.py` and chip_smoke.py's phase 32.

A plain model of the bf16 kernel route's rounding (P and dS rounded to
bf16 for their products, every sum float32, the gradients rounded once
to bf16) is held to the plain backward and to the float64 gradient under
the card's bf16 limits (`FLASH_BWD_TOL` of `tests/test_torch_gpu.py`:
2^-7 and 2^-6 of the gradient's largest magnitude), and the bf16 route's
layout checks run on CPU tensors.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flashattn_ref import attention_ref as jax_attention_ref
from repro_torch.kernels import flashattn, ops
from repro_torch.kernels.flashattn_ref import (attention_ref_lse,
                                               flash_attention_bwd_ref)

CASES = [  # (B, H, Hkv, Sq, Sk, d, causal)
    (2, 4, 2, 24, 24, 16, True),
    (1, 6, 2, 33, 33, 64, True),
    (2, 4, 4, 20, 20, 80, False),
    (1, 4, 1, 17, 29, 64, False),
    (2, 2, 1, 40, 40, 80, True),
]


def _inputs(b, h, hkv, sq, sk, d, seed):
    g = np.random.default_rng(seed)
    r = lambda *s: g.standard_normal(s).astype(np.float32)
    return r(b, h, sq, d), r(b, hkv, sk, d), r(b, hkv, sk, d), r(b, h, sq, d)


@functools.lru_cache(maxsize=None)
def _reference(case):
    """(inputs q, k, v, do; JAX's output; JAX's (dq, dk, dv)) of a case,
    made once for both tests."""
    *shape, causal = case
    q, k, v, do = _inputs(*shape, seed=sum(shape))
    group = q.shape[1] // k.shape[1]
    one = jax.vmap(jax.vmap(lambda q_, k_, v_: jax_attention_ref(
        q_, k_, v_, causal=causal)))

    @jax.jit
    def f(q, k, v, do):
        out, vjp = jax.vjp(lambda q, k, v: one(
            q, jnp.repeat(k, group, axis=1), jnp.repeat(v, group, axis=1)),
            q, k, v)
        return out, vjp(do)

    out, grads = f(*map(jnp.asarray, (q, k, v, do)))
    return (q, k, v, do), np.asarray(out), [np.asarray(x) for x in grads]


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    atol = 1e-6 * float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_grad(case):
    causal = case[-1]
    (q, k, v, do), want_o, want_g = _reference(case)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = attention_ref_lse(tq, tk, tv, causal=causal)
    _close(o, want_o)
    # LSE: the log-sum-exp of the scaled, masked scores
    s = np.einsum("bhqd,bhkd->bhqk", q, np.repeat(k, q.shape[1] // k.shape[1],
                                                  axis=1)) / math.sqrt(q.shape[-1])
    if causal:
        s = np.where(np.tril(np.ones(s.shape[-2:], bool)), s, -np.inf)
    _close(lse, np.asarray(jax.nn.logsumexp(jnp.asarray(s), axis=-1)))
    got = flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal)
    for g, w, t in zip(got, want_g, (tq, tk, tv)):
        assert g.shape == t.shape and g.dtype == t.dtype
        _close(g, w)


@pytest.mark.parametrize("case", CASES)
def test_autograd_cpu_path_matches_jax_grad(case):
    """`ops.flash_attention` on inputs that need gradients goes through
    the autograd Function; on CPU tensors its backward is the plain one,
    and no kernel is counted. The inputs are strided (B, S, H, d) views,
    as the model passes them."""
    causal = case[-1]
    (q, k, v, do), _, want_g = _reference(case)
    leaves = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
              .requires_grad_() for a in (q, k, v)]
    before = (flashattn.LAUNCHES, flashattn.BWD_LAUNCHES)
    out = ops.flash_attention(*(t.transpose(1, 2) for t in leaves),
                              causal=causal)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    out.backward(torch.from_numpy(do))
    assert (flashattn.LAUNCHES, flashattn.BWD_LAUNCHES) == before
    for t, w in zip(leaves, want_g):
        _close(t.grad.transpose(1, 2), w)


def test_serving_path_is_unchanged():
    """No input needs a gradient, or grad is off: the forward alone,
    with no autograd node, and the same values as the plain attention."""
    q, k, v, _ = _inputs(1, 4, 2, 9, 9, 16, seed=0)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    plain = attention_ref_lse(tq, tk, tv, causal=True)[0]
    out = ops.flash_attention(tq, tk, tv)
    assert out.grad_fn is None and torch.equal(out, plain)
    with torch.no_grad():
        out = ops.flash_attention(tq.requires_grad_(), tk, tv)
    assert out.grad_fn is None and torch.equal(out, plain)
    out = ops.flash_attention(tq, tk, tv)        # grad on: the Function
    assert torch.equal(out.detach(), plain)


def test_grad_of_a_sum_and_bf16_cpu_path():
    """An expanded cotangent (the ones of `.sum()`, stride 0) is laid out
    before the backward; bf16 inputs get bf16 gradients."""
    q, k, v, _ = _inputs(1, 2, 1, 12, 12, 16, seed=2)
    for dtype in (torch.float32, torch.bfloat16):
        ts = [torch.from_numpy(a).to(dtype).requires_grad_()
              for a in (q, k, v)]
        ops.flash_attention(*ts, causal=False).sum().backward()
        assert all(t.grad.dtype == dtype and torch.isfinite(
            t.grad.float()).all() for t in ts)


def test_backward_kernel_refuses_cpu_tensors():
    q, k, v, do = map(torch.from_numpy, _inputs(1, 2, 1, 8, 8, 16, seed=3))
    o, lse = attention_ref_lse(q, k, v)
    before = flashattn.BWD_LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flashattn.flash_attention_bwd(q, k, v, o, lse, do)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flashattn.flash_attention_lse(q, k, v)
    assert flashattn.BWD_LAUNCHES == before


# (B, H, Hkv, Sq, Sk, d, causal): GQA with ragged tiles, causal with
# Sq < Sk (keys no query sees), and hubert's d = 80 not causal
ROUTE_CASES = [
    (1, 6, 2, 70, 70, 64, True),
    (1, 3, 1, 40, 100, 32, True),
    (1, 2, 2, 48, 48, 80, False),
]
ROUTE_TOL = (2.0 ** -7, 2.0 ** -6)   # against plain, against float64


def _route_model(q, k, v, o, lse, do, causal):
    """The bf16 route's arithmetic: S, dP from bf16 inputs in float32,
    P = exp2(S·scale·log2 e − LSE·log2 e), dS = P∘(dP − D); P and dS
    rounded to bf16 for dV = PᵀdO, dK = scale·dSᵀQ, dQ = scale·dS K;
    a KV head's dK, dV summed over its query heads in order."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    scale, log2e = 1.0 / math.sqrt(d), 1.4426950408889634
    qf, of, dof = q.float(), o.float(), do.float()
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    p = torch.exp2((qf @ kf.transpose(-1, -2)) * (scale * log2e)
                   - (lse * log2e)[..., None])
    if causal:
        p = p * (torch.arange(sq)[:, None] >= torch.arange(sk)[None])
    ds = p * (dof @ vf.transpose(-1, -2)
              - (dof * of).sum(-1, keepdim=True))
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    dq = (ds16 @ kf) * scale
    dk_g = ((ds16.transpose(-1, -2) @ qf) * scale).reshape(b, hkv, g, sk, d)
    dv_g = (p16.transpose(-1, -2) @ dof).reshape(b, hkv, g, sk, d)
    dk, dv = dk_g[:, :, 0], dv_g[:, :, 0]
    for i in range(1, g):
        dk, dv = dk + dk_g[:, :, i], dv + dv_g[:, :, i]
    return [x.bfloat16() for x in (dq, dk, dv)]


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_bf16_route_rounding_stays_inside_the_gates(case):
    *shape, causal = case
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _inputs(*shape, seed=100 + sum(shape)))
    o, lse = attention_ref_lse(q, k, v, causal=causal)
    got = _route_model(q, k, v, o, lse, do, causal)
    plain = flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                    o.float(), lse, do.float(),
                                    causal=causal)
    q6, k6, v6 = q.double(), k.double(), v.double()
    o6, lse6 = attention_ref_lse(q6, k6, v6, causal=causal)
    exact = flash_attention_bwd_ref(q6, k6, v6, o6, lse6, do.double(),
                                    causal=causal)
    for x, p, e in zip(got, plain, exact):
        assert _rel(x, p) <= ROUTE_TOL[0] and _rel(x, e) <= ROUTE_TOL[1]
    if causal and shape[3] < shape[4]:     # keys past Sq: no query sees them
        assert not got[1][:, :, shape[3]:].any()
        assert not got[2][:, :, shape[3]:].any()


def test_bf16_backward_layout_check_refuses_what_tma_cannot_read():
    """The checks the bf16 backward applies to q, k, v, o and dO before
    it encodes a tensor map, on CPU tensors passed to the checks."""
    ok = torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16)
    flashattn._require_tma_layout("flash_attention_bwd", q=ok, do=ok)
    wide = torch.zeros((1, 2, 8, 20), dtype=torch.bfloat16)[..., :16]
    with pytest.raises(ValueError, match="flash_attention_bwd: do has "
                                         "strides"):
        flashattn._require_tma_layout("flash_attention_bwd", q=ok, do=wide)
    flat = torch.zeros(2 * 8 * 16 + 8, dtype=torch.bfloat16)
    shifted = flat[1:1 + 2 * 8 * 16].view(1, 2, 8, 16)
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        flashattn._require_tma_layout("flash_attention_bwd", k=shifted)


def test_broadcast_cotangent_is_laid_out_for_the_tensor_maps():
    """A dO that repeats along a dim longer than 1 (the gradient of
    `(out.sum(dim=(0, 1, 2)) * w).sum()` has strides (0, 0, 0, 1)) passes
    TMA's stride rule, so the wrapper lays it out itself; other views
    pass through untouched."""
    w = torch.arange(16, dtype=torch.bfloat16)
    do = w.expand(1, 2, 8, 16)
    assert do.stride() == (0, 0, 0, 1)
    flashattn._require_tma_layout("flash_attention_bwd", do=do)
    laid = flashattn._unbroadcast(do)
    assert laid.is_contiguous() and torch.equal(laid, do)
    view = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16).transpose(1, 2)
    assert flashattn._unbroadcast(view) is view
    one = torch.zeros((1, 1, 8, 16), dtype=torch.bfloat16).expand(3, 1, 8, 16)
    assert flashattn._unbroadcast(one).is_contiguous()


# (B, H, Hkv, Sq, Sk, d): G = 6 at 32b's layer, G = 1, ragged Sq and Sk,
# one query row, hubert's d = 80
SCRATCH_CASES = [
    (1, 12, 2, 1024, 1024, 128),
    (2, 6, 6, 150, 150, 64),
    (2, 6, 2, 70, 130, 80),
    (1, 4, 1, 1, 129, 16),
]


@pytest.mark.parametrize("case", SCRATCH_CASES)
def test_backward_scratch_is_float32_and_sized_for_either_route(case):
    """The backward's scratch, the same for bf16 and float32: LSE log2(e)
    and D of every query row padded to whole 64-row tiles, and per-query-
    head dK and dV partials (summed over a KV head's query heads by the
    last launch) only when H > Hkv."""
    b, h, hkv, sq, sk, d = case
    rows, partial = flashattn.bwd_scratch(b, h, hkv, sq, sk, d, "cpu")
    sq_pad = -(-sq // flashattn.BWD_TILE) * flashattn.BWD_TILE
    assert flashattn.BWD_TILE == 64 and sq_pad % 64 == 0 and sq_pad >= sq
    assert rows.dtype == torch.float32 and rows.shape == (2, b, h, sq_pad)
    assert rows.is_contiguous()
    if h == hkv:
        assert partial is None
    else:
        assert partial.dtype == torch.float32 and partial.is_contiguous()
        assert partial.shape == (2, b, h, sk, d)


def _bwd_args(dtype=torch.float32, d=16, lse_shape=None):
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _inputs(1, 4, 2, 8, 8, d, seed=4))
    lse = torch.zeros(lse_shape or (1, 4, 8), dtype=torch.float32)
    return q, k, v, q.clone(), lse, do


def _refusal(kind):
    """(arguments of flash_attention_bwd, the error, its message)."""
    q, k, v, o, lse, do = _bwd_args()
    if kind == "float16":
        return _bwd_args(torch.float16), TypeError, "float32 or bfloat16"
    if kind == "mixed dtypes":
        return (q, k.bfloat16(), v.bfloat16(), o, lse, do), TypeError, \
            "share one dtype"
    if kind == "head dim 120":
        return _bwd_args(d=120), ValueError, "head dim 120"
    if kind == "H % Hkv":
        return (q, k[:, :1].repeat(1, 3, 1, 1), v[:, :1].repeat(1, 3, 1, 1),
                o, lse, do), ValueError, "H % Hkv"
    if kind == "do shape":
        return (q, k, v, o, lse, do[:, :, :4]), ValueError, "q's shape"
    if kind == "lse shape":
        return (q, k, v, o, lse[:, :, :4], do), ValueError, "lse must be"
    if kind == "lse dtype":
        return (q, k, v, o, lse.double(), do), ValueError, "lse must be"
    if kind == "lse strided":
        return (q, k, v, o, torch.zeros((1, 8, 4)).transpose(1, 2), do), \
            ValueError, "lse must be"
    return (q, k, v, o, lse, do), ValueError, "CUDA tensors only"


@pytest.mark.parametrize("kind", [
    "float16", "mixed dtypes", "head dim 120", "H % Hkv", "do shape",
    "lse shape", "lse dtype", "lse strided", "well-formed on the CPU"])
def test_backward_wrapper_refuses_what_its_kernels_do_not_take(kind):
    """The wrapper checks types and shapes before the device, so each
    refusal reads the same on the CPU as on the card, and nothing is
    launched or counted."""
    args, error, match = _refusal(kind)
    before = (flashattn.BWD_LAUNCHES, dict(flashattn.BWD_LAUNCHES_BY_D))
    with pytest.raises(error, match=match):
        flashattn.flash_attention_bwd(*args)
    assert (flashattn.BWD_LAUNCHES,
            dict(flashattn.BWD_LAUNCHES_BY_D)) == before


def test_float32_layout_check_takes_16_byte_pieces():
    """The float32 kernels read 16-byte pieces (cp.async) too: a float32
    view needs a 16-byte aligned base and strides of whole 4-element
    pieces, as a bf16 one needs 8-element ones for TMA."""
    ok = torch.zeros((1, 8, 2, 16)).transpose(1, 2)   # (B, S, H, d) view
    flashattn._require_tma_layout("flash_attention", q=ok, k=ok, v=ok)
    odd = torch.zeros((1, 2, 8, 18))[..., :16]         # rows of 72 bytes
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        flashattn._require_tma_layout("flash_attention", q=odd)
    flat = torch.zeros(2 * 8 * 16 + 4)
    shifted = flat[1:1 + 2 * 8 * 16].view(1, 2, 8, 16)
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        flashattn._require_tma_layout("flash_attention", k=shifted)
    wide = torch.zeros((1, 2, 8, 20))[..., :16]        # rows of 80 bytes
    flashattn._require_tma_layout("flash_attention_bwd", do=wide)
