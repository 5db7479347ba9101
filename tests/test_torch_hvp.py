"""Second derivatives in the port against JAX's on the CPU: flash
attention's double backward, `HvpOperator` and the curvature-spectrum
example.

- Flash attention: a Hessian-vector product through `ops.flash_attention`
  (the autograd Function, whose second-order terms take the plain
  route) against `jax.jvp` of `jax.grad` of the reference's plain
  attention (`repro.kernels.flashattn_ref.attention_ref`, one head,
  mapped over batch and heads, a KV head repeated for its G query
  heads). The loss Σ w∘O + ½ Σ O² makes dO depend on q, k and v, so
  every second-order term is taken. float32 inputs, held to
  `HVP_TOL` = 1e-4 of the product's largest magnitude (both sides sum
  in another order; measured worst 1.04e-6). The float64 case is the
  one that found the fault (the port differentiated as if the saved LSE
  were constant: at the loss Σ O² the q and k parts were off by 4.49 and
  5.23), held to 1e-12.
- `HvpOperator`: the quadratic loss of `tests/test_eigensolver.py`; then
  `matmat` on reduced qwen2-1.5b (flash attention), h2o-danube-3-4b
  (sliding window) and mamba2-780m (SSD) with the same parameters
  (`convert.params_from_arrays`), batch and seeded block, held to
  `HVP_TOL` of max |Hv| (reverse over reverse against forward over
  reverse, float32 both; measured worst 2.07e-6, danube).
- `HvpOperator` under remat (`cfg.remat=True`, every published
  config's setting) on the same three models: bit-equal to remat off,
  and held to `HVP_TOL` of the reference's remat=True block.
- The example: its top eigenvalues against the reference example's
  (the same weights, the reference's start block passed as `x0`),
  within the solve's tol 1e-3.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import HvpOperator as RefHvpOperator
from repro.core import eigsh as ref_eigsh
from repro.kernels.flashattn_ref import attention_ref as jax_attention_ref
from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.convert import params_from_arrays
from repro_torch.core import HvpOperator, eigsh
from repro_torch.examples import curvature_spectrum
from repro_torch.kernels import flashattn, ops
from repro_torch.models import transformer as tf
from repro_torch.obs import trace
from repro_torch.optim import adamw

HVP_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread, restored after each test: a Hessian-vector
    product is many small operations, which run slowest when six xdist
    workers each spread them over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

FLASH_CASES = [  # (B, H, Hkv, Sq, Sk, d, causal)
    (2, 4, 2, 24, 24, 16, True),
    (1, 4, 4, 20, 20, 32, False),
    (1, 6, 2, 33, 33, 64, True),
    (2, 4, 1, 17, 29, 16, False),
]


def _jax_attention(causal, group):
    one = jax.vmap(jax.vmap(lambda q_, k_, v_: jax_attention_ref(
        q_, k_, v_, causal=causal)))

    def attend(q, k, v):
        return one(q, jnp.repeat(k, group, axis=1),
                   jnp.repeat(v, group, axis=1))
    return attend


@functools.lru_cache(maxsize=None)
def _jax_hvp_fn(causal, group):
    """The reference side's Hessian-vector product, jitted: one compile
    per shape in place of a dispatch per primitive."""
    attend = _jax_attention(causal, group)

    def loss(q, k, v, w):
        out = attend(q, k, v)
        return jnp.sum(w * out) + 0.5 * jnp.sum(out * out)

    def hvp(q, k, v, w, dirs):
        grad = lambda q, k, v: jax.grad(loss, argnums=(0, 1, 2))(q, k, v, w)
        return jax.jvp(grad, (q, k, v), dirs)[1]
    return jax.jit(hvp)


def _jax_hvp(q, k, v, w, dirs, causal):
    hv = _jax_hvp_fn(causal, q.shape[1] // k.shape[1])(q, k, v, w,
                                                        tuple(dirs))
    return [np.asarray(h) for h in hv]


def _port_hvp(q, k, v, w, dirs, causal, *, strided=False):
    """The HVP by reverse over reverse through `ops.flash_attention`;
    `strided` passes q, k, v as (B, S, H, d) transposed views, as the
    model does."""
    if strided:
        leaves = [torch.from_numpy(np.ascontiguousarray(
            a.transpose(0, 2, 1, 3))).requires_grad_() for a in (q, k, v)]
        args = [t.transpose(1, 2) for t in leaves]
    else:
        leaves = args = [torch.from_numpy(a).requires_grad_()
                         for a in (q, k, v)]
    out = ops.flash_attention(*args, causal=causal)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    loss = (torch.from_numpy(w) * out).sum() + 0.5 * (out * out).sum()
    grads = torch.autograd.grad(loss, leaves, create_graph=True)
    hv = torch.autograd.grad(
        grads, leaves,
        [torch.from_numpy(np.ascontiguousarray(
            d.transpose(0, 2, 1, 3) if strided else d)) for d in dirs])
    return [(h.transpose(1, 2) if strided else h).numpy() for h in hv]


def _close(got, want, tol):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(np.asarray(got, np.float64) - want)))
    assert err <= tol * scale, (err, scale)


def _flash_inputs(b, h, hkv, sq, sk, d, seed, dtype=np.float32):
    g = np.random.default_rng(seed)
    r = lambda *s: g.standard_normal(s).astype(dtype)
    q, k, v = r(b, h, sq, d), r(b, hkv, sk, d), r(b, hkv, sk, d)
    w = r(b, h, sq, d)
    dirs = (r(b, h, sq, d), r(b, hkv, sk, d), r(b, hkv, sk, d))
    return q, k, v, w, dirs


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_second_derivative_matches_jax(case, strided):
    *shape, causal = case
    q, k, v, w, dirs = _flash_inputs(*shape, seed=sum(shape))
    want = _jax_hvp(q, k, v, w, dirs, causal)
    calls = flashattn.GRAD2_CALLS
    launches = (flashattn.LAUNCHES, flashattn.BWD_LAUNCHES)
    got = _port_hvp(q, k, v, w, dirs, causal, strided=strided)
    assert flashattn.GRAD2_CALLS == calls + 1
    assert (flashattn.LAUNCHES, flashattn.BWD_LAUNCHES) == launches
    for g, x in zip(got, want):
        _close(g, x, HVP_TOL)


def test_flash_second_derivative_float64_probe():
    """The case that found the fault: B = 1, H = 2, S = 8, d = 16,
    causal, float64, the loss ½ Σ O² (w = 0)."""
    g = np.random.default_rng(0)
    q, k, v, d1, d2, d3 = (g.standard_normal((1, 2, 8, 16))
                           for _ in range(6))
    w = np.zeros_like(q)
    with jax.enable_x64(True):
        want = _jax_hvp(q, k, v, w, (d1, d2, d3), True)
    got = _port_hvp(q, k, v, w, (d1, d2, d3), True)
    for a, b in zip(got, want):
        assert a.dtype == np.float64
        _close(a, b, 1e-12)


def test_flash_third_derivative_raises():
    """The second-order terms carry a node that refuses to be
    differentiated: a third derivative raises, never returns values."""
    q, k, v, w, dirs = _flash_inputs(1, 2, 1, 8, 8, 16, seed=3)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad((out * out).sum(), leaves,
                                create_graph=True)
    dot = sum((g * torch.from_numpy(d)).sum() for g, d in zip(grads, dirs))
    hv = torch.autograd.grad(dot, leaves, create_graph=True)
    with pytest.raises(RuntimeError, match="third derivative"):
        torch.autograd.grad(hv[0].sum(), leaves)


def test_first_order_backward_is_unchanged():
    """The first-order gradients of the Function are the plain backward's
    bits, with or without a graph built on them."""
    q, k, v, w, _ = _flash_inputs(2, 4, 2, 24, 24, 16, seed=4)
    want = None
    for create_graph in (False, True):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = ops.flash_attention(*leaves, causal=True)
        got = torch.autograd.grad(out, leaves, torch.from_numpy(w),
                                  create_graph=create_graph)
        assert all(g.requires_grad == create_graph for g in got)
        if want is None:
            want = got
        assert all(torch.equal(a.detach(), b) for a, b in zip(got, want))
    from repro_torch.kernels.flashattn_ref import (attention_ref_lse,
                                                   flash_attention_bwd_ref)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = attention_ref_lse(tq, tk, tv, causal=True)
    plain = flash_attention_bwd_ref(tq, tk, tv, o, lse, torch.from_numpy(w),
                                    causal=True)
    assert all(torch.equal(a, b) for a, b in zip(want, plain))


# ------------------------------------------------------------- HvpOperator
def _quadratic(m):
    mat = np.random.default_rng(1).standard_normal((m, m)).astype(np.float32)
    h = mat @ mat.T / m
    th = torch.from_numpy(h)

    def loss(p):
        return 0.5 * p["w"] @ th @ p["w"]
    return h, loss


def test_hvp_operator_quadratic():
    """`tests/test_eigensolver.py::test_hvp_operator_quadratic` with the
    import swapped: eigenvalues against `np.linalg.eigvalsh`."""
    m = 48
    h, loss = _quadratic(m)
    hop = HvpOperator(loss, {"w": torch.zeros(m)}, pad_to=8, device="cpu")
    res = eigsh(hop, 3, block_size=1, tol=1e-5, max_restarts=100,
                which="LA")
    w_true = np.sort(np.linalg.eigvalsh(h))[-3:]
    np.testing.assert_allclose(np.sort(res.eigenvalues), w_true,
                               rtol=1e-3, atol=1e-4)


def test_hvp_operator_pads_and_traces():
    """n pads to pad_to with zero rows (the padding rows of x are
    ignored); a leaf the loss is linear in has a constant gradient and
    zero rows of Hv; coordinates follow the sorted keys ("c" before
    "w"); each matmat opens one `operator.matmat` span; the operator
    declares no capability and runs on its device."""
    m = 43
    h, quad = _quadratic(m)

    def loss(p):
        return quad(p) + 3.0 * p["c"].sum()
    hop = HvpOperator(loss, {"w": torch.zeros(m), "c": torch.ones(2)},
                      pad_to=8, device="cpu")
    assert (hop.n_logical, hop.n) == (45, 48)
    assert hop.capabilities() == frozenset()
    assert hop.device == torch.device("cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (48, 3)).astype(np.float32))
    with trace.tracing(trace.Tracer()) as tracer:
        y = hop.matmat(x)
    assert y.shape == (48, 3) and y.dtype == torch.float32
    assert torch.count_nonzero(y[:2]) == 0 and torch.count_nonzero(y[45:]) == 0
    np.testing.assert_allclose(y[2:45].numpy(), h @ x[2:45].numpy(),
                               rtol=1e-5, atol=1e-5)
    spans = [r for r in tracer.records()
             if r.get("name") == "operator.matmat"]
    assert len(spans) == 1
    assert {k: spans[0]["args"][k] for k in ("op", "k", "n")} == {
        "op": "HvpOperator", "k": 3, "n": 48}


def _batch(cfg, seed=0):
    g = np.random.default_rng(seed)
    return {"tokens": g.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32),
            "targets": g.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _reference_example_operator():
    """The reference example's operator: reduced qwen2-1.5b drawn by the
    reference's `init_model` from `PRNGKey(0)` (jitted: one compile in
    place of a dispatch per draw), its (2, 16) batch from
    `np.random.default_rng(0)` (`_batch`'s), pad_to 8. Returns (weights
    as numpy, the operator)."""
    cfg = ref_configs.reduced("qwen2-1.5b")
    params = jax.jit(lambda key: ref_tf.init_model(key, cfg))(
        jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    op = RefHvpOperator(lambda p: ref_tf.loss_fn(p, cfg, batch), params,
                        pad_to=8)
    return jax.tree_util.tree_map(np.asarray, params), op


@pytest.mark.parametrize("name", ["qwen2-1.5b", "h2o-danube-3-4b",
                                  "mamba2-780m"])
def test_hvp_matmat_matches_reference(name):
    """One block of two columns through both packages' `HvpOperator` on
    the same weights, batch and block: qwen2's are the reference
    example's (its operator, shared with the example's test), the
    others' drawn by the port."""
    ref_cfg, cfg = ref_configs.reduced(name), configs.reduced(name)
    batch = _batch(cfg)
    if name == "qwen2-1.5b":
        arrays, rop = _reference_example_operator()
    else:
        arrays = adamw.tree_map(lambda t: t.numpy(),
                                tf.init_model(5, cfg, device="cpu"))
        rbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        rop = RefHvpOperator(lambda p: ref_tf.loss_fn(p, ref_cfg, rbatch),
                             jax.tree_util.tree_map(jnp.asarray, arrays))
    op = HvpOperator(lambda p: tf.loss_fn(p, cfg, batch, device="cpu"),
                     params_from_arrays(arrays, device="cpu"), device="cpu")
    assert (op.n, op.n_logical) == (rop.n, rop.n_logical)
    x = np.random.default_rng(7).standard_normal((op.n, 2)).astype(
        np.float32)
    want = np.asarray(rop.matmat(jnp.asarray(x)))
    got = op.matmat(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0
    _close(got, want, HVP_TOL)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "h2o-danube-3-4b",
                                  "mamba2-780m"])
def test_hvp_matmat_under_remat(name):
    """With remat=True (every published config's setting) a double
    backward recomputes each super-layer more than once, so the
    recompute's context must be re-enterable (it raised
    AttributeError before). The block equals the remat-off block bit for
    bit (the recompute repeats the same operations) and the reference's
    remat=True block within HVP_TOL."""
    cfg = dataclasses.replace(configs.reduced(name), remat=True)
    ref_cfg = dataclasses.replace(ref_configs.reduced(name), remat=True)
    batch = _batch(cfg)
    arrays = adamw.tree_map(lambda t: t.numpy(),
                            tf.init_model(5, cfg, device="cpu"))
    rbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rop = RefHvpOperator(lambda p: ref_tf.loss_fn(p, ref_cfg, rbatch),
                         jax.tree_util.tree_map(jnp.asarray, arrays))
    ops_ = {remat: HvpOperator(
        lambda p, c=dataclasses.replace(cfg, remat=remat): tf.loss_fn(
            p, c, batch, device="cpu"),
        params_from_arrays(arrays, device="cpu"), device="cpu")
        for remat in (True, False)}
    x = np.random.default_rng(11).standard_normal((rop.n, 2)).astype(
        np.float32)
    got = ops_[True].matmat(torch.from_numpy(x))
    assert torch.equal(got, ops_[False].matmat(torch.from_numpy(x)))
    want = np.asarray(rop.matmat(jnp.asarray(x)))
    assert np.abs(want).max() > 0
    _close(got.numpy(), want, HVP_TOL)


@functools.lru_cache(maxsize=None)
def _reference_example():
    """The reference example's solve on its operator, returning (weights
    as numpy, start block, eigenvalues): its eigsh's start block drawn
    as that eigsh draws it (seed 0)."""
    arrays, op = _reference_example_operator()
    res = ref_eigsh(op, 4, block_size=2, tol=1e-3, max_restarts=40,
                    which="LA", impl="ref")
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (op.n, 2),
                                      jnp.float32))
    return arrays, x0, np.sort(res.eigenvalues)


def test_curvature_spectrum_matches_reference_example():
    arrays, x0, want = _reference_example()
    res = curvature_spectrum.main(
        device="cpu", params=params_from_arrays(arrays, device="cpu"), x0=x0)
    np.testing.assert_allclose(np.sort(res.eigenvalues), want, rtol=1e-3)


def test_curvature_spectrum_main_on_cpu(capsys):
    """The example as a user runs it (its own weights from seed 0)."""
    res = curvature_spectrum.main(device="cpu")
    assert res.eigenvalues.shape == (4,)
    assert np.isfinite(res.eigenvalues).all()
    assert "parameter space dimension: 127,808" in capsys.readouterr().out
