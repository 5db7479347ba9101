"""Gradients of the port's `loss_fn` against JAX's autodiff of the
reference's, for all ten architectures at `reduced` size in float32.

Weights are drawn once (the port's `init_model`, which draws the
reference's distributions and tree; the reference's eager init takes
seconds per model) as numpy arrays, which the reference takes as they
are and the port through `repro_torch.convert.params_from_arrays`;
inputs come from numpy generators of fixed seeds. The port differentiates with `torch.autograd` (its
causal and bidirectional self-attention through the flash autograd
Function, whose CPU path is the plain backward); the reference with
`jax.grad` under `jax.jit` (config static). Every leaf is held by its
relative Frobenius error, ‖g_port − g_ref‖ / max(‖g_ref‖, 1e-6), to
`GRAD_TOL` = 1e-4: both sides are float32 and differ in the order of
their sums (measured worst 6.0e-6, mamba2-780m). Also: remat changes no
gradient bit, and the recompute under remat logs no MoE routing.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.convert import params_from_arrays
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw

GRAD_TOL = 1e-4
ARCHS = list(ref_configs.ARCHS)
B, S = 2, 16


def _batch(cfg, seed=0):
    g = np.random.default_rng(seed)
    key = "frames" if cfg.frontend == "audio" else "tokens"
    if cfg.frontend == "audio":
        inp = g.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        inp = g.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {key: inp,
             "targets": g.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "patch":
        batch["image_embeds"] = g.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _port_grads(params, cfg, batch):
    alias = adamw.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = tf.loss_fn(alias, cfg, batch, device="cpu")
    grads = torch.autograd.grad(loss, adamw.tree_leaves(alias))
    return float(loss.detach()), grads


def _rel_fro(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-6))


@pytest.mark.parametrize("name", ARCHS)
def test_loss_gradients_match_jax(name):
    ref_cfg = ref_configs.reduced(name)
    cfg = configs.reduced(name)
    arrays = adamw.tree_map(lambda t: t.numpy(),
                            tf.init_model(3, cfg, device="cpu"))
    rp = jax.tree_util.tree_map(jnp.asarray, arrays)
    batch = _batch(cfg)
    want_l, want_g = jax.jit(jax.value_and_grad(ref_tf.loss_fn),
                             static_argnums=1)(
        rp, ref_cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    got_l, got_g = _port_grads(params_from_arrays(arrays, device="cpu"),
                               cfg, batch)
    np.testing.assert_allclose(got_l, float(want_l), rtol=1e-5)
    flat, _ = jax.tree_util.tree_flatten_with_path(want_g)
    assert len(flat) == len(got_g)
    errs = {jax.tree_util.keystr(path): _rel_fro(g.numpy(), w)
            for (path, w), g in zip(flat, got_g)}
    bad = {k: e for k, e in errs.items() if not e <= GRAD_TOL}
    assert not bad, bad


@pytest.mark.parametrize("name", ["qwen2-1.5b", "grok-1-314b"])
def test_remat_changes_no_gradient_bit(name):
    """cfg.remat recomputes each super-layer in the backward: the same
    operations on the same inputs, so every gradient bit is the same. The
    recompute of an MoE layer logs no routing: as many entries with
    remat as without."""
    cfg = configs.reduced(name)
    params = tf.init_model(0, cfg, device="cpu")
    batch = _batch(cfg, seed=1)
    got = {}
    for remat in (False, True):
        moe.ROUTING_LOG = []
        try:
            got[remat] = _port_grads(params,
                                     dataclasses.replace(cfg, remat=remat),
                                     batch)
            got[remat] += (len(moe.ROUTING_LOG),)
        finally:
            moe.ROUTING_LOG = None
    (l0, g0, n0), (l1, g1, n1) = got[False], got[True]
    assert l0 == l1 and n0 == n1
    assert n0 == (cfg.n_layers if cfg.n_experts else 0)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
