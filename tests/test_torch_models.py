"""The port's LM serving path against the JAX package, on the CPU.

Both packages get the same inputs: the reference initializes the model
from a PRNG key, `repro_torch.convert.params_from_arrays` copies those
weights into the port bit for bit, and token ids and activations come
from numpy generators of fixed seeds (never the session `rng`, so these
tests change no draw of another file).

Tolerances: rtol/atol 1e-4 at float32 (the `reduced` default), where the
two differ only in the order of sums. At bf16 the reference's `_attend`
rounds the softmax weights to bf16 before the PV product and the port's
attention keeps them float32 (as the flash kernel does), and each layer
rounds its outputs to bf16 again. That difference propagates through the
layers, so bf16 results are held to 3e-2 (the reference's own bf16
flash-attention tolerance) of the largest magnitude of the compared
tensor, and the modules with no attention to 3e-2 elementwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_att
from repro.models import modules as ref_mod
from repro.models import steps as ref_steps
from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.convert import params_from_arrays
from repro_torch.models import attention as att
from repro_torch.models import modules as mod
from repro_torch.models import steps
from repro_torch.models import transformer as tf

DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _cfgs(dtype="float32", **kw):
    return (dataclasses.replace(ref_configs.reduced("yi-9b"),
                                param_dtype=dtype, **kw),
            dataclasses.replace(configs.reduced("yi-9b"),
                                param_dtype=dtype, **kw))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    """Elementwise rtol/atol at float32; at bf16, TOL of the largest
    magnitude of `want` (see the module docstring)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    tol = TOL[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        scale = max(float(np.max(np.abs(want), initial=0.0)), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _params(ref_cfg, seed=1):
    rp = ref_tf.init_model(jax.random.PRNGKey(seed), ref_cfg)
    return rp, params_from_arrays(jax.tree_util.tree_map(np.asarray, rp),
                                  device="cpu")


def _arr(shape, seed, dtype):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(
        mod._DTYPES[dtype])


def _tree_close(got, want, dtype):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _tree_close(got[k], want[k], dtype)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _tree_close(g, w, dtype)
    else:
        if np.issubdtype(np.asarray(want).dtype, np.integer):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            _close(got, want, dtype)


# ---------------------------------------------------------------- configs

def test_configs_match_reference():
    for fn in ("get", "reduced"):
        want = getattr(ref_configs, fn)("yi-9b")
        got = getattr(configs, fn)("yi-9b")
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert (got.hd, got.n_super, got.n_remainder) == \
            (want.hd, want.n_super, want.n_remainder)
    assert configs.get("yi-9b").param_count() == 8_829_009_920
    for name in ("qwen2-1.5b", "mamba2-780m"):     # every name builds now
        assert dataclasses.asdict(configs.get(name)) == \
            dataclasses.asdict(ref_configs.get(name))
    with pytest.raises(KeyError):
        configs.get("no-such-model")


def test_unported_layers_raise():
    """Every layer kind, MoE FFNs and the audio frontend build and run now
    (tests/test_torch_archs.py holds them to the reference); a layer kind
    the reference does not have raises ValueError, as its `_init_layer`
    does."""
    _, cfg = _cfgs()
    for other in (dict(pattern=("swa",)), dict(pattern=("attn", "ssm")),
                  dict(n_experts=4, moe_d_ff=96), dict(frontend="audio")):
        c = dataclasses.replace(cfg, **other)
        params = tf.init_model(0, c, device="cpu")
        inp = (np.zeros((1, 4, c.d_model), np.float32)
               if c.frontend == "audio" else np.zeros((1, 4), np.int32))
        assert tf.logits_fn(params, c, inp, device="cpu").shape == \
            (1, 4, c.vocab_size)
    for bad in (("conv",), ("attn", "mlp")):
        with pytest.raises(ValueError):
            tf.init_model(0, dataclasses.replace(cfg, pattern=bad),
                          device="cpu")
        with pytest.raises(ValueError):
            tf.init_cache(dataclasses.replace(cfg, pattern=bad), 1, 4,
                          device="cpu")


# ---------------------------------------------------------------- params

@pytest.mark.parametrize("dtype", DTYPES)
def test_params_from_arrays_bit_for_bit(dtype):
    ref_cfg, _ = _cfgs(dtype)
    rp = ref_tf.init_model(jax.random.PRNGKey(0), ref_cfg)
    arrays = jax.tree_util.tree_map(np.asarray, rp)
    got = params_from_arrays(arrays, device="cpu")
    leaves = jax.tree_util.tree_leaves(arrays)
    out = jax.tree_util.tree_leaves(got)
    assert len(out) == len(leaves)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, got)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0,
                                                            arrays))
    for a, t in zip(leaves, out):
        assert t.dtype == mod._DTYPES[dtype] and tuple(t.shape) == a.shape
        bits = t.view(torch.int16) if dtype == "bfloat16" else t
        want = a.view(np.uint16).view(np.int16) if dtype == "bfloat16" else a
        np.testing.assert_array_equal(bits.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_model_layout_and_distributions(dtype):
    """Same tree, shapes and dtypes as the reference; N(0, 1/d_in)
    linears, N(0, 0.02²) embeddings and unit norms."""
    ref_cfg, cfg = _cfgs(dtype)
    want = ref_tf.init_model(jax.random.PRNGKey(0), ref_cfg)
    got = tf.init_model(0, cfg, device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), want)
    assert jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        got) == shapes
    for name in ("wq", "wk", "wv", "wo"):
        w = got["stack"]["l0"]["attn"][name]["w"].float()
        assert abs(float(w.std()) * np.sqrt(w.shape[-2]) - 1) < 0.05
    w = got["stack"]["l0"]["ffn"]["down"]["w"].float()
    assert abs(float(w.std()) * np.sqrt(w.shape[-2]) - 1) < 0.05
    assert abs(float(got["embed"]["tok"].float().std()) / 0.02 - 1) < 0.05
    assert torch.all(got["final_norm"]["scale"] == 1)
    again = tf.init_model(0, cfg, device="cpu")
    assert torch.equal(again["lm_head"]["w"], got["lm_head"]["w"])


# ---------------------------------------------------------------- modules

@pytest.mark.parametrize("dtype", DTYPES)
def test_modules_match_reference(dtype):
    ref_cfg, cfg = _cfgs(dtype)
    rp, pp = _params(ref_cfg)
    rl = jax.tree_util.tree_map(lambda a: a[0], rp["stack"]["l0"])
    pl = tf._layer(pp["stack"]["l0"], 0)
    rx, px = _arr((2, 10, cfg.d_model), 11, dtype)

    def check(got, want):   # no attention here: elementwise at both dtypes
        np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                                   atol=TOL[dtype])

    check(mod.apply_norm(cfg, pl["norm1"], px),
          ref_mod.apply_norm(ref_cfg, rl["norm1"], rx))
    check(mod.apply_mlp(cfg, pl["ffn"], px),
          ref_mod.apply_mlp(ref_cfg, rl["ffn"], rx))
    pos = np.arange(10, dtype=np.float32)
    rc, rs = ref_mod.rope_freqs(ref_cfg, jnp.asarray(pos))
    pc, ps = mod.rope_freqs(cfg, torch.from_numpy(pos))
    check(pc, rc)
    check(ps, rs)
    rq, pq = _arr((2, 10, 2, 2, cfg.hd), 12, dtype)
    check(mod.apply_rope(pq, pc, ps), ref_mod.apply_rope(rq, rc, rs))
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, 10))
    check(mod.embed_tokens(pp["embed"], torch.from_numpy(toks)),
          ref_mod.embed_tokens(rp["embed"], jnp.asarray(toks)))
    got = mod.lm_logits(cfg, pp, px)
    assert got.dtype == torch.float32
    check(got, ref_mod.lm_logits(ref_cfg, rp, rx))
    logits = np.random.default_rng(14).standard_normal(
        (2, 10, cfg.vocab_size)).astype(np.float32)
    mask = (np.arange(10) < 7).astype(np.float32)[None].repeat(2, 0)
    for m in (None, mask):
        np.testing.assert_allclose(
            float(mod.cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(toks),
                                    None if m is None
                                    else torch.from_numpy(m))),
            float(ref_mod.cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(toks),
                                        None if m is None
                                        else jnp.asarray(m))),
            rtol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["causal", "none", "swa", "cross"])
def test_attn_forward_matches_reference(kind, dtype):
    """causal and "none" go through ops.flash_attention (its plain version
    on the CPU); swa and cross through the plain `_attend`."""
    ref_cfg, cfg = _cfgs(dtype, window=5)
    rp, pp = _params(ref_cfg)
    rl = jax.tree_util.tree_map(lambda a: a[1], rp["stack"]["l0"]["attn"])
    pl = tf._layer(pp["stack"]["l0"]["attn"], 1)
    rx, px = _arr((2, 24, cfg.d_model), 21, dtype)
    renc, penc = _arr((2, 9, cfg.d_model), 22, dtype)
    pos = np.arange(24, dtype=np.float32)
    got = att.attn_forward(cfg, pl, px, torch.from_numpy(pos), kind=kind,
                           encoder=penc if kind == "cross" else None)
    want = ref_att.attn_forward(ref_cfg, rl, rx, jnp.asarray(pos), kind=kind,
                                encoder=renc if kind == "cross" else None)
    assert got.dtype == mod._DTYPES[dtype]
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["causal", "swa"])
def test_attn_decode_matches_reference(kind, dtype):
    """Ring-buffer decode past the cache length (slots wrap); swa with a
    window shorter than the cache."""
    ref_cfg, cfg = _cfgs(dtype, window=4)
    rp, pp = _params(ref_cfg)
    rl = jax.tree_util.tree_map(lambda a: a[2], rp["stack"]["l0"]["attn"])
    pl = tf._layer(pp["stack"]["l0"]["attn"], 2)
    rcache = ref_att.init_kv_cache(ref_cfg, 2, 6, ref_mod.dtype_of(ref_cfg))
    pcache = att.init_kv_cache(cfg, 2, 6, mod.dtype_of(cfg))
    for t in range(9):
        rx, px = _arr((2, 1, cfg.d_model), 30 + t, dtype)
        want, rcache = ref_att.attn_decode(ref_cfg, rl, rx, rcache,
                                           jnp.int32(t), kind=kind)
        got, pcache = att.attn_decode(cfg, pl, px, pcache, t, kind=kind)
        _close(got, want, dtype)
        _tree_close(pcache, rcache, dtype)


# ---------------------------------------------------------------- the slice

@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_reference(dtype):
    """prefill_with_cache's logits and every cache leaf, then 4 greedy
    decode steps (logits and cache), against the reference on the same
    weights."""
    ref_cfg, cfg = _cfgs(dtype)
    rp, pp = _params(ref_cfg)
    b, p0, steps_ = 2, 12, 4
    toks = np.random.default_rng(41).integers(0, cfg.vocab_size,
                                              (b, p0)).astype(np.int32)
    want, rcache = ref_tf.prefill_with_cache(rp, ref_cfg, jnp.asarray(toks),
                                             cache_len=p0 + steps_)
    got, pcache = tf.prefill_with_cache(pp, cfg, torch.from_numpy(toks),
                                        cache_len=p0 + steps_)
    assert got.dtype == torch.float32 and got.shape == (b, p0, 256)
    _close(got, want, dtype)
    _tree_close(pcache, rcache, dtype)
    tok = np.asarray(jnp.argmax(want[:, -1:], axis=-1)).astype(np.int32)
    for t in range(p0, p0 + steps_):
        want, rcache = ref_tf.decode_step(rp, ref_cfg, rcache,
                                          jnp.asarray(tok), jnp.int32(t))
        got, pcache = tf.decode_step(pp, cfg, pcache, torch.from_numpy(tok),
                                     t)
        _close(got, want, dtype)
        _tree_close(pcache, rcache, dtype)
        tok = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)


def test_decode_matches_forward():
    """The port against itself, as tests/test_models.py holds the
    reference: prefill + decode reproduce the full forward's logits."""
    _, cfg = _cfgs()
    params = tf.init_model(3, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(51).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    full = tf.logits_fn(params, cfg, toks)
    pl, cache = tf.prefill_with_cache(params, cfg, toks[:, :8], cache_len=12)
    np.testing.assert_allclose(pl.numpy(), full[:, :8].numpy(), rtol=1e-5,
                               atol=1e-5)
    dec = steps.build_decode_step(cfg)
    for t in range(8, 12):
        logits, cache = dec(params, cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("last_only", [False, True])
def test_prefill_step_and_loss_match_reference(last_only):
    ref_cfg, cfg = _cfgs(prefill_last_only=last_only)
    rp, pp = _params(ref_cfg)
    toks = np.random.default_rng(61).integers(0, cfg.vocab_size,
                                              (2, 16)).astype(np.int32)
    tgts = np.random.default_rng(62).integers(0, cfg.vocab_size,
                                              (2, 16)).astype(np.int32)
    want = ref_steps.build_prefill_step(ref_cfg)(
        rp, {"tokens": jnp.asarray(toks)})
    got = steps.build_prefill_step(cfg, device="cpu")(pp, {"tokens": toks})
    assert got.shape == (2, 1 if last_only else 16, cfg.vocab_size)
    _close(got, want, "float32")
    np.testing.assert_allclose(
        float(tf.loss_fn(pp, cfg, {"tokens": toks, "targets": tgts},
                         device="cpu")),
        float(ref_tf.loss_fn(rp, ref_cfg, {"tokens": jnp.asarray(toks),
                                           "targets": jnp.asarray(tgts)})),
        rtol=1e-5)
