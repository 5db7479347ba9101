"""All ten architectures of the reference, through the port, on the CPU.

For each architecture at the reference's `reduced` size in float32: the
configs field for field, the parameter tree's names, shapes and dtypes,
`params_from_arrays` bit for bit (in bf16 too, with the float32 leaves a
bf16 model keeps), logits and loss against the reference, and for the
nine decoders `prefill_with_cache` plus 8 greedy `decode_step`s (logits
and every cache leaf). Weights come from the reference's `init_model`
and cross over through `repro_torch.convert.params_from_arrays`; tokens,
frames and patch embeddings from numpy generators of fixed seeds. The
reference's functions run under `jax.jit` (one trace per architecture,
shared by a module-scoped fixture). Tolerance: rtol/atol `TOL` = 1e-4,
where the packages differ only in the order of sums.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import steps as ref_steps
from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.convert import params_from_arrays
from repro_torch.models import steps
from repro_torch.models import transformer as tf

TOL = 1e-4
ARCHS = list(ref_configs.ARCHS)
DECODERS = [a for a in ARCHS if ref_configs.get(a).decoder]
B, S, PROMPT, STEPS = 2, 16, 12, 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _tree_close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _tree_close(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _tree_close(g, w)
    elif np.issubdtype(np.asarray(want).dtype, np.integer):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want)


def _signature(tree):
    """{path: (shape, dtype name)} of a parameter tree of either package."""
    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                yield from walk(v, path + (i,))
        else:
            dt = str(node.dtype).replace("torch.", "")
            yield "/".join(map(str, path)), (tuple(node.shape), dt)
    return dict(walk(tree, ()))


def _inputs(cfg, seed=0):
    """Token ids or audio frames (B, S), patch embeddings, targets."""
    g = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        inp = g.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        inp = g.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    enc = None
    if cfg.frontend == "patch":
        enc = g.standard_normal((B, cfg.n_frontend_tokens,
                                 cfg.d_model)).astype(np.float32)
    tgt = g.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return inp, enc, tgt


class Arch:
    def __init__(self, name):
        self.ref_cfg = ref_configs.reduced(name)
        self.cfg = configs.reduced(name)
        self.rp = ref_tf.init_model(jax.random.PRNGKey(1), self.ref_cfg)
        self.arrays = jax.tree_util.tree_map(np.asarray, self.rp)
        self.pp = params_from_arrays(self.arrays, device="cpu")
        self.inp, self.enc, self.tgt = _inputs(self.cfg)


@pytest.fixture(scope="module")
def arch():
    """name → its Arch, made once per module."""
    made = {}

    def get(name):
        if name not in made:
            made[name] = Arch(name)
        return made[name]
    return get


def _opt(x):
    return None if x is None else jnp.asarray(x)


# ---------------------------------------------------------------- configs

def test_registry_matches_reference():
    assert list(configs.ARCHS) == list(ref_configs.ARCHS)
    assert {k: dataclasses.asdict(v) for k, v in configs.GRAPHS.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.GRAPHS.items()}
    for name, g in configs.GRAPHS.items():
        assert g.subspace == ref_configs.GRAPHS[name].subspace
    with pytest.raises(KeyError):
        configs.get("no-such-model")


@pytest.mark.parametrize("name", ARCHS)
def test_configs_match_reference(name):
    for fn in ("get", "reduced"):
        want = getattr(ref_configs, fn)(name)
        got = getattr(configs, fn)(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert (got.hd, got.n_super, got.n_remainder) == \
            (want.hd, want.n_super, want.n_remainder)


# ---------------------------------------------------------------- params

@pytest.mark.parametrize("name", ARCHS)
def test_init_model_tree_matches_reference(name, arch):
    """The port's own init: the reference's leaf names, shapes and dtypes."""
    a = arch(name)
    got = tf.init_model(0, a.cfg, device="cpu")
    assert _signature(got) == _signature(a.arrays)
    assert sum(t.numel() for t in jax.tree_util.tree_leaves(got)) == \
        sum(x.size for x in jax.tree_util.tree_leaves(a.arrays))


@pytest.mark.parametrize("name", ARCHS)
def test_params_from_arrays_bit_for_bit_bf16(name):
    """A bf16 model of every family crosses bit for bit, its float32
    leaves (the SSM's a_log, dt_bias, d_skip, the RG-LRU's lam) staying
    float32."""
    cfg = dataclasses.replace(ref_configs.reduced(name),
                              param_dtype="bfloat16")
    arrays = jax.tree_util.tree_map(
        np.asarray, ref_tf.init_model(jax.random.PRNGKey(2), cfg))
    got = params_from_arrays(arrays, device="cpu")
    sig = _signature(got)
    assert sig == _signature(arrays)
    f32 = {k for k, (_, dt) in sig.items() if dt == "float32"}
    want_f32 = {"ssm": {"a_log", "dt_bias", "d_skip"}, "rec": {"lam"}}
    assert {k.rsplit("/", 1)[1] for k in f32} == set().union(
        *(v for kind, v in want_f32.items()
          if any(f"/{kind}/" in k for k in sig)))
    for a, t in zip(jax.tree_util.tree_leaves(arrays),
                    jax.tree_util.tree_leaves(got)):
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(), a.view(np.uint16).view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)


# ---------------------------------------------------------------- forward

@pytest.mark.parametrize("name", ARCHS)
def test_logits_and_loss_match_reference(name, arch):
    a = arch(name)
    want = jax.jit(ref_tf.logits_fn, static_argnums=1)(
        a.rp, a.ref_cfg, jnp.asarray(a.inp), encoder=_opt(a.enc))
    got = tf.logits_fn(a.pp, a.cfg, a.inp, encoder=a.enc, device="cpu")
    assert got.dtype == torch.float32
    _close(got, want)
    key = "frames" if a.cfg.frontend == "audio" else "tokens"
    batch = {key: a.inp, "targets": a.tgt}
    if a.enc is not None:
        batch["image_embeds"] = a.enc
    want_loss = jax.jit(ref_tf.loss_fn, static_argnums=1)(
        a.rp, a.ref_cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(
        float(tf.loss_fn(a.pp, a.cfg, batch, device="cpu")),
        float(want_loss), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", DECODERS)
def test_prefill_and_decode_match_reference(name, arch):
    """prefill_with_cache's logits and every cache leaf, then 8 greedy
    decode steps (logits and cache), against the reference on the same
    weights; swa layers wrap their ring buffer when the window is cut to
    8 below the cache length."""
    a = arch(name)
    ref_cfg, cfg = a.ref_cfg, a.cfg
    if "swa" in cfg.pattern:
        ref_cfg = dataclasses.replace(ref_cfg, window=8)
        cfg = dataclasses.replace(cfg, window=8)
    toks = a.inp[:, :PROMPT]
    cache_len = PROMPT + STEPS
    rprefill = jax.jit(ref_tf.prefill_with_cache, static_argnums=1,
                       static_argnames="cache_len")
    want, rcache = rprefill(a.rp, ref_cfg, jnp.asarray(toks),
                            encoder=_opt(a.enc), cache_len=cache_len)
    got, pcache = tf.prefill_with_cache(a.pp, cfg, toks, encoder=a.enc,
                                        cache_len=cache_len, device="cpu")
    _close(got, want)
    _tree_close(pcache, rcache)
    rdecode = jax.jit(ref_tf.decode_step, static_argnums=1)
    tok = np.asarray(jnp.argmax(want[:, -1:], axis=-1)).astype(np.int32)
    for t in range(PROMPT, cache_len):
        want, rcache = rdecode(a.rp, ref_cfg, rcache, jnp.asarray(tok),
                               jnp.int32(t))
        got, pcache = tf.decode_step(a.pp, cfg, pcache, tok, t,
                                     device="cpu")
        _close(got, want)
        tok = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)
    _tree_close(pcache, rcache)


@pytest.mark.parametrize("name", ["hubert-xlarge", "llama-3.2-vision-90b"])
@pytest.mark.parametrize("last_only", [False, True])
def test_prefill_step_with_frontend_inputs(name, last_only, arch):
    """build_prefill_step with audio frames (hubert, an encoder: all
    positions even with prefill_last_only) and with patch embeddings."""
    a = arch(name)
    ref_cfg = dataclasses.replace(a.ref_cfg, prefill_last_only=last_only)
    cfg = dataclasses.replace(a.cfg, prefill_last_only=last_only)
    key = "frames" if cfg.frontend == "audio" else "tokens"
    batch = {key: a.inp}
    if a.enc is not None:
        batch["image_embeds"] = a.enc
    want = jax.jit(ref_steps.build_prefill_step(ref_cfg))(
        a.rp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = steps.build_prefill_step(cfg, device="cpu")(a.pp, batch)
    s = 1 if last_only and cfg.decoder else S
    assert got.shape == (B, s, cfg.vocab_size)
    _close(got, want)


def test_encoder_only_model_has_no_decode(arch):
    a = arch("hubert-xlarge")
    with pytest.raises(ValueError, match="encoder-only"):
        tf.prefill_with_cache(a.pp, a.cfg, np.zeros((1, 4), np.int32),
                              device="cpu")
    cache = tf.init_cache(a.cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        tf.decode_step(a.pp, a.cfg, cache, np.zeros((1, 1), np.int32), 0,
                       device="cpu")
