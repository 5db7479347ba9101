"""The port's kernel-free LM layers against the JAX package, on the CPU:
SSD (Mamba-2), RG-LRU, MoE, sliding-window and cross attention.

Both packages get the same inputs: a layer's weights come from the
reference's initializer, copied bit for bit by
`repro_torch.convert.params_from_arrays`, and activations come from numpy
generators of fixed seeds. Configs are the reference's `reduced` ones, in
float32, where the two packages differ only in the order of sums (the
SSD's multi-operand einsums contract in another order in torch; the
RG-LRU scan combines in another tree): rtol/atol `TOL` = 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_att
from repro.models import moe as ref_moe
from repro.models import rglru as ref_rg
from repro.models import ssm as ref_ssm
from repro_torch import configs
from repro_torch.convert import params_from_arrays
from repro_torch.models import attention as att
from repro_torch.models import moe
from repro_torch.models import rglru as rg
from repro_torch.models import ssm

TOL = 1e-4


def _cfgs(name, **kw):
    return (dataclasses.replace(ref_configs.reduced(name), **kw),
            dataclasses.replace(configs.reduced(name), **kw))


def _arr(shape, seed, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape)
         * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _port(tree):
    return params_from_arrays(jax.tree_util.tree_map(np.asarray, tree),
                              device="cpu")


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _tree_close(got, want):
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])


# ------------------------------------------------------------------- SSD

@pytest.mark.parametrize("l,chunk", [(16, 4), (24, 8), (13, 8), (5, 8),
                                     (40, 16)])
def test_ssd_chunked_matches_reference(l, chunk):
    """Whole chunks, a padded last chunk (L % chunk ≠ 0) and one chunk
    shorter than `chunk`."""
    bsz, h, p, n = 2, 3, 4, 5
    rx, px = _arr((bsz, l, h, p), 1)
    ra, pa = _arr((bsz, l, h), 2)
    ra, pa = -jnp.abs(ra) * 0.3, -pa.abs() * 0.3
    rb, pb = _arr((bsz, l, n), 3)
    rc, pc = _arr((bsz, l, n), 4)
    want_y, want_s = jax.jit(ref_ssm._ssd_chunked, static_argnums=4)(
        rx, ra, rb, rc, chunk)
    got_y, got_s = ssm._ssd_chunked(px, pa, pb, pc, chunk)
    assert got_y.shape == (bsz, l, h, p) and got_s.shape == (bsz, h, p, n)
    _close(got_y, want_y)
    _close(got_s, want_s)


def test_segsum_matches_reference():
    rx, px = _arr((2, 3, 7), 5)
    want = np.asarray(ref_ssm._segsum(rx))
    got = ssm._segsum(px).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=TOL, atol=TOL)


def test_ssm_forward_and_decode_match_reference():
    """The full-sequence form (output and final state) and 6 decode steps
    from an empty cache (output, conv tail and state after each)."""
    ref_cfg, cfg = _cfgs("mamba2-780m")
    rp = ref_ssm.init_ssm(jax.random.PRNGKey(0), ref_cfg)
    pp = _port(rp)
    rx, px = _arr((2, 13, cfg.d_model), 6)
    want, want_state = jax.jit(ref_ssm.ssm_forward, static_argnums=0,
                               static_argnames="return_state")(
        ref_cfg, rp, rx, return_state=True)
    got, got_state = ssm.ssm_forward(cfg, pp, px, return_state=True)
    _close(got, want)
    _close(got_state, want_state)
    _close(ssm.ssm_forward(cfg, pp, px), want)
    rcache = ref_ssm.init_ssm_cache(ref_cfg, 2, jnp.float32)
    pcache = ssm.init_ssm_cache(cfg, 2, torch.float32)
    assert {k: tuple(v.shape) for k, v in pcache.items()} == \
        {k: v.shape for k, v in rcache.items()}
    ref_decode = jax.jit(ref_ssm.ssm_decode, static_argnums=0)
    for t in range(6):
        want, rcache = ref_decode(ref_cfg, rp, rx[:, t:t + 1], rcache)
        got, pcache = ssm.ssm_decode(cfg, pp, px[:, t:t + 1], pcache)
        _close(got, want)
        _tree_close(pcache, rcache)


# ---------------------------------------------------------------- RG-LRU

@pytest.mark.parametrize("l", [1, 2, 7, 64, 100])
def test_rglru_scan_matches_sequential(l):
    """The doubling scan against the step-by-step recurrence, at lengths
    that are and are not powers of two."""
    _, pa = _arr((2, l, 8), 7)
    _, pb = _arr((2, l, 8), 8)
    a = torch.sigmoid(pa)
    np.testing.assert_allclose(rg.scan(a, pb).numpy(),
                               rg.scan_sequential(a, pb).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_rglru_forward_and_decode_match_reference():
    """Forward (output and final h) against the reference and against the
    sequential oracle's h, then 6 decode steps from an empty cache."""
    ref_cfg, cfg = _cfgs("recurrentgemma-2b")
    rp = ref_rg.init_rglru(jax.random.PRNGKey(0), ref_cfg)
    pp = _port(rp)
    rx, px = _arr((2, 37, cfg.d_model), 9)
    want, want_h = jax.jit(ref_rg.rglru_forward, static_argnums=0,
                           static_argnames="return_state")(
        ref_cfg, rp, rx, return_state=True)
    got, got_h = rg.rglru_forward(cfg, pp, px, return_state=True)
    _close(got, want)
    _close(got_h, want_h)
    xb, _ = rg._conv1d(pp["conv_w"], pp["conv_b"],
                       px @ pp["in_x"]["w"])
    a, b = rg._gates(pp, xb)
    _close(rg.scan_sequential(a, b)[:, -1], want_h)
    rcache = ref_rg.init_rglru_cache(ref_cfg, 2, jnp.float32)
    pcache = rg.init_rglru_cache(cfg, 2, torch.float32)
    ref_decode = jax.jit(ref_rg.rglru_decode, static_argnums=0)
    for t in range(6):
        want, rcache = ref_decode(ref_cfg, rp, rx[:, t:t + 1], rcache)
        got, pcache = rg.rglru_decode(cfg, pp, px[:, t:t + 1], pcache)
        _close(got, want)
        _tree_close(pcache, rcache)


# ------------------------------------------------------------------- MoE

def _moe_case(name, seed=0, **kw):
    ref_cfg, cfg = _cfgs(name, **kw)
    rp = ref_moe.init_moe(jax.random.PRNGKey(seed), ref_cfg)
    return ref_cfg, cfg, rp


def _tie_router(rp):
    """Experts 1 and 2 get the same router column: every token's
    probabilities tie between them."""
    w = np.asarray(rp["router"]["w"]).copy()
    w[:, 2] = w[:, 1]
    return {**rp, "router": {"w": jnp.asarray(w)}}


@pytest.mark.parametrize("case", ["grok-no-drops", "arctic-no-drops",
                                  "grok-drops", "arctic-drops",
                                  "grok-tied", "grok-tied-drops",
                                  "grok-regroup", "arctic-regroup"])
def test_moe_forward_matches_reference(case):
    """capacity_factor 8 (the reduced default: nothing dropped), a
    capacity that drops routings, router logits tied between two experts
    (with and without drops: the tie order decides the queue order), and
    decode inputs with moe_decode_regroup (one group of the whole
    batch)."""
    name = "grok-1-314b" if case.startswith("grok") else "arctic-480b"
    kw = {}
    if "drops" in case and "no-drops" not in case:
        kw["capacity_factor"] = 0.5
    if "regroup" in case:
        kw["moe_decode_regroup"] = True
    ref_cfg, cfg, rp = _moe_case(name, **kw)
    if "tied" in case:
        rp = _tie_router(rp)
    pp = _port(rp)
    shape = (5, 1, cfg.d_model) if "regroup" in case else (2, 24,
                                                           cfg.d_model)
    rx, px = _arr(shape, 10)
    want = ref_moe.moe_forward(ref_cfg, rp, rx)
    moe.ROUTING_LOG = []
    try:
        got = moe.moe_forward(cfg, pp, px)
        log, = moe.ROUTING_LOG
    finally:
        moe.ROUTING_LOG = None
    dropped = int(log["dropped"])
    g, s = (1, 5) if "regroup" in case else (2, 24)
    assert log["experts"].shape == (g, s, cfg.top_k)
    assert log["margin"].shape == (g, s) and bool((log["margin"] >= 0).all())
    if "tied" in case:      # a tie at the k-th place has no margin
        assert bool((log["margin"] == 0).any())
    _close(got, want)
    if "drops" in case and "no-drops" not in case:
        assert dropped > 0
    else:
        assert dropped == 0


def test_top_k_breaks_ties_as_jax_does():
    """Lower index first on ties, for ties at every place of the top k."""
    probs = np.array([[0.1, 0.3, 0.3, 0.3, 0.0],
                      [0.25, 0.25, 0.25, 0.25, 0.0],
                      [0.0, 0.2, 0.4, 0.2, 0.2],
                      [0.5, 0.1, 0.1, 0.1, 0.2]], np.float32)
    for k in (1, 2, 3):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = moe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_capacity_matches_reference():
    for name in ("grok-1-314b", "arctic-480b"):
        for cf in (0.25, 1.25, 8.0):
            ref_cfg, cfg = _cfgs(name, capacity_factor=cf)
            for s in (1, 7, 24, 1024):
                assert moe.capacity(cfg, s) == ref_moe.capacity(ref_cfg, s)


def test_aux_load_balance_loss_matches_reference():
    ref_cfg, cfg = _cfgs("arctic-480b")
    for shape in ((32, cfg.n_experts), (2, 16, cfg.n_experts)):
        rl, pl = _arr(shape, 11)
        np.testing.assert_allclose(
            float(moe.aux_load_balance_loss(cfg, pl)),
            float(ref_moe.aux_load_balance_loss(ref_cfg, rl)), rtol=1e-5)


# -------------------------------------------------------------- attention

def _attn_case(name, seed=0, **kw):
    ref_cfg, cfg = _cfgs(name, **kw)
    rp = ref_att.init_attn(jax.random.PRNGKey(seed), ref_cfg)
    return ref_cfg, cfg, rp, _port(rp)


@pytest.mark.parametrize("kind,s", [("swa", 40), ("swa", 2048),
                                    ("cross", 40), ("cross", 2048)])
def test_plain_attention_matches_reference(kind, s):
    """Sliding-window (window 32, shorter than the sequence) and cross
    attention on the plain path, unchunked and above Q_CHUNK (two query
    chunks of 1,024 rows)."""
    name = "h2o-danube-3-4b" if kind == "swa" else "llama-3.2-vision-90b"
    ref_cfg, cfg, rp, pp = _attn_case(name)
    rx, px = _arr((1, s, cfg.d_model), 12)
    renc, penc = _arr((1, 24, cfg.d_model), 13)
    pos = np.arange(s, dtype=np.float32)
    enc = (renc, penc) if kind == "cross" else (None, None)
    want = ref_att.attn_forward(ref_cfg, rp, rx, jnp.asarray(pos), kind=kind,
                                encoder=enc[0])
    got = att.attn_forward(cfg, pp, px, torch.from_numpy(pos), kind=kind,
                           encoder=enc[1])
    _close(got, want)


def test_plain_attention_above_q_chunk_needs_whole_chunks():
    _, cfg, _, pp = _attn_case("h2o-danube-3-4b")
    _, px = _arr((1, att.Q_CHUNK + 8, cfg.d_model), 14)
    pos = torch.arange(px.shape[1], dtype=torch.float32)
    with pytest.raises(ValueError, match="multiple"):
        att.attn_forward(cfg, pp, px, pos, kind="swa")


def test_cross_attention_decode_matches_reference():
    """precompute_cross_kv, then attn_decode(kind="cross") over the
    encoder's keys and values at several positions."""
    ref_cfg, cfg, rp, pp = _attn_case("llama-3.2-vision-90b")
    renc, penc = _arr((2, 16, cfg.d_model), 15)
    rkv = ref_att.precompute_cross_kv(ref_cfg, rp, renc)
    pkv = att.precompute_cross_kv(cfg, pp, penc)
    for g, w in zip(pkv, rkv):
        _close(g, w)
    for t in range(3):
        rx, px = _arr((2, 1, cfg.d_model), 16 + t)
        want, _ = ref_att.attn_decode(ref_cfg, rp, rx, None, jnp.int32(t),
                                      kind="cross", encoder_kv=rkv)
        got, cache = att.attn_decode(cfg, pp, px, None, t, kind="cross",
                                     encoder_kv=pkv)
        assert cache is None
        _close(got, want)
