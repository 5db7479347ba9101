"""Config-driven model assembly (port of `repro.models.transformer`, the
dense subset): init, full forward, prefill with a KV cache, and decode.

Parameters keep the reference's layout: `params["stack"]["l{i}"]` leaves
carry a leading `n_super` axis (one slice per repetition of cfg.pattern),
remainder layers sit in `params["rem"]`. `jax.lax.scan` over the stack
becomes a Python loop indexing that axis (views, no copies). There is no
remat: the port runs inference only.

Only dense attention layers are ported: the pattern element "attn" with
an MLP. Sliding-window, cross-attention, SSM and RG-LRU layers, MoE FFNs
(`n_experts > 0`) and the audio/patch frontends raise
`NotImplementedError` (ROADMAP.md queue 1 item 7).

Entry points take token ids as tensors or array-likes and run where the
caller says: on `device` when one is given, else on the device of a token
tensor, else on the CUDA card, raising when there is none.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as att
from repro_torch.models.modules import (apply_mlp, apply_norm, cross_entropy,
                                        dtype_of, embed_tokens,
                                        init_embedding, init_linear,
                                        init_mlp, init_norm, lm_logits)

_TODO = "is not ported yet (ROADMAP.md queue 1 item 7)"


def _require_dense(cfg: ArchConfig, encoder=None) -> None:
    for kind in cfg.pattern:
        if kind != "attn":
            raise NotImplementedError(f"layer kind {kind!r} {_TODO}")
    if cfg.n_experts:
        raise NotImplementedError(f"MoE FFN (n_experts={cfg.n_experts}) "
                                  f"{_TODO}")
    if cfg.frontend is not None or encoder is not None:
        raise NotImplementedError(f"frontend {cfg.frontend!r} / encoder "
                                  f"inputs {_TODO}")


def _tokens(tokens, device) -> torch.Tensor:
    """Token ids on the device the call runs on."""
    if device is None and isinstance(tokens, torch.Tensor):
        return tokens
    return torch.as_tensor(tokens, device=resolve_device(device))


def _layer(tree, i: int):
    """Slice i of every leaf of a stacked tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------- layer init
def _init_layer(gen, cfg: ArchConfig, *, lead: tuple = ()):
    """One dense layer: attention and, with d_ff > 0, an MLP."""
    p: dict[str, Any] = {
        "norm1": init_norm(cfg, cfg.d_model, device=gen.device, lead=lead),
        "attn": att.init_attn(gen, cfg, lead=lead)}
    if cfg.d_ff > 0:
        p["norm2"] = init_norm(cfg, cfg.d_model, device=gen.device,
                               lead=lead)
        p["ffn"] = init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, lead=lead)
    return p


def _rcast(cfg, y):
    """Pin branch outputs to the param dtype before the residual add when
    cfg.bf16_residual is set (the reference's §Perf knob)."""
    return y.to(dtype_of(cfg)) if cfg.bf16_residual else y


def _apply_ffn(cfg, p, x):
    h = apply_norm(cfg, p["norm2"], x)
    return x + _rcast(cfg, apply_mlp(cfg, p["ffn"], h))


def _apply_layer(cfg, p, x, positions):
    h = apply_norm(cfg, p["norm1"], x)
    a = att.attn_forward(cfg, p["attn"], h, positions,
                         kind=("causal" if cfg.causal else "none"))
    x = x + _rcast(cfg, a)
    if "ffn" in p:
        x = _apply_ffn(cfg, p, x)
    return x


# ---------------------------------------------------------------- model init
def init_model(seed: int, cfg: ArchConfig, *, device=None):
    """Random parameters in the reference's layout and distributions:
    N(0, 1/d_in) linears, N(0, 0.02²) embeddings, unit norm scales, all in
    cfg.param_dtype, drawn on the device from a generator seeded with
    `seed`."""
    _require_dense(cfg)
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    params: dict[str, Any] = {"embed": init_embedding(gen, cfg)}
    params["stack"] = {
        f"l{i}": _init_layer(gen, cfg, lead=(cfg.n_super,))
        for i in range(len(cfg.pattern))}
    params["rem"] = [_init_layer(gen, cfg) for _ in range(cfg.n_remainder)]
    params["final_norm"] = init_norm(cfg, cfg.d_model, device=gen.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg, cfg.d_model,
                                        cfg.vocab_size)
    return params


def _layers(params, cfg):
    """Each layer's params in order: the stack, then the remainder."""
    for n in range(cfg.n_super):
        sp = _layer(params["stack"], n)
        for i in range(len(cfg.pattern)):
            yield sp[f"l{i}"]
    yield from params["rem"]


# ---------------------------------------------------------------- forward
def forward(params, cfg: ArchConfig, inputs, *, encoder=None, device=None):
    """inputs: int tokens (B,S). Returns final hidden states (B,S,D)."""
    _require_dense(cfg, encoder)
    x = embed_tokens(params["embed"], _tokens(inputs, device))
    positions = torch.arange(x.shape[1], dtype=torch.float32,
                             device=x.device)
    for p in _layers(params, cfg):
        x = _apply_layer(cfg, p, x, positions)
    return apply_norm(cfg, params["final_norm"], x)


def logits_fn(params, cfg, inputs, *, encoder=None, device=None):
    return lm_logits(cfg, params, forward(params, cfg, inputs,
                                          encoder=encoder, device=device))


def loss_fn(params, cfg, batch, *, device=None):
    """Mean next-token cross entropy (forward only; no gradients yet)."""
    logits = logits_fn(params, cfg, batch["tokens"],
                       encoder=batch.get("image_embeds"), device=device)
    targets = torch.as_tensor(batch["targets"], device=logits.device)
    return cross_entropy(logits, targets)


# ---------------------------------------------------------------- decode
def _cache_len(cfg, kind: str, seq_len: int) -> int:
    if kind == "swa":
        return min(seq_len, cfg.window)
    return seq_len


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, *, device=None):
    """Decode cache: per pattern position, stacked over super-layers."""
    _require_dense(cfg)
    dev = resolve_device(device)
    dt = dtype_of(cfg)
    length = _cache_len(cfg, "attn", seq_len)
    return {
        "stack": {f"l{i}": att.init_kv_cache(cfg, batch, length, dt,
                                             device=dev, lead=(cfg.n_super,))
                  for i in range(len(cfg.pattern))},
        "rem": [att.init_kv_cache(cfg, batch, length, dt, device=dev)
                for _ in range(cfg.n_remainder)],
    }


def _cache_layers(cache, cfg):
    """Each layer's cache (views into the stacked tensors), in the order
    of `_layers`."""
    for n in range(cfg.n_super):
        sc = _layer(cache["stack"], n)
        for i in range(len(cfg.pattern)):
            yield sc[f"l{i}"]
    yield from cache["rem"]


def _apply_layer_decode(cfg, p, x, cache, pos):
    h = apply_norm(cfg, p["norm1"], x)
    a, cache = att.attn_decode(cfg, p["attn"], h, cache, pos, kind="causal")
    x = x + a
    if "ffn" in p:
        x = _apply_ffn(cfg, p, x)
    return x, cache


def decode_step(params, cfg: ArchConfig, cache, token, pos, *, device=None):
    """One new token against the cache. token (B,1) int; pos its position.
    Returns (logits (B,1,V) f32, cache); the cache is updated in place."""
    _require_dense(cfg)
    x = embed_tokens(params["embed"], _tokens(token, device))
    pos = int(pos)
    for p, c in zip(_layers(params, cfg), _cache_layers(cache, cfg)):
        x, _ = _apply_layer_decode(cfg, p, x, c, pos)
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params, x), cache


# ------------------------------------------------------- prefill with cache
def prefill_with_cache(params, cfg: ArchConfig, tokens, *, encoder=None,
                       cache_len: int | None = None, device=None):
    """Forward pass that also builds the decode cache. Returns (logits
    (B,S,V) f32, cache with room for cache_len positions)."""
    _require_dense(cfg, encoder)
    tokens = _tokens(tokens, device)
    b, s = tokens.shape[0], tokens.shape[1]
    cache_len = cache_len or s
    cache = init_cache(cfg, b, cache_len, device=tokens.device)
    x = embed_tokens(params["embed"], tokens)
    positions = torch.arange(s, dtype=torch.float32, device=x.device)
    length = _cache_len(cfg, "attn", cache_len)
    keep = min(s, length)
    slots = torch.arange(s - keep, s, device=x.device) % length
    for p, c in zip(_layers(params, cfg), _cache_layers(cache, cfg)):
        h = apply_norm(cfg, p["norm1"], x)
        a, k, v = att._attn_forward_kv(cfg, p["attn"], h, positions,
                                       kind="causal")
        c["k"][:, slots] = k[:, s - keep:]
        c["v"][:, slots] = v[:, s - keep:]
        c["pos"][slots] = torch.arange(s - keep, s, dtype=torch.int32,
                                       device=x.device)
        x = x + a
        if "ffn" in p:
            x = _apply_ffn(cfg, p, x)
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params, x), cache
