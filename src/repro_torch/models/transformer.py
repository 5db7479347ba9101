"""Config-driven model assembly (port of `repro.models.transformer`): init,
full forward, prefill with a decode cache, and decode, for every layer
kind and frontend of the reference.

  pattern elements: attn | swa | cross | ssm | rglru
  families: dense GQA (yi, qwen2, mistral-large, h2o-danube-SWA),
            MoE (grok-1, arctic + dense residual), encoder-only audio
            (hubert), VLM cross-attn (llama-3.2-vision), hybrid RG-LRU
            (recurrentgemma), SSD (mamba2).

Parameters keep the reference's layout: `params["stack"]["l{i}"]` leaves
carry a leading `n_super` axis (one slice per repetition of cfg.pattern),
remainder layers sit in `params["rem"]` (layer i of the remainder has
kind `cfg.pattern[i]`). `jax.lax.scan` over the stack becomes a Python
loop over that axis (views, no copies). The full forward unbinds each
stacked leaf once, so that its backward stacks the super-layers'
gradients in one step rather than adding a stack-sized gradient per
slice. With cfg.remat and grad enabled, each super-layer runs under
`torch.utils.checkpoint` (non-reentrant), as the reference wraps the
scan body in `jax.checkpoint`: its activations are dropped and
recomputed in the backward, the flash forward included; the recompute
does not log MoE routings (`moe.routing_log_paused`), so
`moe.ROUTING_LOG` sees each routing once. A double backward (a
Hessian-vector product) recomputes a layer more than once, so the
recompute's contexts are made anew at each entry. The remainder layers
run without remat, as in the reference.

Sharded training (`train.sharded`) passes `gather`, a hook that turns a
subtree of parameter blocks into full parameters: `logits_fn` and
`forward` call it once on every leaf outside the stack, and each
super-layer calls it on its slice inside the remat region, so a
recompute gathers again rather than keeping a full layer alive. Without
it (`gather=None`) nothing changes.

Frontends are stubs, as in the reference: an audio model takes frame
embeddings (B, S, D) through `embed.in_proj`, a patch model takes patch
embeddings (B, n_img, D) as the cross-attention layers' `encoder`. Both
are cast to the parameter dtype.

Entry points take token ids, frames or patch embeddings as tensors or
array-likes and run where the caller says: on `device` when one is
given, else on the device of an input tensor, else on the CUDA card,
raising when there is none.
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as att
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rg
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.modules import (apply_linear, apply_mlp, apply_norm,
                                        cross_entropy, dtype_of,
                                        embed_tokens, init_embedding,
                                        init_linear, init_mlp, init_norm,
                                        lm_logits, ShapeOnly)

def _on(x, device, dtype=None) -> torch.Tensor:
    """An input on the device the call runs on (`device`, else the
    tensor's own, else the card), in `dtype` when one is given."""
    if device is None and isinstance(x, torch.Tensor):
        t = x
    else:
        t = torch.as_tensor(x, device=resolve_device(device))
    return t if dtype is None else t.to(dtype)


def _layer(tree, i: int):
    """Slice i of every leaf of a stacked tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _moe(cfg, kind: str) -> bool:
    return bool(cfg.n_experts) and kind in ("attn", "swa")


# ---------------------------------------------------------------- layer init
def _init_layer(gen, cfg: ArchConfig, kind: str, *, lead: tuple = ()):
    """One layer of `kind`: its mixer and, but for SSM layers and with
    d_ff > 0, an FFN (MoE on attn/swa layers of an MoE config)."""
    p: dict[str, Any] = {
        "norm1": init_norm(cfg, cfg.d_model, device=gen.device, lead=lead)}
    if kind in ("attn", "swa", "cross"):
        p["attn"] = att.init_attn(gen, cfg, cross=(kind == "cross"),
                                  lead=lead)
    elif kind == "ssm":
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, lead=lead)
    elif kind == "rglru":
        p["rec"] = rg.init_rglru(gen, cfg, lead=lead)
    else:
        raise ValueError(kind)
    if kind != "ssm" and cfg.d_ff > 0:
        p["norm2"] = init_norm(cfg, cfg.d_model, device=gen.device,
                               lead=lead)
        if _moe(cfg, kind):
            p["ffn"] = moe_mod.init_moe(gen, cfg, lead=lead)
        else:
            p["ffn"] = init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, lead=lead)
    return p


def _rcast(cfg, y):
    """Pin branch outputs to the param dtype before the residual add when
    cfg.bf16_residual is set (the reference's §Perf knob)."""
    return y.to(dtype_of(cfg)) if cfg.bf16_residual else y


def _apply_ffn(cfg, p, kind, x):
    h = apply_norm(cfg, p["norm2"], x)
    if _moe(cfg, kind):
        return x + _rcast(cfg, moe_mod.moe_forward(cfg, p["ffn"], h))
    return x + _rcast(cfg, apply_mlp(cfg, p["ffn"], h))


def _self_kind(cfg, kind: str) -> str:
    """The attention kind of a self-attention layer in the full forward."""
    if kind == "swa":
        return "swa"
    return "causal" if cfg.causal else "none"


def _apply_layer(cfg, p, kind, x, positions, encoder):
    h = apply_norm(cfg, p["norm1"], x)
    if kind in ("attn", "swa"):
        x = x + _rcast(cfg, att.attn_forward(cfg, p["attn"], h, positions,
                                             kind=_self_kind(cfg, kind)))
    elif kind == "cross":
        x = x + _rcast(cfg, att.attn_forward(cfg, p["attn"], h, positions,
                                             kind="cross", encoder=encoder))
    elif kind == "ssm":
        return x + _rcast(cfg, ssm_mod.ssm_forward(cfg, p["ssm"], h))
    elif kind == "rglru":
        x = x + _rcast(cfg, rg.rglru_forward(cfg, p["rec"], h))
    else:
        raise ValueError(kind)
    if "ffn" in p:
        x = _apply_ffn(cfg, p, kind, x)
    return x


# ---------------------------------------------------------------- model init
def init_model(seed: int, cfg: ArchConfig, *, device=None):
    """Random parameters in the reference's layout and distributions:
    N(0, 1/d_in) linears, N(0, 0.02²) embeddings, unit norm scales, the
    SSM's and RG-LRU's constants as the reference sets them, all in
    cfg.param_dtype but the float32 leaves the reference keeps float32
    (`a_log`, `dt_bias`, `d_skip`, `lam`); drawn on the device from a
    generator seeded with `seed`. On `device="meta"` the leaves have
    shapes and types only."""
    dev = resolve_device(device)
    gen = (ShapeOnly() if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    params: dict[str, Any] = {}
    if cfg.frontend == "audio":
        # frame embeddings come in directly; a linear stands in for the
        # stubbed conv feature extractor's final projection
        params["embed"] = {"in_proj": init_linear(gen, cfg, cfg.d_model,
                                                  cfg.d_model)}
    else:
        params["embed"] = init_embedding(gen, cfg)
    params["stack"] = {
        f"l{i}": _init_layer(gen, cfg, kind, lead=(cfg.n_super,))
        for i, kind in enumerate(cfg.pattern)}
    params["rem"] = [_init_layer(gen, cfg, cfg.pattern[i])
                     for i in range(cfg.n_remainder)]
    params["final_norm"] = init_norm(cfg, cfg.d_model, device=gen.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg, cfg.d_model,
                                        cfg.vocab_size)
    return params


def _layers(tree, cfg):
    """(kind, each layer's subtree) in order: the stack, then the
    remainder. Over params or a cache (views into stacked tensors)."""
    for n in range(cfg.n_super):
        sp = _layer(tree["stack"], n)
        for i, kind in enumerate(cfg.pattern):
            yield kind, sp[f"l{i}"]
    for i, p in enumerate(tree["rem"]):
        yield cfg.pattern[i], p


def _embed(params, cfg, inputs, device) -> torch.Tensor:
    """Token ids (B, S) through the embedding table, or audio frames
    (B, S, D) through the frontend's input projection."""
    if cfg.frontend == "audio":
        return apply_linear(params["embed"]["in_proj"],
                            _on(inputs, device, dtype_of(cfg)))
    return embed_tokens(params["embed"], _on(inputs, device))


def _encoder(cfg, encoder, device, like: torch.Tensor):
    if encoder is None:
        return None
    return _on(encoder, device if device is not None else like.device,
               dtype_of(cfg))


# ---------------------------------------------------------------- forward
def _unbind(tree, n: int) -> list:
    """A stacked tree as n trees of slices: one `torch.unbind` per leaf."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _super_layer(cfg, sp, x, positions, encoder, gather=None):
    """One repetition of cfg.pattern (the reference's scan body)."""
    if gather is not None:
        sp = gather("stack", sp)
    for i, kind in enumerate(cfg.pattern):
        x = _apply_layer(cfg, sp[f"l{i}"], kind, x, positions, encoder)
    return x


class _RoutingLogPaused:
    """`moe.routing_log_paused()` that can be entered again and again: a
    fresh generator context at each entry."""

    def __enter__(self):
        self._ctx = moe_mod.routing_log_paused()
        return self._ctx.__enter__()

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)


def _recompute_contexts():
    return contextlib.nullcontext(), _RoutingLogPaused()


def _gather_top(params, gather):
    """Every leaf outside the stack full (one `gather` call); the stack's
    blocks as they are."""
    if gather is None:
        return params
    top = gather("", {k: v for k, v in params.items() if k != "stack"})
    return {**top, "stack": params["stack"]}


def forward(params, cfg: ArchConfig, inputs, *, encoder=None, device=None,
            gather=None):
    """inputs: int tokens (B,S), or frame embeddings (B,S,D) for audio
    frontends; encoder: patch embeddings (B,n_img,D) for cross layers.
    Returns final hidden states (B,S,D)."""
    return _forward(_gather_top(params, gather), cfg, inputs, encoder,
                    device, gather)


def _forward(params, cfg, inputs, encoder, device, gather):
    x = _embed(params, cfg, inputs, device)
    encoder = _encoder(cfg, encoder, device, x)
    positions = torch.arange(x.shape[1], dtype=torch.float32,
                             device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for sp in _unbind(params["stack"], cfg.n_super):
        if remat:
            # the layers draw no random numbers: no RNG state to keep
            x = checkpoint(_super_layer, cfg, sp, x, positions, encoder,
                           gather, use_reentrant=False,
                           preserve_rng_state=False,
                           context_fn=_recompute_contexts)
        else:
            x = _super_layer(cfg, sp, x, positions, encoder, gather)
    for i, p in enumerate(params["rem"]):
        x = _apply_layer(cfg, p, cfg.pattern[i], x, positions, encoder)
    return apply_norm(cfg, params["final_norm"], x)


def logits_fn(params, cfg, inputs, *, encoder=None, device=None,
              gather=None, last_only: bool = False):
    """Logits f32 (B, S, V); (B, 1, V) of the last position alone with
    `last_only` (the head projects no other position)."""
    params = _gather_top(params, gather)
    h = _forward(params, cfg, inputs, encoder, device, gather)
    return lm_logits(cfg, params, h[:, -1:] if last_only else h)


def loss_fn(params, cfg, batch, *, device=None, gather=None):
    """Mean next-token cross entropy over the batch's "targets", from
    "tokens" (or "frames" for an audio frontend, with "image_embeds" for
    a patch frontend). Differentiable in the parameters: the flash
    kernel has a backward kernel (`kernels.ops.flash_attention`)."""
    inp = batch.get("frames") if cfg.frontend == "audio" else \
        batch["tokens"]
    logits = logits_fn(params, cfg, inp, encoder=batch.get("image_embeds"),
                       device=device, gather=gather)
    targets = torch.as_tensor(batch["targets"], device=logits.device)
    return cross_entropy(logits, targets)


# ---------------------------------------------------------------- decode
def _cache_len(cfg, kind: str, seq_len: int) -> int:
    if kind == "swa":
        return min(seq_len, cfg.window)
    return seq_len


def _init_layer_cache(cfg, kind: str, batch: int, seq_len: int, nimg: int,
                      device, lead: tuple = ()):
    dt = dtype_of(cfg)
    if kind in ("attn", "swa"):
        return att.init_kv_cache(cfg, batch, _cache_len(cfg, kind, seq_len),
                                 dt, device=device, lead=lead)
    if kind == "cross":
        shape = tuple(lead) + (batch, nimg, cfg.n_kv_heads, cfg.hd)
        return {"ck": torch.zeros(shape, dtype=dt, device=device),
                "cv": torch.zeros(shape, dtype=dt, device=device)}
    if kind == "ssm":
        return ssm_mod.init_ssm_cache(cfg, batch, dt, device=device,
                                      lead=lead)
    if kind == "rglru":
        return rg.init_rglru_cache(cfg, batch, dt, device=device, lead=lead)
    raise ValueError(kind)


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, *,
               n_frontend_tokens: int | None = None, device=None):
    """Decode cache: per pattern position, stacked over super-layers.
    attn: a KV ring buffer of seq_len slots; swa: of min(seq_len, window);
    cross: the encoder's keys and values (n_frontend_tokens of them,
    cfg.n_frontend_tokens when None); ssm: conv tail and state; rglru:
    conv tail and h."""
    dev = resolve_device(device)
    nimg = (n_frontend_tokens if n_frontend_tokens is not None
            else cfg.n_frontend_tokens)
    return {
        "stack": {f"l{i}": _init_layer_cache(cfg, kind, batch, seq_len,
                                             nimg, dev, (cfg.n_super,))
                  for i, kind in enumerate(cfg.pattern)},
        "rem": [_init_layer_cache(cfg, cfg.pattern[i], batch, seq_len, nimg,
                                  dev) for i in range(cfg.n_remainder)],
    }


def _apply_layer_decode(cfg, p, kind, x, cache, pos):
    h = apply_norm(cfg, p["norm1"], x)
    if kind in ("attn", "swa"):
        a, _ = att.attn_decode(cfg, p["attn"], h, cache, pos,
                               kind=("swa" if kind == "swa" else "causal"))
        x = x + a
    elif kind == "cross":
        a, _ = att.attn_decode(cfg, p["attn"], h, None, pos, kind="cross",
                               encoder_kv=(cache["ck"], cache["cv"]))
        x = x + a
    elif kind == "ssm":
        y, _ = ssm_mod.ssm_decode(cfg, p["ssm"], h, cache)
        return x + y
    elif kind == "rglru":
        y, _ = rg.rglru_decode(cfg, p["rec"], h, cache)
        x = x + y
    if "ffn" in p:
        x = _apply_ffn(cfg, p, kind, x)
    return x


def _require_decoder(cfg) -> None:
    if cfg.frontend == "audio" or not cfg.decoder:
        raise ValueError(f"{cfg.name} is encoder-only: it has no token "
                         f"embedding and no decode step")


def decode_step(params, cfg: ArchConfig, cache, token, pos, *, device=None,
                gather=None):
    """One new token against the cache. token (B,1) int; pos its position.
    Returns (logits (B,1,V) f32, cache); the cache is updated in place.
    `gather` is `forward`'s hook: the leaves outside the stack are
    gathered once, each super-layer's blocks just before it runs."""
    _require_decoder(cfg)
    params = _gather_top(params, gather)
    x = embed_tokens(params["embed"], _on(token, device))
    pos = int(pos)
    caches = _layers(cache, cfg)
    for n in range(cfg.n_super):
        sp = _layer(params["stack"], n)
        if gather is not None:
            sp = gather("stack", sp)
        for i, kind in enumerate(cfg.pattern):
            x = _apply_layer_decode(cfg, sp[f"l{i}"], kind, x,
                                    next(caches)[1], pos)
    for i, p in enumerate(params["rem"]):
        x = _apply_layer_decode(cfg, p, cfg.pattern[i], x, next(caches)[1],
                                pos)
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params, x), cache


# ------------------------------------------------------- prefill with cache
def _fill_kv(c, k, v, s: int):
    """The last min(s, slots) keys and values (after RoPE) into a ring
    buffer, each at slot position % slots."""
    length = c["k"].shape[1]
    keep = min(s, length)
    slots = torch.arange(s - keep, s, device=k.device) % length
    c["k"][:, slots] = k[:, s - keep:]
    c["v"][:, slots] = v[:, s - keep:]
    c["pos"][slots] = torch.arange(s - keep, s, dtype=torch.int32,
                                   device=k.device)


def _conv_tail(cfg, conv_in):
    """The conv's last K-1 inputs, zeros before the first token (the
    reference's slice, which would come out short for a prompt of fewer
    than K-1 tokens)."""
    k = cfg.ssm_conv - 1
    return torch.nn.functional.pad(conv_in, (0, 0, k, 0))[:, -k:]


def prefill_with_cache(params, cfg: ArchConfig, tokens, *, encoder=None,
                       cache_len: int | None = None, device=None):
    """Forward pass that also builds the decode cache. Returns (logits
    (B,S,V) f32, cache with room for cache_len positions). Self-attention
    layers run causal; cross layers attend to `encoder` (patch
    embeddings) and keep its keys and values; SSM and RG-LRU layers keep
    their final state and the conv's last K-1 inputs."""
    _require_decoder(cfg)
    tokens = _on(tokens, device)
    b, s = tokens.shape[0], tokens.shape[1]
    cache_len = cache_len or s
    x = embed_tokens(params["embed"], tokens)
    encoder = _encoder(cfg, encoder, device, x)
    cache = init_cache(cfg, b, cache_len,
                       n_frontend_tokens=(encoder.shape[1]
                                          if encoder is not None else 0),
                       device=tokens.device)
    positions = torch.arange(s, dtype=torch.float32, device=x.device)
    dt = dtype_of(cfg)
    for (kind, p), (_, c) in zip(_layers(params, cfg), _layers(cache, cfg)):
        h = apply_norm(cfg, p["norm1"], x)
        if kind in ("attn", "swa"):
            a, k, v = att._attn_forward_kv(
                cfg, p["attn"], h, positions,
                kind=("swa" if kind == "swa" else "causal"))
            _fill_kv(c, k, v, s)
            x = x + a
        elif kind == "cross":
            a, k, v = att._attn_forward_kv(cfg, p["attn"], h, positions,
                                           kind="cross", encoder=encoder)
            c["ck"].copy_(k)
            c["cv"].copy_(v)
            x = x + a
        elif kind == "ssm":
            y, state, conv_in = ssm_mod._ssm_forward(cfg, p["ssm"], h)
            c["conv"].copy_(_conv_tail(cfg, conv_in).to(dt))
            c["state"].copy_(state)
            x = x + y
            continue                    # SSM layers have no FFN
        elif kind == "rglru":
            y, state, conv_in = rg._rglru_forward(cfg, p["rec"], h)
            c["conv"].copy_(_conv_tail(cfg, conv_in).to(dt))
            c["h"].copy_(state)
            x = x + y
        if "ffn" in p:
            x = _apply_ffn(cfg, p, kind, x)
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params, x), cache
