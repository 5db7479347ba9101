"""Elementary model components (port of `repro.models.modules`): plain
functions on tensors, parameters as nested dicts in the reference's
layout.

Initializers draw from an explicit `torch.Generator` and make their
tensors on the generator's device. `lead` is a leading shape for
parameters stacked over layers (`params["stack"]` keeps the reference's
leading `n_super` axis); each slice is drawn in float32 and cast on its
own, so a stacked bf16 leaf never exists in float32 as a whole.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


class ShapeOnly:
    """Stands in for the generator on the meta device: `init_model(...,
    device="meta")` gives every leaf its shape and type and no values
    (a full-size model's sharding specs need no weights)."""
    device = torch.device("meta")


def _normal(gen: torch.Generator, shape: tuple, std: float, dtype,
            lead: tuple = ()) -> torch.Tensor:
    """N(0, std²) of shape lead + shape in `dtype`, drawn in float32 one
    matrix at a time: slice by slice over `lead` and over every dim of
    `shape` but the last two (a layer's experts, (E, D, F), are drawn
    expert by expert)."""
    out = torch.empty(tuple(lead) + tuple(shape), dtype=dtype,
                      device=gen.device)
    if out.is_meta:
        return out
    tile = tuple(shape[-2:])
    flat = out.view(-1, *tile)
    for i in range(flat.shape[0]):
        flat[i].copy_(torch.randn(tile, generator=gen, device=gen.device,
                                  dtype=torch.float32) * std)
    return out


# ----------------------------------------------------------------- norms
def init_norm(cfg, d: int, *, device=None, lead: tuple = ()):
    p = {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype_of(cfg),
                             device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(tuple(lead) + (d,), dtype=dtype_of(cfg),
                                device=device)
    return p


def apply_norm(cfg, p, x):
    """RMSNorm (or LayerNorm) in float32 with eps 1e-6, cast back to x's
    dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6) * p["scale"].float()
    return y.to(x.dtype)


# ----------------------------------------------------------------- linear
def init_linear(gen, cfg, d_in: int, d_out: int, *, bias: bool = False,
                lead: tuple = ()):
    """W ~ N(0, 1/d_in), drawn in float32 and cast to the param dtype."""
    p = {"w": _normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in),
                      dtype_of(cfg), lead)}
    if bias:
        p["b"] = torch.zeros(tuple(lead) + (d_out,), dtype=dtype_of(cfg),
                             device=gen.device)
    return p


def apply_linear(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def act_fn(cfg):
    """silu, or gelu in its tanh form (`jax.nn.gelu`'s default)."""
    if cfg.act == "silu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")


# ----------------------------------------------------------------- mlp
def init_mlp(gen, cfg, d: int, d_ff: int, *, lead: tuple = ()):
    p = {"up": init_linear(gen, cfg, d, d_ff, lead=lead),
         "down": init_linear(gen, cfg, d_ff, d, lead=lead)}
    if cfg.glu:
        p["gate"] = init_linear(gen, cfg, d, d_ff, lead=lead)
    return p


def apply_mlp(cfg, p, x):
    h = apply_linear(p["up"], x)
    if cfg.glu:
        h = act_fn(cfg)(apply_linear(p["gate"], x)) * h
    else:
        h = act_fn(cfg)(h)
    return apply_linear(p["down"], h)


# ----------------------------------------------------------------- rope
@functools.lru_cache(maxsize=None)
def _inv_freq(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    """RoPE inverse frequencies, computed in float64 and rounded to float32
    as the reference's numpy constant is. Kept per device: a copy from the
    host at every layer would synchronize the stream each time."""
    inv = 1.0 / (theta ** (np.arange(0, hd, 2) / hd))
    return torch.tensor(inv, dtype=torch.float32, device=device)


def rope_freqs(cfg, positions: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (…,) → (…, hd/2) cos/sin in float32 (split-half RoPE)."""
    inv = _inv_freq(cfg.hd, cfg.rope_theta, positions.device)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, …, hd); cos/sin: (S, hd/2) or (B, S, hd/2). Head dims
    between S and hd broadcast. Computed in float32, cast back to x's
    dtype."""
    x1, x2 = x.chunk(2, dim=-1)
    mid = (1,) * (x1.dim() - 3)
    if cos.dim() == 2:                       # (S, hd/2)
        shape = (1, cos.shape[0]) + mid + (cos.shape[-1],)
    else:                                    # (B, S, hd/2)
        shape = tuple(cos.shape[:2]) + mid + (cos.shape[-1],)
    cos, sin = cos.reshape(shape), sin.reshape(shape)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ----------------------------------------------------------------- embeds
def init_embedding(gen, cfg):
    return {"tok": _normal(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                           dtype_of(cfg))}


def embed_tokens(p, tokens):
    return p["tok"][tokens.long()]


def lm_logits(cfg, params, x):
    """Logits in float32 (the product in x's dtype, then cast)."""
    if cfg.tie_embeddings:
        w = params["embed"]["tok"].T
    else:
        w = params["lm_head"]["w"]
    return (x @ w).float()


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean CE over (B, S) targets; logits (B, S, V) f32."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
