"""Attention (port of `repro.models.attention`): GQA self-attention through
the hand-written flash kernel, plain sliding-window and cross attention,
and ring-buffer KV caches for decode.

Routing in `attn_forward`:
- causal and "none" self-attention call `kernels.ops.flash_attention`: a
  CUDA tensor launches the kernel, a CPU tensor takes its plain version.
  Query head h reads KV head h // G inside the kernel; K and V are never
  repeated in memory, and the (B, S, K, G, hd) projections go in as
  strided views. The kernel never builds the score matrix, so these
  kinds need no query chunks.
- sliding-window and cross attention stay plain PyTorch in `_attend`, as
  in the reference, which runs no kernel there either. `_attend` builds
  (B, K, G, Sq, Sk) float32 scores, so above `Q_CHUNK` query rows it
  runs over chunks of Q_CHUNK rows in a Python loop (the reference's
  `lax.scan`); rows are independent, so the result equals the unchunked
  form. As in the reference, a length above Q_CHUNK must be a multiple
  of it.
- `attn_decode` (one query token against the ring-buffer cache, or
  against the encoder's keys and values for "cross") is plain PyTorch.

Numerics: `_attend` rounds the softmax weights to v's dtype before the PV
product, as the reference does; the flash path keeps them float32, as the
TPU kernel does. A float32 model therefore matches the reference to
rounding order, and a bf16 model differs by one bf16 rounding of the
weights.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models.modules import (apply_linear, apply_rope,
                                        init_linear, rope_freqs)

NEG_INF = -1e30
Q_CHUNK = 1024          # plain attention runs in query chunks above this


def init_attn(gen, cfg, *, cross: bool = False, lead: tuple = ()):
    """The four projections; a cross-attention layer has the same leaves
    (its keys and values project the encoder's states)."""
    del cross
    hd = cfg.hd
    return {
        "wq": init_linear(gen, cfg, cfg.d_model, cfg.n_heads * hd,
                          bias=cfg.qkv_bias, lead=lead),
        "wk": init_linear(gen, cfg, cfg.d_model, cfg.n_kv_heads * hd,
                          bias=cfg.qkv_bias, lead=lead),
        "wv": init_linear(gen, cfg, cfg.d_model, cfg.n_kv_heads * hd,
                          bias=cfg.qkv_bias, lead=lead),
        "wo": init_linear(gen, cfg, cfg.n_heads * hd, cfg.d_model,
                          lead=lead),
    }


def _split_heads(cfg, q, k, v):
    b, sq = q.shape[:2]
    sk = k.shape[1]
    hd, kh = cfg.hd, cfg.n_kv_heads
    g = cfg.n_heads // kh
    return (q.reshape(b, sq, kh, g, hd), k.reshape(b, sk, kh, hd),
            v.reshape(b, sk, kh, hd))


def _attend(q, k, v, mask):
    """q (B,Sq,K,G,hd), k/v (B,Sk,K,hd), mask (Sq,Sk) or (B,1,1,Sq,Sk).
    Scores in float32 from the inputs' exact products; weights rounded to
    v's dtype before the PV product."""
    hd = q.shape[-1]
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.float(),
                          k.float()) / math.sqrt(hd)
    if mask is not None:
        scores = scores + mask
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", w, v)


def _mask(kind: str, sq: int, sk: int, *, q_offset: int = 0,
          window: int = 0, device=None) -> torch.Tensor | None:
    if kind == "none":
        return None
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    ki = torch.arange(sk, device=device)[None, :]
    m = qi >= ki
    if kind == "swa":
        m = m & (qi - ki < window)
    return torch.where(m, 0.0, NEG_INF).to(torch.float32)


def _attn_forward_kv(cfg, p, x, positions, *, kind: str = "causal",
                     encoder: torch.Tensor | None = None):
    """`attn_forward`, also returning the keys (after RoPE) and values it
    attended to, (B, Sk, K, hd) each: prefill stores them in the cache
    instead of projecting them a second time."""
    b, s, _ = x.shape
    src = encoder if kind == "cross" else x
    q = apply_linear(p["wq"], x)
    k = apply_linear(p["wk"], src)
    v = apply_linear(p["wv"], src)
    q, k, v = _split_heads(cfg, q, k, v)
    if kind != "cross":
        cos, sin = rope_freqs(cfg, positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if kind in ("causal", "none"):
        # (B, S, H, hd) → (B, H, S, hd) views; the output comes back laid
        # out as (B, S, H, hd), so the reshape below is free on the card
        out = ops.flash_attention(
            q.reshape(b, s, cfg.n_heads, cfg.hd).transpose(1, 2),
            k.transpose(1, 2), v.transpose(1, 2),
            causal=(kind == "causal")).transpose(1, 2)
    elif kind in ("swa", "cross"):
        out = _attend_chunked(cfg, q, k, v, "swa" if kind == "swa"
                              else "none")
    else:
        raise ValueError(f"unknown attention kind {kind!r}")
    out = out.reshape(b, s, cfg.n_heads * cfg.hd)
    return apply_linear(p["wo"], out), k, v


def _attend_chunked(cfg, q, k, v, mkind: str) -> torch.Tensor:
    """`_attend` over the whole sequence, in chunks of Q_CHUNK query rows
    above Q_CHUNK (each chunk's mask offset by its first row)."""
    s, sk = q.shape[1], k.shape[1]
    if s <= Q_CHUNK:
        return _attend(q, k, v, _mask(mkind, s, sk, window=cfg.window,
                                      device=q.device))
    if s % Q_CHUNK:
        raise ValueError(f"plain attention over {s} query rows: above "
                         f"Q_CHUNK = {Q_CHUNK} the length must be a "
                         f"multiple of it")
    return torch.cat([
        _attend(q[:, i:i + Q_CHUNK], k, v,
                _mask(mkind, Q_CHUNK, sk, q_offset=i, window=cfg.window,
                      device=q.device))
        for i in range(0, s, Q_CHUNK)], dim=1)


def attn_forward(cfg, p, x, positions, *, kind: str = "causal",
                 encoder: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence attention (train / prefill). kind: causal|swa|cross|none."""
    return _attn_forward_kv(cfg, p, x, positions, kind=kind,
                            encoder=encoder)[0]


# ---------------------------------------------------------------- decode
def init_kv_cache(cfg, batch: int, length: int, dtype, *, device=None,
                  lead: tuple = ()) -> dict:
    """Ring-buffer KV cache, with an optional leading (stacked-layer)
    shape. For SWA/local archs `length` is min(S, window)."""
    kh, hd = cfg.n_kv_heads, cfg.hd
    lead = tuple(lead)
    return {
        "k": torch.zeros(lead + (batch, length, kh, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros(lead + (batch, length, kh, hd), dtype=dtype,
                         device=device),
        "pos": torch.full(lead + (length,), -1, dtype=torch.int32,
                          device=device),   # absolute position per slot
    }


def attn_decode(cfg, p, x, cache, pos: int, *, kind: str = "causal",
                encoder_kv: tuple | None = None):
    """One-token decode. x (B,1,D); pos the token's position (an int).
    kind causal or swa: writes the new key and value into the ring-buffer
    `cache` in place (the reference returns an updated copy); kind cross:
    attends to `encoder_kv`, the (k, v) of `precompute_cross_kv`, and
    leaves `cache` as it is. Returns (out, cache)."""
    b = x.shape[0]
    q = apply_linear(p["wq"], x)
    if kind == "cross":
        k, v = encoder_kv
        q = q.reshape(b, 1, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                      cfg.hd)
        out = _attend(q, k, v, None)
        return apply_linear(p["wo"], out.reshape(b, 1, -1)), cache
    pos = int(pos)
    kn = apply_linear(p["wk"], x)
    vn = apply_linear(p["wv"], x)
    q, kn, vn = _split_heads(cfg, q, kn, vn)
    cos, sin = rope_freqs(cfg, torch.full((1,), float(pos),
                                          dtype=torch.float32,
                                          device=x.device))
    q = apply_rope(q, cos, sin)
    kn = apply_rope(kn, cos, sin)
    slot = pos % cache["k"].shape[1]           # ring buffer
    cache["k"][:, slot] = kn[:, 0]
    cache["v"][:, slot] = vn[:, 0]
    cache["pos"][slot] = pos
    valid = (cache["pos"] >= 0) & (cache["pos"] <= pos)
    if kind == "swa":
        valid &= cache["pos"] > pos - cfg.window
    mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    out = _attend(q, cache["k"], cache["v"], mask[None, None, None, None, :])
    out = out.reshape(b, 1, cfg.n_heads * cfg.hd)
    return apply_linear(p["wo"], out), cache


def precompute_cross_kv(cfg, p, encoder: torch.Tensor):
    """The encoder's keys and values for cross-attention decode, (B, Sk,
    K, hd) each (no RoPE)."""
    k = apply_linear(p["wk"], encoder)
    v = apply_linear(p["wv"], encoder)
    b, sk = k.shape[:2]
    return (k.reshape(b, sk, cfg.n_kv_heads, cfg.hd),
            v.reshape(b, sk, cfg.n_kv_heads, cfg.hd))
