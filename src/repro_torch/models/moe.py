"""Mixture-of-Experts FFN (port of `repro.models.moe`): top-k routing with
capacity-based dispatch, GShard/Switch style, as one-hot dispatch and
combine einsums (the reference's semantics; a gather-based dispatch is
speed work for ROADMAP.md queue 2).

Covers grok-1 (8 experts, top-2) and arctic (128 experts, top-2, with a
dense residual MLP). Plain PyTorch: the reference runs no kernel here.

Two rules keep the routing equal to the reference's:
- the top k experts are taken by a stable descending sort, so that of two
  tied router probabilities the lower expert index comes first, as
  `jax.lax.top_k` puts it (`torch.topk` promises no order on ties);
- a routing's place in its expert's queue is an integer cumsum over the
  routings in token-major (s, k) order, and those at or past the
  capacity are dropped: their one-hot row over the capacity slots is
  zero (`F.one_hot` over cap + 1 classes with the last one cut, where
  `jax.nn.one_hot(cap, cap)` gives the zero row).

`ROUTING_LOG`: set it to a list and every grouped dispatch appends a
dict of device tensors (no host sync): "dropped", the number of routings
over capacity (0-d); "experts", the chosen experts (g, s, k); "margin",
each token's router-logit gap between its k-th and (k+1)-th expert
(g, s; +inf with k = E), which says how near a token was to another
choice. None (the default) records nothing.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.modules import (_normal, act_fn, apply_linear,
                                        apply_mlp, dtype_of, init_linear,
                                        init_mlp)

ROUTING_LOG: list | None = None


def init_moe(gen, cfg, *, lead: tuple = ()):
    e = cfg.n_experts
    dff = cfg.moe_d_ff or cfg.d_ff
    d = cfg.d_model
    dt = dtype_of(cfg)
    p = {
        "router": init_linear(gen, cfg, d, e, lead=lead),
        "up": _normal(gen, (e, d, dff), 1.0 / math.sqrt(d), dt, lead),
        "down": _normal(gen, (e, dff, d), 1.0 / math.sqrt(dff), dt, lead),
    }
    if cfg.glu:
        p["gate"] = _normal(gen, (e, d, dff), 1.0 / math.sqrt(d), dt, lead)
    if cfg.dense_residual:
        p["dense"] = init_mlp(gen, cfg, d, cfg.d_ff, lead=lead)
    return p


def capacity(cfg, tokens_per_group: int) -> int:
    cap = int(math.ceil(tokens_per_group * cfg.top_k / cfg.n_experts
                        * cfg.capacity_factor))
    return max(cap, 1)


def moe_forward(cfg, p, x):
    """x (B,S,D) → (B,S,D), dispatched within groups of one batch row
    each; with cfg.moe_decode_regroup and S == 1 (decode) the whole batch
    is one group, so an expert's GEMM sees ≈ B·top_k/E tokens instead of
    one token per row."""
    if cfg.moe_decode_regroup and x.shape[1] == 1:
        b0 = x.shape[0]
        out = moe_forward_grouped(cfg, p, x.reshape(1, b0, x.shape[2]))
        return out.reshape(b0, 1, x.shape[2])
    return moe_forward_grouped(cfg, p, x)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest values along the last dim and their indices, ties to
    the lower index (`jax.lax.top_k`'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _log_routing(cfg, logits, gate_idx, keep) -> None:
    ranked = torch.sort(logits, dim=-1, descending=True).values
    k = cfg.top_k
    margin = (ranked[..., k - 1] - ranked[..., k] if k < cfg.n_experts
              else torch.full_like(ranked[..., 0], math.inf))
    ROUTING_LOG.append({"dropped": (~keep).sum(), "experts": gate_idx,
                        "margin": margin})


def moe_forward_grouped(cfg, p, x):
    g, s, d = x.shape
    e = cfg.n_experts
    cap = capacity(cfg, s)

    logits = apply_linear(p["router"], x).float()                # (g,s,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, cfg.top_k)                # (g,s,k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # position of each (token, k) routing within its per-group expert queue
    onehot = F.one_hot(gate_idx, e).int()                        # (g,s,k,E)
    flatoh = onehot.reshape(g, s * cfg.top_k, e)
    pos_in_e = torch.cumsum(flatoh, dim=1) * flatoh - 1
    pos = pos_in_e.reshape(g, s, cfg.top_k, e).amax(dim=-1)      # (g,s,k)
    keep = pos < cap
    if ROUTING_LOG is not None:
        _log_routing(cfg, logits, gate_idx, keep)

    # over-capacity routings get pos = cap: class cap is cut off below
    oh_e = onehot.to(x.dtype)                                    # (g,s,k,E)
    oh_c = F.one_hot(torch.where(keep, pos, cap).long(),
                     cap + 1)[..., :cap].to(x.dtype)             # (g,s,k,cap)
    dispatch = torch.einsum("gske,gskc->gsec", oh_e, oh_c)       # (g,s,E,cap)
    gv_e = torch.einsum("gsk,gske->gse", gate_vals * keep,
                        onehot.float()).to(x.dtype)
    combine = dispatch * gv_e[..., None]

    xin = torch.einsum("gsec,gsd->gecd", dispatch, x)            # (g,E,cap,D)
    h = torch.einsum("gecd,edf->gecf", xin, p["up"])
    if cfg.glu:
        h = act_fn(cfg)(torch.einsum("gecd,edf->gecf", xin, p["gate"])) * h
    else:
        h = act_fn(cfg)(h)
    out_e = torch.einsum("gecf,efd->gecd", h, p["down"])         # (g,E,cap,D)
    out = torch.einsum("gsec,gecd->gsd", combine, out_e)

    if cfg.dense_residual:
        out = out + apply_mlp(cfg, p["dense"], x)
    return out


def aux_load_balance_loss(cfg, logits: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance auxiliary (fraction·probability), means
    over the leading axis as in the reference."""
    probs = torch.softmax(logits.float(), dim=-1)
    top1 = probs.argmax(dim=-1)
    frac = F.one_hot(top1, cfg.n_experts).float().mean(dim=0)
    imp = probs.mean(dim=0)
    return cfg.n_experts * (frac * imp).sum()
