"""RG-LRU recurrent block (port of `repro.models.rglru`; RecurrentGemma /
Griffin, arXiv:2402.19427).

Gated linear recurrence h_t = a_t ⊙ h_{t-1} + √(1−a_t²) ⊙ (i_t ⊙ x_t) with
a_t = exp(−c·softplus(Λ)·r_t). The sequence form runs the recurrence as
a log-depth (Hillis–Steele) doubling scan in plain PyTorch, with the
reference's combine ((a1, b1), (a2, b2)) → (a1·a2, a2·b1 + b2): ⌈log2 L⌉
elementwise steps (12 at L = 3,072) where a loop over positions would
launch per token. `scan_sequential` is the step-by-step oracle the tests
hold it to. Decode is the O(1) per-token recurrence. The gelu is the
tanh form (`jax.nn.gelu`'s default).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.modules import (_normal, apply_linear, dtype_of,
                                        init_linear)

_C = 8.0


def _width(cfg):
    return cfg.rglru_width or cfg.d_model


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def init_rglru(gen, cfg, *, lead: tuple = ()):
    d, rw = cfg.d_model, _width(cfg)
    dt, dev, lead = dtype_of(cfg), gen.device, tuple(lead)
    return {
        "in_x": init_linear(gen, cfg, d, rw, lead=lead),
        "in_gate": init_linear(gen, cfg, d, rw, lead=lead),
        "conv_w": _normal(gen, (cfg.ssm_conv, rw), 0.1, dt, lead),
        "conv_b": torch.zeros(lead + (rw,), dtype=dt, device=dev),
        "w_a": init_linear(gen, cfg, rw, rw, lead=lead),   # recurrence gate
        "w_i": init_linear(gen, cfg, rw, rw, lead=lead),   # input gate
        "lam": torch.full(lead + (rw,), 3.0, dtype=torch.float32,
                          device=dev),                     # Λ
        "out": init_linear(gen, cfg, rw, d, lead=lead),
    }


def _gates(p, xb):
    r = torch.sigmoid(apply_linear(p["w_a"], xb).float())
    i = torch.sigmoid(apply_linear(p["w_i"], xb).float())
    log_a = -_C * F.softplus(p["lam"]) * r                 # log a_t ≤ 0
    a = torch.exp(log_a)
    gated_x = i * xb.float()
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated_x
    return a, b


def _conv1d(w, b, x, *, state=None):
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
        return (sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k)) + b,
                None)
    buf = torch.cat([state, x], dim=1)
    return torch.einsum("bkc,kc->bc", buf, w)[:, None] + b, buf[:, 1:]


def scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t from h_{-1} = 0 along dim 1, as a doubling
    scan: after the step of offset d, position t holds the combination of
    positions t-2d+1 … t."""
    n = a.shape[1]
    d = 1
    while d < n:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def scan_sequential(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same recurrence one position at a time (the tests' oracle)."""
    h = torch.zeros_like(b[:, 0])
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def _rglru_forward(cfg, p, x):
    """`rglru_forward` with the final state, also returning the conv's
    input (B, L, RW) before the convolution: its last K-1 rows are the
    decode cache's conv tail."""
    xb_in = apply_linear(p["in_x"], x)
    gate = _gelu(apply_linear(p["in_gate"], x))
    xb, _ = _conv1d(p["conv_w"], p["conv_b"], xb_in)
    a, b = _gates(p, xb)                                   # (B,L,RW) f32
    h = scan(a, b)
    out = apply_linear(p["out"], h.to(x.dtype) * gate)
    return out, h[:, -1], xb_in


def rglru_forward(cfg, p, x, *, return_state: bool = False):
    """x (B,L,D) → (B,L,D) (and the final state (B, RW) float32 with
    return_state)."""
    out, state, _ = _rglru_forward(cfg, p, x)
    return (out, state) if return_state else out


def init_rglru_cache(cfg, batch: int, dtype, *, device=None,
                     lead: tuple = ()):
    rw, lead = _width(cfg), tuple(lead)
    return {
        "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, rw),
                            dtype=dtype, device=device),
        "h": torch.zeros(lead + (batch, rw), dtype=torch.float32,
                         device=device),
    }


def rglru_decode(cfg, p, x, cache):
    """x (B,1,D) → (y, cache) single step; the cache's conv tail and state
    are updated in place (the reference returns a new cache)."""
    xb = apply_linear(p["in_x"], x)
    gate = _gelu(apply_linear(p["in_gate"], x))
    xb, conv_state = _conv1d(p["conv_w"], p["conv_b"], xb,
                             state=cache["conv"])
    a, b = _gates(p, xb)                                   # (B,1,RW)
    h = a[:, 0] * cache["h"] + b[:, 0]
    y = h[:, None].to(x.dtype) * gate
    cache["conv"].copy_(conv_state)
    cache["h"].copy_(h)
    return apply_linear(p["out"], y), cache
