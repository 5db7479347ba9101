"""Mamba-2: the state-space duality (SSD) layer (port of `repro.models.ssm`,
arXiv:2405.21060).

The chunked dual form for prefill (quadratic inside ssm_chunk-sized
chunks, a linear recurrence across chunks) and the O(1)-state recurrent
form for decode. Plain PyTorch, as the reference is plain `jnp`: no
kernel runs here.

The reference's multi-operand einsums are written here as chains of
two-operand products and broadcasts, which bounds the intermediates and
contracts in another order: at float32 the results agree to rounding
(the tests hold them to 1e-4).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.modules import (_normal, apply_linear, dtype_of,
                                        init_linear)


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    return d_in, nheads, cfg.ssm_head_dim, cfg.ssm_state


def init_ssm(gen, cfg, *, lead: tuple = ()):
    d, (d_in, h, _, n) = cfg.d_model, _dims(cfg)
    conv_dim = d_in + 2 * n                      # conv over (x, B, C)
    dt, dev, lead = dtype_of(cfg), gen.device, tuple(lead)

    def const(values: torch.Tensor, dtype):
        return values.to(dtype).expand(lead + values.shape).clone()

    return {
        # in_proj → [z, x, B, C, dt]
        "in_proj": init_linear(gen, cfg, d, 2 * d_in + 2 * n + h,
                               lead=lead),
        "conv_w": _normal(gen, (cfg.ssm_conv, conv_dim), 0.1, dt, lead),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dt, device=dev),
        "a_log": const(torch.log(torch.linspace(1.0, 16.0, h,
                                                device=dev)), torch.float32),
        "dt_bias": torch.zeros(lead + (h,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones(lead + (h,), dtype=torch.float32, device=dev),
        "out_proj": init_linear(gen, cfg, d_in, d, lead=lead),
        "norm_scale": torch.ones(lead + (d_in,), dtype=dt, device=dev),
    }


def _segsum(x):
    """(… T) → (… T T) masked segment sums: entry (i, j) is
    x[j+1] + … + x[i] for j ≤ i, -inf above the diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, -math.inf)


def _ssd_chunked(x, a_dt, b_mat, c_mat, chunk: int):
    """SSD dual form.

    x    (B, L, H, P)   inputs per head
    a_dt (B, L, H)      log decay per step (dt * A, negative)
    b/c  (B, L, N)      shared across heads (ngroups = 1)
    returns y (B, L, H, P), final_state (B, H, P, N)
    """
    bsz, l_orig, h, p = x.shape
    n = b_mat.shape[-1]
    if l_orig % chunk:
        # pad with identity steps: x = 0 adds nothing, a_dt = 0 → decay 1
        # keeps the state, so y[:l] and final_state are exact
        padlen = chunk - l_orig % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, padlen))
        a_dt = F.pad(a_dt, (0, 0, 0, padlen))
        b_mat = F.pad(b_mat, (0, 0, 0, padlen))
        c_mat = F.pad(c_mat, (0, 0, 0, padlen))
    l = x.shape[1]
    c = l // chunk
    xc = x.reshape(bsz, c, chunk, h, p)
    ac = a_dt.reshape(bsz, c, chunk, h).permute(0, 3, 1, 2)   # (B,H,C,L)
    bc = b_mat.reshape(bsz, c, chunk, n)
    cc = c_mat.reshape(bsz, c, chunk, n)

    a_cum = torch.cumsum(ac, dim=-1)
    # 1. intra-chunk (quadratic, "attention-like")
    l_mat = torch.exp(_segsum(ac))                              # (B,H,C,L,L)
    cb = torch.einsum("bcln,bcsn->bcls", cc, bc)                # (B,C,L,L)
    w = cb[:, None] * l_mat                                     # (B,H,C,L,L)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", w, xc)
    # 2. chunk states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)           # (B,H,C,L)
    xd = xc * decay_states.permute(0, 2, 3, 1)[..., None]       # (B,C,L,H,P)
    states = torch.einsum("bcsn,bcshp->bchpn", bc, xd)
    # 3. inter-chunk recurrence
    a_chunk = a_cum[..., -1]                                    # (B,H,C)
    decay_chunk = torch.exp(_segsum(F.pad(a_chunk, (1, 0))))    # (B,H,C+1,C+1)
    states0 = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states0)
    prev_states = new_states[:, :-1]                  # state entering chunk
    final_state = new_states[:, -1]
    # 4. state → output contribution
    state_decay = torch.exp(a_cum)                              # (B,H,C,L)
    y_off = torch.einsum("bcln,bchpn->bclhp", cc, prev_states) \
        * state_decay.permute(0, 2, 3, 1)[..., None]
    y = (y_diag + y_off).reshape(bsz, l, h, p)[:, :l_orig]
    return y, final_state


def _conv1d(w, b, x, *, state=None):
    """Causal depthwise conv over time. x (B,L,C); w (K,C). With `state`
    (B,K-1,C) performs the single-step decode update and returns the new
    state."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
        out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
        return out + b, None
    buf = torch.cat([state, x], dim=1)                         # (B,K,C)
    out = torch.einsum("bkc,kc->bc", buf, w)[:, None] + b
    return out, buf[:, 1:]


def _split(cfg, zxbcdt):
    d_in, h, _, n = _dims(cfg)
    return torch.split(zxbcdt, [d_in, d_in, n, n, h], dim=-1)


def _gated_norm(p, y, z, dtype):
    """y · silu(z), then the grouped RMSNorm in float32."""
    y = y.to(dtype) * F.silu(z)
    yf = y.float()
    return (yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-6)
            * p["norm_scale"].float()).to(dtype)


def _ssm_forward(cfg, p, x):
    """`ssm_forward`, also returning the conv's input (B, L, conv_dim)
    before the convolution: its last K-1 rows are the decode cache's
    conv tail."""
    d_in, h, hp, n = _dims(cfg)
    bsz, l, _ = x.shape
    z, xin, b_mat, c_mat, dt = _split(cfg, apply_linear(p["in_proj"], x))
    conv_in = torch.cat([xin, b_mat, c_mat], dim=-1)
    conv_out, _ = _conv1d(p["conv_w"], p["conv_b"], conv_in)
    conv_out = F.silu(conv_out)
    xin, b_mat, c_mat = torch.split(conv_out, [d_in, n, n], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])                 # (B,L,H)
    a = -torch.exp(p["a_log"])                                 # (H,)
    a_dt = dt * a
    xh = xin.reshape(bsz, l, h, hp).float()
    y, state = _ssd_chunked(xh * dt[..., None], a_dt, b_mat.float(),
                            c_mat.float(), cfg.ssm_chunk)
    y = y + xh * p["d_skip"][None, None, :, None]
    y = _gated_norm(p, y.reshape(bsz, l, d_in), z, x.dtype)
    return apply_linear(p["out_proj"], y), state, conv_in


def ssm_forward(cfg, p, x, *, return_state: bool = False):
    """Full-sequence SSD. x (B,L,D) → y (B,L,D) (and the final state
    (B, H, P, N) float32 with return_state)."""
    out, state, _ = _ssm_forward(cfg, p, x)
    return (out, state) if return_state else out


def init_ssm_cache(cfg, batch: int, dtype, *, device=None,
                   lead: tuple = ()):
    d_in, h, hp, n = _dims(cfg)
    lead = tuple(lead)
    return {
        "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, d_in + 2 * n),
                            dtype=dtype, device=device),
        "state": torch.zeros(lead + (batch, h, hp, n), dtype=torch.float32,
                             device=device),
    }


def ssm_decode(cfg, p, x, cache):
    """Single-step recurrence. x (B,1,D) → (y (B,1,D), cache); the cache's
    conv tail and state are updated in place (the reference returns a
    new cache)."""
    d_in, h, hp, n = _dims(cfg)
    bsz = x.shape[0]
    z, xin, b_mat, c_mat, dt = _split(cfg, apply_linear(p["in_proj"], x))
    conv_in = torch.cat([xin, b_mat, c_mat], dim=-1)
    conv_out, conv_state = _conv1d(p["conv_w"], p["conv_b"], conv_in,
                                   state=cache["conv"])
    conv_out = F.silu(conv_out)
    xin, b_mat, c_mat = torch.split(conv_out, [d_in, n, n], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]           # (B,H)
    a = -torch.exp(p["a_log"])
    da = torch.exp(dt * a)                                     # (B,H)
    xh = xin.reshape(bsz, h, hp).float()
    bv = b_mat[:, 0].float()                                   # (B,N)
    cv = c_mat[:, 0].float()
    state = cache["state"] * da[..., None, None] \
        + (dt[..., None] * xh)[..., None] * bv[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", state, cv) \
        + xh * p["d_skip"][None, :, None]
    y = _gated_norm(p, y.reshape(bsz, 1, d_in), z, x.dtype)
    cache["conv"].copy_(conv_state)
    cache["state"].copy_(state)
    return apply_linear(p["out_proj"], y), cache
