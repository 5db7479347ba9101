"""Plain PyTorch version of flash attention and of its backward: softmax
attention with the scores, weights and products in float32 (port of
`repro.kernels.flashattn_ref`; float64 inputs stay float64, which gives
the exact gradient that the card's kernels are held to).

q (…, Sq, d), k/v (…, Sk, d) → (…, Sq, d) in q's dtype. Leading dims
broadcast as in a matmul, and a 4-d q (B, H, Sq, d) may take k/v
(B, Hkv, Sk, d) with H % Hkv == 0: query head h reads key/value head
h // (H / Hkv) (grouped-query attention), as the kernel does. Causal
masks by absolute position, with q_offset the global position of q's
first row.

The weights stay float32 into the PV product, as in the TPU kernel
(`repro/kernels/flashattn.py`) and the CUDA kernel's float32 path; its
bf16 path feeds them as a bf16 pair (P_hi + P_lo, 16 bits), and the
reference model's `_attend` rounds them to v's dtype first.

`attention_ref_lse` also returns each row's log-sum-exp of the scaled
scores, (…, Sq) float32: P = exp(scale·s − LSE). The backward
`flash_attention_bwd_ref` recomputes P from q, k and that LSE, takes
D = rowsum(dO∘O) and returns (dq, dk, dv), the gradients of
`attention_ref` (JAX's autodiff of it is the reference: the TPU package
has no backward kernel).
"""
from __future__ import annotations

import math

import torch


def _work_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _grouped(q: torch.Tensor, k: torch.Tensor) -> bool:
    grouped = q.dim() == 4 and k.shape[1] != q.shape[1]
    if grouped and q.shape[1] % k.shape[1]:
        raise ValueError(f"attention_ref: {q.shape[1]} query heads are not "
                         f"a multiple of {k.shape[1]} key/value heads")
    return grouped


def _causal_keep(sq: int, sk: int, q_offset: int, device) -> torch.Tensor:
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    ki = torch.arange(sk, device=device)[None, :]
    return qi >= ki


def attention_ref_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_offset: int = 0,
                      sm_scale: float | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out in q's dtype, LSE (…, Sq) float32, float64 for float64 q)."""
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    wt = _work_dtype(q)
    qf, kf, vf = q.to(wt), k.to(wt), v.to(wt)
    grouped = _grouped(q, k)
    if grouped:
        b, h, sq, _ = q.shape
        hkv = k.shape[1]
        qf = qf.reshape(b, hkv, h // hkv, sq, d)
        kf, vf = kf[:, :, None], vf[:, :, None]
    s = (qf @ kf.transpose(-1, -2)) * scale
    if causal:
        keep = _causal_keep(q.shape[-2], k.shape[-2], q_offset, q.device)
        s = s.masked_fill(~keep, float("-inf"))
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - mx)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / denom
    out = p @ vf
    lse = (mx + torch.log(denom))[..., 0]
    if grouped:
        out = out.reshape(q.shape)
        lse = lse.reshape(q.shape[:-1])
    return out.to(q.dtype), lse


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_offset: int = 0,
                  sm_scale: float | None = None) -> torch.Tensor:
    return attention_ref_lse(q, k, v, causal=causal, q_offset=q_offset,
                             sm_scale=sm_scale)[0]


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True,
                            sm_scale: float | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Gradients (dq, dk, dv) of softmax attention, each in its input's
    dtype: q, o, do (B, H, Sq, d), k, v (B, Hkv, Sk, d), lse (B, H, Sq).
    With s the scaled scores, P = exp(s − LSE), dV = Pᵀ dO,
    dP = dO Vᵀ, dS = P∘(dP − D) with D = rowsum(dO∘O), dQ = scale·dS K,
    dK = scale·dSᵀ Q. A KV head's dK and dV sum its G query heads in
    order g = 0, 1, …"""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"flash_attention_bwd_ref: {h} query heads are "
                         f"not a multiple of {hkv} key/value heads")
    g = h // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    wt = _work_dtype(q)

    def grouped(t):              # (B, H, Sq, …) → (B, Hkv, G, Sq, …)
        return t.to(wt).reshape(b, hkv, g, *t.shape[2:])

    qf, of, dof = grouped(q), grouped(o), grouped(do)
    kf, vf = k.to(wt)[:, :, None], v.to(wt)[:, :, None]
    s = (qf @ kf.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(sq, sk, 0, q.device), float("-inf"))
    p = torch.exp(s - grouped(lse)[..., None])
    dp = dof @ vf.transpose(-1, -2)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = (ds @ kf) * scale
    dk_g = (ds.transpose(-1, -2) @ qf) * scale        # (B, Hkv, G, Sk, d)
    dv_g = p.transpose(-1, -2) @ dof
    dk, dv = dk_g[:, :, 0], dv_g[:, :, 0]
    for i in range(1, g):
        dk = dk + dk_g[:, :, i]
        dv = dv + dv_g[:, :, i]
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
