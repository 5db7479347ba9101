"""Plain PyTorch version of flash attention: softmax attention with the
scores, weights and products in float32 (port of
`repro.kernels.flashattn_ref`).

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
"""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_offset: int = 0,
                  sm_scale: float | None = None) -> torch.Tensor:
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    grouped = q.dim() == 4 and k.shape[1] != q.shape[1]
    if grouped:
        b, h, sq, _ = q.shape
        hkv = k.shape[1]
        if h % hkv:
            raise ValueError(f"attention_ref: {h} query heads are not a "
                             f"multiple of {hkv} key/value heads")
        qf = qf.reshape(b, hkv, h // hkv, sq, d)
        kf, vf = kf[:, :, None], vf[:, :, None]
    s = (qf @ kf.transpose(-1, -2)) * scale
    if causal:
        qi = torch.arange(q.shape[-2], device=q.device)[:, None] + q_offset
        ki = torch.arange(k.shape[-2], device=q.device)[None, :]
        s = s.masked_fill(qi < ki, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = p @ vf
    if grouped:
        out = out.reshape(q.shape)
    return out.to(q.dtype)
