"""Flash attention on the card: wrapper over `csrc/flashattn.cu`
(replaces the Pallas `repro.kernels.flashattn`).

q (B, H, Sq, d), k/v (B, Hkv, Sk, d) with H % Hkv == 0 (grouped-query
attention: head h reads KV head h // (H / Hkv)), all float32 or all bf16,
d in HEAD_DIMS. Any strides with a contiguous last dim: the kernel reads
strided views, so the model passes its (B, S, H, d) projections without a
copy. The output is (B, H, Sq, d) in q's dtype, laid out as a (B, Sq, H, d)
tensor, so that `out.transpose(1, 2)` is contiguous. Any Sq and Sk; causal
masks key j for query i when j > i. Its plain version is
`flashattn_ref.attention_ref`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import require_cuda_float

LAUNCHES = 0   # kernel launches by this process (chip_smoke reads it)

HEAD_DIMS = (16, 32, 64, 128)   # the kernel's instantiations


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    global LAUNCHES
    dev = require_cuda_float("flash_attention", q=q, k=k, v=v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} must be "
                         f"(B, H, Sq, d) and (B, Hkv, Sk, d)")
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or h % hkv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (same B and d, H % Hkv == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} is not one of "
                         f"{HEAD_DIMS}")
    out = torch.empty((b, sq, h, d), dtype=q.dtype,
                      device=dev).transpose(1, 2)
    if b * h * sq == 0:
        return out
    if sk == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = (_build.lib().repro_flash_attention_f32 if q.dtype == torch.float32
          else _build.lib().repro_flash_attention_bf16)
    device, stream = _build.device_and_stream(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             ctypes.addressof(strides), b, h, hkv, sq, sk, d, int(causal),
             1.0 / math.sqrt(d), device, stream)
    _build.check(err, "flash_attention")
    LAUNCHES += 1
    return out
