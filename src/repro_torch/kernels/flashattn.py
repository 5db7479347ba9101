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

The input type picks the kernel: bf16 runs on the tensor cores (wgmma
with TMA loads; the weights P enter the PV product as a bf16 pair, P_hi +
P_lo, 16 bits of each), float32 on the CUDA cores (P stays float32).
TMA needs 16-byte aligned bf16 inputs whose strides, for every dim longer
than 1, are multiples of 8 elements; the wrapper raises ValueError on
any other view rather than take another path.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import require_cuda_float

LAUNCHES = 0   # kernel launches by this process (chip_smoke reads it)

HEAD_DIMS = (16, 32, 64, 128)   # the kernel's instantiations
# how the bf16 kernel feeds the weights P to the PV product (PERF.md)
PV_DESIGN = ("P split into bf16 hi + lo, two PV wgmmas per 16 keys "
             "(m64nNk16, A from registers)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    global LAUNCHES
    out, launched = launch_with(_build.lib, q, k, v, causal=causal)
    LAUNCHES += launched
    return out


def launch_with(library, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                *, causal: bool) -> tuple[torch.Tensor, bool]:
    """`flash_attention` through the kernel library that `library()`
    returns, once the inputs have passed their checks (`_build.lib` for
    the port's; `flash_pv` passes a variant build): the output, and
    whether a kernel was launched. It counts nothing in LAUNCHES."""
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
        return out, False
    if sk == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    if q.dtype == torch.bfloat16:
        _require_tma_layout(q=q, k=k, v=v)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.addressof(strides), b, h, hkv, sq, sk, d, int(causal),
            1.0 / math.sqrt(d), *_build.device_and_stream(q)]
    if q.dtype == torch.float32:
        err = library().repro_flash_attention_f32(*args)
    else:
        err = library().repro_flash_attention_bf16(*args)
    if err >= _ERR_NO_ENCODER:
        raise RuntimeError(
            "flash_attention: the driver has no cuTensorMapEncodeTiled"
            if err == _ERR_NO_ENCODER else
            f"flash_attention: cuTensorMapEncodeTiled failed with CUresult "
            f"{err - _ERR_ENCODE}")
    _build.check(err, "flash_attention")
    return out, True


# error codes of the bf16 launcher beyond cudaError_t (csrc/flashattn.cu)
_ERR_NO_ENCODER, _ERR_ENCODE = 19999, 20000


def _require_tma_layout(**tensors: torch.Tensor) -> None:
    """TMA's rules for a bf16 input: a 16-byte aligned base, and a stride
    that is a multiple of 16 bytes for every dim longer than 1."""
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {arg} starts at an address "
                             f"that is not 16-byte aligned (TMA needs it)")
        for size, stride in zip(t.shape[:3], t.stride()[:3]):
            if size > 1 and (stride * t.element_size()) % 16:
                raise ValueError(
                    f"flash_attention: {arg} has strides {t.stride()}; TMA "
                    f"needs every stride of a dim longer than 1 to be a "
                    f"multiple of 16 bytes ({16 // t.element_size()} "
                    f"elements)")
