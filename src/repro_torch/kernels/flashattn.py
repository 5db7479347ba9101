"""Flash attention on the card: wrapper over `csrc/flashattn.cu`
(replaces the Pallas `repro.kernels.flashattn`).

q (B, H, Sq, d), k/v (B, Hkv, Sk, d) with H % Hkv == 0 (grouped-query
attention: head h reads KV head h // (H / Hkv)), all float32 or all bf16,
d in HEAD_DIMS (80 is hubert-xlarge's; the bf16 kernel runs it on 128
columns, TMA filling the last 48 with zeros). Any strides with a contiguous last dim: the kernel reads
strided views, so the model passes its (B, S, H, d) projections without a
copy. The output is (B, H, Sq, d) in q's dtype, laid out as a (B, Sq, H, d)
tensor, so that `out.transpose(1, 2)` is contiguous. Any Sq and Sk; causal
masks key j for query i when j > i. Its plain version is
`flashattn_ref.attention_ref`.

The input type picks the kernel: bf16 runs on the tensor cores (wgmma
with TMA loads; the weights P enter the PV product as a bf16 pair, P_hi +
P_lo, 16 bits of each), float32 on the CUDA cores (cp.async loads; P
stays float32). Both read their inputs in 16-byte pieces, so they need
16-byte aligned inputs whose strides, for every dim longer than 1, are
multiples of 16 bytes (8 bf16 or 4 float32 elements); the wrapper raises
ValueError on any other view rather than take another path.

`flash_attention_lse` also returns each row's log-sum-exp (B, H, Sq)
float32 (the output is the same bits), and `flash_attention_bwd` is the
backward over `csrc/flashattn_bwd.cu`: (dq, dk, dv) from q, k, v, the
output, its LSE and dO, with no atomics (bit-identical run to run). bf16
runs on the tensor cores (wgmma with TMA loads, as the forward; the
weights P and dS enter their products rounded once to bf16, every sum is
float32), float32 on the CUDA cores. Its plain version is
`flashattn_ref.flash_attention_bwd_ref`. It takes strides under the
forward's 16-byte rules (a bf16 dO broadcast along a dim, as the gradient
of a sum is, is laid out first: TMA encodes laid-out data only) and returns
dq laid out as (B, Sq, H, d) and dk, dv as (B, Sk, Hkv, d), as the
forward lays out its output.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (F32_BF16, require_cuda_float,
                                         require_dtype)

LAUNCHES = 0   # kernel launches by this process (chip_smoke reads it)
LAUNCHES_BY_D: dict[int, int] = {}   # those of them by head dim
BWD_LAUNCHES = 0   # backward calls that launched (2 to 4 kernels each)
BWD_LAUNCHES_BY_D: dict[int, int] = {}   # those of them by head dim

HEAD_DIMS = (16, 32, 64, 80, 128)   # the kernel's head dims
BWD_TILE = 64   # query rows per tile of the backward (its LSE/D pad)
# how the bf16 kernel feeds the weights P to the PV product (PERF.md)
PV_DESIGN = ("P split into bf16 hi + lo, two PV wgmmas per 16 keys "
             "(m64nNk16, A from registers)")


def _count(launched: bool, d: int) -> None:
    global LAUNCHES
    if launched:
        LAUNCHES += 1
        LAUNCHES_BY_D[d] = LAUNCHES_BY_D.get(d, 0) + 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    out, _, launched = launch_with(_build.lib, q, k, v, causal=causal)
    _count(launched, q.shape[-1])
    return out


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """`flash_attention` that also stores the row log-sum-exp of the
    scaled scores: (out, lse (B, H, Sq) float32). Counted in LAUNCHES."""
    out, lse, launched = launch_with(_build.lib, q, k, v, causal=causal,
                                     with_lse=True)
    _count(launched, q.shape[-1])
    return out, lse


def _shapes(name: str, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> tuple[int, ...]:
    """(B, H, Hkv, Sq, Sk, d) of checked q, k, v."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} must be "
                         f"(B, H, Sq, d) and (B, Hkv, Sk, d)")
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or h % hkv:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (same B and d, H % Hkv == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} is not one of "
                         f"{HEAD_DIMS}")
    return b, h, hkv, sq, sk, d


def launch_with(library, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                *, causal: bool, with_lse: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor | None, bool]:
    """`flash_attention` through the kernel library that `library()`
    returns, once the inputs have passed their checks (`_build.lib` for
    the port's; `flash_pv` passes a variant build): the output, the LSE
    (None without `with_lse`), and whether a kernel was launched. It
    counts nothing in LAUNCHES."""
    dev = require_cuda_float("flash_attention", q=q, k=k, v=v)
    b, h, hkv, sq, sk, d = _shapes("flash_attention", q, k, v)
    out = torch.empty((b, sq, h, d), dtype=q.dtype,
                      device=dev).transpose(1, 2)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=dev)
           if with_lse else None)
    if b * h * sq == 0:
        return out, lse, False
    if sk == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    _require_tma_layout("flash_attention", q=q, k=k, v=v)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            ctypes.addressof(strides), b, h, hkv, sq, sk, d, int(causal),
            1.0 / math.sqrt(d), *_build.device_and_stream(q)]
    if q.dtype == torch.float32:
        err = library().repro_flash_attention_f32(*args)
    else:
        err = library().repro_flash_attention_bf16(*args)
    _check(err, "flash_attention")
    return out, lse, True


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_attention(q, k, v, causal=causal)` = o, given
    the forward's lse and the output's gradient do. Counted in
    BWD_LAUNCHES (one per call that launches: bf16 runs LSE and D, dK and
    dV, their sum over a KV head's query heads when H > Hkv, and dQ;
    float32 LSE and D, dK, dV and dQ in one grid, and the same sum)."""
    global BWD_LAUNCHES
    # types and shapes first, so that a refusal reads the same on any device
    b, h, hkv, sq, sk, d = _shapes("flash_attention_bwd", q, k, v)
    require_dtype("flash_attention_bwd", F32_BF16, q=q, k=k, v=v, o=o, do=do)
    if len({t.dtype for t in (q, k, v, o, do)}) > 1:
        raise TypeError(f"flash_attention_bwd: q, k, v, o and do must share "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}, "
                        f"{o.dtype}, {do.dtype}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must be q's shape "
                         f"{tuple(q.shape)}")
    if (lse.dtype != torch.float32 or lse.shape != (b, h, sq)
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"float32 ({b}, {h}, {sq}) tensor, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    dev = require_cuda_float("flash_attention_bwd", q=q, k=k, v=v, o=o,
                             do=do)
    if lse.device != dev:
        raise ValueError(f"flash_attention_bwd: lse is on {lse.device}, "
                         f"not {dev}")
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev).transpose(1, 2)
    dk = torch.empty((b, sk, hkv, d), dtype=k.dtype,
                     device=dev).transpose(1, 2)
    dv = torch.empty_like(dk)
    if b * h * sq == 0 or sk == 0:
        return dq, dk.zero_(), dv.zero_()
    if q.dtype == torch.bfloat16:
        do = _unbroadcast(do)
    _require_tma_layout("flash_attention_bwd", q=q, k=k, v=v, o=o, do=do)
    scratch = bwd_scratch(b, h, hkv, sq, sk, d, dev)
    fn = (_build.lib().repro_flash_attention_bwd_bf16
          if q.dtype == torch.bfloat16
          else _build.lib().repro_flash_attention_bwd_f32)
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]))
    err = fn(*(t.data_ptr() for t in (q, k, v, o, do, lse)),
             *(t.data_ptr() if t is not None else None for t in scratch),
             *(t.data_ptr() for t in (dq, dk, dv)),
             ctypes.addressof(strides), b, h, hkv, sq, sk, d, int(causal),
             1.0 / math.sqrt(d), *_build.device_and_stream(q))
    _check(err, "flash_attention_bwd")
    BWD_LAUNCHES += 1
    BWD_LAUNCHES_BY_D[d] = BWD_LAUNCHES_BY_D.get(d, 0) + 1
    return dq, dk, dv


def bwd_scratch(b: int, h: int, hkv: int, sq: int, sk: int, d: int,
                device) -> list[torch.Tensor | None]:
    """The backward's float32 scratch, either input type: LSE log2(e) and
    D of every query row, (2, B, H, Sq_pad) with Sq_pad = Sq rounded up to
    whole BWD_TILE-row tiles; and when H > Hkv the per-query-head partials
    of dK and dV, (2, B, H, Sk, d), which the reduction kernel sums over
    each KV head's query heads (None when H = Hkv)."""
    sq_pad = -(-sq // BWD_TILE) * BWD_TILE
    return [torch.empty((2, b, h, sq_pad), dtype=torch.float32,
                        device=device),
            torch.empty((2, b, h, sk, d), dtype=torch.float32,
                        device=device) if h != hkv else None]


# error codes of the bf16 launchers beyond cudaError_t (csrc/hopper.cuh)
_ERR_NO_ENCODER, _ERR_ENCODE = 19999, 20000


def _check(err: int, name: str) -> None:
    if err >= _ERR_NO_ENCODER:
        raise RuntimeError(
            f"{name}: the driver has no cuTensorMapEncodeTiled"
            if err == _ERR_NO_ENCODER else
            f"{name}: cuTensorMapEncodeTiled failed with CUresult "
            f"{err - _ERR_ENCODE}")
    _build.check(err, name)


def _unbroadcast(t: torch.Tensor) -> torch.Tensor:
    """`t`, laid out anew if it repeats itself along a dim longer than 1
    (stride 0, as the gradient of a sum does): `_require_tma_layout` lets
    such a stride through, and the bf16 backward encodes its tensor maps
    over laid-out data only (the float32 one reads any address)."""
    if any(size > 1 and stride == 0
           for size, stride in zip(t.shape, t.stride())):
        return t.contiguous()
    return t


def _require_tma_layout(name: str, **tensors: torch.Tensor) -> None:
    """The rules of 16-byte loads (TMA for bf16, cp.async for float32):
    a 16-byte aligned base, and a stride that is a multiple of 16 bytes
    for every dim longer than 1."""
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} starts at an address that is "
                             f"not 16-byte aligned (its 16-byte loads need "
                             f"it)")
        for size, stride in zip(t.shape[:3], t.stride()[:3]):
            if size > 1 and (stride * t.element_size()) % 16:
                raise ValueError(
                    f"{name}: {arg} has strides {t.stride()}; its 16-byte "
                    f"loads need every stride of a dim longer than 1 to be "
                    f"a multiple of 16 bytes ({16 // t.element_size()} "
                    f"elements)")
