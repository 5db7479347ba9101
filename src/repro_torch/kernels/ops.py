"""Public kernel entry points, dispatched by the tensor's device.

Mirrors `repro.kernels.ops`. With `impl="auto"` (the default) a CUDA
tensor launches the hand-written kernel, and raises if the kernel does
not build or launch; a CPU tensor takes the plain PyTorch version.
`impl="ref"` forces the plain version on any device (tests and
chip_smoke.py compare with it). There is no fallback from a CUDA tensor
to the plain version. A meta tensor (the dry run's trace) takes each
kernel's shape-only path (`kernels.meta`): outputs of the kernel's shapes
and its flop count, and neither a launch nor the plain version's
intermediates.
"""
from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from repro_torch.graphs.tiles import TiledMatrix
from repro_torch.kernels import flashattn as _flash_kernel
from repro_torch.kernels import gram as _gram_kernel
from repro_torch.kernels import meta as _meta
from repro_torch.kernels import spmm_tile as _spmm_kernel
from repro_torch.kernels import tsgemm as _tsgemm_kernel
from repro_torch.kernels.flashattn_ref import (attention_ref,
                                               attention_ref_lse,
                                               flash_attention_bwd_ref)
from repro_torch.kernels.gram_ref import gram_ref
from repro_torch.kernels.spmm_ref import coo_spmm_ref, spmm_ref
from repro_torch.kernels.tsgemm_ref import tsgemm_ref

Impl = Literal["auto", "ref"]


def _use_kernel(impl: Impl, t: torch.Tensor) -> bool:
    if impl == "ref":
        return False
    if impl == "auto":
        return t.device.type == "cuda"
    raise ValueError(f"unknown impl {impl!r}; expected auto | ref")


def _shape_only(impl: Impl, t: torch.Tensor) -> bool:
    """Whether a call takes the kernel's shape-only path: a meta tensor
    under impl "auto"."""
    return impl == "auto" and t.device.type == "meta"


# ---------------------------------------------------------------------------
# SpMM
# ---------------------------------------------------------------------------

def from_numpy(a: np.ndarray) -> torch.Tensor:
    """A numpy array (a TiledMatrix's blocks) as a CPU tensor of the same
    bytes: bf16 (numpy's `bfloat16` extension type, recognised by name,
    with no import of the package that defines it) through its raw 16-bit
    words, any other type as `torch.from_numpy` takes it."""
    if a.dtype.name == "bfloat16":
        words = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(words).view(torch.bfloat16)
    return torch.from_numpy(a)


def block_rows_from_ptr(row_ptr: np.ndarray) -> np.ndarray:
    """Flatten the CSR row_ptr into per-block block-row ids."""
    return np.repeat(np.arange(row_ptr.shape[0] - 1, dtype=np.int32),
                     np.diff(row_ptr))


def empty_row_mask(row_ptr: np.ndarray, bm: int) -> np.ndarray:
    """Boolean (n_rows,) mask — True where the block row has any blocks."""
    return np.repeat(np.diff(row_ptr) > 0, bm)


def spmm_blocks(blocks: torch.Tensor, block_cols: torch.Tensor,
                row_ptr: torch.Tensor, x: torch.Tensor, *,
                impl: Impl = "auto",
                plan: _spmm_kernel.Plan | None = None) -> torch.Tensor:
    """Block-sparse part of SpMM over the CSR `row_ptr`: blocks float32 or
    bf16, x float32 or bf16, Y float32 with float32 products and sums.
    Rows of empty block rows come out zero on both paths. `plan` is the
    image's work plan for the kernel (`spmm_tile.plan`, built once per
    image); the kernel builds one from row_ptr when none is given, and
    the plain version ignores it."""
    if _shape_only(impl, x):
        return _meta.spmm_blocks(blocks, block_cols, row_ptr, x)
    if _use_kernel(impl, x):
        return _spmm_kernel.spmm_blocksparse(blocks, block_cols, row_ptr, x,
                                             plan=plan)
    n_block_rows = row_ptr.shape[0] - 1
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    block_rows = torch.repeat_interleave(
        torch.arange(n_block_rows, device=row_ptr.device), counts)
    return spmm_ref(blocks, block_cols, block_rows, n_block_rows, x)


def spmm(tm: TiledMatrix, x: torch.Tensor, *,
         impl: Impl = "auto") -> torch.Tensor:
    """Full SpMM: block-sparse path + COO side path. Host-side convenience
    (copies the image to x's device on every call — GraphOperator keeps
    it resident instead)."""
    dev = x.device
    y = spmm_blocks(from_numpy(tm.blocks).to(dev),
                    torch.from_numpy(tm.block_cols).to(dev),
                    torch.from_numpy(tm.row_ptr).to(dev), x, impl=impl)
    if tm.coo_vals.size:
        y = y + coo_spmm_ref(torch.from_numpy(tm.coo_rows).to(dev),
                             torch.from_numpy(tm.coo_cols).to(dev),
                             torch.from_numpy(tm.coo_vals).to(dev),
                             x, tm.shape[0])
    return y


def coo_spmm(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor, n_rows: int, *,
             impl: Impl = "auto") -> torch.Tensor:
    """The COO side path, Y = Σ vals·X[cols] into `rows`: plain PyTorch
    (`coo_spmm_ref`) on every device but meta, where it is shape-only."""
    if _shape_only(impl, x):
        return _meta.coo_spmm(rows, cols, vals, x, n_rows)
    return coo_spmm_ref(rows, cols, vals, x, n_rows)


# ---------------------------------------------------------------------------
# TAS dense ops
# ---------------------------------------------------------------------------

def tsgemm(a: torch.Tensor, b: torch.Tensor, *, alpha: float = 1.0,
           beta: float = 0.0, c0: torch.Tensor | None = None,
           impl: Impl = "auto") -> torch.Tensor:
    """C = alpha*A@B + beta*C0 (MvTimesMatAddMv)."""
    if _shape_only(impl, a):
        return _meta.tsgemm(a, b, c0 if beta != 0.0 else None)
    if not _use_kernel(impl, a):
        return tsgemm_ref(a, b, alpha=alpha, beta=beta, c0=c0)
    return _tsgemm_kernel.tsgemm(a, b, c0 if beta != 0.0 else None,
                                 alpha=alpha, beta=beta)


def gram(a: torch.Tensor, b: torch.Tensor, *, alpha: float = 1.0,
         impl: Impl = "auto") -> torch.Tensor:
    """G = alpha*AᵀB (MvTransMv)."""
    if _shape_only(impl, a):
        return _meta.gram(a, b)
    if not _use_kernel(impl, a):
        return gram_ref(a, b, alpha=alpha)
    return _gram_kernel.gram(a, b, alpha=alpha)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the forward keeps q, k, v, the
    output and its row LSE; the backward launches the hand-written
    backward kernels where the forward launched the kernel, and the plain
    backward on the CPU, so both paths run the same wiring.

    The backward is itself differentiable (a Hessian-vector product
    differentiates it): it applies `_FlashAttentionGrad`, whose forward is
    that first-order backward and whose backward takes the second-order
    terms. The LSE is computed without a graph and saved beside the
    inputs, so no derivative may be taken through it: the second-order
    terms come from the inputs q, k, v and dO alone."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, route: str):
        if route == "kernel":
            out, lse = _flash_kernel.flash_attention_lse(q, k, v,
                                                         causal=causal)
        elif route == "meta":
            out, lse = _meta.flash_attention(q, k, v, causal)
        else:
            out, lse = attention_ref_lse(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.route = causal, route
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1:     # e.g. the expanded ones of a sum
            do = do.contiguous()
        dq, dk, dv = _FlashAttentionGrad.apply(
            q, k, v, out.detach(), lse, do, ctx.causal, ctx.route)
        return dq, dk, dv, None, None


class _FlashAttentionGrad(torch.autograd.Function):
    """The first-order backward of flash attention as a function of
    (q, k, v, dO), so that a double backward sees how dq, dk, dv depend
    on each of them. out and LSE come in as constants (detached): the
    second-order terms recompute them from q, k, v.

    forward: the hand-written backward kernels on a CUDA tensor, the
    plain backward on the CPU (the first-order product, as before), the
    kernels' shape-only path on a meta tensor.
    backward: the second-order terms, by autograd through the plain
    attention `attention_ref`, on every device. This route is plain on
    purpose: the reference has no kernel for it either (JAX
    differentiates its plain attention to any order), so it counts
    calls, not launches (`flashattn.GRAD2_CALLS`). A third derivative
    raises instead of returning values (`_NoThirdDerivative`)."""

    @staticmethod
    def forward(ctx, q, k, v, out, lse, do, causal: bool, route: str):
        ctx.save_for_backward(q, k, v, do)
        ctx.causal = causal
        if route == "meta":
            return _meta.flash_attention_bwd(q, k, v, out, lse, do, causal)
        bwd = (_flash_kernel.flash_attention_bwd if route == "kernel"
               else flash_attention_bwd_ref)
        return bwd(q, k, v, out, lse, do, causal=causal)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        saved = ctx.saved_tensors
        _flash_kernel.GRAD2_CALLS += 1
        with torch.enable_grad():
            q, k, v, do = (t.detach().requires_grad_() for t in saved)
            out = attention_ref(q, k, v, causal=ctx.causal)
            first = torch.autograd.grad(out, (q, k, v), do,
                                        create_graph=True)
            terms = torch.autograd.grad(first, (q, k, v, do), (gq, gk, gv))
        if torch.is_grad_enabled():       # a graph is being built on them
            terms = _NoThirdDerivative.apply(*terms, *saved, gq, gk, gv)
        hq, hk, hv, hdo = terms
        return hq, hk, hv, None, None, hdo, None, None


class _NoThirdDerivative(torch.autograd.Function):
    """Passes the four second-order terms through (the first four
    arguments; the others are what they depend on) and raises if they are
    differentiated. `torch.autograd.function.once_differentiable` does
    not do: it raises only when the incoming gradients need a gradient,
    and otherwise returns terms that a third derivative treats as
    constants, i.e. wrong values."""

    @staticmethod
    def forward(ctx, *args):
        return tuple(t.clone() for t in args[:4])

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("flash attention is differentiable twice; a "
                           "third derivative through it is not supported")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, impl: Impl = "auto") -> torch.Tensor:
    """Softmax attention, scale 1/√d: q (B, H, Sq, d), k/v (B, Hkv, Sk, d)
    with H % Hkv == 0 → (B, H, Sq, d) in q's dtype. Scores and sums are
    float32 on both paths; the weights are float32 too, except in the
    kernel's bf16 path, which feeds them to the PV product as a bf16 pair
    (16 bits).

    Differentiable: when grad is enabled and an input needs a gradient,
    the call goes through `_FlashAttention` (the forward also stores the
    row LSE, the backward is a kernel too on a CUDA tensor), and a
    second derivative takes its terms through the plain attention
    (`_FlashAttentionGrad`). Otherwise (serving) it is the forward alone,
    as it always was. On a meta tensor both directions are the kernels'
    shape-only path (`kernels.meta`)."""
    route = ("meta" if _shape_only(impl, q) else
             "kernel" if _use_kernel(impl, q) else "ref")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, route)
    if route == "kernel":
        return _flash_kernel.flash_attention(q, k, v, causal=causal)
    if route == "meta":
        return _meta.flash_attention(q, k, v, causal)[0]
    return attention_ref(q, k, v, causal=causal)
