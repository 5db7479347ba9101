"""The kernels' shape-only path, for tensors on the meta device.

A meta tensor has a shape and a type and no storage: the dry run
(`launch.dryrun`) traces the port's programs on them. There, a kernel
wrapper must neither launch (there is no card) nor run its plain version
(flash attention's would build the float32 (B, H, Sq, Sk) scores that the
kernel never holds). `kernels.ops` sends a meta tensor here instead: each
kernel is a `torch.library` operator whose fake implementation returns
outputs of the kernel's shapes and types and nothing else, with a flop
formula that `torch.utils.flop_counter.FlopCounterMode` reads, the
products the kernel executes:

  flash forward   2 products of 2·B·H·Sq·Sk·d (S = QKᵀ, O = PV);
  flash backward  7, the design's (`csrc/flashattn_bwd.cu` recomputes S
                  and P in both of its passes so that no sum needs an
                  atomic);
                  both halved under causal;
  SpMM            2·nnz·k over the stored entries of the block image
                  (nb·bm·bn: a kernel multiplies a block's zeros too);
  COO remainder   2·nnz·k (the plain side path);
  gram, tsgemm    2·n·m·b.

The operators have no implementation on any other device: calling one
with a CPU or CUDA tensor raises.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

FLASH_FWD_PRODUCTS = 2
FLASH_BWD_PRODUCTS = 7


def _no_impl(name: str):
    raise NotImplementedError(f"repro_torch::{name} is the shape-only path "
                              "of a kernel: it takes meta tensors only")


def _attn_flops(q_shape, k_shape, causal: bool, products: int) -> int:
    b, h, sq, d = q_shape
    f = products * 2 * b * h * sq * k_shape[2] * d
    return f // 2 if causal else f


# ------------------------------------------------------------ attention
@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    _no_impl("flash_attention")


@flash_attention.register_fake
def _(q, k, v, causal):
    # laid out as the kernel lays out its output: (B, Sq, H, d)
    b, h, sq, d = q.shape
    return (q.new_empty((b, sq, h, d)).transpose(1, 2),
            q.new_empty((b, h, sq), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, causal, *args, **kwargs) -> int:
    return _attn_flops(q_shape, k_shape, causal, FLASH_FWD_PRODUCTS)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _no_impl("flash_attention_bwd")


@flash_attention_bwd.register_fake
def _(q, k, v, o, lse, do, causal):
    # laid out as the kernels lay them out: (B, S, heads, d)
    def laid(t):
        b, h, s, d = t.shape
        return t.new_empty((b, s, h, d)).transpose(1, 2)
    return laid(q), laid(k), laid(v)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _(q_shape, k_shape, *args, **kwargs) -> int:
    causal = args[4] if len(args) > 4 else kwargs["causal"]
    return _attn_flops(q_shape, k_shape, causal, FLASH_BWD_PRODUCTS)


# ------------------------------------------------------------ SpMM
@torch.library.custom_op("repro_torch::spmm_blocks", mutates_args=())
def spmm_blocks(blocks: torch.Tensor, block_cols: torch.Tensor,
                row_ptr: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    _no_impl("spmm_blocks")


@spmm_blocks.register_fake
def _(blocks, block_cols, row_ptr, x):
    return x.new_empty(((row_ptr.shape[0] - 1) * blocks.shape[1],
                        x.shape[1]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.spmm_blocks)
def _(blocks_shape, cols_shape, ptr_shape, x_shape, *args, **kwargs) -> int:
    return 2 * math.prod(blocks_shape) * x_shape[1]


@torch.library.custom_op("repro_torch::coo_spmm", mutates_args=())
def coo_spmm(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor, n_rows: int) -> torch.Tensor:
    _no_impl("coo_spmm")


@coo_spmm.register_fake
def _(rows, cols, vals, x, n_rows):
    return x.new_empty((n_rows, x.shape[1]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.coo_spmm)
def _(rows_shape, cols_shape, vals_shape, x_shape, *args, **kwargs) -> int:
    return 2 * math.prod(vals_shape) * x_shape[1]


# ------------------------------------------------------------ TAS ops
@torch.library.custom_op("repro_torch::gram", mutates_args=())
def gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _no_impl("gram")


@gram.register_fake
def _(a, b):
    return a.new_empty((a.shape[1], b.shape[1]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.gram)
def _(a_shape, b_shape, *args, **kwargs) -> int:
    return 2 * a_shape[0] * a_shape[1] * b_shape[1]


@torch.library.custom_op("repro_torch::tsgemm", mutates_args=())
def tsgemm(a: torch.Tensor, b: torch.Tensor,
           c0: Optional[torch.Tensor]) -> torch.Tensor:
    _no_impl("tsgemm")


@tsgemm.register_fake
def _(a, b, c0):
    return a.new_empty((a.shape[0], b.shape[1]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.tsgemm)
def _(a_shape, b_shape, *args, **kwargs) -> int:
    return 2 * a_shape[0] * a_shape[1] * b_shape[1]
