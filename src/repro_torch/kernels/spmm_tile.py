"""Block-sparse SpMM  Y = A @ X  on the card: wrapper over
`csrc/spmm_tile.cu` (replaces the Pallas `repro.kernels.spmm_tile`).

A is given as dense non-empty (bm×bn) blocks in block-row-major order, an
int32 block column per block and the int32 CSR `row_ptr` over block rows.
The kernel walks `row_ptr` (one CTA per block row) and writes every
output row, zeros for empty block rows. Its plain version is
`spmm_ref.spmm_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import require_cuda_f32, require_int32

LAUNCHES = 0   # kernel launches by this process (chip_smoke reads it)


def spmm_blocksparse(blocks: torch.Tensor, block_cols: torch.Tensor,
                     row_ptr: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for a block-sparse A.

    blocks:     (nb, bm, bn) float32
    block_cols: (nb,) int32
    row_ptr:    (n_block_rows + 1,) int32
    x:          (n_block_cols*bn, k) float32
    returns     (n_block_rows*bm, k) float32
    """
    global LAUNCHES
    dev = require_cuda_f32("spmm_blocksparse", blocks=blocks, x=x)
    require_int32("spmm_blocksparse", dev, block_cols=block_cols,
                  row_ptr=row_ptr)
    if blocks.dim() != 3 or x.dim() != 2 or row_ptr.dim() != 1:
        raise ValueError("spmm_blocksparse: blocks (nb, bm, bn), x (n, k), "
                         "row_ptr (n_block_rows + 1,)")
    nb, bm, bn = blocks.shape
    k = x.shape[1]
    if block_cols.shape != (nb,):
        raise ValueError(f"spmm_blocksparse: block_cols {tuple(block_cols.shape)}"
                         f" for {nb} blocks")
    if x.shape[0] % bn:
        raise ValueError(f"spmm_blocksparse: x has {x.shape[0]} rows, not a "
                         f"multiple of bn={bn}")
    if (bn % 4 or bm * bn > 4096 or bm * k > 2048 or bn * k > 1024
            or k == 0):
        raise ValueError(f"spmm_blocksparse: unsupported block ({bm}, {bn}) "
                         f"with k={k} (needs bn % 4 == 0, bm*bn <= 4096, "
                         f"bm*k <= 2048, bn*k <= 1024)")
    if blocks.data_ptr() % 16:
        raise ValueError("spmm_blocksparse: blocks must be 16-byte aligned")
    n_block_rows = row_ptr.shape[0] - 1
    y = torch.empty((n_block_rows * bm, k), dtype=torch.float32, device=dev)
    if n_block_rows == 0:
        return y
    device, stream = _build.device_and_stream(x)
    err = _build.lib().repro_spmm_blocksparse_f32(
        blocks.data_ptr(), block_cols.data_ptr(), row_ptr.data_ptr(),
        x.data_ptr(), y.data_ptr(), n_block_rows, bm, bn, k, device, stream)
    _build.check(err, "spmm_blocksparse")
    LAUNCHES += 1
    return y
