"""Plain PyTorch versions of block-sparse SpMM: Y = A @ X.

A is a TiledMatrix-style block-sparse image. These mirror
`repro.kernels.spmm_ref` (block gather → dense product → scatter-add) and
are what the CPU path runs and what the CUDA kernel is held against.
All products accumulate in float32.
"""
from __future__ import annotations

import torch


def spmm_ref(blocks: torch.Tensor, block_cols: torch.Tensor,
             block_rows: torch.Tensor, n_block_rows: int,
             x: torch.Tensor) -> torch.Tensor:
    """Block-sparse SpMM.

    blocks:     (nb, bm, bn)
    block_cols: (nb,) int32  — block-column per block
    block_rows: (nb,) int32  — block-row per block (flattened CSR)
    x:          (n_cols_padded, k)
    returns     (n_block_rows*bm, k) float32; empty block rows are zero
    """
    nb, bm, bn = blocks.shape
    k = x.shape[1]
    xb = x.float().reshape(-1, bn, k)              # (n_block_cols, bn, k)
    gathered = xb[block_cols.long()]               # (nb, bn, k)
    partial = torch.bmm(blocks.float(), gathered)  # (nb, bm, k)
    out = torch.zeros((n_block_rows, bm, k), dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, block_rows.long(), partial)
    return out.reshape(n_block_rows * bm, k)


def coo_spmm_ref(coo_rows: torch.Tensor, coo_cols: torch.Tensor,
                 coo_vals: torch.Tensor, x: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    """COO side path (the remainder too sparse for a dense block):
    segment sum. On a CUDA tensor `index_add_` adds with atomics, so the
    order of the sum, and the last bits of Y, change from run to run."""
    contrib = coo_vals[:, None] * x[coo_cols.long()]       # (nnz, k)
    out = torch.zeros((n_rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, coo_rows.long(), contrib)
