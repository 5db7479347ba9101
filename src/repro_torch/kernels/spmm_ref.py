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


def spmm_f64(blocks: torch.Tensor, block_cols: torch.Tensor,
             row_ptr: torch.Tensor, coo: tuple, x: torch.Tensor,
             chunk: int = 1 << 16) -> tuple:
    """A·X in float64 over a block image (CSR `row_ptr`, `chunk` blocks at
    a time) and its COO side path `coo` = (rows, cols, vals), with Σ|terms|
    per element and each row's count of nonzero terms: the exact product,
    and what a float32 SpMM's rounding is bounded by (`float32_sum_bound`).
    """
    nb, bm, _ = blocks.shape
    nbr, k, dev = row_ptr.shape[0] - 1, x.shape[1], x.device
    x64 = x.double()
    xb = x64.reshape(-1, bm, k)
    rows = torch.repeat_interleave(torch.arange(nbr, device=dev),
                                   (row_ptr[1:] - row_ptr[:-1]).long())
    y = torch.zeros((nbr, bm, k), dtype=torch.float64, device=dev)
    terms = torch.zeros_like(y)
    count = torch.zeros((nbr, bm), dtype=torch.int64, device=dev)
    for c0 in range(0, nb, chunk):
        blk = blocks[c0:c0 + chunk].double()
        xc = xb[block_cols[c0:c0 + chunk].long()]
        r = rows[c0:c0 + chunk]
        y.index_add_(0, r, torch.bmm(blk, xc))
        terms.index_add_(0, r, torch.bmm(blk.abs(), xc.abs()))
        count.index_add_(0, r, (blk != 0).sum(-1))
        del blk, xc
    y, terms, count = y.reshape(-1, k), terms.reshape(-1, k), count.reshape(-1)
    cr, cc, cv = coo
    cr, cc, cv = cr.long(), cc.long(), cv.double()
    if cv.numel():
        y.index_add_(0, cr, cv[:, None] * x64[cc])
        terms.index_add_(0, cr, cv.abs()[:, None] * x64[cc].abs())
        count += torch.bincount(cr, minlength=count.numel())
    return y, terms, count


def float32_sum_bound(terms: torch.Tensor, count: torch.Tensor,
                      floor: float) -> torch.Tensor:
    """Per element, max(floor, γ_{m+1})·Σ|terms| for a row of m nonzero
    terms (γ_j = j·u / (1 − j·u), u = 2^-24): the bound on any float32
    sum of those terms, whatever its order."""
    mu = (count + 1).double()[:, None] * 2.0 ** -24
    return torch.clamp(mu / (1 - mu), min=floor) * terms
