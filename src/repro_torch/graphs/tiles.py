"""Block-sparse matrix image (numpy), byte-identical to `repro.graphs.tiles`.

`pack_tiles` turns COO entries into a `TiledMatrix`: non-empty (bm×bn)
blocks are stored densely in block-row-major order and indexed by a CSR
over block rows (the paper's §3.3.1 "matrix index"); blocks with fewer
than `min_block_nnz` entries fall through to a COO remainder. The SpMM
kernel follows a work plan of `row_ptr` (`kernels.spmm_tile.plan`) that
splits the heavy block rows over several CTAs.

The paper's 2-byte SCSR+COO codec and `chunk_block_rows` (the unit of
the SSD-streamed image) are not ported yet: they belong to the SAFS
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class TiledMatrix:
    """Block-sparse matrix image.

    blocks     (nblocks, bm, bn) float32 — dense non-empty blocks in
               block-row-major order (the streamed operand).
    block_cols (nblocks,) int32 — block-column index per block.
    row_ptr    (n_block_rows+1,) int32 — CSR over block rows.
    coo_*      unstructured remainder handled by the segment-sum path.
    """
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]
    blocks: np.ndarray
    block_cols: np.ndarray
    row_ptr: np.ndarray
    coo_rows: np.ndarray
    coo_cols: np.ndarray
    coo_vals: np.ndarray

    @property
    def nblocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def n_block_rows(self) -> int:
        return int(self.row_ptr.shape[0] - 1)

    def nbytes_image(self) -> int:
        """Bytes of the matrix image (what one SpMM streams)."""
        return (self.blocks.nbytes + self.block_cols.nbytes
                + self.coo_rows.nbytes + self.coo_cols.nbytes
                + self.coo_vals.nbytes)


def pack_tiles(n_rows: int, n_cols: int, rows: np.ndarray, cols: np.ndarray,
               vals: np.ndarray, *, block_shape: Tuple[int, int] = (128, 128),
               min_block_nnz: int = 1) -> TiledMatrix:
    """COO → block-sparse image.

    Blocks with >= min_block_nnz entries become dense blocks (SpMM kernel
    path); sparser blocks' entries fall through to the COO side path.
    Dimensions are padded up to block multiples (padding rows/cols are
    zero and harmless: SpMM output is sliced back).
    """
    bm, bn = block_shape
    n_pad = -(-n_rows // bm) * bm
    m_pad = -(-n_cols // bn) * bn
    nbr, nbc = n_pad // bm, m_pad // bn

    br = rows // bm
    bc = cols // bn
    key = br.astype(np.int64) * nbc + bc.astype(np.int64)
    order = np.argsort(key, kind="stable")
    rows, cols, vals, key = rows[order], cols[order], vals[order], key[order]
    ukey, start, counts = np.unique(key, return_index=True, return_counts=True)

    dense_mask_per_entry = np.repeat(counts >= min_block_nnz, counts)
    d_rows, d_cols, d_vals = (rows[dense_mask_per_entry],
                              cols[dense_mask_per_entry],
                              vals[dense_mask_per_entry])
    s_rows, s_cols, s_vals = (rows[~dense_mask_per_entry],
                              cols[~dense_mask_per_entry],
                              vals[~dense_mask_per_entry])

    dense_keys = ukey[counts >= min_block_nnz]
    nblocks = dense_keys.shape[0]
    blocks = np.zeros((max(nblocks, 1), bm, bn), dtype=np.float32)
    block_cols = np.zeros(max(nblocks, 1), dtype=np.int32)
    row_ptr = np.zeros(nbr + 1, dtype=np.int32)

    if nblocks:
        blk_of_entry = np.searchsorted(dense_keys, key[dense_mask_per_entry])
        blocks[blk_of_entry, d_rows % bm, d_cols % bn] = d_vals
        block_row_of = (dense_keys // nbc).astype(np.int32)
        block_cols[:nblocks] = (dense_keys % nbc).astype(np.int32)
        np.add.at(row_ptr, block_row_of + 1, 1)
        row_ptr = np.cumsum(row_ptr).astype(np.int32)
    if nblocks == 0:
        blocks = blocks[:0]
        block_cols = block_cols[:0]

    return TiledMatrix(
        shape=(n_pad, m_pad), block_shape=(bm, bn),
        blocks=blocks, block_cols=block_cols, row_ptr=row_ptr,
        coo_rows=s_rows.astype(np.int32), coo_cols=s_cols.astype(np.int32),
        coo_vals=s_vals.astype(np.float32),
    )
