"""Block-sparse matrix image (numpy), byte-identical to `repro.graphs.tiles`.

`pack_tiles` turns COO entries into a `TiledMatrix`: non-empty (bm×bn)
blocks are stored densely in block-row-major order and indexed by a CSR
over block rows (the paper's §3.3.1 "matrix index"); blocks with fewer
than `min_block_nnz` entries fall through to a COO remainder. The SpMM
kernel follows a work plan of `row_ptr` (`kernels.spmm_tile.plan`) that
splits the heavy block rows over several CTAs.

The paper's §3.3.1 storage format is here too: the 2-byte SCSR+COO tile
codec (`scsr_encode_tile`/`scsr_decode_tile`, byte-identical to the
reference's), and `chunk_block_rows`, the block-row spans in which
`GraphOperator(stream_image=True)` keeps the image in the page store.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

MAX_TILE = 32768  # 2-byte indices with MSB tag → max 32K×32K (paper §3.3.1)


# ---------------------------------------------------------------------------
# 1. Faithful SCSR + COO byte codec (paper fidelity layer)
# ---------------------------------------------------------------------------

def scsr_encode_tile(rows: np.ndarray, cols: np.ndarray,
                     tile_shape: Tuple[int, int]) -> bytes:
    """Encode one tile's COO entries (tile-local indices) into the paper's
    hybrid SCSR+COO byte format.

    Layout:  [SCSR section: for each multi-entry row, a row header
              (0x8000 | row) followed by its column indices (MSB=0)]
             [COO section: (row, col) pairs for single-entry rows]
             [footer: uint32 n_scsr_entries, uint32 n_coo_pairs]
    All index entries are uint16 little-endian.
    """
    tm, tn = tile_shape
    if tm > MAX_TILE or tn > MAX_TILE:
        raise ValueError(f"tile {tile_shape} exceeds SCSR max {MAX_TILE}")
    if rows.size == 0:
        return np.array([0, 0], dtype=np.uint32).tobytes()
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    urows, counts = np.unique(rows, return_counts=True)
    multi = set(urows[counts > 1].tolist())
    scsr: list[int] = []
    coo: list[int] = []
    i = 0
    while i < rows.size:
        r = int(rows[i])
        j = i
        while j < rows.size and rows[j] == r:
            j += 1
        if r in multi:
            scsr.append(0x8000 | r)          # row header, MSB=1
            scsr.extend(int(c) for c in cols[i:j])  # column entries, MSB=0
        else:
            coo.append(r)                     # single-entry rows → COO pairs
            coo.append(int(cols[i]))
        i = j
    body = np.array(scsr + coo, dtype=np.uint16).tobytes()
    footer = np.array([len(scsr), len(coo) // 2], dtype=np.uint32).tobytes()
    return body + footer


def scsr_decode_tile(buf: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """Decode the hybrid format back to tile-local COO (rows, cols)."""
    n_scsr, n_coo = np.frombuffer(buf[-8:], dtype=np.uint32)
    body = np.frombuffer(buf[:-8], dtype=np.uint16)
    scsr, coo = body[:n_scsr], body[n_scsr:n_scsr + 2 * n_coo]
    rows: list[int] = []
    cols: list[int] = []
    cur = -1
    for e in scsr:
        if e & 0x8000:
            cur = int(e & 0x7FFF)
        else:
            rows.append(cur)
            cols.append(int(e))
    r = np.array(rows + coo[0::2].tolist(), dtype=np.int32)
    c = np.array(cols + coo[1::2].tolist(), dtype=np.int32)
    return r, c


def scsr_tile_nbytes(rows: np.ndarray) -> int:
    """Storage bytes of the hybrid format for a tile (excluding values),
    used by the format-size benchmark (paper: SCSR+COO vs CSR)."""
    if rows.size == 0:
        return 8
    _, counts = np.unique(rows, return_counts=True)
    multi_rows = int((counts > 1).sum())
    multi_entries = int(counts[counts > 1].sum())
    single = int((counts == 1).sum())
    return 2 * (multi_rows + multi_entries + 2 * single) + 8



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

    @property
    def nnz(self) -> int:
        return int((self.blocks != 0).sum()) + int(self.coo_vals.shape[0])

    def nbytes_image(self) -> int:
        """Bytes of the matrix image (what one SpMM streams)."""
        return (self.blocks.nbytes + self.block_cols.nbytes
                + self.coo_rows.nbytes + self.coo_cols.nbytes
                + self.coo_vals.nbytes)

    def chunk_block_rows(self, target_bytes: int
                         ) -> list[Tuple[int, int, int, int]]:
        """Split the image into contiguous block-row spans of dense blocks
        totalling ~target_bytes each: `[(br_lo, br_hi, blk_lo, blk_hi)]`
        with blocks[blk_lo:blk_hi] exactly the blocks of block rows
        [br_lo, br_hi). This is the unit the SSD-streamed SpMM reads per
        request (the paper's §3.3.3 sequential scan, page-store edition):
        each span becomes one page-store entry, loaded as coalesced
        vectored runs and prefetched one span ahead of the contraction.
        Never splits inside a block row, so per-span SpMM needs only a
        rebased row index. Returns [] for an image with no block rows.
        """
        if self.n_block_rows == 0:
            return []
        bm, bn = self.block_shape
        per_block = bm * bn * self.blocks.itemsize if self.nblocks else 0
        spans: list[Tuple[int, int, int, int]] = []
        br_lo, cur = 0, 0
        for br in range(self.n_block_rows):
            b = int(self.row_ptr[br + 1] - self.row_ptr[br]) * per_block
            if cur and cur + b > target_bytes:
                spans.append((br_lo, br, int(self.row_ptr[br_lo]),
                              int(self.row_ptr[br])))
                br_lo, cur = br, 0
            cur += b
        spans.append((br_lo, self.n_block_rows, int(self.row_ptr[br_lo]),
                      int(self.row_ptr[-1])))
        return spans

    def to_dense(self) -> np.ndarray:
        n, m = self.shape
        bm, bn = self.block_shape
        out = np.zeros((n, m), dtype=np.float32)
        for br in range(self.n_block_rows):
            for k in range(self.row_ptr[br], self.row_ptr[br + 1]):
                bc = int(self.block_cols[k])
                r0, c0 = br * bm, bc * bn
                out[r0:r0 + bm, c0:c0 + bn] += self.blocks[k]
        if self.coo_rows.size:
            np.add.at(out, (self.coo_rows, self.coo_cols), self.coo_vals)
        return out



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


def csr_nbytes(rows: np.ndarray, n_rows: int, idx_bytes: int = 8) -> int:
    """Plain CSR storage (indices only) for the format-size comparison."""
    return idx_bytes * (rows.size + n_rows + 1)
