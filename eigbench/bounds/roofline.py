"""The yardstick of the roofline shares: published peaks and the bytes each
piece of work needs at least.

Peaks are NVIDIA's data sheet for the H100 SXM (80 GB HBM3) at its full
700 W; a card run below it (`power.limit`) reads lower shares. Every
count is of what the inputs need: each input byte read once and each
output byte written once per call, whatever a kernel reads again, and
work the program adds (split-row partials, a second operand that is the
first) is not counted, so a share never passes 100% for a reason of the
yardstick's.

Shapes come from the packed image (`ImageShape`, read off the
`TiledMatrix` by the harness) and from the program's launch counters.
"""
from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12            # float32 outside the tensor cores
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": HBM_BYTES_PER_S,
                                   "f32_flops_per_s": F32_FLOPS_PER_S}}

F32 = 4
INDEX = 4                          # int32 block column / row pointer
COO_ENTRY = 12                     # int32 row, int32 column, float32 value


@dataclasses.dataclass(frozen=True)
class ImageShape:
    """What one SpMM over a packed image reads: its dense blocks, their
    column indices and row pointer, and the COO remainder."""
    n: int
    block_rows: int
    block_cols: int
    nblocks: int
    n_block_rows: int
    coo_entries: int
    block_itemsize: int = F32

    @classmethod
    def of(cls, tm) -> "ImageShape":
        """The shape of a `TiledMatrix` (read, not kept)."""
        bm, bn = tm.block_shape
        return cls(n=int(tm.shape[0]), block_rows=int(bm), block_cols=int(bn),
                   nblocks=int(tm.nblocks), n_block_rows=int(tm.n_block_rows),
                   coo_entries=int(tm.coo_vals.shape[0]),
                   block_itemsize=int(tm.blocks.itemsize))

    def block_bytes(self) -> int:
        return (self.nblocks * self.block_rows * self.block_cols
                * self.block_itemsize)

    def index_bytes(self) -> int:
        return INDEX * (self.nblocks + self.n_block_rows + 1)


def spmm_bytes(img: ImageShape, k: int) -> int:
    """One launch of the block SpMM at X's width k: blocks, their indices,
    X read once, Y written once."""
    return img.block_bytes() + img.index_bytes() + 2 * F32 * img.n * k


def matmat_bytes(img: ImageShape, k: int) -> int:
    """One operator application over an image (blocks and COO path): the
    SpMM's bytes and every COO entry once; X and Y are counted once for
    the whole application."""
    return spmm_bytes(img, k) + COO_ENTRY * img.coo_entries


def gram_bytes(n: int, m: int, b: int) -> int:
    """G = AᵀB with A (n, m), B (n, b): the least it reads is the wider
    operand once (A may be B), and it writes G."""
    return F32 * (n * max(m, b) + m * b)


def tsgemm_bytes(n: int, m: int, b: int) -> int:
    """C = A·B (+ C0) with A (n, m), B (m, b): A and B read once, C written
    once (C0 is not counted: a call may have none)."""
    return F32 * (n * m + m * b + n * b)


def seconds(nbytes: float, peak: float = HBM_BYTES_PER_S) -> float:
    """The least time to move `nbytes` at the peak."""
    return nbytes / peak
