"""Matrix-image serialization + streaming loader (the on-"SSD" format).

Port of `repro.graphs.gio`; the two packages read each other's images.

save_image/load_image persist a TiledMatrix as an .npz + JSON manifest —
the analogue of the paper's sparse "matrix image" created ahead of time
(§3.3.1). stream_tile_rows yields one tile-row worth of blocks at a time,
emulating the semi-external-memory streaming read pattern; it is what the
single-host out-of-core SpMM consumes, and its byte counts feed the
TieredStore I/O accounting.
"""
from __future__ import annotations

import json
import os
from typing import Iterator, Tuple

import numpy as np

from repro_torch.graphs.tiles import TiledMatrix


def save_image(path: str, tm: TiledMatrix) -> None:
    os.makedirs(path, exist_ok=True)
    np.savez(
        os.path.join(path, "image.npz"),
        blocks=tm.blocks, block_cols=tm.block_cols, row_ptr=tm.row_ptr,
        coo_rows=tm.coo_rows, coo_cols=tm.coo_cols, coo_vals=tm.coo_vals,
    )
    manifest = {
        "shape": list(tm.shape), "block_shape": list(tm.block_shape),
        "nblocks": tm.nblocks, "nnz": tm.nnz,
        "image_bytes": tm.nbytes_image(),
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def load_image(path: str) -> TiledMatrix:
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    z = np.load(os.path.join(path, "image.npz"))
    return TiledMatrix(
        shape=tuple(manifest["shape"]),
        block_shape=tuple(manifest["block_shape"]),
        blocks=z["blocks"], block_cols=z["block_cols"], row_ptr=z["row_ptr"],
        coo_rows=z["coo_rows"], coo_cols=z["coo_cols"], coo_vals=z["coo_vals"],
    )


def stream_tile_rows(tm: TiledMatrix) -> Iterator[Tuple[int, np.ndarray, np.ndarray, int]]:
    """Yield (block_row, blocks, block_cols, bytes_read) per tile row —
    the sequential streaming pattern of semi-external-memory SpMM."""
    for br in range(tm.n_block_rows):
        lo, hi = int(tm.row_ptr[br]), int(tm.row_ptr[br + 1])
        blocks = tm.blocks[lo:hi]
        cols = tm.block_cols[lo:hi]
        yield br, blocks, cols, blocks.nbytes + cols.nbytes
