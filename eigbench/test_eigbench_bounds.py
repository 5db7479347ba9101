"""The roofline byte counts against hand counts at a tiny size."""
import numpy as np
from repro_torch.graphs import pack_tiles

from eigbench.bounds import roofline


def _tiny():
    # a 128 x 128 matrix in 64 x 64 blocks: block (0, 0) holds 5 entries,
    # block (1, 1) holds 4, block (0, 1) holds 2 (below min_block_nnz 4:
    # they go to the COO side path)
    rows = np.array([0, 1, 2, 3, 4, 64, 65, 66, 67, 5, 6], np.int32)
    cols = np.array([0, 1, 2, 3, 4, 64, 65, 66, 67, 70, 71], np.int32)
    vals = np.ones(rows.size, np.float32)
    return pack_tiles(128, 128, rows, cols, vals, block_shape=(64, 64),
                      min_block_nnz=4)


def test_image_shape_and_bytes_by_hand():
    img = roofline.ImageShape.of(_tiny())
    assert (img.n, img.nblocks, img.n_block_rows, img.coo_entries) == (
        128, 2, 2, 2)
    assert img.block_bytes() == 2 * 64 * 64 * 4
    assert img.index_bytes() == 4 * (2 + 3)
    k = 4
    x_and_y = 2 * 128 * k * 4
    assert roofline.spmm_bytes(img, k) == 32768 + 20 + x_and_y
    assert roofline.matmat_bytes(img, k) == 32768 + 20 + x_and_y + 2 * 12


def test_gram_and_tsgemm_bytes_by_hand():
    n = 1000
    assert roofline.gram_bytes(n, 4, 4) == 4 * (4000 + 16)
    assert roofline.gram_bytes(n, 8, 2) == 4 * (8000 + 16)
    assert roofline.tsgemm_bytes(n, 4, 4) == 4 * (4000 + 16 + 4000)
    assert roofline.seconds(3.35e12) == 1.0
    assert roofline.PEAKS["NVIDIA H100 80GB HBM3"]["hbm_bytes_per_s"] == \
        3.35e12


def test_bf16_image_halves_the_blocks():
    import dataclasses
    img = roofline.ImageShape.of(_tiny())
    half = dataclasses.replace(img, block_itemsize=2)
    assert half.block_bytes() * 2 == img.block_bytes()
