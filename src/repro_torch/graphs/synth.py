"""Synthetic R-MAT graphs (numpy), the same draws as `repro.graphs.synth`.

Generators return deduplicated COO arrays (rows, cols, vals). For a given
(n, nnz, seed) they produce exactly the reference's arrays, so both
packages factorize the same operator.
"""
from __future__ import annotations

import numpy as np


def _dedup(rows: np.ndarray, cols: np.ndarray, n: int,
           vals: np.ndarray | None = None):
    """Deduplicate COO entries; keep first value for duplicates."""
    key = rows.astype(np.int64) * n + cols.astype(np.int64)
    _, idx = np.unique(key, return_index=True)
    rows, cols = rows[idx], cols[idx]
    if vals is None:
        vals = np.ones(rows.shape[0], dtype=np.float32)
    else:
        vals = vals[idx]
    return rows.astype(np.int32), cols.astype(np.int32), vals.astype(np.float32)


def rmat_graph(n: int, nnz: int, *, seed: int = 0, symmetric: bool = False,
               a: float = 0.57, b: float = 0.19, c: float = 0.19):
    """R-MAT power-law graph (Twitter/Friendster stand-in).

    Edges are drawn in the next power-of-two space; out-of-range vertices
    and self loops are rejected.
    """
    rng = np.random.default_rng(seed)
    levels = int(np.ceil(np.log2(max(n, 2))))
    # oversample to survive rejection + dedup
    m = int(nnz * 1.5) + 16
    rows = np.zeros(m, dtype=np.int64)
    cols = np.zeros(m, dtype=np.int64)
    pa, pb, pc = a, a + b, a + b + c
    for _ in range(levels):
        r = rng.random(m)
        quad_b = (r >= pa) & (r < pb)
        quad_c = (r >= pb) & (r < pc)
        quad_d = r >= pc
        rows = rows * 2 + (quad_c | quad_d)
        cols = cols * 2 + (quad_b | quad_d)
    ok = (rows < n) & (cols < n) & (rows != cols)
    rows, cols = rows[ok][:nnz], cols[ok][:nnz]
    if symmetric:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    return _dedup(rows, cols, n)


def rmat_spectral(n: int, nnz: int, *, seed: int = 0):
    """Symmetric normalized-adjacency R-MAT graph — the standard input of
    the end-to-end eigensolver drivers and parity tests."""
    from repro_torch.graphs.laplacian import normalized_adjacency
    r, c, v = rmat_graph(n, nnz, seed=seed, symmetric=True)
    return normalized_adjacency(n, r, c, v)


def to_dense(n: int, rows, cols, vals) -> np.ndarray:
    d = np.zeros((n, n), dtype=np.float32)
    d[rows, cols] = vals
    return d
