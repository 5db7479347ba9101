"""Synthetic graphs (numpy), the same draws as `repro.graphs.synth`.

Generators return deduplicated COO arrays (rows, cols, vals). For the
same arguments they produce exactly the reference's arrays, byte for
byte, so both packages factorize the same operator.

  - rmat_graph:          power-law social graphs (Twitter / Friendster)
  - knn_band_graph:      near-banded weighted KNN graph (Babel Tagalog)
  - clustered_web_graph: domain-clustered directed page graph
  - erdos_renyi:         uniform random control
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


def knn_band_graph(n: int, k: int = 8, *, bandwidth: int | None = None,
                   seed: int = 0):
    """Symmetrized KNN graph with near-banded structure and cosine-ish weights.

    Matches the paper's KNN distance graph: most degrees in a narrow range,
    no power law, weighted edges.
    """
    rng = np.random.default_rng(seed)
    bw = bandwidth if bandwidth is not None else max(4 * k, 16)
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    offs = rng.integers(1, bw + 1, size=n * k) * rng.choice([-1, 1], size=n * k)
    cols = np.clip(rows + offs, 0, n - 1)
    ok = rows != cols
    rows, cols = rows[ok], cols[ok]
    # symmetrize
    rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    vals = (0.5 + 0.5 * rng.random(rows.shape[0])).astype(np.float32)
    r, c, v = _dedup(rows, cols, n, vals)
    # make weights symmetric: w(i,j) = w(j,i) by averaging with transpose
    key = r.astype(np.int64) * n + c.astype(np.int64)
    tkey = c.astype(np.int64) * n + r.astype(np.int64)
    order, torder = np.argsort(key), np.argsort(tkey)
    v_sym = np.empty_like(v)
    v_sym[order] = 0.5 * (v[order] + v[torder])
    return r, c, v_sym


def clustered_web_graph(n: int, nnz: int, *, n_domains: int = 64, seed: int = 0,
                        p_intra: float = 0.9):
    """Directed page graph analogue: vertices clustered by domain; most edges
    stay within a domain (the paper notes this gives good cache hit rates)."""
    rng = np.random.default_rng(seed)
    dom = np.sort(rng.integers(0, n_domains, size=n))  # clustered vertex ids
    dom_start = np.searchsorted(dom, np.arange(n_domains))
    dom_end = np.searchsorted(dom, np.arange(n_domains), side="right")
    rows = rng.integers(0, n, size=int(nnz * 1.3))
    intra = rng.random(rows.shape[0]) < p_intra
    d = dom[rows]
    lo, hi = dom_start[d], np.maximum(dom_end[d], dom_start[d] + 1)
    intra_cols = lo + (rng.random(rows.shape[0]) * (hi - lo)).astype(np.int64)
    inter_cols = rng.integers(0, n, size=rows.shape[0])
    cols = np.where(intra, intra_cols, inter_cols)
    ok = rows != cols
    rows, cols = rows[ok][:nnz], cols[ok][:nnz]
    return _dedup(rows, cols, n)


def erdos_renyi(n: int, nnz: int, *, seed: int = 0, symmetric: bool = True):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, size=int(nnz * 1.2))
    cols = rng.integers(0, n, size=int(nnz * 1.2))
    ok = rows != cols
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
