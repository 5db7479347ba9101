"""Graph operators: degrees, normalized adjacency, Laplacian (COO-level)."""
from __future__ import annotations

import numpy as np


def degrees(n: int, rows: np.ndarray, cols: np.ndarray,
            vals: np.ndarray | None = None) -> np.ndarray:
    d = np.zeros(n, dtype=np.float64)
    if vals is None:
        np.add.at(d, rows, 1.0)
    else:
        np.add.at(d, rows, vals.astype(np.float64))
    return d


def normalized_adjacency(n: int, rows: np.ndarray, cols: np.ndarray,
                         vals: np.ndarray):
    """D^{-1/2} A D^{-1/2} — the spectral-clustering operator [17, 22]."""
    d = degrees(n, rows, cols, vals)
    with np.errstate(divide="ignore"):
        dinv = np.where(d > 0, 1.0 / np.sqrt(np.maximum(d, 1e-300)), 0.0)
    return rows, cols, (vals * dinv[rows] * dinv[cols]).astype(np.float32)


def laplacian(n: int, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
              *, normalized: bool = False):
    """L = D - A (or I - D^{-1/2} A D^{-1/2}); returns COO including diagonal."""
    if normalized:
        r, c, v = normalized_adjacency(n, rows, cols, vals)
        v = -v
        diag = np.ones(n, dtype=np.float32)
    else:
        r, c, v = rows, cols, -vals
        diag = degrees(n, rows, cols, vals).astype(np.float32)
    dr = np.arange(n, dtype=np.int32)
    keep = diag != 0
    return (np.concatenate([r, dr[keep]]).astype(np.int32),
            np.concatenate([c, dr[keep]]).astype(np.int32),
            np.concatenate([v, diag[keep]]).astype(np.float32))
