"""SVD for directed graphs (the page graph path, §4.3.2).

Port of `repro.core.svd`. A directed adjacency matrix is asymmetric, so
the paper computes the SVD instead of an eigendecomposition: the
symmetric Krylov–Schur solver runs on the Gram operator AᵀA (two
streamed SpMMs per application: A then Aᵀ, both images on the slow
tier), σ = sqrt(λ), and the left vectors are U = A V Σ⁻¹.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.krylov_schur import eigsh
from repro_torch.core.operator import GraphOperator, NormalOperator
from repro_torch.core.tiered import TieredStore
from repro_torch.kernels import ops as kops


@dataclasses.dataclass
class SvdResult:
    s: np.ndarray                 # (nsv,) singular values, descending
    u: torch.Tensor | None        # (n_rows, nsv) on the operator's device
    v: torch.Tensor | None        # (n_cols, nsv)
    n_restarts: int
    n_ops: int
    converged: bool
    io_stats: dict | None


def svds(a_op: GraphOperator, at_op: GraphOperator, nsv: int, *,
         block_size: int = 2, num_blocks: int | None = None,
         tol: float = 1e-8, max_restarts: int = 60,
         store: TieredStore | None = None, impl: kops.Impl = "auto",
         seed: int = 0, compute_vectors: bool = True,
         callback: Callable | None = None, x0=None) -> SvdResult:
    """Leading nsv singular triplets of A (n_rows × n_cols).

    The paper uses block size 2 and NB = 2·nsv for the page graph because
    SpMM is SSD-bound there — the same defaults apply here.

    `callback(restart, sigma, res)` fires per inner restart with the
    current σ estimates (σ = √max(θ, 0)) and the Gram residual bounds.
    x0: the (n_cols, block_size) start block, passed on to `eigsh`.
    """
    store = store or TieredStore(device=a_op.device)
    gram_op = NormalOperator(a_op, at_op)
    cb = None
    if callback is not None:
        def cb(k, theta, res):
            callback(k, np.sqrt(np.maximum(theta, 0.0)), res.copy())
    res = eigsh(gram_op, nsv, block_size=block_size, num_blocks=num_blocks,
                tol=tol, max_restarts=max_restarts, which="LA", store=store,
                impl=impl, seed=seed, compute_eigenvectors=compute_vectors,
                callback=cb, x0=x0)
    lam = np.maximum(res.eigenvalues, 0.0)
    s = np.sqrt(lam)
    u = v = None
    if compute_vectors and res.eigenvectors is not None:
        v = res.eigenvectors
        av = a_op.matmat(v)
        sinv = np.where(s > 1e-12, 1.0 / np.maximum(s, 1e-30), 0.0)
        u = av * torch.as_tensor(sinv, dtype=torch.float32,
                                 device=av.device)[None, :]
    return SvdResult(s=s, u=u, v=v, n_restarts=res.n_restarts,
                     n_ops=res.n_ops, converged=res.converged,
                     io_stats=store.stats.as_dict())
