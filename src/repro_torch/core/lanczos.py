"""Block Lanczos with full reorthogonalization — the HEIGEN-style baseline.

Port of `repro.core.lanczos`. The paper compares against HEIGEN [12], a
basic Lanczos implementation: build the full m = b·NB subspace once (no
restarts), Rayleigh–Ritz, done. Same out-of-core substrate as
Krylov–Schur (it reuses `krylov_schur._expand`), so the I/O comparison
against the restarted solver is apples-to-apples.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.krylov_schur import _expand, _start_block
from repro_torch.core.multivector import MultiVector
from repro_torch.core.ortho import cholqr
from repro_torch.core.residuals import EigResult, sort_ritz
from repro_torch.core.tiered import TieredStore
from repro_torch.kernels import ops as kops


def lanczos_eigsh(op, nev: int, *, block_size: int = 4,
                  num_blocks: int | None = None, which: str = "LM",
                  store: TieredStore | None = None,
                  impl: kops.Impl = "auto", group_size: int = 8,
                  seed: int = 0, compute_eigenvectors: bool = True,
                  fused_passes: bool = True,
                  callback: Callable | None = None, x0=None) -> EigResult:
    """`callback(step, theta, res)` fires once per block expansion with the
    current Ritz values / residual bounds of the growing subspace —
    nev-length arrays (positions past the subspace dimension padded with
    0 / inf), freshly allocated per call. The per-step tridiagonal
    eigensolve it needs is only paid when a callback is set.

    x0: an explicit (n, b) start block, as `eigsh` takes it; without it
    the start block is drawn from a `torch.Generator` seeded with `seed`
    on the store's device."""
    b = block_size
    if num_blocks is None:
        num_blocks = 4 * (-(-nev // b)) + 2
    m_max = b * num_blocks

    store = store or TieredStore(device=getattr(op, "device", None))
    q, _ = cholqr(_start_block(store, op.n, b, seed, x0), impl=impl)

    v = MultiVector(store, op.n, group_size=group_size, impl=impl)
    h = np.zeros((0, 0), dtype=np.float64)
    r_next = np.zeros((b, b), dtype=np.float64)
    n_ops = 0
    while v.ncols + b <= m_max:
        q, h, r_next = _expand(op, v, q, h, impl, fused_passes=fused_passes)
        n_ops += 1
        if callback is not None:
            th, y = np.linalg.eigh(h)
            order = sort_ritz(th, which)
            th, y = th[order], y[:, order]
            rn = np.linalg.norm(r_next @ y[-b:, :], axis=0)
            k = min(nev, th.shape[0])
            theta_cb = np.zeros(nev)
            res_cb = np.full(nev, np.inf)
            theta_cb[:k] = th[:k]
            res_cb[:k] = rn[:k]
            callback(n_ops - 1, theta_cb, res_cb)

    theta, y = np.linalg.eigh(h)
    order = sort_ritz(theta, which)
    theta, y = theta[order], y[:, order]
    s = r_next @ y[-b:, :]
    res = np.linalg.norm(s, axis=0)

    vec = None
    if compute_eigenvectors:
        vec = v.mv_times_mat(torch.as_tensor(y[:, :nev], dtype=torch.float32,
                                             device=store.device))

    return EigResult(
        eigenvalues=theta[:nev], eigenvectors=vec, residuals=res[:nev],
        n_restarts=0, n_ops=n_ops, m_subspace=m_max,
        converged=bool((res[:nev] <= 1e-4 * np.maximum(
            1.0, np.abs(theta[:nev]))).all()),
        io_stats=store.stats.as_dict())
